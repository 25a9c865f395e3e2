"""Port parity: the user-feature PMFs (UserPMF, UserVisualPMF).

The same numpy inputs go through the JAX package and the port: parameter
names (`user_mlp/...`, `item_mlp/...`), loss, aux and autograd gradients
against jax.grad (dropout off) with the feature rows gathered by the model
or joined into the batch (`user_feature`, `item_vfeature`), full-catalog
scores and the serving sides (`user_vecs`, `item_vecs`), 20 steps of
lazy_adam and keras_adam through both Trainers, and npz checkpoints both
ways. Amazon-book's int32 user categories go through UserPMF as JAX's
`f @ w` promotes them (float32). Dropout on the user MLP draws from the
Trainer's generator (its law: one [B, H] mask a hidden layer, one seed one
loss, nothing drawn without a generator), and UserVisualPMF's item MLP,
built with the dropout rate, never drops (`openrec_tpu/models/
user_feature.py:107-110`). The JAX package's bar is mirrored
(`tests/test_models_extended.py:200-212`).

Tolerances: rtol = atol = 1e-5 for losses, gradients and scores; 20-step
parameters and losses rtol 1e-5, atol 1e-6.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from openrec_tpu import checkpoint as jckpt
from openrec_tpu import models as jmodels
from openrec_tpu.training import Trainer as JTrainer
from openrec_tpu.training import optim as joptim
import openrec_tpu_torch as port
from openrec_tpu_torch import checkpoint as tckpt
from openrec_tpu_torch import convert, models
from openrec_tpu_torch.data import InteractionStore, loaders, samplers
from openrec_tpu_torch.training import Trainer, optim as toptim
from tests.conftest import make_interactions

torch.set_num_threads(1)

TOL = 1e-5
RTOL, ATOL = 1e-5, 1e-6
USERS, ITEMS, BATCH, LR = 30, 50, 16, 1e-3
FIXTURES = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "fixtures", "dataset") + os.sep
_rng = np.random.default_rng(5)
USER_FEATURES = _rng.normal(size=(USERS, 6)).astype(np.float32)
# Amazon-book's layout: a few int32 category columns a user
CATEGORIES = _rng.integers(0, 5, (USERS, 3)).astype(np.int32)
ITEM_FEATURES = np.maximum(_rng.normal(size=(ITEMS, 12)), 0.0).astype(
    np.float32)

# name: (class, keyword arguments)
SPECS = {
    "UserPMF": ("UserPMF", dict(user_features=USER_FEATURES, mlp_units=(6,),
                                a=1.0, b=0.01, l2_weight=0.01)),
    "UserPMF-int32": ("UserPMF", dict(user_features=CATEGORIES,
                                      sigmoid=False, a=2.0, b=0.5)),
    "UserVisualPMF": ("UserVisualPMF", dict(
        user_features=USER_FEATURES, mlp_units=(6,),
        item_features=ITEM_FEATURES, item_mlp_units=(10,), b=0.01,
        l2_weight=0.01)),
}


def _models(name, seed=0, **over):
    """(JAX model, numpy params, port model holding the same params), with
    a nonzero item bias and MLP biases."""
    cls, kw = SPECS[name]
    kw = {**kw, **over}
    jmodel = getattr(jmodels, cls)(USERS, ITEMS, 8, **kw)
    params = jax.tree.map(np.asarray, jmodel.init(jax.random.PRNGKey(seed)))
    rng = np.random.default_rng(seed)
    params["item_bias"] = rng.normal(scale=0.1, size=(ITEMS, 1)).astype(
        np.float32)
    for key in ("user_mlp", "item_mlp"):
        for layer in params.get(key, ()):
            layer["b"] = rng.normal(scale=0.1, size=layer["b"].shape) \
                .astype(np.float32)
    model = getattr(models, cls)(USERS, ITEMS, 8, device="cpu", **kw)
    model.load_params(convert.params_from_jax(params, device="cpu"))
    return jmodel, params, model


def _batch(rng, joined=None):
    """A pointwise batch; joined=name adds rows of that spec's feature
    widths and dtypes (`user_feature`, `item_vfeature`)."""
    batch = {"user_id": rng.integers(0, USERS, BATCH).astype(np.int32),
             "item_id": rng.integers(0, ITEMS, BATCH).astype(np.int32),
             "label": (rng.random(BATCH) < 0.3).astype(np.float32)}
    if joined == "UserPMF-int32":
        batch["user_feature"] = rng.integers(0, 5, (BATCH, 3)).astype(
            np.int32)
    elif joined:
        batch["user_feature"] = rng.normal(size=(BATCH, 6)).astype(
            np.float32)
        batch["item_vfeature"] = rng.random((BATCH, 12)).astype(np.float32)
    return batch


def _torch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _jax(tree):
    return jax.tree.map(jnp.asarray, tree)


@pytest.mark.parametrize("name", list(SPECS))
def test_param_names_and_shapes_are_the_jax_tree(name):
    _, params, model = _models(name)
    want = {k: v.shape for k, v in convert.flatten_tree(params).items()}
    assert {k: tuple(v.shape) for k, v in model.params().items()} == want
    assert all(b.dtype == torch.float32 for b in model.buffers())
    assert not any("feature" in k for k in model.state_dict())


@pytest.mark.parametrize("joined", [False, True])
@pytest.mark.parametrize("name", list(SPECS))
def test_loss_aux_and_grads_match_jax(name, joined):
    jmodel, params, model = _models(name)
    batch = _batch(np.random.default_rng(1), joined and name)
    (want, want_aux), jgrads = jax.value_and_grad(
        jmodel.loss, has_aux=True)(_jax(params), _jax(batch))
    loss, aux = model.loss(_torch(batch))
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(want), rtol=TOL, atol=TOL)
    assert sorted(aux) == sorted(want_aux) == ["l2_loss", "loss"]
    for key in aux:
        np.testing.assert_allclose(aux[key].item(), float(want_aux[key]),
                                   rtol=TOL, atol=TOL, err_msg=key)
    flat = convert.flatten_tree(jgrads)
    assert sorted(flat) == sorted(model.params())
    for key, param in model.params().items():
        np.testing.assert_allclose(param.grad.numpy(), np.asarray(flat[key]),
                                   rtol=TOL, atol=TOL, err_msg=key)
    # no grad_transform: the gradients reach the optimizer as they are
    grads = {k: p.grad for k, p in model.params().items()}
    assert model.grad_transform(grads, batch) is grads


@pytest.mark.parametrize("name", list(SPECS))
def test_joined_rows_equal_gathered(name):
    _, _, model = _models(name)
    batch = _batch(np.random.default_rng(2))
    joined = dict(batch, user_feature=SPECS[name][1]["user_features"][
        batch["user_id"]])
    if name == "UserVisualPMF":
        joined["item_vfeature"] = ITEM_FEATURES[batch["item_id"]]
    with torch.no_grad():
        a = model.loss(_torch(batch))[0].item()
        b = model.loss(_torch(joined))[0].item()
    np.testing.assert_allclose(a, b, rtol=1e-6)


@pytest.mark.parametrize("name", list(SPECS))
def test_score_and_serving_side_match_jax(name):
    jmodel, params, model = _models(name)
    users = np.array([0, 7, 29, 3, 3], np.int32)
    want = np.asarray(jmodel.score(_jax(params), {"user_id": users}))
    with torch.no_grad():
        got = model.score({"user_id": torch.from_numpy(users)})
        served = model.user_vecs(torch.from_numpy(users)) \
            @ model.item_vecs(torch.arange(ITEMS)).T \
            + model.item_bias.reshape(-1)
    if SPECS[name][1].get("sigmoid", True):
        served = torch.sigmoid(served)
    np.testing.assert_allclose(got.numpy(), want, rtol=TOL, atol=TOL)
    np.testing.assert_allclose(served.numpy(), want, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("optimizer", ["lazy_adam", "keras_adam"])
@pytest.mark.parametrize("name", list(SPECS))
def test_twenty_steps_match_jax(name, optimizer):
    jmodel, params, model = _models(name)
    rng = np.random.default_rng(7)
    batches = [_batch(rng) for _ in range(20)]
    jt = JTrainer(jmodel, optimizer=getattr(joptim, optimizer)(LR), seed=0)
    jt.params = _jax(params)
    jt.opt_state = jt.tx.init(jt.params)
    tt = Trainer(model, optimizer=getattr(toptim, optimizer)(LR),
                 device="cpu")
    jl = np.concatenate([np.asarray(jt.train_step_multi(batches[:10])),
                         np.asarray(jt.train_step_multi(batches[10:]))])
    tl = torch.cat([tt.train_step_multi(batches[:10]),
                    tt.train_step_multi(batches[10:])]).numpy()
    np.testing.assert_allclose(tl, jl, rtol=RTOL, atol=ATOL)
    want = convert.flatten_tree(jax.tree.map(np.asarray, jt.params))
    for key, value in tt.params.items():
        np.testing.assert_allclose(value.detach().numpy(), want[key],
                                   rtol=RTOL, atol=ATOL, err_msg=key)


@pytest.mark.parametrize("name", ["UserPMF", "UserVisualPMF"])
def test_jax_checkpoints_restore_both_ways(name, tmp_path):
    jmodel, params, _ = _models(name, seed=2)
    path = jckpt.save(str(tmp_path / "jax"), 4, params)
    cls, kw = SPECS[name]
    fresh = getattr(models, cls)(USERS, ITEMS, 8, device="cpu", **kw)
    fresh.load_params(tckpt.restore(path, device="cpu"))
    for key, value in convert.flatten_tree(params).items():
        np.testing.assert_array_equal(fresh.params()[key].detach().numpy(),
                                      value, err_msg=key)
    back = tckpt.save(str(tmp_path / "torch"), 5, fresh.params())
    files = set(np.load(back).files)
    assert files == set(convert.flatten_tree(params))
    assert "user_mlp/1/b" in files
    assert ("item_mlp/0/w" in files) == (name == "UserVisualPMF")
    template = jmodel.init(jax.random.PRNGKey(9))
    got = jax.tree.map(np.asarray, jckpt.restore(back, template=template))
    assert jax.tree.structure(got) == jax.tree.structure(template)
    for key, value in convert.flatten_tree(got).items():
        np.testing.assert_array_equal(
            value, convert.flatten_tree(params)[key], err_msg=key)


# ----------------------------------------------------------------- dropout

@pytest.mark.parametrize("name", ["UserPMF", "UserVisualPMF"])
def test_user_mlp_drops_and_the_item_mlp_never_does(name):
    """One [B, 6] mask for the user MLP's hidden layer and no other draw
    (UserVisualPMF's item MLP has a hidden layer of 10 and the rate, and
    does not draw); one seed one loss, another seed another; without a
    generator JAX's loss without an rng; `score` draws nothing."""
    jmodel, params, model = _models(name, dropout=0.5)
    batch = _batch(np.random.default_rng(1))
    gen = torch.Generator().manual_seed(5)
    ref = torch.Generator().manual_seed(5)
    with torch.no_grad():
        a = model.loss(_torch(batch), generator=gen)[0].item()
        torch.rand((BATCH, 6), generator=ref)
        assert torch.equal(gen.get_state(), ref.get_state())
        assert a == model.loss(_torch(batch), generator=torch.Generator()
                               .manual_seed(5))[0].item()
        assert a != model.loss(_torch(batch), generator=torch.Generator()
                               .manual_seed(6))[0].item()
        plain = model.loss(_torch(batch))[0].item()
        model.score({"user_id": torch.tensor([1, 2])})
        model.item_vecs(torch.arange(ITEMS))
    assert torch.equal(gen.get_state(), ref.get_state())
    want, _ = jmodel.loss(_jax(params), _jax(batch))
    np.testing.assert_allclose(plain, float(want), rtol=TOL, atol=TOL)
    if name == "UserVisualPMF":
        # the JAX package's item vector under a training rng: undropped
        jitem = jmodel._item_vec(_jax(params), jnp.arange(ITEMS))
        with torch.no_grad():
            np.testing.assert_allclose(
                model.item_vecs(torch.arange(ITEMS)).numpy(),
                np.asarray(jitem), rtol=TOL, atol=TOL)
        assert model.item_mlp.dropout_rate == 0.5


def test_trainer_generator_moves_only_with_user_dropout():
    rng = np.random.default_rng(3)
    batches = [_batch(rng) for _ in range(3)]
    for dropout, moves in ((None, False), (0.4, True)):
        model = models.UserVisualPMF(
            USERS, ITEMS, 8, user_features=USER_FEATURES, mlp_units=(6,),
            item_features=ITEM_FEATURES, item_mlp_units=(10,),
            dropout=dropout, device="cpu",
            generator=torch.Generator().manual_seed(1))
        tt = Trainer(model, lr=LR, seed=0, device="cpu")
        state = tt.generator.get_state()
        tt.train_step_multi(batches)
        assert torch.equal(tt.generator.get_state(), state) != moves


# ------------------------------------------------------------ Amazon-book

def test_amazon_categories_through_user_pmf():
    """`load_amazon_book`'s int32 user categories (the fixture's [30, 3])
    train UserPMF, whose loss equals JAX's on them."""
    raw = loaders.load_amazon_book(FIXTURES, feature_shape=(ITEMS, 16))
    cats = raw["user_features"]
    assert cats.dtype == np.int32 and cats.shape == (USERS, 3)
    jmodel = jmodels.UserPMF(USERS, ITEMS, 8, user_features=cats,
                             mlp_units=(4,))
    params = jax.tree.map(np.asarray, jmodel.init(jax.random.PRNGKey(3)))
    model = models.UserPMF(USERS, ITEMS, 8, user_features=cats,
                           mlp_units=(4,), device="cpu")
    model.load_params(convert.params_from_jax(params, device="cpu"))
    store = InteractionStore(raw["train_data"], USERS, ITEMS, seed=0)
    s = samplers.StratifiedPointwiseSampler(store, 16, seed=0,
                                            use_native=False)
    batch = s.sample()
    want, _ = jmodel.loss(_jax(params), _jax(batch))
    with torch.no_grad():
        got = model.loss(_torch(batch))[0].item()
    np.testing.assert_allclose(got, float(want), rtol=TOL, atol=TOL)
    tr = Trainer(model, lr=0.05, seed=0, device="cpu")
    losses = [float(tr.train_step(s.sample())[0]) for _ in range(5)]
    assert np.isfinite(losses).all()


def test_user_pmf_and_user_visual_pmf_train():
    """`tests/test_models_extended.py:200-212` on the port."""
    store = InteractionStore(make_interactions(), 40, 100, seed=0)
    rng = np.random.default_rng(5)
    ufeats = rng.normal(size=(40, 6)).astype(np.float32)
    vfeats = np.random.default_rng(3).normal(size=(100, 12)).astype(
        np.float32)
    for model in (
            models.UserPMF(40, 100, 8, user_features=ufeats, mlp_units=(8,),
                           device="cpu"),
            models.UserVisualPMF(40, 100, 8, user_features=ufeats,
                                 mlp_units=(8,), item_features=vfeats,
                                 item_mlp_units=(8,), device="cpu")):
        s = samplers.StratifiedPointwiseSampler(store, batch_size=64, seed=0)
        tr = Trainer(model, lr=0.02, seed=0, device="cpu")
        losses = [float(tr.train_step(b)[0])
                  for b, _ in zip(iter(s), range(40))]
        assert np.isfinite(losses).all()
        assert np.mean(losses[-5:]) < np.mean(losses[:5])


@pytest.mark.parametrize("name", ["UserPMF", "UserVisualPMF"])
def test_new_models_need_cuda_or_explicit_cpu(name):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid")
    kw = dict(SPECS[name][1])
    with pytest.raises(RuntimeError, match="CUDA"):
        getattr(port, name)(USERS, ITEMS, 8, **kw)
    model = getattr(port, name)(USERS, ITEMS, 8, device="cpu", **kw)
    assert all(t.device.type == "cpu"
               for t in list(model.parameters()) + list(model.buffers()))
