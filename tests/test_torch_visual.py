"""Port parity: the visual family (VBPR, VisualBPR, VisualCML, VisualPMF,
VisualGMF, ConcatVisualBPR) and the fusions.

The same numpy inputs go through the JAX package and the port: parameter
names (`visual_mlp/0/w`, `visual_proj/0/b`, VisualGMF's bias-free
`mlp/0/w`), each model's loss, aux and autograd gradients against
jax.grad (dropout off), before and after `grad_transform`, whose 1/B
reaches the visual subtree only; losses with joined feature rows
(`p_item_vfeature`, ...) against JAX's with the same rows and against the
gathered ones; full-catalog scores (VisualCML's euclidean form, VisualGMF's
w-weighted one) and the serving sides `item_vecs` / `user_vecs`; 20 steps
of lazy_adam and keras_adam through both Trainers (VisualCML's censor
included); npz checkpoints both ways; float64 features and joined rows
held as float32. Dropout draws from a torch.Generator, so its law is
held: x / keep or 0, one seed one loss, the positives and negatives drawn
apart, one draw a hidden layer, nothing drawn without a generator or by a
one-layer MLP, and the Trainer's generator moving only for a model that
draws. The JAX package's own bars are mirrored
(`tests/test_models_extended.py:113-200`).

Tolerances: rtol = atol = 1e-5 for losses, gradients and scores; 20-step
parameters and losses rtol 1e-5, atol 1e-6; joined against gathered
rtol 1e-6 (JAX's bar).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from openrec_tpu import checkpoint as jckpt
from openrec_tpu import models as jmodels
from openrec_tpu.modules import fusions as jfusions
from openrec_tpu.training import Trainer as JTrainer
from openrec_tpu.training import optim as joptim
import openrec_tpu_torch as port
from openrec_tpu_torch import checkpoint as tckpt
from openrec_tpu_torch import convert, models
from openrec_tpu_torch.data import InteractionStore, samplers
from openrec_tpu_torch.modules import fusions
from openrec_tpu_torch.training import Trainer, optim as toptim
from tests.conftest import make_interactions

torch.set_num_threads(1)

TOL = 1e-5
RTOL, ATOL = 1e-5, 1e-6
USERS, ITEMS, FEAT, BATCH, LR = 40, 60, 12, 16, 1e-3
# non-negative, as a CNN's relu outputs are
FEATURES = np.maximum(np.random.default_rng(3).normal(
    size=(ITEMS, FEAT)), 0.0).astype(np.float32)

# name: (class, positional widths, keyword arguments)
SPECS = {
    "VBPR": ("VBPR", (16, 8), dict(l2_weight=0.01)),
    "VBPR-deep": ("VBPR", (16, 10), dict(mlp_units=(9, 6))),
    "VisualBPR": ("VisualBPR", (8,), dict(mlp_units=(10,), l2_weight=0.01)),
    "VisualBPR-linear": ("VisualBPR", (8,), dict()),
    "VisualCML": ("VisualCML", (8,), dict(mlp_units=(10,), margin=0.5,
                                          l2_weight=0.01)),
    "VisualPMF": ("VisualPMF", (8,), dict(mlp_units=(10,), a=1.0, b=0.01,
                                          l2_weight=0.01)),
    "VisualPMF-linear": ("VisualPMF", (8,), dict(a=2.0, b=0.5,
                                                 sigmoid=False)),
    "VisualGMF": ("VisualGMF", (8,), dict(mlp_units=(10,), l2_weight=0.01)),
    "ConcatVisualBPR": ("ConcatVisualBPR", (12, 4), dict(l2_weight=0.01)),
}
POINTWISE = ("VisualPMF", "VisualGMF")
MLP_KEY = {"ConcatVisualBPR": "visual_proj"}


def _cls(name):
    return SPECS[name][0]


def _models(name, seed=0, features=FEATURES, **over):
    """(JAX model, numpy params, port model holding the same params), with
    a nonzero item bias and MLP biases."""
    cls, widths, kw = SPECS[name]
    kw = {**kw, **over}
    jmodel = getattr(jmodels, cls)(USERS, ITEMS, *widths,
                                   item_features=features, **kw)
    params = jax.tree.map(np.asarray, jmodel.init(jax.random.PRNGKey(seed)))
    rng = np.random.default_rng(seed)
    params["item_bias"] = rng.normal(scale=0.1, size=(ITEMS, 1)).astype(
        np.float32)
    for layer in params[MLP_KEY.get(cls, "visual_mlp")]:
        layer["b"] = rng.normal(scale=0.1, size=layer["b"].shape).astype(
            np.float32)
    model = getattr(models, cls)(USERS, ITEMS, *widths,
                                 item_features=features, device="cpu", **kw)
    model.load_params(convert.params_from_jax(params, device="cpu"))
    return jmodel, params, model


def _batch(name, rng, joined=None):
    """A pairwise or pointwise batch (negatives apart from their positive);
    joined: None, "gathered" (FEATURES' rows) or "random" rows."""
    users = rng.integers(0, USERS, BATCH).astype(np.int32)
    if _cls(name) in POINTWISE:
        batch = {"user_id": users,
                 "item_id": rng.integers(0, ITEMS, BATCH).astype(np.int32),
                 "label": (rng.random(BATCH) < 0.3).astype(np.float32)}
        keys = (("item_id", "item_vfeature"),)
    else:
        p = rng.integers(0, ITEMS, BATCH)
        n = (p + rng.integers(1, ITEMS, BATCH)) % ITEMS
        batch = {"user_id": users, "p_item_id": p.astype(np.int32),
                 "n_item_id": n.astype(np.int32)}
        keys = (("p_item_id", "p_item_vfeature"),
                ("n_item_id", "n_item_vfeature"))
    for id_key, out_key in keys if joined else ():
        batch[out_key] = (FEATURES[batch[id_key]] if joined == "gathered"
                          else rng.random((BATCH, FEAT)).astype(np.float32))
    return batch


def _torch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _jax(batch):
    return jax.tree.map(jnp.asarray, batch)


# ------------------------------------------------------------------ models

@pytest.mark.parametrize("name", list(SPECS))
def test_param_names_and_shapes_are_the_jax_tree(name):
    """Every name and shape is the JAX tree's; VisualGMF's unit has no
    `mlp/0/b`; the features are a buffer, no parameter, no state_dict
    entry."""
    _, params, model = _models(name)
    want = {k: v.shape for k, v in convert.flatten_tree(params).items()}
    assert {k: tuple(v.shape) for k, v in model.params().items()} == want
    if _cls(name) == "VisualGMF":
        assert "mlp/0/w" in want and "mlp/0/b" not in want
    assert dict(model.named_buffers())["item_features"].dtype \
        == torch.float32
    assert not any("feature" in k for k in model.state_dict())


@pytest.mark.parametrize("joined", [None, "random"])
@pytest.mark.parametrize("name", list(SPECS))
def test_loss_aux_and_grads_match_jax(name, joined):
    """Loss, aux and gradients, then the gradients after each package's
    `grad_transform`: 1/B on the visual MLP (VisualBPR, VisualCML,
    VisualPMF, VisualGMF) or projection (ConcatVisualBPR), nothing for
    VBPR, and every other entry untouched."""
    jmodel, params, model = _models(name)
    batch = _batch(name, np.random.default_rng(1), joined)
    (want, want_aux), jgrads = jax.value_and_grad(
        jmodel.loss, has_aux=True)(_jax(params), _jax(batch))
    loss, aux = model.loss(_torch(batch))
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(want), rtol=TOL, atol=TOL)
    assert sorted(aux) == sorted(want_aux) == ["l2_loss", "loss"]
    for key in aux:
        np.testing.assert_allclose(aux[key].item(), float(want_aux[key]),
                                   rtol=TOL, atol=TOL, err_msg=key)
    grads = {k: p.grad for k, p in model.params().items()}
    scaled = model.grad_transform(grads, _torch(batch))
    want_raw = convert.flatten_tree(jgrads)
    want_scaled = convert.flatten_tree(
        jmodel.grad_transform(jgrads, _jax(batch)))
    assert sorted(want_raw) == sorted(grads)
    mlp = MLP_KEY.get(_cls(name), "visual_mlp") + "/"
    for key in grads:
        np.testing.assert_allclose(grads[key].numpy(),
                                   np.asarray(want_raw[key]),
                                   rtol=TOL, atol=TOL, err_msg=key)
        np.testing.assert_allclose(scaled[key].numpy(),
                                   np.asarray(want_scaled[key]),
                                   rtol=TOL, atol=TOL, err_msg=key)
        rescaled = key.startswith(mlp) and _cls(name) != "VBPR"
        assert torch.equal(scaled[key], grads[key] / BATCH if rescaled
                           else grads[key]), key


@pytest.mark.parametrize("name", list(SPECS))
def test_joined_features_equal_gathered(name):
    """The sampler's joined rows give the loss of the model's own gather
    (JAX `tests/test_models_extended.py:127-145`), and float64 joined rows
    are held as float32, as jnp.asarray holds them."""
    _, _, model = _models(name)
    rng = np.random.default_rng(2)
    batch = _batch(name, rng, "gathered")
    plain = {k: v for k, v in batch.items() if "feature" not in k}
    wide = {k: v.astype(np.float64) if "feature" in k else v
            for k, v in batch.items()}
    with torch.no_grad():
        got = [model.loss(_torch(b))[0].item() for b in (batch, plain, wide)]
    np.testing.assert_allclose(got[0], got[1], rtol=1e-6)
    assert got[2] == got[0]


@pytest.mark.parametrize("name", list(SPECS))
def test_score_and_serving_side_match_jax(name):
    """Full-catalog scores; `item_vecs` (and VisualGMF's `user_vecs`,
    VisualCML's 2u, v, b - ||v||^2) give the same ranking as u.v + b."""
    jmodel, params, model = _models(name)
    users = np.array([0, 5, 39, 12, 12], np.int32)
    want = np.asarray(jmodel.score(_jax(params), {"user_id": users}))
    with torch.no_grad():
        got = model.score({"user_id": torch.from_numpy(users)})
        v = model.item_vecs(torch.arange(ITEMS))
        assert torch.equal(v, model.item_vecs())
        b = model.item_bias.reshape(-1)
        u = (model.user_vecs(torch.from_numpy(users))
             if hasattr(model, "user_vecs")
             else model.user_embed[torch.from_numpy(users).long()])
        if _cls(name) == "VisualCML":
            served = 2 * u @ v.T + (b - (v ** 2).sum(1)) \
                - (u ** 2).sum(1, keepdim=True)
        else:
            served = u @ v.T + b
            if SPECS[name][2].get("sigmoid", _cls(name) == "VisualPMF"):
                served = torch.sigmoid(served)
    assert tuple(got.shape) == want.shape == (5, ITEMS)
    np.testing.assert_allclose(got.numpy(), want, rtol=TOL, atol=TOL)
    np.testing.assert_allclose(served.numpy(), want, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("optimizer", ["lazy_adam", "keras_adam"])
@pytest.mark.parametrize("name", ["VBPR", "VisualBPR", "VisualCML",
                                  "VisualPMF", "VisualGMF",
                                  "ConcatVisualBPR"])
def test_twenty_steps_match_jax(name, optimizer):
    """20 steps (two K-step calls of 10) from the same parameters, with
    the 1/B rescale and VisualCML's censor; dropout off."""
    jmodel, params, model = _models(name)
    rng = np.random.default_rng(7)
    batches = [_batch(name, rng) for _ in range(20)]
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
    if name == "VisualCML" and optimizer == "lazy_adam":
        # a row moves only in a step that touches it, and is then censored
        # (keras_adam's dense moments move every row in every step)
        for table in ("user_embed", "item_embed"):
            norms = torch.linalg.vector_norm(tt.params[table].detach(), dim=1)
            touched = torch.from_numpy((tt.params[table].detach().numpy()
                                        != params[table]).any(axis=1))
            assert touched.any() and norms[touched].max() <= 1.0 + 1e-6


@pytest.mark.parametrize("name", ["VBPR", "VisualBPR", "VisualCML",
                                  "VisualPMF", "VisualGMF",
                                  "ConcatVisualBPR"])
def test_jax_checkpoints_restore_both_ways(name, tmp_path):
    """By name (`visual_mlp/0/w`, `visual_proj/0/b`, `mlp/0/w`); the item
    features are in neither file nor state_dict."""
    jmodel, params, _ = _models(name, seed=2)
    path = jckpt.save(str(tmp_path / "jax"), 4, params)
    cls, widths, kw = SPECS[name]
    fresh = getattr(models, cls)(USERS, ITEMS, *widths,
                                 item_features=FEATURES, device="cpu", **kw)
    fresh.load_params(tckpt.restore(path, device="cpu"))
    for key, value in convert.flatten_tree(params).items():
        np.testing.assert_array_equal(fresh.params()[key].detach().numpy(),
                                      value, err_msg=key)
    back = tckpt.save(str(tmp_path / "torch"), 5, fresh.params())
    files = set(np.load(back).files)
    assert files == set(convert.flatten_tree(params))
    named = {"VisualGMF": "mlp/0/w", "ConcatVisualBPR": "visual_proj/0/w"}
    assert named.get(name, "visual_mlp/0/b") in files
    template = jmodel.init(jax.random.PRNGKey(9))
    got = jax.tree.map(np.asarray, jckpt.restore(back, template=template))
    assert jax.tree.structure(got) == jax.tree.structure(template)
    for key, value in convert.flatten_tree(got).items():
        np.testing.assert_array_equal(
            value, convert.flatten_tree(params)[key], err_msg=key)


@pytest.mark.parametrize("name", ["VBPR", "VisualPMF"])
def test_float64_and_int_features_are_held_as_float32(name):
    """A float64 feature matrix gives the loss of its float32 copy, in
    both packages (jnp.asarray keeps 32 bits); so does an int32 one."""
    batch = _batch(name, np.random.default_rng(4))
    for features in (FEATURES.astype(np.float64),
                     (FEATURES * 3).astype(np.int32)):
        jmodel, params, model = _models(name, features=features)
        assert model.item_features.dtype == torch.float32
        want, _ = jmodel.loss(_jax(params), _jax(batch))
        with torch.no_grad():
            got = model.loss(_torch(batch))[0].item()
        np.testing.assert_allclose(got, float(want), rtol=TOL, atol=TOL)


def test_a_float32_card_or_cpu_tensor_is_shared_not_copied():
    feats = torch.from_numpy(FEATURES.copy())
    a = models.VisualBPR(USERS, ITEMS, 8, item_features=feats, device="cpu")
    b = models.VBPR(USERS, ITEMS, 16, 8, item_features=feats, device="cpu")
    assert a.item_features.data_ptr() == b.item_features.data_ptr() \
        == feats.data_ptr()


# ----------------------------------------------------------------- dropout

def _dropout_model(name, mlp_units=(10,), rate=0.5):
    return _models(name, mlp_units=mlp_units, dropout=rate)


def test_dropout_draws_one_mask_a_hidden_layer_per_side():
    """VisualBPR draws one [B, H] mask for the positives and one for the
    negatives, VisualPMF one: the generator ends where that many draws
    leave it. With a generator one seed gives one loss and another seed
    another; without one the loss is JAX's without an rng, and `score`
    draws nothing."""
    for name, draws in (("VisualBPR", 2), ("VisualPMF", 1)):
        jmodel, params, model = _dropout_model(name)
        batch = _batch(name, np.random.default_rng(1))
        gen = torch.Generator().manual_seed(5)
        ref = torch.Generator().manual_seed(5)
        with torch.no_grad():
            a = model.loss(_torch(batch), generator=gen)[0].item()
        for _ in range(draws):
            torch.rand((BATCH, 10), generator=ref)
        assert torch.equal(gen.get_state(), ref.get_state())
        with torch.no_grad():
            assert a == model.loss(_torch(batch), generator=torch.Generator()
                                   .manual_seed(5))[0].item()
            assert a != model.loss(_torch(batch), generator=torch.Generator()
                                   .manual_seed(6))[0].item()
            plain = model.loss(_torch(batch))[0].item()
            state = gen.get_state()
            model.score({"user_id": torch.tensor([1, 2])})
        assert torch.equal(gen.get_state(), state)
        want, _ = jmodel.loss(_jax(params), _jax(batch))
        np.testing.assert_allclose(plain, float(want), rtol=TOL, atol=TOL)


def test_positives_and_negatives_draw_apart():
    """With every negative equal to its positive and no bias, BPR's loss
    is log 2 exactly, unless the two sides' masks differ."""
    _, _, model = _dropout_model("VisualBPR")
    with torch.no_grad():
        model.item_bias.zero_()
    rng = np.random.default_rng(3)
    ids = rng.integers(0, ITEMS, BATCH).astype(np.int32)
    batch = _torch({"user_id": rng.integers(0, USERS, BATCH).astype(np.int32),
                    "p_item_id": ids, "n_item_id": ids})
    with torch.no_grad():
        assert model.loss(batch)[1]["loss"].item() == pytest.approx(
            np.log(2.0), abs=1e-7)
        drawn = model.loss(batch, generator=torch.Generator().manual_seed(
            1))[1]["loss"].item()
    assert abs(drawn - np.log(2.0)) > 1e-3


def test_dropout_keeps_x_over_keep_at_the_keep_rate():
    """VisualPMF's item vector through a hidden layer whose output layer is
    the identity: each unit is relu(h) / keep or 0, the kept share of the
    live units within 5 standard deviations of keep."""
    rate, H = 0.3, 64
    model = models.VisualPMF(USERS, ITEMS, H, mlp_units=(H,),
                             item_features=FEATURES, dropout=rate,
                             device="cpu")
    mlp = model.visual_mlp
    with torch.no_grad():
        mlp[1].w.copy_(torch.eye(H))
        mlp[1].b.zero_()
        model.item_embed.zero_()
        ids = torch.arange(ITEMS).repeat(20)
        hidden = torch.relu(model.item_features[ids] @ mlp[0].w + mlp[0].b)
        out = model.item_vecs(ids, generator=torch.Generator().manual_seed(2))
    keep = 1.0 - rate
    kept = out != 0
    assert torch.equal(out[kept], (hidden / keep)[kept])
    live = hidden != 0
    share = kept[live].float().mean().item()
    n = int(live.sum())
    assert abs(share - keep) < 5 * np.sqrt(keep * (1 - keep) / n)


@pytest.mark.parametrize("name,over,moves", [
    ("VBPR", {}, False),                          # no dropout at all
    ("VisualGMF", {"mlp_units": (10,)}, False),   # its visual MLP has none
    ("ConcatVisualBPR", {}, False),
    ("VisualBPR", {"mlp_units": (), "dropout": 0.4}, False),  # no hidden
    ("VisualBPR", {"mlp_units": (10,), "dropout": 0.4}, True),
    ("VisualCML", {"mlp_units": (10,), "dropout": 0.4}, True),
    ("VisualPMF", {"mlp_units": (10,), "dropout": 0.4}, True),
])
def test_trainer_generator_moves_only_for_a_model_that_draws(name, over,
                                                             moves):
    cls, widths, kw = SPECS[name]
    kw = {**kw, **over}
    rng = np.random.default_rng(3)
    batches = [_batch(name, rng) for _ in range(3)]

    def run(seed):
        model = getattr(models, cls)(USERS, ITEMS, *widths,
                                     item_features=FEATURES, device="cpu",
                                     generator=torch.Generator()
                                     .manual_seed(1), **kw)
        tt = Trainer(model, lr=LR, seed=seed, device="cpu")
        state = tt.generator.get_state()
        losses = torch.cat([tt.train_step_multi(batches[:2]),
                            tt.train_step(batches[2])[0][None]])
        return torch.equal(tt.generator.get_state(), state), losses
    unmoved, a = run(0)
    assert unmoved != moves
    assert torch.equal(a, run(0)[1])
    assert torch.equal(a, run(1)[1]) != moves


# ----------------------------------------------- the JAX package's own bars

def _store():
    return InteractionStore(make_interactions(), USERS, 100, seed=0)


def _bar_features():
    return np.random.default_rng(3).normal(size=(100, 12)).astype(np.float32)


def _train_decreases(model, batches, steps=40, lr=0.02):
    tr = Trainer(model, lr=lr, seed=0, device="cpu")
    losses = [float(tr.train_step(b)[0]) for b, _ in zip(batches,
                                                          range(steps))]
    assert np.isfinite(losses).all()
    assert np.mean(losses[-5:]) < np.mean(losses[:5])
    return tr


@pytest.mark.parametrize("name", ["VBPR", "VisualPMF", "VisualGMF",
                                  "ConcatVisualBPR"])
def test_models_train(name):
    """`test_vbpr_concat_pathway`, `test_visual_pointwise_models_train`
    and `test_concat_visual_bpr_trains` on the port."""
    kw = {"VBPR": dict(dim_user_embed=16, dim_item_embed=8),
          "ConcatVisualBPR": dict(dim_embed=12, dim_ve=4)}.get(
              name, dict(dim_embed=8, mlp_units=(16,)))
    model = getattr(models, name)(USERS, 100, item_features=_bar_features(),
                                  device="cpu", **kw)
    cls = (samplers.StratifiedPointwiseSampler if name in POINTWISE
           else samplers.PairwiseSampler)
    tr = _train_decreases(model, iter(cls(_store(), batch_size=64, seed=0)))
    with torch.no_grad():
        assert tuple(model.score({"user_id": torch.arange(4)}).shape) \
            == (4, 100)
    assert tr.global_step == 40


def test_visual_bpr_grad_rescale_applied():
    model = models.VisualBPR(USERS, 100, 8, mlp_units=(16,),
                             item_features=_bar_features(), device="cpu")
    batch = _torch(samplers.PairwiseSampler(_store(), batch_size=64,
                                            seed=0).sample())
    model.loss(batch)[0].backward()
    grads = {k: p.grad for k, p in model.params().items()}
    scaled = model.grad_transform(grads, batch)
    ratio = scaled["visual_mlp/0/w"] / grads["visual_mlp/0/w"]
    np.testing.assert_allclose(ratio[torch.isfinite(ratio)].numpy(),
                               1.0 / 64, rtol=1e-5)
    assert torch.equal(scaled["item_embed"], grads["item_embed"])


def test_visual_cml_censors():
    model = models.VisualCML(USERS, 100, 8, mlp_units=(16,),
                             item_features=_bar_features(), device="cpu")
    tr = Trainer(model, lr=0.05, seed=0, device="cpu")
    s = samplers.PairwiseSampler(_store(), batch_size=64, seed=0)
    for b, _ in zip(iter(s), range(30)):
        tr.train_step(b)
    norms = torch.linalg.vector_norm(model.item_embed.detach(), dim=1)
    assert norms.max() <= 1.0 + 1e-4


# ----------------------------------------------------------------- fusions

@pytest.mark.parametrize("weight", [1.0, 2.0, 0.5])
def test_fusions_match_jax(weight):
    rng = np.random.default_rng(int(weight * 10))
    xs = [rng.normal(size=(5, 4)).astype(np.float32) for _ in range(3)]
    got = fusions.average_fusion([torch.from_numpy(x) for x in xs], weight)
    want = jfusions.average_fusion([jnp.asarray(x) for x in xs], weight)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-7)
    for axis in (0, -1):
        np.testing.assert_array_equal(
            fusions.concat_fusion([torch.from_numpy(x) for x in xs],
                                  axis).numpy(),
            np.asarray(jfusions.concat_fusion([jnp.asarray(x) for x in xs],
                                              axis)))
    # the legacy models' Average(weight=2) of two inputs is their sum
    two = [torch.from_numpy(x) for x in xs[:2]]
    assert torch.equal(fusions.average_fusion(two, 2.0), two[0] + two[1])


# -------------------------------------------------------------- the device

@pytest.mark.parametrize("name", ["VBPR", "VisualBPR", "VisualCML",
                                  "VisualPMF", "VisualGMF",
                                  "ConcatVisualBPR"])
def test_new_models_need_cuda_or_explicit_cpu(name):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid")
    cls, widths, kw = SPECS[name]
    with pytest.raises(RuntimeError, match="CUDA"):
        getattr(port, cls)(4, ITEMS, *widths, item_features=FEATURES)
    model = getattr(port, cls)(4, ITEMS, *widths, item_features=FEATURES,
                               device="cpu")
    assert all(t.device.type == "cpu"
               for t in list(model.parameters()) + list(model.buffers()))
