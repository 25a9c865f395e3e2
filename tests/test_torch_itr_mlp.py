"""Port parity: ItrMLP, the temporal embedding forward-propagation model.

The same numpy inputs go through the JAX package and the port: the
parameter tree's names and shapes; loss, aux and gradients against
`jax.grad`, with zero gradients on the frozen tables and the flags;
`post_step`'s flags; `update_embeddings` on planted flags, whose MLP
normalises over the whole table; `pretrain_identity` on JAX's own
uniforms (its draw sequence replayed: one split a step, carried from the
user MLP to the item MLP); `score`, `user_vecs` and `serving_tables`;
20 Trainer steps under `lazy_adam` and `keras_adam` with
`update_interval`, against JAX's `Trainer.train`, the tables moving only
through the updates; npz checkpoints both ways; `pretrained_*_embeddings`;
and the generator rule: ItrMLP draws nothing, so the Trainer's generator
does not move. The JAX package's own bar is mirrored
(`tests/test_models_extended.py:228-254`).

Tolerances: rtol = atol = 1e-5 for losses, gradients, updates, scores and
pretrained MLPs; 20-step trajectories as `tests/test_torch_explicit.py`'s
`assert_itr_mlp_close` states them (the MLP biases before a batch norm
step on rounding noise in both packages and are held by their bound and
by the scores).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from openrec_tpu import checkpoint as jckpt
from openrec_tpu.models import ItrMLP as JItrMLP
from openrec_tpu.training import Trainer as JTrainer
from openrec_tpu.training import optim as joptim
from openrec_tpu_torch import checkpoint as tckpt
from openrec_tpu_torch import convert, models
from openrec_tpu_torch.models.itr_mlp import pretrain_mlp_identity
from openrec_tpu_torch.training import Trainer, optim as toptim
from tests.test_torch_explicit import assert_itr_mlp_close

torch.set_num_threads(1)

TOL = 1e-5
USERS, ITEMS, B, LR = 30, 40, 16, 1e-3

SPECS = {
    "default": dict(total_users=USERS, total_items=ITEMS, dim_embed=6),
    "deep": dict(total_users=USERS, total_items=ITEMS, dim_embed=6,
                 user_dims=(10, 8, 6), item_dims=(12, 6)),
    "weighted": dict(total_users=USERS, total_items=ITEMS, dim_embed=6,
                     user_dims=(10, 6), item_dims=(10, 6), a=2.0, b=0.5),
}


def _models(name="deep", seed=0):
    """(JAX model, numpy params, port model holding the same params);
    tables widened from 0.01 and a nonzero item bias, so that the batch
    norms and scores are far from flat."""
    kw = SPECS[name]
    jmodel = JItrMLP(**kw)
    params = jax.tree.map(np.asarray, jmodel.init(jax.random.PRNGKey(seed)))
    rng = np.random.default_rng(seed + 100)
    for key in ("user_embed", "item_embed"):
        params[key] = params[key] * 30.0
    params["item_bias"] = rng.normal(scale=0.3, size=(ITEMS, 1)).astype(
        np.float32)
    model = models.ItrMLP(**kw, device="cpu")
    model.load_params(convert.params_from_jax(params, device="cpu"))
    return jmodel, params, model


def _batch(rng, batch=B):
    return {"user_id": rng.integers(0, USERS, batch).astype(np.int32),
            "item_id": rng.integers(0, ITEMS, batch).astype(np.int32),
            "label": rng.uniform(0, 1, batch).astype(np.float32)}


def _torch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _flat(params):
    return convert.flatten_tree(jax.tree.map(np.asarray, params))


def _assert_params(model, jparams, tol=TOL, noise_bound=None):
    """The port's parameters against JAX's. With `noise_bound`, the MLPs'
    biases `b` (each before a batch norm: true gradient 0, stepped by
    Adam on rounding noise) are held to |b| <= noise_bound instead."""
    want = _flat(jparams)
    for key, value in model.params().items():
        got = value.detach().numpy()
        if noise_bound is not None and "_mlp/" in key and key.endswith("/b"):
            assert np.abs(got).max() <= noise_bound, key
            assert np.abs(want[key]).max() <= noise_bound, key
            continue
        np.testing.assert_allclose(got, want[key], rtol=tol, atol=tol,
                                   err_msg=key)


@pytest.mark.parametrize("name", list(SPECS))
def test_param_names_and_shapes_are_the_jax_tree(name):
    _, params, model = _models(name)
    want = {k: v.shape for k, v in convert.flatten_tree(params).items()}
    got = {k: tuple(v.shape) for k, v in model.params().items()}
    assert got == want
    layers = len(SPECS[name].get("user_dims", ())) or 1
    for i in range(layers):
        assert {f"user_mlp/{i}/{p}" for p in ("w", "b", "bn_scale",
                                               "bn_bias")} <= set(got)
    assert got["user_flag"] == (USERS,) and got["item_bias"] == (ITEMS, 1)


def test_init_is_jax_law():
    """Tables 0.01 x a normal truncated at 2; flags and bias zero; the
    MLPs glorot with batch norm at scale 1 and bias 0."""
    model = models.ItrMLP(2000, 3000, 20, user_dims=(30, 20), device="cpu",
                          generator=torch.Generator().manual_seed(0))
    for t in (model.user_embed, model.item_embed):
        assert t.abs().max() <= 0.02
        assert abs(t.std().item() - 0.01 * 0.8796) < 2e-4
    for t in (model.user_flag, model.item_flag, model.item_bias):
        assert not t.any()
    assert model.user_mlp[0].w.abs().max() <= np.sqrt(6.0 / 50)
    assert torch.equal(model.user_mlp[1].bn_scale, torch.ones(20))
    assert not model.item_mlp[0].bn_bias.any()


@pytest.mark.parametrize("name", list(SPECS))
def test_loss_and_grads_match_jax(name):
    """Loss, aux and gradients against jax.grad; the tables and the flags
    get none in the port (detached) and zeros in JAX."""
    jmodel, params, model = _models(name)
    batch = _batch(np.random.default_rng(1))
    (want, want_aux), want_grads = jax.value_and_grad(
        jmodel.loss, has_aux=True)(jax.tree.map(jnp.asarray, params),
                                   jax.tree.map(jnp.asarray, batch))
    loss, aux = model.loss(_torch(batch))
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(want), rtol=TOL, atol=TOL)
    assert sorted(aux) == sorted(want_aux) == ["loss"]
    flat = convert.flatten_tree(want_grads)
    frozen = ("user_embed", "item_embed", "user_flag", "item_flag")
    for key, param in model.params().items():
        if key in frozen:
            assert param.grad is None
            assert not np.asarray(flat[key]).any()
            continue
        np.testing.assert_allclose(param.grad.numpy(), np.asarray(flat[key]),
                                   rtol=TOL, atol=TOL, err_msg=key)
    assert np.abs(np.asarray(flat["item_bias"])).sum() > 0


def test_post_step_marks_visited_rows():
    jmodel, params, model = _models()
    batch = _batch(np.random.default_rng(2))
    batch["user_id"][:3] = 7          # a repeated id
    want = jmodel.post_step(jax.tree.map(jnp.asarray, params),
                            jax.tree.map(jnp.asarray, batch))
    model.post_step(_torch(batch))
    for key in ("user_flag", "item_flag"):
        np.testing.assert_array_equal(model.params()[key].detach().numpy(),
                                      np.asarray(want[key]), err_msg=key)
    assert model.user_flag.sum() == len(np.unique(batch["user_id"]))


def test_update_embeddings_on_planted_flags():
    """Flagged rows get MLP(table) with the batch norm over EVERY row of
    the table, as JAX's; the other rows keep their bits; the flags clear.
    The MLP over the flagged rows alone would give other rows."""
    jmodel, params, model = _models(seed=3)
    rng = np.random.default_rng(3)
    for key, n in (("user_flag", USERS), ("item_flag", ITEMS)):
        flag = (rng.random(n) < 0.3).astype(np.float32)
        flag[:2] = [1.0, 0.0]
        params[key] = flag
    model.load_params(convert.params_from_jax(params, device="cpu"))
    before = {k: v.detach().clone() for k, v in model.params().items()}
    want = jmodel.update_embeddings(jax.tree.map(jnp.asarray, params))
    model.update_embeddings()
    _assert_params(model, want)
    for table, flag, mlp in (("user_embed", "user_flag", model.user_mlp),
                             ("item_embed", "item_flag", model.item_mlp)):
        mask = torch.from_numpy(params[flag] > 0)
        now = model.params()[table].detach()
        assert torch.equal(now[~mask], before[table][~mask])
        assert not torch.allclose(now[mask], before[table][mask])
        with torch.no_grad():
            alone = mlp(before[table][mask])
        assert not torch.allclose(alone, now[mask], rtol=1e-3, atol=1e-3)
        assert not model.params()[flag].any()


def _jax_uniforms(rng, steps, batch, dim):
    """JAX pretrain_identity's inputs: per step rng, sub = split(rng), x =
    uniform(sub, -0.5, 0.5); the user MLP's steps, then the item MLP's
    from the same carried rng (`openrec_tpu/models/itr_mlp.py:151-154`)."""
    out = []
    for _ in range(2):
        xs = []
        for _ in range(steps):
            rng, sub = jax.random.split(rng)
            xs.append(np.asarray(jax.random.uniform(
                sub, (batch, dim), minval=-0.5, maxval=0.5)))
        out.append(xs)
    return out


@pytest.mark.parametrize("name", ["default", "deep"])
def test_pretrain_identity_on_jax_uniforms(name):
    """Both MLPs after 25 optax-Adam steps on JAX's replayed inputs
    (`_assert_params`' noise bound on the biases before a batch norm),
    and their outputs."""
    jmodel, params, model = _models(name)
    steps, batch, lr = 25, 32, 1e-2
    want = jmodel.pretrain_identity(jax.tree.map(jnp.asarray, params),
                                    jax.random.PRNGKey(4), steps=steps,
                                    batch=batch, lr=lr)
    user_x, item_x = _jax_uniforms(jax.random.PRNGKey(4), steps, batch, 6)
    pretrain_mlp_identity(model.user_mlp, map(torch.tensor, user_x), lr)
    pretrain_mlp_identity(model.item_mlp, map(torch.tensor, item_x), lr)
    _assert_params(model, want, noise_bound=steps * lr)
    assert not np.allclose(_flat(want)["user_mlp/0/w"],
                           convert.flatten_tree(params)["user_mlp/0/w"])
    # the MLPs themselves agree on the last inputs
    for mlp, key, x in ((model.user_mlp, "user_mlp", user_x[-1]),
                        (model.item_mlp, "item_mlp", item_x[-1])):
        with torch.no_grad():
            got = mlp(torch.tensor(x)).numpy()
        np.testing.assert_allclose(got, np.asarray(getattr(
            jmodel, f"_{key}").apply(want[key], x)), rtol=TOL, atol=TOL)


def test_pretrain_identity_draws_its_inputs_from_the_generator():
    """pretrain_identity(generator) is pretrain_mlp_identity on that
    generator's U(-0.5, 0.5) draws, user MLP first; and it pulls the MLPs
    toward the identity (tests/test_models_extended.py:228)."""
    _, _, model = _models()
    _, _, ref = _models()
    x = torch.rand((32, 6), generator=torch.Generator().manual_seed(1)) - 0.5

    def gap(m):
        with torch.no_grad():
            return (m.user_mlp(x) - x).abs().mean().item()
    before = gap(model)
    model.pretrain_identity(torch.Generator().manual_seed(5), steps=300,
                            batch=32, lr=1e-2)
    gen = torch.Generator().manual_seed(5)
    for mlp in (ref.user_mlp, ref.item_mlp):
        pretrain_mlp_identity(mlp, [torch.rand((32, 6), generator=gen) - 0.5
                                    for _ in range(300)], 1e-2)
    for key, value in model.params().items():
        assert torch.equal(value, ref.params()[key]), key
    assert gap(model) < before


@pytest.mark.parametrize("name", ["deep", "weighted"])
def test_scores_and_serving_tables_match_jax(name):
    """score against JAX's (sigmoid of the user MLP over the request's rows
    against the item MLP over the full table); sigmoid(user_vecs . table
    + bias) is the score, the table contiguous: what K1/K2/K3 serve."""
    jmodel, params, model = _models(name)
    users = np.random.default_rng(5).integers(0, USERS, 13).astype(np.int32)
    with torch.no_grad():
        got = model.score({"user_id": torch.from_numpy(users)})
        u = model.user_vecs({"user_id": torch.from_numpy(users)})
    want = np.asarray(jmodel.score(params, {"user_id": users}))
    assert tuple(got.shape) == want.shape == (13, ITEMS)
    np.testing.assert_allclose(got.numpy(), want, rtol=TOL, atol=TOL)
    table, bias = model.serving_tables()
    assert table.is_contiguous() and tuple(table.shape) == (ITEMS, 6)
    assert tuple(bias.shape) == (ITEMS,) and not table.requires_grad
    np.testing.assert_allclose(torch.sigmoid(u @ table.T + bias).numpy(),
                               got.numpy(), rtol=TOL, atol=TOL)
    np.testing.assert_allclose(
        u.numpy(), np.asarray(jmodel._user_vec(params, users)), rtol=TOL,
        atol=TOL)


def _trainers(name, optimizer):
    jmodel, params, model = _models(name)
    jt = JTrainer(jmodel, optimizer=getattr(joptim, optimizer)(LR), seed=0)
    jt.params = jax.tree.map(jnp.asarray, params)
    jt.opt_state = jt.tx.init(jt.params)
    tt = Trainer(model, optimizer=getattr(toptim, optimizer)(LR),
                 device="cpu")
    return jmodel, jt, tt


@pytest.mark.parametrize("optimizer", ["lazy_adam", "keras_adam"])
@pytest.mark.parametrize("name", ["deep", "weighted"])
def test_twenty_steps_with_updates_match_jax(name, optimizer):
    """20 steps through both Trainers' train(update_interval=5), from the
    same weights: losses and parameters agree."""
    jmodel, jt, tt = _trainers(name, optimizer)
    rng = np.random.default_rng(7)
    batches = [_batch(rng) for _ in range(20)]
    jt.train(total_iter=20, train_batches=batches, update_interval=5,
             verbose=False)
    tt.train(total_iter=20, train_batches=batches, update_interval=5,
             verbose=False)
    assert tt.global_step == jt.global_step == 20
    assert_itr_mlp_close(jmodel, jt.params, tt.model, steps=20)


@pytest.mark.parametrize("optimizer", ["lazy_adam", "keras_adam"])
def test_tables_move_only_through_updates(optimizer):
    """Without update_interval, 20 steps leave the tables' bits (lazy_adam
    touches none of their rows, keras_adam's zero moments step by 0), in
    JAX as here; the flags are set, their moments zero; the losses agree."""
    jmodel, jt, tt = _trainers("deep", optimizer)
    before = {k: v.detach().clone() for k, v in tt.params.items()}
    rng = np.random.default_rng(8)
    batches = [_batch(rng) for _ in range(20)]
    jl = np.concatenate([np.asarray(jt.train_step_multi(batches[:10])),
                         np.asarray(jt.train_step_multi(batches[10:]))])
    tl = torch.cat([tt.train_step_multi(batches[:10]),
                    tt.train_step_multi(batches[10:])]).numpy()
    np.testing.assert_allclose(tl, jl, rtol=TOL, atol=1e-6)
    want = _flat(jt.params)
    for key in ("user_embed", "item_embed"):
        assert torch.equal(tt.params[key], before[key])
        np.testing.assert_array_equal(want[key], before[key].numpy())
        assert not tt.opt_state.mu[key].any()
        assert not tt.opt_state.nu[key].any()
    for key in ("user_flag", "item_flag"):
        np.testing.assert_array_equal(tt.params[key].detach().numpy(),
                                      want[key])
        assert tt.params[key].sum() > 0 and not tt.opt_state.mu[key].any()
    assert not torch.equal(tt.params["item_bias"], before["item_bias"])


def test_trainer_generator_does_not_move():
    """ItrMLP draws nothing in its loss: the Trainer's generator stays
    where it was, and two seeds give one trajectory."""
    rng = np.random.default_rng(3)
    batches = [_batch(rng) for _ in range(3)]

    def run(seed):
        _, _, model = _models()
        tt = Trainer(model, lr=LR, seed=seed, device="cpu")
        state = tt.generator.get_state()
        losses = torch.cat([tt.train_step_multi(batches[:2]),
                            tt.train_step(batches[2])[0][None]])
        return torch.equal(tt.generator.get_state(), state), losses
    unmoved, a = run(0)
    assert unmoved
    assert torch.equal(a, run(1)[1])


def test_jax_checkpoints_restore_both_ways(tmp_path):
    jmodel, params, _ = _models(seed=2)
    params["user_flag"] = np.array(params["user_flag"])
    params["user_flag"][[1, 4]] = 1.0
    path = jckpt.save(str(tmp_path / "jax"), 4, params)
    fresh = models.ItrMLP(**SPECS["deep"], device="cpu")
    fresh.load_params(tckpt.restore(path, device="cpu"))
    for key, value in convert.flatten_tree(params).items():
        np.testing.assert_array_equal(fresh.params()[key].detach().numpy(),
                                      value, err_msg=key)
    back = tckpt.save(str(tmp_path / "torch"), 5, fresh.params())
    template = jmodel.init(jax.random.PRNGKey(9))
    got = jax.tree.map(np.asarray, jckpt.restore(back, template=template))
    assert jax.tree.structure(got) == jax.tree.structure(template)
    for key, value in convert.flatten_tree(got).items():
        np.testing.assert_array_equal(
            value, convert.flatten_tree(params)[key], err_msg=key)


def test_pretrained_embeddings():
    """pretrained_*_embeddings become the tables, as float32, in both
    packages; the rest of the init is unchanged."""
    rng = np.random.default_rng(6)
    users = rng.normal(size=(USERS, 6))                  # float64
    items = rng.normal(size=(ITEMS, 6)).astype(np.float32)
    kw = dict(SPECS["deep"], pretrained_user_embeddings=users,
              pretrained_item_embeddings=items)
    jparams = JItrMLP(**kw).init(jax.random.PRNGKey(0))
    model = models.ItrMLP(**kw, device="cpu")
    for key, want in (("user_embed", users), ("item_embed", items)):
        got = model.params()[key].detach()
        assert got.dtype == torch.float32
        np.testing.assert_array_equal(got.numpy(), want.astype(np.float32))
        np.testing.assert_array_equal(got.numpy(), np.asarray(jparams[key]))
    items[0, 0] = 99.0                # the model holds its own copy
    assert model.item_embed[0, 0] != 99.0
