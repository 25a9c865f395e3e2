"""Port parity: PMF, WRMF, GMF and UCML against the JAX package on the same
parameters (carried over by `convert`) and the same numpy batches: their
losses, each model's loss, aux and autograd gradients against jax.grad,
20 steps of lazy_adam and keras_adam through the Trainer (UCML's unit-ball
censoring as `post_step` included), full-catalog scores, and the JAX
package's npz checkpoints restored by the port and back.

Tolerances: rtol = atol = 1e-5 for losses, gradients and scores (fp32 sums
in another order); 20-step parameters and losses rtol 1e-5, atol 1e-6.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from openrec_tpu import checkpoint as jckpt
from openrec_tpu import models as jmodels
from openrec_tpu.modules import losses as jlosses
from openrec_tpu.training import Trainer as JTrainer
from openrec_tpu.training import optim as joptim
from openrec_tpu_torch import checkpoint as tckpt
from openrec_tpu_torch import convert, models
from openrec_tpu_torch.modules import losses as tlosses
from openrec_tpu_torch.modules.embedding import censor_norm, censor_norm_
from openrec_tpu_torch.training import Trainer, optim as toptim

torch.set_num_threads(1)

TOL = 1e-5
RTOL, ATOL = 1e-5, 1e-6
USERS, ITEMS, DIM, BATCH, LR = 30, 70, 8, 16, 1e-3

# name: (model class name, keyword arguments, batch kind)
SPECS = {
    "PMF": ("PMF", dict(a=1.0, b=0.2, l2_reg=0.01), "pointwise"),
    "PMF-sigmoid": ("PMF", dict(a=2.0, b=0.5, sigmoid=True), "pointwise"),
    "WRMF": ("WRMF", dict(a=1.0, b=0.01, l2_weight=0.001), "pointwise"),
    "WRMF-sigmoid": ("WRMF", dict(a=3.0, b=1.0, sigmoid=True,
                                  l2_weight=0.1), "pointwise"),
    "GMF": ("GMF", dict(l2_weight=0.01), "pointwise"),
    "UCML": ("UCML", dict(margin=0.5, l2_weight=0.01), "pairwise"),
}


def _models(name, seed=0):
    """(JAX model, numpy params, port model holding the same params)."""
    cls, kw, _ = SPECS[name]
    jmodel = getattr(jmodels, cls)(USERS, ITEMS, DIM, DIM, **kw)
    params = jax.tree.map(np.asarray, jmodel.init(jax.random.PRNGKey(seed)))
    params["item_bias"] = np.random.default_rng(seed).normal(
        scale=0.1, size=(ITEMS, 1)).astype(np.float32)
    model = getattr(models, cls)(USERS, ITEMS, DIM, DIM, device="cpu", **kw)
    model.load_params(convert.params_from_jax(params, device="cpu"))
    return jmodel, params, model


def _batch(kind, rng):
    users = rng.integers(0, USERS, BATCH).astype(np.int32)
    if kind == "pairwise":
        return {"user_id": users,
                "p_item_id": rng.integers(0, ITEMS, BATCH).astype(np.int32),
                "n_item_id": rng.integers(0, ITEMS, BATCH).astype(np.int32)}
    return {"user_id": users,
            "item_id": rng.integers(0, ITEMS, BATCH).astype(np.int32),
            "label": (rng.random(BATCH) < 0.3).astype(np.float32)}


def _torch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


# ------------------------------------------------------------------ losses

def _loss_args(name, rng):
    def arr(*shape):
        return rng.normal(size=shape).astype(np.float32)
    if name == "eudist":
        return [arr(9, 4), arr(9, 4), arr(9, 4)], {}
    if name == "eudist-bias":
        return [arr(9, 4), arr(9, 4), arr(9, 4), arr(9, 1), arr(9, 1)], \
            {"margin": 1.5}
    label = (rng.random(9) < 0.5).astype(np.float32)
    if name.startswith("mse"):
        kw = {"a": 2.0, "b": 0.3, "sigmoid": name == "mse-sigmoid"}
        return [arr(9, 4), arr(9, 4), arr(9, 1), label], kw
    # logits up to |100|: the stable form must not overflow
    logit = arr(9) * 10.0
    logit[:4] = [100.0, -100.0, 60.0, -0.0]
    return [label, logit], {"reduction": name.split("-")[1]}


@pytest.mark.parametrize("name", ["eudist", "eudist-bias", "mse",
                                  "mse-sigmoid", "bce-mean", "bce-sum"])
def test_losses_match_jax(name):
    args, kw = _loss_args(name, np.random.default_rng(4))
    fn = {"eudist": "pairwise_eudist_hinge_loss",
          "mse": "pointwise_mse_loss",
          "bce": "bce_logits_loss"}[name.split("-")[0]]
    want = float(getattr(jlosses, fn)(*map(jnp.asarray, args), **kw))
    got = getattr(tlosses, fn)(*map(torch.from_numpy, args), **kw)
    assert got.dim() == 0 and np.isfinite(got.item())
    np.testing.assert_allclose(got.item(), want, rtol=TOL, atol=TOL)


def test_bce_logits_loss_is_the_stable_formula():
    """max(x, 0) - x*y + log1p(exp(-|x|)) in float64, per element, where
    the naive log(sigmoid) form overflows."""
    x = np.array([100.0, -100.0, 30.0, -30.0, 0.0, 2.5], np.float32)
    y = np.array([0.0, 1.0, 1.0, 0.0, 1.0, 0.0], np.float32)
    x64, y64 = x.astype(np.float64), y.astype(np.float64)
    want = np.maximum(x64, 0) - x64 * y64 + np.log1p(np.exp(-np.abs(x64)))
    got = tlosses.bce_logits_loss(torch.from_numpy(y), torch.from_numpy(x),
                                  reduction="sum")
    np.testing.assert_allclose(got.item(), want.sum(), rtol=1e-6)
    assert want[0] == 100.0 and want[1] == 100.0


# ------------------------------------------------------------------ models

@pytest.mark.parametrize("name", list(SPECS))
def test_loss_aux_and_grads_match_jax(name):
    jmodel, params, model = _models(name)
    batch = _batch(SPECS[name][2], np.random.default_rng(1))
    (want, want_aux), want_grads = jax.value_and_grad(
        jmodel.loss, has_aux=True)(jax.tree.map(jnp.asarray, params),
                                   jax.tree.map(jnp.asarray, batch))
    loss, aux = model.loss(_torch(batch))
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(want), rtol=TOL, atol=TOL)
    assert sorted(aux) == sorted(want_aux) == ["l2_loss", "loss"]
    for key in aux:
        np.testing.assert_allclose(aux[key].item(), float(want_aux[key]),
                                   rtol=TOL, atol=TOL)
    flat_grads = convert.flatten_tree(want_grads)
    assert sorted(flat_grads) == sorted(model.params())
    for key, param in model.params().items():
        np.testing.assert_allclose(param.grad.numpy(),
                                   np.asarray(flat_grads[key]),
                                   rtol=TOL, atol=TOL, err_msg=key)


@pytest.mark.parametrize("name", list(SPECS))
def test_score_matches_jax(name):
    jmodel, params, model = _models(name)
    users = np.array([0, 5, 29, 12, 12], np.int32)
    want = np.asarray(jmodel.score(jax.tree.map(jnp.asarray, params),
                                   {"user_id": users}))
    with torch.no_grad():
        got = model.score({"user_id": torch.from_numpy(users)})
    assert tuple(got.shape) == want.shape == (5, ITEMS)
    np.testing.assert_allclose(got.numpy(), want, rtol=TOL, atol=TOL)


def test_gmf_serving_applies_w_once():
    """GMF's score is (u * w).V^T + b, the full Dense_1(u * v) + b at
    every item; its user side `user_vecs` is u * w, not u * w^2."""
    _, params, model = _models("GMF")
    u, v, b = (params["user_embed"], params["item_embed"],
               params["item_bias"])
    w = params["mlp"][0]["w"]
    want = np.einsum("bd,id->bi", u[[3, 4]], v * w[:, 0]) + b[:, 0]
    with torch.no_grad():
        got = model.score({"user_id": torch.tensor([3, 4])})
        side = model.user_vecs(torch.tensor([3]))
    np.testing.assert_allclose(got.numpy(), want, rtol=TOL, atol=TOL)
    np.testing.assert_allclose(side.numpy(), u[[3]] * w[:, 0], rtol=1e-7)


def test_pmf_init_is_truncated_normal():
    g = torch.Generator().manual_seed(3)
    model = models.PMF(200, 300, 16, 16, device="cpu", generator=g)
    for table in (model.user_embed, model.item_embed):
        t = table.detach()
        assert t.abs().max() <= 0.02 and 0.007 < t.std() < 0.0095
    assert not model.item_bias.any()
    again = models.PMF(200, 300, 16, 16, device="cpu",
                       generator=torch.Generator().manual_seed(3))
    assert torch.equal(again.user_embed, model.user_embed)


# ---------------------------------------------------------------- training

@pytest.mark.parametrize("optimizer", ["lazy_adam", "keras_adam"])
@pytest.mark.parametrize("name", ["PMF", "WRMF", "GMF", "UCML"])
def test_twenty_steps_match_jax(name, optimizer):
    """20 steps (two K-step calls of 10) from the same parameters; UCML's
    post_step censors the batch's rows after every step in both."""
    jmodel, params, model = _models(name)
    rng = np.random.default_rng(7)
    batches = [_batch(SPECS[name][2], rng) for _ in range(20)]
    jt = JTrainer(jmodel, optimizer=getattr(joptim, optimizer)(LR), seed=0)
    jt.params = jax.tree.map(jnp.asarray, params)
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
    if name == "UCML":
        last = batches[-1]
        for table, ids in (("user_embed", last["user_id"]),
                           ("item_embed", np.concatenate(
                               [last["p_item_id"], last["n_item_id"]]))):
            norms = np.linalg.norm(want[table][ids], axis=1)
            assert np.all(norms <= 1.0 + 1e-4), table


def test_ucml_censored_rows_stay_put_under_lazy_adam():
    """After a censor, a row that no later batch touches keeps its bits:
    lazy_adam moves only rows with a nonzero gradient (the JAX package's
    tests/test_models_train.py:46-64 relies on it)."""
    _, _, model = _models("UCML")
    tt = Trainer(model, optimizer=toptim.lazy_adam(0.05), device="cpu")
    first = {"user_id": np.array([1, 2, 2], np.int32),
             "p_item_id": np.array([10, 11, 11], np.int32),
             "n_item_id": np.array([12, 10, 13], np.int32)}
    tt.train_step(first)
    users = model.user_embed.detach().clone()
    items = model.item_embed.detach().clone()
    np.testing.assert_allclose(
        torch.linalg.vector_norm(items[[10, 11, 12, 13]], dim=1).numpy(),
        1.0, rtol=1e-6)
    for _ in range(3):
        tt.train_step({"user_id": np.array([5, 6, 7], np.int32),
                       "p_item_id": np.array([20, 21, 22], np.int32),
                       "n_item_id": np.array([23, 24, 25], np.int32)})
    assert torch.equal(model.user_embed[[1, 2]], users[[1, 2]])
    assert torch.equal(model.item_embed[10:14], items[10:14])
    assert not torch.equal(model.item_embed[20:26], items[20:26])


def test_censor_norm_in_place_matches_functional_with_duplicates():
    rng = np.random.default_rng(5)
    table = torch.from_numpy((rng.normal(size=(12, 5)) * 2)
                             .astype(np.float32))
    table[4] *= 0.01                              # a row below eps
    ids = torch.tensor([0, 4, 4, 7, 11, 0])
    want = censor_norm(table, ids)
    before = table.clone()
    out = censor_norm_(table, ids)
    assert out is table and torch.equal(table, want)
    untouched = [i for i in range(12) if i not in (0, 4, 7, 11)]
    assert torch.equal(table[untouched], before[untouched])


# ------------------------------------------------------------- checkpoints

@pytest.mark.parametrize("name", ["PMF", "WRMF", "GMF", "UCML"])
def test_jax_checkpoints_restore_both_ways(name, tmp_path):
    jmodel, params, model = _models(name, seed=2)
    path = jckpt.save(str(tmp_path / "jax"), 4, params)
    fresh = getattr(models, SPECS[name][0])(USERS, ITEMS, DIM, DIM,
                                            device="cpu")
    fresh.load_params(tckpt.restore(path, device="cpu"))
    for key, value in convert.flatten_tree(params).items():
        np.testing.assert_array_equal(fresh.params()[key].detach().numpy(),
                                      value, err_msg=key)
    back = tckpt.save(str(tmp_path / "torch"), 5, fresh.params())
    template = jmodel.init(jax.random.PRNGKey(9))
    got = jax.tree.map(np.asarray, jckpt.restore(back, template=template))
    assert jax.tree.structure(got) == jax.tree.structure(template)
    for key, value in convert.flatten_tree(got).items():
        np.testing.assert_array_equal(value, convert.flatten_tree(
            params)[key], err_msg=key)
    # the params tree crosses convert both ways, lists included (GMF's mlp)
    again = convert.params_to_numpy(convert.params_from_jax(params,
                                                            device="cpu"))
    assert sorted(convert.flatten_tree(again)) \
        == sorted(convert.flatten_tree(params))
