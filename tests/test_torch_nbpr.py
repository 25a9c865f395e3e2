"""Port parity: NBPR and WCML, their losses and `NPairwiseSampler`.

The same numpy inputs go through the JAX package and the port: the
dot-product hinge and the multi-negative losses with autograd gradients
against jax.grad (a duplicated hardest negative included, whose gradient
both split evenly), the WARP rank weight, the (user, positive, K
negatives) streams of `NPairwiseSampler` directly and through
`Dataset.n_pairwise` with 2 workers, each model's loss, aux, gradients
and scores on parameters carried over by `convert`, 20 steps of lazy_adam
and keras_adam through both Trainers (WCML's censor included) on batches
whose rows repeat their hardest negative, and the JAX package's own
training bars (`tests/test_models_extended.py:89`, `:96`).

Tolerances: rtol = atol = 1e-5 for losses, gradients and scores; 20-step
parameters and losses rtol 1e-5, atol 1e-6; streams bit-identical.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from openrec_tpu import models as jmodels
from openrec_tpu.data import dataset as jdataset
from openrec_tpu.data import samplers as jsamplers
from openrec_tpu.data.store import InteractionStore as JStore
from openrec_tpu.modules import losses as jlosses
from openrec_tpu.training import Trainer as JTrainer
from openrec_tpu.training import optim as joptim
from openrec_tpu_torch import convert, models
from openrec_tpu_torch.data import Dataset, InteractionStore, samplers
from openrec_tpu_torch.modules import losses as tlosses
from openrec_tpu_torch.training import Trainer, optim as toptim
from tests.conftest import make_interactions

torch.set_num_threads(1)

TOL = 1e-5
RTOL, ATOL = 1e-5, 1e-6
USERS, ITEMS, DIM, BATCH, K, LR = 30, 70, 8, 16, 4, 1e-3
SPECS = {"NBPR": dict(l2_weight=0.01),
         "WCML": dict(margin=0.5, l2_weight=0.01)}


# ------------------------------------------------------------------ losses

def _loss_args(name, rng):
    def arr(*shape):
        return rng.normal(size=shape).astype(np.float32)
    if name.startswith("hinge"):
        args = [arr(9, 4), arr(9, 4), arr(9, 4)]
        if name == "hinge-bias":
            return args + [arr(9, 1), arr(9, 1)], {"margin": 0.7}
        return args, {}
    u, p, n = arr(9, 4), arr(9, 4), arr(9, K, 4)
    pb, nb = arr(9, 1), arr(9, K, 1)
    if name.endswith("tie"):
        # every row holds one negative (vector and bias) twice, in slots 1
        # and 2, and makes it the hardest by far (the others lie near the
        # origin): the min / max over K is a tie
        n, nb = 0.1 * n, 0.1 * nb
        n[:, 1] = 0.5 * u if name.startswith("multi-log") \
            else u + 0.05 * arr(9, 4)
        n[:, 2], nb[:, 2] = n[:, 1], nb[:, 1]
    kw = {"total_items": 70}
    if name.startswith("multi-eudist"):
        kw["margin"] = 0.5
    return [u, p, n, pb, nb], kw


LOSSES = {"hinge": "pairwise_hinge_loss", "hinge-bias": "pairwise_hinge_loss",
          "multi-log": "multi_neg_log_loss",
          "multi-log-tie": "multi_neg_log_loss",
          "multi-eudist": "multi_neg_eudist_loss",
          "multi-eudist-tie": "multi_neg_eudist_loss"}


@pytest.mark.parametrize("name", list(LOSSES))
def test_losses_and_gradients_match_jax(name):
    args, kw = _loss_args(name, np.random.default_rng(4))
    fn = LOSSES[name]
    argnums = tuple(range(len(args)))
    want, want_grads = jax.value_and_grad(
        lambda *a: getattr(jlosses, fn)(*a, **kw), argnums)(
            *map(jnp.asarray, args))
    inputs = [torch.from_numpy(a).requires_grad_() for a in args]
    got = getattr(tlosses, fn)(*inputs, **kw)
    got.backward()
    assert got.dim() == 0 and np.isfinite(got.item())
    np.testing.assert_allclose(got.item(), float(want), rtol=TOL, atol=TOL)
    for i, (x, g) in enumerate(zip(inputs, want_grads)):
        np.testing.assert_allclose(x.grad.numpy(), np.asarray(g), rtol=TOL,
                                   atol=TOL, err_msg=f"argument {i}")


@pytest.mark.parametrize("fn", ["multi_neg_log_loss",
                                "multi_neg_eudist_loss"])
def test_tied_hardest_negative_splits_its_gradient(fn):
    """The two copies of a tied hardest negative take half the gradient
    each, as jnp.min / jnp.max give it; torch.min(x, dim) would give all
    of it to one copy."""
    name = "multi-log-tie" if fn == "multi_neg_log_loss" \
        else "multi-eudist-tie"
    args, kw = _loss_args(name, np.random.default_rng(8))
    n = torch.from_numpy(args[2]).requires_grad_()
    getattr(tlosses, fn)(*map(torch.from_numpy, args[:2]), n,
                         *map(torch.from_numpy, args[3:]), **kw).backward()
    g = n.grad.numpy()
    np.testing.assert_allclose(g[:, 1], g[:, 2], rtol=1e-6, atol=1e-7)
    assert np.abs(g[:, 1]).max() > 1e-3
    np.testing.assert_array_equal(g[:, [0, 3]], 0.0)


@pytest.mark.parametrize("total_items", [70, 16_980, 450_166])
def test_rank_weight_is_bit_equal(total_items):
    v = np.arange(0, 6, dtype=np.int32)
    for k in (1, 4, 5):
        want = np.asarray(jlosses._rank_weight(jnp.asarray(v), k,
                                               total_items))
        got = tlosses._rank_weight(torch.from_numpy(v), k, total_items)
        np.testing.assert_array_equal(got.numpy(), want)


# ----------------------------------------------------------------- sampler

def _stores(data=None):
    data = make_interactions() if data is None else data
    return (InteractionStore(data, 40, 100, seed=0),
            JStore(data, 40, 100, seed=0))


@pytest.mark.parametrize("seed,k", [(0, 4), (3, 1), (11, 5)])
def test_npairwise_stream_bit_identical(seed, k):
    ts, js = _stores()
    tsam = samplers.NPairwiseSampler(ts, 64, k, seed=seed)
    jsam = jsamplers.NPairwiseSampler(js, 64, k, seed=seed)
    for _ in range(12):                      # past one epoch of 320 records
        got, want = tsam.sample(), jsam.sample()
        assert sorted(got) == sorted(want) \
            == ["n_item_id", "p_item_id", "user_id"]
        for key in want:
            assert got[key].dtype == want[key].dtype == np.int32
            np.testing.assert_array_equal(got[key], want[key], err_msg=key)
    assert got["n_item_id"].shape == (64, k)
    assert not ts.is_positive(np.repeat(got["user_id"], k),
                              got["n_item_id"].reshape(-1)).any()
    clone, jclone = tsam.with_seed((seed, 1)), jsam.with_seed((seed, 1))
    for _ in range(3):
        np.testing.assert_array_equal(clone.sample()["n_item_id"],
                                      jclone.sample()["n_item_id"])


def test_dataset_n_pairwise_two_workers_match_jax():
    """Dataset.n_pairwise with 2 workers: every batch is the next one of
    worker w's stream, the JAX sampler cloned with seed (seed, w)."""
    data = make_interactions(50, 300, 40, seed=3)
    ds, jds = Dataset(data, 50, 300, seed=3), jdataset.Dataset(data, 50,
                                                              300, seed=3)
    take = 12
    feed = ds.n_pairwise(64, 5, num_parallel_calls=2, take=take)
    jfeed = jds.n_pairwise(64, 5, num_parallel_calls=2, take=take)
    got = list(feed)
    feed.stop()
    jfeed.stop()
    assert len(got) == take
    streams = [[s.sample() for _ in range(take)] for s in
               (jfeed._sampler.with_seed((3, w)) for w in range(2))]
    pos = [0, 0]
    for g in got:
        for w in range(2):
            want = streams[w][pos[w]]
            if all(np.array_equal(g[key], want[key]) for key in want):
                pos[w] += 1
                break
        else:
            raise AssertionError("a batch is no worker's next batch")
    assert sum(pos) == take


# ------------------------------------------------------------------ models

def _models(name, seed=0):
    """(JAX model, numpy params, port model holding the same params)."""
    jmodel = getattr(jmodels, name)(USERS, ITEMS, DIM, **SPECS[name])
    params = jax.tree.map(np.asarray, jmodel.init(jax.random.PRNGKey(seed)))
    params["item_bias"] = np.random.default_rng(seed).normal(
        scale=0.1, size=(ITEMS, 1)).astype(np.float32)
    model = getattr(models, name)(USERS, ITEMS, DIM, device="cpu",
                                  **SPECS[name])
    model.load_params(convert.params_from_jax(params, device="cpu"))
    return jmodel, params, model


def _batch(rng, ties=4):
    """A (user, positive, K negatives) batch whose first `ties` rows hold
    each of their negatives twice ([a, a, b, b]), so the hardest negative
    is always tied there. No negative is its row's positive, as the
    sampler guarantees: there pos - neg is 0 up to the summation orders of
    two different products, and `diff < 0` may count it either way."""
    p = rng.integers(0, ITEMS, BATCH).astype(np.int32)
    n = rng.integers(0, ITEMS, (BATCH, K)).astype(np.int32)
    n[:ties, 1], n[:ties, 3] = n[:ties, 0], n[:ties, 2]
    n = np.where(n == p[:, None], (n + 1) % ITEMS, n).astype(np.int32)
    return {"user_id": rng.integers(0, USERS, BATCH).astype(np.int32),
            "p_item_id": p, "n_item_id": n}


@pytest.mark.parametrize("name", list(SPECS))
def test_loss_aux_and_grads_match_jax(name):
    jmodel, params, model = _models(name)
    batch = _batch(np.random.default_rng(1))
    (want, want_aux), want_grads = jax.value_and_grad(
        jmodel.loss, has_aux=True)(jax.tree.map(jnp.asarray, params),
                                   jax.tree.map(jnp.asarray, batch))
    loss, aux = model.loss({k: torch.from_numpy(v)
                            for k, v in batch.items()})
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


@pytest.mark.parametrize("optimizer", ["lazy_adam", "keras_adam"])
@pytest.mark.parametrize("name", list(SPECS))
def test_twenty_steps_match_jax(name, optimizer):
    """20 steps (two K-step calls of 10) from the same parameters; WCML's
    post_step censors the batch's user rows and p + n item rows after
    every step in both."""
    jmodel, params, model = _models(name)
    rng = np.random.default_rng(7)
    batches = [_batch(rng) for _ in range(20)]
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
    if name == "WCML":
        last = batches[-1]
        for table, ids in (("user_embed", last["user_id"]),
                           ("item_embed", np.concatenate(
                               [last["p_item_id"],
                                last["n_item_id"].reshape(-1)]))):
            norms = np.linalg.norm(want[table][ids], axis=1)
            assert np.all(norms <= 1.0 + 1e-4), table
            np.testing.assert_allclose(
                torch.linalg.vector_norm(tt.params[table][ids], dim=1)
                .detach().numpy(), norms, rtol=RTOL, atol=ATOL)


def test_wcml_censors_duplicate_ids_in_place():
    """A row named several times in one batch (as p and as several n) is
    projected once: its norm is min(||row||, 1) / max(||row||, 0.1) of the
    row before the step's censor."""
    _, _, model = _models("WCML")
    with torch.no_grad():
        model.item_embed[5] *= 100.0
    batch = {"user_id": np.array([1, 1], np.int32),
             "p_item_id": np.array([5, 6], np.int32),
             "n_item_id": np.array([[5, 5, 7, 5], [6, 6, 5, 8]], np.int32)}
    model.post_step(batch)
    norms = torch.linalg.vector_norm(model.item_embed[[5, 6, 7, 8]], dim=1)
    assert torch.all(norms <= 1.0 + 1e-6)
    np.testing.assert_allclose(norms[0].item(), 1.0, rtol=1e-6)


# ----------------------------------------------- the JAX package's own bars

def _train_losses(model, batches, steps, lr):
    tt = Trainer(model, lr=lr, seed=0, device="cpu")
    losses = []
    for i, b in enumerate(batches):
        if i >= steps:
            break
        losses.append(float(tt.train_step(b)[0]))
    assert np.isfinite(losses).all(), losses[:5]
    return tt, losses


def test_nbpr_trains():
    """tests/test_models_extended.py:89 on the port."""
    store, _ = _stores()
    model = models.NBPR(40, 100, 8, device="cpu",
                        generator=torch.Generator().manual_seed(0))
    s = samplers.NPairwiseSampler(store, batch_size=64, num_negatives=4,
                                  seed=0)
    _, losses = _train_losses(model, iter(s), 150, 0.05)
    assert np.mean(losses[-5:]) < np.mean(losses[:5])


def test_wcml_trains_and_censors():
    """tests/test_models_extended.py:96 on the port."""
    store, _ = _stores()
    model = models.WCML(40, 100, 8, margin=0.5, device="cpu",
                        generator=torch.Generator().manual_seed(0))
    s = samplers.NPairwiseSampler(store, batch_size=64, num_negatives=4,
                                  seed=0)
    _train_losses(model, iter(s), 40, 0.05)
    norms = torch.linalg.vector_norm(model.item_embed.detach(), dim=1)
    assert norms.max() <= 1.0 + 1e-4
