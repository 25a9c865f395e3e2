"""Port parity: MLPRec and NeuMF (the NCF family), dropout drawn from the
Trainer's generator, and the numpy evaluators.

The same numpy inputs go through the JAX package and the port: parameter
names (the MLP's bias-less output layer, NeuMF's `ge_h/0/w`), each
model's loss, aux and autograd gradients against jax.grad with dropout
off, chunked full-catalog scores, 20 steps of lazy_adam and keras_adam
through both Trainers, npz checkpoints both ways, and every function of
`metrics/numpy_eval.py` with `EvalManager` in full and sampled mode on the
same score rows. Dropout draws from a torch.Generator, so its law is held
instead of JAX's bits: each kept unit is x / keep and the rest 0, the keep
rate lies within binomial bounds, one seed gives one loss, `score` draws
nothing, and the Trainer's generator moves only for a model that draws.
The JAX package's own bars are mirrored
(`tests/test_ncf_and_numpy_eval.py:34`, `:54`, `:67`, `:87`, `:101`).

Tolerances: rtol = atol = 1e-5 for losses, gradients and scores; 20-step
parameters and losses rtol 1e-5, atol 1e-6; numpy_eval bit-equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from openrec_tpu import checkpoint as jckpt
from openrec_tpu import models as jmodels
from openrec_tpu.data.store import InteractionStore as JStore
from openrec_tpu.metrics import numpy_eval as jeval
from openrec_tpu.training import Trainer as JTrainer
from openrec_tpu.training import optim as joptim
import openrec_tpu_torch as port
from openrec_tpu_torch import checkpoint as tckpt
from openrec_tpu_torch import convert, models
from openrec_tpu_torch.data import InteractionStore, samplers
from openrec_tpu_torch.metrics import numpy_eval as teval
from openrec_tpu_torch.modules.mlp import MLP
from openrec_tpu_torch.training import Trainer, optim as toptim
from tests.conftest import make_interactions

torch.set_num_threads(1)

TOL = 1e-5
RTOL, ATOL = 1e-5, 1e-6
USERS, ITEMS, DIM, BATCH, LR = 30, 70, 8, 16, 1e-3

# name: (positional widths, keyword arguments)
SPECS = {
    "MLPRec": ((DIM, DIM), dict(mlp_units=(16, 8, 1), l2_weight=0.01)),
    "MLPRec-one-layer": ((DIM, 6), dict(mlp_units=(1,))),
    "NeuMF": ((DIM, 6), dict(mlp_units=(16, 8, 1), alpha=0.4,
                             l2_weight=0.01)),
}


def _cls(name):
    return name.split("-")[0]


def _models(name, seed=0, **over):
    """(JAX model, numpy params, port model holding the same params)."""
    widths, kw = SPECS[name]
    kw = {**kw, **over}
    jmodel = getattr(jmodels, _cls(name))(USERS, ITEMS, *widths, **kw)
    params = jax.tree.map(np.asarray, jmodel.init(jax.random.PRNGKey(seed)))
    rng = np.random.default_rng(seed)
    params["item_bias"] = rng.normal(scale=0.1, size=(ITEMS, 1)).astype(
        np.float32)
    for layer in params["mlp"]:
        if "b" in layer:
            layer["b"] = rng.normal(scale=0.1, size=layer["b"].shape).astype(
                np.float32)
    model = getattr(models, _cls(name))(USERS, ITEMS, *widths, device="cpu",
                                        **kw)
    model.load_params(convert.params_from_jax(params, device="cpu"))
    return jmodel, params, model


def _batch(rng):
    return {"user_id": rng.integers(0, USERS, BATCH).astype(np.int32),
            "item_id": rng.integers(0, ITEMS, BATCH).astype(np.int32),
            "label": (rng.random(BATCH) < 0.3).astype(np.float32)}


def _torch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


# ------------------------------------------------------------------ models

@pytest.mark.parametrize("name", list(SPECS))
def test_param_names_and_shapes_are_the_jax_tree(name):
    """The MLP's output layer has no bias (`mlp/N-1/w` alone), NeuMF's GE
    unit is `ge_h/0/w`: every name and shape is the JAX tree's."""
    _, params, model = _models(name)
    want = {k: v.shape for k, v in convert.flatten_tree(params).items()}
    got = {k: tuple(v.shape) for k, v in model.params().items()}
    assert got == want
    last = len(SPECS[name][1]["mlp_units"]) - 1
    assert f"mlp/{last}/w" in got and f"mlp/{last}/b" not in got


@pytest.mark.parametrize("name", list(SPECS))
def test_loss_aux_and_grads_match_jax(name):
    jmodel, params, model = _models(name)
    batch = _batch(np.random.default_rng(1))
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


@pytest.mark.parametrize("item_chunk", [32, 70, 4096])
@pytest.mark.parametrize("name", list(SPECS))
def test_chunked_score_matches_jax(name, item_chunk):
    """Full-catalog scores through chunks that pad the catalog (32: three
    chunks, 26 pad items), fit it (70) or exceed it (4096)."""
    jmodel, params, model = _models(name, dropout=0.3)
    users = np.array([0, 5, 29, 12, 12], np.int32)
    want = np.asarray(jmodel.score(jax.tree.map(jnp.asarray, params),
                                   {"user_id": users}, item_chunk=32))
    with torch.no_grad():
        got = model.score({"user_id": torch.from_numpy(users)},
                          item_chunk=item_chunk)
    assert tuple(got.shape) == want.shape == (5, ITEMS)
    np.testing.assert_allclose(got.numpy(), want, rtol=TOL, atol=TOL)
    # the training path's logit at (u, i) is the score row's entry
    pairs = (torch.tensor([0, 5, 29]), torch.tensor([3, 69, 40]))
    with torch.no_grad():
        logit = model.logit(*pairs)
    np.testing.assert_allclose(logit.numpy(),
                               got.numpy()[[0, 1, 2], [3, 69, 40]],
                               rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("optimizer", ["lazy_adam", "keras_adam"])
@pytest.mark.parametrize("name", ["MLPRec", "NeuMF"])
def test_twenty_steps_match_jax(name, optimizer):
    """20 steps (two K-step calls of 10) from the same parameters, dropout
    off."""
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


@pytest.mark.parametrize("name", ["MLPRec", "NeuMF"])
def test_jax_checkpoints_restore_both_ways(name, tmp_path):
    jmodel, params, _ = _models(name, seed=2)
    path = jckpt.save(str(tmp_path / "jax"), 4, params)
    widths, kw = SPECS[name]
    fresh = getattr(models, name)(USERS, ITEMS, *widths, device="cpu", **kw)
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


# ----------------------------------------------------------------- dropout

def test_dropout_keeps_x_over_keep_at_the_keep_rate():
    """An MLP whose second layer is the identity returns its dropped hidden
    layer: every unit is relu(h) / keep or 0, and the kept share of 64,000
    units lies within 5 standard deviations of keep."""
    rate, B, H = 0.3, 500, 128
    mlp = MLP(6, [H, H], dropout_rate=rate, out_bias=False, device="cpu",
              generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        mlp[1].w.copy_(torch.eye(H))
    x = torch.from_numpy(np.random.default_rng(2).normal(
        size=(B, 6)).astype(np.float32))
    with torch.no_grad():
        hidden = torch.relu(x @ mlp[0].w + mlp[0].b)
        out = mlp(x, train=True, generator=torch.Generator().manual_seed(3))
    keep = 1.0 - rate
    kept = out != 0
    assert torch.equal(out[kept], (hidden / keep)[kept])
    live = hidden != 0                   # a zero unit is 0 whether kept
    share = kept[live].float().mean().item()
    n = int(live.sum())
    assert abs(share - keep) < 5 * np.sqrt(keep * (1 - keep) / n)


@pytest.mark.parametrize("name", ["MLPRec", "NeuMF"])
def test_dropout_draws_only_from_the_given_generator(name):
    """With a generator the loss drops units (one seed, one loss; another
    seed, another); without one it is JAX's loss without an rng, and
    `score` draws nothing."""
    jmodel, params, model = _models(name, dropout=0.5)
    batch = _batch(np.random.default_rng(1))

    def loss(gen=None):
        with torch.no_grad():
            return model.loss(_torch(batch), generator=gen)[0].item()
    a = loss(torch.Generator().manual_seed(5))
    assert a == loss(torch.Generator().manual_seed(5))
    assert a != loss(torch.Generator().manual_seed(6))
    want, _ = jmodel.loss(jax.tree.map(jnp.asarray, params),
                          jax.tree.map(jnp.asarray, batch))
    np.testing.assert_allclose(loss(), float(want), rtol=TOL, atol=TOL)
    gen = torch.Generator().manual_seed(0)
    state = gen.get_state()
    with torch.no_grad():
        first = model.score({"user_id": torch.tensor([1, 2])})
        assert torch.equal(first, model.score({"user_id":
                                                torch.tensor([1, 2])}))
    assert torch.equal(gen.get_state(), state)


@pytest.mark.parametrize("name", ["BPR", "NBPR", "MLPRec"])
def test_trainer_generator_moves_only_for_a_model_that_draws(name):
    """The Trainer hands its generator to every loss; a model that draws
    nothing (BPR, NBPR, MLPRec without dropout) leaves it where it was,
    so device-sampled streams do not move, and MLPRec with dropout draws
    the same masks from the same seed."""
    rng = np.random.default_rng(3)
    if name == "MLPRec":
        batches = [_batch(rng) for _ in range(3)]
    else:
        batches = [{"user_id": rng.integers(0, USERS, BATCH).astype(np.int32),
                    "p_item_id": rng.integers(0, ITEMS, BATCH).astype(
                        np.int32),
                    "n_item_id": rng.integers(
                        0, ITEMS, (BATCH, 3) if name == "NBPR" else BATCH)
                    .astype(np.int32)} for _ in range(3)]

    def run(dropout, seed=0):
        if name == "MLPRec":
            model = models.MLPRec(USERS, ITEMS, DIM, DIM, mlp_units=(8, 1),
                                  dropout=dropout, device="cpu",
                                  generator=torch.Generator().manual_seed(1))
        else:
            model = getattr(models, name)(USERS, ITEMS, DIM,
                                          *([DIM] if name == "BPR" else []),
                                          device="cpu",
                                          generator=torch.Generator()
                                          .manual_seed(1))
        tt = Trainer(model, lr=LR, seed=seed, device="cpu")
        state = tt.generator.get_state()
        losses = torch.cat([tt.train_step_multi(batches[:2]),
                            tt.train_step(batches[2])[0][None]])
        return torch.equal(tt.generator.get_state(), state), losses
    unmoved, _ = run(None)
    assert unmoved
    if name == "MLPRec":
        unmoved, a = run(0.4)
        assert not unmoved
        assert torch.equal(a, run(0.4)[1])
        assert not torch.equal(a, run(0.4, seed=1)[1])


# -------------------------------------------------------------- numpy_eval

def _rows(rng, users=6, items=50):
    rows = rng.normal(size=(users, items)).astype(np.float32)
    rows[:, 10:14] = rows[:, [9]]                 # exact ties
    return rows


@pytest.mark.parametrize("at", [1, 3, 10, 100])
def test_numpy_eval_functions_bit_equal(at):
    rng = np.random.default_rng(at)
    for row in _rows(rng):
        pos = rng.choice(50, 5, replace=False)
        excl = rng.choice(50, 7, replace=False)
        for args in ((row, pos, excl), (row, pos), (row, pos, [])):
            got, want = teval.full_rank(*args), jeval.full_rank(*args)
            np.testing.assert_array_equal(got[0], want[0])
            assert got[1] == want[1]
        ranks, n = teval.partial_rank(row[pos], row[excl])
        jranks, jn = jeval.partial_rank(row[pos], row[excl])
        np.testing.assert_array_equal(ranks, jranks)
        assert n == jn
        for fn in ("auc",):
            assert getattr(teval, fn)(ranks, n) == getattr(jeval, fn)(
                jranks, jn)
        for fn in ("ndcg", "recall", "precision"):
            assert getattr(teval, fn)(ranks, n, at) \
                == getattr(jeval, fn)(jranks, jn, at)
        assert teval.mse(row, row[::-1]) == jeval.mse(row, row[::-1])
    empty = np.empty(0)
    assert teval.ndcg(empty, 3.0, at) == jeval.ndcg(empty, 3.0, at)
    assert teval.recall(empty, 3.0, at) == jeval.recall(empty, 3.0, at)


@pytest.mark.parametrize("num_negatives", [None, 20])
def test_eval_manager_bit_equal(num_negatives):
    """Full mode, and sampled mode with its rejection loop on the same
    seed, over the same numpy score rows and stores (train positives
    excluded)."""
    data = make_interactions(40, 100, 8, seed=5)
    train, val = data[:250], data[250:]
    stores = [InteractionStore(val, 40, 100, seed=0),
              InteractionStore(train, 40, 100, seed=0)]
    jstores = [JStore(val, 40, 100, seed=0), JStore(train, 40, 100, seed=0)]
    table = np.random.default_rng(6).normal(size=(40, 100)).astype(
        np.float32)

    def score_fn(users):
        return table[np.asarray(users)]
    got = teval.EvalManager(at=(5, 50), seed=3).evaluate(
        score_fn, stores[0], excl_stores=stores[1:],
        num_negatives=num_negatives, user_batch=16)
    want = jeval.EvalManager(at=(5, 50), seed=3).evaluate(
        score_fn, jstores[0], excl_stores=jstores[1:],
        num_negatives=num_negatives, user_batch=16)
    assert got == want
    assert set(got) == {"AUC", "Recall@5", "Recall@50", "NDCG@5", "NDCG@50",
                        "Precision@5", "Precision@50"}


# ----------------------------------------------- the JAX package's own bars

def _train_ok(model, steps=40, lr=0.01):
    store = InteractionStore(make_interactions(), 40, 100, seed=0)
    s = samplers.StratifiedPointwiseSampler(store, batch_size=64, seed=0,
                                            use_native=False)
    tr = Trainer(model, lr=lr, seed=0, device="cpu")
    losses = [float(tr.train_step(b)[0])
              for b, _ in zip(iter(s), range(steps))]
    assert np.isfinite(losses).all()
    assert np.mean(losses[-5:]) < np.mean(losses[:5])
    return tr


def test_mlp_rec_trains_and_scores():
    """tests/test_ncf_and_numpy_eval.py:34 on the port."""
    model = models.MLPRec(40, 100, 8, 8, mlp_units=(16, 1), device="cpu",
                          generator=torch.Generator().manual_seed(0))
    _train_ok(model)
    with torch.no_grad():
        scores = model.score({"user_id": torch.arange(3)}, item_chunk=32)
        assert tuple(scores.shape) == (3, 100)
        direct = model.logit(torch.tensor([1]), torch.tensor([7]))
    np.testing.assert_allclose(scores[1, 7].item(), direct.item(),
                               rtol=1e-5)


def test_neumf_trains_and_scores():
    """tests/test_ncf_and_numpy_eval.py:54 on the port."""
    model = models.NeuMF(40, 100, 8, 8, mlp_units=(16, 1), alpha=0.4,
                         device="cpu",
                         generator=torch.Generator().manual_seed(0))
    _train_ok(model)
    with torch.no_grad():
        scores = model.score({"user_id": torch.arange(2)}, item_chunk=32)
        assert tuple(scores.shape) == (2, 100)
        logit = model.logit(torch.tensor([1]), torch.tensor([5]))
    np.testing.assert_allclose(scores[1, 5].item(), logit.item(),
                               rtol=1e-4, atol=1e-6)


def test_numpy_eval_manager_full_and_sampled():
    """tests/test_ncf_and_numpy_eval.py:67 on the port."""
    store = InteractionStore(make_interactions(), 40, 100, seed=0)
    model = models.BPR(40, 100, 8, 8, device="cpu",
                       generator=torch.Generator().manual_seed(0))

    def score_fn(users):
        with torch.no_grad():
            return model.score({"user_id": torch.as_tensor(users)}).numpy()
    mgr = teval.EvalManager(at=(10, 50), seed=0)
    full = mgr.evaluate(score_fn, store)
    assert set(full) == {"AUC", "Recall@10", "Recall@50", "NDCG@10",
                         "NDCG@50", "Precision@10", "Precision@50"}
    for v in full.values():
        assert 0.0 <= v <= 1.0
    sampled = mgr.evaluate(score_fn, store, num_negatives=20)
    assert np.isfinite(list(sampled.values())).all()


def test_numpy_metric_formulas():
    """tests/test_ncf_and_numpy_eval.py:87 on the port."""
    ranks = np.array([0.0, 3.0, 120.0])
    n = 500.0
    np.testing.assert_allclose(teval.auc(ranks, n),
                               np.mean((n - ranks) / n))
    assert teval.recall(ranks, n, at=3) == 2 / 3
    assert teval.precision(ranks, n, at=3) == 2 / 3
    want_denom = sum(1 / np.log2(i + 2) for i in range(3))
    want_dcg = 1 / np.log2(0 + 2) + 1 / np.log2(3 + 2)
    np.testing.assert_allclose(teval.ndcg(ranks, n, at=100),
                               want_dcg / want_denom)


def test_full_rank_excludes():
    """tests/test_ncf_and_numpy_eval.py:101 on the port."""
    scores = np.array([5.0, 4.0, 3.0, 2.0, 1.0])
    ranks, n_neg = teval.full_rank(scores, pos_items=[2], excl_items=[0])
    assert n_neg == 3
    np.testing.assert_array_equal(ranks, [1.0])


# -------------------------------------------------------------- the device

@pytest.mark.parametrize("name", ["NBPR", "WCML", "MLPRec", "NeuMF", "CDL",
                                  "SDAE"])
def test_new_models_need_cuda_or_explicit_cpu(name):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid")
    args = {"NBPR": (4, 5, 2), "WCML": (4, 5, 2), "MLPRec": (4, 5, 2, 2),
            "NeuMF": (4, 5, 2, 2), "CDL": (4, 5, 2, np.ones((5, 3))),
            "SDAE": (3, [2])}[name]
    with pytest.raises(RuntimeError, match="CUDA"):
        getattr(port, name)(*args)
    model = getattr(port, name)(*args, device="cpu")
    assert all(p.device.type == "cpu" for p in model.parameters())
