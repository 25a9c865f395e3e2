"""Port parity: the Trainer against the JAX package's Trainer on the same
parameters (carried over by `convert`) and the same batches: K steps of
train_step, train_step_multi and train_step_multi_flat, `train` with
every feed, `evaluate` on mask and id batches, checkpoints both ways, and
the watch-list behaviours (feed='auto', an empty stream).

Tolerances: params and losses rtol 1e-5, atol 1e-6 after 20 steps at the
CiteULike learning rate 1e-3 (autograd and XLA sum the per-example
gradients in another order); metrics rtol 1e-5, atol 1e-6.
"""

import json

import jax
import numpy as np
import pytest
import torch

from openrec_tpu import checkpoint as jckpt
from openrec_tpu.data.samplers import EvaluationSampler as JEval
from openrec_tpu.data.store import InteractionStore as JStore
from openrec_tpu.models import BPR as JBPR
from openrec_tpu.training import Trainer as JTrainer
from openrec_tpu.training import optim as joptim
from openrec_tpu_torch import convert
from openrec_tpu_torch.data import (EvaluationSampler, InteractionStore,
                                    PairwiseSampler)
from openrec_tpu_torch.models import BPR
from openrec_tpu_torch.serving import CachedDotProductScorer
from openrec_tpu_torch.modules.embedding import embedding_lookup
from openrec_tpu_torch.training import Trainer, optim as toptim
from tests.conftest import make_interactions

torch.set_num_threads(1)

USERS, ITEMS, DIM, BS, LR = 40, 100, 8, 32, 1e-3
RTOL, ATOL = 1e-5, 1e-6


def _batches(n, seed=0, bs=BS):
    store = InteractionStore(make_interactions(), USERS, ITEMS, seed=seed)
    s = PairwiseSampler(store, batch_size=bs, seed=seed)
    return [s.sample() for _ in range(n)]


def _pair(optimizer="lazy_adam", **kw):
    """A JAX trainer and a port trainer holding the same parameters."""
    jt = JTrainer(JBPR(USERS, ITEMS, DIM, DIM), lr=LR, seed=0,
                  optimizer=getattr(joptim, optimizer)(LR), **kw)
    model = BPR(USERS, ITEMS, DIM, DIM, device="cpu")
    model.load_params(convert.params_from_jax(
        jax.tree.map(np.asarray, jt.params), device="cpu"))
    tt = Trainer(model, optimizer=getattr(toptim, optimizer)(LR),
                 device="cpu", **kw)
    return jt, tt


def _assert_params(jt, tt):
    for key, value in jt.params.items():
        np.testing.assert_allclose(tt.params[key].detach().numpy(),
                                   np.asarray(value), rtol=RTOL, atol=ATOL)
    assert tt.global_step == jt.global_step


@pytest.mark.parametrize("optimizer", ["lazy_adam", "keras_adam"])
@pytest.mark.parametrize("how", ["train_step", "multi", "multi_flat"])
def test_twenty_steps_match_jax(how, optimizer):
    batches = _batches(20)
    jt, tt = _pair(optimizer)
    if how == "train_step":
        jl = [float(jt.train_step(b)[0]) for b in batches]
        tl = [float(tt.train_step(b)[0]) for b in batches]
    elif how == "multi":
        jl = np.concatenate([np.asarray(jt.train_step_multi(batches[:10])),
                             np.asarray(jt.train_step_multi(batches[10:]))])
        tl = torch.cat([tt.train_step_multi(batches[:10]),
                        tt.train_step_multi(batches[10:])]).numpy()
    else:
        flat = {k: np.concatenate([b[k] for b in batches])
                for k in batches[0]}
        jl = np.asarray(jt.train_step_multi_flat(flat, 20))
        tl = tt.train_step_multi_flat(flat, 20).numpy()
    np.testing.assert_allclose(tl, jl, rtol=RTOL, atol=ATOL)
    _assert_params(jt, tt)
    assert int(tt.opt_state.count) == int(jt.opt_state.count) == 20


@pytest.mark.parametrize("feed", ["per_step", "flat", "stacked", "auto"])
def test_train_feeds_match_jax(feed, tmp_path):
    k = 5
    batches = _batches(20)
    if feed == "flat":
        stream = [{key: np.concatenate([b[key] for b in batches[i:i + k]])
                   for key in batches[0]} for i in range(0, 20, k)]
    elif feed in ("stacked", "auto"):
        stream = [{key: np.stack([b[key] for b in batches[i:i + k]])
                   for key in batches[0]} for i in range(0, 20, k)]
    else:
        stream = batches
    jt, tt = _pair(log_file=None)
    jt.train(20, iter(stream), steps_per_call=k, feed=feed, verbose=False)
    log = tmp_path / "log.jsonl"
    tt.log_file = str(log)
    ev = EvaluationSampler(InteractionStore(make_interactions(seed=1),
                                            USERS, ITEMS), 16)
    res = tt.train(20, iter(stream), steps_per_call=k, feed=feed,
                   eval_samplers={"val": ev}, eval_interval=10,
                   verbose=False)
    _assert_params(jt, tt)
    records = [json.loads(line) for line in log.read_text().splitlines()]
    assert [r["step"] for r in records] == [10, 20]
    assert set(records[-1]["eval"]["val"]) == set(res["val"])


def test_feed_auto_reads_leading_dim_k_as_stacked():
    """trainer.py:287-291 kept: a per-step batch whose every value is 2-D
    with leading dim k is read as k stacked steps, in both packages."""
    k = 4
    odd = [{key: v.reshape(k, -1) for key, v in b.items()}
           for b in _batches(2, bs=8)]          # [4, 2] per value
    jt, tt = _pair()
    jt.train(8, iter(odd), steps_per_call=k, verbose=False)
    tt.train(8, iter(odd), steps_per_call=k, verbose=False)
    assert jt.global_step == tt.global_step == 8
    _assert_params(jt, tt)
    # 1-D values stay per-step batches
    jt, tt = _pair()
    jt.train(8, iter(_batches(8)), steps_per_call=k, verbose=False)
    tt.train(8, iter(_batches(8)), steps_per_call=k, verbose=False)
    _assert_params(jt, tt)


def test_empty_stream_behaves_like_jax():
    """trainer.py:286/:563 kept: an empty stream with k > 1 still demands
    total_iter % k == 0 (the JAX package asserts, the port raises
    ValueError), and otherwise trains nothing."""
    jt, tt = _pair()
    with pytest.raises(AssertionError):
        jt.train(7, iter([]), steps_per_call=5, verbose=False)
    with pytest.raises(ValueError):
        tt.train(7, iter([]), steps_per_call=5, verbose=False)
    jt.train(10, iter([]), steps_per_call=5, verbose=False)
    tt.train(10, iter([]), steps_per_call=5, verbose=False)
    assert jt.global_step == tt.global_step == 0
    with pytest.raises(ValueError):
        tt.train(10, iter([]), steps_per_call=5, feed="bogus")


@pytest.mark.parametrize("device_masks", [False, True])
def test_evaluate_matches_jax(device_masks, tmp_path):
    train = make_interactions(seed=0)
    val = make_interactions(seed=1, per_user=3)
    jt, tt = _pair()
    batches = _batches(15)
    jt.train_step_multi(batches)
    tt.train_step_multi(batches)
    jev = JEval(JStore(val, USERS, ITEMS), 12,
                excl_stores=[JStore(train, USERS, ITEMS)],
                device_masks=device_masks)
    tev = EvaluationSampler(InteractionStore(val, USERS, ITEMS), 12,
                            excl_stores=[InteractionStore(train, USERS,
                                                          ITEMS)],
                            device_masks=device_masks)
    want = jt.evaluate(jev, at=(5, 20))
    dump = tmp_path / "scores.npz"
    got = tt.evaluate(tev, at=(5, 20), dump_path=str(dump))
    deferred = tt.evaluate(tev, at=(5, 20), defer_metrics=True)
    assert sorted(got) == sorted(want) == ["AUC", "NDCG", "Precision",
                                           "Recall"]
    for key in want:
        np.testing.assert_allclose(got[key], want[key], rtol=RTOL,
                                   atol=ATOL)
        np.testing.assert_allclose(deferred[key].numpy(), want[key],
                                   rtol=RTOL, atol=ATOL)
    with np.load(dump) as d:
        assert d["scores"].shape == (USERS, ITEMS)
        np.testing.assert_array_equal(np.sort(d["user_ids"]),
                                      np.arange(USERS))
    if device_masks:
        scorer = CachedDotProductScorer(
            tt.model, USERS, ITEMS,
            extract_user_vecs=lambda p, i: embedding_lookup(
                p["user_embed"], i),
            extract_item_vecs=lambda p, i: embedding_lookup(
                p["item_embed"], i),
            extract_item_bias=lambda p, i: embedding_lookup(
                p["item_bias"], i), device="cpu")
        chunked = tt.evaluate(tev, at=(5, 20), scorer=scorer, eval_chunk=32)
        for key in want:
            np.testing.assert_allclose(chunked[key], want[key], rtol=RTOL,
                                       atol=ATOL)


def test_defer_metrics_train_matches_eager():
    ev = EvaluationSampler(InteractionStore(make_interactions(seed=1),
                                            USERS, ITEMS), 16,
                           device_masks=True)
    results = []
    for defer in (False, True):
        _, tt = _pair()
        results.append(tt.train(20, iter(_batches(20)), steps_per_call=5,
                                eval_samplers={"val": ev}, eval_interval=10,
                                defer_metrics=defer, verbose=False))
    for key, value in results[0]["val"].items():
        np.testing.assert_allclose(results[1]["val"][key], value,
                                   rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("optimizer", ["lazy_adam", "lazy_adagrad"])
def test_checkpoints_cross_both_ways(optimizer, tmp_path):
    batches = _batches(12)
    jt, tt = _pair(optimizer, save_model_dir=str(tmp_path / "t"))
    jt.save_model_dir = str(tmp_path / "j")
    jt.train_step_multi(batches[:6])
    tt.train_step_multi(batches[:6])
    tpath, jpath = tt.save(), jt.save()
    with np.load(tpath) as a, np.load(jpath) as b:
        assert sorted(a.files) == sorted(b.files)
        for key in b.files:
            assert a[key].dtype == b[key].dtype and \
                a[key].shape == b[key].shape, key
    # port checkpoint -> fresh JAX trainer, JAX checkpoint -> fresh port
    jt2, tt2 = _pair(optimizer)
    jt2.restore(tpath)
    tt2.restore(jpath)
    for key in jt.params:
        np.testing.assert_array_equal(np.asarray(jt2.params[key]),
                                      tt.params[key].detach().numpy())
        np.testing.assert_array_equal(tt2.params[key].detach().numpy(),
                                      np.asarray(jt.params[key]))
    want = convert.opt_state_to_numpy(tt.opt_state)
    got = convert.opt_state_to_numpy(tt2.opt_state)
    assert convert.flatten_tree(got).keys() == convert.flatten_tree(
        want).keys()
    # training on from the crossed checkpoints keeps the two in step
    jt2.global_step = tt2.global_step = 6
    jt2.train_step_multi(batches[6:])
    tt2.train_step_multi(batches[6:])
    _assert_params(jt2, tt2)


def test_opt_state_from_jax_and_warm_start(tmp_path):
    jt, tt = _pair()
    batches = _batches(5)
    jt.train_step_multi(batches)
    state = convert.opt_state_from_jax(jax.tree.map(np.asarray,
                                                    jt.opt_state),
                                       device="cpu")
    assert isinstance(state, toptim.LazyAdamState)
    assert state.count.dtype == torch.int32 and int(state.count) == 5
    np.testing.assert_array_equal(state.nu["item_embed"].numpy(),
                                  np.asarray(jt.opt_state.nu["item_embed"]))
    back = convert.opt_state_to_numpy(state)
    np.testing.assert_array_equal(back["mu"]["user_embed"],
                                  np.asarray(jt.opt_state.mu["user_embed"]))
    # warm start: only params, shape-matched, from the latest checkpoint
    jckpt.save(str(tmp_path), 5, {"params": jt.params,
                                  "opt_state": jt.opt_state})
    model = BPR(USERS, ITEMS, DIM, DIM, device="cpu")
    warm = Trainer(model, lr=LR, init_model_dir=str(tmp_path),
                   device="cpu")
    for key in jt.params:
        np.testing.assert_array_equal(warm.params[key].detach().numpy(),
                                      np.asarray(jt.params[key]))
    assert int(warm.opt_state.count) == 0
    with pytest.raises(FileNotFoundError):
        Trainer(BPR(4, 4, 2, 2, device="cpu"), device="cpu",
                save_model_dir=str(tmp_path / "none")).restore()


def test_profile_writes_a_trace(tmp_path):
    _, tt = _pair()
    path = tt.profile(iter(_batches(4)), steps=2, trace_dir=str(tmp_path))
    assert path.endswith("trace.json")
    assert json.loads(open(path).read())["traceEvents"]
    assert tt.global_step == 3


def test_trainer_refuses_a_model_on_another_device():
    model = BPR(4, 4, 2, 2, device="cpu")
    with pytest.raises(ValueError, match="lies on"):
        Trainer(model, device="meta")
