"""Port parity, `ParallelTrainer` on gloo meshes of 8 CPU ranks against
the JAX package's on its 8 CPU devices (tests/test_parallel_trainer.py):
trajectories of train_step / train_step_multi / train_step_multi_flat
on a 4 x 2 mesh, evaluate on mask and id batches, per-rank checkpoints
restored into a 2 x 4 trainer, a JAX ParallelTrainer's checkpoint
restored into the port's (and training on from it), warm start, the
sparse_tables path, `train(feed='flat')`, on-device sampling and a
200-step `train` with interval eval and saves.

One launch of `python -c WORKER` (never imports JAX) for every case.
Bars: losses rtol 1e-5, parameters rtol 1e-4 / atol 1e-6 (JAX's own),
metrics rtol 1e-5 / atol 1e-6, checkpoints bit for bit.
"""

import os
import pickle

import jax
import numpy as np
import pytest

from openrec_tpu import ParallelTrainer as JParallelTrainer
from openrec_tpu.data import InteractionStore as JStore
from openrec_tpu.data.samplers import EvaluationSampler as JEval
from openrec_tpu.data.samplers import PairwiseSampler as JPairwise
from openrec_tpu.models import BPR as JBPR
from openrec_tpu.models import DLRM as JDLRM
from openrec_tpu.parallel import make_mesh
from openrec_tpu.training.sparse import dlrm_fused_table_spec
from openrec_tpu_torch import convert
from openrec_tpu_torch.parallel.launch import spawn_local
from tests.conftest import make_low_rank

pytestmark = pytest.mark.skipif(len(jax.devices()) < 8,
                                reason="needs 8 devices")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DLRM_KW = dict(m_spa=8, ln_emb=(64, 128, 32), ln_bot=(8, 8), ln_top=(16, 1),
               dim_dense=3, loss_func="bce", fused_tables=True)

WORKER = r'''
import os, pickle
import numpy as np
import torch
torch.set_num_threads(1)
import torch.distributed as dist
from openrec_tpu_torch import ParallelTrainer
from openrec_tpu_torch import parallel as par
from openrec_tpu_torch.data import (Dataset, DevicePairwiseSampler,
                                    EvaluationSampler, InteractionStore)
from openrec_tpu_torch.models import BPR, DLRM
from openrec_tpu_torch.training.sparse import dlrm_fused_table_spec

inp = pickle.load(open(os.environ["CASES_IN"], "rb"))
root = os.environ["CASES_OUT"]
mesh_a = par.make_mesh(4, 2, device="cpu")
mesh_b = par.make_mesh(2, 4, device="cpu")
out = {}


def bpr(params=None):
    m = BPR(64, 256, 16, 16, l2_weight=1e-4, device="cpu")
    if params is not None:
        m.load_params(params)
    return m


def full(tr):
    with par.full_params(tr.model, tr.shardings, tr.mesh):
        return {k: v.detach().numpy().copy()
                for k, v in tr.model.params().items()}


train_store = InteractionStore(inp["train"], 64, 256, seed=0)
test_store = InteractionStore(inp["test"], 64, 256, seed=0)
b = inp["batches"]

# trajectory through every host-fed entry point, eval, save (4 x 2)
pt = ParallelTrainer(bpr(inp["params"]), mesh_a, lr=0.05, seed=0,
                     save_model_dir=os.path.join(root, "port"))
losses = [float(pt.train_step(x)[0]) for x in b[:6]]
losses += pt.train_step_multi(b[6:10]).tolist()
flat = {k: np.concatenate([x[k] for x in b[10:12]]) for k in b[0]}
losses += pt.train_step_multi_flat(flat, 2).tolist()
out["losses"] = losses
out["params"] = full(pt)
out["local_rows"] = pt.model.item_embed.shape[0]
out["eval"] = pt.evaluate(EvaluationSampler(
    test_store, 32, excl_stores=[train_store]), at=(50,))
out["eval_ids"] = pt.evaluate(EvaluationSampler(
    test_store, 32, excl_stores=[train_store], device_masks=True), at=(50,))
pt.save()

# restore into a fresh trainer on another layout (2 x 4), and warm start
pt2 = ParallelTrainer(bpr(), mesh_b, lr=0.05, seed=1,
                      save_model_dir=os.path.join(root, "port"))
pt2.restore()
out["restored"] = full(pt2)
out["restored_count"] = int(pt2.opt_state.count)
pt3 = ParallelTrainer(bpr(), mesh_b, lr=0.05, seed=1,
                      init_model_dir=os.path.join(root, "port"))
out["warm"] = full(pt3)

# the JAX ParallelTrainer's checkpoint, then train on from it
pt4 = ParallelTrainer(bpr(), mesh_b, lr=0.05, seed=0)
pt4.restore(inp["jax_ckpt"])
out["from_jax"] = full(pt4)
out["from_jax_next"] = [float(pt4.train_step(x)[0]) for x in b[12:14]]
out["from_jax_next_params"] = full(pt4)

# sparse_tables (4 x 2)
dl = DLRM(**inp["dlrm_kw"], device="cpu")
dl.load_params(inp["dlrm_params"])
ps = ParallelTrainer(dl, mesh_a, lr=0.01, seed=0,
                     sparse_tables=dlrm_fused_table_spec(dl))
out["sparse_losses"] = ps.train_step_multi(inp["dlrm_batches"]).tolist()
out["sparse_params"] = full(ps)

# train(feed='flat') == _dispatch_multi on the same payloads
ta = ParallelTrainer(bpr(inp["params"]), mesh_a, lr=0.01, seed=0)
tb = ParallelTrainer(bpr(inp["params"]), mesh_a, lr=0.01, seed=0)
payloads = [{k: np.concatenate([x[k] for x in b[i:i + 3]]) for k in b[0]}
            for i in (0, 3)]
for p in payloads:
    ta._dispatch_multi({k: v.reshape(3, -1) for k, v in p.items()}, 3)
tb.train(total_iter=6, train_batches=iter(payloads), steps_per_call=3,
         feed="flat", verbose=False)
out["flat_feed_equal"] = all(np.array_equal(x, y) for x, y in zip(
    full(ta).values(), full(tb).values()))
out["flat_feed_step"] = tb.global_step

# on-device sampling (4 x 2)
td = ParallelTrainer(bpr(inp["params"]), mesh_a, lr=0.05, seed=0)
sampler = DevicePairwiseSampler(train_store, batch_size=16, device="cpu")
dev_losses = [td.train_steps_device(sampler, 50).numpy() for _ in range(4)]
out["device_losses"] = np.concatenate(dev_losses)
out["device_step"] = td.global_step

# a 200-step train with interval eval and saves (4 x 2)
ds = Dataset(inp["train"], 64, 256, seed=0)
tr = ParallelTrainer(bpr(inp["params"]), mesh_a, lr=0.05, seed=0,
                     save_model_dir=os.path.join(root, "loop"))
out["train_result"] = tr.train(
    total_iter=200, train_batches=ds.pairwise(batch_size=256),
    eval_samplers={"val": EvaluationSampler(test_store, 32,
                                            excl_stores=[ds.store])},
    eval_interval=100, save_interval=100, at=(50,), verbose=False)
out["loop_steps"] = par.sharded_checkpoint.sorted_steps(
    os.path.join(root, "loop"))

pickle.dump(out, open(os.path.join(root, f"out-{dist.get_rank()}.pkl"),
                      "wb"))
'''


def _np(tree):
    return jax.tree.map(np.array, tree)


def _dlrm_batches(n=4, B=32):
    rng = np.random.default_rng(0)
    return [{"dense_features": rng.normal(size=(B, 3)).astype(np.float32),
             "sparse_features": np.stack([rng.integers(0, c, B)
                                          for c in (64, 128, 32)],
                                         axis=1).astype(np.int32),
             "label": rng.integers(0, 2, B).astype(np.float32)}
            for _ in range(n)]


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("ptrainer")
    train, test = make_low_rank()
    jstore = JStore(train, 64, 256, seed=0)
    jtest = JStore(test, 64, 256, seed=0)
    it = iter(JPairwise(jstore, batch_size=64, seed=3))
    batches = [next(it) for _ in range(14)]
    model = JBPR(total_users=64, total_items=256, dim_user_embed=16,
                 dim_item_embed=16, l2_weight=1e-4)
    mesh = make_mesh(data=4, model=2)
    jt = JParallelTrainer(model, mesh, lr=0.05, seed=0,
                          save_model_dir=str(tmp / "jax"))
    params0 = convert.flatten_tree(_np(jt.params))
    ref = {}
    losses = [float(jt.train_step(x)[0]) for x in batches[:6]]
    losses += np.asarray(jt.train_step_multi(batches[6:10])).tolist()
    flat = {k: np.concatenate([x[k] for x in batches[10:12]])
            for k in batches[0]}
    losses += np.asarray(jt.train_step_multi_flat(flat, 2)).tolist()
    ref["losses"] = losses
    ref["params"] = convert.flatten_tree(_np(jt.params))
    ref["eval"] = jt.evaluate(JEval(jtest, 32, excl_stores=[jstore]),
                              at=(50,))
    jax_ckpt = jt.save()
    ref["next"] = [float(jt.train_step(x)[0]) for x in batches[12:14]]
    ref["next_params"] = convert.flatten_tree(_np(jt.params))

    dmodel = JDLRM(**DLRM_KW)
    dbatches = _dlrm_batches()
    jd = JParallelTrainer(dmodel, mesh, lr=0.01, seed=0,
                          sparse_tables=dlrm_fused_table_spec(dmodel))
    dparams = convert.flatten_tree(_np(jd.params))
    ref["sparse_losses"] = np.asarray(jd.train_step_multi(dbatches)).tolist()
    ref["sparse_params"] = convert.flatten_tree(_np(jd.params))

    inp = dict(train=train, test=test, batches=batches, params=params0,
               jax_ckpt=jax_ckpt, dlrm_kw=DLRM_KW, dlrm_params=dparams,
               dlrm_batches=dbatches)
    path = tmp / "in.pkl"
    with open(path, "wb") as f:
        pickle.dump(inp, f)
    spawn_local(WORKER, 8, timeout=240,
                env={"PYTHONPATH": REPO, "CASES_IN": str(path),
                     "CASES_OUT": str(tmp)})
    outs = []
    for r in range(8):
        with open(tmp / f"out-{r}.pkl", "rb") as f:
            outs.append(pickle.load(f))
    return ref, outs


def _close(got, want, rtol=1e-4, atol=1e-6):
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=rtol, atol=atol,
                                   err_msg=k)


def test_trajectory_matches_jax(run):
    ref, outs = run
    for o in outs:
        assert o["local_rows"] == 128               # 256 items over 2
        np.testing.assert_allclose(o["losses"], ref["losses"], rtol=1e-5)
        _close(o["params"], ref["params"])


def test_evaluate_matches_jax(run):
    ref, outs = run
    for o in outs:
        for key in ("eval", "eval_ids"):
            for k, v in ref["eval"].items():
                np.testing.assert_allclose(o[key][k], v, rtol=1e-5,
                                           atol=1e-6, err_msg=k)


def test_checkpoint_restores_into_other_layout(run):
    _, outs = run
    for o in outs:
        for k, v in o["params"].items():
            np.testing.assert_array_equal(o["restored"][k], v)
            np.testing.assert_array_equal(o["warm"][k], v)
        assert o["restored_count"] == 12


def test_jax_checkpoint_restores_and_trains_on(run):
    ref, outs = run
    for o in outs:
        for k, v in ref["params"].items():
            np.testing.assert_array_equal(o["from_jax"][k], v)
        np.testing.assert_allclose(o["from_jax_next"], ref["next"],
                                   rtol=1e-5)
        _close(o["from_jax_next_params"], ref["next_params"])


def test_sparse_tables_match_jax(run):
    ref, outs = run
    for o in outs:
        np.testing.assert_allclose(o["sparse_losses"], ref["sparse_losses"],
                                   rtol=1e-5)
        _close(o["sparse_params"], ref["sparse_params"])


def test_flat_feed_and_device_sampling(run):
    _, outs = run
    for o in outs:
        assert o["flat_feed_equal"] and o["flat_feed_step"] == 6
        assert o["device_step"] == 200
        losses = o["device_losses"]
        assert np.isfinite(losses).all()
        assert losses[-50:].mean() < losses[:50].mean()
        np.testing.assert_array_equal(losses, outs[0]["device_losses"])


def test_train_loop_evals_and_saves(run):
    """JAX's bar (tests/test_parallel_trainer.py:29-35): val AUC > 0.75
    after 200 steps on the planted low-rank data."""
    _, outs = run
    for o in outs:
        assert float(o["train_result"]["val"]["AUC"]) > 0.75
        assert o["loop_steps"] == [100, 200]
