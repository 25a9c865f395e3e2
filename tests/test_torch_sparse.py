"""Port parity, the O(batch) sparse step: `unique_padded`, `SubTable`,
`make_sparse_train_step` on the fused and the separate DLRM tables and on
BPR, `Trainer(sparse_tables=...)` through every entry point and its
checkpoints, `make_sparse_device_loop`, optax-form `adam`, and the sparse
state's conversion, against `openrec_tpu.training.sparse` and optax on
the same numpy inputs, parameters carried over by `convert`.

Tolerances: `unique_padded` exact; sparse steps rtol 1e-4, atol 1e-7 on
rows, moments and dense parameters (JAX's own test of the step,
tests/test_sparse_step.py:128-153); losses rtol 1e-5; optax-form adam
rtol 1e-6, atol 1e-9 over 6 steps; untouched rows bit-identical.
"""

import ast
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from openrec_tpu.data.device_sampler import \
    DevicePairwiseSampler as JDeviceSampler
from openrec_tpu.data.samplers import PairwiseSampler as JPairwise
from openrec_tpu.data.store import InteractionStore as JStore
from openrec_tpu.models import BPR as JBPR
from openrec_tpu.models import DLRM as JDLRM
from openrec_tpu.training import Trainer as JTrainer
from openrec_tpu.training import sparse as jsparse
from openrec_tpu_torch import convert
from openrec_tpu_torch.data import DevicePairwiseSampler, InteractionStore
from openrec_tpu_torch.models import BPR, DLRM
from openrec_tpu_torch.training import Trainer
from openrec_tpu_torch.training import optim as toptim
from openrec_tpu_torch.training import sparse as tsparse
from tests.conftest import make_interactions, make_low_rank

torch.set_num_threads(1)

RTOL, ATOL = 1e-4, 1e-7
LN_EMB = (50, 80, 30)
KW = dict(m_spa=4, ln_emb=LN_EMB, ln_bot=(8, 4), ln_top=(16, 1),
          dim_dense=3, loss_func="bce")
BPR_SPECS = {"user_embed": ["user_id"],
             "item_embed": ["p_item_id", "n_item_id"],
             "item_bias": ["p_item_id", "n_item_id"]}


def _batch(seed, B=24):
    rng = np.random.default_rng(seed)
    return {
        "dense_features": rng.normal(size=(B, 3)).astype(np.float32),
        "sparse_features": np.stack([rng.integers(0, c, B) for c in LN_EMB],
                                    axis=1).astype(np.int32),
        "label": rng.integers(0, 2, B).astype(np.float32)}


def _jbatch(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _np(tree):
    return jax.tree.map(np.array, tree)


def _dlrm_pair(fused=True, seed=0):
    jm = JDLRM(**KW, fused_tables=fused)
    jp = jm.init(jax.random.PRNGKey(seed))
    tm = DLRM(**KW, fused_tables=fused, device="cpu")
    tm.load_params(convert.params_from_jax(_np(jp), device="cpu"))
    return jm, jp, tm


def _assert_params(tm, jp, atol_of=None):
    jflat = convert.flatten_tree(_np(jp))
    assert set(jflat) == set(tm.params())
    for name, p in tm.params().items():
        np.testing.assert_allclose(p.detach().numpy(), jflat[name],
                                   rtol=RTOL,
                                   atol=(atol_of or {}).get(name, ATOL),
                                   err_msg=name)


def _assert_state(ts, js):
    """Sparse moments and count, and the dense optax state."""
    jsp = js["sparse"]
    assert int(ts["sparse"].count) == int(jsp.count)
    assert set(ts["sparse"].mu) == set(jsp.mu)
    for path in jsp.mu:
        for t, j in ((ts["sparse"].mu, jsp.mu), (ts["sparse"].nu, jsp.nu)):
            np.testing.assert_allclose(t[path].numpy(), np.asarray(j[path]),
                                       rtol=RTOL, atol=ATOL, err_msg=path)
    tdense = convert.flatten_tree(ts["dense"])
    jdense = convert.flatten_tree(_np(js["dense"]))
    assert set(tdense) == set(jdense)
    for key, value in jdense.items():
        np.testing.assert_allclose(np.asarray(tdense[key]), value,
                                   rtol=RTOL, atol=ATOL, err_msg=key)


# --------------------------------------------------------- unique_padded

@pytest.mark.parametrize("ids,cap", [
    ([5, 3, 5, 9, 3, 3], 6), ([5, 3, 5, 9, 3, 3, 7, 1], 3),
    ([5, 3, 5, 9, 3, 3, 7, 1], 5), ([4, 4, 4, 4], 4), ([8], 1),
    ([0, 2 ** 31 - 2, 7, 7], 4)])
def test_unique_padded_equals_jax(ids, cap):
    ids = np.asarray(ids, np.int32)
    ju, jv = jsparse.unique_padded(jnp.asarray(ids), cap)
    tu, tv = tsparse.unique_padded(torch.from_numpy(ids), cap)
    assert tu.dtype == torch.int32 and tv.dtype == torch.bool
    np.testing.assert_array_equal(tu.numpy(), np.asarray(ju))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))


@pytest.mark.parametrize("seed", range(4))
def test_unique_padded_random_equals_jax(seed):
    rng = np.random.default_rng(seed)
    n = int(rng.integers(1, 400))
    ids = rng.integers(0, int(rng.integers(1, 600)), n).astype(np.int32)
    ids = ids.reshape(-1, 1) if seed % 2 else ids      # any rank flattens
    for cap in sorted({1, n // 3 + 1, len(np.unique(ids)), n}):
        ju, jv = jsparse.unique_padded(jnp.asarray(ids), cap)
        tu, tv = tsparse.unique_padded(torch.from_numpy(ids), cap)
        np.testing.assert_array_equal(tu.numpy(), np.asarray(ju))
        np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))


def test_sparse_module_calls_no_torch_unique():
    """torch.unique's output length depends on the data (a host sync and
    no fixed shapes): the sparse step must not call it."""
    path = Path(tsparse.__file__)
    calls = [node.attr for node in ast.walk(ast.parse(path.read_text()))
             if isinstance(node, ast.Attribute)]
    assert not {"unique", "unique_consecutive", "item", "tolist",
                "nonzero"} & set(calls)


def test_subtable_lookup_grads_land_on_first_matches():
    ids = np.array([5, 3, 5, 9, 3, 3, 5], np.int32)
    cap = 7
    ju, _ = jsparse.unique_padded(jnp.asarray(ids), cap)
    tu, tv = tsparse.unique_padded(torch.from_numpy(ids), cap)
    w = np.random.default_rng(0).normal(size=(cap, 2)).astype(np.float32)
    jg = jax.grad(lambda r: jnp.sum(
        jsparse.SubTable(ju, r).lookup(jnp.asarray(ids)) ** 2))(
            jnp.asarray(w))
    rows = torch.from_numpy(w.copy()).requires_grad_()
    view = tsparse.SubTable(tu, rows)
    looked = view.lookup(torch.from_numpy(ids))
    np.testing.assert_array_equal(looked.detach().numpy(),
                                  w[[1, 0, 1, 2, 0, 0, 1]])
    (looked ** 2).sum().backward()
    np.testing.assert_allclose(rows.grad.numpy(), np.asarray(jg),
                               rtol=1e-6)
    # uids [3 5 9 9 9 9 9]: 3 x3, 5 x3, 9 x1 on its first slot, pads none
    counts = np.array([3, 3, 1, 0, 0, 0, 0], np.float32)
    np.testing.assert_allclose(rows.grad.numpy(),
                               2 * w * counts[:, None], rtol=1e-6)
    assert not tv[3:].any()
    with pytest.raises(TypeError, match="full-table"):
        view.T


# ------------------------------------------------------------ the step

@pytest.mark.parametrize("fused,id_cap", [(True, None), (False, None),
                                          (True, 40)],
                         ids=["fused", "separate", "fused-cap40"])
def test_sparse_steps_match_jax(fused, id_cap):
    """5 sparse steps: rows, mu, nu (keras-form Adam) and the dense MLP
    parameters (optax-form Adam) against JAX's make_sparse_train_step."""
    jm, jp, tm = _dlrm_pair(fused)
    specs_j = jsparse.dlrm_fused_table_spec(jm) if fused \
        else jsparse.dlrm_table_specs(len(LN_EMB))
    specs_t = tsparse.dlrm_fused_table_spec(tm) if fused \
        else tsparse.dlrm_table_specs(len(LN_EMB))
    jinit, jstep, _ = jsparse.make_sparse_train_step(
        jm, specs_j, learning_rate=0.01, id_cap=id_cap)
    tinit, tstep = tsparse.make_sparse_train_step(
        tm, specs_t, learning_rate=0.01, id_cap=id_cap)
    js, ts = jinit(jp), tinit(tm.params())
    for step in range(5):
        batch = _batch(seed=20 + step)
        jp, js, jl = jstep(jp, js, _jbatch(batch), jax.random.PRNGKey(step))
        ts, tl = tstep(ts, batch)
        np.testing.assert_allclose(tl.item(), float(jl), rtol=1e-5)
    _assert_params(tm, jp)
    _assert_state(ts, js)


def test_sparse_step_is_in_place_and_leaves_untouched_rows():
    _, _, tm = _dlrm_pair(True)
    start = tm.embed_fused.detach().clone()
    table_ptr = tm.embed_fused.data_ptr()
    init, step = tsparse.make_sparse_train_step(
        tm, tsparse.dlrm_fused_table_spec(tm), learning_rate=0.1)
    state = init(tm.params())
    mu_ptr = state["sparse"].mu[("embed_fused",)].data_ptr()
    touched = set()
    for s in range(3):
        batch = _batch(seed=40 + s, B=8)
        state, _ = step(state, batch)
        touched |= set(tm.flat_sparse_ids(batch["sparse_features"])
                       .reshape(-1).tolist())
    assert tm.embed_fused.grad is None          # no full-table gradient
    assert tm.embed_fused.data_ptr() == table_ptr
    assert state["sparse"].mu[("embed_fused",)].data_ptr() == mu_ptr
    new = tm.embed_fused.detach()
    untouched = sorted(set(range(sum(LN_EMB))) - touched)
    assert len(untouched) > 50
    np.testing.assert_array_equal(new[untouched].numpy(),
                                  start[untouched].numpy())
    mu = state["sparse"].mu[("embed_fused",)]
    assert not mu[untouched].any()
    moved = ~torch.isclose(new, start).all(dim=1)
    assert moved[sorted(touched)].all()


def test_sparse_mid_trajectory_carry():
    """3 JAX steps, then parameters and state carried into the port, then
    3 more steps on each side."""
    jm, jp, tm = _dlrm_pair(True, seed=3)
    jinit, jstep, _ = jsparse.make_sparse_train_step(
        jm, jsparse.dlrm_fused_table_spec(jm), learning_rate=0.01)
    js = jinit(jp)
    for step in range(3):
        jp, js, _ = jstep(jp, js, _jbatch(_batch(seed=60 + step)),
                          jax.random.PRNGKey(step))
    tm.load_params(convert.params_from_jax(_np(jp), device="cpu"))
    _, tstep = tsparse.make_sparse_train_step(
        tm, tsparse.dlrm_fused_table_spec(tm), learning_rate=0.01)
    ts = convert.sparse_opt_state_from_jax(_np(js), device="cpu")
    _assert_state(ts, js)
    back = convert.sparse_opt_state_to_numpy(ts)
    np.testing.assert_array_equal(back["sparse"]["mu"][("embed_fused",)],
                                  np.asarray(js["sparse"].mu[
                                      ("embed_fused",)]))
    assert int(back["dense"]["0"]["count"]) == 3
    for step in range(3, 6):
        batch = _batch(seed=60 + step)
        jp, js, jl = jstep(jp, js, _jbatch(batch), jax.random.PRNGKey(step))
        ts, tl = tstep(ts, batch)
        np.testing.assert_allclose(tl.item(), float(jl), rtol=1e-5)
    _assert_params(tm, jp)
    _assert_state(ts, js)


def test_sparse_step_bpr_matches_jax():
    """The list-of-keys specs on BPR, whose loss takes the views too.

    item_bias at atol 2e-6: an item drawn as a positive and a negative in
    one batch gets a bias gradient that nearly cancels (6e-6 from terms
    of ~1e-3), and Adam's normalisation turns the two libraries' rounding
    of that sum (relative ~4e-4) into ~lr * 1e-4 of the row's value."""
    store = JStore(make_interactions(), 40, 100, seed=0)
    sampler = JPairwise(store, batch_size=64, seed=0)
    batches = [sampler.sample() for _ in range(5)]
    jm = JBPR(total_users=40, total_items=100, dim_user_embed=8,
              dim_item_embed=8, l2_weight=0.1)
    jp = jm.init(jax.random.PRNGKey(0))
    tm = BPR(40, 100, 8, 8, l2_weight=0.1, device="cpu")
    tm.load_params(convert.params_from_jax(_np(jp), device="cpu"))
    jinit, jstep, _ = jsparse.make_sparse_train_step(jm, BPR_SPECS,
                                                     learning_rate=0.01)
    tinit, tstep = tsparse.make_sparse_train_step(tm, BPR_SPECS,
                                                  learning_rate=0.01)
    js, ts = jinit(jp), tinit(tm.params())
    for b in batches:
        jp, js, jl = jstep(jp, js, _jbatch(b), jax.random.PRNGKey(0))
        ts, tl = tstep(ts, b)
        np.testing.assert_allclose(tl.item(), float(jl), rtol=1e-5)
    _assert_params(tm, jp, atol_of={"item_bias": 2e-6})
    _assert_state(ts, js)


def test_sparse_spec_errors():
    _, _, tm = _dlrm_pair(True)
    b = _batch(seed=7)
    b["sparse_features"] = torch.as_tensor(b["sparse_features"])
    wrappers = {"columns": tsparse.Columns, "mixed": tsparse.ColumnIds,
                "hash": tsparse.Hashed, "hash4": tsparse.Hashed}
    for mode, cls in wrappers.items():
        spec = tsparse.dlrm_fused_table_spec(tm, mode=mode)
        assert set(spec) == {"embed_fused"}
        assert isinstance(spec["embed_fused"](b), cls)
    assert spec["embed_fused"](b).rounds == 4
    assert spec["embed_fused"](b).lookup_unroll == 4
    assert isinstance(tsparse.dlrm_fused_table_spec(tm, columnwise=True)
                      ["embed_fused"](b), tsparse.Columns)
    mixed = tsparse.dlrm_fused_table_spec(tm, mode="mixed")["embed_fused"](b)
    assert mixed.counts == LN_EMB and mixed.offsets == (0, 50, 130)
    flat = tsparse.dlrm_fused_table_spec(tm, mode="flat")["embed_fused"](b)
    assert isinstance(flat, torch.Tensor) and flat.dim() == 1
    with pytest.raises(ValueError, match="unknown dedup mode"):
        tsparse.dlrm_fused_table_spec(tm, mode="sorted")
    _, _, sep = _dlrm_pair(False)
    init, _ = tsparse.make_sparse_train_step(
        sep, {("embed_tables", 0): lambda b: b["sparse_features"][:, 0]})
    with pytest.raises(ValueError, match="mixes sparse and dense"):
        init(sep.params())


# ------------------------------------------------------------- Trainer

def _sparse_trainers(tmp_path=None):
    jm = JDLRM(**KW, fused_tables=True)
    jt = JTrainer(jm, lr=0.01, seed=0,
                  sparse_tables=jsparse.dlrm_fused_table_spec(jm),
                  save_model_dir=str(tmp_path / "j") if tmp_path else None)
    tm = DLRM(**KW, fused_tables=True, device="cpu")
    tm.load_params(convert.params_from_jax(_np(jt.params), device="cpu"))
    tt = Trainer(tm, lr=0.01, device="cpu",
                 sparse_tables=tsparse.dlrm_fused_table_spec(tm),
                 save_model_dir=str(tmp_path / "t") if tmp_path else None)
    return jt, tt


def test_trainer_sparse_tables_entry_points_match_jax():
    jt, tt = _sparse_trainers()
    assert isinstance(tt.opt_state["dense"][0], toptim.ScaleByAdamState)
    b = [_batch(seed=80 + i) for i in range(9)]
    jl, _ = jt.train_step(b[0])
    tl, aux = tt.train_step(b[0])
    np.testing.assert_allclose(tl.item(), float(jl), rtol=1e-5)
    assert aux["loss"] is tl
    np.testing.assert_allclose(tt.train_step_multi(b[1:4]).numpy(),
                               np.asarray(jt.train_step_multi(b[1:4])),
                               rtol=1e-5)
    flat = {k: np.concatenate([x[k] for x in b[4:6]]) for k in b[4]}
    np.testing.assert_allclose(tt.train_step_multi_flat(flat, 2).numpy(),
                               np.asarray(jt.train_step_multi_flat(flat, 2)),
                               rtol=1e-5)
    jt.train(3, iter(b[6:9]), verbose=False)
    tt.train(3, iter(b[6:9]), verbose=False)
    assert tt.global_step == jt.global_step == 9
    _assert_params(tt.model, jt.params)
    _assert_state(tt.opt_state, jt.opt_state)


def test_trainer_sparse_checkpoint_carries_across(tmp_path):
    """A JAX sparse Trainer's checkpoint (params and the sparse + optax
    state, under the same npz keys the port writes) restores into the port
    mid-trajectory; both then take 2 more steps alike."""
    jt, tt = _sparse_trainers(tmp_path)
    for i in range(2):
        jt.train_step(_batch(seed=90 + i))
        tt.train_step(_batch(seed=90 + i))
    jpath, tpath = jt.save(), tt.save()
    with np.load(jpath) as a, np.load(tpath) as b:
        assert set(a.files) == set(b.files)
        assert "opt_state/sparse/mu/('embed_fused',)" in b.files
        assert "opt_state/dense/0/mu/mlp_top/1/w" in b.files
    tm = DLRM(**KW, fused_tables=True, device="cpu")
    fresh = Trainer(tm, lr=0.01, device="cpu",
                    sparse_tables=tsparse.dlrm_fused_table_spec(tm))
    fresh.restore(jpath)
    _assert_state(fresh.opt_state, jt.opt_state)
    for i in range(2, 4):
        jt.train_step(_batch(seed=90 + i))
        fresh.train_step(_batch(seed=90 + i))
    _assert_params(tm, jt.params)
    _assert_state(fresh.opt_state, jt.opt_state)


def test_trainer_sparse_dense_optimizer_argument():
    """`optimizer` with sparse_tables drives the dense parameters only."""
    jm = JDLRM(**KW, fused_tables=True)
    from openrec_tpu.training import optim as joptim
    jt = JTrainer(jm, lr=0.01, seed=0, optimizer=joptim.keras_adam(0.02),
                  sparse_tables=jsparse.dlrm_fused_table_spec(jm))
    tm = DLRM(**KW, fused_tables=True, device="cpu")
    tm.load_params(convert.params_from_jax(_np(jt.params), device="cpu"))
    tt = Trainer(tm, lr=0.01, device="cpu", optimizer=toptim.keras_adam(0.02),
                 sparse_tables=tsparse.dlrm_fused_table_spec(tm))
    assert "embed_fused" not in tt.opt_state["dense"].mu
    for i in range(3):
        jt.train_step(_batch(seed=100 + i))
        tt.train_step(_batch(seed=100 + i))
    _assert_params(tm, jt.params)


def test_trainer_sparse_tables_device_sampled():
    """train_steps_device and train(device sampler) run the sparse step on
    batches drawn on the device; only the batch's rows move."""
    train, _ = make_low_rank()
    store = InteractionStore(train, 64, 256, seed=0)
    tm = BPR(64, 256, 16, 16, l2_weight=0.0, device="cpu",
             generator=torch.Generator().manual_seed(0))
    tt = Trainer(tm, lr=0.05, device="cpu", seed=1, sparse_tables=BPR_SPECS)
    sampler = DevicePairwiseSampler(store, 64, device="cpu")
    first = tt.train_steps_device(sampler, 20)
    assert first.shape == (20,)
    tt.train(40, sampler, steps_per_call=20, verbose=False)
    last = tt.train_steps_device(sampler, 20)
    assert tt.global_step == 80 == int(tt.opt_state["sparse"].count)
    assert int(tt.opt_state["dense"][0].count) == 80
    assert torch.isfinite(last).all() and last.mean() < first.mean()


# ---------------------------------------------------------- device loop

def test_sparse_device_loop_learns_like_jax():
    """K sparse steps on device-sampled BPR batches: the port's loss falls
    as JAX's does (the samplers' random streams differ: Philox here,
    threefry there, so the trajectories are compared by their losses)."""
    train, _ = make_low_rank()
    kw = dict(k=50, learning_rate=0.05)

    jstore = JStore(train, 64, 256, seed=0)
    jm = JBPR(total_users=64, total_items=256, dim_user_embed=16,
              dim_item_embed=16, l2_weight=0.0)
    jinit, jloop = jsparse.make_sparse_device_loop(
        jm, BPR_SPECS, JDeviceSampler(jstore, batch_size=512), **kw)
    jp = jm.init(jax.random.PRNGKey(0))
    js = jinit(jp)
    rng = jax.random.PRNGKey(1)
    jlosses = []
    for _ in range(6):
        rng, sub = jax.random.split(rng)
        jp, js, losses = jloop(jp, js, sub)
        jlosses.append(float(np.mean(np.asarray(losses))))

    tstore = InteractionStore(train, 64, 256, seed=0)
    tm = BPR(64, 256, 16, 16, l2_weight=0.0, device="cpu")
    tm.load_params(convert.params_from_jax(
        _np(jm.init(jax.random.PRNGKey(0))), device="cpu"))
    tinit, tloop = tsparse.make_sparse_device_loop(
        tm, BPR_SPECS, DevicePairwiseSampler(tstore, 512, device="cpu"),
        **kw)
    ts = tinit(tm.params())
    gen = torch.Generator().manual_seed(1)
    tlosses = []
    for _ in range(6):
        ts, losses = tloop(ts, gen)
        assert losses.shape == (50,)
        tlosses.append(losses.mean().item())
    assert int(ts["sparse"].count) == 300
    # the first 50 steps' mean loss agrees closely; later means, a few
    # thousandths, agree within a factor of 2 (other draws), and both
    # fall below 1 % of the first
    np.testing.assert_allclose(tlosses[0], jlosses[0], rtol=0.02)
    ratio = np.array(tlosses) / np.array(jlosses)
    assert (ratio > 0.5).all() and (ratio < 2.0).all(), (tlosses, jlosses)
    assert tlosses[-1] < 0.01 * tlosses[0]
    assert jlosses[-1] < 0.01 * jlosses[0]


# ------------------------------------------------------- optax-form adam

def _adam_schedule(seed=0, steps=6, scale=1.0):
    rng = np.random.default_rng(seed)
    params = {"w": rng.normal(size=(4, 3)).astype(np.float32),
              "b": rng.normal(size=(3,)).astype(np.float32)}
    grads = [{k: (rng.normal(size=v.shape) * scale).astype(np.float32)
              for k, v in params.items()} for _ in range(steps)]
    return params, grads


@pytest.mark.parametrize("scale", [1.0, 1e-7])
def test_optax_form_adam_matches_optax(scale):
    """At gradients of order eps the keras and optax forms part: the
    port's `adam` follows optax.adam there, its `keras_adam` does not."""
    params, grads = _adam_schedule(scale=scale)
    kw = dict(learning_rate=0.01, b1=0.9, b2=0.999, eps=1e-7)
    jtx = optax.adam(**kw)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    js = jtx.init(jp)
    out = {}
    for name in ("adam", "keras_adam"):
        tx = getattr(toptim, name)(**kw)
        tp = convert.params_from_jax({k: v.copy() for k, v in
                                      params.items()}, device="cpu")
        ts = tx.init(tp)
        for g in grads:
            upd, ts = tx.update({k: torch.from_numpy(v) for k, v in
                                 g.items()}, ts, tp)
            toptim.apply_updates(tp, upd)
        out[name] = (tp, ts)
    for g in grads:
        upd, js = jtx.update({k: jnp.asarray(v) for k, v in g.items()},
                             js, jp)
        jp = optax.apply_updates(jp, upd)
    tp, ts = out["adam"]
    for k in params:
        np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]),
                                   rtol=1e-6, atol=1e-9)
    assert int(ts[0].count) == int(js[0].count) == len(grads)
    assert set(convert.flatten_tree(ts)) \
        == set(convert.flatten_tree(_np(js)))
    keras = out["keras_adam"][0]
    gap = max(np.abs(keras[k].numpy() - np.asarray(jp[k])).max()
              for k in params)
    if scale < 1e-3:
        assert gap > 1e-4          # the forms differ at O(eps)
    else:
        assert gap < 1e-5


def test_adam_state_from_jax():
    params, grads = _adam_schedule(seed=1, steps=2)
    jtx = optax.adam(0.01)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    js = jtx.init(jp)
    upd, js = jtx.update({k: jnp.asarray(v) for k, v in grads[0].items()},
                         js, jp)
    ts = convert.opt_state_from_jax(_np(js), device="cpu")
    assert isinstance(ts[0], toptim.ScaleByAdamState)
    assert isinstance(ts[1], toptim.EmptyState)
    np.testing.assert_array_equal(ts[0].mu["w"].numpy(),
                                  np.asarray(js[0].mu["w"]))
    back = convert.opt_state_to_numpy(ts)
    np.testing.assert_array_equal(back["0"]["nu"]["b"],
                                  np.asarray(js[0].nu["b"]))
