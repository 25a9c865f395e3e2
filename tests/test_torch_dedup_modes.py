"""Port parity, the sparse step's dedup modes: `unique_padded_columns`,
`unique_padded_mixed`, `unique_hashed` / `hash_positions` /
`HashSubTable`, `dlrm_fused_table_spec(mode=...)` and the trajectories of
the four modes, against `openrec_tpu.training.sparse` on the same numpy
inputs.

Bars: uids, valid masks and the hash slot table bit-equal to JAX's; the
four modes' trajectories bit-identical to one another (JAX's own bar,
tests/test_sparse_step.py:300-336) and within rtol 1e-4, atol 1e-6 of
JAX's; `hash_positions` leaves gradients untouched and its straggler path
works (tests/test_sparse_step.py:80-120).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from openrec_tpu.models import DLRM as JDLRM
from openrec_tpu.training import sparse as jsparse
from openrec_tpu_torch import convert, trace
from openrec_tpu_torch.models import DLRM
from openrec_tpu_torch.training import Trainer
from openrec_tpu_torch.training import sparse as tsparse

torch.set_num_threads(1)

LN_EMB = (50, 80, 30)
KW = dict(m_spa=4, ln_emb=LN_EMB, ln_bot=(8, 4), ln_top=(16, 1),
          dim_dense=3, loss_func="bce", fused_tables=True)
MODES = ("flat", "columns", "mixed", "hash", "hash2")


def _ids_bt(seed, B, counts):
    rng = np.random.default_rng(seed)
    offsets = np.concatenate([[0], np.cumsum(counts)[:-1]])
    return np.stack([rng.integers(0, c, B) + o
                     for c, o in zip(counts, offsets)],
                    axis=1).astype(np.int32), tuple(int(o) for o in offsets)


def _eq(t, j):
    np.testing.assert_array_equal(t.numpy(), np.asarray(j))


@pytest.mark.parametrize("seed,B,counts", [(0, 16, (7, 3, 19)),
                                           (1, 32, (50, 80, 30)),
                                           (2, 5, (2, 1, 40, 9))])
def test_unique_padded_columns_equals_jax(seed, B, counts):
    ids, _ = _ids_bt(seed, B, counts)
    ju, jv = jsparse.unique_padded_columns(jnp.asarray(ids))
    tu, tv = tsparse.unique_padded_columns(torch.from_numpy(ids))
    _eq(tu, ju)
    _eq(tv, jv)
    # every original id resolves to its own row (SubTable's contract)
    u = tu.numpy()
    flat = ids.reshape(-1)
    np.testing.assert_array_equal(u[np.searchsorted(u, flat)], flat)


@pytest.mark.parametrize("seed,B,counts", [(0, 16, (7, 3, 19)),
                                           (1, 32, (50, 80, 30)),
                                           (3, 8, (8, 9, 2))])
def test_unique_padded_mixed_equals_jax(seed, B, counts):
    ids, offsets = _ids_bt(seed, B, counts)
    ju, jv = jsparse.unique_padded_mixed(
        jsparse.ColumnIds(jnp.asarray(ids), counts, offsets))
    tu, tv = tsparse.unique_padded_mixed(
        tsparse.ColumnIds(torch.from_numpy(ids), counts, offsets))
    _eq(tu, ju)
    _eq(tv, jv)


def test_unique_padded_mixed_ids_outside_their_range():
    """Contract-violating ids below a small table's offset or past its end
    mark nothing (JAX's clamp + mode="drop"), bit-equal to JAX."""
    counts, offsets = (4, 6, 20), (0, 4, 10)
    ids = np.array([[0, 4, 10], [3, 3, 29], [9, 10, 11], [-1, 4, 12]],
                   np.int32)
    ju, jv = jsparse.unique_padded_mixed(
        jsparse.ColumnIds(jnp.asarray(ids), counts, offsets))
    tu, tv = tsparse.unique_padded_mixed(
        tsparse.ColumnIds(torch.from_numpy(ids), counts, offsets))
    _eq(tu, ju)
    _eq(tv, jv)


@pytest.mark.parametrize("n,hi,rounds", [(300, 500, 8), (256, 40, 0),
                                         (1000, 2 ** 31 - 2, 8),
                                         (77, 77, 1), (1, 5, 8)])
def test_unique_hashed_slot_table_equals_jax(n, hi, rounds):
    rng = np.random.default_rng(n + rounds)
    ids = rng.integers(0, hi, n).astype(np.int32)
    ju, jv = jsparse.unique_hashed(jnp.asarray(ids), rounds=rounds)
    tu, tv = tsparse.unique_hashed(torch.from_numpy(ids), rounds=rounds)
    _eq(tu, ju)                      # slot for slot
    _eq(tv, jv)
    np.testing.assert_array_equal(np.sort(tu.numpy()[tv.numpy()]),
                                  np.unique(ids))


@pytest.mark.parametrize("unroll,rounds", [(8, None), (1, None),
                                           (1, "run")])
def test_hash_positions_equal_jax(unroll, rounds):
    """Every id probes to its own slot, JAX's slot; unroll=1 without the
    table's round count takes the straggler path (one host check a
    probe), with it no host check at all."""
    rng = np.random.default_rng(11)
    ids = rng.integers(0, 40, 256).astype(np.int32)   # heavy collisions
    ju, _ = jsparse.unique_hashed(jnp.asarray(ids), rounds=0)
    slots, _, run = tsparse._insert_hashed(torch.from_numpy(ids), rounds=0)
    _eq(slots, ju)
    want = jsparse.hash_positions(ju, jnp.asarray(ids), unroll=unroll)
    before = trace.counter("openrec.host_syncs")
    got = tsparse.hash_positions(slots, torch.from_numpy(ids),
                                 unroll=unroll,
                                 rounds=run if rounds else None)
    _eq(got, want)
    checks = trace.counter("openrec.host_syncs") - before
    assert (checks == 0) if rounds else (checks >= 1)


def test_insert_hashed_host_checks():
    """One host check after the unrolled rounds when every id landed;
    rounds=0 checks once a round until they have."""
    ids = torch.arange(64, dtype=torch.int32)
    before = trace.counter("openrec.host_syncs")
    _, _, run = tsparse._insert_hashed(ids, rounds=8)
    assert trace.counter("openrec.host_syncs") - before == 1 and run == 8
    before = trace.counter("openrec.host_syncs")
    _, _, run = tsparse._insert_hashed(ids, rounds=0)
    assert trace.counter("openrec.host_syncs") - before == run + 1


def test_hash_quirks_recorded():
    """The JAX package's quirks: an id absent from the table gets an
    arbitrary slot (JAX: its S-th probe; the port: its last probe, the
    table's round count given), and `Hashed` does not validate negative
    ids: the slot tables agree for them too. In the step a negative id
    gathers a zero row here where JAX clips it to row 0 (the gather is
    masked, as the sharded lookup's)."""
    ids = np.array([5, -3, 9, 5, -3], np.int32)
    ju, jv = jsparse.unique_hashed(jnp.asarray(ids))
    tu, tv = tsparse.unique_hashed(torch.from_numpy(ids))
    _eq(tu, ju)
    _eq(tv, jv)
    absent = np.array([7], np.int32)
    jpos = int(jsparse.hash_positions(ju, jnp.asarray(absent))[0])
    tpos = int(tsparse.hash_positions(tu, torch.from_numpy(absent))[0])
    assert tpos == jpos                       # both probe to the S-th
    assert 0 <= int(tsparse.hash_positions(
        tu, torch.from_numpy(absent), rounds=8)[0]) < tu.shape[0]
    rows = tsparse.masked_gather(torch.ones(10, 2), tu, 0)
    assert (rows.numpy()[tu.numpy() < 0] == 0).all()


def test_hash_subtable_gradients():
    """Gradients flow through a HashSubTable lookup; each unique id's slot
    gets 2 * its count, empty slots nothing (JAX's test, :96)."""
    ids = np.array([3, 7, 3, 1, 9, 7], np.int32)
    slots, valid, run = tsparse._insert_hashed(torch.from_numpy(ids),
                                               rounds=1)
    rows = torch.ones((slots.shape[0], 4), requires_grad=True)
    view = tsparse.HashSubTable(slots, rows, rounds=run)
    (view.lookup(torch.from_numpy(ids)) ** 2).sum().backward()
    counts = {3: 2, 7: 2, 1: 1, 9: 1}
    for s, (u, v) in enumerate(zip(slots.tolist(), valid.tolist())):
        want = 2.0 * counts.get(u, 0) if v else 0.0
        np.testing.assert_array_equal(rows.grad[s].numpy(), want)
    with pytest.raises(TypeError):
        view.T


def _batches(n=4, B=32, seed=5):
    rng = np.random.default_rng(seed)
    return [{
        "dense_features": rng.normal(size=(B, 3)).astype(np.float32),
        "sparse_features": np.stack([rng.integers(0, c, B) for c in LN_EMB],
                                    axis=1).astype(np.int32),
        "label": rng.integers(0, 2, B).astype(np.float32)}
        for _ in range(n)]


def _np(tree):
    return jax.tree.map(np.array, tree)


def _port_run(jp, mode, batches):
    tm = DLRM(**KW, device="cpu")
    tm.load_params(convert.params_from_jax(_np(jp), device="cpu"))
    init, step = tsparse.make_sparse_train_step(
        tm, tsparse.dlrm_fused_table_spec(tm, mode=mode),
        learning_rate=0.01)
    st = init(tm.params())
    losses = []
    for b in batches:
        st, loss = step(st, {k: torch.as_tensor(v) for k, v in b.items()})
        losses.append(loss.item())
    return tm, st, losses


def test_four_modes_bit_identical_and_match_jax():
    """At B = 32, 'mixed' takes both segment kinds (tables of 50 and 80
    rows dedup per column, the one of 30 is a static touched segment)."""
    jm = JDLRM(**KW)
    jp0 = _np(jm.init(jax.random.PRNGKey(0)))
    batches = _batches()
    runs = {mode: _port_run(jp0, mode, batches) for mode in MODES}
    ref_tm, ref_st, ref_losses = runs["flat"]
    for mode, (tm, st, losses) in runs.items():
        assert losses == ref_losses, mode
        for name, p in tm.params().items():
            np.testing.assert_array_equal(
                p.detach().numpy(), ref_tm.params()[name].detach().numpy(),
                err_msg=f"{mode} {name}")
        for part in ("mu", "nu"):
            np.testing.assert_array_equal(
                getattr(st["sparse"], part)[("embed_fused",)].numpy(),
                getattr(ref_st["sparse"], part)[("embed_fused",)].numpy())
    for mode in ("flat", "hash"):
        jinit, jstep, _ = jsparse.make_sparse_train_step(
            jm, jsparse.dlrm_fused_table_spec(jm, mode=mode),
            learning_rate=0.01)
        jp = jax.tree.map(jnp.asarray, jp0)     # the step donates it
        js = jinit(jp)
        for i, b in enumerate(batches):
            jp, js, jl = jstep(jp, js, {k: jnp.asarray(v)
                                        for k, v in b.items()},
                               jax.random.PRNGKey(i))
            np.testing.assert_allclose(ref_losses[i], float(jl), rtol=1e-5)
        jflat = convert.flatten_tree(_np(jp))
        for name, p in ref_tm.params().items():
            np.testing.assert_allclose(p.detach().numpy(), jflat[name],
                                       rtol=1e-4, atol=1e-6, err_msg=name)
        np.testing.assert_allclose(
            ref_st["sparse"].mu[("embed_fused",)].numpy(),
            np.asarray(js["sparse"].mu[("embed_fused",)]),
            rtol=1e-4, atol=1e-6)


@pytest.mark.parametrize("mode", ["columns", "mixed", "hash"])
def test_trainer_sparse_tables_every_mode(mode):
    """Trainer(sparse_tables=...) through train_step and the K-step entry
    point, each mode bit-identical to the flat mode's trainer."""
    jp = JDLRM(**KW).init(jax.random.PRNGKey(1))
    batches = _batches(n=5, seed=9)
    finals = []
    for m in ("flat", mode):
        tm = DLRM(**KW, device="cpu")
        tm.load_params(convert.params_from_jax(_np(jp), device="cpu"))
        tr = Trainer(tm, lr=0.01, device="cpu",
                     sparse_tables=tsparse.dlrm_fused_table_spec(tm, mode=m))
        tr.train_step(batches[0])
        losses = tr.train_step_multi(batches[1:]).numpy()
        finals.append((losses, {k: v.detach().numpy().copy()
                                for k, v in tm.params().items()}))
    np.testing.assert_array_equal(finals[0][0], finals[1][0])
    for name in finals[0][1]:
        np.testing.assert_array_equal(finals[0][1][name], finals[1][1][name])


# ---------------------------------------------- the tables' Adam, in place

def _update_as_written_before(table, mu, nu, uids, valid, hashed, lo, g,
                              alpha, b1, b2, eps):
    """Phases 4 and 5 of the sparse step for one table as the step wrote
    them before `ops.sparse_adam` took them over: both moments gathered at
    every slot, Adam, each delta masked by `valid` (and a partial table's
    dropped slots by a -0.0 fill at rows spread by position), three
    `index_add_`. lo: the first global row of a partial table (a hash
    table or a row block), None for a whole one."""
    v = valid[:, None].to(g.dtype)
    at, drop = uids, None
    if lo is not None:
        n_rows = table.shape[0]
        local = at.long() - lo
        keep = (local >= 0) & (local < n_rows)
        if hashed:
            keep = keep & valid
        at = torch.where(keep, local, torch.arange(
            local.shape[0], device=local.device) % n_rows)
        drop = ~keep[:, None]

    def delta(x):
        x = x * v
        return x if drop is None else x.masked_fill(drop, -0.0)

    mu_old = mu.index_select(0, at)
    nu_old = nu.index_select(0, at)
    mu_rows = b1 * mu_old + (1 - b1) * g
    nu_rows = b2 * nu_old + (1 - b2) * g * g
    step = -alpha * mu_rows / (torch.sqrt(nu_rows) + eps)
    table.index_add_(0, at, delta(step))
    mu.index_add_(0, at, delta(mu_rows - mu_old))
    nu.index_add_(0, at, delta(nu_rows - nu_old))


class _RowBlock(tsparse.RowLayout):
    """Block `block` of two equal row blocks of every table, as one rank of
    a two-way model mesh holds it, with nothing joined: the other block's
    rows gather as zeros and are not written."""

    def __init__(self, block: int):
        self.block = block

    def sharded(self, name):
        return True

    def shard_range(self, name, table):
        return self.block * table.shape[0], table.shape[0]


# case: (dedup mode, fused tables, id_cap, row block or None)
ADAM_CASES = {"flat": ("flat", True, None, None),
              "columns": ("columns", True, None, None),
              "mixed": ("mixed", True, None, None),
              "hash": ("hash", True, None, None),
              "flat-cap40": ("flat", True, 40, None),
              "separate": (None, False, None, None),
              "block0": ("flat", True, None, 0),
              "block1": ("flat", True, None, 1)}


@pytest.mark.parametrize("case", list(ADAM_CASES))
def test_sparse_adam_is_the_steps_former_arithmetic(case, monkeypatch):
    """Each of 3 steps calls `ops.sparse_adam_apply` once a table (its
    plain version, on the CPU) with the write mask and rows the step
    builds: table, mu and nu come out equal to the arithmetic it replaced,
    the live slots name distinct rows, and no row outside them changes, to
    the bit. In every dedup mode, with `id_cap` below the batch's 70-odd
    uniques, on the separate tables and on either block of a two-block
    `RowLayout`."""
    mode, fused, id_cap, block = ADAM_CASES[case]
    jp = JDLRM(**dict(KW, fused_tables=fused)).init(jax.random.PRNGKey(2))
    tm = DLRM(**dict(KW, fused_tables=fused), device="cpu")
    tm.load_params(convert.params_from_jax(_np(jp), device="cpu"))
    layout, lo = None, None
    if block is not None:
        n = sum(LN_EMB) // 2
        layout, lo = _RowBlock(block), block * n
        tm.embed_fused = torch.nn.Parameter(
            tm.embed_fused.detach()[lo:lo + n].clone())
    elif mode == "hash":
        lo = 0
    specs = tsparse.dlrm_fused_table_spec(tm, mode=mode) if fused \
        else tsparse.dlrm_table_specs(len(LN_EMB))
    init, step = tsparse.make_sparse_train_step(
        tm, specs, learning_rate=0.01, id_cap=id_cap, layout=layout)

    dedups, calls = [], []
    real_dedup, real_apply = tsparse._dedup, tsparse.sparse_adam_apply

    def dedup(raw, device, cap):
        out = real_dedup(raw, device, cap)
        dedups.append(out)
        return out

    def apply(table, mu, nu, at, write, g, alpha, b1, b2, eps):
        uids, valid, hashed, _ = dedups.pop(0)
        before = [t.clone() for t in (table, mu, nu)]
        want = [t.clone() for t in (table, mu, nu)]
        _update_as_written_before(*want, uids, valid, hashed is not None, lo,
                                  g, alpha, b1, b2, eps)
        real_apply(table, mu, nu, at, write, g, alpha, b1, b2, eps)
        live = at[write].long()
        assert live.unique().numel() == live.numel()
        outside = torch.ones(table.shape[0], dtype=torch.bool)
        outside[live] = False
        for got, w, b in zip((table, mu, nu), want, before):
            assert torch.equal(got, w)
            assert torch.equal(got[outside].view(torch.int32),
                               b[outside].view(torch.int32))
        calls.append(int((~write).sum()))

    monkeypatch.setattr(tsparse, "_dedup", dedup)
    monkeypatch.setattr(tsparse, "sparse_adam_apply", apply)
    state = init(tm.params())
    for b in _batches(n=3, seed=11):
        state, _ = step(state, {k: torch.as_tensor(v) for k, v in b.items()})
    assert len(calls) == 3 * len(specs) and not dedups
    # slots that write nothing, but where the uniques fill the cap
    assert (sum(calls) == 0) == (id_cap is not None)
