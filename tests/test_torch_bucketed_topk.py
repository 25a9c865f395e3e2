"""Port parity: the bucket-max kernels' plain PyTorch versions and
`bucket_score_topk` against the JAX package's Pallas kernels (interpret
mode on the CPU), on the same numpy inputs; the launch plans of the
kernels' bf16 tensor-core routes (`tma_plan`, `mma_plan`) and fp32
CUDA-core route (`f32_plan`); and which tables take the TMA route
(`tma_route`).

Tolerances: values rtol=atol=1e-5 (fp32 sums taken in another order);
ids exact, except where the two picks score within 1e-5 of each other.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from openrec_tpu.ops.bucketed_topk import (
    bucket_max2_scores as jax_bucket_max2, bucket_max_scores as jax_bucket_max,
    pallas_score_topk)
import kernel_cases
from openrec_tpu_torch.ops.bucketed_topk import (
    bucket_geometry, bucket_max2_scores, bucket_max_scores,
    bucket_score_topk, choose_bucket, f32_plan, mma_plan, tma_plan,
    tma_route)
from openrec_tpu_torch.ops.topk import fused_geometry

torch.set_num_threads(1)

TOL = 1e-5


def _inputs(seed, B, I, D, bias=True):
    rng = np.random.default_rng(seed)
    u = rng.normal(size=(B, D)).astype(np.float32)
    v = rng.normal(size=(I, D)).astype(np.float32)
    b = rng.normal(size=(I,)).astype(np.float32) if bias else None
    return u, v, b


def _scores_padded(u, v, b, I_pad):
    """float64 scores of the (already rounded) inputs, -1e30 past I."""
    s = u.astype(np.float64) @ v.astype(np.float64).T
    if b is not None:
        s = s + b[None, :]
    pad = np.full((u.shape[0], I_pad - v.shape[0]), -1e30)
    return np.concatenate([s, pad], axis=1)


def _assert_ids(got, want, full):
    """ids equal, except where both picks score within TOL."""
    got, want = np.asarray(got, np.int64), np.asarray(want, np.int64)
    diff = got != want
    if diff.any():
        sg = np.take_along_axis(full, got, axis=1)[diff]
        sw = np.take_along_axis(full, want, axis=1)[diff]
        np.testing.assert_allclose(sg, sw, rtol=0, atol=TOL)


def _to_torch(u, v, b, dtype=torch.float32):
    return (torch.from_numpy(u).to(dtype), torch.from_numpy(v).to(dtype),
            None if b is None else torch.from_numpy(b))


SHAPES = [(4, 1024, 16, 8, 256),     # one grid block, several chunks
          (12, 700, 8, 4, 256),      # padded tail block
          (6, 1300, 16, 2, 128)]     # several grid blocks


@pytest.mark.parametrize("B,I,D,bucket,tile", SHAPES)
def test_bucket_max_matches_jax(B, I, D, bucket, tile):
    u, v, b = _inputs(2, B, I, D)
    want_v, want_i = jax_bucket_max(jnp.asarray(u), jnp.asarray(v),
                                    jnp.asarray(b), bucket=bucket,
                                    item_tile=tile, user_block=8,
                                    interpret=True)
    got_v, got_i = bucket_max_scores(*_to_torch(u, v, b), bucket=bucket)
    assert got_v.dtype == torch.float32 and got_i.dtype == torch.int32
    np.testing.assert_allclose(got_v.numpy(), np.asarray(want_v),
                               rtol=TOL, atol=TOL)
    _, item_block, L = bucket_geometry(I, D, 4, bucket)
    full = _scores_padded(u, v, b, L * bucket)
    _assert_ids(got_i.numpy(), np.asarray(want_i), full)


@pytest.mark.parametrize("B,I,D,bucket,tile", SHAPES)
def test_bucket_max2_matches_jax(B, I, D, bucket, tile):
    u, v, b = _inputs(5, B, I, D)
    want = jax_bucket_max2(jnp.asarray(u), jnp.asarray(v), jnp.asarray(b),
                           bucket=bucket, item_tile=tile, user_block=8,
                           interpret=True)
    got = bucket_max2_scores(*_to_torch(u, v, b), bucket=bucket)
    want_v1, want_i1, want_v2, want_i2 = (np.asarray(x) for x in want)
    got_v1, got_i1, got_v2, got_i2 = (x.numpy() for x in got)
    np.testing.assert_allclose(got_v1, want_v1, rtol=TOL, atol=TOL)
    np.testing.assert_allclose(got_v2, want_v2, rtol=TOL, atol=TOL)
    _, _, L = bucket_geometry(I, D, 4, bucket)
    full = _scores_padded(u, v, b, L * bucket)
    _assert_ids(got_i1, want_i1, full)
    # slot 2: the tie order is unspecified, so hold the id SETS equal up
    # to near-ties, and every reported pair exact
    _assert_ids(got_i2, want_i2, full)
    np.testing.assert_allclose(np.take_along_axis(full, got_i2, axis=1),
                               got_v2, rtol=TOL, atol=TOL)
    assert (got_i1 != got_i2).all()


def test_bucket_max_bf16_matches_jax():
    B, I, D, bucket = 5, 1500, 24, 4
    u, v, b = _inputs(7, B, I, D)
    ju, jv = jnp.asarray(u, jnp.bfloat16), jnp.asarray(v, jnp.bfloat16)
    want_v, want_i = jax_bucket_max(ju, jv, jnp.asarray(b), bucket=bucket,
                                    item_tile=256, user_block=8,
                                    interpret=True)
    tu, tv, tb = _to_torch(u, v, b, torch.bfloat16)
    got_v, got_i = bucket_max_scores(tu, tv, tb, bucket=bucket)
    np.testing.assert_allclose(got_v.numpy(), np.asarray(want_v),
                               rtol=TOL, atol=TOL)
    _, _, L = bucket_geometry(I, D, 2, bucket)
    full = _scores_padded(tu.float().numpy(), tv.float().numpy(), b,
                          L * bucket)
    _assert_ids(got_i.numpy(), np.asarray(want_i), full)
    # and the top-2 kernel on the same bf16 inputs
    w2 = [np.asarray(x) for x in jax_bucket_max2(
        ju, jv, jnp.asarray(b), bucket=bucket, item_tile=256, user_block=8,
        interpret=True)]
    g2 = [x.numpy() for x in bucket_max2_scores(tu, tv, tb, bucket=bucket)]
    np.testing.assert_allclose(g2[0], w2[0], rtol=TOL, atol=TOL)
    np.testing.assert_allclose(g2[2], w2[2], rtol=TOL, atol=TOL)
    _assert_ids(g2[1], w2[1], full)
    _assert_ids(g2[3], w2[3], full)


def test_bucket_max_shrink_rule_matches_jax():
    """The table-block shrink rule (a TPU VMEM budget in the JAX package)
    fixes `bucket` and so the output layout: the port keeps it."""
    for I, D, itemsize, bucket in [(450_166, 64, 2, 1024),
                                   (450_166, 64, 4, 256),
                                   (16_980, 50, 4, 4096), (1000, 8, 4, 3)]:
        got_bucket, item_block, L = bucket_geometry(I, D, itemsize, bucket)
        want = bucket
        while want > 1 and want * 128 * D * itemsize > 6 << 20:
            want //= 2
        assert got_bucket == want
        assert item_block == want * 128
        assert L == -(-I // item_block) * item_block // want


@pytest.mark.parametrize("per_bucket", [1, 2])
@pytest.mark.parametrize("recall_target", [None, 0.99, 0.995])
def test_bucket_score_topk_matches_jax(recall_target, per_bucket):
    B, I, D, k = 6, 20_000, 16, 20
    u, v, b = _inputs(11, B, I, D)
    want_v, want_i = pallas_score_topk(
        jnp.asarray(u), jnp.asarray(v), jnp.asarray(b), k, bucket=32,
        item_tile=4096, user_block=8, interpret=True,
        recall_target=recall_target, per_bucket=per_bucket)
    got_v, got_i = bucket_score_topk(*_to_torch(u, v, b), k, bucket=32,
                                     recall_target=recall_target,
                                     per_bucket=per_bucket)
    np.testing.assert_allclose(got_v.numpy(), np.asarray(want_v),
                               rtol=TOL, atol=TOL)
    full = _scores_padded(u, v, b, I)
    _assert_ids(got_i.numpy(), np.asarray(want_i), full)
    np.testing.assert_allclose(np.take_along_axis(full, got_i.numpy(), 1),
                               got_v.numpy(), rtol=TOL, atol=TOL)


def test_bucket_score_topk_short_tail_matches_jax():
    """k > 128 with a short tail grid block (I=1030, bucket=8): the
    non-empty-bucket guard must shrink the ratio so no padding id is
    returned (`tests/test_ops.py:124`)."""
    B, I, D, k = 4, 1030, 8, 200
    u, v, _ = _inputs(5, B, I, D, bias=False)
    want_v, want_i = pallas_score_topk(
        jnp.asarray(u), jnp.asarray(v), None, k, bucket=8, item_tile=256,
        user_block=8, interpret=True)
    got_v, got_i = bucket_score_topk(*_to_torch(u, v, None), k, bucket=8)
    assert got_i.max().item() < I
    assert got_v.min().item() > -1e29
    np.testing.assert_allclose(got_v.numpy(), np.asarray(want_v),
                               rtol=TOL, atol=TOL)
    _assert_ids(got_i.numpy(), np.asarray(want_i), _scores_padded(u, v,
                                                                   None, I))


@pytest.mark.parametrize("per_bucket", [1, 2])
def test_bucket_one_matches_jax(per_bucket):
    """bucket=1: one item per bucket, so the top-k is exact; the top-2
    kernel's second slot stays -inf and names the first member."""
    B, I, D, k = 3, 300, 8, 12
    u, v, b = _inputs(13, B, I, D)
    want_v, want_i = pallas_score_topk(
        jnp.asarray(u), jnp.asarray(v), jnp.asarray(b), k, bucket=1,
        item_tile=128, user_block=8, interpret=True, per_bucket=per_bucket)
    got_v, got_i = bucket_score_topk(*_to_torch(u, v, b), k, bucket=1,
                                     per_bucket=per_bucket)
    np.testing.assert_allclose(got_v.numpy(), np.asarray(want_v),
                               rtol=TOL, atol=TOL)
    full = _scores_padded(u, v, b, I)
    _assert_ids(got_i.numpy(), np.asarray(want_i), full)
    exact = np.argsort(-full, axis=1, kind="stable")[:, :k]
    _assert_ids(got_i.numpy(), exact, full)
    if per_bucket == 2:
        _, _, v2, i2 = bucket_max2_scores(*_to_torch(u, v, b), bucket=1)
        assert torch.isinf(v2).all() and (v2 < 0).all()
        L = v2.shape[1]
        assert (i2 == torch.arange(L, dtype=torch.int32)[None, :]).all()


# the bf16 shapes the card tests check (`kernel_cases.K1K2_CASES`), then
# D x B x bucket
PLAN_CASES = [(B, I, D, bucket) for _, B, I, D, dtype, bucket, _ in
              kernel_cases.K1K2_CASES if dtype == "bfloat16"] + [
    (B, 100_003, D, bucket) for D in (8, 50, 64, 128, 384)
    for B in (1, 37, 256) for bucket in (1, 64, 256)]


@pytest.mark.parametrize("B,I,D,bucket", PLAN_CASES)
def test_mma_plan(B, I, D, bucket):
    """The bf16 route's launch plan: it fits the card's shared memory, pads
    D to the mma depth, covers every (grid block j, lane half, member
    split, user tile) exactly once in the kernel's block order, and splits
    members until the grid fills the card where the bucket allows."""
    plan = mma_plan(B, I, D, bucket, top2=True, sm_count=132)
    assert plan == mma_plan(B, I, D, bucket, top2=False, sm_count=132)
    assert (plan.bucket, plan.L) == bucket_geometry(I, D, 2, bucket)[::2]
    assert plan.Dp % 16 == 0 and D <= plan.Dp < D + 16
    row = 2 * plan.Dp + 16               # bytes; odd in 16-byte chunks
    assert row % 32 == 16
    assert plan.smem == 64 * row + plan.stages * (64 * row + 64 * 4)
    assert plan.smem <= 232_448 and 2 <= plan.stages <= 4
    assert plan.blocks_per_sm >= 1
    assert (plan.users, plan.lanes, plan.threads) == (64, 64, 256)
    # the kernel's block order: user tile fastest, then lane half, split, j
    n_j, n_ut = plan.L // 128, -(-B // 64)
    idx = np.arange(plan.blocks)
    ut, rest = idx % n_ut, idx // n_ut
    h, z, j = rest & 1, (rest >> 1) % plan.n_split, (rest >> 1) // plan.n_split
    assert plan.blocks == n_j * 2 * plan.n_split * n_ut
    key = ((j * plan.n_split + z) * 2 + h) * n_ut + ut
    assert j.max() == n_j - 1 and np.array_equal(np.sort(key), idx)
    # blocks sharing a V tile (same j, half, split) are adjacent
    assert (np.diff(rest)[ut[1:] != 0] == 0).all()
    # member splits: every member in exactly one split
    a_per = -(-plan.bucket // plan.n_split)
    members = sorted(a for s in range(plan.n_split)
                     for a in range(s * a_per,
                                    min(plan.bucket, (s + 1) * a_per)))
    assert members == list(range(plan.bucket))
    assert plan.blocks >= 132 or plan.n_split * 2 > plan.bucket


# the fp32 shapes the card tests check (`kernel_cases.K1K2_CASES`), then
# D x B x bucket
F32_PLAN_CASES = [(B, I, D, bucket) for _, B, I, D, dtype, bucket, _ in
                  kernel_cases.K1K2_CASES if dtype == "float32"] + [
    (B, 100_003, D, bucket) for D in (1, 8, 50, 64, 128, 384)
    for B in (1, 37, 256) for bucket in (1, 2, 16, 64)]
# (B, I, D, bucket) -> (stages, smem) at CiteULike: K1 at `pallas`'s bucket
# 2, K2 at `pallas2`'s 16
F32_CITEULIKE = {(256, 16_980, 50, 2): (2, 41_312),
                 (256, 16_980, 50, 16): (4, 69_024)}


@pytest.mark.parametrize("B,I,D,bucket", F32_PLAN_CASES)
def test_f32_plan(B, I, D, bucket):
    """The fp32 route's launch plan: the user tile and S ring slots (a
    member tile and its bias slice each) fit the card's shared memory, the
    ring is 1 .. 4 deep and no deeper than the members a split block walks,
    as deep as two blocks an SM allow where they do, and the grid of
    `launch()` covers every (grid block j, lane half, member split, user
    tile) exactly once. D beyond 384 raises."""
    plan = f32_plan(B, I, D, bucket, top2=True, sm_count=132)
    assert plan == f32_plan(B, I, D, bucket, top2=False, sm_count=132)
    assert plan == f32_plan(B, I, D, bucket, False, n_split=plan.n_split)
    assert (plan.bucket, plan.L) == bucket_geometry(I, D, 4, bucket)[::2]
    tile = D * 68 * 4                      # [D][68] fp32
    slot = tile + 64 * 4                   # + the bias slice
    assert plan.smem == tile + plan.stages * slot
    assert plan.smem <= 232_448
    members = -(-plan.bucket // plan.n_split)
    assert 1 <= plan.stages <= min(4, members)
    if plan.stages < min(4, members):      # the budget set the depth
        two = 233_472 // 2 - 1024
        assert plan.smem + slot > (two if plan.smem <= two else 232_448)
    assert plan.blocks_per_sm == min(8, 233_472 // (plan.smem + 1024)) >= 1
    if (B, I, D, bucket) in F32_CITEULIKE:
        assert (plan.stages, plan.smem) == F32_CITEULIKE[B, I, D, bucket]
    # launch()'s grid: x = (j * 2 + h) * n_split + z, y = user tile
    n_j, n_ut = plan.L // 128, -(-B // 64)
    x = np.arange(n_j * 2 * plan.n_split)
    z, jh = x % plan.n_split, x // plan.n_split
    assert plan.blocks == x.size * n_ut
    cover = {(j, h, zz) for j, h, zz in zip(jh >> 1, jh & 1, z)}
    assert cover == {(j, h, zz) for j in range(n_j) for h in (0, 1)
                     for zz in range(plan.n_split)}
    assert plan.blocks >= 132 or plan.n_split * 2 > plan.bucket
    with pytest.raises(ValueError):
        f32_plan(B, I, 385, bucket, top2=False)


def test_f32_plan_k3_bound_pass():
    """K3's bound pass launches K1's fp32 route with its own member split:
    at CiteULike (bucket 16, split 2) it gets K2's ring, 4 slots in
    69,024 bytes."""
    k3 = fused_geometry(256, 16_980, 50, 100, 4, 132)
    plan = f32_plan(256, 16_980, 50, k3.bucket, False, n_split=k3.k1_split)
    assert (k3.bucket, k3.k1_split) == (16, 2)
    assert (plan.stages, plan.smem, plan.L) == (4, 69_024, k3.L)


@pytest.mark.parametrize("case", [c for c in kernel_cases.K1K2_CASES
                                  if c[0].startswith(("lastfm", "citeulike",
                                                      "tradesy", "amazon",
                                                      "netflix"))],
                         ids=lambda c: c[0])
def test_serving_cases_sit_at_their_methods_buckets(case):
    """The card tests' serving shapes sit at the bucket `bucket_score_topk`
    picks for the method of their kernel (K1 `pallas` at 0.99, K2
    `pallas2` at 0.995, k 100): LastFM's 2 and 8, Netflix's 2 and 16."""
    name, _, I, _, _, bucket, _ = case
    top2 = "K2" in name
    assert bucket == choose_bucket(I, 100, recall_target=0.995 if top2
                                   else 0.99, per_bucket=2 if top2 else 1)


@pytest.mark.parametrize("dtype,D,ptr,want", [
    (torch.bfloat16, 64, 0x7f0000000000, True),
    (torch.bfloat16, 8, 16, True),
    (torch.bfloat16, 40, 48, True),
    (torch.bfloat16, 256, 1 << 20, True),
    (torch.bfloat16, 64, 0x7f0000000008, False),   # 8-byte aligned
    (torch.bfloat16, 64, 0x7f0000000002, False),   # a view one element in
    (torch.bfloat16, 100, 0x7f0000000000, False),  # 200-byte rows
    (torch.bfloat16, 60, 0x7f0000000000, False),
    (torch.bfloat16, 50, 0x7f0000000000, False),
    (torch.bfloat16, 4, 0x7f0000000000, False),
    (torch.bfloat16, 264, 0x7f0000000000, False),  # past four chunks
    (torch.float32, 64, 0x7f0000000000, False),
    (torch.float16, 64, 0x7f0000000000, False),
])
def test_tma_route(dtype, D, ptr, want):
    """The TMA route is a function of dtype, D and the table's alignment
    alone: bf16 rows of whole 16-byte chunks (D a multiple of 8, up to
    256) starting on a 16-byte boundary."""
    assert tma_route(dtype, D, ptr) is want


def test_tma_route_of_the_card_cases():
    """Every bf16 card case's layout takes the route its name says: the
    aligned tables at D a multiple of 8 the TMA route, the views and D =
    50, 60 and 100 `bucket_max_mma`."""
    for name, _, _, D, dtype, _, layout in kernel_cases.K1K2_CASES:
        if dtype != "bfloat16":
            continue
        aligned = layout not in ("row", "element")
        assert tma_route(torch.bfloat16, D, 0 if aligned else 2) is (
            D % 8 == 0 and D <= 256 and aligned), name


# the bf16 shapes of the card cases that take the TMA route, then D x B x
# bucket
TMA_PLAN_CASES = [(B, I, D, bucket) for _, B, I, D, dtype, bucket, layout in
                  kernel_cases.K1K2_CASES if dtype == "bfloat16"
                  and D % 8 == 0 and layout not in ("row", "element")] + [
    (B, 100_003, D, bucket) for D in (8, 40, 64, 128, 256)
    for B in (1, 37, 256, 1000, 1024) for bucket in (1, 64, 256)]


def _tma_ranges(steps, grid):
    """The member steps each persistent block of the TMA route takes, in
    the kernel's arithmetic: block c takes [c * steps // grid, (c + 1) *
    steps // grid)."""
    return [(c * steps // grid, (c + 1) * steps // grid)
            for c in range(grid)]


def _tma_parts(plan, B):
    """The parts of the TMA route's blocks, as the kernel walks them: block
    c takes its range of member steps (`_tma_ranges`) in order, each part
    (block, unit, first member, end member), unit = (j * 2 + h) * n_ug +
    ug."""
    parts = []
    for c, (first, last) in enumerate(_tma_ranges(plan.steps, plan.grid)):
        pos = first
        while pos < last:
            unit, a0 = divmod(pos, plan.bucket)
            a1 = min(plan.bucket, a0 + last - pos)
            parts.append((c, unit, a0, a1))
            pos += a1 - a0
    return parts


def _step_owner(p, steps, grid):
    """The kernel's `step_owner`: the block whose range holds step p."""
    return ((p + 1) * grid - 1) // steps


@pytest.mark.parametrize("B,I,D,bucket", TMA_PLAN_CASES)
def test_tma_plan(B, I, D, bucket):
    """The TMA route's launch plan: the ring, the two user tiles and the
    barriers fit the card's shared memory from a
    1,024-byte boundary, the ring is 2 .. 12 deep and as deep as that
    allows; the persistent blocks' ranges hold every member of every (grid
    block j, lane half, user group of 128) exactly once, in member order
    within a unit, no block holds more than one step above another, and
    the kernel's owner arithmetic names a cut unit's parts and their
    workspace slots, each slot written once."""
    plan = tma_plan(B, I, D, bucket, sm_count=132)
    assert (plan.bucket, plan.L) == bucket_geometry(I, D, 2, bucket)[::2]
    assert plan.chunks == -(-D // 64) and plan.chunks * 64 >= D
    tile = plan.chunks * 64 * 128
    assert plan.smem == 1023 + (plan.stages + 2) * tile + 16 * plan.stages
    assert plan.smem <= 232_448 and 2 <= plan.stages <= 12
    assert plan.stages == 12 or plan.smem + tile + 16 > 232_448
    n_j, n_ug = plan.L // 128, -(-B // 128)
    assert plan.units == n_j * 2 * n_ug
    assert plan.steps == plan.units * plan.bucket
    assert plan.grid == min(132, plan.steps)
    sizes = [b - a for a, b in _tma_ranges(plan.steps, plan.grid)]
    assert sum(sizes) == plan.steps and max(sizes) - min(sizes) <= 1
    assert plan.fill == pytest.approx(plan.steps / (132 * max(sizes)))
    parts = _tma_parts(plan, B)
    by_unit = {}
    for c, unit, a0, a1 in parts:
        by_unit.setdefault(unit, []).append((c, a0, a1))
    assert sorted(by_unit) == list(range(plan.units))
    slots = []
    for unit, ps in by_unit.items():
        # the members of the unit once each, in block order
        assert ps[0][1] == 0 and ps[-1][2] == plan.bucket
        assert all(e == b for (_, _, e), (_, b, _) in zip(ps, ps[1:]))
        u_step = unit * plan.bucket
        lo = _step_owner(u_step, plan.steps, plan.grid)
        hi = _step_owner(u_step + plan.bucket - 1, plan.steps, plan.grid)
        assert [c for c, _, _ in ps] == list(range(lo, hi + 1))
        if len(ps) > 1:
            for c, a0, _ in ps:
                written = 2 * c + (0 if a0 > 0 else 1)
                read = 2 * c + (0 if c * plan.steps // plan.grid > u_step
                                else 1)
                assert written == read
                slots.append(written)
    assert len(slots) == len(set(slots))
    assert all(0 <= s < 2 * plan.grid for s in slots)
    # every unit's (j, h, ug) once
    assert {(u // n_ug >> 1, u // n_ug & 1, u % n_ug) for u in by_unit} == {
        (j, h, ug) for j in range(n_j) for h in (0, 1) for ug in range(n_ug)}


@pytest.mark.parametrize("what,B,k,target", [
    ("batch-k10", 1024, 10, 0.99), ("serve-k1", 256, 100, 0.99)])
def test_tma_plan_fills_the_serving_cells(what, B, k, target):
    """At both serving cells' K1 shapes (the Amazon catalog, 450,166 x 64
    bf16, `pallas` at recall 0.99) the 132 persistent blocks' rounds are
    at least 90 % full: batch-k10 (1,024 users, bucket 256 after the
    shrink rule, L 1,792: 224 units, 57,344 steps, 434 or 435 a block) and
    serve-k1 (256 users, bucket 64, L 7,040: 220 units, 14,080 steps, 106
    or 107 a block), where one unit a block in turn would fill 85 % and
    83 %."""
    I = kernel_cases.AMAZON["items"]
    plan = tma_plan(B, I, 64, choose_bucket(I, k, recall_target=target),
                    sm_count=132)
    assert plan.fill >= 0.99 and plan.grid == 132 and plan.stages == 12
    whole = plan.units * plan.bucket / (132 * -(-plan.units // 132)
                                        * plan.bucket)
    assert whole < 0.9


@pytest.mark.parametrize("D", (0, 4, 50, 60, 100, 264, 384))
def test_tma_plan_refuses_other_widths(D):
    with pytest.raises(ValueError):
        tma_plan(256, 10_000, D, 16)
