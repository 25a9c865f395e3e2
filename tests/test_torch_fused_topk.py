"""Port parity: the fused score + top-k kernel K3's plain version (and the
wrapper on CPU tensors) against the JAX package's `fused_score_topk` run
in interpret mode, on the shapes and oracles of `tests/test_ops.py`, with
planted exact ties.

Tolerances: values rtol=atol=1e-5 (fp32 sums taken in another order). Ids
are compared exactly: on these inputs no two distinct scores lie within
the tolerance, and exact ties (duplicated item rows) must resolve to the
smaller id in both packages.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from openrec_tpu.ops.topk import fused_score_topk as jax_fused, topk_xla
from openrec_tpu_torch.ops import topk as ttopk
from openrec_tpu_torch.ops.topk import (fused_geometry, fused_score_topk,
                                        fused_topk_plain)

torch.set_num_threads(1)

TOL = 1e-5


def _inputs(seed, B, I, D, dup=False):
    rng = np.random.default_rng(seed)
    u = rng.normal(size=(B, D)).astype(np.float32)
    v = rng.normal(size=(I, D)).astype(np.float32)
    b = rng.normal(size=(I,)).astype(np.float32)
    if dup:   # every item 3j+1 repeats item 3j: exact score ties
        n = len(v[1::3])
        v[1::3] = v[0::3][:n]
        b[1::3] = b[0::3][:n]
    return u, v, b


def _jax(u, v, b, k):
    vals, ids = jax_fused(jnp.asarray(u), jnp.asarray(v), jnp.asarray(b), k,
                          user_block=8, item_tile=128, interpret=True)
    return np.asarray(vals), np.asarray(ids)


def _port(fn, u, v, b, k, **kw):
    vals, ids = fn(torch.from_numpy(u), torch.from_numpy(v),
                   torch.from_numpy(b), k, **kw)
    assert vals.dtype == torch.float32 and ids.dtype == torch.int32
    return vals.numpy(), ids.numpy()


@pytest.mark.parametrize("B,I,D,k,dup", [
    (4, 1000, 16, 10, False),      # tests/test_ops.py:12
    (12, 300, 8, 50, False),       # tests/test_ops.py:12
    (5, 700, 8, 1, True),
    (6, 900, 8, 128, True),
    (3, 1100, 12, 129, True),
])
def test_fused_topk_plain_matches_jax(B, I, D, k, dup):
    u, v, b = _inputs(B * 7 + k, B, I, D, dup)
    want_v, want_i = _jax(u, v, b, k)
    for tile in (128, 2048):
        got_v, got_i = _port(fused_topk_plain, u, v, b, k, item_tile=tile)
        np.testing.assert_allclose(got_v, want_v, rtol=TOL, atol=TOL)
        np.testing.assert_array_equal(got_i, want_i)
    got_v, got_i = _port(fused_score_topk, u, v, b, k)
    np.testing.assert_array_equal(got_i, want_i)
    # the oracle of tests/test_ops.py: topk_xla's values
    xv, _ = topk_xla(jnp.asarray(u), jnp.asarray(v), jnp.asarray(b), k)
    np.testing.assert_allclose(got_v, np.asarray(xv), rtol=TOL, atol=TOL)


def test_planted_ties_take_the_smaller_id():
    u, v, b = _inputs(3, 4, 600, 8, dup=True)
    vals, ids = _port(fused_score_topk, u, v, b, 60)
    scores = u @ v.T + b
    for r in range(4):
        pairs = list(zip(-vals[r], ids[r]))
        assert pairs == sorted(pairs)          # score desc, then id asc
        np.testing.assert_allclose(scores[r, ids[r]], vals[r], rtol=TOL,
                                   atol=TOL)
        # each planted duplicate in the list sits right after its twin
        for pos, i in enumerate(ids[r]):
            if i % 3 == 1 and pos > 0:
                assert ids[r][pos - 1] == i - 1


def test_fused_topk_never_returns_padding():
    """tests/test_ops.py:29: I not tile-aligned and k == I."""
    u, v, b = _inputs(1, 4, 130, 8)
    b[:] = 0.0
    want_v, want_i = _jax(u, v, b, 130)
    got_v, got_i = _port(fused_score_topk, u, v, b, 130)
    assert got_i.max() < 130 and np.isfinite(got_v).all()
    np.testing.assert_array_equal(got_i, want_i)
    np.testing.assert_allclose(got_v, want_v, rtol=TOL, atol=TOL)


def test_bf16_tables_accumulate_in_fp32():
    u, v, b = _inputs(5, 6, 500, 16)
    ub = torch.from_numpy(u).bfloat16()
    vb = torch.from_numpy(v).bfloat16()
    got_v, got_i = fused_score_topk(ub, vb, torch.from_numpy(b)[:, None], 20)
    want_v, want_i = _jax(ub.float().numpy(), vb.float().numpy(), b, 20)
    np.testing.assert_allclose(got_v.numpy(), want_v, rtol=TOL, atol=TOL)
    np.testing.assert_array_equal(got_i.numpy(), want_i)


def test_wrapper_checks_and_limits():
    u, v, b = _inputs(0, 2, 50, 4)
    tu, tv, tb = map(torch.from_numpy, (u, v, b))
    with pytest.raises(ValueError):
        fused_score_topk(tu, tv, tb, 51)               # k > I
    with pytest.raises(ValueError):
        fused_score_topk(tu, tv, tb, 0)
    with pytest.raises(TypeError):
        fused_score_topk(tu, tv.double(), tb, 5)
    with pytest.raises(ValueError):
        fused_score_topk(tu, tv[:, :3], tb, 5)
    with pytest.raises(ValueError):
        fused_geometry(4, 10_000, 64, 2049)
    with pytest.raises(ValueError):                    # shared memory
        fused_geometry(4, 10_000, 1024, 1024)
    # no bias is zeros
    got = fused_score_topk(tu, tv, None, 5)
    want = fused_score_topk(tu, tv, torch.zeros(50), 5)
    assert torch.equal(got[1], want[1])


@pytest.mark.parametrize("B,I,D,k", [
    (256, 450_166, 64, 100), (256, 16_980, 50, 100), (9, 300, 50, 300),
    (70, 20_000, 64, 1000), (4, 10_000, 256, 2048), (1, 129, 8, 1)])
def test_launch_plan_covers_the_catalog(B, I, D, k):
    Kb, G, n_slices, tps, smem = fused_geometry(B, I, D, k)
    n_tiles = -(-I // 128)
    assert Kb % 32 == 0 and k <= Kb < k + 32
    assert G in (4, 8, 16, 32) and G * Kb * 8 <= 64 * 1024 or G == 4
    assert smem <= ttopk._SMEM_LIMIT
    assert (n_slices - 1) * tps < n_tiles <= n_slices * tps
    if n_slices > 1:                     # each slice outlasts 8 full lists,
        assert tps * 128 >= 8 * Kb       # and the grid is one wave
        assert n_slices * -(-B // G) <= 2 * 132
