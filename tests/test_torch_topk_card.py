"""The serving kernels on the card: K1 and K2 (`csrc/bucket_max.cu`,
`ops.bucketed_topk`) and K3 (`csrc/fused_topk.cu`, `ops.topk`) against
their plain versions, and the serving path through
`CachedDotProductScorer` at full width.

Bars:
- K1 and K2 at every case of `kernel_cases.K1K2_CASES` (bf16 on the
  tensor-core route, fp32 on the CUDA-core route; a ragged catalog
  tail, bucket 1, a split bucket range, B 37, tables whose rows start
  8-, 4- or 2-byte aligned, twin bucket members, no bias, and the
  serving shapes and row shards at the buckets their methods pick):
  values within rtol = atol = 1e-5, ids equal except where both picks
  score within that tolerance, K2's two slots compared as id sets,
  every id in its column's bucket; among twin members slot 1 keeps the
  earlier and K2's slot 2 the twin; one launch counted a call;
- K3 at every case of `kernel_cases.K3_CASES` (k 1 to 1,000 and k == I,
  B and I off the tiling, duplicated rows, tables off a 16-byte
  boundary, all-equal scores, a catalog of fewer than 8 * Kb items, the
  serving shapes) against `fused_topk_plain` by the same bars, values
  best first and each the fp32 score at its id; every user has at least
  min(k, I) candidates; all-equal scores take the rescan branch and
  return ids 0 .. k-1; a planted tie puts the smaller id first; one
  launch counted a call;
- BPR at the Amazon catalog (99,473 x 450,166 x 64, bf16 serve tables)
  and at CiteULike's (5,551 x 16,980 x 50, fp32), weights made by numpy
  and loaded through `convert.params_from_jax`, 8 requests of 256 users,
  top-100 by `pallas` (recall target 0.99), `pallas2` (0.995), `exact`
  and `approx`: every score the fp32 score at its id, recall against
  `exact` at least the target less 0.01, K1 counted once a `pallas`
  request, K2 once a `pallas2` request, K3 never; `topk_ordered`'s sort
  and float routes return the same ids; one `eval_metrics` batch equal
  to the dense metrics.

The kernels have no CPU version, so every test needs a CUDA card and
skips without one. On a machine with a card, from the repository's root:

    python -m pytest --noconftest -p no:cacheprovider -m card \\
        tests/test_torch_topk_card.py

(`--noconftest`: the suite's conftest.py sets JAX up for the CPU tests,
and this file imports neither JAX nor the JAX package.)
"""

import pytest
import torch

from kernel_cases import (AMAZON, CITEULIKE, K1K2_CASES, K3_CASES, METHODS,
                          bpr_serving, bucket_of, hold_eval_metrics,
                          hold_k1k2, hold_k3, hold_serving, serve_topk)
from openrec_tpu_torch.ops import bucketed_topk as bt
from openrec_tpu_torch.ops import ordered_topk
from openrec_tpu_torch.ops import topk as tk

pytestmark = pytest.mark.card


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the serving kernels have no CPU "
                    "version")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", 0)


@pytest.fixture
def cuda():
    return _card()


def _k1k2_inputs(gen, dev, B, I, D, dtype, bucket, layout):
    """(u, v, b) on the card for one K1/K2 case, laid out as it says."""
    dt = getattr(torch, dtype)
    u = torch.randn(B, D, generator=gen, device=dev).to(dt)
    v = torch.randn(I, D, generator=gen, device=dev)
    b = torch.randn(I, generator=gen, device=dev)
    if layout == "twins":
        blk = 128 * bt.bucket_geometry(I, D, torch.finfo(dt).bits // 8,
                                       bucket)[0]
        t = torch.arange(I, device=dev)
        odd = ((t % blk) // 128) % 2 == 1
        v[odd] = v[t[odd] - 128]
        b[odd] = b[t[odd] - 128]
    if layout == "pad2":                # pad_rows' zero rows, never picked
        v[-2:] = 0.0
        b[-2:] = -1e30
    v = v.to(dt)
    if layout == "row":
        v = torch.cat([v[:1], v])[1:]
    elif layout == "element":
        flat = torch.empty(I * D + 1, device=dev, dtype=dt)
        flat[1:] = v.reshape(-1)
        v = flat[1:].view(I, D)
    if layout in ("row", "element"):
        assert v.data_ptr() % 16 != 0, f"{layout} view is 16-byte aligned"
    return u, v, None if layout == "nobias" else b


def _check_twins(u, v, b, bucket, top2):
    """With member 2m+1 a copy of member 2m, slot 1 must name the even
    member of its pair (the earlier one, strict `>`), and K2's slot 2 its
    twin, at the same value."""
    out = (bt.bucket_max2_scores if top2 else bt.bucket_max_scores)(
        u, v, b, bucket=bucket)
    torch.cuda.synchronize()
    blk = 128 * bucket_of(bt, v, bucket)
    v1, i1 = out[0], out[1].long()
    real = v1 > -1e29
    assert not (((i1 % blk) // 128 % 2 == 1) & real).any(), \
        "slot 1 kept the later twin of a tie"
    if top2:
        v2, i2 = out[2], out[3].long()
        has = real & (i1 + 128 < v.shape[0])
        assert ((i2 == i1 + 128) & (v2 == v1))[has].all(), \
            "slot 2 is not the twin of slot 1"


@pytest.mark.parametrize("kernel", ("K1", "K2"))
@pytest.mark.parametrize("case", K1K2_CASES, ids=lambda c: c[0])
def test_k1_k2_against_plain(cuda, case, kernel):
    _, B, I, D, dtype, bucket, layout = case
    top2 = kernel == "K2"
    gen = torch.Generator(device=cuda).manual_seed(B * D + I)
    u, v, b = _k1k2_inputs(gen, cuda, B, I, D, dtype, bucket, layout)
    hold_k1k2(torch, bt, u, v, b, bucket, top2, case[0])
    if layout == "twins":
        _check_twins(u, v, b, bucket, top2)


@pytest.mark.parametrize("case", K3_CASES, ids=lambda c: c[0])
def test_k3_against_plain(cuda, case):
    name, B, I, D, dt, k, layout = case
    dtype = getattr(torch, dt)
    gen = torch.Generator(device=cuda).manual_seed(B * D + I)
    u = torch.randn(B, D, generator=gen, device=cuda).to(dtype)
    v = torch.randn(I, D, generator=gen, device=cuda)
    b = torch.randn(I, generator=gen, device=cuda)
    if layout == "dup":     # item 3j+1 repeats item 3j, bias and all
        n = v[1::3].shape[0]
        v[1::3] = v[0::3][:n]
        b[1::3] = b[0::3][:n]
    if layout == "zero":
        v.zero_()
        b.zero_()
    v = v.to(dtype).contiguous()
    if layout == "offset":
        v = torch.cat([v[:1], v])[1:]
        assert v.data_ptr() % 16 != 0, "the view is 16-byte aligned"
    if layout == "nobias":
        b = None
    _, ids, count, _, _ = hold_k3(torch, tk, u, v, b, k, name)
    if layout == "zero":
        plan = tk.fused_geometry(
            B, I, D, k, v.element_size(),
            torch.cuda.get_device_properties(cuda).multi_processor_count)
        assert int((count > plan.C).sum()) == B, \
            "not every user took the rescan branch"
        assert torch.equal(ids, torch.arange(k, device=cuda, dtype=ids.dtype)
                           .expand(B, -1))
    if layout == "dup":     # the planted twins resolve to the smaller id
        twins = (ids % 3 == 1)[:, 1:] & (ids[:, 1:] - 1 != ids[:, :-1])
        assert not twins.any(), "a planted tie did not put the smaller id " \
            "first"


@pytest.fixture(scope="module", params=(AMAZON, CITEULIKE),
                ids=lambda c: c["name"])
def served(request):
    """`kernel_cases.bpr_serving` at one catalog's full width."""
    yield bpr_serving(torch, request.param, _card())


@pytest.mark.parametrize("method", METHODS)
def test_serving_route(served, method, monkeypatch):
    hold_serving(torch, served, method)
    # `topk_ordered`'s two routes forced on the method's rows: the stable
    # sort of the whole row's order keys, and the float path
    got = {}
    for route, short in (("sort", 1 << 62), ("float", 0)):
        monkeypatch.setattr(ordered_topk, "SHORT_ROW", short)
        got[route] = serve_topk(served.scorer, served.params,
                                served.requests[0], method)[1]
    assert torch.equal(got["sort"], got["float"])


def test_eval_metrics_equal_dense(served):
    hold_eval_metrics(torch, served)
