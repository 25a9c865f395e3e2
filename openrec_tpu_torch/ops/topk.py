"""Full-catalog score + top-k: library calls and the fused kernel K3.

Counterparts of `openrec_tpu/ops/topk.py`. `topk_xla` and `topk_approx`
are XLA code outside any Pallas kernel there: a matmul and a top-k.

`approx` maps to EXACT top-k. `lax.approx_max_k` (the TPU PartialReduce
op) has no PyTorch counterpart; exact top-k meets every `recall_target`
and equals what the JAX package returns on the CPU, where approx_max_k
is exact too.

Both order exact score ties as `lax.top_k` does, the lower id first
(`ops/ordered_topk.py`).

`fused_score_topk` (K3, the counterpart of the Pallas kernel
`_fused_topk_kernel`, `openrec_tpu/ops/topk.py:58-141`) returns the exact
top k of u.V^T + b without writing the [B, I] scores, ordered by score
descending and, among equal scores, by item id ascending (what lax.top_k
gives). On a CUDA tensor it runs four stages (`_prepare`, `STAGES`): the
K1 kernel as a bound pass, then `csrc/fused_topk.cu`'s threshold, filter
and final sort (built at first use), and counts one launch of K3 in the
counter `openrec.k3.launches` (`trace.py`); on a CPU tensor it runs
`fused_topk_plain`, a tiled running merge in plain PyTorch.
`_threshold_topk_stages_plain` models the four stages on the CPU for the
tests.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from openrec_tpu_torch import trace
from openrec_tpu_torch.ops import bucketed_topk as bt
from openrec_tpu_torch.ops.ordered_topk import topk_ordered

_TILE = 128                  # items per filter tile
_MAX_K = 2048
_SMEM_LIMIT = 232448         # bytes of shared memory a block can use
_FILTER_USERS = 32           # users per filter block: 8 warps of 4
_FILTER_BLOCKS_PER_SM = 2    # the filter's __launch_bounds__(256, 2)
_BOUND_BUCKETS = 8           # the bound pass keeps L >= 8 * Kb buckets


def dot_scores(user_vecs, item_table, item_bias):
    """u.V^T + b in fp32. bf16 tables are upcast first: `torch.matmul` on
    bf16 tensors would return bf16, where JAX accumulates into and returns
    fp32. Exact fp32 needs `torch.backends.cuda.matmul.allow_tf32` False
    (PyTorch's default) on the card."""
    s = user_vecs.float() @ item_table.float().T
    if item_bias is not None:
        s = s + item_bias.reshape(-1).float()
    return s


def topk_xla(user_vecs, item_table, item_bias, k):
    """(values, ids) of the exact top-k of u.V^T + b, ties by id."""
    return topk_ordered(dot_scores(user_vecs, item_table, item_bias), k)


def topk_approx(user_vecs, item_table, item_bias, k,
                recall_target: float = 0.99):
    """Same as `topk_xla`: exact top-k satisfies any `recall_target`."""
    del recall_target
    return topk_xla(user_vecs, item_table, item_bias, k)


# ------------------------------------------------------------ plain version

def fused_topk_plain(user_vecs, item_table, item_bias, k: int,
                     item_tile: int = 2048):
    """K3's function in plain PyTorch: stream item tiles of `item_tile`,
    keep a running top k per user, and merge each tile into it by a
    stable descending sort of concat([best, tile]), so that among equal
    scores the earlier entry (the smaller id) stays first, as lax.top_k
    does. (values f32 [B, k], ids i32 [B, k])."""
    B = user_vecs.shape[0]
    I = item_table.shape[0]
    dev = user_vecs.device
    best_v = torch.empty((B, 0), device=dev)
    best_i = torch.empty((B, 0), dtype=torch.int32, device=dev)
    for lo in range(0, I, item_tile):
        hi = min(lo + item_tile, I)
        s = dot_scores(user_vecs, item_table[lo:hi],
                       None if item_bias is None
                       else item_bias.reshape(-1)[lo:hi])
        ids = torch.arange(lo, hi, dtype=torch.int32,
                           device=dev).expand(B, -1)
        cat_v = torch.cat([best_v, s], dim=1)
        cat_i = torch.cat([best_i, ids], dim=1)
        order = torch.sort(cat_v, dim=1, descending=True,
                           stable=True).indices[:, :k]
        best_v = cat_v.gather(1, order)
        best_i = cat_i.gather(1, order)
    return best_v, best_i


def _threshold_topk_stages_plain(user_vecs, item_table, item_bias, k: int,
                                bucket: int | None = None):
    """The CUDA path's four stages in plain PyTorch, for the tests: K1's
    argmax ids at the plan's bucket (or `bucket`), tau = the k-th largest
    of their rescored values (-inf when fewer than k are real items), the
    filter s >= tau with its count, and per user either a stable sort of
    the candidates or, past C of them, the rescan's running top-Kb through
    chunks of C - Kb. One score matrix serves every stage, as one
    arithmetic serves the kernels. (vals [B, k], ids [B, k], count [B])."""
    B, D = user_vecs.shape
    I = item_table.shape[0]
    plan = fused_geometry(B, I, D, k, item_table.element_size())
    _, arg = bt.bucket_max_plain(user_vecs, item_table, item_bias,
                                 plan.bucket if bucket is None else bucket)
    s = dot_scores(user_vecs, item_table, item_bias)
    rescored = torch.where(arg < I, s.gather(1, arg.long().clamp(max=I - 1)),
                           float("-inf"))
    pad = rescored.new_full((B, max(0, k - rescored.shape[1])),
                            float("-inf"))
    tau = torch.cat([rescored, pad], 1).topk(k, dim=1).values[:, -1:]
    keep = s >= tau
    count = keep.sum(1).int()
    ids = torch.arange(I, dtype=torch.int32)

    def best(v, i, n):   # candidates are in id order: stable = id ascending
        order = torch.sort(v, descending=True, stable=True).indices[:n]
        return v[order], i[order]

    out_v, out_i = [], []
    for r in range(B):
        if count[r] <= plan.C:
            cv, ci = s[r][keep[r]], ids[keep[r]]
        else:
            cv, ci = s.new_empty(0), ids[:0]
            for lo in range(0, I, plan.C - plan.Kb):
                hi = lo + plan.C - plan.Kb
                cv, ci = best(torch.cat([cv, s[r, lo:hi]]),
                              torch.cat([ci, ids[lo:hi]]), plan.Kb)
        cv, ci = best(cv, ci, k)
        out_v.append(cv)
        out_i.append(ci)
    return torch.stack(out_v), torch.stack(out_i), count


# ------------------------------------------------------------------ kernel

def _round_up(x, m):
    return -(-x // m) * m


class K3Plan(NamedTuple):
    Kb: int                  # k rounded up to 32
    bucket: int              # the bound pass's K1 bucket
    L: int                   # its buckets per user
    C: int                   # candidate slots per user
    k1_split: int            # K1's member split (n_split)
    users_per_block: int     # of the filter
    n_slices: int            # catalog slices of the filter
    tiles_per_slice: int
    smem_tau: int            # bytes of shared memory per block
    smem_filter: int
    smem_final: int


@functools.lru_cache(maxsize=256)
def fused_geometry(B: int, I: int, D: int, k: int, itemsize: int = 4,
                   sm_count: int = 132) -> K3Plan:
    """K3's launch plan for u [B, D], V [I, D] of `itemsize` bytes.

    The bound pass takes the largest power-of-two K1 bucket, within K1's
    table-block shrink rule, that keeps L >= 8*Kb buckets (bucket 1 when
    none does); then L >= k, so tau exists. C is the smallest power of two
    >= 4*Kb. The filter's 128-item tiles are cut into contiguous slices so
    that slices x user groups of 32 fill the card once at its blocks per
    SM (a second, partial wave costs as much as the first). Raises where
    a kernel cannot take the shape: k > 2048, D beyond K1's limit, or a
    block's shared memory beyond the card's 227 KB."""
    if not 1 <= k <= _MAX_K:
        raise ValueError(f"k={k}: the kernel holds 1 <= k <= {_MAX_K}")
    if D > bt._MAX_DIM:
        raise ValueError(f"embedding dim {D} > {bt._MAX_DIM}, the limit of "
                         "the K1 bound pass")
    Kb = _round_up(k, 32)
    C = 1 << (4 * Kb - 1).bit_length()
    bucket = 1
    while True:
        wider, _, L = bt.bucket_geometry(I, D, itemsize, 2 * bucket)
        if wider != 2 * bucket or L < _BOUND_BUCKETS * Kb:
            break
        bucket = wider
    bucket, _, L = bt.bucket_geometry(I, D, itemsize, bucket)
    Dp = _round_up(D, 4)
    Sv = Dp if (Dp // 4) % 2 else Dp + 4
    smem = (4 * D + 4 * 258,                           # u, histogram, pick
            4 * (_FILTER_USERS * Dp + _TILE * Sv),     # u, one tile
            8 * C + 4 * D)                             # candidates, u
    if max(smem) > _SMEM_LIMIT:
        raise ValueError(f"k={k}, D={D}: {max(smem)} bytes of shared memory "
                         f"per block, more than the card's {_SMEM_LIMIT}")
    n_tiles = -(-I // _TILE)
    want = _FILTER_BLOCKS_PER_SM * sm_count // -(-B // _FILTER_USERS)
    n_slices = max(1, min(want, n_tiles))
    tiles_per_slice = -(-n_tiles // n_slices)
    n_slices = -(-n_tiles // tiles_per_slice)
    return K3Plan(Kb, bucket, L, C, bt._n_split(B, L, bucket, sm_count),
                  _FILTER_USERS, n_slices, tiles_per_slice, *smem)


def _k3_fn():
    from openrec_tpu_torch.ops import _build
    fn = _build.load("fused_topk").openrec_k3
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, p, p] + [i] * 10 + [p] * 8 + [i, i, p]
        fn.restype = ctypes.c_int
    return fn


_SM_COUNT: dict = {}          # device index -> multiprocessor count
_SCRATCH: dict = {}           # (device, stream, plan, B) -> scratch
_SCRATCH_KEEP = 8             # scratch buffers kept, newest last
STAGES = ("K1 pass", "tau", "filter", "final")


def _scratch(dev, stream, plan, B):
    """K3's scratch, one int32 buffer kept across calls on one stream
    (stream order keeps calls from overlapping; a new buffer on every call
    costs host time the launches wait for). Returns (buffer, count view
    [B], pointers): K1's v1, i1 [B, L] and split partials pv1, pi1
    [k1_split, B, L] (None without a split), tau, count [B], cand_v,
    cand_i [B, C]."""
    key = (dev.index, stream, plan, B)
    hit = _SCRATCH.pop(key, None)
    if hit is None:
        BL = B * plan.L
        split = plan.k1_split * BL if plan.k1_split > 1 else 0
        sizes = (BL, BL, split, split, B, B, B * plan.C, B * plan.C)
        ws = torch.empty(sum(sizes), device=dev, dtype=torch.int32)
        ptrs, at = [], ws.data_ptr()
        for n in sizes:
            ptrs.append(at if n else None)
            at += 4 * n
        hit = ws, ws.narrow(0, sum(sizes[:5]), B), ptrs
        while len(_SCRATCH) >= _SCRATCH_KEEP:
            _SCRATCH.pop(next(iter(_SCRATCH)))
    _SCRATCH[key] = hit
    return hit


def _prepare(user_vecs, item_table, item_bias, k: int):
    """K3 on CUDA tensors, ready to launch: (run, count). run(first, last,
    out) launches stages first .. last of STAGES (0 .. 3) on the current
    stream and raises on a CUDA error; the final stage writes out = (vals
    f32 [B, k], ids i32 [B, k]). count [B] i32 is the filter's candidate
    count of each user, overwritten by the next call of the same shape."""
    B, D = user_vecs.shape
    I = item_table.shape[0]
    dev = user_vecs.device
    if item_bias is not None:
        if item_bias.dtype != torch.float32:
            raise TypeError(f"item_bias must be float32, not "
                            f"{item_bias.dtype}")
        if item_bias.dim() != 1:
            item_bias = item_bias.reshape(-1)
    for name, t in (("user_vecs", user_vecs), ("item_table", item_table),
                    ("item_bias", item_bias)):
        if t is not None and not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    sm_count = _SM_COUNT.get(dev.index)
    if sm_count is None:
        sm_count = _SM_COUNT[dev.index] = torch.cuda.get_device_properties(
            dev).multi_processor_count
    plan = fused_geometry(B, I, D, k, item_table.element_size(), sm_count)
    if -(-B // plan.users_per_block) > 65535:
        raise ValueError(f"B={B}: more than 65535 user groups of "
                         f"{plan.users_per_block}")
    stream = torch.cuda.current_stream(dev).cuda_stream
    _, count, (v1, i1, pv1, pi1, *select) = _scratch(dev, stream, plan, B)
    bias = None if item_bias is None else item_bias.data_ptr()

    def launch(first, last, out):
        if first == 0:
            bt._launch_ptrs(user_vecs, item_table, item_bias, False,
                            plan.bucket, plan.k1_split, plan.L,
                            [v1, i1, None, None], [pv1, pi1, None, None],
                            stream)
        if last >= 1:
            err = _k3_fn()(
                user_vecs.data_ptr(), item_table.data_ptr(), bias,
                int(user_vecs.dtype == torch.bfloat16), B, I, D, plan.L, k,
                plan.Kb, plan.C, plan.n_slices, plan.tiles_per_slice, v1,
                i1, *select,
                None if out is None else out[0].data_ptr(),
                None if out is None else out[1].data_ptr(),
                max(first, 1), last, stream)
            if err != 0:
                raise RuntimeError(f"fused_topk launch failed: CUDA error "
                                   f"{err}")

    def run(first: int = 0, last: int = 3, out=None):
        if last == 3 and out is None:
            raise ValueError("the final stage needs out = (vals, ids)")
        if torch.cuda.current_device() == dev.index:
            launch(first, last, out)
        else:
            with torch.cuda.device(dev):
                launch(first, last, out)

    return run, count


def fused_score_topk(user_vecs, item_table, item_bias, k: int):
    """(top_vals f32 [B, k], top_ids i32 [B, k]): the exact top k of
    u.V^T + b, best first, the smaller id first among equal scores; the
    [B, I] scores are never written.

    user_vecs [B, D] and item_table [I, D] share a dtype (f32 or bf16);
    item_bias [I], [I, 1] (f32) or None. The dot accumulates in fp32.
    Limits of the kernels: 1 <= k <= min(I, 2048), D <= 384 (the K1
    bound pass), and a filter block's shared memory (about 4*160*D bytes)
    within 227 KB; the wrapper raises beyond them. On CUDA tensors
    `fused_score_topk.last_count` is then the [B] i32 count of candidates
    that passed the filter (at least k each; scratch that the next call
    of the same shape overwrites); on CPU tensors None. The TPU
    kernel's scheduling knobs (user_block, item_tile, interpret) fix no
    output and are dropped.
    """
    bt._check(user_vecs, item_table, item_bias)
    I = item_table.shape[0]
    if not 1 <= k <= min(I, _MAX_K):
        raise ValueError(f"k={k} must lie in [1, min(I={I}, {_MAX_K})]")
    if user_vecs.device.type == "cpu":
        fused_score_topk.last_count = None
        return fused_topk_plain(user_vecs, item_table, item_bias, k)
    run, count = _prepare(user_vecs, item_table, item_bias, k)
    B, dev = user_vecs.shape[0], user_vecs.device
    run(0, 2)       # the outputs are made while the first stages run
    vals = torch.empty((B, k), device=dev)
    ids = torch.empty((B, k), device=dev, dtype=torch.int32)
    run(3, 3, (vals, ids))
    trace.count("openrec.k3.launches")
    fused_score_topk.last_count = count
    return vals, ids


fused_score_topk.last_count = None

