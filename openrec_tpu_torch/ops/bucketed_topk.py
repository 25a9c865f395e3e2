"""Fused score + strided bucket-max top-k: the CUDA kernels and their
plain PyTorch versions.

Counterpart of `openrec_tpu/ops/bucketed_topk.py`. `bucket_max_scores`
(K1) and `bucket_max2_scores` (K2) return, per strided bucket of items,
the top-1 (or top-2) (score, item id) of u.V^T + b without writing the
[B, I] scores: item t belongs to bucket `(t // (128*bucket))*128 + t % 128`.
`bucket_score_topk` (the counterpart of `pallas_score_topk`) finishes with
an exact top-k over the [B, L] maxima, equal scores by candidate position
as `lax.top_k` orders them (`ops/ordered_topk.py`): every returned (score,
id) pair is exact, and a true top-k item is missed only when two (K2:
three) of them share a bucket.

On a CUDA tensor each wrapper launches its kernel (`csrc/bucket_max.cu`,
built at first use) and counts the launch in the counter
`openrec.k1.launches` or `openrec.k2.launches` (`trace.py`); on a CPU
tensor it runs the plain version (`bucket_max_plain`), which the
tests hold against the JAX package and `chip_smoke.py` holds against the
kernel on the card. bf16 tables take one of two tensor-core routes, by
what the inputs are (`tma_route`): a table whose rows are whole 16-byte
chunks (D a multiple of 8, up to 256) and whose storage starts on a
16-byte boundary takes `bucket_max_wgmma` (a TMA producer warp and two
`wgmma` consumer warpgroups on one persistent block an SM; `tma_plan`
sizes it; each launch also counts `openrec.bucket_max.tma_launches`);
every other bf16 table takes `bucket_max_mma` (mma.sync fed by a
cp.async ring; `mma_plan` sizes it). fp32 tables take the CUDA-core
route (`bucket_max_f32_kernel`: fp32 FMAs fed by a cp.async ring;
`f32_plan` sizes it), which keeps the scores exact in fp32.

Geometry is the JAX package's (`_bucket_call_setup`, :211-256): the
`_MAX_VBLOCK_BYTES` shrink rule is a TPU VMEM budget, but it changes
`bucket` and so the output, and is kept. The TPU-only scheduling knobs
(`item_tile`, `user_block`, `interpret`, `reduction`) fix no output and
are dropped.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import NamedTuple

import torch

from openrec_tpu_torch import trace
from openrec_tpu_torch.ops.ordered_topk import topk_ordered

_LANES = 128                     # bucket stride of the strided layout
_MAX_VBLOCK_BYTES = 6 << 20      # the JAX package's per-block table budget
_MAX_DIM = 384                   # f32 route: the user tile and one ring
                                 # slot, D*68*4 B each, fill a block
_F32_STRIDE = 68                 # f32 route: shared row stride (floats)
_BLOCK_USERS, _HALVES = 64, 2    # a kernel block: 64 users x 64 of 128 lanes
_THREADS = 256                   # 8 warps, each 16 users x 32 lanes (mma)
_PAD_SCORE = -1e30
_SMEM_LIMIT = 232448             # bytes of shared memory a block can use
_SMEM_PER_SM = 233472            # an SM's 228 KB, 1 KB of it kept per block
_MAX_STAGES = 4                  # either route's deepest ring
TMA_LAUNCHES = "openrec.bucket_max.tma_launches"
_TMA_MAX_DIM = 256               # TMA route: four 64-column chunks a row
_TMA_CHUNK_BYTES = 64 * 128      # [64 rows][128 B], one swizzled chunk
_TMA_UNIT_USERS = 128            # two consumer warpgroups of 64 users
_TMA_MAX_STAGES = 12


def _round_up(x, m):
    return -(-x // m) * m


def bucket_geometry(num_items: int, dim: int, itemsize: int, bucket: int):
    """(bucket, item_block, L) after the table-block shrink rule
    (`openrec_tpu/ops/bucketed_topk.py:222-233`)."""
    while bucket > 1 and bucket * _LANES * dim * itemsize > _MAX_VBLOCK_BYTES:
        bucket //= 2
    item_block = bucket * _LANES
    return bucket, item_block, _round_up(num_items, item_block) // bucket


# ------------------------------------------------------------ plain version

def bucket_max_plain(user_vecs, item_table, item_bias, bucket: int,
                     top2: bool = False):
    """The kernels' function in plain PyTorch, after the shrink rule:
    (v1, i1) or (v1, i1, v2, i2), each [B, L]. Scores are fp32; a tie goes
    to the earliest bucket member, in both slots."""
    B, D = user_vecs.shape
    I = item_table.shape[0]
    bucket, item_block, L = bucket_geometry(
        I, D, item_table.element_size(), bucket)
    I_pad = L * bucket
    s = user_vecs.float() @ item_table.float().T
    if item_bias is not None:
        s = s + item_bias.reshape(-1).float()
    s = torch.cat([s, s.new_full((B, I_pad - I), _PAD_SCORE)], dim=1)
    s = s.reshape(B, I_pad // item_block, bucket, _LANES)
    base = (torch.arange(I_pad // item_block, device=s.device)[:, None]
            * item_block + torch.arange(_LANES, device=s.device)[None, :])

    def slot(scores):
        # argmax returns the first maximal index: earliest member wins
        a = scores.argmax(dim=2, keepdim=True)
        vals = scores.gather(2, a).squeeze(2)
        ids = base + a.squeeze(2) * _LANES
        return vals.reshape(B, L), ids.reshape(B, L).int(), a

    v1, i1, a1 = slot(s)
    if not top2:
        return v1, i1
    v2, i2, _ = slot(s.scatter(2, a1, float("-inf")))
    return v1, i1, v2, i2


# ------------------------------------------------------------------ kernels

def _kernel_fn(name: str = "openrec_bucket_max"):
    from openrec_tpu_torch.ops import _build
    fn = getattr(_build.load("bucket_max"), name)
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = {
            "openrec_bucket_max": [p, p, p] + [i] * 11 + [p] * 9,
            "openrec_bucket_max_tma": [p, p, p] + [i] * 10 + [p] * 10,
            "openrec_bucket_max_tma_map": [p, i, i, p]}[name]
        fn.restype = ctypes.c_int
    return fn


_TMA_MAPS: dict = {}      # (table pointer, I, D) -> its TMA map (128 B)
_TMA_MAPS_KEEP = 64
_TMA_SCRATCH: dict = {}   # (device, stream, top2) -> workspace, counts
_SM_COUNT: dict = {}      # device index -> SMs


def _tma_map(item_table):
    """The table's TMA map, made once for each (pointer, I, D): the map is
    a function of those alone, so a hit is always right."""
    I, D = item_table.shape
    key = (item_table.data_ptr(), I, D)
    m = _TMA_MAPS.get(key)
    if m is None:
        m = ctypes.create_string_buffer(128)
        err = _kernel_fn("openrec_bucket_max_tma_map")(key[0], I, D, m)
        if err != 0:
            raise RuntimeError(f"TMA map of the [{I}, {D}] table failed: "
                               f"driver error {err}")
        while len(_TMA_MAPS) >= _TMA_MAPS_KEEP:
            _TMA_MAPS.pop(next(iter(_TMA_MAPS)))
        _TMA_MAPS[key] = m
    return m


def _tma_scratch(dev, stream, top2: bool, plan: TmaPlan):
    """Device pointers (ws_v1, ws_i1, ws_v2, ws_i2, counts) of the TMA
    route's workspace on this stream: for each block 2 slots of 32 x 256
    entries of each state array (the parts of units cut between blocks),
    and a count a unit and warpgroup. The kernel leaves the counts zero; a
    launch of a larger shape gets a larger, zeroed buffer."""
    key = (dev.index, stream, top2)
    hit = _TMA_SCRATCH.get(key)
    if hit is None or hit[1] < plan.grid or hit[2] < plan.units:
        grid = max(plan.grid, hit[1] if hit else 0)
        units = max(plan.units, hit[2] if hit else 0)
        n = 2 * grid * 32 * 256           # entries of one state array
        ws = torch.empty(n * (4 if top2 else 2), device=dev,
                         dtype=torch.int32)
        counts = torch.zeros(2 * units, device=dev, dtype=torch.int32)
        at = ws.data_ptr()
        ptrs = [at, at + 4 * n] + ([at + 8 * n, at + 12 * n] if top2
                                   else [None, None])
        hit = _TMA_SCRATCH[key] = ((ws, counts), grid, units,
                                   ptrs + [counts.data_ptr()])
    return hit[3]


def _sm_count(dev) -> int:
    n = _SM_COUNT.get(dev.index)
    if n is None:
        n = _SM_COUNT[dev.index] = torch.cuda.get_device_properties(
            dev).multi_processor_count
    return n


def _n_split(B: int, L: int, bucket: int, sm_count: int) -> int:
    """Split the members of each bucket across blocks until the grid fills
    the card once (a second pass merges the splits). Both routes' blocks
    are 64 users x 64 lanes, so one rule serves both."""
    blocks = (L // _LANES) * _HALVES * (-(-B // _BLOCK_USERS))
    n = 1
    while blocks * n < sm_count and n * 2 <= bucket:
        n *= 2
    return n


class MmaPlan(NamedTuple):
    bucket: int              # after the table-block shrink rule
    L: int                   # buckets per user
    Dp: int                  # D zero-padded to the mma depth (16)
    stages: int              # member tiles in the cp.async ring
    users: int               # per block (4 warps of 16)
    lanes: int               # per block (2 warps of 32)
    threads: int
    n_split: int             # member splits (a merge pass when > 1)
    blocks: int              # grid: (L/128) x n_split x 2 x ceil(B/64)
    smem: int                # dynamic shared memory bytes per block
    blocks_per_sm: int       # as the shared memory allows


@functools.lru_cache(maxsize=256)
def mma_plan(B: int, I: int, D: int, bucket: int, top2: bool,
             sm_count: int = 132) -> MmaPlan:
    """Launch plan of the bf16 tensor-core route for u [B, D], V [I, D].

    A block owns 64 users x 64 lanes of one grid block (the same for K1
    and K2, so `top2` changes nothing here): the user tile [64, Dp] and a
    ring of `stages` member tiles [64, Dp] of bf16, each row padded by 16
    bytes (an odd number of 16-byte chunks, so ldmatrix is free of bank
    conflicts), plus a bias slice of 64 floats per stage. The ring is as
    deep as two blocks an SM allow (at most 4), else as one block allows;
    at least 2. Raises where D > 384 or the tiles do not fit."""
    del top2
    if not 1 <= D <= _MAX_DIM:
        raise ValueError(f"embedding dim {D}: the kernels take 1 .. "
                         f"{_MAX_DIM}")
    bucket, _, L = bucket_geometry(I, D, 2, bucket)
    Dp = _round_up(D, 16)
    row = 2 * Dp + 16
    fixed = _BLOCK_USERS * row
    per_stage = _LANES // _HALVES * (row + 4)
    stages = 0
    for budget in (_SMEM_PER_SM // 2 - 1024, _SMEM_LIMIT):
        stages = min(_MAX_STAGES, (budget - fixed) // per_stage)
        if stages >= 2:
            break
    if stages < 2:
        raise ValueError(f"D={D}: two ring stages do not fit in "
                         f"{_SMEM_LIMIT} bytes of shared memory")
    smem = fixed + stages * per_stage
    n_split = _n_split(B, L, bucket, sm_count)
    blocks = (L // _LANES) * n_split * _HALVES * (-(-B // _BLOCK_USERS))
    return MmaPlan(bucket, L, Dp, stages, _BLOCK_USERS, _LANES // _HALVES,
                   _THREADS, n_split, blocks, smem,
                   min(2, _SMEM_PER_SM // (smem + 1024)))


def tma_route(dtype, dim: int, data_ptr: int) -> bool:
    """Whether K1/K2 take the TMA route for a table of this dtype, width
    and start address: bf16 rows of whole 16-byte chunks (D a multiple of
    8, at most 256), the table starting on a 16-byte boundary, which a TMA
    map needs. Every other bf16 table takes `bucket_max_mma`."""
    return (dtype == torch.bfloat16 and dim % 8 == 0
            and 8 <= dim <= _TMA_MAX_DIM and data_ptr % 16 == 0)


class TmaPlan(NamedTuple):
    bucket: int              # after the table-block shrink rule
    L: int                   # buckets per user
    chunks: int              # 64-column chunks of a row (D zero-padded)
    stages: int              # member tiles in the TMA ring
    units: int               # (L/128) x 2 x ceil(B/128): lanes x users
    steps: int               # units x bucket members
    grid: int                # persistent blocks, one an SM at most
    smem: int                # dynamic shared memory bytes per block
    fill: float              # steps over SMs x the busiest block's steps


@functools.lru_cache(maxsize=256)
def tma_plan(B: int, I: int, D: int, bucket: int,
             sm_count: int = 132) -> TmaPlan:
    """Launch plan of the bf16 TMA route for u [B, D], V [I, D].

    A work unit is 128 users x 64 lanes of one grid block, its `bucket`
    members its steps; block c of the `grid` takes steps [c * steps //
    grid, (c + 1) * steps // grid), so every round is full to a step, and
    a unit cut between blocks is merged by the block that finishes it last
    (no merge pass). Shared memory: a ring of `stages` member tiles
    (chunks x [64][128 B]), the two warpgroups' user tiles in the same
    layout, a full and an empty barrier a stage, and 1023 bytes to align
    the ring to 1,024. The ring is as deep as the card's 227 KB allow, at
    most 12. Raises where D is not a multiple of 8 in 8 .. 256."""
    if D % 8 or not 8 <= D <= _TMA_MAX_DIM:
        raise ValueError(f"embedding dim {D}: the TMA route takes "
                         f"multiples of 8 up to {_TMA_MAX_DIM}")
    bucket, _, L = bucket_geometry(I, D, 2, bucket)
    chunks = -(-D // 64)
    tile = chunks * _TMA_CHUNK_BYTES
    stages = min(_TMA_MAX_STAGES, (_SMEM_LIMIT - 1023 - 2 * tile)
                 // (tile + 16))
    smem = 1023 + (stages + 2) * tile + 16 * stages
    units = L // _LANES * _HALVES * -(-B // _TMA_UNIT_USERS)
    steps = units * bucket
    grid = min(sm_count, steps)
    return TmaPlan(bucket, L, chunks, stages, units, steps, grid, smem,
                   steps / (sm_count * -(-steps // grid)))


class F32Plan(NamedTuple):
    bucket: int              # after the table-block shrink rule
    L: int                   # buckets per user
    stages: int              # member tiles in the cp.async ring
    n_split: int             # member splits (a merge pass when > 1)
    blocks: int              # grid: (L/128) x 2 x n_split x ceil(B/64)
    smem: int                # dynamic shared memory bytes per block
    blocks_per_sm: int       # as the shared memory (and threads) allow


@functools.lru_cache(maxsize=256)
def f32_plan(B: int, I: int, D: int, bucket: int, top2: bool,
             sm_count: int = 132, n_split: int | None = None) -> F32Plan:
    """Launch plan of the fp32 CUDA-core route for u [B, D], V [I, D].

    A block owns 64 users x 64 lanes of one grid block (`top2` changes
    nothing here): the user tile [D][68] fp32, transposed, then a ring of
    `stages` slots, each a member tile [D][68] and its bias slice of 64
    floats. The ring is at most 4 deep, no deeper than the members a split
    block walks, and as deep as two blocks an SM allow, else as one block
    allows; at least 1. `n_split` is the member split the launch uses
    (K3's bound pass passes its own); by default `_n_split`'s. Raises
    where D is outside 1 .. 384."""
    del top2
    if not 1 <= D <= _MAX_DIM:
        raise ValueError(f"embedding dim {D}: the kernels take 1 .. "
                         f"{_MAX_DIM}")
    bucket, _, L = bucket_geometry(I, D, 4, bucket)
    if n_split is None:
        n_split = _n_split(B, L, bucket, sm_count)
    tile = D * _F32_STRIDE * 4
    slot = tile + _LANES // _HALVES * 4
    two = (_SMEM_PER_SM // 2 - 1024 - tile) // slot
    one = (_SMEM_LIMIT - tile) // slot
    stages = min(_MAX_STAGES, -(-bucket // n_split), two if two >= 1 else one)
    smem = tile + stages * slot
    blocks = (L // _LANES) * _HALVES * n_split * (-(-B // _BLOCK_USERS))
    return F32Plan(bucket, L, stages, n_split, blocks, smem,
                   min(2048 // _THREADS, _SMEM_PER_SM // (smem + 1024)))


def _check(user_vecs, item_table, item_bias):
    if user_vecs.dim() != 2 or item_table.dim() != 2 \
            or user_vecs.shape[1] != item_table.shape[1]:
        raise ValueError(f"shapes {tuple(user_vecs.shape)} and "
                         f"{tuple(item_table.shape)}: want [B, D] and [I, D]")
    if user_vecs.dtype != item_table.dtype \
            or user_vecs.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError("user_vecs and item_table must share one dtype, "
                        f"float32 or bfloat16; got {user_vecs.dtype} and "
                        f"{item_table.dtype}")
    if item_bias is not None and item_bias.numel() != item_table.shape[0]:
        raise ValueError(f"item_bias has {item_bias.numel()} entries for "
                         f"{item_table.shape[0]} items")
    dev = user_vecs.device
    if item_table.device != dev or (item_bias is not None
                                    and item_bias.device != dev):
        raise ValueError("user_vecs, item_table and item_bias must share "
                         "one device")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {dev}")


def _launch(user_vecs, item_table, item_bias, bucket: int, top2: bool):
    B, D = user_vecs.shape
    I = item_table.shape[0]
    if D > _MAX_DIM:
        raise ValueError(f"embedding dim {D} > {_MAX_DIM}, the kernel's "
                         "shared-memory limit")
    if item_bias is not None:
        if item_bias.dtype != torch.float32:
            raise TypeError(f"item_bias must be float32, not "
                            f"{item_bias.dtype}")
        item_bias = item_bias.reshape(-1)
    for name, t in (("user_vecs", user_vecs), ("item_table", item_table),
                    ("item_bias", item_bias)):
        if t is not None and not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    bucket, _, L = bucket_geometry(I, D, item_table.element_size(), bucket)
    dev = user_vecs.device
    n_out = 4 if top2 else 2
    outs = [torch.empty((B, L), device=dev,
                        dtype=torch.float32 if k % 2 == 0 else torch.int32)
            for k in range(n_out)]
    # the TMA route balances its blocks itself and writes no split parts
    n_split = 1 if tma_route(item_table.dtype, D, item_table.data_ptr()) \
        else _n_split(B, L, bucket, _sm_count(dev))
    parts = [torch.empty((n_split, B, L), device=dev, dtype=o.dtype)
             for o in outs] if n_split > 1 else []

    def ptrs(tensors):            # unused outputs are passed as null
        return [t.data_ptr() for t in tensors] + [None] * (4 - len(tensors))

    with torch.cuda.device(dev):
        _launch_ptrs(user_vecs, item_table, item_bias, top2, bucket, n_split,
                     L, ptrs(outs), ptrs(parts),
                     torch.cuda.current_stream(dev).cuda_stream)
    return tuple(outs)


def _launch_ptrs(user_vecs, item_table, item_bias, top2: bool, bucket: int,
                 n_split: int, L: int, outs, parts, stream):
    """Launch the kernel into outputs given as device pointers: `outs` and
    `parts` are 4 each (v1, i1, v2, i2), None where unused; item_bias is
    [I] or None. bf16 tables that `tma_route` admits take the TMA route
    with `tma_plan`'s ring and grid, which balances its own blocks and
    writes `outs` directly (`n_split` and `parts` unused), other bf16 tables
    the mma route with `mma_plan`'s depth, ring and shared memory, fp32
    inputs the CUDA-core route with `f32_plan`'s ring and shared memory
    for this `n_split`. K3's bound pass calls this on its own
    workspace."""
    B, D = user_vecs.shape
    I = item_table.shape[0]
    bf16 = user_vecs.dtype == torch.bfloat16
    if tma_route(item_table.dtype, D, item_table.data_ptr()):
        dev = user_vecs.device
        tp = tma_plan(B, I, D, bucket, _sm_count(dev))
        err = _kernel_fn("openrec_bucket_max_tma")(
            user_vecs.data_ptr(), None if item_bias is None
            else item_bias.data_ptr(), _tma_map(item_table), int(top2), B, I,
            D, bucket, L, tp.chunks, tp.stages, tp.smem, tp.grid, *outs,
            *_tma_scratch(dev, stream, top2, tp), stream)
        if err != 0:
            raise RuntimeError(f"bucket_max TMA kernel launch failed: CUDA "
                               f"error {err}")
        trace.count(TMA_LAUNCHES)
        return
    if bf16:
        mp = mma_plan(B, I, D, bucket, top2)
        plan = (mp.Dp, mp.stages, mp.smem)
    else:
        fp = f32_plan(B, I, D, bucket, top2, n_split=n_split)
        plan = (0, fp.stages, fp.smem)
    err = _kernel_fn()(
        user_vecs.data_ptr(), item_table.data_ptr(),
        None if item_bias is None else item_bias.data_ptr(),
        int(bf16), int(top2), B, I, D, bucket, n_split, L, *plan,
        *outs, *parts, stream)
    if err != 0:
        raise RuntimeError(f"bucket_max kernel launch failed: CUDA error "
                           f"{err}")


def bucket_max_scores(user_vecs, item_table, item_bias, bucket: int = 128):
    """[B, L] (bucket-max scores f32, argmax item ids i32) of u.V^T + b,
    L = 128*ceil(I/(128*bucket)) after the shrink rule. user_vecs [B, D]
    and item_table [I, D] share a dtype (f32 or bf16); item_bias [I],
    [I, 1] or None. Items past I score -1e30; the dot accumulates in fp32.
    """
    _check(user_vecs, item_table, item_bias)
    if user_vecs.device.type == "cpu":
        return bucket_max_plain(user_vecs, item_table, item_bias, bucket)
    out = _launch(user_vecs, item_table, item_bias, bucket, top2=False)
    trace.count("openrec.k1.launches")
    return out


def bucket_max2_scores(user_vecs, item_table, item_bias, bucket: int = 256):
    """Top-2 per bucket: [B, L] (v1, i1, v2, i2); same layout and inputs as
    `bucket_max_scores`. Slot 1 keeps the earliest member on ties; the id
    order of exact ties in slot 2 is unspecified (the values are exact)."""
    _check(user_vecs, item_table, item_bias)
    if user_vecs.device.type == "cpu":
        return bucket_max_plain(user_vecs, item_table, item_bias, bucket,
                                top2=True)
    out = _launch(user_vecs, item_table, item_bias, bucket, top2=True)
    trace.count("openrec.k2.launches")
    return out


# ------------------------------------------------------------------- top-k

def bucket_score_topk(user_vecs, item_table, item_bias, k: int,
                      bucket: int = 128, recall_target: float | None = None,
                      per_bucket: int = 1):
    """(top_vals, top_ids): the fused bucket pass + exact top-k over its
    [B, L] maxima (or [B, 2L] candidates with per_bucket=2).

    recall_target: if given, `bucket` is IGNORED: the ratio becomes the
    largest power of two whose expected recall meets the target,
    1 - (k-1)/(2L) for per_bucket=1 and L >= sqrt(C(k-1,2)/(1-target)) for
    per_bucket=2 (`openrec_tpu/ops/bucketed_topk.py:370-384`). The ratio
    then shrinks until at least k buckets hold a real item (:396-405), and
    the table-block shrink rule applies inside the bucket pass.
    """
    bucket = choose_bucket(item_table.shape[0], k, bucket, recall_target,
                           per_bucket)
    with trace.span("openrec.serve.score"):
        if per_bucket == 2:
            v1, i1, v2, i2 = bucket_max2_scores(user_vecs, item_table,
                                                item_bias, bucket=bucket)
            vals = torch.cat([v1, v2], dim=1)
            ids = torch.cat([i1, i2], dim=1)
        else:
            vals, ids = bucket_max_scores(user_vecs, item_table, item_bias,
                                          bucket=bucket)
    with trace.span("openrec.serve.select"):
        # ties by candidate position, as lax.top_k over the candidates
        top_vals, pos = topk_ordered(vals, k)
        return top_vals, ids.gather(1, pos)


def choose_bucket(I: int, k: int, bucket: int = 128,
                  recall_target: float | None = None,
                  per_bucket: int = 1) -> int:
    """The bucket ratio `bucket_score_topk` hands to K1/K2 for a catalog of
    I items (its docstring gives the rule)."""
    if k > I:
        raise ValueError(f"k={k} > {I} items")
    if per_bucket not in (1, 2):
        raise ValueError(f"per_bucket must be 1 or 2, not {per_bucket}")
    if recall_target is not None and k > 1:
        if per_bucket == 2:
            pairs = (k - 1) * (k - 2) / 2.0
            l_min = math.sqrt(pairs / max(1e-6, 1.0 - recall_target)) \
                if pairs > 0 else 1.0
        else:
            l_min = (k - 1) / (2.0 * max(1e-6, 1.0 - recall_target))
        bucket = max(1, int(I / max(l_min, 1.0)))
        while bucket & (bucket - 1):          # round down to power of two
            bucket &= bucket - 1

    def nonempty_buckets(ratio):
        blk = _LANES * ratio
        n = -(-I // blk)
        return _LANES * (n - 1) + min(I - (n - 1) * blk, _LANES)

    while bucket > 1 and nonempty_buckets(bucket) < k:
        bucket //= 2
    return bucket
