"""Full-catalog score + top-k: library calls and the fused kernel K3.

Counterparts of `openrec_tpu/ops/topk.py`. `topk_xla` and `topk_approx`
are XLA code outside any Pallas kernel there: a matmul and a top-k.

`approx` maps to EXACT top-k. `lax.approx_max_k` (the TPU PartialReduce
op) has no PyTorch counterpart; exact top-k meets every `recall_target`
and equals what the JAX package returns on the CPU, where approx_max_k
is exact too.

`torch.topk` orders exact score ties arbitrarily, while `lax.top_k` puts
the lower index first; the two can differ only at such ties.

`fused_score_topk` (K3, the counterpart of the Pallas kernel
`_fused_topk_kernel`, `openrec_tpu/ops/topk.py:58-141`) returns the exact
top k of u.V^T + b without writing the [B, I] scores, ordered by score
descending and, among equal scores, by item id ascending (what lax.top_k
gives). On a CUDA tensor it launches `csrc/fused_topk.cu` (built at first
use) and counts the launch in `fused_score_topk.launches`; on a CPU tensor
it runs `fused_topk_plain`, the same tiled running merge in plain PyTorch.
"""

from __future__ import annotations

import ctypes

import torch

from openrec_tpu_torch.ops.bucketed_topk import _check

_TILE = 128                  # items per kernel tile
_MAX_K = 2048                # longest running list the kernel holds
_SMEM_LIMIT = 232448         # bytes of shared memory a block can use
_LIST_SMEM = 64 * 1024       # running lists' share of a block's memory
_SCRATCH_WORDS = 576         # per warp: 4 users' pending + merge chunk
_BLOCKS_PER_SM = 2           # the kernel's __launch_bounds__(256, 2)
_SLICE_LISTS = 8             # a slice holds at least this many full lists


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
    """(values, ids) of the exact top-k of u.V^T + b."""
    return torch.topk(dot_scores(user_vecs, item_table, item_bias), k, dim=1)


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


# ------------------------------------------------------------------ kernel

def _round_up(x, m):
    return -(-x // m) * m


def fused_geometry(B: int, I: int, D: int, k: int, sm_count: int = 132):
    """The kernel's launch plan: (Kb, G, n_slices, tiles_per_slice, smem).
    Kb = k rounded up to 32 is each user's running list; G users (4 per
    warp) share a block, fewer for long lists so that the lists take at
    most 64 KB; the catalog's 128-item tiles are cut into contiguous
    slices so that slices x user groups fill the card once at two blocks
    an SM (a second, partial wave costs as much as the first), each slice
    at least 8*Kb items long (every slice fills its own list before its
    filter bites, so short slices drown in merges). Raises if a block's
    shared memory would pass the card's 227 KB."""
    if not 1 <= k <= _MAX_K:
        raise ValueError(f"k={k}: the kernel holds 1 <= k <= {_MAX_K}")
    Kb = _round_up(k, 32)
    G = 32
    while G > 4 and G * Kb * 8 > _LIST_SMEM:
        G //= 2
    Dp = _round_up(D, 4)
    Sv = Dp if (Dp // 4) % 2 else Dp + 4
    smem = 4 * (G * Dp + _TILE * Sv + 2 * G * Kb + (G // 4) * _SCRATCH_WORDS)
    if smem > _SMEM_LIMIT:
        raise ValueError(f"k={k}, D={D}: {smem} bytes of shared memory per "
                         f"block, more than the card's {_SMEM_LIMIT}")
    n_tiles = -(-I // _TILE)
    want = _BLOCKS_PER_SM * sm_count // -(-B // G)
    min_tiles = max(2, -(-_SLICE_LISTS * Kb // _TILE))
    n_slices = max(1, min(want, n_tiles // min_tiles))
    tiles_per_slice = -(-n_tiles // n_slices)
    n_slices = -(-n_tiles // tiles_per_slice)
    return Kb, G, n_slices, tiles_per_slice, smem


def _kernel_fn():
    from openrec_tpu_torch.ops import _build
    fn = _build.load("fused_topk").openrec_fused_topk
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, p, p, i, i, i, i, i, i, i, i, i, p, p, p, p, p, p]
        fn.restype = ctypes.c_int
    return fn


def _launch(user_vecs, item_table, item_bias, k: int):
    B, D = user_vecs.shape
    I = item_table.shape[0]
    dev = user_vecs.device
    if item_bias is not None:
        if item_bias.dtype != torch.float32:
            raise TypeError(f"item_bias must be float32, not "
                            f"{item_bias.dtype}")
        item_bias = item_bias.reshape(-1)
    for name, t in (("user_vecs", user_vecs), ("item_table", item_table),
                    ("item_bias", item_bias)):
        if t is not None and not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    Kb, G, n_slices, tiles_per_slice, _ = fused_geometry(
        B, I, D, k, torch.cuda.get_device_properties(dev)
        .multi_processor_count)
    if -(-B // G) > 65535:
        raise ValueError(f"B={B}: more than 65535 user groups of {G}")
    out_v = torch.empty((B, k), device=dev)
    out_i = torch.empty((B, k), device=dev, dtype=torch.int32)
    thr = torch.empty(B, device=dev)   # the slices' shared k-th score bound
    part_v = part_i = None
    if n_slices > 1:
        part_v = torch.empty((n_slices, B, Kb), device=dev)
        part_i = torch.empty((n_slices, B, Kb), device=dev,
                             dtype=torch.int32)
    with torch.cuda.device(dev):
        err = _kernel_fn()(
            user_vecs.data_ptr(), item_table.data_ptr(),
            None if item_bias is None else item_bias.data_ptr(),
            int(user_vecs.dtype == torch.bfloat16), B, I, D, k, Kb, G,
            n_slices, tiles_per_slice, out_v.data_ptr(), out_i.data_ptr(),
            None if part_v is None else part_v.data_ptr(),
            None if part_i is None else part_i.data_ptr(), thr.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"fused_topk kernel launch failed: CUDA error "
                           f"{err}")
    return out_v, out_i


def fused_score_topk(user_vecs, item_table, item_bias, k: int):
    """(top_vals f32 [B, k], top_ids i32 [B, k]): the exact top k of
    u.V^T + b, best first, the smaller id first among equal scores; the
    [B, I] scores are never written.

    user_vecs [B, D] and item_table [I, D] share a dtype (f32 or bf16);
    item_bias [I], [I, 1] (f32) or None. The dot accumulates in fp32.
    Limits of the kernel: 1 <= k <= min(I, 2048), and a block's shared
    memory (about 4*(128*D + 16*k) bytes) within 227 KB, which holds for
    every k <= 2048 at D <= 256; the wrapper raises beyond them. The TPU
    kernel's scheduling knobs (user_block, item_tile, interpret) fix no
    output and are dropped.
    """
    _check(user_vecs, item_table, item_bias)
    I = item_table.shape[0]
    if not 1 <= k <= min(I, _MAX_K):
        raise ValueError(f"k={k} must lie in [1, min(I={I}, {_MAX_K})]")
    if user_vecs.device.type == "cpu":
        return fused_topk_plain(user_vecs, item_table, item_bias, k)
    out = _launch(user_vecs, item_table, item_bias, k)
    fused_score_topk.launches += 1
    return out


fused_score_topk.launches = 0

