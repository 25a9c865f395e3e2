"""Fused score + strided bucket-max top-k: the CUDA kernels and their
plain PyTorch versions.

Counterpart of `openrec_tpu/ops/bucketed_topk.py`. `bucket_max_scores`
(K1) and `bucket_max2_scores` (K2) return, per strided bucket of items,
the top-1 (or top-2) (score, item id) of u.V^T + b without writing the
[B, I] scores: item t belongs to bucket `(t // (128*bucket))*128 + t % 128`.
`bucket_score_topk` (the counterpart of `pallas_score_topk`) finishes with
an exact top-k over the [B, L] maxima: every returned (score, id) pair is
exact, and a true top-k item is missed only when two (K2: three) of them
share a bucket.

On a CUDA tensor each wrapper launches its kernel (`csrc/bucket_max.cu`,
built at first use) and counts the launch in its `launches` attribute; on
a CPU tensor it runs the plain version (`bucket_max_plain`), which the
tests hold against the JAX package and `chip_smoke.py` holds against the
kernel on the card.

Geometry is the JAX package's (`_bucket_call_setup`, :211-256): the
`_MAX_VBLOCK_BYTES` shrink rule is a TPU VMEM budget, but it changes
`bucket` and so the output, and is kept. The TPU-only scheduling knobs
(`item_tile`, `user_block`, `interpret`, `reduction`) fix no output and
are dropped.
"""

from __future__ import annotations

import ctypes
import math

import torch

_LANES = 128                     # bucket stride of the strided layout
_MAX_VBLOCK_BYTES = 6 << 20      # the JAX package's per-block table budget
_MAX_DIM = 384                   # the kernel's shared-memory tiles: 2*D*68*4 B
_BLOCK_USERS, _HALVES = 64, 2    # a kernel block: 64 users x 64 of 128 lanes
_PAD_SCORE = -1e30


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

def _kernel_fn():
    from openrec_tpu_torch.ops import _build
    fn = _build.load("bucket_max").openrec_bucket_max
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, p, p, i, i, i, i, i, i, i, i,
                       p, p, p, p, p, p, p, p, p]
        fn.restype = ctypes.c_int
    return fn


def _n_split(blocks: int, bucket: int, sm_count: int) -> int:
    """Split the members of each bucket across blocks until the grid fills
    the card once (a second pass merges the splits)."""
    n = 1
    while blocks * n < sm_count and n * 2 <= bucket:
        n *= 2
    return n


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
    blocks = (L // _LANES) * _HALVES * (-(-B // _BLOCK_USERS))
    n_split = _n_split(blocks, bucket,
                       torch.cuda.get_device_properties(dev)
                       .multi_processor_count)
    parts = [torch.empty((n_split, B, L), device=dev, dtype=o.dtype)
             for o in outs] if n_split > 1 else []

    def ptrs(tensors):            # unused outputs are passed as null
        return [t.data_ptr() for t in tensors] + [None] * (4 - len(tensors))

    with torch.cuda.device(dev):
        err = _kernel_fn()(
            user_vecs.data_ptr(), item_table.data_ptr(),
            None if item_bias is None else item_bias.data_ptr(),
            int(user_vecs.dtype == torch.bfloat16), int(top2),
            B, I, D, bucket, n_split, L, *ptrs(outs), *ptrs(parts),
            torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"bucket_max kernel launch failed: CUDA error "
                           f"{err}")
    return tuple(outs)


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
    bucket_max_scores.launches += 1
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
    bucket_max2_scores.launches += 1
    return out


bucket_max_scores.launches = 0
bucket_max2_scores.launches = 0


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
    I = item_table.shape[0]
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
    if per_bucket == 2:
        v1, i1, v2, i2 = bucket_max2_scores(user_vecs, item_table,
                                            item_bias, bucket=bucket)
        vals = torch.cat([v1, v2], dim=1)
        ids = torch.cat([i1, i2], dim=1)
    else:
        vals, ids = bucket_max_scores(user_vecs, item_table, item_bias,
                                      bucket=bucket)
    top_vals, pos = torch.topk(vals, k, dim=1)
    return top_vals, ids.gather(1, pos)
