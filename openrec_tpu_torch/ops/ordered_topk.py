"""Top-k ordered as `lax.top_k` orders it: by score descending and, among
equal scores, by position ascending.

`torch.topk` leaves open the order of equal scores, and which of several
equal scores at the k-th place it keeps; `lax.top_k` keeps the lower
positions first, and orders floats totally (NaN above +inf, +0.0 above
-0.0). Without ties the two agree. `topk_ordered` takes one of two
routes by the row's length:
  - a row of at most `SHORT_ROW` entries (`bucket_score_topk`'s
    candidates, a small catalog) is sorted whole, stably and descending,
    by the float's order-preserving int32 (`order_key`), so that equal
    keys keep their positions' order: exact in every case, and it never
    asks the host;
  - a longer row (a whole large catalog, where the sort would cost more
    than the scores) takes `torch.topk`'s float path for k + 1,
    sorts the k by position and then stably by score (two sorts of
    [B, k], always), and asks the host once a call (`trace.host_sync`)
    whether a row ties across the k-th place, ties zeros (+0.0 against
    -0.0) or holds a NaN; only such rows, rare with float scores, are
    redone by the sort of the whole row.
"""

from __future__ import annotations

import torch

from openrec_tpu_torch import trace

# Rows up to this length are sorted whole (no host check).
SHORT_ROW = 1 << 15


def order_key(values: torch.Tensor) -> torch.Tensor:
    """float32 -> int32 with the same total order: a non-negative float's
    bits already order as integers; a negative one's lower 31 bits are
    flipped, so that a larger magnitude gives a smaller key."""
    bits = values.float().contiguous().view(torch.int32)
    return bits ^ ((bits >> 31) & 0x7FFFFFFF)


def _by_sort(x: torch.Tensor, k: int) -> torch.Tensor:
    """Positions of the k largest of each row of x, in `lax.top_k`'s
    order."""
    return torch.sort(order_key(x), dim=1, descending=True,
                      stable=True).indices[:, :k]


def topk_ordered(values: torch.Tensor, k: int):
    """(top values [..., k], their positions [..., k], int64) along the
    last dim of `values`, in `lax.top_k`'s order."""
    shape = values.shape
    x = values.reshape(-1, shape[-1])
    n = x.shape[1]
    if n <= SHORT_ROW:
        pos = _by_sort(x, k)
        vals = x.gather(1, pos)
        return vals.reshape(*shape[:-1], k), pos.reshape(*shape[:-1], k)
    vals, pos = torch.topk(x, min(k + 1, n), dim=1)
    tie = vals[:, 1:] >= vals[:, :-1]
    exact = torch.isnan(vals[:, 0]) | (tie & (vals[:, 1:] == 0)).any(dim=1)
    if k < n:
        exact = exact | tie[:, k - 1]
    vals, pos = vals[:, :k], pos[:, :k]
    by_pos, perm = torch.sort(pos, dim=1)
    vals, perm = torch.sort(vals.gather(1, perm), dim=1, descending=True,
                            stable=True)
    pos = by_pos.gather(1, perm)
    tied = exact.any()
    with trace.host_sync():
        tied = bool(tied)
    if tied:
        rows = exact.nonzero()[:, 0]
        pos = pos.index_copy(0, rows, _by_sort(x[rows], k))
        vals = x.gather(1, pos)
    return vals.reshape(*shape[:-1], k), pos.reshape(*shape[:-1], k)
