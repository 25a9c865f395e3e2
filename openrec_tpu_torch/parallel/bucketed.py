"""Bucketed id exchange for row-sharded embedding tables.

Counterpart of `openrec_tpu/parallel/bucketed.py`. `sharded_lookup`
makes every shard gather all B ids (masked) and moves a [B, D] sum
through the group. Here the HOST buckets each batch's ids by owning shard
first (`bucket_ids`, numpy, bit-identical to the JAX package's), so each
shard gathers only the ids it owns and one collective moves the already
gathered rows:

- `gathered_lookup`: ids the same on every rank of 'model' (split over
  'data'): per-shard bucket gather, all_gather over 'model', local
  unpermute. Its gradient: the all_gather's reduce-scatter, then the
  gather's scatter-add.
- `alltoall_lookup`: ids split over BOTH dims (each rank feeds its own
  B/(d*m) slice): ids route to their owners and rows route back with two
  all_to_alls of [m*C] ids / [m*C, D] rows; the rows' all_to_all is its
  own transpose.

Both take the full host arrays from `bucket_batch` / `bucket_batch_2d`
and return this rank's block of the JAX function's result.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from openrec_tpu_torch.parallel import collectives as col
from openrec_tpu_torch.parallel.mesh import (DATA_AXIS, MODEL_AXIS,
                                             axis_group, axis_index,
                                             axis_size)


def default_capacity(local_batch: int, num_shards: int, slack: float = 2.0
                     ) -> int:
    """Static per-bucket capacity: B/m ids per shard expected, times slack,
    rounded up to a multiple of 8. Constant across steps."""
    c = int(np.ceil(local_batch / num_shards * slack))
    return max(8, -(-c // 8) * 8)


def bucket_ids(ids: np.ndarray, num_shards: int, rows_per_shard: int,
               capacity: Optional[int] = None):
    """Bucket a flat id vector by owning shard (host side).

    ids: [B] int. Returns (buckets [num_shards, C] int32, inv [B] int32):
    buckets[s, j] is the j-th id owned by shard s (pad slots repeat the
    shard's base row, a valid local gather no inv entry references) and
    inv[k] is the flat index into the row-major [num_shards*C] gathered
    rows holding ids[k]'s row. Raises ValueError on bucket overflow."""
    ids = np.asarray(ids)
    b = ids.shape[0]
    if capacity is None:
        capacity = default_capacity(b, num_shards)
    shard = ids // rows_per_shard
    order = np.argsort(shard, kind="stable")          # group by shard
    sorted_shard = shard[order]
    counts = np.bincount(sorted_shard, minlength=num_shards)
    if counts.max(initial=0) > capacity:
        raise ValueError(
            f"bucket overflow: max {counts.max()} ids on one shard > "
            f"capacity {capacity}; pass a larger capacity")
    starts = np.zeros(num_shards, dtype=np.int64)
    np.cumsum(counts[:-1], out=starts[1:])
    pos_in_bucket = np.arange(b, dtype=np.int64) - starts[sorted_shard]
    buckets = np.repeat(
        (np.arange(num_shards, dtype=np.int64) * rows_per_shard)[:, None],
        capacity, axis=1)                              # pad = shard base row
    buckets[sorted_shard, pos_in_bucket] = ids[order]
    inv = np.empty(b, dtype=np.int64)
    inv[order] = sorted_shard * capacity + pos_in_bucket
    return buckets.astype(np.int32), inv.astype(np.int32)


def bucket_batch(ids: np.ndarray, num_shards: int, rows_per_shard: int,
                 data_shards: int = 1, capacity: Optional[int] = None):
    """Bucket a global batch whose leading dim splits over 'data': each
    of the `data_shards` contiguous slices is bucketed on its own.
    Returns (buckets [d, num_shards, C], inv [d, B/d])."""
    ids = np.asarray(ids)
    b = ids.shape[0]
    assert b % data_shards == 0, (b, data_shards)
    local = b // data_shards
    if capacity is None:
        capacity = default_capacity(local, num_shards)
    buckets, invs = zip(*(bucket_ids(ids[i * local:(i + 1) * local],
                                     num_shards, rows_per_shard, capacity)
                          for i in range(data_shards)))
    return np.stack(buckets), np.stack(invs)


def bucket_batch_2d(ids: np.ndarray, num_shards: int, rows_per_shard: int,
                    data_shards: int, capacity: Optional[int] = None):
    """Bucket a global batch for `alltoall_lookup`: it splits over 'data'
    (major) then 'model' (minor). Returns (buckets [d, m, m, C],
    inv [d, m, B_dev])."""
    ids = np.asarray(ids)
    b = ids.shape[0]
    n_dev = data_shards * num_shards
    assert b % n_dev == 0, (b, n_dev)
    per_dev = b // n_dev
    if capacity is None:
        capacity = default_capacity(per_dev, num_shards)
    ids_dev = ids.reshape(data_shards, num_shards, per_dev)
    buckets = np.empty((data_shards, num_shards, num_shards, capacity),
                       dtype=np.int32)
    inv = np.empty((data_shards, num_shards, per_dev), dtype=np.int32)
    for i in range(data_shards):
        for j in range(num_shards):
            buckets[i, j], inv[i, j] = bucket_ids(
                ids_dev[i, j], num_shards, rows_per_shard, capacity)
    return buckets, inv


def _on(x, like: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(np.asarray(x), device=like.device).long()


def gathered_lookup(table_shard, buckets, inv, mesh, axis: str = MODEL_AXIS,
                    data_axis: str = DATA_AXIS) -> torch.Tensor:
    """Lookup with host-bucketed ids and one all_gather of gathered rows.

    table_shard: this rank's [V/m, D] rows; buckets [d, m, C] and inv
    [d, B_local] from `bucket_batch`. Returns this rank's data block
    [B_local, D] of the rows, in the original id order (JAX: the whole
    [d*B_local, D], split P(data_axis))."""
    i, j = axis_index(mesh, data_axis), axis_index(mesh, axis)
    lo = j * table_shard.shape[0]
    mine = _on(buckets, table_shard)[i, j]                       # [C]
    rows = table_shard.index_select(0, mine - lo)                # [C, D]
    allrows = col.all_gather(rows, axis_group(mesh, axis))       # [m*C, D]
    return allrows.index_select(0, _on(inv, table_shard)[i])


def alltoall_lookup(table_shard, buckets, inv, mesh, axis: str = MODEL_AXIS,
                    data_axis: str = DATA_AXIS) -> torch.Tensor:
    """Lookup when the id stream splits over both dims: each rank's send
    buckets [m, C] (`bucket_batch_2d`: buckets [d, m, m, C], inv
    [d, m, B_dev]) route to their owners, which gather and send the rows
    back. Returns this rank's [B_dev, D] (JAX: [d, m, B_dev, D], split
    over both dims)."""
    i, j = axis_index(mesh, data_axis), axis_index(mesh, axis)
    m = axis_size(mesh, axis)
    group = axis_group(mesh, axis)
    send = _on(buckets, table_shard)[i, j]                       # [m, C]
    C = send.shape[1]
    recv = col.all_to_all(send.reshape(-1), group)               # [m*C]
    lo = j * table_shard.shape[0]
    rows = table_shard.index_select(0, recv - lo)                # [m*C, D]
    back = col.all_to_all(rows, group)                           # [m*C, D]
    assert back.shape[0] == m * C
    return back.index_select(0, _on(inv, table_shard)[i, j])
