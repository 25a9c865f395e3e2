"""Row-sharded embedding tables: lookup, scores and top-k retrieval.

Counterpart of `openrec_tpu/parallel/embedding.py`. Each rank holds a
[V/m, D] row shard of a table (m = the 'model' dim's size). Every JAX
`shard_map` body is split in two: a shard-local function on plain
tensors (`lookup_local`, `pallas_topk_local`, `merge_topk`), which one
process can also call for m shards in turn, and the collective that
joins the ranks (`collectives.py`). The full functions take this rank's shard and return
this rank's block of the JAX function's result.

  - `sharded_lookup`: masked gather + all_reduce over 'model'. An id
    outside the table gives a ZERO row (the JAX package's semantics),
    where `embedding_lookup` clips it to the nearest row. Its gradient
    is the local scatter-add of the masked gather.
  - `sharded_scores` / `sharded_topk`: this rank's [B, I/m] score block,
    per-shard top-k, all_gather of the k*m candidates, exact merge.
  - `sharded_pallas_topk`: each shard streams its rows through the
    bucket-max kernels K1 (`per_bucket=1`) or K2 (`per_bucket=2`)
    (`ops.bucket_score_topk`); the per-shard [B, I/m] scores never exist.

Every merge orders equal scores by candidate position, as `lax.top_k`
over the all_gathered candidates does: the lower shard first, then the
shard's own order (`ops.topk_ordered`).
"""

from __future__ import annotations

import torch

from openrec_tpu_torch.ops.bucketed_topk import bucket_score_topk
from openrec_tpu_torch.ops.ordered_topk import topk_ordered
from openrec_tpu_torch.ops.topk import dot_scores
from openrec_tpu_torch.parallel import collectives as col
from openrec_tpu_torch.parallel.mesh import (MODEL_AXIS, axis_group,
                                             axis_index, axis_size)
from openrec_tpu_torch.training.sparse import masked_gather


def pad_rows(num_rows: int, num_shards: int) -> int:
    """Rows padded up so the table splits evenly across shards."""
    return -(-num_rows // num_shards) * num_shards


# ------------------------------------------------------------ shard-local

def lookup_local(table_shard: torch.Tensor, ids, shard: int) -> torch.Tensor:
    """Shard `shard`'s part of a lookup: its rows of `ids`, zero rows for
    the ids it does not hold (mask after gather, as JAX's kernel)."""
    return masked_gather(table_shard, ids, shard * table_shard.shape[0])


def pallas_topk_local(user_vecs, table_shard, bias_shard, k: int,
                      shard: int, recall_target: float | None = None,
                      per_bucket: int = 1):
    """One shard's retrieval through K1 / K2 (`bucket_score_topk`): its
    top-k (score, global id), every pair exact."""
    vals, idx = bucket_score_topk(user_vecs, table_shard, bias_shard, k,
                                  recall_target=recall_target,
                                  per_bucket=per_bucket)
    return vals, idx + shard * table_shard.shape[0]


def merge_topk(vals: torch.Tensor, ids: torch.Tensor, k: int):
    """Exact top-k of the shards' candidates, concatenated in shard order
    along the last dim; equal scores by candidate position."""
    best_v, pos = topk_ordered(vals, k)
    return best_v, ids.gather(-1, pos)


# -------------------------------------------------------------- collective

def sharded_lookup(table_shard, ids, mesh, axis: str = MODEL_AXIS):
    """Rows `ids` ([B], the same on every rank of `axis`) of a table whose
    rows split over `axis`; differentiable into `table_shard`."""
    rows = lookup_local(table_shard, ids, axis_index(mesh, axis))
    return col.all_reduce(rows, axis_group(mesh, axis))


class ShardedTable:
    """A row-sharded table as a `Recommender.table` override: `lookup`
    is `sharded_lookup`, so the model's loss reaches the shard through
    `model.loss(batch, tables={name: view})`."""

    def __init__(self, shard: torch.Tensor, mesh, axis: str = MODEL_AXIS):
        self.shard = shard
        self.mesh = mesh
        self.axis = axis

    @property
    def shape(self):
        return (self.shard.shape[0] * axis_size(self.mesh, self.axis),
                *self.shard.shape[1:])

    @property
    def dtype(self):
        return self.shard.dtype

    def lookup(self, ids) -> torch.Tensor:
        return sharded_lookup(self.shard, ids, self.mesh, self.axis)

    @property
    def T(self):
        raise TypeError("full-table ops are not available on a row-sharded "
                        "table; use sharded_scores / sharded_topk")


def sharded_scores(user_vecs, table_shard, bias_shard, mesh,
                   axis: str = MODEL_AXIS) -> torch.Tensor:
    """This rank's [B, I/m] block of the full-catalog scores u.V^T + b
    (JAX returns them sharded P(..., axis)); nothing is gathered."""
    del mesh, axis
    return dot_scores(user_vecs, table_shard, bias_shard)


def sharded_topk(scores_block, k: int, mesh, axis: str = MODEL_AXIS,
                 approx: bool = False, recall_target: float = 0.99):
    """Top-k over an item-sharded score matrix: per-shard top-k,
    all_gather of the k*m candidates over `axis`, exact merge; the result
    is the same on every rank of `axis`. approx=True is the exact per-shard
    top-k (`lax.approx_max_k` has no PyTorch counterpart; exact meets any
    recall_target)."""
    del approx, recall_target
    vals, idx = topk_ordered(scores_block, k)
    idx = idx + axis_index(mesh, axis) * scores_block.shape[-1]
    group = axis_group(mesh, axis)
    return merge_topk(col.all_gather_last(vals, group),
                      col.all_gather_last(idx, group), k)


def sharded_pallas_topk(user_vecs, table_shard, bias_shard, k: int, mesh,
                        axis: str = MODEL_AXIS,
                        recall_target: float | None = None,
                        per_bucket: int = 1):
    """Fused retrieval over a row-sharded catalog: each rank runs K1
    (per_bucket=1) or K2 (per_bucket=2) over its [I/m, D] shard and keeps
    its top-k, the k*m candidates are all_gathered over `axis` and merged
    exactly. user_vecs [B, D], the same on every rank of `axis`; bias_shard
    [I/m] / [I/m, 1] or None. Returns ([B, k] scores, [B, k] global ids),
    every pair exact; recall follows the bucket-collision law per shard."""
    vals, idx = pallas_topk_local(user_vecs, table_shard, bias_shard, k,
                                  axis_index(mesh, axis),
                                  recall_target=recall_target,
                                  per_bucket=per_bucket)
    group = axis_group(mesh, axis)
    return merge_topk(col.all_gather_last(vals, group),
                      col.all_gather_last(idx, group), k)
