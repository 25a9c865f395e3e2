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
  - `ShardedTable`: a row-sharded table as a model's view of it, with
    its real row count (the table before `mesh.pad_to` appended zero
    rows): its lookups, censoring, whole-table modules (a batch norm
    over the real rows of every shard), serving rows and softmax.
  - `sharded_softmax_ce`: the softmax cross-entropy over a row-sharded
    output layer (a vocabulary-parallel softmax): each rank its [B, I/m]
    logit block, the row max and the sum of exponentials over 'model',
    the label's logit from the shard that holds it; pad rows enter no
    denominator.
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

from openrec_tpu_torch.modules import global_batch
from openrec_tpu_torch.ops.bucketed_topk import bucket_score_topk
from openrec_tpu_torch.ops.ordered_topk import topk_ordered
from openrec_tpu_torch.ops.topk import dot_scores
from openrec_tpu_torch.parallel import collectives as col
from openrec_tpu_torch.parallel.mesh import (MODEL_AXIS, axis_group,
                                             axis_index)
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
    """A row-sharded table as a `Recommender.table` override. The model
    reaches it through the functions of `modules/embedding.py` and
    `modules/losses.py`, each of which resolves the view's own method:
    `lookup` (`sharded_lookup`), `censor_norm_` (the ids that fall in
    this rank's rows [offset, offset + n)), `map_rows` / `update_rows_`
    (a module over the shard standing for the module over the whole
    table), `serving_rows` (the shard, its pad rows at a given value) and
    `softmax_ce` (`sharded_softmax_ce`). `rows` is the table's real row
    count, before `mesh.pad_to` appended zero rows; `shape` reports it."""

    def __init__(self, shard: torch.Tensor, mesh, rows: int,
                 axis: str = MODEL_AXIS):
        self.shard = shard
        self.mesh = mesh
        self.axis = axis
        self.offset = axis_index(mesh, axis) * shard.shape[0]
        self.rows = int(rows)

    @property
    def shape(self):
        return (self.rows, *self.shard.shape[1:])

    @property
    def dtype(self):
        return self.shard.dtype

    @property
    def device(self):
        return self.shard.device

    def lookup(self, ids) -> torch.Tensor:
        return sharded_lookup(self.shard, ids, self.mesh, self.axis)

    def real_rows(self) -> torch.Tensor:
        """[n] bool: which of this shard's rows are real (False at the pad
        rows past `rows`)."""
        return torch.arange(self.offset, self.offset + self.shard.shape[0],
                            device=self.shard.device) < self.rows

    def censor_norm_(self, ids, eps: float = 0.1) -> "ShardedTable":
        """`modules.embedding.censor_norm_` of the global `ids` that fall
        in this shard, IN PLACE; the others touch nothing (pad rows are
        no id). They are sent to local row 0 with row 0's own final
        value, so that every write to a row still agrees, and nothing
        waits on the host."""
        table = self.shard
        ids = torch.as_tensor(ids, device=table.device).long().reshape(-1)
        if ids.numel() == 0:
            return self
        local = ids - self.offset
        keep = (local >= 0) & (local < table.shape[0])
        at = torch.where(keep, local, 0)
        rows = table.index_select(0, at)
        norm = torch.linalg.vector_norm(rows, dim=-1, keepdim=True)
        new = rows / torch.clamp(norm, min=eps)
        hit0 = keep & (local == 0)
        row0 = torch.where(hit0.any(), new[torch.argmax(hit0.int())],
                           table[0])
        table.index_copy_(0, at, torch.where(keep[:, None], new,
                                             row0[None, :]))
        return self

    def map_rows(self, fn) -> torch.Tensor:
        """fn over this shard, standing for fn over the whole table: a
        batch norm inside takes the mean and variance of the whole
        table's real rows (summed over `axis`,
        `global_batch.sharded_rows`); no gradient."""
        group = axis_group(self.mesh, self.axis)
        with global_batch.sharded_rows(
                self.real_rows(), self.rows,
                lambda x: col.all_reduce_sum([x], group)[0]):
            return fn(self.shard)

    def update_rows_(self, flag: torch.Tensor, fn) -> "ShardedTable":
        """shard[flagged] <- map_rows(fn)[flagged] IN PLACE; `flag` [rows]
        is indexed by global row and kept whole (ItrMLP's flags)."""
        n = self.shard.shape[0]
        mark = flag.new_zeros(n)
        part = flag[self.offset:self.offset + n]
        mark[:part.shape[0]] = part
        self.shard.copy_(torch.where(mark[:, None] > 0, self.map_rows(fn),
                                     self.shard))
        return self

    def serving_rows(self, pad: float = 0.0) -> torch.Tensor:
        """This shard's rows to serve from, detached, its pad rows at
        `pad` (-1e30 for a bias: no pad row is ever served)."""
        rows = self.shard.detach()
        real = self.real_rows().reshape(-1, *[1] * (rows.dim() - 1))
        return torch.where(real, rows, pad)

    def softmax_ce(self, hidden, bias, labels):
        """The mean softmax cross-entropy of hidden . table^T + bias over
        the whole catalog (`sharded_softmax_ce`); `bias` the view of the
        bias sharded alike."""
        return sharded_softmax_ce(hidden, self.shard, bias.shard, labels,
                                  self.rows, self.mesh, self.axis)

    @property
    def T(self):
        raise TypeError("full-table ops are not available on a row-sharded "
                        "table; use sharded_scores / sharded_topk")


def sharded_softmax_ce(hidden, weight_shard, bias_shard, labels, rows: int,
                       mesh, axis: str = MODEL_AXIS):
    """Mean sparse softmax cross-entropy of logits hidden . W^T + b over a
    catalog of `rows` items whose rows split over `axis` (a vocabulary-
    parallel softmax), differentiable into hidden and both shards; equals
    `softmax_ce_loss` over the whole [B, rows] logits within rounding.

    Each rank computes its [B, n] logit block, its pad rows (global row >=
    rows) at -inf so that they add nothing to a denominator; the row max
    is taken over `axis` with no gradient (it cancels), the sum of
    exponentials and the label's logit (a masked gather on the shard that
    holds it) are summed over `axis`. hidden [B, H] the same on every rank
    of `axis`; weight_shard [n, H]; bias_shard [n] or [n, 1]; labels [B]."""
    group = axis_group(mesh, axis)
    n = weight_shard.shape[0]
    lo = axis_index(mesh, axis) * n
    h = col.replicated(hidden, group)
    logits = h @ weight_shard.T + bias_shard.reshape(-1)           # [B, n]
    real = torch.arange(lo, lo + n, device=logits.device) < rows
    logits = logits.masked_fill(~real, float("-inf"))
    top = col.all_max(torch.amax(logits.detach(), dim=1), group)   # [B]
    sumexp = col.all_reduce(torch.sum(torch.exp(logits - top[:, None]),
                                      dim=1), group)
    local = torch.as_tensor(labels, device=logits.device).long() - lo
    inside = (local >= 0) & (local < n)
    picked = logits.gather(1, torch.where(inside, local, 0)[:, None])[:, 0]
    label_logit = col.all_reduce(torch.where(inside, picked, 0.0), group)
    return torch.mean(torch.log(sumexp) + top - label_logit)


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
