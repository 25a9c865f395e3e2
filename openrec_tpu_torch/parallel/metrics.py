"""Catalog-sharded full-catalog eval: per-shard rank counting + psum.

Counterpart of `openrec_tpu/parallel/metrics.py`. With the catalog (and
its table) row-sharded over 'model', no rank holds a whole [B, I] score
row. Each rank counts, for every positive of every user, how many of ITS
items outrank it; sums over 'model' give the exact global ranks, and
`metrics_from_counts` turns them into AUC / Recall@K / NDCG@K /
Precision@K with the dense path's semantics. Two all_reduces of [B, P]
scores (each positive's score lives on one shard) come first, then one
of the [B, P] counts and one of [B].

Inputs are EvaluationSampler(device_masks=True)'s -1-padded id lists. A
positive listed twice (a duplicated record) counts once, as it does in
the dense path's mask; the JAX package's counts it twice, which breaks
its own claim of the dense path's semantics.
"""

from __future__ import annotations

import torch

from openrec_tpu_torch.metrics.ranking import metrics_from_counts
from openrec_tpu_torch.ops.topk import dot_scores
from openrec_tpu_torch.parallel.collectives import all_reduce_sum
from openrec_tpu_torch.parallel.mesh import (MODEL_AXIS, axis_group,
                                             axis_index)


def _local_masks(ids, lo: int, width: int):
    """([B, width] mask of the ids in [lo, lo + width), in_range, local)."""
    local = ids.long() - lo
    in_range = (ids >= 0) & (local >= 0) & (local < width)
    safe = torch.where(in_range, local, width)       # width: cut-off column
    mask = torch.zeros((ids.shape[0], width + 1), dtype=torch.bool,
                       device=ids.device)
    mask.scatter_(1, safe, True)
    return mask[:, :width], in_range, torch.where(in_range, local, 0)


def _shard_counts(s, lo: int, total_items: int, pos_ids, excl_ids, group):
    """(ranks [B, P], leq [B, P], num_eval [B]), summed over `group`, from
    this shard's raw scores `s` [B, C] of catalog rows [lo, lo + C)."""
    C = s.shape[1]
    gid_ok = (lo + torch.arange(C, device=s.device)) < total_items
    pos_m, pos_in, pos_safe = _local_masks(pos_ids, lo, C)
    excl_m, _, _ = _local_masks(excl_ids, lo, C)
    excl_m = excl_m | ~gid_ok[None, :]
    # mask inside the exp (exp(-inf) = 0 exactly): excluded or padded rows
    # may hold any value, and exp(big) * 0 would be NaN
    p = torch.exp(torch.where(excl_m, -torch.inf, s))
    # each positive's score lives on one shard; masking and summing
    # routes it everywhere, its transform taken from p (a positive that is
    # also excluded keeps its zeroed transform, as on the dense path)
    s_pos, p_pos = all_reduce_sum(
        [s.gather(1, pos_safe) * pos_in, p.gather(1, pos_safe) * pos_in],
        group)
    gt = C - torch.searchsorted(torch.sort(p, dim=1).values,
                                p_pos.contiguous(), right=True)
    eval_m = ~(pos_m | excl_m)
    s_eval = torch.sort(torch.where(eval_m, s, torch.inf), dim=1).values
    le = torch.searchsorted(s_eval, s_pos.contiguous(), right=True)
    return all_reduce_sum([gt, le, eval_m.sum(dim=1)], group)


def _first_occurrences(ids):
    """ids with every repeat of an earlier entry of its row set to -1: a
    positive listed twice counts once, as in the dense path's mask."""
    P = ids.shape[1]
    earlier = torch.tril(torch.ones(P, P, dtype=torch.bool,
                                    device=ids.device), diagonal=-1)
    dup = ((ids[:, :, None] == ids[:, None, :]) & earlier).any(dim=2)
    return torch.where(dup, -1, ids)


def sharded_eval_metrics(scores_block, pos_ids, excl_ids, total_items: int,
                         mesh, axis: str = MODEL_AXIS, at=(100,)) -> dict:
    """Metrics over an item-sharded score matrix: `scores_block` is this
    rank's [B, I_padded/m] block (`sharded_scores`), pos_ids / excl_ids
    [B, P] / [B, E] -1-padded, the same on every rank of `axis`. Padded
    catalog rows (id >= total_items) are ignored. Returns {"AUC": [B],
    "Recall" / "NDCG" / "Precision": [B, K]}, the same on every rank."""
    pos_ids = _first_occurrences(torch.as_tensor(pos_ids,
                                                 device=scores_block.device))
    excl_ids = torch.as_tensor(excl_ids, device=scores_block.device)
    C = scores_block.shape[-1]
    ranks, leq, num_eval = _shard_counts(
        scores_block, axis_index(mesh, axis) * C, total_items, pos_ids,
        excl_ids, axis_group(mesh, axis))
    return metrics_from_counts(ranks, leq, pos_ids >= 0, num_eval, at)


def sharded_dot_eval_metrics(user_vecs, table_shard, bias_shard, pos_ids,
                             excl_ids, total_items: int, mesh,
                             axis: str = MODEL_AXIS, at=(100,)) -> dict:
    """Scoring + metrics for u.V^T + b models with a row-sharded catalog:
    each rank scores its [B, I/m] block and reduces it to O(B*P) counts;
    the full score row never exists. bias_shard [I/m] / [I/m, 1] or
    None."""
    return sharded_eval_metrics(
        dot_scores(user_vecs, table_shard, bias_shard), pos_ids, excl_ids,
        total_items, mesh, axis=axis, at=at)

