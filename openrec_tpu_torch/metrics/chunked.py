"""Chunked full-catalog eval for giant catalogs on one device.

Counterpart of `openrec_tpu/metrics/chunked.py`: the same AUC / Recall@K /
NDCG@K / Precision@K as the dense path (metrics/ranking.py) while holding
only one [B, chunk] score block. A first loop over catalog chunks reads
the positives' scores; a second (the JAX package's `lax.scan`) accumulates per
positive how many items score strictly above it (transformed) and how
many eval items score <= it (raw), and `metrics_from_counts` finishes.
"""

from __future__ import annotations

import torch

from openrec_tpu_torch.metrics.ranking import metrics_from_counts


def _local_masks(ids, lo, width):
    """Scatter -1-padded id lists into [B, width] bools for ids in
    [lo, lo+width)."""
    local = ids - lo
    in_range = (ids >= 0) & (local >= 0) & (local < width)
    mask = torch.zeros((ids.shape[0], width + 1), dtype=torch.bool,
                       device=ids.device)
    mask.scatter_(1, torch.where(in_range, local, width), True)
    return mask[:, :width]


def chunked_dot_eval_metrics(user_vecs, table, bias, pos_ids, excl_ids,
                             total_items: int, chunk: int = 16384,
                             at=(100,)):
    """Metrics for scores u.V^T + b in O(B*chunk) memory.

    user_vecs [B, D]; table [I', D] with I' >= total_items (rows past
    total_items are ignored); bias [I'], [I', 1] or None; pos_ids /
    excl_ids [B, P] / [B, E] ints, -1-padded.
    """
    dev = user_vecs.device
    user_vecs = user_vecs.float()
    if bias is None:
        bias = torch.zeros(table.shape[0], device=dev)
    bias = bias.reshape(-1).float()
    pos_ids = torch.as_tensor(pos_ids, device=dev).long()
    excl_ids = torch.as_tensor(excl_ids, device=dev).long()

    valid_pos = pos_ids >= 0

    def chunks():
        for lo in range(0, total_items, chunk):
            hi = min(lo + chunk, total_items)
            yield lo, hi, (user_vecs @ table[lo:hi].float().T
                           + bias[lo:hi][None, :])

    # Positive scores are read out of the same [B, chunk] score blocks that
    # they are ranked against, so a positive compares equal to itself
    # whatever order a matmul sums in (a separate gather-and-dot may round
    # differently and let a positive outrank itself).
    s_pos = torch.zeros(pos_ids.shape, device=dev)
    for lo, hi, s in chunks():
        here = valid_pos & (pos_ids >= lo) & (pos_ids < hi)
        local = torch.where(here, pos_ids - lo, 0)
        s_pos = torch.where(here, s.gather(1, local), s_pos)
    # A positive that is also excluded has its transformed score zeroed by
    # the dense path's exp*not(excl): replicate with a membership test.
    pos_excl = ((pos_ids[:, :, None] == excl_ids[:, None, :])
                & (excl_ids[:, None, :] >= 0)).any(dim=-1)
    p_pos = torch.where(pos_excl, 0.0, torch.exp(s_pos))

    ranks = torch.zeros_like(pos_ids)
    leq = torch.zeros_like(pos_ids)
    num_eval = torch.zeros(user_vecs.shape[0], dtype=torch.long, device=dev)
    for lo, hi, s in chunks():
        pos_m = _local_masks(pos_ids, lo, hi - lo)
        excl_m = _local_masks(excl_ids, lo, hi - lo)
        # mask inside the exp: exp(-inf) = 0 exactly
        p = torch.exp(torch.where(excl_m, -torch.inf, s))
        p_sorted = torch.sort(p, dim=1).values
        ranks += (hi - lo) - torch.searchsorted(p_sorted, p_pos, right=True)
        eval_m = ~(pos_m | excl_m)
        s_eval = torch.sort(torch.where(eval_m, s, torch.inf), dim=1).values
        leq += torch.searchsorted(s_eval, s_pos, right=True)
        num_eval += eval_m.sum(dim=1)
    return metrics_from_counts(ranks, leq, valid_pos, num_eval, at)
