"""Full-catalog ranking metrics on tensors.

Counterpart of `openrec_tpu/metrics/ranking.py`, with its tie conventions
(:11-18) kept exactly:

  AUC:   eval = not(pos or excl); per user
         sum_p |{e in eval : s_e <= s_p}| / (|pos|*|eval|)
  Recall/NDCG/Precision: s <- exp(s)*not(excl);
         rank_above(p) = |{j : s_j > s_p}| over ALL items (strict);
         Recall@k = |{p : rank_above(p) < k}| / |pos|
         NDCG@k   = sum_p 1/log2(rank_above(p)+2) * [rank_above(p) < k]
         (unnormalized DCG)
         Precision@k = |{p : rank_above(p) < k}| / k

and `MSE`, the per-record squared error of the regression eval
(`:136-138`).

Users are a batch dimension: one sort + one batched searchsorted per call.
"""

from __future__ import annotations

import math

import torch


def _at(at, device):
    return torch.as_tensor(at, dtype=torch.int32, device=device)


def _counts_gt(vals, queries):
    """#entries of each row of vals strictly greater than each query."""
    sorted_vals = torch.sort(vals, dim=1).values
    return vals.shape[1] - torch.searchsorted(sorted_vals, queries,
                                              right=True)


def AUC(pos_mask, pred, excl_mask):
    eval_mask = ~(pos_mask | excl_mask)
    num_pos = pos_mask.sum(dim=1)
    num_eval = eval_mask.sum(dim=1)
    # non-eval entries pushed to +inf so a right bisect of any finite
    # positive score never counts them
    eval_sorted = torch.sort(torch.where(eval_mask, pred, torch.inf),
                             dim=1).values
    counts = torch.searchsorted(eval_sorted, pred.contiguous(), right=True)
    total = torch.where(pos_mask, counts, 0).sum(dim=1)
    denom = (num_pos * num_eval).float()
    return torch.where(denom > 0, total.float() / denom.clamp(min=1), 0.0)


def _rank_above(pred, excl_mask):
    """rank_above per item under the reference's exp*mask transform."""
    p = torch.exp(pred) * (~excl_mask).to(pred.dtype)
    return _counts_gt(p, p)


def _hits(pos_mask, pred, excl_mask, at):
    ranks = _rank_above(pred, excl_mask)
    at_arr = _at(at, pred.device)
    return ranks, (ranks[:, None, :] < at_arr[None, :, None]) \
        & pos_mask[:, None, :]


def _recall(pos_mask, hits):
    num_pos = pos_mask.sum(dim=1).clamp(min=1)
    return hits.sum(dim=2).float() / num_pos[:, None]


def _ndcg(ranks, hits):
    log_recip = 1.0 / (torch.log(ranks.float() + 2.0) / math.log(2.0))
    return torch.where(hits, log_recip[:, None, :], 0.0).sum(dim=2)


def _precision(hits, at):
    return hits.sum(dim=2).float() / _at(at, hits.device).float()[None, :]


def Recall(pos_mask, pred, excl_mask, at=(100,)):
    _, hits = _hits(pos_mask, pred, excl_mask, at)
    return _recall(pos_mask, hits)


def NDCG(pos_mask, pred, excl_mask, at=(100,)):
    return _ndcg(*_hits(pos_mask, pred, excl_mask, at))


def Precision(pos_mask, pred, excl_mask, at=(100,)):
    _, hits = _hits(pos_mask, pred, excl_mask, at)
    return _precision(hits, at)


def ranking_metrics(pos_mask, pred, excl_mask, at=(100,)) -> dict:
    """{"AUC", "Recall", "NDCG", "Precision"}: the four functions above,
    with one rank pass (sort + searchsorted over [B, I]) shared by the
    three @k metrics instead of one each."""
    ranks, hits = _hits(pos_mask, pred, excl_mask, at)
    return {"AUC": AUC(pos_mask, pred, excl_mask),
            "Recall": _recall(pos_mask, hits), "NDCG": _ndcg(ranks, hits),
            "Precision": _precision(hits, at)}


def metrics_from_counts(ranks, leq_counts, valid_pos, num_eval, at):
    """Metric dict from per-positive sufficient statistics: `ranks`
    [B, P] (rank_above under exp*not(excl)), `leq_counts` [B, P] (#eval
    items with score <= the positive's), valid_pos [B, P] bool, num_eval
    [B], at: ints. Returns {"AUC": [B], "Recall"/"NDCG"/"Precision":
    [B, K]}."""
    ranks = ranks.to(torch.int32)
    at_arr = _at(at, ranks.device)
    num_pos = valid_pos.sum(dim=1)
    hits = (ranks[:, None, :] < at_arr[None, :, None]) & valid_pos[:, None, :]

    recall = hits.sum(dim=2).float() / num_pos.clamp(min=1)[:, None]
    precision = hits.sum(dim=2).float() / at_arr.float()[None, :]
    log_recip = 1.0 / (torch.log(ranks.float() + 2.0) / math.log(2.0))
    ndcg = torch.where(hits, log_recip[:, None, :], 0.0).sum(dim=2)

    total = torch.where(valid_pos, leq_counts, 0).sum(dim=1)
    denom = (num_pos * num_eval).float()
    auc = torch.where(denom > 0, total.float() / denom.clamp(min=1), 0.0)
    return {"AUC": auc, "Recall": recall, "NDCG": ndcg,
            "Precision": precision}


def ids_to_masks(pos_ids, excl_ids, total_items):
    """Scatter -1-padded id lists [B, P] into [B, I] boolean masks."""
    def scatter(ids):
        ids = torch.as_tensor(ids).long()
        mask = torch.zeros((ids.shape[0], total_items + 1), dtype=torch.bool,
                           device=ids.device)
        # pads (and ids out of range) land in the spare last column
        safe = torch.where((ids >= 0) & (ids < total_items), ids,
                           total_items)
        mask.scatter_(1, safe, True)
        return mask[:, :total_items]

    return scatter(pos_ids), scatter(excl_ids)


def MSE(pred, labels):
    """Per-example squared error (tf1 evaluators/mse.py:10-12)."""
    return (pred - labels) ** 2
