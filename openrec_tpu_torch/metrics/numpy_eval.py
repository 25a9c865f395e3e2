"""Host-side (numpy) evaluators of the tf1 evaluator family.

Counterpart of `openrec_tpu/metrics/numpy_eval.py`, kept as the port's own
copy (the port imports nothing of the JAX package): the same functions on
the same numpy score rows give bit-equal results.
  full_rank     rank-above counts of each positive among the items that
                are neither positive nor excluded
  partial_rank  ranks against sampled negatives only
  auc           mean((N - rank) / N)
  ndcg          sum over hits ranked below `at` of 1/log2(rank + 2),
                normalised by the IDCG over ALL of the user's positives
  recall        |{rank <= at}| / |positives| (the reference's <=; the
                on-device metric in `metrics/ranking.py` uses <)
  precision     |{rank <= at}| / at
  mse           mean squared error
  EvalManager   the means over per-user score rows, in full mode or
                against `num_negatives` sampled negatives per user (a
                rejection loop on np.random.default_rng(seed))

They run on score rows pulled to the host (e.g. from `model.score`): the
CPU-side alternative to `metrics/ranking.py`'s on-device path, and the
home of the sampled-negative evaluation mode.
"""

from __future__ import annotations

import numpy as np


def full_rank(scores, pos_items, excl_items=()):
    """(rank_above, negative_num) for each positive item.

    scores: [num_items] float row for one user; pos_items: indices of the
    user's positives; excl_items: indices excluded from ranking (e.g.
    train positives — reference eval_manager.py:12-16).
    """
    scores = np.asarray(scores, dtype=np.float64)
    pos_items = np.asarray(pos_items, dtype=np.int64)
    mask = np.ones(len(scores), dtype=bool)
    if len(excl_items):
        mask[np.asarray(excl_items, dtype=np.int64)] = False
    mask[pos_items] = False          # negatives = not pos, not excluded
    neg_scores = scores[mask]
    pos_scores = scores[pos_items]
    rank_above = (neg_scores[None, :] > pos_scores[:, None]).sum(axis=1)
    return rank_above.astype(np.float64), float(len(neg_scores))


def partial_rank(pos_scores, neg_scores):
    """Ranks vs sampled negatives (reference eval_manager.py:27-38)."""
    pos_scores = np.asarray(pos_scores, dtype=np.float64)
    neg_scores = np.asarray(neg_scores, dtype=np.float64)
    rank_above = (neg_scores[None, :] > pos_scores[:, None]).sum(axis=1)
    return rank_above.astype(np.float64), float(len(neg_scores))


def auc(rank_above, negative_num):
    """mean((N - rank)/N) (reference auc.py:10-13)."""
    return float(np.mean((negative_num - rank_above) / negative_num))


def ndcg(rank_above, negative_num, at=100):
    """Σ_{r<at} 1/log2(r+2), normalized by Σ_i 1/log2(i+2) over ALL of the
    user's positives (exactly reference ndcg.py:13-26)."""
    ranks = np.asarray(rank_above)
    denom = float((1.0 / np.log2(np.arange(len(ranks)) + 2)).sum()) \
        if len(ranks) else 1.0
    hits = ranks[ranks < at]
    dcg = float((1.0 / np.log2(hits + 2)).sum())
    return dcg / denom if denom > 0 else 0.0


def recall(rank_above, negative_num, at=100):
    """|{r ≤ at}| / |pos| — note the reference's ≤ (recall.py:12-19; the
    tf2 on-device metric uses <, metrics/ranking.py keeps that)."""
    ranks = np.asarray(rank_above)
    return float((ranks <= at).sum() / max(len(ranks), 1))


def precision(rank_above, negative_num, at=100):
    ranks = np.asarray(rank_above)
    return float((ranks <= at).sum() / at)


def mse(pred, labels):
    pred = np.asarray(pred, dtype=np.float64)
    labels = np.asarray(labels, dtype=np.float64)
    return float(np.mean((pred - labels) ** 2))


class EvalManager:
    """Aggregate the numpy metrics over per-user score rows.

    evaluate(score_fn, store, excl_stores=(), at=(...), num_negatives=None):
      full mode ranks positives against all non-excluded items; sampled
      mode (num_negatives) against that many sampled negatives per user
      (parity: legacy implicit_model_trainer.py:131-175).
    """

    def __init__(self, at=(50, 100), seed=0):
        self.at = tuple(at)
        self.rng = np.random.default_rng(seed)

    def evaluate(self, score_fn, store, excl_stores=(), num_negatives=None,
                 user_batch=256):
        users = store.warm_users()
        results = {"AUC": [], **{f"Recall@{k}": [] for k in self.at},
                   **{f"NDCG@{k}": [] for k in self.at},
                   **{f"Precision@{k}": [] for k in self.at}}
        for lo in range(0, len(users), user_batch):
            chunk = users[lo:lo + user_batch]
            rows = np.asarray(score_fn(chunk))
            for row, u in zip(rows, chunk):
                pos = store.get_positive_items(u)
                excl = np.concatenate(
                    [ex.get_positive_items(u) for ex in excl_stores]
                ) if excl_stores else ()
                if num_negatives is None:
                    ranks, n_neg = full_rank(row, pos, excl)
                else:
                    banned = set(pos.tolist())
                    for ex in excl_stores:
                        banned |= set(ex.get_positive_items(u).tolist())
                    negs = []
                    while len(negs) < num_negatives:
                        c = int(self.rng.integers(0, store.total_items()))
                        if c not in banned:
                            negs.append(c)
                    ranks, n_neg = partial_rank(row[pos], row[negs])
                results["AUC"].append(auc(ranks, n_neg))
                for k in self.at:
                    results[f"Recall@{k}"].append(recall(ranks, n_neg, k))
                    results[f"NDCG@{k}"].append(ndcg(ranks, n_neg, k))
                    results[f"Precision@{k}"].append(
                        precision(ranks, n_neg, k))
        return {key: float(np.mean(vals)) for key, vals in results.items()}
