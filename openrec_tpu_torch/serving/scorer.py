"""Cached-embedding serving: full-catalog scores and top-k by dot product.

Counterpart of `openrec_tpu/serving/scorer.py` (the reference's
FastDotProductServer): for a model whose serving scores are u.v + b, cache
all user/item embeddings once, serve by matmul (plus top-k), and re-cache
after `mark_dirty()`. Extraction runs in batches, for models whose item
vectors come from feature networks over huge catalogs.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from openrec_tpu_torch.device import resolve_device
from openrec_tpu_torch.metrics.chunked import chunked_dot_eval_metrics
from openrec_tpu_torch.ops.bucketed_topk import bucket_score_topk
from openrec_tpu_torch.ops.topk import dot_scores

METHODS = ("exact", "approx", "pallas", "pallas2")


class CachedDotProductScorer:
    """Cache embeddings once; serve full-catalog scores / top-k.

    extract_user_vecs(params, user_ids) -> [B, D]
    extract_item_vecs(params, item_ids) -> [B, D]
    extract_item_bias(params, item_ids) -> [B] or [B, 1] (optional)

    `params` is whatever the extractors read, e.g. `model.params()` or a
    `convert.params_from_jax` dict.
    """

    def __init__(self, model, total_users: int, total_items: int,
                 extract_user_vecs: Callable,
                 extract_item_vecs: Callable,
                 extract_item_bias: Optional[Callable] = None,
                 extract_batch_size: int = 8192,
                 serve_dtype=torch.float32, device=None):
        """serve_dtype: dtype of the cached tables. Full-catalog scoring
        reads the whole item table per query batch, so `torch.bfloat16`
        halves its bytes; scores still accumulate in fp32 and the bias is
        added in fp32, so rankings differ from fp32 caches only at
        near-ties."""
        self.model = model
        self.total_users = total_users
        self.total_items = total_items
        self.device = resolve_device(device)
        self._extract_user = extract_user_vecs
        self._extract_item = extract_item_vecs
        self._extract_bias = extract_item_bias
        self._bs = extract_batch_size
        self._serve_dtype = serve_dtype
        self._dirty = True
        self._dirty32 = True
        self._U = self._V = self._b = None
        self._U32 = self._V32 = None

    def mark_dirty(self):
        """Call after any training that changes params."""
        self._dirty = True
        self._dirty32 = True

    @torch.no_grad()
    def _extract_all(self, extract, total, params):
        outs = [extract(params, torch.arange(lo, min(lo + self._bs, total),
                                             device=self.device))
                for lo in range(0, total, self._bs)]
        return outs[0] if len(outs) == 1 else torch.cat(outs, dim=0)

    def cache(self, params):
        dt = self._serve_dtype
        self._U = self._extract_all(self._extract_user, self.total_users,
                                    params).to(dt).contiguous()
        self._V = self._extract_all(self._extract_item, self.total_items,
                                    params).to(dt).contiguous()
        if self._extract_bias is not None:
            b = self._extract_all(self._extract_bias, self.total_items,
                                  params)
            self._b = b.reshape(-1).float().contiguous()
        else:
            self._b = torch.zeros(self.total_items, device=self.device)
        self._dirty = False

    def _rows(self, user_ids):
        ids = torch.as_tensor(user_ids, device=self.device).long()
        return self._U.index_select(0, ids)

    @torch.no_grad()
    def serve(self, params, user_ids):
        """Full-catalog scores [B, total_items], always fp32."""
        if self._dirty:
            self.cache(params)
        return dot_scores(self._rows(user_ids), self._V, self._b)

    @torch.no_grad()
    def topk(self, params, user_ids, k: int = 100, approx: bool = False,
             recall_target: float = 0.99, method: Optional[str] = None):
        """(scores, item_ids) of the top-k items per user.

        method: 'exact' (default; top-k of the fp32 scores), 'approx' (the
        JAX package's `lax.approx_max_k`; PyTorch has no counterpart, so it
        is the exact top-k, which meets any recall_target), 'pallas' (the
        fused bucket-max kernel, `ops/bucketed_topk.py`: the [B, I] scores
        are never written; every returned score/id is exact, expected
        recall >= recall_target) or 'pallas2' (top-2 per bucket: squared
        collision loss, the recall >= 0.995 route). The names are the JAX
        package's. `approx=True` is the older spelling of method='approx'.
        """
        if method is None:
            method = "approx" if approx else "exact"
        if method not in METHODS:
            raise ValueError(f"method must be one of {METHODS}, not "
                             f"{method!r}")
        if self._dirty:
            self.cache(params)
        rows = self._rows(user_ids)
        if method in ("pallas", "pallas2"):
            return bucket_score_topk(
                rows, self._V, self._b, k, recall_target=recall_target,
                per_bucket=2 if method == "pallas2" else 1)
        return torch.topk(dot_scores(rows, self._V, self._b), k, dim=1)

    @torch.no_grad()
    def eval_metrics(self, params, user_ids, pos_ids, excl_ids,
                     at=(50, 100), chunk: int = 16384):
        """AUC/Recall@K/NDCG@K/Precision@K in O(B*chunk) memory
        (metrics/chunked.py): the [B, total_items] score rows are never
        held whole. pos_ids/excl_ids are -1-padded id lists."""
        if self._dirty:
            self.cache(params)
        # Rank from FRESH fp32 extractions, not an upcast of the serve
        # caches: bf16 caches were already rounded, and eval must match
        # fp32 semantics exactly.
        if self._serve_dtype == torch.float32:
            U32, V32 = self._U, self._V
        else:
            if self._dirty32 or self._U32 is None:
                self._U32 = self._extract_all(
                    self._extract_user, self.total_users, params).float()
                self._V32 = self._extract_all(
                    self._extract_item, self.total_items, params).float()
                self._dirty32 = False
            U32, V32 = self._U32, self._V32
        ids = torch.as_tensor(user_ids, device=self.device).long()
        return chunked_dot_eval_metrics(
            U32.index_select(0, ids), V32, self._b, pos_ids, excl_ids,
            total_items=self.total_items, chunk=chunk, at=tuple(at))
