"""NBPR and WCML: pairwise models over K negatives per positive.

Counterpart of `openrec_tpu/models/nbpr.py`. Batches come from
`NPairwiseSampler`: user_id [B], p_item_id [B], n_item_id [B, K].

NBPR (`:20-51`) is BPR with the WARP-weighted log loss on the hardest of
the K negatives (`multi_neg_log_loss`), plus `l2_weight` times the L2 of
the gathered rows; it serves u.V^T + b. WCML (`:54-105`) takes the
rank-weighted hinge under euclidean scores (`multi_neg_eudist_loss`) and,
after every optimizer step, projects the batch's user rows and the item
rows concat(p, n.reshape(-1)) onto the unit ball in place (`post_step`;
duplicate ids are safe, as in UCML). WCML serves -||u - v||^2 + b in the
matmul form 2u.V^T - ||u||^2 - ||V||^2 + b.
"""

from __future__ import annotations

import torch

from openrec_tpu_torch.models.base import FactorRecommender
from openrec_tpu_torch.models.ucml import UCML
from openrec_tpu_torch.modules.embedding import censor_norm_
from openrec_tpu_torch.modules.losses import (l2_half, multi_neg_eudist_loss,
                                              multi_neg_log_loss)


class NBPR(FactorRecommender):
    loss_reduction = "sum"

    def __init__(self, total_users: int, total_items: int, dim_embed: int,
                 l2_weight: float = 0.0, device=None,
                 generator: torch.Generator | None = None):
        super().__init__(total_users, total_items, dim_embed, dim_embed,
                         device=device, generator=generator)
        self.l2_weight = l2_weight

    def _task(self, *args):
        return multi_neg_log_loss(*args, self.total_items)

    def loss(self, batch: dict, tables: dict | None = None,
             generator: torch.Generator | None = None):
        user_vec = self.lookup("user_embed", batch["user_id"], tables)
        p_vec = self.lookup("item_embed", batch["p_item_id"], tables)
        n_vecs = self.lookup("item_embed", batch["n_item_id"], tables)
        p_bias = self.lookup("item_bias", batch["p_item_id"], tables)
        n_biases = self.lookup("item_bias", batch["n_item_id"], tables)
        task = self._task(user_vec, p_vec, n_vecs, p_bias, n_biases)
        l2 = l2_half(user_vec, p_vec, n_vecs)
        return task + self.l2_weight * l2, {"loss": task, "l2_loss": l2}


class WCML(NBPR):
    def __init__(self, total_users: int, total_items: int, dim_embed: int,
                 margin: float = 0.5, l2_weight: float = 0.0, device=None,
                 generator: torch.Generator | None = None):
        super().__init__(total_users, total_items, dim_embed,
                         l2_weight=l2_weight, device=device,
                         generator=generator)
        self.margin = margin

    def _task(self, *args):
        return multi_neg_eudist_loss(*args, self.total_items,
                                     margin=self.margin)

    @torch.no_grad()
    def post_step(self, batch: dict, tables: dict | None = None) -> None:
        dev = self.item_embed.device
        censor_norm_(self.table("user_embed", tables), batch["user_id"])
        censor_norm_(self.table("item_embed", tables), torch.cat([
            torch.as_tensor(batch["p_item_id"], device=dev).reshape(-1),
            torch.as_tensor(batch["n_item_id"], device=dev).reshape(-1)]))

    # -||u - v||^2 + b in UCML's matmul form
    score = UCML.score
