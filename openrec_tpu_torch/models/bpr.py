"""BPR: Bayesian Personalized Ranking matrix factorization.

Counterpart of `openrec_tpu/models/bpr.py`: parameters `user_embed`
[U, D], `item_embed` [I, D] and `item_bias` [I, 1] (zeros), the pairwise
log loss on u.v + b plus `l2_weight` times the L2 of the gathered rows,
and full-catalog serving u.V^T + b.
"""

from __future__ import annotations

import torch

from openrec_tpu_torch.models.base import FactorRecommender
from openrec_tpu_torch.modules.losses import l2_half, pairwise_log_loss


class BPR(FactorRecommender):
    def __init__(self, total_users: int, total_items: int,
                 dim_user_embed: int, dim_item_embed: int,
                 l2_weight: float = 1.0, device=None,
                 generator: torch.Generator | None = None):
        super().__init__(total_users, total_items, dim_user_embed,
                         dim_item_embed, device=device, generator=generator)
        self.l2_weight = l2_weight

    def loss(self, batch: dict, tables: dict | None = None,
             generator: torch.Generator | None = None):
        user_vec = self.lookup("user_embed", batch["user_id"], tables)
        # One gather (and one backward scatter) for pos+neg instead of two.
        p_ids = torch.as_tensor(batch["p_item_id"], device=user_vec.device)
        n_ids = torch.as_tensor(batch["n_item_id"], device=user_vec.device)
        pn = torch.cat([p_ids, n_ids])
        vecs = self.lookup("item_embed", pn, tables)
        biases = self.lookup("item_bias", pn, tables)
        B = p_ids.shape[0]
        p_vec, n_vec = vecs[:B], vecs[B:]
        p_bias, n_bias = biases[:B], biases[B:]
        task = pairwise_log_loss(user_vec, p_vec, n_vec, p_bias, n_bias)
        l2 = l2_half(user_vec, p_vec, n_vec)
        return task + self.l2_weight * l2, {"loss": task, "l2_loss": l2}
