"""WRMF: weighted regularized matrix factorization (Hu et al. 2008).

Counterpart of `openrec_tpu/models/wrmf.py`: `pointwise_mse_loss` (the
weight outside the square) on u.v + b over pointwise samples, plus
`l2_weight` times the L2 of the gathered rows; serving u.V^T + b.
"""

from __future__ import annotations

import torch

from openrec_tpu_torch.models.base import FactorRecommender
from openrec_tpu_torch.modules.losses import l2_half, pointwise_mse_loss


class WRMF(FactorRecommender):
    loss_reduction = "sum"

    def __init__(self, total_users: int, total_items: int,
                 dim_user_embed: int, dim_item_embed: int, a: float = 1.0,
                 b: float = 1.0, sigmoid: bool = False,
                 l2_weight: float = 1.0, device=None,
                 generator: torch.Generator | None = None):
        super().__init__(total_users, total_items, dim_user_embed,
                         dim_item_embed, device=device, generator=generator)
        self.a, self.b = a, b
        self.sigmoid = sigmoid
        self.l2_weight = l2_weight

    def loss(self, batch: dict, tables: dict | None = None,
             generator: torch.Generator | None = None):
        user_vec = self.lookup("user_embed", batch["user_id"], tables)
        item_vec = self.lookup("item_embed", batch["item_id"], tables)
        item_bias = self.lookup("item_bias", batch["item_id"], tables)
        label = torch.as_tensor(batch["label"], device=user_vec.device)
        task = pointwise_mse_loss(user_vec, item_vec, item_bias, label,
                                  a=self.a, b=self.b, sigmoid=self.sigmoid)
        l2 = l2_half(user_vec, item_vec)
        return task + self.l2_weight * l2, {"loss": task, "l2_loss": l2}
