"""GMF: generalized matrix factorization (the NCF family).

Counterpart of `openrec_tpu/models/gmf.py`: logit = Dense_1(u * v) + b
with one bias-free linear unit (`mlp/0/w`, [D, 1], glorot-uniform),
`bce_logits_loss`, and `l2_weight` times the L2 of the gathered rows and
of the unit's weight. Serving uses the reduced form (u * w).V^T + b, a
[B, D] x [D, I] product instead of a [B, I, D] tensor.
"""

from __future__ import annotations

import torch

from openrec_tpu_torch.device import resolve_device
from openrec_tpu_torch.models.base import FactorRecommender
from openrec_tpu_torch.modules.embedding import embedding_lookup
from openrec_tpu_torch.modules.losses import bce_logits_loss, l2_half
from openrec_tpu_torch.modules.mlp import MLP


class GMF(FactorRecommender):
    def __init__(self, total_users: int, total_items: int,
                 dim_user_embed: int, dim_item_embed: int,
                 l2_weight: float = 1.0, device=None,
                 generator: torch.Generator | None = None):
        super().__init__(total_users, total_items, dim_user_embed,
                         dim_item_embed, device=device, generator=generator)
        self.l2_weight = l2_weight
        self.mlp = MLP(dim_item_embed, [1], use_bias=False,
                       device=resolve_device(device), generator=generator)

    def user_vecs(self, user_ids) -> torch.Tensor:
        """u * w: the user side of the serving product, w applied once."""
        return embedding_lookup(self.user_embed, user_ids) \
            * self.mlp[0].w[:, 0]

    def loss(self, batch: dict, tables: dict | None = None,
             generator: torch.Generator | None = None):
        user_vec = self.lookup("user_embed", batch["user_id"], tables)
        item_vec = self.lookup("item_embed", batch["item_id"], tables)
        item_bias = self.lookup("item_bias", batch["item_id"], tables)
        label = torch.as_tensor(batch["label"], device=user_vec.device)
        logit = (self.mlp(user_vec * item_vec) + item_bias).reshape(-1)
        task = bce_logits_loss(label, logit)
        l2 = l2_half(user_vec, item_vec) + self.mlp.l2()
        return task + self.l2_weight * l2, {"loss": task, "l2_loss": l2}

    def score(self, batch: dict) -> torch.Tensor:
        return self.user_vecs(batch["user_id"]) @ self.item_embed.T \
            + self.item_bias.reshape(-1)
