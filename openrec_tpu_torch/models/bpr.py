"""BPR: Bayesian Personalized Ranking matrix factorization.

Counterpart of `openrec_tpu/models/bpr.py`: parameters `user_embed`
[U, D], `item_embed` [I, D] and `item_bias` [I, 1] (zeros), the pairwise
log loss on u.v + b plus `l2_weight` times the L2 of the gathered rows,
and full-catalog serving u.V^T + b.
"""

from __future__ import annotations

import torch
from torch import nn

from openrec_tpu_torch.device import resolve_device
from openrec_tpu_torch.models.base import Recommender
from openrec_tpu_torch.modules.embedding import (embedding_init,
                                                 embedding_lookup)
from openrec_tpu_torch.modules.losses import l2_half, pairwise_log_loss


class BPR(Recommender):
    def __init__(self, total_users: int, total_items: int,
                 dim_user_embed: int, dim_item_embed: int,
                 l2_weight: float = 1.0, device=None,
                 generator: torch.Generator | None = None):
        super().__init__()
        dev = resolve_device(device)
        self.total_users = total_users
        self.total_items = total_items
        self.l2_weight = l2_weight
        self.user_embed = nn.Parameter(embedding_init(
            total_users, dim_user_embed, generator=generator, device=dev))
        self.item_embed = nn.Parameter(embedding_init(
            total_items, dim_item_embed, generator=generator, device=dev))
        self.item_bias = nn.Parameter(
            torch.zeros((total_items, 1), device=dev))

    def loss(self, batch: dict):
        user_vec = embedding_lookup(self.user_embed, batch["user_id"])
        # One gather (and one backward scatter) for pos+neg instead of two.
        p_ids = torch.as_tensor(batch["p_item_id"], device=user_vec.device)
        n_ids = torch.as_tensor(batch["n_item_id"], device=user_vec.device)
        pn = torch.cat([p_ids, n_ids])
        vecs = embedding_lookup(self.item_embed, pn)
        biases = embedding_lookup(self.item_bias, pn)
        B = p_ids.shape[0]
        p_vec, n_vec = vecs[:B], vecs[B:]
        p_bias, n_bias = biases[:B], biases[B:]
        task = pairwise_log_loss(user_vec, p_vec, n_vec, p_bias, n_bias)
        l2 = l2_half(user_vec, p_vec, n_vec)
        return task + self.l2_weight * l2, {"loss": task, "l2_loss": l2}

    def score(self, batch: dict) -> torch.Tensor:
        user_vec = embedding_lookup(self.user_embed, batch["user_id"])
        return user_vec @ self.item_embed.T + self.item_bias.reshape(-1)
