"""UCML / CML: collaborative metric learning.

Counterpart of `openrec_tpu/models/ucml.py`: the hinge on negative squared
euclidean distances plus bias (`pairwise_eudist_hinge_loss`, one lookup
for the positives and negatives together), `l2_weight` times the L2 of
the gathered rows, and after every optimizer step `post_step`, which
projects the batch's user rows and its positive and negative item rows
onto the unit ball in place (`censor_norm_`; a row-sharded table's view
censors the ids in its shard). Serving scores
-||u - v||^2 + b in the matmul form 2u.V^T - ||u||^2 - ||V||^2 + b, so
ranks agree with the JAX package's up to summation order.
"""

from __future__ import annotations

import torch

from openrec_tpu_torch.models.base import FactorRecommender
from openrec_tpu_torch.modules.embedding import censor_norm_, embedding_lookup
from openrec_tpu_torch.modules.losses import (l2_half,
                                              pairwise_eudist_hinge_loss)


class UCML(FactorRecommender):
    loss_reduction = "sum"

    def __init__(self, total_users: int, total_items: int,
                 dim_user_embed: int, dim_item_embed: int,
                 margin: float = 0.5, l2_weight: float = 1.0, device=None,
                 generator: torch.Generator | None = None):
        super().__init__(total_users, total_items, dim_user_embed,
                         dim_item_embed, device=device, generator=generator)
        self.margin = margin
        self.l2_weight = l2_weight

    def _item_ids(self, batch: dict) -> torch.Tensor:
        dev = self.item_embed.device
        return torch.cat([torch.as_tensor(batch["p_item_id"], device=dev),
                          torch.as_tensor(batch["n_item_id"], device=dev)])

    def loss(self, batch: dict, tables: dict | None = None,
             generator: torch.Generator | None = None):
        user_vec = self.lookup("user_embed", batch["user_id"], tables)
        pn = self._item_ids(batch)
        vecs = self.lookup("item_embed", pn, tables)
        biases = self.lookup("item_bias", pn, tables)
        B = pn.shape[0] // 2
        p_vec, n_vec = vecs[:B], vecs[B:]
        p_bias, n_bias = biases[:B], biases[B:]
        task = pairwise_eudist_hinge_loss(user_vec, p_vec, n_vec, p_bias,
                                          n_bias, self.margin)
        l2 = l2_half(user_vec, p_vec, n_vec)
        return task + self.l2_weight * l2, {"loss": task, "l2_loss": l2}

    @torch.no_grad()
    def post_step(self, batch: dict, tables: dict | None = None) -> None:
        censor_norm_(self.table("user_embed", tables), batch["user_id"])
        censor_norm_(self.table("item_embed", tables), self._item_ids(batch))

    def score(self, batch: dict) -> torch.Tensor:
        user_vec = embedding_lookup(self.user_embed, batch["user_id"])
        item = self.item_embed
        sq_u = torch.sum(user_vec ** 2, dim=1, keepdim=True)
        sq_v = torch.sum(item ** 2, dim=1)
        scores = 2.0 * (user_vec @ item.T) - sq_u - sq_v[None, :]
        return scores + self.item_bias.reshape(-1)


# CML is the legacy name of the same model (legacy recommenders/cml.py).
CML = UCML
