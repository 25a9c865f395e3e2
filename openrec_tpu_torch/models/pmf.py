"""PMF: probabilistic matrix factorization on pointwise labels.

Counterpart of `openrec_tpu/models/pmf.py`: parameters `user_embed`,
`item_embed` and `item_bias` [I, 1] (zeros); the loss is
1/2 * sum((w * (label - pred))^2) with the weight w = (a - b)*label + b
INSIDE the square (`pmf.py:53-54`, unlike WRMF's), pred = u.v + b or its
sigmoid, plus `l2_reg` times the L2 of the gathered rows. Embeddings are
drawn from a normal of stddev 0.01 truncated at two stddevs (`pmf.py:33-
39`), from a `torch.Generator`: the same law as JAX's draw, not its bits.
"""

from __future__ import annotations

import torch

from openrec_tpu_torch.device import resolve_device
from openrec_tpu_torch.models.base import FactorRecommender


def truncated_normal_init(num: int, dim: int, stddev: float = 0.01,
                          generator: torch.Generator | None = None,
                          device=None) -> torch.Tensor:
    """[num, dim] from N(0, stddev^2) truncated to +-2 stddev."""
    table = torch.empty((num, dim), device=resolve_device(device))
    return torch.nn.init.trunc_normal_(table, 0.0, stddev, -2.0 * stddev,
                                       2.0 * stddev, generator=generator)


class PMF(FactorRecommender):
    loss_reduction = "sum"

    def __init__(self, total_users: int, total_items: int,
                 dim_user_embed: int, dim_item_embed: int, a: float = 1.0,
                 b: float = 1.0, sigmoid: bool = False, l2_reg: float = 0.0,
                 device=None, generator: torch.Generator | None = None):
        super().__init__(total_users, total_items, dim_user_embed,
                         dim_item_embed, device=device, generator=generator,
                         init=truncated_normal_init)
        self.a, self.b = a, b
        self.sigmoid = sigmoid
        self.l2_reg = l2_reg

    def loss(self, batch: dict, tables: dict | None = None,
             generator: torch.Generator | None = None):
        user_vec = self.lookup("user_embed", batch["user_id"], tables)
        item_vec = self.lookup("item_embed", batch["item_id"], tables)
        item_bias = self.lookup("item_bias", batch["item_id"], tables)
        label = torch.as_tensor(batch["label"], device=user_vec.device)
        pred = torch.sum(user_vec * item_vec, dim=1) + item_bias.reshape(-1)
        if self.sigmoid:
            pred = torch.sigmoid(pred)
        weight = (self.a - self.b) * label + self.b
        task = 0.5 * torch.sum((weight * (label - pred)) ** 2)
        reg = self.l2_reg * (0.5 * torch.sum(user_vec ** 2)
                             + 0.5 * torch.sum(item_vec ** 2))
        return task + reg, {"loss": task, "l2_loss": reg}

    def score(self, batch: dict) -> torch.Tensor:
        scores = super().score(batch)
        return torch.sigmoid(scores) if self.sigmoid else scores
