"""The NCF family: the MLP-CE recommender and the GMF + MLP hybrid.

Counterpart of `openrec_tpu/models/ncf.py`.

MLPRec (`:32-108`): logit = MLP([u || v]) + b_i, where the MLP's hidden
layers are relu and its output layer (one unit) has no bias; the task is
`bce_logits_loss` summed over the batch, plus `l2_weight` times the L2 of
the gathered rows.

NeuMF (`:112-214`): logit = alpha * h^T (u_ge * v_ge) + (1 - alpha) *
MLP([u_mlp || v_mlp]) + b_i over separate GE and MLP tables, h a bias-free
unit (`ge_h/0/w`); the L2 covers the gathered GE rows only.

Dropout after each hidden layer applies in `loss` when a generator is
given, and draws from it (the JAX package's per-step rng: the same keep
rate and 1/keep scaling, not its bits). `score` draws nothing; it scores
the full catalog in chunks of `item_chunk` items (the catalog padded to a
multiple of it, then sliced), since the MLP runs on every (user, item)
pair. NeuMF's GE half is a matmul, (u_ge * h).V_ge^T.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from openrec_tpu_torch.device import resolve_device
from openrec_tpu_torch.models.base import FactorRecommender, Recommender
from openrec_tpu_torch.modules.embedding import (embedding_init,
                                                 embedding_lookup)
from openrec_tpu_torch.modules.losses import bce_logits_loss, l2_half
from openrec_tpu_torch.modules.mlp import MLP


def _tower(in_dim, units, dropout, device, generator):
    """relu hidden layers, a linear output layer without bias."""
    return MLP(in_dim, list(units), activation="relu", out_activation=None,
               dropout_rate=dropout, out_bias=False, device=device,
               generator=generator)


def _pair_scores(mlp, user_vec, item, item_chunk):
    """mlp([u || v]) for every user row and every item, [B, I], in chunks
    of `item_chunk` items."""
    B, I = user_vec.shape[0], item.shape[0]
    n_chunks = -(-I // item_chunk)
    item = F.pad(item, (0, 0, 0, n_chunks * item_chunk - I))
    out = []
    for lo in range(0, n_chunks * item_chunk, item_chunk):
        v = item[lo:lo + item_chunk]
        x = torch.cat([user_vec[:, None, :].expand(B, item_chunk, -1),
                       v[None, :, :].expand(B, item_chunk, -1)], dim=2)
        out.append(mlp(x.reshape(B * item_chunk, -1)).reshape(B, item_chunk))
    return torch.cat(out, dim=1)[:, :I]


class MLPRec(FactorRecommender):
    def __init__(self, total_users: int, total_items: int,
                 dim_user_embed: int, dim_item_embed: int,
                 mlp_units: Sequence[int] = (64, 1),
                 dropout: Optional[float] = None, l2_weight: float = 0.0,
                 device=None, generator: torch.Generator | None = None):
        super().__init__(total_users, total_items, dim_user_embed,
                         dim_item_embed, device=device, generator=generator)
        self.l2_weight = l2_weight
        self.mlp = _tower(dim_user_embed + dim_item_embed, mlp_units,
                          dropout, resolve_device(device), generator)

    def loss(self, batch: dict, tables: dict | None = None,
             generator: torch.Generator | None = None):
        user_vec = self.lookup("user_embed", batch["user_id"], tables)
        item_vec = self.lookup("item_embed", batch["item_id"], tables)
        bias = self.lookup("item_bias", batch["item_id"], tables)
        x = torch.cat([user_vec, item_vec], dim=1)
        logit = (self.mlp(x, train=generator is not None,
                          generator=generator) + bias).reshape(-1)
        label = torch.as_tensor(batch["label"], device=logit.device)
        task = bce_logits_loss(label, logit, reduction="sum")
        l2 = l2_half(user_vec, item_vec)
        return task + self.l2_weight * l2, {"loss": task, "l2_loss": l2}

    def logit(self, user_id, item_id) -> torch.Tensor:
        """The training path's logit at (user_id, item_id) pairs, [B]."""
        x = torch.cat([self.lookup("user_embed", user_id),
                       self.lookup("item_embed", item_id)], dim=1)
        return (self.mlp(x) + self.lookup("item_bias", item_id)).reshape(-1)

    def score(self, batch: dict, item_chunk: int = 4096) -> torch.Tensor:
        user_vec = embedding_lookup(self.user_embed, batch["user_id"])
        return _pair_scores(self.mlp, user_vec, self.item_embed,
                            item_chunk) + self.item_bias.reshape(-1)


class NeuMF(Recommender):
    def __init__(self, total_users: int, total_items: int,
                 dim_ge_embed: int, dim_mlp_embed: int,
                 mlp_units: Sequence[int] = (64, 1), alpha: float = 0.5,
                 dropout: Optional[float] = None, l2_weight: float = 0.0,
                 device=None, generator: torch.Generator | None = None):
        super().__init__()
        dev = resolve_device(device)
        self.total_users, self.total_items = total_users, total_items
        self.alpha = alpha
        self.l2_weight = l2_weight
        for name, num, dim in (("user_ge", total_users, dim_ge_embed),
                               ("item_ge", total_items, dim_ge_embed),
                               ("user_mlp_embed", total_users, dim_mlp_embed),
                               ("item_mlp_embed", total_items,
                                dim_mlp_embed)):
            setattr(self, name, nn.Parameter(embedding_init(
                num, dim, generator=generator, device=dev)))
        self.item_bias = nn.Parameter(torch.zeros((total_items, 1),
                                                  device=dev))
        self.ge_h = MLP(dim_ge_embed, [1], use_bias=False, device=dev,
                        generator=generator)
        self.mlp = _tower(2 * dim_mlp_embed, mlp_units, dropout, dev,
                          generator)

    def _forward(self, user_id, item_id, generator=None, tables=None):
        """(logit [B], u_ge, v_ge) at (user_id, item_id) pairs."""
        u_ge = self.lookup("user_ge", user_id, tables)
        v_ge = self.lookup("item_ge", item_id, tables)
        x = torch.cat([self.lookup("user_mlp_embed", user_id, tables),
                       self.lookup("item_mlp_embed", item_id, tables)],
                      dim=1)
        mlp = self.mlp(x, train=generator is not None, generator=generator)
        logit = self.alpha * self.ge_h(u_ge * v_ge) \
            + (1 - self.alpha) * mlp \
            + self.lookup("item_bias", item_id, tables)
        return logit.reshape(-1), u_ge, v_ge

    def logit(self, user_id, item_id) -> torch.Tensor:
        """The training path's logit at (user_id, item_id) pairs, [B]."""
        return self._forward(user_id, item_id)[0]

    def loss(self, batch: dict, tables: dict | None = None,
             generator: torch.Generator | None = None):
        logit, u_ge, v_ge = self._forward(batch["user_id"], batch["item_id"],
                                          generator, tables)
        label = torch.as_tensor(batch["label"], device=logit.device)
        task = bce_logits_loss(label, logit, reduction="sum")
        l2 = l2_half(u_ge, v_ge)
        return task + self.l2_weight * l2, {"loss": task, "l2_loss": l2}

    def score(self, batch: dict, item_chunk: int = 4096) -> torch.Tensor:
        user_id = batch["user_id"]
        u_ge = embedding_lookup(self.user_ge, user_id)
        ge = (u_ge * self.ge_h[0].w[:, 0]) @ self.item_ge.T
        mlp = _pair_scores(self.mlp,
                           embedding_lookup(self.user_mlp_embed, user_id),
                           self.item_mlp_embed, item_chunk)
        return self.alpha * ge + (1 - self.alpha) * mlp \
            + self.item_bias.reshape(-1)
