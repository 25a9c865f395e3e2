"""User-feature recommenders: PMF whose user vector adds an MLP over the
user's feature row.

Counterpart of `openrec_tpu/models/user_feature.py`:
  UserPMF        (`:25-84`) user vector user_embed + MLP(user features)
                 (the legacy Average of weight 2, a sum), dropout after
                 the MLP's hidden layers; PMF's truncated-normal tables
                 and weighted MSE (w = (a - b)*label + b inside the
                 square, optional sigmoid).
  UserVisualPMF  (`:87-134`) the same, with the item vector item_embed +
                 MLP(item features) under `item_mlp`. That MLP is built
                 with the dropout rate but applied without `train`
                 (`:107-110`), so it never drops; kept so.

Feature matrices are float32 non-persistent buffers (`user_features`,
`item_features`), as in `models/visual.py`: int32 categories (Amazon-
book's `user_features_categories.npy`) become float32 there, as JAX's
`f @ w` promotes them. Rows joined into a batch (`user_feature`,
`item_vfeature`) replace the gathered ones and are cast likewise.
Dropout draws from the generator `loss` is given, never without one.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch

from openrec_tpu_torch.device import resolve_device
from openrec_tpu_torch.models.base import FactorRecommender
from openrec_tpu_torch.models.pmf import truncated_normal_init
from openrec_tpu_torch.models.visual import (feature_buffer, feature_rows,
                                              pmf_task)
from openrec_tpu_torch.modules.losses import l2_half
from openrec_tpu_torch.modules.mlp import MLP


class UserPMF(FactorRecommender):
    loss_reduction = "sum"

    def __init__(self, total_users: int, total_items: int, dim_embed: int,
                 user_features=None, mlp_units: Sequence[int] = (),
                 a: float = 1.0, b: float = 1.0, sigmoid: bool = True,
                 dropout: Optional[float] = None, l2_weight: float = 0.0,
                 device=None, generator: torch.Generator | None = None):
        super().__init__(total_users, total_items, dim_embed, dim_embed,
                         device=device, generator=generator,
                         init=truncated_normal_init)
        dev = resolve_device(device)
        self.register_buffer("user_features",
                             feature_buffer(user_features, dev),
                             persistent=False)
        self.user_mlp = MLP(self.user_features.shape[1],
                            list(mlp_units) + [dim_embed], activation="relu",
                            out_activation=None, dropout_rate=dropout,
                            device=dev, generator=generator)
        self.a, self.b = a, b
        self.sigmoid = sigmoid
        self.dropout = dropout
        self.l2_weight = l2_weight

    def user_vecs(self, user_ids, features=None, generator=None,
                  tables=None) -> torch.Tensor:
        """user_embed + MLP(user features) at `user_ids`; dropout only
        with a generator. Without one, the serving side."""
        emb = self.lookup("user_embed", user_ids, tables)
        f = feature_rows(self.user_features, user_ids, features)
        proj = self.user_mlp(f, train=generator is not None,
                             generator=generator)
        return emb + proj

    def item_vecs(self, item_ids=None, tables=None) -> torch.Tensor:
        """The item vectors at `item_ids` (default: the whole catalog)."""
        if item_ids is None:
            return self.item_embed
        return self.lookup("item_embed", item_ids, tables)

    def loss(self, batch: dict, tables: dict | None = None,
             generator: torch.Generator | None = None):
        return self._pmf_loss(self.user_vecs(batch["user_id"],
                                       batch.get("user_feature"), generator,
                                       tables),
                        self.item_vecs(batch["item_id"], tables=tables),
                        batch, tables)

    def _pmf_loss(self, user_vec, item_vec, batch: dict,
                  tables: dict | None):
        """PMF's weighted MSE and L2 of the batch's user and item vectors:
        the loss and its aux."""
        bias = self.lookup("item_bias", batch["item_id"], tables)
        task = pmf_task(user_vec, item_vec, bias, batch["label"], self.a,
                        self.b, self.sigmoid)
        l2 = l2_half(user_vec, item_vec)
        return task + self.l2_weight * l2, {"loss": task, "l2_loss": l2}

    def score(self, batch: dict) -> torch.Tensor:
        scores = self.user_vecs(batch["user_id"]) @ self.item_vecs().T \
            + self.item_bias.reshape(-1)
        return torch.sigmoid(scores) if self.sigmoid else scores


class UserVisualPMF(UserPMF):
    def __init__(self, total_users: int, total_items: int, dim_embed: int,
                 user_features=None, mlp_units: Sequence[int] = (),
                 a: float = 1.0, b: float = 1.0, sigmoid: bool = True,
                 dropout: Optional[float] = None, l2_weight: float = 0.0,
                 item_features=None, item_mlp_units: Sequence[int] = (),
                 device=None, generator: torch.Generator | None = None):
        super().__init__(total_users, total_items, dim_embed, user_features,
                         mlp_units, a, b, sigmoid, dropout, l2_weight,
                         device=device, generator=generator)
        dev = resolve_device(device)
        self.register_buffer("item_features",
                             feature_buffer(item_features, dev),
                             persistent=False)
        self.item_mlp = MLP(self.item_features.shape[1],
                            list(item_mlp_units) + [dim_embed],
                            activation="relu", out_activation=None,
                            dropout_rate=dropout, device=dev,
                            generator=generator)

    def item_vecs(self, item_ids=None, features=None,
                  tables=None) -> torch.Tensor:
        """item_embed + MLP(item features), never dropped."""
        if item_ids is None:
            emb, f = self.item_embed, self.item_features
        else:
            emb = self.lookup("item_embed", item_ids, tables)
            f = feature_rows(self.item_features, item_ids, features)
        return emb + self.item_mlp(f)

    def loss(self, batch: dict, tables: dict | None = None,
             generator: torch.Generator | None = None):
        return self._pmf_loss(self.user_vecs(batch["user_id"],
                                       batch.get("user_feature"), generator,
                                       tables),
                        self.item_vecs(batch["item_id"],
                                       batch.get("item_vfeature"), tables),
                        batch, tables)
