"""CDL: collaborative deep learning, PMF with an SDAE over item content.

Counterpart of `openrec_tpu/models/cdl.py:24-84`: PMF's tables
(truncated-normal init, stddev 0.01), an `SDAE` (`sdae/encoder/...`,
`sdae/decoder/...`) whose code is added to the item's latent vector
(item vector = item_embed + enc(features)), the task
0.5 * sum((w * (label - pred))^2) with w = (a - b)*label + b inside the
square, pred = u.v + b or its sigmoid, plus the SDAE's reconstruction
term and `l2_weight` times the L2 of the gathered user and item vectors.
`item_features` [I, F] is a non-persistent buffer: not a parameter, not
in checkpoints, as it is not in the JAX params tree. `score` re-encodes
the whole catalog on every call.
"""

from __future__ import annotations

from typing import Sequence

import torch

from openrec_tpu_torch.device import resolve_device
from openrec_tpu_torch.models.base import FactorRecommender
from openrec_tpu_torch.models.pmf import truncated_normal_init
from openrec_tpu_torch.modules.embedding import embedding_lookup
from openrec_tpu_torch.modules.losses import l2_half
from openrec_tpu_torch.modules.sdae import SDAE


class CDL(FactorRecommender):
    loss_reduction = "sum"

    def __init__(self, total_users: int, total_items: int, dim_embed: int,
                 item_features, encoder_dims: Sequence[int] = (),
                 dropout: float = 0.0, l2_reconst: float = 1.0,
                 a: float = 1.0, b: float = 1.0, sigmoid: bool = True,
                 l2_weight: float = 0.0, device=None,
                 generator: torch.Generator | None = None):
        super().__init__(total_users, total_items, dim_embed, dim_embed,
                         device=device, generator=generator,
                         init=truncated_normal_init)
        dev = resolve_device(device)
        features = torch.as_tensor(item_features, dtype=torch.float32)
        self.register_buffer("item_features", features.to(dev),
                             persistent=False)
        self.sdae = SDAE(features.shape[1],
                         list(encoder_dims) + [dim_embed], dropout=dropout,
                         l2_reconst=l2_reconst, device=dev,
                         generator=generator)
        self.a, self.b = a, b
        self.sigmoid = sigmoid
        self.l2_weight = l2_weight

    def item_vecs(self, item_ids) -> torch.Tensor:
        """item_embed + enc(features) at `item_ids`: the serving side."""
        return embedding_lookup(self.item_embed, item_ids) \
            + self.sdae.encode(embedding_lookup(self.item_features,
                                                item_ids))

    def loss(self, batch: dict, tables: dict | None = None,
             generator: torch.Generator | None = None):
        user_vec = self.lookup("user_embed", batch["user_id"], tables)
        emb = self.lookup("item_embed", batch["item_id"], tables)
        f = batch.get("item_feature")
        f = embedding_lookup(self.item_features, batch["item_id"]) \
            if f is None else torch.as_tensor(f, device=emb.device)
        reconst, code = self.sdae.reconstruction_loss(f, generator)
        item_vec = emb + code
        bias = self.lookup("item_bias", batch["item_id"], tables)
        label = torch.as_tensor(batch["label"], device=emb.device)
        pred = torch.sum(user_vec * item_vec, dim=1) + bias.reshape(-1)
        if self.sigmoid:
            pred = torch.sigmoid(pred)
        weight = (self.a - self.b) * label + self.b
        task = 0.5 * torch.sum((weight * (label - pred)) ** 2)
        l2 = l2_half(user_vec, item_vec)
        total = task + reconst + self.l2_weight * l2
        return total, {"loss": task, "reconst_loss": reconst, "l2_loss": l2}

    def score(self, batch: dict) -> torch.Tensor:
        user_vec = embedding_lookup(self.user_embed, batch["user_id"])
        item_full = self.item_embed + self.sdae.encode(self.item_features)
        scores = user_vec @ item_full.T + self.item_bias.reshape(-1)
        return torch.sigmoid(scores) if self.sigmoid else scores
