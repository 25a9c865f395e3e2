"""The visual family: recommenders whose item vector fuses an id embedding
with an MLP over the item's feature row (a CNN's 4,096 outputs in VBPR).

Counterpart of `openrec_tpu/models/visual.py`:
  VBPR            (`:48-103`) BPR whose item vector is
                  [item_embed (dim_item) || MLP(features) (dim_user -
                  dim_item)], by default one linear layer; L2 on
                  the concatenated vectors; no gradient rescale.
  VisualBPR       (`:106-169`) item vector item_embed + MLP(features); the
                  gradients of `visual_mlp` scaled by 1/B
                  (`grad_transform`); dropout draws once for the positives
                  and once for the negatives.
  VisualCML       (`:172-209`) VisualBPR on the euclidean hinge; its
                  `post_step` projects the batch's `user_embed` and
                  `item_embed` rows (the latent rows, not the fused
                  vectors) onto the unit ball; scores
                  2u.v - ||u||^2 - ||v||^2 + b.
  VisualPMF       (`:212-277`) PMF's truncated-normal tables and weighted
                  MSE (w = (a - b)*label + b inside the square, optional
                  sigmoid) on item_embed + MLP(features); dropout draws
                  once.
  VisualGMF       (`:280-340`) GMF's bias-free unit `mlp/0/w` on
                  u * (item_embed + MLP(features)), BCE from logits summed;
                  the visual MLP has no dropout; scores
                  (u * w).V^T + b.
  ConcatVisualBPR (`:343-401`) item vector [item_embed (dim - dim_ve) ||
                  Linear(features) (dim_ve)] under `visual_proj`, whose
                  gradients are scaled by 1/B.

The feature matrix is a float32 non-persistent buffer (`item_features`):
not a parameter and not in checkpoints, as it is not in the JAX params
tree. A CUDA float32 tensor is taken as it is, so several models can
share one copy on the card; anything else (float64, int32, a memmap) is
converted once, as `jnp.asarray` converts it under JAX's default 32-bit
mode. Feature rows joined into a batch (`p_item_vfeature`,
`n_item_vfeature`, `item_vfeature`) replace the gathered ones and are
cast to the buffer's dtype. Dropout draws from the generator `loss` is
given (the Trainer's), never without one: the keep rate and 1/keep scale
of JAX's masks, not their bits. `item_vecs` without a generator is the
serving side;
`score` re-runs the MLP over the whole catalog on every call.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from openrec_tpu_torch.device import resolve_device
from openrec_tpu_torch.models.base import FactorRecommender
from openrec_tpu_torch.models.pmf import truncated_normal_init
from openrec_tpu_torch.modules.embedding import (censor_norm_, embedding_init,
                                                 embedding_lookup)
from openrec_tpu_torch.modules.losses import (bce_logits_loss, l2_half,
                                              pairwise_eudist_hinge_loss,
                                              pairwise_log_loss)
from openrec_tpu_torch.modules.mlp import MLP


def feature_buffer(features, device) -> torch.Tensor:
    """[N, F] float32 on `device`; a float32 tensor already there is
    returned as it is (shared, not copied)."""
    if features is None:
        raise ValueError("the model needs its feature matrix")
    if not isinstance(features, torch.Tensor):
        # writable float32 memory: a read-only memmap or another dtype is
        # copied here once
        features = torch.from_numpy(np.require(features, np.float32, "W"))
    return features.to(device=device, dtype=torch.float32)


def feature_rows(buffer, ids, given=None) -> torch.Tensor:
    """A batch's joined rows `given` in the buffer's dtype and on its
    device (float32, unless the model was cast), else rows `ids` of the
    buffer."""
    if given is None:
        return embedding_lookup(buffer, ids)
    return torch.as_tensor(given, device=buffer.device).to(buffer.dtype)


def pmf_task(user_vec, item_vec, bias, label, a, b, sigmoid):
    """1/2 * sum((w * (label - pred))^2), w = (a - b)*label + b, pred =
    u.v + b or its sigmoid (`openrec_tpu/models/visual.py:254-260`)."""
    label = torch.as_tensor(label, device=user_vec.device)
    pred = torch.sum(user_vec * item_vec, dim=1) + bias.reshape(-1)
    if sigmoid:
        pred = torch.sigmoid(pred)
    weight = (a - b) * label + b
    return 0.5 * torch.sum((weight * (label - pred)) ** 2)


class _VisualRecommender(FactorRecommender):
    """Tables, the item feature buffer and the visual MLP under `mlp_name`,
    whose output joins the item embedding by sum or (`concat`)
    concatenation; BPR's loss on the fused vectors, and the MLP's 1/B
    gradient rescale where `rescale` is set."""

    loss_reduction = "mean"
    mlp_name = "visual_mlp"
    concat = False
    rescale = True

    def __init__(self, total_users, total_items, dim_user_embed,
                 dim_item_embed, item_features, mlp: dict, device=None,
                 generator=None, init=embedding_init):
        super().__init__(total_users, total_items, dim_user_embed,
                         dim_item_embed, device=device, generator=generator,
                         init=init)
        dev = resolve_device(device)
        self.register_buffer("item_features",
                             feature_buffer(item_features, dev),
                             persistent=False)
        setattr(self, self.mlp_name,
                MLP(self.item_features.shape[1], device=dev,
                    generator=generator, **mlp))

    def item_vecs(self, item_ids=None, features=None, generator=None,
                  tables=None) -> torch.Tensor:
        """Item vectors at `item_ids` (default: the whole catalog), from
        the batch's joined feature rows `features` where given. Without a
        generator nothing drops: the serving side."""
        if item_ids is None:
            emb, f = self.item_embed, self.item_features
        else:
            emb = self.lookup("item_embed", item_ids, tables)
            f = feature_rows(self.item_features, item_ids, features)
        proj = getattr(self, self.mlp_name)(f, train=generator is not None,
                                            generator=generator)
        return torch.cat([emb, proj], dim=-1) if self.concat else emb + proj

    def _pairwise_vecs(self, batch, generator, tables):
        """(user, positive, negative vectors, positive, negative biases);
        the positives' dropout draws first, then the negatives'."""
        user_vec = self.lookup("user_embed", batch["user_id"], tables)
        p_vec = self.item_vecs(batch["p_item_id"],
                               batch.get("p_item_vfeature"), generator,
                               tables)
        n_vec = self.item_vecs(batch["n_item_id"],
                               batch.get("n_item_vfeature"), generator,
                               tables)
        p_bias = self.lookup("item_bias", batch["p_item_id"], tables)
        n_bias = self.lookup("item_bias", batch["n_item_id"], tables)
        return user_vec, p_vec, n_vec, p_bias, n_bias

    def loss(self, batch: dict, tables: dict | None = None,
             generator: torch.Generator | None = None):
        user_vec, p_vec, n_vec, p_bias, n_bias = self._pairwise_vecs(
            batch, generator, tables)
        task = pairwise_log_loss(user_vec, p_vec, n_vec, p_bias, n_bias)
        l2 = l2_half(user_vec, p_vec, n_vec)
        return task + self.l2_weight * l2, {"loss": task, "l2_loss": l2}

    def grad_transform(self, grads: dict, batch: dict) -> dict:
        """The visual MLP's gradients times 1/B, the legacy rescale
        (`openrec_tpu/models/visual.py:40-44, 160-162`); the sparse step
        does not call it, as the JAX package's does not."""
        if not self.rescale:
            return grads
        scale, prefix = 1.0 / batch["user_id"].shape[0], self.mlp_name + "/"
        return {k: g * scale if k.startswith(prefix) else g
                for k, g in grads.items()}

    def score(self, batch: dict) -> torch.Tensor:
        user_vec = embedding_lookup(self.user_embed, batch["user_id"])
        return user_vec @ self.item_vecs().T + self.item_bias.reshape(-1)


class VBPR(_VisualRecommender):
    concat = True
    rescale = False

    def __init__(self, total_users: int, total_items: int,
                 dim_user_embed: int, dim_item_embed: int,
                 item_features=None,
                 mlp_units: Optional[Sequence[int]] = None,
                 l2_weight: float = 0.001, device=None,
                 generator: torch.Generator | None = None):
        units = (list(mlp_units) if mlp_units is not None
                 else [dim_user_embed - dim_item_embed])
        super().__init__(total_users, total_items, dim_user_embed,
                         dim_item_embed, item_features,
                         dict(units=units, activation="relu",
                              out_activation=None),
                         device=device, generator=generator)
        self.l2_weight = l2_weight


class VisualBPR(_VisualRecommender):
    def __init__(self, total_users: int, total_items: int, dim_embed: int,
                 mlp_units: Sequence[int] = (), item_features=None,
                 dropout: Optional[float] = None, l2_weight: float = 0.0,
                 device=None, generator: torch.Generator | None = None):
        super().__init__(total_users, total_items, dim_embed, dim_embed,
                         item_features,
                         dict(units=list(mlp_units) + [dim_embed],
                              activation="relu", out_activation=None,
                              dropout_rate=dropout),
                         device=device, generator=generator)
        self.dropout = dropout
        self.l2_weight = l2_weight


class VisualCML(VisualBPR):
    loss_reduction = "sum"

    def __init__(self, total_users: int, total_items: int, dim_embed: int,
                 mlp_units: Sequence[int] = (), item_features=None,
                 dropout: Optional[float] = None, l2_weight: float = 0.0,
                 margin: float = 0.5, device=None,
                 generator: torch.Generator | None = None):
        super().__init__(total_users, total_items, dim_embed, mlp_units,
                         item_features, dropout, l2_weight, device=device,
                         generator=generator)
        self.margin = margin

    def loss(self, batch: dict, tables: dict | None = None,
             generator: torch.Generator | None = None):
        user_vec, p_vec, n_vec, p_bias, n_bias = self._pairwise_vecs(
            batch, generator, tables)
        task = pairwise_eudist_hinge_loss(user_vec, p_vec, n_vec, p_bias,
                                          n_bias, self.margin)
        l2 = l2_half(user_vec, p_vec, n_vec)
        return task + self.l2_weight * l2, {"loss": task, "l2_loss": l2}

    @torch.no_grad()
    def post_step(self, batch: dict, tables: dict | None = None) -> None:
        dev = self.item_embed.device
        censor_norm_(self.table("user_embed", tables), batch["user_id"])
        censor_norm_(self.table("item_embed", tables), torch.cat([
            torch.as_tensor(batch["p_item_id"], device=dev),
            torch.as_tensor(batch["n_item_id"], device=dev)]))

    def score(self, batch: dict) -> torch.Tensor:
        user_vec = embedding_lookup(self.user_embed, batch["user_id"])
        item = self.item_vecs()
        sq_u = torch.sum(user_vec ** 2, dim=1, keepdim=True)
        sq_v = torch.sum(item ** 2, dim=1)
        return 2.0 * (user_vec @ item.T) - sq_u - sq_v[None, :] \
            + self.item_bias.reshape(-1)


class VisualPMF(_VisualRecommender):
    loss_reduction = "sum"

    def __init__(self, total_users: int, total_items: int, dim_embed: int,
                 mlp_units: Sequence[int] = (), item_features=None,
                 a: float = 1.0, b: float = 1.0, sigmoid: bool = True,
                 dropout: Optional[float] = None, l2_weight: float = 0.0,
                 device=None, generator: torch.Generator | None = None):
        super().__init__(total_users, total_items, dim_embed, dim_embed,
                         item_features,
                         dict(units=list(mlp_units) + [dim_embed],
                              activation="relu", out_activation=None,
                              dropout_rate=dropout),
                         device=device, generator=generator,
                         init=truncated_normal_init)
        self.a, self.b = a, b
        self.sigmoid = sigmoid
        self.dropout = dropout
        self.l2_weight = l2_weight

    def loss(self, batch: dict, tables: dict | None = None,
             generator: torch.Generator | None = None):
        user_vec = self.lookup("user_embed", batch["user_id"], tables)
        item_vec = self.item_vecs(batch["item_id"],
                                  batch.get("item_vfeature"), generator,
                                  tables)
        bias = self.lookup("item_bias", batch["item_id"], tables)
        task = pmf_task(user_vec, item_vec, bias, batch["label"], self.a,
                        self.b, self.sigmoid)
        l2 = l2_half(user_vec, item_vec)
        return task + self.l2_weight * l2, {"loss": task, "l2_loss": l2}

    def score(self, batch: dict) -> torch.Tensor:
        scores = super().score(batch)
        return torch.sigmoid(scores) if self.sigmoid else scores


class VisualGMF(_VisualRecommender):
    loss_reduction = "sum"

    def __init__(self, total_users: int, total_items: int, dim_embed: int,
                 mlp_units: Sequence[int] = (), item_features=None,
                 l2_weight: float = 0.0, device=None,
                 generator: torch.Generator | None = None):
        super().__init__(total_users, total_items, dim_embed, dim_embed,
                         item_features,
                         dict(units=list(mlp_units) + [dim_embed],
                              activation="relu", out_activation=None),
                         device=device, generator=generator)
        self.mlp = MLP(dim_embed, [1], use_bias=False,
                       device=resolve_device(device), generator=generator)
        self.l2_weight = l2_weight

    def user_vecs(self, user_ids) -> torch.Tensor:
        """u * w: the user side of the serving product, w applied once."""
        return embedding_lookup(self.user_embed, user_ids) \
            * self.mlp[0].w[:, 0]

    def loss(self, batch: dict, tables: dict | None = None,
             generator: torch.Generator | None = None):
        user_vec = self.lookup("user_embed", batch["user_id"], tables)
        item_vec = self.item_vecs(batch["item_id"],
                                  batch.get("item_vfeature"), None, tables)
        bias = self.lookup("item_bias", batch["item_id"], tables)
        logit = (self.mlp(user_vec * item_vec) + bias).reshape(-1)
        label = torch.as_tensor(batch["label"], device=logit.device)
        task = bce_logits_loss(label, logit, reduction="sum")
        l2 = l2_half(user_vec, item_vec)
        return task + self.l2_weight * l2, {"loss": task, "l2_loss": l2}

    def score(self, batch: dict) -> torch.Tensor:
        return self.user_vecs(batch["user_id"]) @ self.item_vecs().T \
            + self.item_bias.reshape(-1)


class ConcatVisualBPR(_VisualRecommender):
    mlp_name = "visual_proj"
    concat = True

    def __init__(self, total_users: int, total_items: int, dim_embed: int,
                 dim_ve: int, item_features=None, l2_weight: float = 0.0,
                 device=None, generator: torch.Generator | None = None):
        super().__init__(total_users, total_items, dim_embed,
                         dim_embed - dim_ve, item_features,
                         dict(units=[dim_ve], activation=None,
                              out_activation=None),
                         device=device, generator=generator,
                         init=truncated_normal_init)
        self.l2_weight = l2_weight
