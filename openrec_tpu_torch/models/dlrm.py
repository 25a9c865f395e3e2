"""DLRM: deep learning recommendation model (Naumov et al.).

Counterpart of `openrec_tpu/models/dlrm.py:31-167`: one embedding table
per sparse feature (`ln_emb` rows each), a bottom MLP over the dense
features, the pairwise dot interaction (or a concatenation), a top MLP,
MSE or BCE loss, and `loss_threshold` clipping of the prediction.

Parameters, by their "/"-paths: `mlp_bot/{i}/w|b`, `mlp_top/{i}/w|b`, and
either `embed_tables/{t}` (one [ln_emb[t], m_spa] table per feature) or,
with `fused_tables=True`, `embed_fused`: all tables stacked into one
[sum(ln_emb), m_spa] table, feature t's ids offset by
`table_offsets[t]`, so one gather serves all features and the O(batch)
sparse step (`training/sparse.py`) sees one row space.

`compute_dtype="bfloat16"` runs both MLPs and the interaction in bf16;
parameters stay fp32 and the prediction and loss are fp32.

`loss(batch, tables=...)` and `predict(..., tables=...)` take table
overrides by name: the sparse step passes a gathered `SubTable` view as
`embed_fused`, so autograd reaches only the gathered rows.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch
from torch import nn

from openrec_tpu_torch.device import resolve_device
from openrec_tpu_torch.models.base import Recommender
from openrec_tpu_torch.modules.embedding import (embedding_init,
                                                 embedding_lookup)
from openrec_tpu_torch.modules.interactions import second_order_interaction
from openrec_tpu_torch.modules.losses import bce_loss, mse_loss
from openrec_tpu_torch.modules.mlp import MLP


class DLRM(Recommender):

    def __init__(self, m_spa: int, ln_emb: Sequence[int],
                 ln_bot: Sequence[int], ln_top: Sequence[int],
                 dim_dense: int, arch_interaction_op: str = "dot",
                 arch_interaction_itself: bool = False,
                 sigmoid_bot: bool = False, sigmoid_top: bool = True,
                 loss_func: str = "mse", loss_threshold: float = 0.0,
                 fused_tables: bool = False,
                 compute_dtype: str = "float32", device=None,
                 generator: torch.Generator | None = None):
        super().__init__()
        if arch_interaction_op not in ("dot", "cat"):
            raise ValueError(f"arch_interaction_op={arch_interaction_op} "
                             "is not supported")
        if loss_func not in ("mse", "bce"):
            raise ValueError(f"loss_func={loss_func} is not supported")
        if arch_interaction_op == "dot" and ln_bot[-1] != m_spa:
            raise ValueError(
                f"dot interaction requires ln_bot[-1] == m_spa "
                f"(got {ln_bot[-1]} vs {m_spa})")
        dev = resolve_device(device)
        self.m_spa = m_spa
        self.ln_emb = tuple(int(c) for c in ln_emb)
        self.ln_bot = tuple(ln_bot)
        self.ln_top = tuple(ln_top)
        self.dim_dense = dim_dense
        self.arch_interaction_op = arch_interaction_op
        self.arch_interaction_itself = arch_interaction_itself
        self.loss_func = loss_func
        self.loss_threshold = loss_threshold
        self.fused_tables = fused_tables
        self.compute_dtype = compute_dtype
        tables = [embedding_init(num, m_spa, generator=generator, device=dev)
                  for num in self.ln_emb]
        if fused_tables:
            self.embed_fused = nn.Parameter(torch.cat(tables))
        else:
            self.embed_tables = nn.ParameterList(tables)
        del tables
        self.mlp_bot = MLP(
            dim_dense, ln_bot, activation="relu",
            out_activation="sigmoid" if sigmoid_bot else "relu",
            device=dev, generator=generator)
        self.mlp_top = MLP(
            self._top_in_dim(), ln_top, activation="relu",
            out_activation="sigmoid" if sigmoid_top else "relu",
            device=dev, generator=generator)
        self.register_buffer(
            "_offsets", torch.as_tensor(self.table_offsets[:-1],
                                        dtype=torch.int32, device=dev),
            persistent=False)

    def _top_in_dim(self) -> int:
        F = len(self.ln_emb) + 1     # sparse features + dense embedding
        if self.arch_interaction_op == "dot":
            pairs = F * (F + 1) // 2 if self.arch_interaction_itself \
                else F * (F - 1) // 2
            return self.ln_bot[-1] + pairs
        return len(self.ln_emb) * self.m_spa + self.ln_bot[-1]

    @property
    def table_offsets(self) -> np.ndarray:
        return np.concatenate([[0], np.cumsum(self.ln_emb)])

    def flat_sparse_ids(self, sparse_features) -> torch.Tensor:
        """[B, T] per-table ids -> [B, T] ids into the fused row space."""
        sparse = torch.as_tensor(sparse_features, device=self._offsets.device)
        return sparse + self._offsets[None, :]

    def predict(self, dense_features, sparse_features,
                tables: dict | None = None) -> torch.Tensor:
        """dense: [B, dim_dense]; sparse: [B, num_tables] int -> [B]."""
        dev = self._offsets.device
        dense = torch.as_tensor(dense_features, device=dev)
        sparse = torch.as_tensor(sparse_features, device=dev)
        B, T = sparse.shape
        if self.fused_tables:
            rows = embedding_lookup(self.table("embed_fused", tables),
                                    self.flat_sparse_ids(sparse).reshape(-1))
            sparse_vecs = rows.reshape(B, T, self.m_spa)
        else:
            sparse_vecs = torch.stack(
                [embedding_lookup(self.table(f"embed_tables/{t}", tables),
                                  sparse[:, t]) for t in range(T)], dim=1)
        cdt = getattr(torch, self.compute_dtype)
        dense_vec = self.mlp_bot(dense.to(cdt))
        sparse_vecs = sparse_vecs.to(cdt)
        if self.arch_interaction_op == "dot":
            inter = second_order_interaction(
                torch.cat([sparse_vecs, dense_vec[:, None, :]], dim=1),
                self_interaction=self.arch_interaction_itself)
            top_in = torch.cat([dense_vec, inter], dim=1)
        else:
            top_in = torch.cat([sparse_vecs.reshape(B, -1), dense_vec],
                               dim=1)
        pred = self.mlp_top(top_in).to(torch.float32)
        if 0.0 < self.loss_threshold < 1.0:
            pred = torch.clamp(pred, self.loss_threshold,
                               1.0 - self.loss_threshold)
        return pred.reshape(-1)

    def loss(self, batch: dict, tables: dict | None = None,
             generator: torch.Generator | None = None):
        pred = self.predict(batch["dense_features"], batch["sparse_features"],
                            tables=tables)
        label = torch.as_tensor(batch["label"], device=pred.device)
        task = mse_loss(label, pred) if self.loss_func == "mse" \
            else bce_loss(label, pred)
        return task, {"loss": task}

    def score(self, batch: dict) -> torch.Tensor:
        return self.predict(batch["dense_features"], batch["sparse_features"])


def criteo_dlrm(counts, dim_embed=4, ln_bot=(8, 4), ln_top=(128, 64, 1),
                **kw) -> DLRM:
    """The reference Criteo config (tf2_examples/dlrm_criteo.py:9-14,29-38)."""
    return DLRM(m_spa=dim_embed, ln_emb=tuple(int(c) for c in counts),
                ln_bot=tuple(ln_bot), ln_top=tuple(ln_top), dim_dense=13,
                loss_func="bce", **kw)
