"""DLRM: deep learning recommendation model (Naumov et al.).

Counterpart of `openrec_tpu/models/dlrm.py:31-167`: one embedding table
per sparse feature (`ln_emb` rows each), a bottom MLP over the dense
features, the pairwise dot interaction (or a concatenation), a top MLP,
MSE or BCE loss, and `loss_threshold` clipping of the prediction.

Beyond the JAX package, DLRM-DCNv2 (the model of MLPerf Training's
recommendation benchmark): `arch_interaction_op="dcn"` feeds the top MLP
with `dcn_layers` low-rank cross layers of rank `dcn_rank`
(`modules/interactions.py`) over x0 = [dense vector, the T sparse
vectors], (T + 1) * m_spa wide; and `multi_hot` (ids a table, fused
tables only) makes each feature a bag: `sparse_features` is then [B,
sum(multi_hot)], the columns grouped by table in table order, and each
table's ids are sum-pooled into one vector by one `embedding_bag` call
for all bags (`modules.embedding.embedding_bags`). The pooling sits in
the span `openrec.dlrm.pool` and counts its ids in
`openrec.dlrm.bag_ids`, the cross layers in `openrec.dlrm.cross`
(`trace.py`). Without `multi_hot` every feature looks up one id.

Parameters, by their "/"-paths: `mlp_bot/{i}/w|b`, `mlp_top/{i}/w|b`, and
either `embed_tables/{t}` (one [ln_emb[t], m_spa] table per feature) or,
with `fused_tables=True`, `embed_fused`: all tables stacked into one
[sum(ln_emb), m_spa] table, feature t's ids offset by
`table_offsets[t]`, so one gather serves all features and the O(batch)
sparse step (`training/sparse.py`) sees one row space; with `dcn`,
`cross/{l}/v` [d, r], `cross/{l}/w` [r, d] and `cross/{l}/b` [d].

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

from openrec_tpu_torch import trace
from openrec_tpu_torch.device import resolve_device
from openrec_tpu_torch.models.base import Recommender
from openrec_tpu_torch.modules.embedding import (embedding_bags,
                                                 embedding_init,
                                                 embedding_lookup)
from openrec_tpu_torch.modules.interactions import (LowRankCrossNet,
                                                    second_order_interaction)
from openrec_tpu_torch.modules.losses import bce_loss, mse_loss
from openrec_tpu_torch.modules.mlp import MLP


class DLRM(Recommender):
    loss_reduction = "mean"

    def __init__(self, m_spa: int, ln_emb: Sequence[int],
                 ln_bot: Sequence[int], ln_top: Sequence[int],
                 dim_dense: int, arch_interaction_op: str = "dot",
                 arch_interaction_itself: bool = False,
                 sigmoid_bot: bool = False, sigmoid_top: bool = True,
                 loss_func: str = "mse", loss_threshold: float = 0.0,
                 fused_tables: bool = False,
                 compute_dtype: str = "float32", device=None,
                 generator: torch.Generator | None = None,
                 dcn_layers: int = 0, dcn_rank: int = 0,
                 multi_hot: Sequence[int] | None = None):
        super().__init__()
        if arch_interaction_op not in ("dot", "cat", "dcn"):
            raise ValueError(f"arch_interaction_op={arch_interaction_op} "
                             "is not supported")
        if loss_func not in ("mse", "bce"):
            raise ValueError(f"loss_func={loss_func} is not supported")
        if arch_interaction_op in ("dot", "dcn") and ln_bot[-1] != m_spa:
            raise ValueError(
                f"{arch_interaction_op} interaction requires ln_bot[-1] == "
                f"m_spa (got {ln_bot[-1]} vs {m_spa})")
        if arch_interaction_op == "dcn" and (dcn_layers < 1
                                             or dcn_rank < 1):
            raise ValueError("dcn interaction requires dcn_layers >= 1 and "
                             f"dcn_rank >= 1 (got {dcn_layers}, {dcn_rank})")
        if multi_hot is not None and (
                len(multi_hot) != len(ln_emb)
                or any(int(n) < 1 for n in multi_hot)):
            raise ValueError("multi_hot needs one size >= 1 a table (got "
                             f"{tuple(multi_hot)} for {len(ln_emb)} tables)")
        if multi_hot is not None and not fused_tables:
            raise ValueError("multi_hot bags need fused_tables=True")
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
        self.dcn_layers = dcn_layers
        self.dcn_rank = dcn_rank
        self.multi_hot = None if multi_hot is None \
            else tuple(int(n) for n in multi_hot)
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
        if arch_interaction_op == "dcn":
            self.cross = LowRankCrossNet(self._top_in_dim(), dcn_layers,
                                         dcn_rank, device=dev,
                                         generator=generator)
        # each id column's table offset: one column a table, or a bag's
        # columns all at their table's
        sizes = self.multi_hot or (1,) * len(self.ln_emb)
        self.register_buffer(
            "_offsets", torch.as_tensor(
                np.repeat(self.table_offsets[:-1], sizes),
                dtype=torch.int32, device=dev),
            persistent=False)
        self.register_buffer(
            "_bag_starts", torch.as_tensor(
                np.concatenate([[0], np.cumsum(sizes)[:-1]]),
                dtype=torch.int64, device=dev),
            persistent=False)

    def _top_in_dim(self) -> int:
        F = len(self.ln_emb) + 1     # sparse features + dense embedding
        if self.arch_interaction_op == "dot":
            pairs = F * (F + 1) // 2 if self.arch_interaction_itself \
                else F * (F - 1) // 2
            return self.ln_bot[-1] + pairs
        if self.arch_interaction_op == "dcn":
            return (len(self.ln_emb) + 1) * self.m_spa
        return len(self.ln_emb) * self.m_spa + self.ln_bot[-1]

    @property
    def table_offsets(self) -> np.ndarray:
        return np.concatenate([[0], np.cumsum(self.ln_emb)])

    def flat_sparse_ids(self, sparse_features) -> torch.Tensor:
        """[B, C] per-table ids -> [B, C] ids into the fused row space (C
        the tables, or sum(multi_hot))."""
        sparse = torch.as_tensor(sparse_features, device=self._offsets.device)
        return sparse + self._offsets[None, :]

    def pooled(self, sparse: torch.Tensor,
               tables: dict | None = None) -> torch.Tensor:
        """[B, sum(multi_hot)] ids -> [B, T, m_spa]: each table's bag of
        rows summed, all bags in one `embedding_bags` call."""
        B, C = sparse.shape
        if C != sum(self.multi_hot):
            raise ValueError(f"sparse_features has {C} columns, multi_hot "
                             f"{sum(self.multi_hot)}")
        trace.count("openrec.dlrm.bag_ids", B * C)
        with trace.span("openrec.dlrm.pool"):
            offsets = (torch.arange(B, dtype=torch.int64,
                                    device=sparse.device)[:, None] * C
                       + self._bag_starts[None, :]).reshape(-1)
            return embedding_bags(
                self.table("embed_fused", tables),
                self.flat_sparse_ids(sparse).reshape(-1),
                offsets).reshape(B, len(self.ln_emb), self.m_spa)

    def predict(self, dense_features, sparse_features,
                tables: dict | None = None) -> torch.Tensor:
        """dense: [B, dim_dense]; sparse: [B, num_tables] int (or [B,
        sum(multi_hot)]) -> [B]."""
        dev = self._offsets.device
        dense = torch.as_tensor(dense_features, device=dev)
        sparse = torch.as_tensor(sparse_features, device=dev)
        B, T = sparse.shape
        if self.multi_hot is not None:
            sparse_vecs = self.pooled(sparse, tables)
        elif self.fused_tables:
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
        elif self.arch_interaction_op == "dcn":
            x0 = torch.cat([dense_vec, sparse_vecs.reshape(B, -1)], dim=1)
            with trace.span("openrec.dlrm.cross"):
                top_in = self.cross(x0)
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
