"""Sequential recommenders: next-item prediction over user histories.

Counterpart of `openrec_tpu/models/sequence.py`. A batch is a
`TemporalSampler`'s: `seq_item_id` [B, L] windows, `seq_len` [B] and the
next item `label` [B] (YouTubeRec also `user_gender`, `user_geo`).

RNNRec (`:39-92`): a GRU or LSTM (`modules/rnn.py`) over the window's
item embeddings; its final state h [B, num_units] scores the catalog as
h . out_weight^T + out_bias ([I, num_units], [I]). The loss is the
softmax CE over the full catalog, or with `softmax_samples` set TF's
sampled softmax (log-uniform candidates by default), whose candidates
are drawn from the generator the Trainer hands to `loss`. Every table is
read through `table` / `lookup`, so on a mesh whose rules shard
`item_embed`, `out_weight` and `out_bias` over 'model' the full softmax
is the vocabulary-parallel one (`table_softmax_ce` resolves the view's
`softmax_ce`) and the
sampled one gathers its true and candidate rows through the views.

VanillaYouTubeRec (`:95-165`): the window's item embeddings summed over
its first seq_len positions and divided by L, not by seq_len (the
reference's reduce_mean over the padded axis, kept), through an MLP
whose hidden layers are relu and whose last layer has no bias
(`mlp/<last>/w` alone); its logits [B, I] go into the full softmax CE.
Dropout after the hidden layers applies in `loss` when a generator is
given, and draws from it. YouTubeRec (`:168-196`) feeds the MLP
[gender embedding, geo embedding, pooled items], in that order.

Item embeddings (and YouTubeRec's user tables) start as 0.01 times a
normal truncated at 2 (the JAX package's `_normal_embed`); the models in
the tests start from JAX's init through `convert.params_from_jax`.

Serving: `hidden(batch)` gives the vector a K1/K2/K3 request scores
with: RNNRec's state against `out_weight` and `out_bias`, the YouTube
models' last hidden layer against the transposed last MLP weight and no
bias (`serving_tables()`). On a mesh, `hidden(batch, tables=views)`
and `serving_tables(views)` give a rank its shard to serve (through
`parallel.sharded_pallas_topk`), its pad rows at bias -1e30.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import nn

from openrec_tpu_torch.device import resolve_device
from openrec_tpu_torch.models.base import Recommender
from openrec_tpu_torch.modules.embedding import (embedding_lookup,
                                                 normal_embed, serving_rows)
from openrec_tpu_torch.modules.interactions import masked_sum
from openrec_tpu_torch.modules.losses import (sampled_softmax_loss,
                                              softmax_ce_loss,
                                              table_softmax_ce)
from openrec_tpu_torch.modules.mlp import MLP, glorot_uniform
from openrec_tpu_torch.modules.rnn import GRU, LSTM


class RNNRec(Recommender):
    loss_reduction = "mean"

    def __init__(self, total_items: int, dim_item_embed: int,
                 max_seq_len: int, num_units: int, cell_type: str = "gru",
                 softmax_samples: Optional[int] = None,
                 softmax_sample_distribution: str = "log_uniform",
                 device=None,
                 generator: torch.Generator | None = None):
        super().__init__()
        dev = resolve_device(device)
        cells = {"gru": GRU, "lstm": LSTM}
        if cell_type not in cells:
            raise ValueError("Invalid RNN cell type.")
        self.total_items = total_items
        self.max_seq_len = max_seq_len
        self.softmax_samples = softmax_samples
        self.softmax_sample_distribution = softmax_sample_distribution
        self.item_embed = nn.Parameter(normal_embed(
            total_items, dim_item_embed, generator, dev))
        self.cell = cells[cell_type](dim_item_embed, num_units, device=dev,
                                     generator=generator)
        self.out_weight = nn.Parameter(glorot_uniform(
            (total_items, num_units), generator=generator, device=dev))
        self.out_bias = nn.Parameter(torch.zeros(total_items, device=dev))

    def hidden(self, batch: dict, tables: dict | None = None
               ) -> torch.Tensor:
        """The recurrent state after each window's last item, [B, H]."""
        seq_vecs = self.lookup("item_embed", batch["seq_item_id"], tables)
        return self.cell(seq_vecs, batch["seq_len"])

    def loss(self, batch: dict, tables: dict | None = None,
             generator: torch.Generator | None = None):
        state = self.hidden(batch, tables)
        weight = self.table("out_weight", tables)
        bias = self.table("out_bias", tables)
        if self.softmax_samples is not None:
            if generator is None:
                raise ValueError("sampled softmax needs a generator")
            task = sampled_softmax_loss(
                weight, bias, state, batch["label"],
                num_sampled=self.softmax_samples, generator=generator,
                distribution=self.softmax_sample_distribution)
        else:
            task = table_softmax_ce(state, weight, bias, batch["label"])
        return task, {"loss": task}

    def score_hidden(self, state: torch.Tensor) -> torch.Tensor:
        return state @ self.out_weight.T + self.out_bias

    def score(self, batch: dict) -> torch.Tensor:
        return self.score_hidden(self.hidden(batch))

    def serving_tables(self, tables: dict | None = None):
        """(item table [I, H], bias [I]) that `hidden` scores against;
        with the views of row-sharded tables, this rank's shards, its pad
        rows at bias -1e30 so that none is ever served."""
        return (serving_rows(self.table("out_weight", tables)),
                serving_rows(self.table("out_bias", tables), -1e30))


class VanillaYouTubeRec(Recommender):
    loss_reduction = "mean"

    def __init__(self, total_items: int, dim_item_embed: int,
                 max_seq_len: int,
                 mlp_units: Optional[Sequence[int]] = None,
                 dropout: Optional[float] = None, device=None,
                 generator: torch.Generator | None = None):
        super().__init__()
        dev = resolve_device(device)
        self.total_items = total_items
        self.max_seq_len = max_seq_len
        self.dropout = dropout
        units = (list(mlp_units) if mlp_units is not None
                 else [dim_item_embed, total_items])
        self.item_embed = nn.Parameter(normal_embed(
            total_items, dim_item_embed, generator, dev))
        self._init_user_tables(generator, dev)
        self.mlp = MLP(self._mlp_in_dim(dim_item_embed), units,
                       activation="relu", out_activation=None,
                       dropout_rate=dropout, out_bias=False, device=dev,
                       generator=generator)

    def _init_user_tables(self, generator, device):
        """YouTubeRec's demographic tables; none here."""

    def _mlp_in_dim(self, dim_item_embed):
        return dim_item_embed

    def _pooled(self, batch, tables=None):
        """Sum of the first seq_len item vectors / L (the reference's
        mean over the padded axis)."""
        seq_vecs = self.lookup("item_embed", batch["seq_item_id"], tables)
        return masked_sum(seq_vecs, batch["seq_len"]) / seq_vecs.shape[1]

    def _features(self, batch, tables=None):
        return self._pooled(batch, tables)

    def hidden(self, batch: dict,
               generator: torch.Generator | None = None,
               tables: dict | None = None) -> torch.Tensor:
        """The MLP's last hidden layer [B, units[-2]], with dropout when
        `generator` is given: the logits are it times the last weight."""
        return self.mlp(self._features(batch, tables),
                        train=generator is not None, generator=generator,
                        layers=len(self.mlp) - 1)

    def loss(self, batch: dict, tables: dict | None = None,
             generator: torch.Generator | None = None):
        logits = self.hidden(batch, generator, tables) @ self.mlp[-1].w
        task = softmax_ce_loss(logits, batch["label"])
        return task, {"loss": task}

    def score(self, batch: dict) -> torch.Tensor:
        return self.hidden(batch) @ self.mlp[-1].w

    def serving_tables(self):
        """(item table [I, units[-2]] = the last weight transposed, made
        contiguous, and no bias) that `hidden` scores against."""
        return self.mlp[-1].w.detach().T.contiguous(), None


class YouTubeRec(VanillaYouTubeRec):
    """VanillaYouTubeRec with the user's gender and geo embeddings before
    the pooled items in the MLP's input."""

    def __init__(self, total_items: int, dim_item_embed: int,
                 max_seq_len: int,
                 mlp_units: Optional[Sequence[int]] = None,
                 dropout: Optional[float] = None, total_genders: int = 3, total_geos: int = 100,
                 dim_gender_embed: int = 8, dim_geo_embed: int = 8,
                 device=None, generator: torch.Generator | None = None):
        self.total_genders, self.total_geos = total_genders, total_geos
        self.dim_gender_embed = dim_gender_embed
        self.dim_geo_embed = dim_geo_embed
        super().__init__(total_items, dim_item_embed, max_seq_len,
                         mlp_units, dropout, device, generator)

    def _init_user_tables(self, generator, device):
        self.gender_embed = nn.Parameter(normal_embed(
            self.total_genders, self.dim_gender_embed, generator, device))
        self.geo_embed = nn.Parameter(normal_embed(
            self.total_geos, self.dim_geo_embed, generator, device))

    def _mlp_in_dim(self, dim_item_embed):
        return dim_item_embed + self.dim_gender_embed + self.dim_geo_embed

    def _features(self, batch, tables=None):
        gender = embedding_lookup(self.gender_embed, batch["user_gender"])
        geo = embedding_lookup(self.geo_embed, batch["user_geo"])
        return torch.cat([gender, geo, self._pooled(batch, tables)], dim=1)
