"""ItrMLP: the temporal embedding forward-propagation recommender.

Counterpart of `openrec_tpu/models/itr_mlp.py:34-165`. The user and item
tables are frozen: training moves only the two MLPs (batch norm on every
layer, relu out) that transform looked-up rows, and the item bias.
`post_step` marks the rows a batch visited in `user_flag` / `item_flag`;
`update_embeddings()`, which `Trainer.train(update_interval=)` calls
every `update_interval` steps, writes MLP(table) into the marked rows and
clears the marks. The MLP runs over the WHOLE table there, so its batch
norm takes the statistics of every row, visited or not. In a
data-parallel step the loss's batch norm takes the GLOBAL batch's
statistics (`modules/global_batch.py`), so the loss splits over data
ranks as a sum; `post_step` marks the global batch's rows in the flags,
which stay whole, so every rank does the same.

On a mesh whose rules shard `user_embed`, `item_embed` and `item_bias`
over 'model', the loss reads them through their views (detached
lookups); `update_embeddings(tables=views)` runs each MLP over this
rank's shard, its batch norm over the whole table's real rows (summed
over 'model', `ShardedTable.map_rows`; no pad row enters),
and writes the flagged rows of the shard; `serving_tables(views)` gives
this rank's shard of the served table, its pad rows at bias -1e30.

The tables and flags stay `nn.Parameter`s under the JAX tree's names, so
that `convert`, npz checkpoints and `load_params` carry them. They are
detached where they are read (JAX's `lax.stop_gradient`, `:84-91`), so
their gradients are zero: `lazy_adam` touches none of their rows, and a
dense Adam's zero moments give a zero step. `post_step` and
`update_embeddings` work in place, as the port's `post_step` does
(`models/base.py`), where JAX returns new params.

Serving: `user_vecs(batch)` (the user MLP over the request's rows, batch
norm over that batch) against `serving_tables()` (the item MLP over the
full item table, and the bias [I]); their logits are what K1/K2/K3
serve, and `score` is their sigmoid, which is monotone and saturates in
fp32.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import nn

from openrec_tpu_torch.device import resolve_device
from openrec_tpu_torch.models.base import Recommender
from openrec_tpu_torch.modules.embedding import (map_rows, normal_embed,
                                                 serving_rows, update_rows_)
from openrec_tpu_torch.modules.mlp import MLP
from openrec_tpu_torch.training.optim import adam, apply_updates


def _table(pretrained, num, dim, generator, device):
    if pretrained is None:
        return normal_embed(num, dim, generator, device)
    return torch.as_tensor(pretrained, dtype=torch.float32).to(
        device, copy=True)


class ItrMLP(Recommender):
    # a sum over the records; the batch norm's statistics are the global
    # batch's in a data-parallel step, so the slices' sums add up to it
    loss_reduction = "sum"

    def __init__(self, total_users: int, total_items: int, dim_embed: int,
                 user_dims: Sequence[int] = (),
                 item_dims: Sequence[int] = (),
                 pretrained_user_embeddings=None,
                 pretrained_item_embeddings=None,
                 a: float = 1.0, b: float = 1.0, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        dev = resolve_device(device)
        self.total_users = total_users
        self.total_items = total_items
        self.dim_embed = dim_embed
        self.a, self.b = a, b
        self.user_embed = nn.Parameter(_table(
            pretrained_user_embeddings, total_users, dim_embed, generator,
            dev))
        self.item_embed = nn.Parameter(_table(
            pretrained_item_embeddings, total_items, dim_embed, generator,
            dev))
        self.user_flag = nn.Parameter(torch.zeros(total_users, device=dev))
        self.item_flag = nn.Parameter(torch.zeros(total_items, device=dev))
        self.item_bias = nn.Parameter(torch.zeros((total_items, 1),
                                                  device=dev))
        self.user_mlp, self.item_mlp = (
            MLP(dim_embed, list(dims) or [dim_embed], activation="relu",
                out_activation="relu", batch_norm=True, device=dev,
                generator=generator)
            for dims in (user_dims, item_dims))

    def user_vecs(self, batch: dict, tables: dict | None = None
                  ) -> torch.Tensor:
        """The user MLP over the batch's rows (batch norm over them)."""
        return self.user_mlp(self.lookup("user_embed", batch["user_id"],
                                         tables).detach())

    def _item_vecs(self, item_ids, tables=None) -> torch.Tensor:
        return self.item_mlp(self.lookup("item_embed", item_ids,
                                         tables).detach())

    def loss(self, batch: dict, tables: dict | None = None,
             generator: torch.Generator | None = None):
        """0.5 * sum((w * (label - sigmoid(u . v + b)))^2), w = (a - b) *
        label + b. Draws nothing."""
        item_ids = batch["item_id"]
        bias = self.lookup("item_bias", item_ids, tables).reshape(-1)
        label = batch["label"]
        pred = torch.sigmoid(torch.sum(self.user_vecs(batch, tables)
                                       * self._item_vecs(item_ids, tables),
                                       dim=1) + bias)
        weight = (self.a - self.b) * label + self.b
        task = 0.5 * torch.sum((weight * (label - pred)) ** 2)
        return task, {"loss": task}

    @torch.no_grad()
    def post_step(self, batch: dict, tables: dict | None = None) -> None:
        """Mark the visited rows (flags to 1.0), in place."""
        for flag, key in ((self.user_flag, "user_id"),
                          (self.item_flag, "item_id")):
            ids = torch.as_tensor(batch[key], device=flag.device).long()
            flag.index_fill_(0, ids.reshape(-1), 1.0)

    @torch.no_grad()
    def update_embeddings(self, tables: dict | None = None) -> None:
        """table[flagged] <- MLP(table)[flagged], the MLP over the full
        table (its batch norm over every row); then clear the flags. In
        place. With the views of row-sharded tables, each rank updates
        its shard, the batch norm over the whole table's real rows."""
        for name, flag, mlp in (("user_embed", self.user_flag,
                                 self.user_mlp),
                                ("item_embed", self.item_flag,
                                 self.item_mlp)):
            update_rows_(self.table(name, tables), flag, mlp)
            flag.zero_()

    def pretrain_identity(self, generator: torch.Generator | None = None,
                          steps: int = 2000, batch: int = 32,
                          lr: float = 1e-3) -> None:
        """Pretrain the user MLP, then the item MLP, toward the identity
        on U(-0.5, 0.5) inputs of [batch, dim_embed] drawn from
        `generator` (`steps` of each; the reference hardcodes 20,000)."""
        dev = self.user_embed.device
        for mlp in (self.user_mlp, self.item_mlp):
            pretrain_mlp_identity(
                mlp, (torch.rand((batch, self.dim_embed), generator=generator,
                                 device=dev) - 0.5 for _ in range(steps)),
                lr)

    def serving_tables(self, tables: dict | None = None):
        """(item MLP over the full item table [I, dim], made contiguous;
        item bias [I]) that `user_vecs` scores against. With the views of
        row-sharded tables, this rank's shard of both, the batch norm over
        the whole table's real rows and the pad rows at bias -1e30."""
        with torch.no_grad():
            items = map_rows(self.item_mlp, self.table("item_embed", tables))
        return items.contiguous(), serving_rows(
            self.table("item_bias", tables), -1e30).reshape(-1)

    def score(self, batch: dict) -> torch.Tensor:
        table, bias = self.serving_tables()
        return torch.sigmoid(self.user_vecs(batch) @ table.T + bias)


def pretrain_mlp_identity(mlp: MLP, inputs, lr: float = 1e-3) -> None:
    """optax-form Adam (`training.optim.adam`, eps 1e-8) on
    0.5 * sum((mlp(x) - x)^2), one step for each x of `inputs`, in place
    on the MLP's parameters."""
    params = {name: p for name, p in mlp.named_parameters()}
    tx = adam(lr)
    state = tx.init(params)
    for x in inputs:
        loss = 0.5 * torch.sum((mlp(x) - x) ** 2)
        grads = dict(zip(params, torch.autograd.grad(
            loss, list(params.values()))))
        with torch.no_grad():
            updates, state = tx.update(grads, state, params)
            apply_updates(params, updates)
