"""Recommender base class.

Counterpart of `openrec_tpu/models/base.py`. The JAX package passes a
params pytree into pure functions; here the parameters live on the
`nn.Module`. `params()` and `load_params` name them by the JAX pytree's
"/"-joined paths (`mlp_bot/0/w`, `embed_tables/3`), the module's "."-joined
names with "." read as "/", so that `convert.params_from_jax` output and
npz checkpoints load by name. BPR's names hold neither character.

  model = BPR(..., device="cuda")
  loss, aux = model.loss(batch)         # autograd-able
  loss, aux = model.loss(batch, tables={"item_embed": view})
  loss, aux = model.loss(batch, generator=gen)   # dropout draws from gen
  scores = model.score(batch)           # full-catalog serving
  model.load_params(flat)               # {path: tensor} from JAX / npz
  grads = model.grad_transform(grads, batch)   # trainer hooks, identity
  model.post_step(batch)                       # by default
  model.post_step(batch, tables={"user_embed": view})   # a row shard
"""

from __future__ import annotations

import torch
from torch import nn

from openrec_tpu_torch.device import resolve_device
from openrec_tpu_torch.modules.embedding import (embedding_init,
                                                 embedding_lookup)


class Recommender(nn.Module):
    """Base class; subclasses define loss/score."""

    def loss(self, batch: dict, tables: dict | None = None,
             generator: torch.Generator | None = None):
        """Returns (total_loss, aux_dict). aux carries per-part losses.
        `tables` replaces embedding tables by name for this call, e.g. with
        the gathered views of the O(batch) sparse step
        (`training/sparse.py`), so that autograd never reaches the full
        table, or with the views of row-sharded tables on a mesh
        (`parallel.ShardedTable`). `generator` is the Trainer's
        `torch.Generator` (the JAX package's per-step rng): a model whose
        loss draws randomness (dropout) draws from it, and only when it
        is given; the others never touch it, so it does not advance."""
        raise NotImplementedError

    def table(self, name: str, tables: dict | None = None):
        """The embedding table `name` ("/"-path), or its override."""
        if tables and name in tables:
            return tables[name]
        return self.get_parameter(name.replace("/", "."))

    def lookup(self, name: str, ids, tables: dict | None = None):
        """Rows `ids` of the table `name` (or of its override)."""
        return embedding_lookup(self.table(name, tables), ids)

    def score(self, batch: dict) -> torch.Tensor:
        """Full-catalog scores [B, total_items] for serving/evaluation."""
        raise NotImplementedError

    # How the loss reduces over the batch's examples, for `batch_sums`:
    # "mean" (a batch mean plus, where aux has "l2_loss", l2_weight times
    # an L2 summed over the batch's looked-up rows), "sum" (every term a
    # sum over the examples) or None (not declared: the loss does not
    # split over data ranks). A term that reads the whole batch, such as
    # a batch norm's statistics, still splits: inside a data-parallel
    # step it reads the global batch (`modules/global_batch.py`), so each
    # slice's part is its examples' terms and the parts add up.
    loss_reduction: str | None = None

    def batch_sums(self, total: torch.Tensor, aux: dict) -> dict:
        """The parts of `total` (key "total") and of each aux term that
        are sums over the batch's examples; the rest of each is a batch
        mean or independent of the batch. A data slice adds its sums whole
        and the rest by its share of the batch, so that the slices'
        gradients add up to the whole batch's (`parallel/train.py`).
        Raises where the loss does not split so."""
        if self.loss_reduction == "sum":
            return {"total": total, **aux}
        if self.loss_reduction == "mean":
            if "l2_loss" not in aux:
                return {}
            return {"total": self.l2_weight * aux["l2_loss"],
                    "l2_loss": aux["l2_loss"]}
        raise NotImplementedError(
            f"{type(self).__name__}'s loss does not split over data ranks "
            "(no loss_reduction); train it with one data rank")

    def grad_transform(self, grads: dict, batch: dict) -> dict:
        """Per-model gradient post-processing between autograd and the
        optimizer (`openrec_tpu/models/base.py:366-370`). Default:
        identity."""
        return grads

    def post_step(self, batch: dict, tables: dict | None = None) -> None:
        """Applied after each optimizer step, IN PLACE on the parameters
        (e.g. norm censoring; `openrec_tpu/models/base.py:360-364` returns
        new params instead). `tables` as in `loss`: a row-sharded table
        comes as a view (`parallel.ShardedTable`), which the functions of
        `modules/embedding.py` (`censor_norm_`) resolve; the step reaches
        it through `table`. Default: nothing."""

    def params(self) -> dict:
        """Flat {path: parameter}, keyed like the JAX params pytree."""
        return {name.replace(".", "/"): p
                for name, p in self.named_parameters()}

    @torch.no_grad()
    def load_params(self, flat: dict) -> None:
        """Copy a flat {path: tensor/array} dict (`convert.params_from_jax`,
        `checkpoint.restore`) into the parameters. Every parameter must be
        present with its shape."""
        for key, param in self.params().items():
            if key not in flat:
                raise KeyError(f"missing parameter '{key}'")
            value = torch.as_tensor(flat[key])
            if tuple(value.shape) != tuple(param.shape):
                raise ValueError(f"'{key}': shape {tuple(value.shape)} != "
                                 f"{tuple(param.shape)}")
            param.copy_(value)


class FactorRecommender(Recommender):
    """A recommender over `user_embed` [U, Du], `item_embed` [I, Di] and
    `item_bias` [I, 1] (zeros), serving u.V^T + b: BPR, PMF, WRMF, and the
    tables of GMF and UCML. `init(num, dim, generator=, device=)` makes
    each embedding table (default uniform(-0.05, 0.05)), users first."""

    def __init__(self, total_users: int, total_items: int,
                 dim_user_embed: int, dim_item_embed: int, device=None,
                 generator: torch.Generator | None = None,
                 init=embedding_init):
        super().__init__()
        dev = resolve_device(device)
        self.total_users = total_users
        self.total_items = total_items
        self.user_embed = nn.Parameter(init(
            total_users, dim_user_embed, generator=generator, device=dev))
        self.item_embed = nn.Parameter(init(
            total_items, dim_item_embed, generator=generator, device=dev))
        self.item_bias = nn.Parameter(
            torch.zeros((total_items, 1), device=dev))

    def score(self, batch: dict) -> torch.Tensor:
        user_vec = embedding_lookup(self.user_embed, batch["user_id"])
        return user_vec @ self.item_embed.T + self.item_bias.reshape(-1)
