"""Recommender base class.

Counterpart of `openrec_tpu/models/base.py`. The JAX package passes a
params pytree into pure functions; here the parameters live on the
`nn.Module`, named by the JAX pytree's "/"-joined paths so that
`convert.params_from_jax` output and npz checkpoints load by name:

  model = BPR(..., device="cuda")
  loss, aux = model.loss(batch)         # autograd-able
  scores = model.score(batch)           # full-catalog serving
  model.load_params(flat)               # {path: tensor} from JAX / npz
  grads = model.grad_transform(grads, batch)   # trainer hooks, identity
  model.post_step(batch)                       # by default
"""

from __future__ import annotations

import torch
from torch import nn


class Recommender(nn.Module):
    """Base class; subclasses define loss/score."""

    def loss(self, batch: dict):
        """Returns (total_loss, aux_dict). aux carries per-part losses."""
        raise NotImplementedError

    def score(self, batch: dict) -> torch.Tensor:
        """Full-catalog scores [B, total_items] for serving/evaluation."""
        raise NotImplementedError

    def grad_transform(self, grads: dict, batch: dict) -> dict:
        """Per-model gradient post-processing between autograd and the
        optimizer (`openrec_tpu/models/base.py:366-370`). Default:
        identity."""
        return grads

    def post_step(self, batch: dict) -> None:
        """Applied after each optimizer step, IN PLACE on the parameters
        (e.g. norm censoring; `openrec_tpu/models/base.py:360-364` returns
        new params instead). Default: nothing."""

    def params(self) -> dict:
        """Flat {path: parameter}, keyed like the JAX params pytree."""
        return dict(self.named_parameters())

    @torch.no_grad()
    def load_params(self, flat: dict) -> None:
        """Copy a flat {path: tensor/array} dict (`convert.params_from_jax`,
        `checkpoint.restore`) into the parameters. Every parameter must be
        present with its shape."""
        for key, param in self.named_parameters():
            if key not in flat:
                raise KeyError(f"missing parameter '{key}'")
            value = torch.as_tensor(flat[key])
            if tuple(value.shape) != tuple(param.shape):
                raise ValueError(f"'{key}': shape {tuple(value.shape)} != "
                                 f"{tuple(param.shape)}")
            param.copy_(value)
