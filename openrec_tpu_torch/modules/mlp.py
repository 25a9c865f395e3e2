"""MLP stacks as `nn.Module`s.

Counterpart of `openrec_tpu/modules/mlp.py`: glorot-uniform kernels and
zero biases (keras Dense defaults), per-layer activation with a separate
output activation, and the tf1 MultiLayerFC extras: dropout after every
hidden layer in training, and batch norm over the batch axis with the
BIASED variance (`jnp.var`), epsilon 1e-5.

The MLP is a `ModuleList` of its layers, so the parameters of layer i
are `{i}.w`, `{i}.b`, `{i}.bn_scale` and `{i}.bn_bias` (`out_bias=False`
leaves the last layer without `b`, as the NCF models pop it from the JAX
tree, `openrec_tpu/models/ncf.py:59`);
`Recommender.params()` names them `{i}/w` ..., the JAX pytree's paths (a
list of dicts). Dropout draws its keep mask from a
`torch.Generator`: the bits cannot match JAX's threefry, only the keep
rate and the 1/keep scaling do.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from openrec_tpu_torch.device import resolve_device

_ACTIVATIONS = {
    None: lambda x: x,
    "linear": lambda x: x,
    "relu": torch.relu,
    "sigmoid": torch.sigmoid,
    "tanh": torch.tanh,
    # jax.nn.gelu defaults to the tanh approximation
    "gelu": lambda x: F.gelu(x, approximate="tanh"),
    "elu": F.elu,
    "softmax": lambda x: torch.softmax(x, dim=-1),
}


def activate(name, x):
    return _ACTIVATIONS[name](x)


def glorot_uniform(shape, generator: torch.Generator | None = None,
                   dtype=torch.float32, device=None) -> torch.Tensor:
    """Uniform(-l, l) with l = sqrt(6 / (fan_in + fan_out)) over the last
    two dims. `generator` must live on `device` (default CUDA)."""
    dev = resolve_device(device)
    limit = math.sqrt(6.0 / (shape[-2] + shape[-1]))
    return torch.empty(shape, dtype=dtype, device=dev).uniform_(
        -limit, limit, generator=generator)


class _Layer(nn.Module):
    """One layer's parameters (w, and b / bn_scale / bn_bias if used)."""


class MLP(nn.ModuleList):
    """units[i] outputs per layer; `forward(x, train=...)` applies it."""

    def __init__(self, in_dim: int, units: Sequence[int],
                 use_bias: bool = True, activation: Optional[str] = "relu",
                 out_activation: Optional[str] = None,
                 dropout_rate: Optional[float] = None,
                 batch_norm: bool = False, out_bias: bool = True,
                 device=None, generator: torch.Generator | None = None):
        super().__init__()
        dev = resolve_device(device)
        self.units = list(units)
        self.activation = activation
        self.out_activation = out_activation
        self.dropout_rate = dropout_rate
        self.batch_norm = batch_norm
        self.generator = generator
        dims = [in_dim] + self.units
        for i, (d_in, d_out) in enumerate(zip(dims[:-1], dims[1:])):
            layer = _Layer()
            layer.w = nn.Parameter(glorot_uniform(
                (d_in, d_out), generator=generator, device=dev))
            if use_bias and (out_bias or i < len(self.units) - 1):
                layer.b = nn.Parameter(torch.zeros(d_out, device=dev))
            if batch_norm:
                layer.bn_scale = nn.Parameter(torch.ones(d_out, device=dev))
                layer.bn_bias = nn.Parameter(torch.zeros(d_out, device=dev))
            self.append(layer)

    def forward(self, x: torch.Tensor, train: bool = False,
                generator: torch.Generator | None = None) -> torch.Tensor:
        """Weights are cast to x's dtype (bf16 compute keeps fp32
        parameters). Dropout in training draws from `generator`, else
        from the module's own."""
        n = len(self)
        for i, layer in enumerate(self):
            x = x @ layer.w.to(x.dtype)
            if hasattr(layer, "b"):
                x = x + layer.b.to(x.dtype)
            if self.batch_norm:
                mean = torch.mean(x, dim=0, keepdim=True)
                var = torch.var(x, dim=0, keepdim=True, correction=0)
                x = (x - mean) * torch.rsqrt(var + 1e-5)
                x = x * layer.bn_scale.to(x.dtype) \
                    + layer.bn_bias.to(x.dtype)
            x = activate(self.out_activation if i == n - 1
                         else self.activation, x)
            if self.dropout_rate and train and i < n - 1:
                gen = generator if generator is not None else self.generator
                if gen is None:
                    raise ValueError("dropout in training needs a generator")
                keep = 1.0 - self.dropout_rate
                mask = torch.rand(x.shape, generator=gen,
                                  device=x.device) < keep
                x = torch.where(mask, x / keep, 0.0)
        return x

    def l2(self) -> torch.Tensor:
        """Sum of tf.nn.l2_loss over kernels and biases (||.||^2 / 2)."""
        total = 0.0
        for layer in self:
            total = total + 0.5 * torch.sum(layer.w ** 2)
            if hasattr(layer, "b"):
                total = total + 0.5 * torch.sum(layer.b ** 2)
        return total
