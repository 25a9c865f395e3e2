"""Interaction blocks.

Counterpart of `openrec_tpu/modules/interactions.py`:
`second_order_interaction` (`:21-33`), the DLRM pairwise dot
interaction. One batched product gives the Gram matrix [B, F, F]; the
pairs are its upper-triangle entries in row-major order, which
`torch.triu_indices(F, F, offset=k)` gives in the same order as
`np.triu_indices(F, k)`. And `masked_mean_pool` (`:36-46`), the mean of
a sequence's first seq_len vectors, over `masked_sum`, which
VanillaYouTubeRec divides by L instead (`models/sequence.py`).

`LowRankCrossNet` is the port's own (the JAX package has no DCN): the
low-rank cross network of DCN-V2 (Wang et al., arXiv:2008.13535,
section 3), as TorchRec's `LowRankCrossNet` computes it,
x_{l+1} = x0 * (W_l (V_l x_l) + b_l) + x_l, with the weights stored
[in, out] as the port's MLPs store them.
"""

from __future__ import annotations

import torch
from torch import nn

from openrec_tpu_torch.device import resolve_device
from openrec_tpu_torch.modules.mlp import glorot_uniform


def second_order_interaction(features, self_interaction: bool = False):
    """Pairwise dot products between feature vectors.

    features: [B, F, D] stacked features (or a list of [B, D]).
    Returns [B, F*(F-1)/2] (or F*(F+1)/2 with self_interaction)."""
    if isinstance(features, (list, tuple)):
        features = torch.stack(features, dim=1)
    gram = torch.bmm(features, features.transpose(1, 2))
    F = features.shape[1]
    iu = torch.triu_indices(F, F, offset=0 if self_interaction else 1,
                            device=features.device)
    return gram[:, iu[0], iu[1]]


def masked_sum(seq_vecs, seq_len):
    """Sum over the first seq_len positions of each row.

    seq_vecs: [B, L, D]; seq_len: [B] int. Returns [B, D]."""
    L = seq_vecs.shape[1]
    seq_len = torch.as_tensor(seq_len, device=seq_vecs.device)
    mask = (torch.arange(L, device=seq_vecs.device)[None, :]
            < seq_len[:, None]).to(seq_vecs.dtype)
    return torch.sum(seq_vecs * mask[:, :, None], dim=1)


def masked_mean_pool(seq_vecs, seq_len):
    """Mean over the first seq_len positions of each row, divided by
    max(seq_len, 1) (tf1 mlp_softmax.py:13-15).

    seq_vecs: [B, L, D]; seq_len: [B] int. Returns [B, D]."""
    seq_len = torch.as_tensor(seq_len, device=seq_vecs.device)
    denom = torch.clamp(seq_len.to(seq_vecs.dtype), min=1.0)
    return masked_sum(seq_vecs, seq_len) / denom[:, None]


class _CrossLayer(nn.Module):
    """One cross layer's parameters: v [d, r], w [r, d], b [d]."""


class LowRankCrossNet(nn.ModuleList):
    """`layers` cross layers of rank `rank` over d-wide inputs; layer l's
    parameters are `{l}.v` [d, r], `{l}.w` [r, d], `{l}.b` [d]
    (glorot-uniform kernels, a zero bias, as the port's MLPs).
    `forward(x0)` [B, d] casts them to x0's dtype and returns x_L."""

    def __init__(self, d: int, layers: int, rank: int, device=None,
                 generator: torch.Generator | None = None):
        super().__init__()
        dev = resolve_device(device)
        for _ in range(layers):
            layer = _CrossLayer()
            layer.v = nn.Parameter(glorot_uniform((d, rank),
                                                  generator=generator,
                                                  device=dev))
            layer.w = nn.Parameter(glorot_uniform((rank, d),
                                                  generator=generator,
                                                  device=dev))
            layer.b = nn.Parameter(torch.zeros(d, device=dev))
            self.append(layer)

    def forward(self, x0: torch.Tensor) -> torch.Tensor:
        x = x0
        for layer in self:
            x = x0 * ((x @ layer.v.to(x.dtype)) @ layer.w.to(x.dtype)
                      + layer.b.to(x.dtype)) + x
        return x
