"""Stacked denoising autoencoder (CDL's item-content pathway).

Counterpart of `openrec_tpu/modules/sdae.py:20-50`: an encoder MLP over
`dims` (relu hidden layers, a linear code layer), a decoder MLP over
dims[-2::-1] + [in_dim] (mirrored), input corruption by dropout, and the
reconstruction term l2_reconst * ||dec(enc(x~)) - x||^2. Parameters are
`encoder/{i}/w|b` and `decoder/{i}/w|b`, the JAX tree's paths. The
corruption mask draws from the generator given to `reconstruction_loss`
(the same keep rate and 1/keep scaling as JAX's, not its bits); without
one nothing is corrupted, as there.
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from openrec_tpu_torch.modules.mlp import MLP


class SDAE(nn.Module):
    def __init__(self, in_dim: int, dims: Sequence[int], dropout: float = 0.0,
                 l2_reconst: float = 1.0, device=None,
                 generator: torch.Generator | None = None):
        super().__init__()
        dims = list(dims)
        self.dropout = dropout
        self.l2_reconst = l2_reconst
        self.encoder = MLP(in_dim, dims, activation="relu",
                           out_activation=None, device=device,
                           generator=generator)
        self.decoder = MLP(dims[-1], dims[-2::-1] + [in_dim],
                           activation="relu", out_activation=None,
                           device=device, generator=generator)

    def encode(self, x: torch.Tensor) -> torch.Tensor:
        return self.encoder(x)

    def reconstruction_loss(self, x: torch.Tensor,
                            generator: torch.Generator | None = None):
        """(l2_reconst * ||dec(enc(x~)) - x||^2, enc(x~)), x~ = x with
        each entry dropped at rate `dropout` (kept ones scaled by 1/keep)
        when a generator is given."""
        corrupted = x
        if self.dropout > 0.0 and generator is not None:
            keep = 1.0 - self.dropout
            mask = torch.rand(x.shape, generator=generator,
                              device=x.device) < keep
            corrupted = torch.where(mask, x / keep, 0.0)
        code = self.encode(corrupted)
        recon = self.decoder(code)
        return self.l2_reconst * torch.sum((recon - x) ** 2), code
