"""Recurrent sequence encoders: GRU and LSTM over padded sequences.

Counterpart of `openrec_tpu/modules/rnn.py:21-104`. Each cell is written
as the JAX package writes it, one explicit step in a Python loop over the
L positions (JAX's `lax.scan`), not with `nn.GRU` / `nn.LSTM`: PyTorch's
GRU applies its reset gate after the recurrent product, r * (W_hn h +
b_hn), and returns (1 - z) * n + z * h, where the JAX cell multiplies
[x, r * h] by `wh` and returns (1 - z) * h + z * h~; no mapping of
weights makes the two equal. Each weight is [d_in + d_h, d_h] and
multiplies concat([x, h]); the LSTM's forget bias starts at 1.

The final state is the carry kept where t < seq_len: a step past a row's
length leaves its carry as it was (`torch.where`), so a row of length 0
returns zeros, as the padding rows of `TemporalEvaluationSampler` need.
"""

from __future__ import annotations

import torch
from torch import nn

from openrec_tpu_torch.device import resolve_device
from openrec_tpu_torch.modules.mlp import glorot_uniform


class _Cell(nn.Module):
    """Weights `w<gate>` [d_in + d_h, d_h] (glorot uniform) and biases
    `b<gate>` [d_h], named as in the JAX params dict."""

    GATES: tuple = ()

    def __init__(self, dim_in: int, dim_hidden: int, device=None,
                 generator: torch.Generator | None = None):
        super().__init__()
        dev = resolve_device(device)
        self.dim_in, self.dim_hidden = dim_in, dim_hidden
        for gate in self.GATES:
            setattr(self, f"w{gate}", nn.Parameter(glorot_uniform(
                (dim_in + dim_hidden, dim_hidden), generator=generator,
                device=dev)))
        for gate in self.GATES:
            setattr(self, f"b{gate}", nn.Parameter(torch.full(
                (dim_hidden,), 1.0 if gate == "f" else 0.0, device=dev)))

    def _gate(self, xh, gate):
        return xh @ getattr(self, f"w{gate}") + getattr(self, f"b{gate}")

    def _carry0(self, seq_vecs):
        return torch.zeros((seq_vecs.shape[0], self.dim_hidden),
                           dtype=seq_vecs.dtype, device=seq_vecs.device)

    def _keep(self, seq_vecs, seq_len):
        """[L, B, 1] bool: position t counts for row b (t < seq_len[b])."""
        L = seq_vecs.shape[1]
        seq_len = torch.as_tensor(seq_len, device=seq_vecs.device)
        return (torch.arange(L, device=seq_vecs.device)[:, None]
                < seq_len[None, :])[:, :, None]


class GRU(_Cell):
    GATES = ("z", "r", "h")

    def step(self, h, x):
        xh = torch.cat([x, h], dim=-1)
        z = torch.sigmoid(self._gate(xh, "z"))
        r = torch.sigmoid(self._gate(xh, "r"))
        h_tilde = torch.tanh(self._gate(torch.cat([x, r * h], dim=-1), "h"))
        return (1.0 - z) * h + z * h_tilde

    def forward(self, seq_vecs, seq_len):
        """seq_vecs: [B, L, D_in]; seq_len: [B] -> final valid state
        [B, H]."""
        keep = self._keep(seq_vecs, seq_len)
        h = self._carry0(seq_vecs)
        for t in range(seq_vecs.shape[1]):
            h = torch.where(keep[t], self.step(h, seq_vecs[:, t]), h)
        return h


class LSTM(_Cell):
    GATES = ("i", "f", "g", "o")

    def step(self, carry, x):
        h, c = carry
        xh = torch.cat([x, h], dim=-1)
        i = torch.sigmoid(self._gate(xh, "i"))
        f = torch.sigmoid(self._gate(xh, "f"))
        g = torch.tanh(self._gate(xh, "g"))
        o = torch.sigmoid(self._gate(xh, "o"))
        c_new = f * c + i * g
        return o * torch.tanh(c_new), c_new

    def forward(self, seq_vecs, seq_len):
        """seq_vecs: [B, L, D_in]; seq_len: [B] -> final valid hidden
        state [B, H]."""
        keep = self._keep(seq_vecs, seq_len)
        h = c = self._carry0(seq_vecs)
        for t in range(seq_vecs.shape[1]):
            h_new, c_new = self.step((h, c), seq_vecs[:, t])
            h = torch.where(keep[t], h_new, h)
            c = torch.where(keep[t], c_new, c)
        return h
