"""Embedding tables as plain tensors + functions.

Counterpart of `openrec_tpu/modules/embedding.py`: uniform(-0.05, 0.05)
init, look-up, and norm censoring. A table is a [num, dim] tensor (an
`nn.Parameter` inside a model).
"""

from __future__ import annotations

import torch

from openrec_tpu_torch.device import resolve_device


def embedding_init(num: int, dim: int, zero_init: bool = False,
                   scale: float = 0.05, dtype=torch.float32,
                   generator: torch.Generator | None = None,
                   device=None) -> torch.Tensor:
    """Uniform(-scale, scale) like keras 'uniform', or zeros. `generator`
    must live on `device` (default CUDA)."""
    dev = resolve_device(device)
    table = torch.zeros((num, dim), dtype=dtype, device=dev)
    if not zero_init:
        table.uniform_(-scale, scale, generator=generator)
    return table


def embedding_lookup(table: torch.Tensor, ids) -> torch.Tensor:
    """Rows `ids` of `table`. Out-of-range ids CLAMP to the nearest row, as
    `jnp.take(mode="clip")` does (`openrec_tpu/modules/embedding.py:38`);
    `index_select` alone would raise on them."""
    ids = torch.as_tensor(ids, device=table.device)
    safe = ids.long().clamp(0, table.shape[0] - 1)
    return table.index_select(0, safe.reshape(-1)).reshape(
        *ids.shape, *table.shape[1:])


def censor_norm(table: torch.Tensor, ids, eps: float = 0.1) -> torch.Tensor:
    """New table with rows `ids` projected onto the unit ball:
    row /= max(||row||, eps). Duplicate ids are safe: the update is a pure
    function of the original row."""
    ids = torch.as_tensor(ids, device=table.device).long()
    rows = table.index_select(0, ids)
    norm = torch.linalg.vector_norm(rows, dim=-1, keepdim=True)
    return table.index_copy(0, ids, rows / torch.clamp(norm, min=eps))


def censor_max_norm(table: torch.Tensor, ids,
                    max_norm: float = 1.0) -> torch.Tensor:
    """New table with rows `ids` clipped to ||row|| <= max_norm."""
    ids = torch.as_tensor(ids, device=table.device).long()
    rows = table.index_select(0, ids)
    norm = torch.linalg.vector_norm(rows, dim=-1, keepdim=True)
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-12), max=1.0)
    return table.index_copy(0, ids, rows * scale)
