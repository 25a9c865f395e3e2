"""Embedding tables as plain tensors + functions.

Counterpart of `openrec_tpu/modules/embedding.py`: uniform(-0.05, 0.05)
init (and tf1's 'normal' init, 0.01 times a truncated normal), look-up,
and norm censoring (also in place, for a model's `post_step`). A table
is a [num, dim] tensor (an `nn.Parameter` inside a model), or a view
that carries its own method of a function's name, which the function
resolves (`training.sparse.SubTable`'s `lookup`; a row shard,
`parallel.ShardedTable`). `embedding_bags` sums bags of rows (the
multi-hot DLRM's sum pooling) in one `embedding_bag` call for all bags.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

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


def normal_embed(num: int, dim: int, generator=None, device=None):
    """0.01 * truncated_normal(-2, 2) [num, dim] (tf1 LatentFactor's
    'normal' init; the sequence models' and ItrMLP's tables)."""
    table = torch.empty((num, dim), device=resolve_device(device))
    return 0.01 * torch.nn.init.trunc_normal_(table, generator=generator)


def embedding_lookup(table: torch.Tensor, ids) -> torch.Tensor:
    """Rows `ids` of `table`. Out-of-range ids CLAMP to the nearest row, as
    `jnp.take(mode="clip")` does (`openrec_tpu/modules/embedding.py:38`);
    `index_select` alone would raise on them. A view that carries its own
    `lookup` (`training.sparse.SubTable`) resolves the ids itself."""
    if hasattr(table, "lookup"):
        return table.lookup(ids)
    ids = torch.as_tensor(ids, device=table.device)
    safe = ids.long().clamp(0, table.shape[0] - 1)
    return table.index_select(0, safe.reshape(-1)).reshape(
        *ids.shape, *table.shape[1:])


def embedding_bags(table: torch.Tensor, ids,
                   offsets: torch.Tensor) -> torch.Tensor:
    """Sums of rows `ids` [N] of `table` over bags: bag j holds
    ids[offsets[j] : offsets[j + 1]] (the last runs to N; `offsets` an
    int64 tensor on the ids' device); [len(offsets), D]. One
    `embedding_bag` gathers and sums every bag, so the looked-up rows are
    never written out. Out-of-range ids clamp as in `embedding_lookup`. A
    gathered view (`training.sparse.SubTable`, `HashSubTable`) pools its
    own rows by its `bags`, the same `embedding_bag` over the ids' rows in
    the view, whose gradient `ops.view_grad` sums."""
    if hasattr(table, "bags"):
        return table.bags(ids, offsets)
    ids = torch.as_tensor(ids, device=table.device)
    safe = ids.long().clamp(0, table.shape[0] - 1).reshape(-1)
    return F.embedding_bag(safe, table, offsets, mode="sum")


def censor_norm_(table: torch.Tensor, ids, eps: float = 0.1) -> torch.Tensor:
    """Project rows `ids` of `table` onto the unit ball IN PLACE:
    row /= max(||row||, eps); returns `table`. Duplicate ids are safe: every
    copy of a row is computed from the original row before any is written,
    so whichever copy lands last (`index_copy_` leaves that open on CUDA)
    writes the same value. A view that carries its own `censor_norm_`
    (a row shard, `parallel.ShardedTable`) censors the ids in its rows."""
    if hasattr(table, "censor_norm_"):
        return table.censor_norm_(ids, eps)
    ids = torch.as_tensor(ids, device=table.device).long().reshape(-1)
    rows = table.index_select(0, ids)
    norm = torch.linalg.vector_norm(rows, dim=-1, keepdim=True)
    return table.index_copy_(0, ids, rows / torch.clamp(norm, min=eps))


def map_rows(fn, table: torch.Tensor) -> torch.Tensor:
    """fn(table): a module over the whole table (ItrMLP's MLPs). A view
    that carries its own `map_rows` (a row shard) runs fn over its rows,
    with the statistics of the whole table."""
    if hasattr(table, "map_rows"):
        return table.map_rows(fn)
    return fn(table)


def update_rows_(table: torch.Tensor, flag: torch.Tensor, fn):
    """table[flag > 0] <- fn(table)[flag > 0] IN PLACE, fn over the whole
    table (`map_rows`); `flag` [rows]. A view updates its own rows."""
    if hasattr(table, "update_rows_"):
        return table.update_rows_(flag, fn)
    return table.copy_(torch.where(flag[:, None] > 0, fn(table), table))


def serving_rows(table: torch.Tensor, pad: float = 0.0) -> torch.Tensor:
    """The table to serve from, detached. A view (a row shard) gives its
    rows, its pad rows at `pad`."""
    if hasattr(table, "serving_rows"):
        return table.serving_rows(pad)
    return table.detach()


def censor_norm(table: torch.Tensor, ids, eps: float = 0.1) -> torch.Tensor:
    """New table with rows `ids` projected onto the unit ball (the
    functional form of `censor_norm_`)."""
    return censor_norm_(table.clone(), ids, eps)


def censor_max_norm(table: torch.Tensor, ids,
                    max_norm: float = 1.0) -> torch.Tensor:
    """New table with rows `ids` clipped to ||row|| <= max_norm."""
    ids = torch.as_tensor(ids, device=table.device).long()
    rows = table.index_select(0, ids)
    norm = torch.linalg.vector_norm(rows, dim=-1, keepdim=True)
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-12), max=1.0)
    return table.index_copy(0, ids, rows * scale)
