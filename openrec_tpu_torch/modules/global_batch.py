"""The global batch that a data-parallel step's loss stands for.

JAX's data-parallel step is one GSPMD program over the GLOBAL batch
(`openrec_tpu/parallel/train.py:58-69`): a random draw inside its loss
has the global batch's shape, and a batch norm takes the global batch's
statistics. Each rank of the port runs the loss on its slice. Inside
`data_parallel(...)`, which the step functions of `parallel/train.py`
enter around `model.loss` at more than one data rank, the modules read
here what the slice is a part of:

  - `rand(shape, generator, device)`: the float32 uniforms of a draw
    whose leading dim is the batch (a dropout mask, a corruption mask).
    Outside, `torch.rand(shape)`. Inside, `torch.rand([B_global, ...])`
    from the generator, which every rank seeds alike, and this rank's
    rows of it: every rank's generator advances alike, and each slice's
    mask is its part of the mask one rank draws for the whole batch.
  - `batch_moments(x)`: the mean and the biased variance over dim 0.
    Outside, `torch.mean` and `torch.var(correction=0)`. Inside, over the
    global batch in two passes, as `jnp.var` (the global mean, then the
    global sum of squared deviations), each a sum over the data group
    whose backward sums every rank's cotangent.

A draw whose shape does not depend on the batch (the sampled softmax's
candidates) needs only the generator that every rank shares.

`sharded_rows(...)` is the counterpart over 'model': a module applied to
this rank's row shard of a table (ItrMLP's MLP over its whole tables,
`update_embeddings`) stands for the module over the whole table, so
inside it `batch_moments` takes the statistics of the table's REAL rows,
this shard's summed over the group: the pad rows that make the table
split evenly enter no mean or variance. It draws nothing.
"""

from __future__ import annotations

from contextlib import contextmanager
from typing import Callable, NamedTuple, Optional

import torch


class DataParallel(NamedTuple):
    """This rank's place in the global batch: `index` of `size` data
    ranks, `batch` rows in all, and `all_sum`, a differentiable sum of a
    tensor over the data group."""
    size: int
    index: int
    batch: int
    all_sum: Callable[[torch.Tensor], torch.Tensor]


class ShardedRows(NamedTuple):
    """This rank's row shard of a table of `rows` real rows: `real` [n]
    marks the shard's real rows (False at pad rows), `all_sum` sums a
    tensor over the shards' group."""
    real: torch.Tensor
    rows: int
    all_sum: Callable[[torch.Tensor], torch.Tensor]


_current: Optional[DataParallel | ShardedRows] = None


@contextmanager
def data_parallel(size: int, index: int, batch: int,
                  all_sum: Callable[[torch.Tensor], torch.Tensor]):
    """Inside: the loss's modules draw and normalise over the global
    batch of `batch` rows, of which this rank holds slice `index` of
    `size`."""
    global _current
    if batch % size:
        raise ValueError(f"a batch of {batch} does not split over {size} "
                         "data ranks")
    outer, _current = _current, DataParallel(size, index, batch, all_sum)
    try:
        yield _current
    finally:
        _current = outer


@contextmanager
def sharded_rows(real: torch.Tensor, rows: int,
                 all_sum: Callable[[torch.Tensor], torch.Tensor]):
    """Inside: a batch norm over a row shard takes the statistics of the
    whole table's `rows` real rows (`real` marks this shard's)."""
    global _current
    outer, _current = _current, ShardedRows(real, rows, all_sum)
    try:
        yield _current
    finally:
        _current = outer


def _local_rows(ctx: DataParallel, n: int) -> slice:
    local = ctx.batch // ctx.size
    if n != local:
        raise ValueError(f"inside a data-parallel loss a batch tensor has "
                         f"{local} rows (of {ctx.batch}), not {n}")
    return slice(ctx.index * local, (ctx.index + 1) * local)


def rand(shape, generator: Optional[torch.Generator] = None,
         device=None) -> torch.Tensor:
    """Uniforms [0, 1) of `shape`, whose dim 0 is the batch: inside a
    data-parallel context this rank's rows of the global batch's draw."""
    shape = tuple(shape)
    ctx = _current
    if not isinstance(ctx, DataParallel):
        return torch.rand(shape, generator=generator, device=device)
    rows = _local_rows(ctx, shape[0])
    return torch.rand((ctx.batch,) + shape[1:], generator=generator,
                      device=device)[rows]


def batch_moments(x: torch.Tensor):
    """(mean, biased variance) over dim 0, keepdim: inside a data-parallel
    context, over the global batch; inside `sharded_rows`, over the whole
    table's real rows."""
    ctx = _current
    if ctx is None:
        return (torch.mean(x, dim=0, keepdim=True),
                torch.var(x, dim=0, keepdim=True, correction=0))
    if isinstance(ctx, ShardedRows):
        w = ctx.real.to(x.dtype)[:, None]
        mean = ctx.all_sum(torch.sum(x * w, dim=0, keepdim=True)) / ctx.rows
        var = ctx.all_sum(torch.sum(((x - mean) * w) ** 2, dim=0,
                                    keepdim=True)) / ctx.rows
        return mean, var
    _local_rows(ctx, x.shape[0])
    mean = ctx.all_sum(torch.sum(x, dim=0, keepdim=True)) / ctx.batch
    var = ctx.all_sum(torch.sum((x - mean) ** 2, dim=0, keepdim=True)) \
        / ctx.batch
    return mean, var
