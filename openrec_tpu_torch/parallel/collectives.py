"""The collectives that join shards, with the gradients autograd needs.

Each JAX `shard_map` body of `openrec_tpu/parallel/` becomes a
shard-local function on plain tensors plus one of these collectives over
a mesh dim's process group. The backward of each is the transpose the
JAX package's docstrings state (`parallel/embedding.py:1-12`,
`parallel/bucketed.py:17-20`), with shard_map's rule for a result that is
replicated over the group (the same value on every rank, so the same
cotangent): the summed cotangents are divided by the group's size.

  all_reduce (psum)  -> backward: all_reduce, / group size
  all_gather         -> backward: reduce-scatter (all_reduce, then this
                        rank's chunk), / group size
  all_to_all         -> backward: all_to_all (no division: each rank's
                        result is its own)
  data_sum           -> backward: all_reduce (no division: each rank's
                        loss is its own part of the global batch's, so
                        the cotangents of a global statistic add up)
  replicated         -> forward: the identity; backward: all_reduce (a
                        value the same on every rank entering work that
                        each rank does on its own shard, whose cotangent
                        is this rank's part of the whole: shard_map's
                        pvary, Megatron's "copy to the parallel region")

A group of one rank is the identity both ways, so a 1 x 1 mesh computes
bit for bit what one device does. gloo (CPU) and NCCL (CUDA) both run
them.
"""

from __future__ import annotations

import torch
import torch.distributed as dist


def group_size(group) -> int:
    return dist.get_world_size(group)


class _AllReduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        x = x.clone()
        dist.all_reduce(x, group=group)
        return x

    @staticmethod
    def backward(ctx, ct):
        ct = ct.contiguous().clone()
        dist.all_reduce(ct, group=ctx.group)
        return ct / group_size(ctx.group), None


class _DataSum(_AllReduce):
    @staticmethod
    def backward(ctx, ct):
        ct = ct.contiguous().clone()
        dist.all_reduce(ct, group=ctx.group)
        return ct, None


class _Replicated(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.clone()

    @staticmethod
    def backward(ctx, ct):
        ct = ct.contiguous().clone()
        dist.all_reduce(ct, group=ctx.group)
        return ct, None


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        n = group_size(group)
        parts = [torch.empty_like(x) for _ in range(n)]
        dist.all_gather(parts, x.contiguous(), group=group)
        ctx.chunk = x.shape[0]
        return torch.cat(parts)

    @staticmethod
    def backward(ctx, ct):
        ct = ct.contiguous().clone()
        dist.all_reduce(ct, group=ctx.group)
        r = dist.get_rank(ctx.group)
        mine = ct[r * ctx.chunk:(r + 1) * ctx.chunk]
        return mine / group_size(ctx.group), None


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        out = torch.empty_like(x)
        dist.all_to_all_single(out, x.contiguous(), group=group)
        return out

    @staticmethod
    def backward(ctx, ct):
        out = torch.empty_like(ct)
        dist.all_to_all_single(out, ct.contiguous(), group=ctx.group)
        return out, None


def all_reduce(x: torch.Tensor, group) -> torch.Tensor:
    """Sum over the group (lax.psum), differentiable."""
    if group_size(group) == 1:
        return x
    return _AllReduce.apply(x, group)


def data_sum(x: torch.Tensor, group) -> torch.Tensor:
    """Sum over the data group of a statistic of the global batch (a
    batch norm's sums), differentiable: the backward sums every rank's
    cotangent, since each rank's loss is its own slice's part of the
    global batch's. At one rank the identity, with no collective."""
    if group_size(group) == 1:
        return x
    return _DataSum.apply(x, group)


def replicated(x: torch.Tensor, group) -> torch.Tensor:
    """`x`, the same on every rank of the group, as the input of
    shard-local work (a row block of logits): the identity, whose backward
    sums the ranks' partial cotangents into the whole one. At one rank the
    identity both ways."""
    if group_size(group) == 1:
        return x
    return _Replicated.apply(x, group)


def all_max(x: torch.Tensor, group) -> torch.Tensor:
    """Elementwise max over the group (lax.pmax), no gradient."""
    if group_size(group) == 1:
        return x
    x = x.detach().clone()
    dist.all_reduce(x, op=dist.ReduceOp.MAX, group=group)
    return x


def all_gather(x: torch.Tensor, group) -> torch.Tensor:
    """The group's tensors concatenated along dim 0 in rank order
    (lax.all_gather, tiled), differentiable."""
    if group_size(group) == 1:
        return x
    return _AllGather.apply(x, group)


def all_to_all(x: torch.Tensor, group) -> torch.Tensor:
    """Dim 0 split in group-size chunks, chunk j sent to rank j, received
    chunks concatenated in rank order (lax.all_to_all, tiled),
    differentiable."""
    if group_size(group) == 1:
        return x
    return _AllToAll.apply(x, group)


def all_gather_last(x: torch.Tensor, group) -> torch.Tensor:
    """Concatenation along the LAST dim, no gradient (top-k candidates)."""
    if group_size(group) == 1:
        return x
    parts = [torch.empty_like(x) for _ in range(group_size(group))]
    dist.all_gather(parts, x.contiguous(), group=group)
    return torch.cat(parts, dim=-1)


def all_reduce_sum(tensors: list, group) -> list:
    """Each tensor summed over the group, in one collective per dtype on
    one flat buffer; no gradient."""
    out = list(tensors)
    if group_size(group) == 1:
        return out
    by_dtype = {}
    for i, t in enumerate(tensors):
        by_dtype.setdefault(t.dtype, []).append(i)
    for idx in by_dtype.values():
        flat = torch.cat([tensors[i].reshape(-1) for i in idx])
        dist.all_reduce(flat, group=group)
        at = 0
        for i in idx:
            n = tensors[i].numel()
            out[i] = flat[at:at + n].reshape(tensors[i].shape)
            at += n
    return out
