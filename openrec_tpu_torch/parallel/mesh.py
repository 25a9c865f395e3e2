"""Process mesh and placement rules.

Counterpart of `openrec_tpu/parallel/mesh.py`. JAX runs one process over
a mesh of devices; here every rank is a process of its own
(`torch.distributed`), one device each, and the mesh is a
`torch.distributed.device_mesh.DeviceMesh` with the dims

  'data'  - the batch: each data rank computes its slice of the global
            batch and gradients are summed over 'data';
  'model' - embedding rows: a table's rows split evenly over 'model', and
            lookups join the shards with a collective.

A JAX `NamedSharding` becomes a placement rule, `Sharding(mesh, spec,
shape)`: `spec` names, per dimension of a leaf, the mesh dim it splits
over (or None), `shape` is the leaf's real global shape, and
`block(shape)` says which block of the leaf this rank holds.
NCCL joins CUDA ranks (the default); gloo joins CPU ranks, and CUDA
ranks on request (`backend="gloo"`).
"""

from __future__ import annotations

import os
import re
import socket
from typing import NamedTuple, Optional, Sequence

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from openrec_tpu_torch.device import resolve_device

DATA_AXIS = "data"
MODEL_AXIS = "model"


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def initialize_multihost(coordinator_address: Optional[str] = None,
                         num_processes: Optional[int] = None,
                         process_id: Optional[int] = None, device=None,
                         backend: Optional[str] = None):
    """Join the job's process group; returns (rank, world size).

    Without arguments the launcher's environment names them (`torchrun`
    sets RANK, WORLD_SIZE, MASTER_ADDR, MASTER_PORT); with none of that a
    process is a job of one, on a free localhost port. CUDA ranks take the
    card LOCAL_RANK (default rank) mod the cards. `backend` defaults to
    NCCL on CUDA and gloo on the CPU; backend="gloo" lets CUDA ranks join
    over the host (several ranks on one card, which NCCL refuses). Raises
    without CUDA unless device="cpu"."""
    dev = resolve_device(device)
    if dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    env = os.environ
    rank = int(process_id if process_id is not None
               else env.get("RANK", 0))
    world = int(num_processes if num_processes is not None
                else env.get("WORLD_SIZE", 1))
    if coordinator_address is None:
        if "MASTER_ADDR" in env and "MASTER_PORT" in env:
            coordinator_address = \
                f"{env['MASTER_ADDR']}:{env['MASTER_PORT']}"
        elif world == 1:
            coordinator_address = f"127.0.0.1:{_free_port()}"
        else:
            raise RuntimeError("no coordinator address: pass one or launch "
                               "with torchrun")
    if dev.type == "cuda":
        local = int(env.get("LOCAL_RANK", rank))
        torch.cuda.set_device(local % torch.cuda.device_count())
    if backend is None:
        backend = "nccl" if dev.type == "cuda" else "gloo"
    dist.init_process_group(
        backend,
        init_method=f"tcp://{coordinator_address}", rank=rank,
        world_size=world)
    return rank, world


def make_mesh(data: Optional[int] = None, model: int = 1,
              device=None, backend: Optional[str] = None) -> DeviceMesh:
    """A ('data', 'model') DeviceMesh over the job's ranks (joining the job
    first, `initialize_multihost`, over `backend`); 'data' absorbs the
    remainder. Raises without CUDA unless device="cpu"."""
    dev = resolve_device(device)
    _, world = initialize_multihost(device=dev, backend=backend)
    if data is None:
        if world % model:
            raise ValueError(f"{world} ranks do not split over model={model}")
        data = world // model
    if data * model != world:
        raise ValueError(f"{data}x{model} != {world} ranks")
    return init_device_mesh(dev.type, (data, model),
                            mesh_dim_names=(DATA_AXIS, MODEL_AXIS))


def mesh_device(mesh: DeviceMesh) -> torch.device:
    """The device this rank computes on."""
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


def axis_size(mesh: DeviceMesh, axis: str) -> int:
    return mesh.size(mesh.mesh_dim_names.index(axis))


def axis_index(mesh: DeviceMesh, axis: str) -> int:
    """This rank's coordinate along `axis` (lax.axis_index)."""
    return mesh.get_local_rank(axis)


def axis_group(mesh: DeviceMesh, axis: str):
    return mesh.get_group(axis)


class Sharding(NamedTuple):
    """Which block of a leaf this rank holds: dimension i splits evenly
    over the mesh dim spec[i] (None or missing: whole). `shape`: the
    leaf's global shape before `pad_to` appended rows."""
    mesh: DeviceMesh
    spec: tuple
    shape: tuple

    def axes(self):
        return [a for a in self.spec if a is not None]

    def block(self, shape) -> tuple:
        """This rank's block of a leaf of global `shape`, as slices."""
        out = []
        for i, n in enumerate(shape):
            a = self.spec[i] if i < len(self.spec) else None
            if a is None:
                out.append(slice(0, n))
                continue
            m = axis_size(self.mesh, a)
            if n % m:
                raise ValueError(f"dim {i} of {tuple(shape)} does not split "
                                 f"over '{a}' of size {m}")
            r = axis_index(self.mesh, a)
            out.append(slice(r * (n // m), (r + 1) * (n // m)))
        return tuple(out)

    def global_shape(self, local_shape) -> tuple:
        return tuple(n * (axis_size(self.mesh, self.spec[i])
                          if i < len(self.spec) and self.spec[i] else 1)
                     for i, n in enumerate(local_shape))

    def is_writer(self) -> bool:
        """True on exactly one rank per distinct block: the one at
        coordinate 0 of every mesh dim the leaf does not split over (JAX's
        replica_id == 0)."""
        return all(axis_index(self.mesh, a) == 0
                   for a in self.mesh.mesh_dim_names if a not in self.axes())


def batch_sharding(mesh: DeviceMesh, shape: tuple) -> Sharding:
    """The leading (batch) dim over 'data', the rest whole."""
    return Sharding(mesh, (DATA_AXIS,), tuple(shape))


def replicated(mesh: DeviceMesh, shape: tuple) -> Sharding:
    return Sharding(mesh, (), tuple(shape))


def row_sharding(mesh: DeviceMesh, shape: tuple) -> Sharding:
    """Rows (dim 0) over 'model': embedding tables."""
    return Sharding(mesh, (MODEL_AXIS, None), tuple(shape))


# Shard every embedding table's rows over 'model', replicate dense towers:
# the whole zoo (tables are named *_embed / embed_tables / out_weight).
DEFAULT_RULES = (
    (r"(item_embed|user_embed|embed_tables/\d+|embed_fused|out_weight"
     r"|item_bias)", (MODEL_AXIS, None)),
    (r"out_bias", (MODEL_AXIS,)),
)


def match_partition_rules(rules: Sequence, params: dict,
                          mesh: DeviceMesh) -> dict:
    """{name: Sharding} for a flat {name: tensor} dict: the first rule
    whose regex matches the "/"-path wins; scalars and 1-element leaves
    replicate. rules: (pattern, spec tuple) pairs."""
    out = {}
    for name, leaf in params.items():
        spec = ()
        if leaf.dim() > 0 and leaf.numel() > 1:
            for pattern, ps in rules:
                if re.search(pattern, name):
                    spec = tuple(ps)
                    break
        out[name] = Sharding(mesh, spec, tuple(leaf.shape))
    return out


def pad_to(leaf: torch.Tensor, sharding: Sharding) -> torch.Tensor:
    """`leaf` with zero rows appended so that every split dim divides
    evenly (`embedding.pad_rows`); unchanged when it already does."""
    pads = []
    for i, a in enumerate(sharding.spec):
        if a is None:
            continue
        m = axis_size(sharding.mesh, a)
        pads.append((i, -leaf.shape[i] % m))
    for i, p in pads:
        if p:
            shape = list(leaf.shape)
            shape[i] = p
            leaf = torch.cat([leaf, leaf.new_zeros(shape)], dim=i)
    return leaf


def shard_params(params: dict, mesh: DeviceMesh, rules=DEFAULT_RULES):
    """({name: this rank's block}, {name: Sharding}) from full parameters:
    each leaf is padded to split evenly, then sliced to this rank's
    block (a fresh contiguous tensor)."""
    shardings = match_partition_rules(rules, params, mesh)
    local = {}
    for name, leaf in params.items():
        full = pad_to(leaf.detach(), shardings[name])
        local[name] = full[shardings[name].block(full.shape)].contiguous()
    return local, shardings


def shard_tree(tree, shardings: dict):
    """`tree` (an optimizer state: dicts, NamedTuples, tuples) with every
    tensor stored under a parameter's name, or under its path tuple as in
    the sparse step's state, cut to this rank's block of that parameter
    (`shard_params`); everything else as it is."""
    if isinstance(tree, dict):
        out = {}
        for key, value in tree.items():
            name = key if isinstance(key, str) else (
                "/".join(map(str, key)) if isinstance(key, tuple) else None)
            sh = shardings.get(name)
            if sh is not None and isinstance(value, torch.Tensor):
                full = pad_to(value, sh)
                out[key] = full[sh.block(full.shape)].contiguous()
            else:
                out[key] = shard_tree(value, shardings)
        return out
    if hasattr(tree, "_fields"):
        return type(tree)(*(shard_tree(v, shardings) for v in tree))
    if isinstance(tree, (list, tuple)):
        return type(tree)(shard_tree(v, shardings) for v in tree)
    return tree


def shard_model(model, mesh: DeviceMesh, rules=DEFAULT_RULES) -> dict:
    """Shard a model's own parameters IN PLACE: each becomes this rank's
    block of it (`shard_params`), on the mesh's device. Returns
    {name: Sharding}. A model whose tables are sharded must reach them
    through `Recommender.table` / `lookup`, so that the distribution
    layer can hand it a sharded view."""
    local, shardings = shard_params(model.params(), mesh, rules)
    dev = mesh_device(mesh)
    with torch.no_grad():
        for name, p in model.params().items():
            p.data = local[name].to(dev)
    return shardings
