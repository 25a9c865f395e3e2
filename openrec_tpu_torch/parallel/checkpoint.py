"""Per-rank (process-local) checkpoints with a manifest.

Counterpart of `openrec_tpu/parallel/checkpoint.py`, in the same on-disk
format, so that a checkpoint written by either package restores in the
other, into any mesh layout:

    <ckpt_dir>/ckpt-<step>/
        manifest.json        {"step", "process_count", "leaves": {key:
                             {"shape", "dtype"}}} (rank 0)
        shard-<rank>.npz     this rank's pieces, and under "__pieces__"
                             (JSON as uint8) its piece table: per piece
                             its leaf key, npz member and global offsets

Every rank writes only the blocks it holds, and a block held by several
ranks (a replicated leaf, a table's shard on every data rank) is written
once, by the rank at coordinate 0 of the mesh dims the leaf does not
split over (`Sharding.is_writer`, JAX's replica_id == 0). Restore reads,
for each leaf, the pieces overlapping this rank's block. Leaf keys are
the "/"-joined tree paths (`convert.flatten_tree`), as the JAX package
names them. `optimistic=True` keeps the template's value for a leaf
absent from the manifest or of another shape.
"""

from __future__ import annotations

import json
import os
import re
import shutil

import numpy as np
import torch
import torch.distributed as dist

from openrec_tpu_torch.convert import flatten_tree, unflatten_like


def _norm_index(block) -> list:
    return [[sl.start, sl.stop] for sl in block]


def _barrier():
    if dist.is_initialized() and dist.get_world_size() > 1:
        dist.barrier()


def save_sharded(ckpt_dir: str, step: int, tree, shardings,
                 max_to_keep: int = 10) -> str:
    """Write this rank's blocks of `tree` (a tree of this rank's local
    tensors) under `<ckpt_dir>/ckpt-<step>/`. `shardings`: {key: Sharding}
    keyed like `flatten_tree(tree)`. Rank 0 writes the manifest and prunes
    old steps; every rank returns after all have written."""
    step_dir = os.path.join(ckpt_dir, f"ckpt-{step}")
    os.makedirs(step_dir, exist_ok=True)
    rank = dist.get_rank() if dist.is_initialized() else 0
    world = dist.get_world_size() if dist.is_initialized() else 1
    pieces, arrays, leaves_meta = [], {}, {}
    for key, leaf in flatten_tree(tree).items():
        leaf = torch.as_tensor(leaf)
        sh = shardings[key]
        shape = sh.global_shape(tuple(leaf.shape))
        value = leaf.detach().cpu().numpy()
        leaves_meta[key] = {"shape": list(shape), "dtype": str(value.dtype)}
        if not sh.is_writer():
            continue
        member = f"piece{len(pieces)}"
        pieces.append({"key": key, "member": member,
                       "offsets": _norm_index(sh.block(shape))})
        arrays[member] = value
    arrays["__pieces__"] = np.frombuffer(json.dumps(pieces).encode(),
                                         dtype=np.uint8)
    np.savez(os.path.join(step_dir, f"shard-{rank}.npz"), **arrays)
    _barrier()
    if rank == 0:
        with open(os.path.join(step_dir, "manifest.json"), "w") as f:
            json.dump({"step": step, "process_count": world,
                       "leaves": leaves_meta}, f)
        if max_to_keep is not None:
            for old in sorted_steps(ckpt_dir)[:-max_to_keep]:
                shutil.rmtree(os.path.join(ckpt_dir, f"ckpt-{old}"),
                              ignore_errors=True)
    _barrier()
    return step_dir


def sorted_steps(ckpt_dir: str):
    if not os.path.isdir(ckpt_dir):
        return []
    steps = [int(m.group(1)) for d in os.listdir(ckpt_dir)
             if (m := re.fullmatch(r"ckpt-(\d+)", d))
             and os.path.isdir(os.path.join(ckpt_dir, d))]
    return sorted(steps)


def latest_step(ckpt_dir: str):
    steps = sorted_steps(ckpt_dir)
    return steps[-1] if steps else None


class _PieceReader:
    """Opens a step's shard files; assembles any global block of a leaf."""

    def __init__(self, step_dir: str):
        self._files = {}
        self.by_key = {}          # key -> [(fname, member, offsets)]
        for fname in sorted(os.listdir(step_dir)):
            if not re.fullmatch(r"shard-\d+\.npz", fname):
                continue
            npz = np.load(os.path.join(step_dir, fname))
            self._files[fname] = npz
            for p in json.loads(bytes(npz["__pieces__"]).decode()):
                self.by_key.setdefault(p["key"], []).append(
                    (fname, p["member"], p["offsets"]))

    def read_block(self, key, block, dtype):
        starts = [sl.start for sl in block]
        stops = [sl.stop for sl in block]
        out = np.empty([b - a for a, b in zip(starts, stops)], dtype)
        filled = 0
        for fname, member, offsets in self.by_key[key]:
            lo = [max(a, o[0]) for a, o in zip(starts, offsets)]
            hi = [min(b, o[1]) for b, o in zip(stops, offsets)]
            if any(a >= b for a, b in zip(lo, hi)):
                continue
            piece = self._files[fname][member]
            src = tuple(slice(a - o[0], b - o[0])
                        for a, b, o in zip(lo, hi, offsets))
            dst = tuple(slice(a - s, b - s)
                        for a, b, s in zip(lo, hi, starts))
            out[dst] = piece[src]
            filled += int(np.prod([b - a for a, b in zip(lo, hi)]))
        if filled < out.size:
            raise ValueError(f"checkpoint pieces do not cover block {block} "
                             f"of '{key}'")
        return out

    def close(self):
        for npz in self._files.values():
            npz.close()


def restore_sharded(step_dir: str, template, shardings,
                    optimistic: bool = False):
    """The checkpoint in `template`'s structure, each leaf this rank's
    block of it under `shardings` ({key: Sharding} keyed like
    `flatten_tree(template)`), on the template leaf's device and dtype.
    The mesh may differ from the one that saved it. Raises KeyError for a
    leaf absent from the manifest (or of another shape) unless
    optimistic=True, which keeps the template's value."""
    with open(os.path.join(step_dir, "manifest.json")) as f:
        manifest = json.load(f)
    reader = _PieceReader(step_dir)
    try:
        flat = {}
        for key, leaf in flatten_tree(template).items():
            leaf = torch.as_tensor(leaf)
            sh = shardings[key]
            shape = sh.global_shape(tuple(leaf.shape))
            meta = manifest["leaves"].get(key)
            if meta is None or tuple(meta["shape"]) != shape:
                if optimistic:
                    flat[key] = leaf
                    continue
                raise KeyError(
                    f"checkpoint {step_dir} is missing '{key}' (or shape "
                    "mismatch); use optimistic=True for partial restore")
            block = reader.read_block(key, sh.block(shape),
                                      np.dtype(meta["dtype"]))
            flat[key] = torch.as_tensor(block).to(device=leaf.device,
                                                  dtype=leaf.dtype)
        return unflatten_like(template, flat)
    finally:
        reader.close()
