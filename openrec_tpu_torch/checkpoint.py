"""npz checkpoints in the JAX package's format, with optimistic restore.

Counterpart of `openrec_tpu/checkpoint.py:42-102`: one
`<ckpt_dir>/ckpt-<step>.npz` per step holding the flattened parameters
under "/"-joined path keys, `max_to_keep` pruning, and `_optimistic_restore`
semantics (load only entries whose name AND shape match). The two packages
read each other's files.

Parameters here are a flat `{path: tensor}` dict (`convert.params_from_jax`,
`module.state_dict()`) or any nesting of dicts/NamedTuples/lists of tensors
or arrays. A `Trainer` checkpoint is the tree {"params": ..., "opt_state":
...}, written under the keys the JAX `Trainer.save` writes
(`openrec_tpu/checkpoint.py:24-39`): `params/<name>`, `opt_state/count`,
`opt_state/mu/<name>`, `opt_state/nu/<name>` (lazy_adagrad:
`opt_state/<name>`).
"""

from __future__ import annotations

import os
import re

import numpy as np
import torch

from openrec_tpu_torch.convert import flatten_tree
from openrec_tpu_torch.device import resolve_device


def _to_numpy(leaf):
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().cpu().numpy()
    return np.asarray(leaf)


def save(ckpt_dir: str, step: int, params, max_to_keep: int = 10) -> str:
    """Write `<ckpt_dir>/ckpt-<step>.npz`; prune old checkpoints."""
    os.makedirs(ckpt_dir, exist_ok=True)
    path = os.path.join(ckpt_dir, f"ckpt-{step}.npz")
    np.savez(path, **{k: _to_numpy(v)
                      for k, v in flatten_tree(params).items()})
    if max_to_keep is not None:
        kept = sorted_checkpoints(ckpt_dir)
        for old in kept[:-max_to_keep]:
            os.remove(os.path.join(ckpt_dir, old))
    return path


def sorted_checkpoints(ckpt_dir: str):
    if not os.path.isdir(ckpt_dir):
        return []
    files = [f for f in os.listdir(ckpt_dir)
             if re.fullmatch(r"ckpt-\d+\.npz", f)]
    return sorted(files, key=lambda f: int(re.findall(r"\d+", f)[0]))


def latest_checkpoint(ckpt_dir: str):
    ckpts = sorted_checkpoints(ckpt_dir)
    return os.path.join(ckpt_dir, ckpts[-1]) if ckpts else None


def latest_step(ckpt_dir: str):
    ckpts = sorted_checkpoints(ckpt_dir)
    return int(re.findall(r"\d+", ckpts[-1])[0]) if ckpts else None


def restore(path: str, template: dict | None = None,
            optimistic: bool = False, device=None) -> dict:
    """Load a checkpoint as a flat {path: tensor} dict.

    Without a template: every saved entry, on `device` (default CUDA).
    With a flat template ({path: tensor}, e.g. a `state_dict()`): the
    template's keys, each with the template tensor's dtype and device.
      - optimistic=False: every entry must be present with matching shape.
      - optimistic=True: entries present with matching name+shape are
        loaded, everything else keeps the template's value.
    """
    with np.load(path) as data:
        flat_saved = {k: data[k] for k in data.files}
    if template is None:
        dev = resolve_device(device)
        return {k: torch.as_tensor(v).to(dev) for k, v in flat_saved.items()}

    out = {}
    for key, leaf in template.items():
        saved = flat_saved.get(key)
        if saved is not None and saved.shape == tuple(leaf.shape):
            out[key] = torch.as_tensor(saved).to(device=leaf.device,
                                                 dtype=leaf.dtype)
        elif optimistic:
            out[key] = leaf
        else:
            raise KeyError(
                f"checkpoint {path} is missing '{key}' "
                f"(or shape mismatch); use optimistic=True for partial "
                "restore")
    return out
