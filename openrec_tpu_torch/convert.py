"""Carry parameters between the JAX package and the port, through numpy.

The JAX side hands over its params pytree with its leaves as numpy arrays
(`jax.tree.map(np.asarray, params)`, built by the caller); this module
never imports JAX. Keys are the "/"-joined tree paths that
`openrec_tpu/checkpoint.py:_flatten` writes into its npz checkpoints, so
`params_from_jax(tree)` and a restored checkpoint name every tensor alike
(`{"user_embed": ..., "item_embed": ..., "item_bias": ...}` for BPR).
"""

from __future__ import annotations

import numpy as np
import torch

from openrec_tpu_torch.device import resolve_device


def flatten_tree(tree, prefix: str = "") -> dict:
    """Nested dicts / lists / tuples -> {"a/b/0": leaf}. Dict keys are
    visited in sorted order, as jax.tree_util does."""
    if isinstance(tree, dict):
        items = sorted(tree.items(), key=lambda kv: str(kv[0]))
    elif isinstance(tree, (list, tuple)):
        items = list(enumerate(tree))
    else:
        return {prefix: tree}
    flat = {}
    for key, sub in items:
        flat.update(flatten_tree(sub, f"{prefix}/{key}" if prefix
                                 else str(key)))
    return flat


def params_from_jax(tree, device=None) -> dict:
    """Flat {path: tensor} on `device` (default CUDA) from a JAX params
    pytree whose leaves are numpy arrays. dtypes are kept."""
    dev = resolve_device(device)
    # np.require copies only arrays that are read-only (as exported JAX
    # arrays are): torch wants writable memory
    return {k: torch.as_tensor(np.require(v, requirements="W")).to(dev)
            for k, v in flatten_tree(tree).items()}


def params_to_numpy(flat: dict) -> dict:
    """Inverse of `params_from_jax`: {path: tensor} -> nested dicts of
    numpy arrays (sequence levels come back as dicts keyed "0", "1", ...)."""
    tree: dict = {}
    for key, value in flat.items():
        node = tree
        *parents, leaf = key.split("/")
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = value.detach().cpu().numpy() \
            if isinstance(value, torch.Tensor) else np.asarray(value)
    return tree
