"""Carry parameters between the JAX package and the port, through numpy.

The JAX side hands over its params pytree with its leaves as numpy arrays
(`jax.tree.map(np.asarray, params)`, built by the caller); this module
never imports JAX. Keys are the "/"-joined tree paths that
`openrec_tpu/checkpoint.py:_flatten` writes into its npz checkpoints, so
`params_from_jax(tree)` and a restored checkpoint name every tensor alike
(`{"user_embed": ..., "item_embed": ..., "item_bias": ...}` for BPR).

Optimizer states cross the same way: `opt_state_from_jax` takes the JAX
`LazyAdamState` (count, mu, nu; lazy_adam and keras_adam) or lazy_adagrad's
accumulator dict, with numpy leaves, and `opt_state_to_numpy` gives them
back as nested dicts. A NamedTuple level is keyed by its field names, as
JAX names it (`opt_state/count`, `opt_state/mu/item_embed`).
"""

from __future__ import annotations

import numpy as np
import torch

from openrec_tpu_torch.device import resolve_device


def _join(prefix, key):
    return f"{prefix}/{key}" if prefix else str(key)


def flatten_tree(tree, prefix: str = "") -> dict:
    """Nested dicts / NamedTuples / lists / tuples -> {"a/b/0": leaf}.
    Dict keys are visited in sorted order and NamedTuple levels are keyed
    by field name, as jax.tree_util does."""
    if isinstance(tree, dict):
        items = sorted(tree.items(), key=lambda kv: str(kv[0]))
    elif hasattr(tree, "_fields"):
        items = [(f, getattr(tree, f)) for f in tree._fields]
    elif isinstance(tree, (list, tuple)):
        items = list(enumerate(tree))
    else:
        return {prefix: tree}
    flat = {}
    for key, sub in items:
        flat.update(flatten_tree(sub, _join(prefix, key)))
    return flat


def unflatten_like(template, flat: dict, prefix: str = ""):
    """The tree of `template`'s structure with each leaf taken from
    `flat` under its `flatten_tree` path."""
    if isinstance(template, dict):
        return {k: unflatten_like(v, flat, _join(prefix, k))
                for k, v in template.items()}
    if hasattr(template, "_fields"):
        return type(template)(**{
            f: unflatten_like(getattr(template, f), flat, _join(prefix, f))
            for f in template._fields})
    if isinstance(template, (list, tuple)):
        return type(template)(unflatten_like(v, flat, _join(prefix, i))
                              for i, v in enumerate(template))
    return flat[prefix]


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


def opt_state_from_jax(state, device=None):
    """The port's optimizer state from a JAX one with numpy leaves
    (`jax.tree.map(np.asarray, opt_state)`): a `LazyAdamState` (count,
    mu, nu) for lazy_adam / keras_adam, a {name: tensor} dict for
    lazy_adagrad."""
    from openrec_tpu_torch.training.optim import LazyAdamState
    dev = resolve_device(device)
    if hasattr(state, "_fields"):
        return LazyAdamState(
            count=torch.as_tensor(np.array(state.count, np.int32)).to(dev),
            mu=params_from_jax(state.mu, dev),
            nu=params_from_jax(state.nu, dev))
    return params_from_jax(state, dev)


def opt_state_to_numpy(state) -> dict:
    """Inverse of `opt_state_from_jax`, as nested dicts of numpy arrays:
    {"count", "mu", "nu"} for the Adams (`LazyAdamState(**d)` on the JAX
    side), {name: accumulator} for lazy_adagrad."""
    return params_to_numpy(flatten_tree(state))
