"""Optimizers for embedding-table workloads, written out by hand.

Counterpart of `openrec_tpu/training/optim.py`, in the same functional
form as there: `tx = lazy_adam(lr)`, `state = tx.init(params)`,
`updates, state = tx.update(grads, state, params)`, then
`apply_updates(params, updates)`. `params`, `grads` and the moments are
flat `{name: tensor}` dicts, so a trainer checkpoint names the state as
the JAX package does: `opt_state/count`, `opt_state/mu/<name>`,
`opt_state/nu/<name>` for the Adams and `opt_state/<name>` for Adagrad.
State tensors live on the parameters' device.

Both Adams use the keras formulation, which `torch.optim.Adam` does not:
bias correction folded into the step size, alpha = lr*sqrt(c2)/c1 in
fp32 from an int32 step count, and eps = 1e-7 OUTSIDE the sqrt,
step = -alpha*m/(sqrt(v)+eps).

`adam` is optax's Adam (`optax.adam`), the sparse step's default for
the dense parameters (`openrec_tpu/training/sparse.py:489-490`): the
moments are bias-corrected, m_hat = m/(1 - b1^t), v_hat = v/(1 - b2^t),
and the step is -lr * m_hat/(sqrt(v_hat) + eps), eps default 1e-8. It
differs from the keras form at O(eps). Its state mirrors optax's chain
state, (ScaleByAdamState(count, mu, nu), EmptyState()), so a checkpoint
names it as the JAX package does (`opt_state/dense/0/mu/<name>`).

`lazy_adam` updates only the rows of table-shaped leaves (ndim >=
`min_sparse_ndim`) whose gradient row has any nonzero entry; untouched
rows keep their moments and parameters (a row that is in the batch but
got an all-zero gradient counts as untouched). The gradients are dense,
as JAX autodiff gives them (`index_select` backward). `keras_adam` decays
and applies the moments of every row on every step (TF/Keras Adam's
trajectory on sparse gradients). `lazy_adagrad` is the rows-touched
Adagrad.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from openrec_tpu_torch.device import resolve_device


class GradientTransformation(NamedTuple):
    init: Callable
    update: Callable


class LazyAdamState(NamedTuple):
    count: torch.Tensor      # int32 scalar on the parameters' device
    mu: dict
    nu: dict


class ScaleByAdamState(NamedTuple):
    count: torch.Tensor      # int32 scalar on the parameters' device
    mu: dict
    nu: dict


class EmptyState(NamedTuple):
    """optax's stateless link of a chain (scale_by_learning_rate)."""


def apply_updates(params: dict, updates: dict) -> dict:
    """params[name] += updates[name], in place (the parameters of a module
    stay the same tensors); returns params."""
    with torch.no_grad():
        for name, p in params.items():
            p.add_(updates[name])
    return params


def _device_of(params: dict, device=None) -> torch.device:
    """The parameters' device; `device` (default CUDA) for an empty tree."""
    for p in params.values():
        return p.device
    return resolve_device(device)


def _zeros(params: dict, device=None) -> dict:
    return {k: torch.zeros_like(p, memory_format=torch.contiguous_format)
            for k, p in params.items()}


def _touched(g):
    """[rows, 1, ...] bool: the row of g has any nonzero entry."""
    return (g != 0).reshape(g.shape[0], -1).any(dim=1).reshape(
        (g.shape[0],) + (1,) * (g.dim() - 1))


def _adam_alpha(count, learning_rate, b1, b2):
    c = count.to(torch.float32)
    c1 = 1.0 - b1 ** c
    c2 = 1.0 - b2 ** c
    return learning_rate * torch.sqrt(c2) / c1


def _adam_init(params, device=None):
    """Zero moments and count; `device` places the count of an empty
    tree (the sparse step's dense part when every parameter is a table)."""
    return LazyAdamState(
        count=torch.zeros([], dtype=torch.int32,
                          device=_device_of(params, device)),
        mu=_zeros(params), nu=_zeros(params))


def adam(learning_rate: float = 1e-3, b1: float = 0.9, b2: float = 0.999,
         eps: float = 1e-8) -> GradientTransformation:
    """optax.adam: chain(scale_by_adam, scale_by_learning_rate), dense."""

    def init_fn(params, device=None):
        state = _adam_init(params, device)
        return ScaleByAdamState(*state), EmptyState()

    def update_fn(grads, state, params=None):
        adam_state, empty = state
        count = adam_state.count + 1
        c = count.to(torch.float32)
        c1 = 1 - b1 ** c
        c2 = 1 - b2 ** c
        mu = {k: (1 - b1) * g + b1 * adam_state.mu[k]
              for k, g in grads.items()}
        nu = {k: (1 - b2) * g ** 2 + b2 * adam_state.nu[k]
              for k, g in grads.items()}
        updates = {k: -learning_rate * ((mu[k] / c1)
                                        / (torch.sqrt(nu[k] / c2) + eps))
                   for k in grads}
        return updates, (ScaleByAdamState(count=count, mu=mu, nu=nu), empty)

    return GradientTransformation(init_fn, update_fn)


def lazy_adam(learning_rate: float = 1e-3, b1: float = 0.9,
              b2: float = 0.999, eps: float = 1e-7,
              min_sparse_ndim: int = 2) -> GradientTransformation:
    """Adam with rows-touched (lazy) updates for table-shaped leaves."""

    def update_fn(grads, state, params=None):
        count = state.count + 1
        alpha = _adam_alpha(count, learning_rate, b1, b2)
        updates, mu, nu = {}, {}, {}
        for k, g in grads.items():
            m, n = state.mu[k], state.nu[k]
            if g.dim() >= min_sparse_ndim:
                touched = _touched(g)
                mu[k] = torch.where(touched, b1 * m + (1 - b1) * g, m)
                nu[k] = torch.where(touched, b2 * n + (1 - b2) * g * g, n)
                step = -alpha * mu[k] / (torch.sqrt(nu[k]) + eps)
                updates[k] = torch.where(touched, step, 0.0)
            else:
                mu[k] = b1 * m + (1 - b1) * g
                nu[k] = b2 * n + (1 - b2) * g * g
                updates[k] = -alpha * mu[k] / (torch.sqrt(nu[k]) + eps)
        return updates, LazyAdamState(count=count, mu=mu, nu=nu)

    return GradientTransformation(_adam_init, update_fn)


def keras_adam(learning_rate: float = 1e-3, b1: float = 0.9,
               b2: float = 0.999, eps: float = 1e-7
               ) -> GradientTransformation:
    """Dense Adam in the exact keras formulation."""

    def update_fn(grads, state, params=None):
        count = state.count + 1
        alpha = _adam_alpha(count, learning_rate, b1, b2)
        mu = {k: b1 * state.mu[k] + (1 - b1) * g for k, g in grads.items()}
        nu = {k: b2 * state.nu[k] + (1 - b2) * g * g
              for k, g in grads.items()}
        updates = {k: -alpha * mu[k] / (torch.sqrt(nu[k]) + eps)
                   for k in grads}
        return updates, LazyAdamState(count=count, mu=mu, nu=nu)

    return GradientTransformation(_adam_init, update_fn)


def lazy_adagrad(learning_rate: float = 0.1, eps: float = 1e-7,
                 min_sparse_ndim: int = 2) -> GradientTransformation:
    """Rows-touched Adagrad; the state is the {name: accumulator} dict."""

    def update_fn(grads, state, params=None):
        updates, acc = {}, {}
        for k, g in grads.items():
            if g.dim() >= min_sparse_ndim:
                touched = _touched(g)
                acc[k] = torch.where(touched, state[k] + g * g, state[k])
                updates[k] = torch.where(
                    touched,
                    -learning_rate * g / (torch.sqrt(acc[k]) + eps), 0.0)
            else:
                acc[k] = state[k] + g * g
                updates[k] = -learning_rate * g / (torch.sqrt(acc[k]) + eps)
        return updates, acc

    return GradientTransformation(_zeros, update_fn)
