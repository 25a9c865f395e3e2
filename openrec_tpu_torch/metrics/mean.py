"""Streaming mean accumulators.

Counterpart of `openrec_tpu/metrics/mean.py`. `Mean` (scalar) and
`DictMean` (dicts of per-user metric vectors, summed over axis 0) are
host-side numpy. `DeviceMean` and `DeviceDictMean` keep their sums in
tensors on the values' device, so a training loop can log and evaluate
without copying anything to the host until the run ends
(`Trainer.train(defer_metrics=True)`). Every accumulator takes a `valid`
row mask so padded eval batches do not enter the averages.
"""

from __future__ import annotations

import numpy as np
import torch


class Mean:

    def __init__(self):
        self._sum = 0.0
        self._count = 0.0

    def update_state(self, values):
        v = np.asarray(values)
        self._sum += float(v.sum())
        self._count += v.size

    def result(self):
        return self._sum / max(self._count, 1.0)

    def reset_states(self):
        self._sum = 0.0
        self._count = 0.0


class DeviceMean:
    """Scalar streaming mean kept on the device (no host copy).

    update_state only stores a reference; the references are summed into
    a running device scalar every `fold_every` updates (one small launch
    per fold instead of one per update), so memory stays bounded."""

    def __init__(self, fold_every: int = 64):
        self._fold_every = int(fold_every)
        self.reset_states()

    def update_state(self, values):
        self._pending.append(values)
        if len(self._pending) >= self._fold_every:
            self._fold()

    def _fold(self):
        for v in self._pending:
            v = torch.as_tensor(v)
            s = v.sum()
            self._sum = s if self._sum is None else self._sum + s
            self._count += float(v.numel())
        self._pending = []

    def result_device(self):
        """Mean as a device scalar (0.0 if nothing accumulated)."""
        self._fold()
        if self._sum is None:
            return 0.0
        return self._sum / max(self._count, 1.0)

    def result(self):
        return float(self.result_device())

    def reset_states(self):
        self._sum = None
        self._count = 0.0
        self._pending = []


class DeviceDictMean:
    """DictMean kept on the device: `result_device` returns a dict of
    device tensors for the caller to copy once, later."""

    def __init__(self):
        self.reset_states()

    def reset_states(self):
        self._sums = {}
        self._counts = {}

    def update_state(self, state: dict, valid=None):
        for key, values in state.items():
            v = torch.as_tensor(values).to(torch.float32)
            if valid is not None and v.dim() > 0:
                m = torch.as_tensor(valid, device=v.device).to(torch.float32)
                s = (v * m.reshape((-1,) + (1,) * (v.dim() - 1))).sum(dim=0)
                n = m.sum()
            else:
                s = v.sum(dim=0) if v.dim() else v
                n = float(v.shape[0]) if v.dim() else 1.0
            if key in self._sums:
                self._sums[key] = self._sums[key] + s
                self._counts[key] = self._counts[key] + n
            else:
                self._sums[key] = s
                self._counts[key] = n

    def result_device(self):
        return {key: self._sums[key] / torch.clamp(
            torch.as_tensor(self._counts[key], dtype=torch.float32,
                            device=self._sums[key].device), min=1.0)
            for key in self._sums}

    def result(self):
        return {k: v.cpu().numpy() for k, v in self.result_device().items()}


class DictMean:

    def __init__(self, state_shape: dict):
        self._shapes = dict(state_shape)
        self.reset_states()

    def reset_states(self):
        self._states = {
            key: {"sum": np.zeros(shape, dtype=np.float64), "count": 0.0}
            for key, shape in self._shapes.items()}

    def update_state(self, state: dict, valid=None):
        for key, values in state.items():
            v = np.asarray(values, dtype=np.float64)
            # metric outputs are [B] or [B, num_at]; users on axis 0
            if valid is not None and v.ndim > 0:
                mask = np.asarray(valid, dtype=bool)
                v = v[mask]
                n = mask.sum()
            else:
                n = v.shape[0] if v.ndim > 0 else 1
            self._states[key]["sum"] += v.sum(axis=0) if v.ndim else v
            self._states[key]["count"] += float(n)

    def result(self):
        return {key: st["sum"] / max(st["count"], 1.0)
                for key, st in self._states.items()}
