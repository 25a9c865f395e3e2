"""Fusion modules: combine module outputs into one representation.

Counterpart of `openrec_tpu/modules/fusions.py` (legacy fusions/
average.py:4-34 and concat.py:4-33).
"""

from __future__ import annotations

import torch


def average_fusion(tensors, weight=1.0):
    """weight * sum(tensors) / len(tensors), the legacy Average; its
    models pass weight=2.0 with two inputs, an elementwise sum."""
    return weight * sum(tensors) / len(tensors)


def concat_fusion(tensors, axis=-1):
    return torch.cat(list(tensors), dim=axis)
