"""Loss functions: batch in, scalar out.

Counterpart of the BPR losses of `openrec_tpu/modules/losses.py:32-48`
and DLRM's `mse_loss` / `bce_loss` (`:131-140`); the other losses of that
module come with the models that use them.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def _dot(a, b):
    return torch.sum(a * b, dim=-1)


def l2_half(*tensors):
    """tf.nn.l2_loss: sum(t**2)/2, summed over the given tensors."""
    return sum(0.5 * torch.sum(t ** 2) for t in tensors)


def pairwise_log_loss(user_vec, p_item_vec, n_item_vec,
                      p_item_bias=None, n_item_bias=None):
    """BPR: -mean(log_sigmoid(max(pos - neg, -30)))."""
    pos = _dot(user_vec, p_item_vec)
    neg = _dot(user_vec, n_item_vec)
    if p_item_bias is not None:
        pos = pos + p_item_bias.reshape(pos.shape)
    if n_item_bias is not None:
        neg = neg + n_item_bias.reshape(neg.shape)
    return -torch.mean(F.logsigmoid(torch.clamp(pos - neg, min=-30.0)))


def mse_loss(label, pred):
    """Mean squared error (keras MeanSquaredError, mean reduction)."""
    return torch.mean((label - pred) ** 2)


def bce_loss(label, prob, eps=1e-7):
    """Binary cross-entropy on probabilities (keras BinaryCrossentropy
    defaults: probabilities clipped to [eps, 1 - eps], mean reduction)."""
    p = torch.clamp(prob, eps, 1.0 - eps)
    return -torch.mean(label * torch.log(p)
                       + (1.0 - label) * torch.log(1.0 - p))
