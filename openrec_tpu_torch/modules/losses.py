"""Loss functions: batch in, scalar out.

Counterpart of `openrec_tpu/modules/losses.py`: BPR's losses (`:32-48`),
the dot-product hinge (`:51-60`), UCML's euclidean hinge (`:63-75`), the
multi-negative losses of NBPR and WCML with their WARP rank weight
(`:78-118`), WRMF's and PMF's pointwise MSE (`:121-128`), DLRM's
`mse_loss` / `bce_loss` (`:131-140`) and the NCF family's
`bce_logits_loss` (`:143-148`). Sums stay sums and means stay means, as
there. The hardest of K negatives is taken with `torch.amin` /
`torch.amax`, which split the gradient evenly among tied entries as
`jnp.min` / `jnp.max` do (`torch.min(x, dim)` gives all of it to one
index); ties are routine, since the K negatives are drawn with
replacement. The softmax losses come with the models that use them.
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


def pairwise_hinge_loss(user_vec, p_item_vec, n_item_vec,
                        p_item_bias=None, n_item_bias=None, margin=1.0):
    """sum(max(margin - pos_score + neg_score, 0)) on dot-product scores
    (the positive hinge; the legacy reference negates the sum)."""
    pos = _dot(user_vec, p_item_vec)
    neg = _dot(user_vec, n_item_vec)
    if p_item_bias is not None:
        pos = pos + p_item_bias.reshape(pos.shape)
    if n_item_bias is not None:
        neg = neg + n_item_bias.reshape(neg.shape)
    return torch.sum(torch.clamp(margin - pos + neg, min=0.0))


def pairwise_eudist_hinge_loss(user_vec, p_item_vec, n_item_vec,
                               p_item_bias=None, n_item_bias=None,
                               margin=0.5):
    """CML triplet: scores are -||u - v||^2 (+ bias); the sum of margin
    violations."""
    pos = -torch.sum((user_vec - p_item_vec) ** 2, dim=-1)
    neg = -torch.sum((user_vec - n_item_vec) ** 2, dim=-1)
    if p_item_bias is not None:
        pos = pos + p_item_bias.reshape(pos.shape)
    if n_item_bias is not None:
        neg = neg + n_item_bias.reshape(neg.shape)
    return torch.sum(torch.clamp(margin - (pos - neg), min=0.0))


def _rank_weight(violations, neg_num, total_items):
    """WARP-style rank weight log(floor(I * violations / K) + 1), in fp32
    in that order."""
    est_rank = torch.floor(total_items * violations.float() / neg_num)
    return torch.log(est_rank + 1.0)


def multi_neg_log_loss(user_vec, p_item_vec, n_item_vecs,
                       p_item_bias, n_item_biases, total_items):
    """NBPR: the rank-weighted log loss on the hardest of K negatives,
    -sum(log_sigmoid(max(w * min_k(pos - neg_k), -30))).

    n_item_vecs: [B, K, D]; n_item_biases: [B, K] or [B, K, 1]."""
    B, K = n_item_vecs.shape[0], n_item_vecs.shape[1]
    pos = _dot(user_vec, p_item_vec) + p_item_bias.reshape(-1)
    neg = torch.einsum("bd,bkd->bk", user_vec, n_item_vecs) \
        + n_item_biases.reshape(B, K)
    diff = pos[:, None] - neg                      # [B, K]
    w = _rank_weight(torch.sum(diff < 0.0, dim=1), K, total_items)
    hardest = torch.amin(diff, dim=1)
    return -torch.sum(F.logsigmoid(torch.clamp(w * hardest, min=-30.0)))


def multi_neg_eudist_loss(user_vec, p_item_vec, n_item_vecs,
                          p_item_bias, n_item_biases, total_items,
                          margin=0.5):
    """WCML: the rank-weighted hinge on the hardest of K negatives under
    euclidean scores -||u - v||^2 + b."""
    B, K = n_item_vecs.shape[0], n_item_vecs.shape[1]
    pos = -torch.sum((user_vec - p_item_vec) ** 2, dim=-1) \
        + p_item_bias.reshape(-1)
    neg = -torch.sum((user_vec[:, None, :] - n_item_vecs) ** 2, dim=-1) \
        + n_item_biases.reshape(B, K)
    scores = torch.clamp(margin - pos[:, None] + neg, min=0.0)   # [B, K]
    w = _rank_weight(torch.sum(scores > 0.0, dim=1), K, total_items)
    return torch.sum(w * torch.amax(scores, dim=1))


def pointwise_mse_loss(user_vec, item_vec, item_bias, label,
                       a=1.0, b=1.0, sigmoid=False):
    """WRMF weighted MSE: sum(((a - b)*label + b) * (label - pred)^2)."""
    pred = _dot(user_vec, item_vec) + item_bias.reshape(-1)
    if sigmoid:
        pred = torch.sigmoid(pred)
    weight = (a - b) * label + b
    return torch.sum(weight * (label - pred) ** 2)


def mse_loss(label, pred):
    """Mean squared error (keras MeanSquaredError, mean reduction)."""
    return torch.mean((label - pred) ** 2)


def bce_loss(label, prob, eps=1e-7):
    """Binary cross-entropy on probabilities (keras BinaryCrossentropy
    defaults: probabilities clipped to [eps, 1 - eps], mean reduction)."""
    p = torch.clamp(prob, eps, 1.0 - eps)
    return -torch.mean(label * torch.log(p)
                       + (1.0 - label) * torch.log(1.0 - p))


def bce_logits_loss(label, logit, reduction="mean"):
    """Binary cross-entropy from logits in the numerically stable form
    max(x, 0) - x*y + log1p(exp(-|x|)) (sigmoid_cross_entropy_with_logits);
    reduction 'mean', else the sum."""
    per = torch.clamp(logit, min=0.0) - logit * label \
        + torch.log1p(torch.exp(-torch.abs(logit)))
    return torch.mean(per) if reduction == "mean" else torch.sum(per)
