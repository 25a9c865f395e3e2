"""Loss functions: batch in, scalar out.

Counterpart of `openrec_tpu/modules/losses.py`: BPR's losses (`:32-48`),
the dot-product hinge (`:51-60`), UCML's euclidean hinge (`:63-75`), the
multi-negative losses of NBPR and WCML with their WARP rank weight
(`:78-118`), WRMF's and PMF's pointwise MSE (`:121-128`), DLRM's
`mse_loss` / `bce_loss` (`:131-140`) and the NCF family's
`bce_logits_loss` (`:143-148`), and the sequence models' softmax losses
(`:153-236`): `softmax_ce_loss` over the full catalog (and
`table_softmax_ce` over an output layer), TF's log-uniform
candidate law (`log_uniform_logprob`, `log_uniform_sample`) and
`sampled_softmax_loss`. Sums stay sums and means stay means, as
there. The hardest of K negatives is taken with `torch.amin` /
`torch.amax`, which split the gradient evenly among tied entries as
`jnp.min` / `jnp.max` do (`torch.min(x, dim)` gives all of it to one
index); ties are routine, since the K negatives are drawn with
replacement. The sampled softmax draws its candidates from a
`torch.Generator` (Philox on the card), not from JAX's threefry: the law
is the same, the bits are not; `log_uniform_from_uniforms` is the closed
form applied to given uniforms, which gives JAX's ids for JAX's uniforms.
"""

from __future__ import annotations

import functools

import torch
import torch.nn.functional as F

from openrec_tpu_torch.modules.embedding import embedding_lookup


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


# ----------------------------------------------------------------- softmax

def softmax_ce_loss(logits, labels, reduction="mean"):
    """Sparse softmax cross-entropy over the full catalog (tf1
    mlp_softmax.py:36-40, rnn_softmax.py:22-26)."""
    logp = F.log_softmax(logits, dim=-1)
    labels = torch.as_tensor(labels, device=logits.device).long()
    per = -logp.gather(1, labels[:, None])[:, 0]
    return torch.mean(per) if reduction == "mean" else torch.sum(per)


def table_softmax_ce(hidden, table, bias, labels):
    """The mean `softmax_ce_loss` of the logits hidden . table^T + bias
    (RNNRec's output layer). A view that carries its own `softmax_ce`
    (a row-sharded output layer, `parallel.ShardedTable`) computes it
    without the whole logits."""
    if hasattr(table, "softmax_ce"):
        return table.softmax_ce(hidden, bias, labels)
    return softmax_ce_loss(hidden @ table.T + bias, labels)


@functools.lru_cache(maxsize=64)
def _f32_log(x: float) -> float:
    """log(x) computed in float32 (as JAX computes its constants), as a
    Python float that a float32 tensor op takes without rounding."""
    return torch.log(torch.tensor(x, dtype=torch.float32)).item()


def log_uniform_logprob(ids, range_max: int):
    """log P(id) under TF's log-uniform (Zipf) candidate law,
    P(c) = (log(c + 2) - log(c + 1)) / log(range_max + 1), in float32."""
    c = torch.as_tensor(ids).to(torch.float32)
    return torch.log(torch.log1p(1.0 / (c + 1.0))) \
        - _f32_log(_f32_log(float(range_max) + 1.0))


def log_uniform_from_uniforms(u, range_max: int):
    """The inverse CDF of TF's RangeSampler::LogUniform on float32
    uniforms u in [0, 1): floor(exp(u * log(R + 1))) - 1, clipped to
    [0, R - 1], as int32."""
    c = torch.floor(torch.exp(u * _f32_log(float(range_max) + 1.0))) - 1.0
    return torch.clamp(c.to(torch.int32), 0, range_max - 1)


def log_uniform_sample(num_sampled: int, range_max: int,
                       generator: torch.Generator | None = None,
                       device=None):
    """`num_sampled` ids drawn with replacement from the log-uniform law:
    float32 uniforms from `generator` through the closed form."""
    u = torch.rand(num_sampled, generator=generator, device=device)
    return log_uniform_from_uniforms(u, range_max)


def sampled_softmax_loss(item_table, item_bias, hidden, labels,
                         num_sampled: int, generator=None,
                         distribution: str = "log_uniform",
                         sampled_values=None):
    """TF's sampled softmax (tf1 rnn_softmax.py:24-26): softmax CE over
    [true class | num_sampled candidates drawn with replacement], each
    logit less log of its expected count S * P(class), candidates equal
    to a row's true class set to -1e9 (accidental hits).

    distribution: 'log_uniform' (TF's default; ids ranked by falling
    popularity) or 'uniform'. sampled_values: optional (sampled_ids [S],
    true_expected_count [B], sampled_expected_count [S]) that replaces
    the draw, as TF's argument does. Otherwise the candidates are drawn
    from `generator` on the tables' device.

    item_table: [I, D]; item_bias: [I] or [I, 1]; hidden: [B, D];
    labels: [B] int. The true and candidate rows are looked up
    (`embedding_lookup`), so either table may be a view with its own
    lookup (a row shard, `parallel.ShardedTable`, whose shape is the
    catalog's)."""
    total_items = item_table.shape[0]
    dev = item_table.device
    labels = torch.as_tensor(labels, device=dev).long()
    if sampled_values is not None:
        sampled, true_exp, samp_exp = sampled_values
        sampled = torch.as_tensor(sampled, device=dev).long()
        true_logq = torch.log(torch.as_tensor(true_exp, device=dev,
                                              dtype=torch.float32))
        samp_logq = torch.log(torch.as_tensor(samp_exp, device=dev,
                                              dtype=torch.float32))
    elif distribution == "log_uniform":
        sampled = log_uniform_sample(num_sampled, total_items, generator,
                                     dev).long()
        log_s = _f32_log(float(num_sampled))
        true_logq = log_s + log_uniform_logprob(labels, total_items)
        samp_logq = log_s + log_uniform_logprob(sampled, total_items)
    elif distribution == "uniform":
        sampled = torch.randint(0, total_items, (num_sampled,),
                                generator=generator, device=dev)
        true_logq = samp_logq = torch.log(torch.tensor(
            num_sampled / total_items, dtype=torch.float32, device=dev))
    else:
        raise ValueError(f"unknown candidate distribution {distribution!r}")

    true_w = embedding_lookup(item_table, labels)                # [B, D]
    true_logit = torch.sum(hidden * true_w, dim=-1) \
        + embedding_lookup(item_bias, labels).reshape(-1)
    sampled_w = embedding_lookup(item_table, sampled)            # [S, D]
    sampled_logit = hidden @ sampled_w.T \
        + embedding_lookup(item_bias, sampled).reshape(-1)       # [B, S]

    true_logit = true_logit - true_logq
    sampled_logit = sampled_logit - samp_logq.reshape(1, -1)
    hit = sampled[None, :] == labels[:, None]
    sampled_logit = torch.where(hit, -1e9, sampled_logit)

    logits = torch.cat([true_logit[:, None], sampled_logit], dim=1)
    return softmax_ce_loss(logits, torch.zeros_like(labels))
