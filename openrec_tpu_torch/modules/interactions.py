"""Interaction blocks.

Counterpart of `openrec_tpu/modules/interactions.py`:
`second_order_interaction` (`:21-33`), the DLRM pairwise dot
interaction. One batched product gives the Gram matrix [B, F, F]; the
pairs are its upper-triangle entries in row-major order, which
`torch.triu_indices(F, F, offset=k)` gives in the same order as
`np.triu_indices(F, k)`. And `masked_mean_pool` (`:36-46`), the mean of
a sequence's first seq_len vectors, over `masked_sum`, which
VanillaYouTubeRec divides by L instead (`models/sequence.py`).
"""

from __future__ import annotations

import torch


def second_order_interaction(features, self_interaction: bool = False):
    """Pairwise dot products between feature vectors.

    features: [B, F, D] stacked features (or a list of [B, D]).
    Returns [B, F*(F-1)/2] (or F*(F+1)/2 with self_interaction)."""
    if isinstance(features, (list, tuple)):
        features = torch.stack(features, dim=1)
    gram = torch.bmm(features, features.transpose(1, 2))
    F = features.shape[1]
    iu = torch.triu_indices(F, F, offset=0 if self_interaction else 1,
                            device=features.device)
    return gram[:, iu[0], iu[1]]


def masked_sum(seq_vecs, seq_len):
    """Sum over the first seq_len positions of each row.

    seq_vecs: [B, L, D]; seq_len: [B] int. Returns [B, D]."""
    L = seq_vecs.shape[1]
    seq_len = torch.as_tensor(seq_len, device=seq_vecs.device)
    mask = (torch.arange(L, device=seq_vecs.device)[None, :]
            < seq_len[:, None]).to(seq_vecs.dtype)
    return torch.sum(seq_vecs * mask[:, :, None], dim=1)


def masked_mean_pool(seq_vecs, seq_len):
    """Mean over the first seq_len positions of each row, divided by
    max(seq_len, 1) (tf1 mlp_softmax.py:13-15).

    seq_vecs: [B, L, D]; seq_len: [B] int. Returns [B, D]."""
    seq_len = torch.as_tensor(seq_len, device=seq_vecs.device)
    denom = torch.clamp(seq_len.to(seq_vecs.dtype), min=1.0)
    return masked_sum(seq_vecs, seq_len) / denom[:, None]
