"""Interaction blocks.

Counterpart of `second_order_interaction` in
`openrec_tpu/modules/interactions.py:21-33`: the DLRM pairwise dot
interaction. One batched product gives the Gram matrix [B, F, F]; the
pairs are its upper-triangle entries in row-major order, which
`torch.triu_indices(F, F, offset=k)` gives in the same order as
`np.triu_indices(F, k)`. `masked_mean_pool` comes with the sequence
models.
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
