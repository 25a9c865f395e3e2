"""Full-catalog score + top-k with library calls.

Counterparts of `openrec_tpu/ops/topk.py:topk_xla` and `topk_approx`, which
are XLA code outside any Pallas kernel: a matmul and a top-k.

`approx` maps to EXACT top-k. `lax.approx_max_k` (the TPU PartialReduce
op) has no PyTorch counterpart; exact top-k meets every `recall_target`
and equals what the JAX package returns on the CPU, where approx_max_k
is exact too.

`torch.topk` orders exact score ties arbitrarily, while `lax.top_k` puts
the lower index first; the two can differ only at such ties.

The fused score + top-k study kernel (`fused_score_topk`, Pallas,
`openrec_tpu/ops/topk.py:58-141`) is not ported yet.
"""

from __future__ import annotations

import torch


def dot_scores(user_vecs, item_table, item_bias):
    """u.V^T + b in fp32. bf16 tables are upcast first: `torch.matmul` on
    bf16 tensors would return bf16, where JAX accumulates into and returns
    fp32. Exact fp32 needs `torch.backends.cuda.matmul.allow_tf32` False
    (PyTorch's default) on the card."""
    s = user_vecs.float() @ item_table.float().T
    if item_bias is not None:
        s = s + item_bias.reshape(-1).float()
    return s


def topk_xla(user_vecs, item_table, item_bias, k):
    """(values, ids) of the exact top-k of u.V^T + b."""
    return torch.topk(dot_scores(user_vecs, item_table, item_bias), k, dim=1)


def topk_approx(user_vecs, item_table, item_bias, k,
                recall_target: float = 0.99):
    """Same as `topk_xla`: exact top-k satisfies any `recall_target`."""
    del recall_target
    return topk_xla(user_vecs, item_table, item_bias, k)
