"""Serving retrieval at an Amazon-sized catalog: the port of
examples/serving_retrieval.py.

Caches (U, V, b) once from a model (bf16 tables halve the bytes each
request reads), then answers one request of 256 users with its top-100
three ways: `exact` (torch.topk of the fp32 scores), `approx` (the same
exact top-k: PyTorch has no approximate one) and `pallas` (the bucket-max
kernel K1, `csrc/bucket_max.cu`, which never writes the [B, I] scores).
OPENREC_EXAMPLE_SMALL=1: 2,000 users x 20,000 items x 32.

    python -m openrec_tpu_torch.examples.serving_retrieval
"""

import os

import numpy as np
import torch

from openrec_tpu_torch.device import resolve_device
from openrec_tpu_torch.models import BPR
from openrec_tpu_torch.modules.embedding import embedding_lookup
from openrec_tpu_torch.serving import CachedDotProductScorer

total_users, total_items, dim = 99_473, 450_166, 64
if os.environ.get("OPENREC_EXAMPLE_SMALL") == "1":
    total_users, total_items, dim = 2000, 20_000, 32
device = resolve_device(os.environ.get("OPENREC_EXAMPLE_DEVICE"))

# random weights stand in for trained ones
model = BPR(total_users=total_users, total_items=total_items,
            dim_user_embed=dim, dim_item_embed=dim, device=device,
            generator=torch.Generator(device=device).manual_seed(0))
params = model.params()

scorer = CachedDotProductScorer(
    model, total_users, total_items,
    extract_user_vecs=lambda p, i: embedding_lookup(p["user_embed"], i),
    extract_item_vecs=lambda p, i: embedding_lookup(p["item_embed"], i),
    extract_item_bias=lambda p, i: embedding_lookup(p["item_bias"], i),
    serve_dtype=torch.bfloat16, device=device)

request = np.random.default_rng(0).integers(0, total_users, 256,
                                            dtype=np.int32)

for method in ("exact", "approx", "pallas"):
    vals, ids = scorer.topk(params, request, k=100, method=method)
    print(f"{method:7s} top-3 of user {int(request[0])}: "
          f"{ids[0, :3].tolist()} scores "
          f"{np.round(vals[0, :3].cpu().numpy(), 4).tolist()}")
