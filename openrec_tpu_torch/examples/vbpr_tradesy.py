"""VBPR on Tradesy with the cached-embedding scorer: the port of
examples/vbpr_tradesy.py.

Each batch carries its items' feature rows, joined on the host by
`Dataset.pairwise(joins=...)` (the reference's VBPRPairwiseSampler), and
the ranking eval goes through a bf16 `CachedDotProductScorer` whose item
vectors are [item_embed || MLP(features)], extracted in batches, so the
[B, 165,906] score rows are never held whole. Runs on real data when
`dataset/tradesy/` exists; otherwise on synthetic interactions at
Tradesy's catalog with 128-dim Gaussian features (OPENREC_EXAMPLE_SMALL=1:
800 users x 4,000 items, 16-dim features).

    python -m openrec_tpu_torch.examples.vbpr_tradesy
"""

import os

import numpy as np
import torch

from openrec_tpu_torch import Dataset, Trainer
from openrec_tpu_torch.data import loaders
from openrec_tpu_torch.models import VBPR
from openrec_tpu_torch.modules.embedding import embedding_lookup
from openrec_tpu_torch.serving import CachedDotProductScorer

dim_user = 100
dim_item = 50
batch_size = 1000
total_iter = int(1e5)
eval_interval = 1000
device = os.environ.get("OPENREC_EXAMPLE_DEVICE")     # None: CUDA

# quick-run / smoke-test overrides (tests/test_torch_examples.py)
total_iter = int(os.environ.get("OPENREC_EXAMPLE_ITERS", total_iter))
eval_interval = int(os.environ.get("OPENREC_EXAMPLE_EVAL_INTERVAL",
                                   eval_interval))

if os.path.isdir("dataset/tradesy"):
    raw_data = loaders.load_tradesy("dataset/")
else:
    print("dataset/tradesy not found: using synthetic data")
    raw_data = dict(loaders.TRADESY)
    n = 100000
    if os.environ.get("OPENREC_EXAMPLE_SMALL") == "1":
        raw_data = {"total_users": 800, "total_items": 4000}
        n = 20000
    raw = loaders.synthetic_interactions(raw_data["total_users"],
                                         raw_data["total_items"], n)
    raw_data["train_data"], raw_data["val_data"] = raw[:n - n // 10], \
        raw[n - n // 10:]
    n_vis = 16 if os.environ.get("OPENREC_EXAMPLE_SMALL") == "1" else 128
    raw_data["item_features"] = np.random.default_rng(0).normal(
        size=(raw_data["total_items"], n_vis)).astype(np.float32)

train_dataset = Dataset(raw_data["train_data"], raw_data["total_users"],
                        raw_data["total_items"])
val_dataset = Dataset(raw_data["val_data"], raw_data["total_users"],
                      raw_data["total_items"])
features = raw_data["item_features"]

model = VBPR(total_users=raw_data["total_users"],
             total_items=raw_data["total_items"],
             dim_user_embed=dim_user, dim_item_embed=dim_item,
             item_features=features, device=device)
trainer = Trainer(model, lr=1e-3, device=device)

# Cached scorer: user vectors, [item_embed || MLP(visual)] item vectors and
# biases extracted once per eval, in batches; bf16 tables halve the bytes
# a request reads at 166k items.
scorer = CachedDotProductScorer(
    model, raw_data["total_users"], raw_data["total_items"],
    extract_user_vecs=lambda p, ids: embedding_lookup(p["user_embed"], ids),
    extract_item_vecs=lambda p, ids: model.item_vecs(ids),
    extract_item_bias=lambda p, ids: embedding_lookup(p["item_bias"], ids),
    serve_dtype=torch.bfloat16, device=device)

sampler = train_dataset.pairwise(
    batch_size=batch_size, num_parallel_calls=4,
    joins=[("p_item_id", features, "p_item_vfeature"),
           ("n_item_id", features, "n_item_vfeature")])

for i, batch in enumerate(sampler):
    if i >= total_iter:
        break
    loss, _ = trainer.train_step(batch)
    if i % eval_interval == 0 and i > 0:
        # id batches through the scorer's chunked giant-catalog metrics
        m = trainer.evaluate(
            val_dataset.evaluation(batch_size=1000,
                                   excl_datasets=[train_dataset],
                                   device_masks=True),
            at=(50, 100), scorer=scorer)
        print(f"Iter {i}  loss {float(loss):.4f}  AUC={m['AUC']:.4f}  "
              f"Recall@[50,100]={m['Recall']}", flush=True)
sampler.stop()
