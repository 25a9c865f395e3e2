"""Per-group accuracy analysis: the port of examples/fairness_analysis.py
(the reference tutorial `tf1_tutorials/OpenRec_Basics_Diversity_and_
Fairness.ipynb`). Train BPR, then break the ranking metrics down by user
group (training-activity terciles) to inspect the fairness of exposure.

    python -m openrec_tpu_torch.examples.fairness_analysis
"""

import os

import numpy as np

from openrec_tpu_torch.data import Dataset, EvaluationSampler, loaders
from openrec_tpu_torch.models import BPR
from openrec_tpu_torch.training import Trainer

device = os.environ.get("OPENREC_EXAMPLE_DEVICE")     # None: CUDA
_SMALL = os.environ.get("OPENREC_EXAMPLE_SMALL") == "1"
raw = loaders.synthetic_citeulike(num_records=15000 if _SMALL else 60000)
train_ds = Dataset(raw["train_data"], raw["total_users"],
                   raw["total_items"])
val_ds = Dataset(raw["val_data"], raw["total_users"], raw["total_items"])

model = BPR(total_users=raw["total_users"], total_items=raw["total_items"],
            dim_user_embed=32, dim_item_embed=32, device=device)
trainer = Trainer(model, lr=1e-3, device=device)
_iters = int(os.environ.get("OPENREC_EXAMPLE_ITERS", 2000))
trainer.train(total_iter=_iters,
              train_batches=train_ds.pairwise(batch_size=512,
                                              num_parallel_calls=2),
              steps_per_call=min(100, _iters))

# Group users by training activity (interaction-count terciles).
counts = train_ds.store.user_positive_counts()
warm = val_ds.store.warm_users()
terciles = np.quantile(counts[warm], [1 / 3, 2 / 3])
groups = {"low-activity": warm[counts[warm] <= terciles[0]],
          "mid-activity": warm[(counts[warm] > terciles[0])
                               & (counts[warm] <= terciles[1])],
          "high-activity": warm[counts[warm] > terciles[1]]}

print(f"{'group':>14}  {'users':>6}  {'AUC':>7}  {'Recall@100':>10}")
for name, users in groups.items():
    if len(users) == 0:
        continue
    sampler = EvaluationSampler(val_ds.store, batch_size=64,
                                excl_stores=[train_ds.store])
    sampler.eval_users = users
    res = trainer.evaluate(sampler, at=(100,))
    print(f"{name:>14}  {len(users):>6}  {res['AUC']:.4f}  "
          f"{float(res['Recall'][0]):>10.4f}")
