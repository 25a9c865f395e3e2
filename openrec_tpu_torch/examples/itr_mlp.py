"""ItrMLP: temporal embedding forward-propagation training, the port of
examples/itr_mlp.py.

  - identity-pretrain the two transform MLPs;
  - chronological (one unshuffled epoch) explicit sampling,
    `Dataset.explicit(chronological=True)`;
  - `Trainer.train(update_interval=...)` forward-propagates the visited
    embeddings every `update_itr` steps;
  - the regression (MSE) eval over held-out rating records.

Synthetic time-ordered ratings (the reference trains on Netflix ratings in
time order): label = sigmoid of a rank-8 affinity.

    python -m openrec_tpu_torch.examples.itr_mlp
"""

import os

import numpy as np
import torch

from openrec_tpu_torch import resolve_device
from openrec_tpu_torch.data import Dataset
from openrec_tpu_torch.models import ItrMLP
from openrec_tpu_torch.training import Trainer

dim_embed = 20
batch_size = 256
update_itr = 200          # forward-propagate embeddings this often
eval_itr = 1000
total_users, total_items, n_records = 2000, 3000, 300_000
pretrain_steps = 2000
device = os.environ.get("OPENREC_EXAMPLE_DEVICE")     # None: CUDA
# quick-run / smoke-test overrides (tests/test_torch_examples.py)
if os.environ.get("OPENREC_EXAMPLE_SMALL") == "1":
    total_users, total_items, n_records = 300, 500, 20_000
    update_itr, eval_itr, pretrain_steps = 10, 30, 20
eval_itr = int(os.environ.get("OPENREC_EXAMPLE_EVAL_INTERVAL", eval_itr))

rng = np.random.default_rng(0)
raw = np.zeros(n_records, dtype=[("user_id", np.int32),
                                 ("item_id", np.int32),
                                 ("label", np.float32)])
raw["user_id"] = rng.integers(0, total_users, n_records)
raw["item_id"] = rng.integers(0, total_items, n_records)
affinity = rng.normal(size=(total_users, 8)) @ rng.normal(
    size=(8, total_items))
raw["label"] = 1 / (1 + np.exp(-affinity[raw["user_id"], raw["item_id"]]))

split = int(n_records * 0.9)
train_dataset = Dataset(raw[:split], total_users, total_items, seed=0)
val_dataset = Dataset(raw[split:], total_users, total_items, seed=0)

model = ItrMLP(total_users=total_users, total_items=total_items,
               dim_embed=dim_embed, user_dims=(30, 30, dim_embed),
               item_dims=(30, 30, dim_embed), device=device)
trainer = Trainer(model, lr=1e-3, device=device)

print("[pretrain MLPs toward identity]")
model.pretrain_identity(
    torch.Generator(device=resolve_device(device)).manual_seed(0),
    steps=pretrain_steps)

trainer.train(
    total_iter=int(os.environ.get("OPENREC_EXAMPLE_ITERS",
                                  split // batch_size)),
    train_batches=train_dataset.explicit(batch_size=batch_size,
                                         chronological=True),
    eval_samplers={"val": val_dataset.regression_evaluation(batch_size)},
    eval_interval=eval_itr,
    update_interval=update_itr)
