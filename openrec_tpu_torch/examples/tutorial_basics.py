"""Walkthrough of the framework basics: the port of
examples/tutorial_basics.py (the reference's RecSys'18 tutorial notebook,
tf1_tutorials/OpenRec_Basics_Diversity_and_Fairness.ipynb):

  Part 1: build the pipeline (data -> store -> sampler -> model ->
          trainer -> eval) and measure PER-GROUP accuracy;
  Part 2: fairness: oversample an under-represented group during
          training and measure again;
  Part 3: diversity: boost tail items at serving time.

    python -m openrec_tpu_torch.examples.tutorial_basics
"""

import os

import numpy as np
import torch

from openrec_tpu_torch import Dataset, Trainer
from openrec_tpu_torch.data import loaders
from openrec_tpu_torch.data.samplers import EvaluationSampler, PairwiseSampler
from openrec_tpu_torch.models import BPR

device = os.environ.get("OPENREC_EXAMPLE_DEVICE")     # None: CUDA

# ----------------------------------------------------------------- data #
# The notebook uses Last.fm (992 users x 14,598 artists) with a per-user
# gender attribute. With no dataset/ directory we synthesize interactions
# at the same scale (loaders.load_lastfm reads the real files).
_SMALL = os.environ.get("OPENREC_EXAMPLE_SMALL") == "1"
total_users, total_items = (200, 2000) if _SMALL else (992, 14598)
n_records = 8000 if _SMALL else 60000

rng = np.random.default_rng(0)
records = loaders.synthetic_interactions(total_users, total_items,
                                         n_records, seed=0)
# 80/20 train/test split, like the notebook's
split = int(len(records) * 0.8)
train_data, test_data = records[:split], records[split:]

# user gender: 0/1/2 ('nan' = undeclared, deliberately under-represented
# like the notebook's NAN group)
gender = rng.choice([0, 1, 2], size=total_users, p=[0.55, 0.35, 0.10])

# ------------------------------------------------- store + sampler + model #
# Dataset wraps the interaction store and gives the sampling strategies;
# pairwise() is the BPR triplet stream.
train_ds = Dataset(train_data, total_users, total_items, seed=0)
test_ds = Dataset(test_data, total_users, total_items, seed=0)

model = BPR(total_users=total_users, total_items=total_items,
            dim_user_embed=32, dim_item_embed=32, device=device)
trainer = Trainer(model, lr=1e-3, seed=0, device=device)

# ------------------------------------------------------ Part 1: train/eval #
total_iter = int(os.environ.get("OPENREC_EXAMPLE_ITERS", 3000))
trainer.train(
    total_iter=total_iter,
    train_batches=train_ds.pairwise(batch_size=256, num_parallel_calls=2),
    steps_per_call=min(100, total_iter))


def eval_group(users):
    """Ranking metrics restricted to one user group (the notebook's
    per-gender evaluators are EvaluationSamplers over a user subset)."""
    sampler = EvaluationSampler(test_ds.store, batch_size=64,
                                excl_stores=[train_ds.store])
    warm = sampler.eval_users
    sampler.eval_users = np.intersect1d(users, warm)
    if len(sampler.eval_users) == 0:
        return None
    return trainer.evaluate(sampler, at=(100,))


def report(title):
    print(f"\n{title}")
    print(f"{'group':>8}  {'users':>5}  {'AUC':>7}  {'Recall@100':>10}")
    for g, name in enumerate(["male", "female", "nan"]):
        res = eval_group(np.flatnonzero(gender == g))
        if res is None:
            continue
        print(f"{name:>8}  {int((gender == g).sum()):>5}  "
              f"{float(res['AUC']):.4f}  "
              f"{float(res['Recall'][0]):>10.4f}")


report("Part 1: per-gender accuracy (uniform sampling)")

# --------------------------------------- Part 2: balanced user sampling #
# The under-represented group is oversampled at the DATA layer with no
# model change: the train stream comes from a store whose records repeat
# that group's interactions (the samplers are store-driven, so
# rebalancing is a record-level operation).
nan_users = np.flatnonzero(gender == 2)
mask = np.isin(train_data["user_id"], nan_users)
rebalanced = np.concatenate([train_data, train_data[mask],
                             train_data[mask]])   # 3x NAN records
balanced_ds = Dataset(rebalanced, total_users, total_items, seed=0)

trainer2 = Trainer(BPR(total_users=total_users, total_items=total_items,
                       dim_user_embed=32, dim_item_embed=32, device=device),
                   lr=1e-3, seed=0, device=device)
trainer2.train(
    total_iter=total_iter,
    train_batches=PairwiseSampler(balanced_ds.store, batch_size=256,
                                  seed=0),
    steps_per_call=min(100, total_iter))
_t, trainer = trainer, trainer2
report("Part 2: per-gender accuracy (NAN group oversampled 3x)")
trainer = _t

# ----------------------------------------------- Part 3: diversity boost #
# Boost tail items at serving: score, then add a constant to the items in
# the bottom popularity quartile (the notebook's post-processing step).
pop = np.bincount(train_data["item_id"], minlength=total_items)
tail = pop <= np.quantile(pop, 0.25)
boost = 0.5

users = np.arange(min(64, total_users), dtype=np.int32)
with torch.no_grad():
    scores = model.score({"user_id": torch.as_tensor(
        users, device=trainer.device)}).cpu().numpy()
boosted = scores + boost * tail[None, :]

topk = np.argsort(-scores, axis=1)[:, :10]
topk_boosted = np.argsort(-boosted, axis=1)[:, :10]
frac_tail = tail[topk].mean()
frac_tail_boosted = tail[topk_boosted].mean()
print(f"\nPart 3: tail-item share of top-10: "
      f"{frac_tail:.3f} -> {frac_tail_boosted:.3f} with boost={boost}")
