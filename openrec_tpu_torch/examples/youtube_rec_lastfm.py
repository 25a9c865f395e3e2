"""YouTubeRec on LastFM: the port of examples/youtube_rec_lastfm.py.

VanillaYouTubeRec with the user's gender (3 values, dim 10) and geo (67
values, dim 40) embeddings before the pooled items in the MLP's input;
the user features are joined into every batch on the host
(`Dataset.temporal(joins=...)`, `temporal_evaluation(joins=...)`). Runs
on real data when `dataset/lastfm/` exists (with its
`user_feature.npy`); otherwise on synthetic records and features at
LastFM's catalog (OPENREC_EXAMPLE_SMALL=1: 200 users x 2,000 items,
10,000 records).

    python -m openrec_tpu_torch.examples.youtube_rec_lastfm
"""

import os

import numpy as np

from openrec_tpu_torch import Dataset, Trainer
from openrec_tpu_torch.data import loaders
from openrec_tpu_torch.metrics import Mean
from openrec_tpu_torch.models import YouTubeRec

dim_item_embed = 50
dim_gender, dim_geo = 10, 40
max_seq_len = 20
batch_size = 256
total_iter = int(1e4)
eval_interval = 100
device = os.environ.get("OPENREC_EXAMPLE_DEVICE")     # None: CUDA

# quick-run / smoke-test overrides (tests/test_torch_examples.py)
total_iter = int(os.environ.get("OPENREC_EXAMPLE_ITERS", total_iter))
eval_interval = int(os.environ.get("OPENREC_EXAMPLE_EVAL_INTERVAL",
                                   eval_interval))

if os.path.isdir("dataset/lastfm"):
    raw_data = loaders.load_lastfm("dataset/")
    gender = raw_data["user_features"]["user_gender"]
    geo = raw_data["user_features"]["user_geo"]
else:
    print("dataset/lastfm not found: using synthetic data")
    raw_data = dict(loaders.LASTFM)
    n = 50000
    if os.environ.get("OPENREC_EXAMPLE_SMALL") == "1":
        raw_data = {"total_users": 200, "total_items": 2000}
        n = 10000
    raw = loaders.synthetic_interactions(raw_data["total_users"],
                                         raw_data["total_items"], n,
                                         timestamps=True)
    raw_data["train_data"], raw_data["test_data"] = raw[:n - n // 10], \
        raw[n - n // 10:]
    rng = np.random.default_rng(0)
    gender = rng.integers(0, 3, raw_data["total_users"]).astype(np.int32)
    geo = rng.integers(0, 67, raw_data["total_users"]).astype(np.int32)
joins = [("user_id", gender, "user_gender"), ("user_id", geo, "user_geo")]

train_dataset = Dataset(raw_data["train_data"], raw_data["total_users"],
                        raw_data["total_items"], sortby="ts")
# held-out next-item eval with the same user-feature joins (the
# reference's YouTubeEvaluationSampler, tf1_examples/youtube_rec_lastfm.py:
# 28-36)
test_dataset = Dataset(raw_data["test_data"], raw_data["total_users"],
                       raw_data["total_items"], sortby="ts")

model = YouTubeRec(total_items=raw_data["total_items"],
                   dim_item_embed=dim_item_embed, max_seq_len=max_seq_len,
                   total_genders=3, total_geos=67,
                   dim_gender_embed=dim_gender, dim_geo_embed=dim_geo,
                   device=device)
trainer = Trainer(model, lr=1e-3, device=device)

batches = train_dataset.temporal(batch_size=batch_size,
                                 max_seq_len=max_seq_len,
                                 num_parallel_calls=4, joins=joins)
avg = Mean()
for i, batch in enumerate(batches):
    if i >= total_iter:
        break
    loss, _ = trainer.train_step(batch)
    avg.update_state(float(loss))
    if i % eval_interval == 0:
        m = trainer.evaluate_temporal(
            test_dataset.temporal_evaluation(batch_size=batch_size,
                                             max_seq_len=max_seq_len,
                                             joins=joins),
            at=(100, 500))
        print(f"Iter {i}  loss {avg.result():.4f}  "
              f"AUC={m['AUC']:.4f}  Recall@[100,500]={m['Recall']}",
              flush=True)
        avg.reset_states()
batches.stop()
