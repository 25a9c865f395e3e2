"""RNNRec on LastFM: the port of examples/rnn_rec_lastfm.py.

A GRU over windows of up to 100 items (`Dataset.temporal`, 4 prefetch
threads), 32 units, sampled softmax over 1,000 log-uniform candidates,
and the next-item AUC / Recall@{100, 500} of every test user's last item
(`Trainer.evaluate_temporal`). Runs on real data when `dataset/lastfm/`
exists; otherwise on synthetic records at LastFM's catalog
(OPENREC_EXAMPLE_SMALL=1: 200 users x 2,000 items, 10,000 records).

    python -m openrec_tpu_torch.examples.rnn_rec_lastfm
"""

import os

from openrec_tpu_torch import Dataset, Trainer
from openrec_tpu_torch.data import loaders
from openrec_tpu_torch.metrics import Mean
from openrec_tpu_torch.models import RNNRec

dim_item_embed = 50
max_seq_len = 100
num_units = 32
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

train_dataset = Dataset(raw_data["train_data"], raw_data["total_users"],
                        raw_data["total_items"], sortby="ts")
# held-out interactions for next-item evaluation (the reference wires a
# Test dataset + TemporalEvaluationSampler + AUC/Recall into its trainer,
# tf1_examples/rnn_rec_lastfm.py:24-28)
test_dataset = Dataset(raw_data["test_data"], raw_data["total_users"],
                       raw_data["total_items"], sortby="ts")

model = RNNRec(total_items=raw_data["total_items"],
               dim_item_embed=dim_item_embed, max_seq_len=max_seq_len,
               num_units=num_units, softmax_samples=1000, device=device)
trainer = Trainer(model, lr=1e-3, device=device)

avg = Mean()
batches = train_dataset.temporal(batch_size=batch_size,
                                 max_seq_len=max_seq_len,
                                 num_parallel_calls=4)
for i, batch in enumerate(batches):
    if i >= total_iter:
        break
    loss, _ = trainer.train_step(batch)
    avg.update_state(float(loss))
    if i % eval_interval == 0:
        m = trainer.evaluate_temporal(
            test_dataset.temporal_evaluation(batch_size=batch_size,
                                             max_seq_len=max_seq_len),
            at=(100, 500))
        print(f"Iter {i}  loss {avg.result():.4f}  "
              f"AUC={m['AUC']:.4f}  Recall@[100,500]={m['Recall']}",
              flush=True)
        avg.reset_states()
batches.stop()
