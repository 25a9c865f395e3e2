"""DLRM on Criteo Kaggle: the port of examples/dlrm_criteo.py.

Real data: put kaggle_processed.npz under dataset/criteo/ (the
reference's data_utils layout). Otherwise a synthetic long-tail stand-in
is generated in-process, or, with OPENREC_CRITEO_FROM_DISK=<records>
(<= 1: 2,000,000), a synthetic npz in the reference's on-disk layout is
written once and then read through `loaders.load_criteo` as the real file
would be, with the disk-to-host ingest rate printed.

    python -m openrec_tpu_torch.examples.dlrm_criteo
"""

import os
import time

import numpy as np
import torch

from openrec_tpu_torch.data import ShuffledArrayLoader, loaders
from openrec_tpu_torch.models import criteo_dlrm
from openrec_tpu_torch.training import Trainer

dim_embed = 4
bottom_mlp = (8, 4)
top_mlp = (128, 64, 1)
total_iter = int(1e5)
batch_size = 1024
eval_interval = 100
device = os.environ.get("OPENREC_EXAMPLE_DEVICE")     # None: CUDA

# quick-run / smoke-test overrides (tests/test_torch_examples.py)
total_iter = int(os.environ.get("OPENREC_EXAMPLE_ITERS", total_iter))
eval_interval = int(os.environ.get("OPENREC_EXAMPLE_EVAL_INTERVAL",
                                   eval_interval))

npz_path = "dataset/criteo/kaggle_processed.npz"
from_disk = os.environ.get("OPENREC_CRITEO_FROM_DISK")
if from_disk and not os.path.isfile(npz_path):
    n_rec = int(from_disk)
    n_rec = 2_000_000 if n_rec <= 1 else n_rec
    print(f"generating {npz_path}: {n_rec} records, reference layout")
    size = loaders.write_synthetic_criteo_npz(npz_path,
                                              num_records=n_rec)
    print(f"wrote {size / 1e6:.1f} MB")
if os.path.isfile(npz_path):
    t0 = time.perf_counter()
    raw_data = loaders.load_criteo("dataset/")
    dt = time.perf_counter() - t0
    size = os.path.getsize(npz_path)
    print(f"ingest: {size / 1e6:.1f} MB npz in {dt:.2f}s = "
          f"{size / dt / 1e6:.0f} MB/s disk->host "
          "(incl. the reference 6/7-1/14-1/14 split + log transform)")
else:
    print("dataset/criteo not found: using synthetic data")
    n_rec = (20000 if os.environ.get("OPENREC_EXAMPLE_SMALL") == "1"
             else 300000)
    raw_data = loaders.synthetic_criteo(num_records=n_rec)

model = criteo_dlrm(raw_data["counts"], dim_embed=dim_embed,
                    ln_bot=bottom_mlp, ln_top=top_mlp, device=device)
trainer = Trainer(model, lr=1e-3, device=device)

train_loader = ShuffledArrayLoader(
    {"dense_features": raw_data["X_int_train"],
     "sparse_features": raw_data["X_cat_train"],
     "label": raw_data["y_train"]},
    batch_size=batch_size, seed=0)

val_batch = {"dense_features": raw_data["X_int_val"][:8192],
             "sparse_features": raw_data["X_cat_val"][:8192],
             "label": raw_data["y_val"][:8192]}


def roc_auc(labels, scores):
    order = np.argsort(scores)
    ranks = np.empty(len(scores))
    ranks[order] = np.arange(1, len(scores) + 1)
    pos = labels > 0.5
    n_pos, n_neg = pos.sum(), (~pos).sum()
    if n_pos == 0 or n_neg == 0:
        return float("nan")
    return (ranks[pos].sum() - n_pos * (n_pos + 1) / 2) / (n_pos * n_neg)


for it, batch in enumerate(train_loader):
    if it >= total_iter:
        break
    loss, _ = trainer.train_step(batch)
    if it % eval_interval == 0:
        with torch.no_grad():
            pred = model.score(val_batch).cpu().numpy()
        auc = roc_auc(val_batch["label"], pred)
        print(f"Iter {it}  loss {float(loss):.4f}  val AUC {auc:.4f}",
              flush=True)
