"""BPR with on-device sampling: the port of examples/bpr_device_sampled.py.

Batches are drawn on the card (uniform positive records, negatives
rejection-sampled against a bitmap of the positives) inside the K-step
loop; the host sends nothing per step. Synthetic CiteULike-shaped data
unless `dataset/citeulike/` exists (OPENREC_EXAMPLE_SMALL=1: 10,000
records).

    python -m openrec_tpu_torch.examples.bpr_device_sampled
"""

import os

from openrec_tpu_torch import Trainer
from openrec_tpu_torch.data import Dataset, DevicePairwiseSampler, loaders
from openrec_tpu_torch.models import BPR

dim_embed = 50
batch_size = 1000
total_iter = int(1e5)
eval_interval = 1000
steps_per_call = 200
device = os.environ.get("OPENREC_EXAMPLE_DEVICE")     # None: CUDA

# quick-run / smoke-test overrides (tests/test_torch_examples.py)
total_iter = int(os.environ.get("OPENREC_EXAMPLE_ITERS", total_iter))
eval_interval = int(os.environ.get("OPENREC_EXAMPLE_EVAL_INTERVAL",
                                   eval_interval))
steps_per_call = min(steps_per_call, eval_interval)

if os.path.isdir("dataset/citeulike"):
    raw_data = loaders.load_citeulike("dataset/")
else:
    print("dataset/citeulike not found: using synthetic data")
    n = 10000 if os.environ.get("OPENREC_EXAMPLE_SMALL") == "1" else 204057
    raw_data = loaders.synthetic_citeulike(num_records=n)

train_dataset = Dataset(raw_data["train_data"], raw_data["total_users"],
                        raw_data["total_items"])
val_dataset = Dataset(raw_data["val_data"], raw_data["total_users"],
                      raw_data["total_items"])

model = BPR(total_users=raw_data["total_users"],
            total_items=raw_data["total_items"],
            dim_user_embed=dim_embed, dim_item_embed=dim_embed,
            device=device)
trainer = Trainer(model, lr=1e-3, device=device)

# A Device*Sampler handed to Trainer.train switches the loop to on-device
# sampling (Trainer.train_steps_device).
sampler = DevicePairwiseSampler(train_dataset.store, batch_size=batch_size,
                                device=device)

trainer.train(
    total_iter=total_iter,
    train_batches=sampler,
    eval_samplers={"val": val_dataset.evaluation(
        batch_size=batch_size, excl_datasets=[train_dataset])},
    eval_interval=eval_interval,
    at=(50, 100),
    steps_per_call=steps_per_call,
)
