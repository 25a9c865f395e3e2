"""PMF on CiteULike with stratified pointwise sampling: the port of
examples/pmf_citeulike.py (PMF + StratifiedPointwiseSampler, pos_ratio
0.2, on the C++ sampler feeder).

Runs on real data when `dataset/citeulike/` exists; otherwise on a
synthetic dataset of the same shape (OPENREC_EXAMPLE_SMALL=1: 10,000
records).

    python -m openrec_tpu_torch.examples.pmf_citeulike
"""

import os
import tempfile

from openrec_tpu_torch import Dataset, Trainer
from openrec_tpu_torch.data import loaders
from openrec_tpu_torch.models import PMF

dim_embed = 50
total_iter = int(1e5)
batch_size = 1000
eval_interval = 1000
device = os.environ.get("OPENREC_EXAMPLE_DEVICE")     # None: CUDA

# quick-run / smoke-test overrides (tests/test_torch_examples.py)
total_iter = int(os.environ.get("OPENREC_EXAMPLE_ITERS", total_iter))
eval_interval = int(os.environ.get("OPENREC_EXAMPLE_EVAL_INTERVAL",
                                   eval_interval))
steps_per_call = min(100, eval_interval)

if os.path.isdir("dataset/citeulike"):
    raw_data = loaders.load_citeulike("dataset/")
else:
    print("dataset/citeulike not found: using synthetic data")
    n = 10000 if os.environ.get("OPENREC_EXAMPLE_SMALL") == "1" else 204057
    raw_data = loaders.synthetic_citeulike(num_records=n)

train_dataset = Dataset(raw_data=raw_data["train_data"],
                        total_users=raw_data["total_users"],
                        total_items=raw_data["total_items"])
val_dataset = Dataset(raw_data=raw_data["val_data"],
                      total_users=raw_data["total_users"],
                      total_items=raw_data["total_items"])

pmf_model = PMF(total_users=raw_data["total_users"],
                total_items=raw_data["total_items"],
                dim_user_embed=dim_embed, dim_item_embed=dim_embed,
                device=device)

trainer = Trainer(pmf_model, lr=1e-3, device=device,
                  save_model_dir=os.environ.get(
                      "OPENREC_CKPT_DIR",
                      os.path.join(tempfile.gettempdir(), "openrec_examples",
                                   "pmf_citeulike_ckpt")))
trainer.train(
    total_iter=total_iter,
    train_batches=train_dataset.stratified_pointwise(
        batch_size=batch_size, pos_ratio=0.2, num_parallel_calls=4),
    eval_samplers={"val": val_dataset.evaluation(
        batch_size=batch_size, excl_datasets=[train_dataset])},
    eval_interval=eval_interval,
    save_interval=eval_interval,
    at=(50, 100),
    steps_per_call=steps_per_call,
)
