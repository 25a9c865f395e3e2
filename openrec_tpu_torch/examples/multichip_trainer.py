"""Multi-rank training through the high-level harness: ParallelTrainer.
The port of examples/multichip_trainer.py.

The Trainer's UX (intervals, eval, checkpoints), with every global batch
split over the mesh's 'data' ranks and the embedding tables row-sharded
over 'model'. One process per rank, launched by torchrun:

    torchrun --nproc-per-node 8 -m openrec_tpu_torch.examples.multichip_trainer
    # on the CPU, two gloo ranks:
    OPENREC_EXAMPLE_DEVICE=cpu torchrun --standalone --nproc-per-node 2 \
        -m openrec_tpu_torch.examples.multichip_trainer
"""

import os
import tempfile

import numpy as np
import torch
import torch.distributed as dist

from openrec_tpu_torch import Dataset, ParallelTrainer
from openrec_tpu_torch.models import BPR
from openrec_tpu_torch.parallel import make_mesh, mesh

device = os.environ.get("OPENREC_EXAMPLE_DEVICE")     # None: CUDA
total_users, total_items = 2000, 8192
rng = np.random.default_rng(0)          # every rank draws the same data
n = 100_000
raw = np.zeros(n, dtype=[("user_id", np.int32), ("item_id", np.int32)])
raw["user_id"] = rng.integers(0, total_users, n)
raw["item_id"] = rng.integers(0, total_items, n)
train = Dataset(raw[: int(n * 0.9)], total_users, total_items, seed=0)
val = Dataset(raw[int(n * 0.9):], total_users, total_items, seed=0)

world = int(os.environ.get("WORLD_SIZE", 1))
model_axis = 2 if world % 2 == 0 and world > 1 else 1
grid = make_mesh(data=world // model_axis, model=model_axis, device=device)
if dist.get_rank() == 0:
    print(f"mesh: data {mesh.axis_size(grid, 'data')} x model "
          f"{mesh.axis_size(grid, 'model')}")

dev = mesh.mesh_device(grid)
model = BPR(total_users=total_users, total_items=total_items,
            dim_user_embed=32, dim_item_embed=32, device=dev,
            generator=torch.Generator(device=dev).manual_seed(0))
ckpt_dir = os.environ.get(
    "OPENREC_CKPT_DIR", os.path.join(tempfile.gettempdir(), "multichip_ckpt"))
trainer = ParallelTrainer(model, grid, lr=1e-3, save_model_dir=ckpt_dir)
trainer.train(
    total_iter=int(os.environ.get("OPENREC_EXAMPLE_ITERS", 400)),
    train_batches=train.pairwise(batch_size=1024, num_parallel_calls=2),
    eval_samplers={"val": val.evaluation(256, excl_datasets=[train])},
    eval_interval=int(os.environ.get("OPENREC_EXAMPLE_EVAL_INTERVAL",
                                     200)),
    save_interval=200)
dist.destroy_process_group()
