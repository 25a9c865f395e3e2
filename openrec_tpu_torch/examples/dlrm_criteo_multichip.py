"""DLRM with mesh parallelism: the batch over 'data', embedding rows over
'model'. The port of examples/dlrm_criteo_multichip.py; one process per
rank, launched by torchrun:

    torchrun --nproc-per-node 8 -m openrec_tpu_torch.examples.dlrm_criteo_multichip
    # on the CPU, two gloo ranks:
    OPENREC_EXAMPLE_DEVICE=cpu torchrun --standalone --nproc-per-node 2 \
        -m openrec_tpu_torch.examples.dlrm_criteo_multichip
"""

import os

import numpy as np
import torch
import torch.distributed as dist

from openrec_tpu_torch.data import ShuffledArrayLoader, loaders
from openrec_tpu_torch.models import criteo_dlrm
from openrec_tpu_torch.parallel import (make_mesh, make_parallel_train_step,
                                        mesh)
from openrec_tpu_torch.training.optim import lazy_adam

device = os.environ.get("OPENREC_EXAMPLE_DEVICE")     # None: CUDA
batch_size = 1024
total_iter = int(os.environ.get("OPENREC_EXAMPLE_ITERS", 500))

n_rec = (20000 if os.environ.get("OPENREC_EXAMPLE_SMALL") == "1"
         else 100000)
raw_data = loaders.synthetic_criteo(num_records=n_rec)
world = int(os.environ.get("WORLD_SIZE", 1))
model_axis = 2 if world % 2 == 0 and world > 1 else 1
grid = make_mesh(data=world // model_axis, model=model_axis, device=device)
rank = dist.get_rank()
if rank == 0:
    print(f"mesh: data {mesh.axis_size(grid, 'data')} x model "
          f"{mesh.axis_size(grid, 'model')}")

# Pad tables so rows split evenly across the model axis.
counts = np.maximum(raw_data["counts"], 1)
counts = ((counts + model_axis - 1) // model_axis) * model_axis
dev = mesh.mesh_device(grid)
model = criteo_dlrm(counts, dim_embed=8, ln_bot=(16, 8), ln_top=(64, 32, 1),
                    device=dev,
                    generator=torch.Generator(device=dev).manual_seed(0))

step_fn, init_fn = make_parallel_train_step(model, lazy_adam(1e-3), grid)
params, opt_state, _ = init_fn()

loader = ShuffledArrayLoader(           # the same global batches everywhere
    {"dense_features": raw_data["X_int_train"],
     "sparse_features": raw_data["X_cat_train"],
     "label": raw_data["y_train"]},
    batch_size=batch_size, seed=0)

for i, batch in enumerate(loader):
    if i >= total_iter:
        break
    opt_state, loss, _ = step_fn(opt_state, batch)
    if i % 100 == 0 and rank == 0:
        print(f"Iter {i}  loss {float(loss):.4f}", flush=True)
if rank == 0:
    print("done")
dist.destroy_process_group()
