"""Which backends take two ranks on one card? Two processes, both on
cuda:0; prints one JSON line with what happened.

    python3 nccl_probe.py                  # NCCL: one all_reduce
    python3 nccl_probe.py --backend gloo   # gloo: the collectives the
                                           # data-parallel step runs, on
                                           # CUDA tensors, over a mesh

The distribution layer runs one NCCL rank per card; on a one-card machine
the multi-shard math runs as shard-local calls in one process instead
(`chip_smoke.py` phase 12 (b)), and two data ranks share the card over
gloo (phase 12 (f)). This records why, and that gloo can.
"""

from __future__ import annotations

import argparse
import json

from openrec_tpu_torch.parallel.launch import spawn_local

_NCCL = r"""
import os, torch, torch.distributed as dist
torch.cuda.set_device(0)
dist.init_process_group("nccl", init_method="env://")
x = torch.full((4,), float(dist.get_rank() + 1), device="cuda:0")
dist.all_reduce(x)
torch.cuda.synchronize()
print("ALLREDUCE", x.tolist(), flush=True)
"""

_GLOO = r"""
import os, torch, torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh
torch.cuda.set_device(0)
dist.init_process_group("gloo", init_method="env://")
r = dist.get_rank()
x = torch.full((4,), float(r + 1), device="cuda:0")
dist.all_reduce(x)
print("ALLREDUCE", x.device.type, x.tolist(), flush=True)
parts = [torch.empty(2, device="cuda:0") for _ in range(2)]
dist.all_gather(parts, torch.full((2,), float(r), device="cuda:0"))
print("ALLGATHER", [p.tolist() for p in parts], flush=True)
mesh = init_device_mesh("cuda", (2, 1), mesh_dim_names=("data", "model"))
g = mesh.get_group("data")
y = torch.full((3,), float(r + 1), device="cuda:0")
dist.all_reduce(y, group=g)
print("MESH_ALLREDUCE", dist.get_backend(g), y.tolist(), flush=True)
try:
    z = torch.empty(2, device="cuda:0")
    dist.all_to_all_single(z, torch.full((2,), float(r), device="cuda:0"))
    print("ALLTOALL", z.tolist(), flush=True)
except Exception as e:
    print("ALLTOALL_REFUSED", type(e).__name__, str(e)[:200], flush=True)
torch.cuda.synchronize()
"""


def main(backend: str = "nccl", timeout: float = 120.0) -> dict:
    keys = ("ALLREDUCE", "ALLGATHER", "MESH_ALLREDUCE", "ALLTOALL")
    try:
        outs = spawn_local(_NCCL if backend == "nccl" else _GLOO, 2,
                           timeout=timeout)
        result = {"two_ranks_one_card": "ran",
                  "lines": [ln for ln in outs[0].splitlines()
                            if ln.startswith(keys)]}
    except (RuntimeError, TimeoutError) as e:
        lines = [ln for ln in str(e).splitlines()
                 if "NCCL" in ln or "Error" in ln or "exited" in ln
                 or "gloo" in ln.lower()]
        result = {"two_ranks_one_card": "refused", "error": lines[-6:]}
    print(json.dumps({f"{backend}_probe": result}), flush=True)
    return result


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--backend", choices=("nccl", "gloo"), default="nccl")
    main(ap.parse_args().backend)
