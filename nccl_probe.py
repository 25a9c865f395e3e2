"""Does NCCL take two ranks on one card? One all_reduce, two processes,
both on cuda:0; prints one JSON line with what happened.

    python3 nccl_probe.py

The distribution layer runs one rank per card; on a one-card machine the
multi-shard math runs as shard-local calls in one process instead
(`chip_smoke.py` phase 12 (b)). This records why.
"""

from __future__ import annotations

import json

from openrec_tpu_torch.parallel.launch import spawn_local

_RANK = r"""
import os, torch, torch.distributed as dist
torch.cuda.set_device(0)
dist.init_process_group("nccl", init_method="env://")
x = torch.full((4,), float(dist.get_rank() + 1), device="cuda:0")
dist.all_reduce(x)
torch.cuda.synchronize()
print("ALLREDUCE", x.tolist(), flush=True)
"""


def main(timeout: float = 120.0) -> dict:
    try:
        outs = spawn_local(_RANK, 2, timeout=timeout)
        result = {"two_ranks_one_card": "ran",
                  "all_reduce": [ln for ln in outs[0].splitlines()
                                 if ln.startswith("ALLREDUCE")]}
    except (RuntimeError, TimeoutError) as e:
        lines = [ln for ln in str(e).splitlines()
                 if "NCCL" in ln or "Error" in ln or "exited" in ln]
        result = {"two_ranks_one_card": "refused", "error": lines[-6:]}
    print(json.dumps({"nccl_probe": result}), flush=True)
    return result


if __name__ == "__main__":
    main()
