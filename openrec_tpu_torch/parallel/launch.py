"""Run a piece of Python as the ranks of a job on this host.

`spawn_local(code, world)` starts `world` processes of `python -c code`
with the environment `torchrun` would give them (RANK, LOCAL_RANK,
WORLD_SIZE, MASTER_ADDR=127.0.0.1, MASTER_PORT a free port), waits for
all of them under one timeout, and kills every one that is left when the
time is up or a rank fails. After `code`, each rank that joined a process
group meets the others at a barrier and destroys its group. It raises
with a failing rank's output; it returns every rank's output.
`initialize_multihost` / `make_mesh` inside `code` join the job from
that environment.
"""

from __future__ import annotations

import os
import subprocess
import sys
import time

from openrec_tpu_torch.parallel.mesh import _free_port

_CLEANUP = """
import torch.distributed as _dist
if _dist.is_initialized():
    _dist.barrier()
    _dist.destroy_process_group()
"""
_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def spawn_local(code: str, world: int, timeout: float = 120.0,
                env: dict | None = None, threads: int = 1) -> list:
    """[stdout+stderr of rank 0, ..., rank world-1]."""
    base = dict(os.environ)
    base.update(env or {})
    # the ranks import this package from where this process found it
    base["PYTHONPATH"] = os.pathsep.join(
        p for p in (_ROOT, base.get("PYTHONPATH")) if p)
    base.update(MASTER_ADDR="127.0.0.1", MASTER_PORT=str(_free_port()),
                WORLD_SIZE=str(world), OMP_NUM_THREADS=str(threads))
    # a rank that leaves with its gloo / NCCL threads running can abort at
    # exit: every rank meets the others, then takes its group down
    code = code + _CLEANUP
    procs = []
    for rank in range(world):
        e = dict(base, RANK=str(rank), LOCAL_RANK=str(rank))
        procs.append(subprocess.Popen(
            [sys.executable, "-c", code], env=e, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    deadline = time.monotonic() + timeout
    outs = [None] * world
    try:
        while any(o is None for o in outs):
            for r, p in enumerate(procs):
                if outs[r] is None and p.poll() is not None:
                    outs[r] = p.stdout.read()
                    if p.returncode != 0:
                        raise RuntimeError(
                            f"rank {r} exited {p.returncode}:\n"
                            f"{outs[r][-6000:]}")
            if time.monotonic() > deadline:
                raise TimeoutError(f"ranks still running after {timeout} s")
            time.sleep(0.05)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
    return outs
