"""Data-parallel training driver: the configuration's DLRM under the
distribution layer's O(batch) sparse step
(`openrec_tpu_torch.parallel.make_parallel_sparse_train_step`) on a data
x model mesh of the cell's cards, data = cards and model 1, one rank a
card over NCCL.

Rank 0 runs in the benchmark's own process on card 0; ranks 1 to
cards - 1 are processes of this module (`python -m
portbench.drivers.train_dp`), started as `parallel/launch.py` starts
ranks (RANK, LOCAL_RANK, WORLD_SIZE, MASTER_ADDR and MASTER_PORT of a
free localhost port), each on its own card. Every rank makes the seed's
weights and the same pool of global batches (`traffic.train_pool`) and
feeds each global batch through `device_iterator`; the step trains on the
rank's slice of it, dedups the global batch's ids, and sums the
gradients over the ranks in one all_reduce. Before each group of `CHUNK`
window steps rank 0 tells the others over a gloo group whether the
window is still open, so every rank takes the same steps.

Rank 0 reads what `drivers/train.py` reads, with the same functions: the
first `check_steps` steps from the seed's weights, the window's rate (the
examples of the global batches of every step dispatched in it, over the
time from its first dispatch to the synchronize that ends it), a
profiled slice of `trace_steps` steps (with its device seconds in NCCL
kernels), and `check_steps` more steps from a copy of its state after the
window. `reference/dlrm.py` follows the same global batches in one
process. After the window every rank's replica is fingerprinted
(`fingerprint`: steps taken, each leaf's float64 sum and norm) and rank 0
returns all of them, so a replica that left the others shows.

No cell of BENCHMARK.json runs this driver yet: the four-card cell
`dlrm-kaggle.train-dp4` (`traffic/train-dp4.json`,
`workloads/dlrm-kaggle.train-dp4.json`, `metrics/dp.allreduce_ms.py`)
waits on the spread of its rate. `portbench/dp_probe.py` runs it at chosen
seeds and checks rank 0's state against one-process training.
"""

from __future__ import annotations

import datetime
import gc
import itertools
import json
import os
import socket
import subprocess
import sys
import tempfile
import time

import torch
import torch.distributed as dist

from portbench import devtrace, slice_events, traffic as traffic_lib, weights
from portbench.drivers.train import follow, snapshot, table_rows

ENV = "DP_RANK_JOB"
CHUNK = 4                # window steps a go-ahead from rank 0 covers
TIMEOUT_S = 180          # a collective that waits longer fails the run


class RankTrainer:
    """The distributed step behind `Trainer`'s face (`train_step`,
    `params`, `opt_state`), so `drivers/train.py`'s readers read it."""

    def __init__(self, model, step_fn, state):
        self.model = model
        self.step_fn = step_fn
        self.opt_state = state

    @property
    def params(self) -> dict:
        return self.model.params()

    def train_step(self, batch):
        self.opt_state, loss = self.step_fn(self.opt_state, batch)
        return loss, {}


def build(cfg: dict, seed: int, device, world: int):
    """(model, trainer, initial weights) on this rank: the port's DLRM on
    fused tables, holding the seed's weights, under the data-parallel
    sparse step over `world` data ranks."""
    from openrec_tpu_torch.models import DLRM
    from openrec_tpu_torch.parallel import (make_mesh,
                                            make_parallel_sparse_train_step)
    from openrec_tpu_torch.training.sparse import dlrm_fused_table_spec
    if cfg["dtype"] != "float32":
        raise ValueError("the driver runs fp32 DLRM")
    mesh = make_mesh(data=world, model=1, device=device)
    model = DLRM(m_spa=cfg["m_spa"], ln_emb=cfg["ln_emb"],
                 ln_bot=cfg["ln_bot"], ln_top=cfg["ln_top"],
                 dim_dense=cfg["dim_dense"],
                 arch_interaction_op=cfg["interaction"],
                 loss_func=cfg["loss"], fused_tables=True,
                 compute_dtype=cfg["dtype"], device=device)
    w = weights.dlrm_weights(cfg, seed, device)
    model.load_params(w)
    opt = cfg["optimizer"]
    step_fn, init_fn = make_parallel_sparse_train_step(
        model, dlrm_fused_table_spec(model, mode=cfg["dedup"]), mesh,
        learning_rate=opt["lr"], b1=opt["b1"], b2=opt["b2"],
        eps=opt["eps"])
    _, state, _ = init_fn()
    return model, RankTrainer(model, step_fn, state), w


def fingerprint(params: dict, steps: int) -> torch.Tensor:
    """This rank's replica after `steps` steps, on the host: the steps,
    then each leaf's sum and norm in float64 (equal on every rank while
    the replicas are bit for bit equal)."""
    out = [float(steps)]
    with torch.no_grad():
        for name in sorted(params):
            p = params[name].detach()
            out += [float(p.sum(dtype=torch.float64)),
                    float(torch.linalg.vector_norm(p, dtype=torch.float64))]
    return torch.tensor(out, dtype=torch.float64)


def nccl_seconds(events: list) -> float:
    """Device seconds of the slice's NCCL kernels (the union of their
    intervals), from the same `traceEvents` as `devtrace.reduce_trace`."""
    marks = [e for e in events if e.get("name") == devtrace.SLICE
             and e.get("cat") == "user_annotation"]
    lo = float(marks[0]["ts"])
    hi = lo + float(marks[0]["dur"])
    spans = []
    for e in events:
        if e.get("ph") == "X" and e.get("cat") == "kernel" \
                and "nccl" in e.get("name", "").lower():
            s = max(float(e["ts"]), lo)
            t = min(float(e["ts"]) + float(e["dur"]), hi)
            if t > s:
                spans.append((s, t))
    return sum(t - s for s, t in devtrace._union(spans)) * 1e-6


def profiled_slice(body, device) -> dict:
    """`devtrace.reduce_trace` of `body()`'s profiled slice, with
    `nccl_s`."""
    events = slice_events.profiled_events(body, device)
    out = devtrace.reduce_trace(events)
    out["nccl_s"] = nccl_seconds(events)
    return out


def rank_run(job: dict, rank: int, world: int, device, gloo,
             t_proc: float) -> dict | None:
    """One rank's part of a run; rank 0 returns the run's readings."""
    from openrec_tpu_torch.data.pipeline import device_iterator
    cfg, traffic, seed = job["config"], job["traffic"], job["seed"]
    cuda = device.type == "cuda"
    torch.backends.cuda.matmul.allow_tf32 = bool(cfg["tf32"])
    torch.backends.cudnn.allow_tf32 = bool(cfg["tf32"])
    model, trainer, w0 = build(cfg, seed, device, world)
    pool = traffic_lib.train_pool(traffic, cfg, seed, device, pin=cuda)
    feed = device_iterator(itertools.cycle(pool), device,
                           prefetch=int(traffic["prefetch"]))
    n_check = int(traffic["check_steps"])
    lead = rank == 0

    def steps(n):
        for _ in range(n):
            trainer.train_step(next(feed))

    if lead:
        program = follow(trainer, feed, cfg, n_check,
                         {"params": w0, "mu": None}, None)
    else:
        steps(n_check)
    del w0
    steps(int(traffic["warmup_steps"]))
    drawn = n_check + int(traffic["warmup_steps"])
    if cuda:
        torch.cuda.synchronize(device)
    setup_s = time.perf_counter() - t_proc

    go = torch.zeros(1, dtype=torch.int32)
    done = 0
    t0 = time.perf_counter()
    end = t0 + float(job["seconds"])
    while True:
        if lead:
            go[0] = int(time.perf_counter() < end)
        dist.broadcast(go, 0, group=gloo)
        if not int(go[0]):
            break
        for _ in range(CHUNK):
            last, _ = trainer.train_step(next(feed))
        done += CHUNK
    if cuda:
        torch.cuda.synchronize(device)
    elapsed = time.perf_counter() - t0
    drawn += done

    sliced = None
    if job["trace"]:
        n = int(traffic["trace_steps"])
        if lead:
            def body():
                for _ in range(n):
                    with devtrace.annotate("portbench.feed", True):
                        b = next(feed)
                    with devtrace.annotate("portbench.train_step", True):
                        trainer.train_step(b)
            sliced = profiled_slice(body, device)
            sliced["steps"] = n
            sliced["examples"] = n * int(traffic["batch"])
        else:
            steps(n)
        drawn += n
    peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    replicas = [torch.zeros(2 * len(trainer.params) + 1, dtype=torch.float64)
                for _ in range(world)]
    dist.all_gather(replicas, fingerprint(trainer.params, drawn), group=gloo)

    pool_size = len(pool)
    steady_batches = [pool[(drawn + i) % pool_size] for i in range(n_check)]
    if lead:
        program["last_loss"] = float(last)
        steady_start = snapshot(trainer)
        steady = follow(trainer, feed, cfg, n_check, steady_start,
                        table_rows(cfg, steady_batches[0], device))
        out = {
            "setup_s": setup_s,
            "window_s": elapsed,
            "attempted": done,
            "failed": 0,
            "examples_done": done * int(traffic["batch"]),
            "spans": {},
            "slice": sliced,
            "memory_peak_bytes": peak,
            "program": program,
            "check_batches": pool[:n_check],
            "steady": steady,
            "steady_batches": steady_batches,
            "steady_start": steady_start,
            "steady_count": drawn,
            "replicas": [r.tolist() for r in replicas],
        }
    else:
        steps(n_check)
        out = None
    del model, trainer, feed, pool
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    return out


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _join(rank: int, world: int, port: int, device):
    """Join the job (NCCL on cards, gloo on the CPU) and make the gloo
    group the window's go-ahead travels on."""
    if device.type == "cuda":
        torch.cuda.set_device(device)
    dist.init_process_group(
        "nccl" if device.type == "cuda" else "gloo",
        init_method=f"tcp://127.0.0.1:{port}", rank=rank, world_size=world,
        timeout=datetime.timedelta(seconds=TIMEOUT_S))
    return dist.new_group(backend="gloo")


def _leave():
    dist.barrier()
    dist.destroy_process_group()


def worker() -> None:
    """A rank above 0: its job from the environment, its card LOCAL_RANK."""
    job = json.loads(os.environ[ENV])
    rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
    device = torch.device("cuda", int(os.environ["LOCAL_RANK"])) \
        if job["device"] == "cuda" else torch.device("cpu")
    gloo = _join(rank, world, int(os.environ["MASTER_PORT"]), device)
    rank_run(job, rank, world, device, gloo, time.perf_counter())
    _leave()


def run(cell: dict, seed: int, seconds: float, trace: bool, device,
        t_proc: float) -> dict:
    world = int(cell["chips"])
    port = _free_port()
    job = {"config": cell["config"], "traffic": cell["traffic"],
           "seed": int(seed), "seconds": float(seconds),
           "trace": bool(trace), "device": device.type}
    root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    env = dict(os.environ, MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port),
               WORLD_SIZE=str(world), PYTHONPATH=os.pathsep.join(
                   p for p in (root, os.environ.get("PYTHONPATH")) if p))
    env[ENV] = json.dumps(job)
    if device.type == "cpu":
        env["OMP_NUM_THREADS"] = "1"
    logs, procs = [], []
    try:
        for rank in range(1, world):
            log = tempfile.TemporaryFile(mode="w+")
            logs.append(log)
            procs.append(subprocess.Popen(
                [sys.executable, "-m", "portbench.drivers.train_dp"],
                cwd=root, env=dict(env, RANK=str(rank),
                                   LOCAL_RANK=str(rank)),
                stdout=log, stderr=subprocess.STDOUT))
        gloo = _join(0, world, port, device)
        out = rank_run(job, 0, world, device, gloo, t_proc)
        _leave()
        for r, p in enumerate(procs, start=1):
            if p.wait(timeout=TIMEOUT_S) != 0:
                logs[r - 1].seek(0)
                raise RuntimeError(f"rank {r} exited {p.returncode}:\n"
                                   f"{logs[r - 1].read()[-6000:]}")
        return out
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for log in logs:
            log.close()


if __name__ == "__main__":
    worker()
