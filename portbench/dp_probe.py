"""A probe of the data-parallel driver (`drivers/train_dp.py`) at chosen
seeds: whether a failed check of its state after the window is a fault of
the program's data-parallel step or of the driver around it.

    python3 portbench/dp_probe.py --seeds 2718281829,1618033989 \
        [--repeats 2] [--seconds 3]

on a machine with four cards (the cell `dlrm-kaggle.train-dp4`, which no
entry of BENCHMARK.json runs yet). Each seed runs `repeats` times, all in
this one process, as `control.py` runs them. After each run it prints one
JSON line with:

- `readings`: `reference/dlrm.py`'s check of the run, as `correct` reads
  it;
- `replicas_equal`: whether every rank took the same steps and holds the
  same replica (`train_dp.fingerprint`) after the window;
- `batch_shift`: the reference's loss at rank 0's copied state on the
  pool's batches around the one the steady check fed (shift 0), beside
  the program's first steady loss: a miscount of the batches drawn shows
  as a shift other than 0 matching;
- `one_process`: the port's one-process sparse step (`drivers/train.py`'s
  trainer) over the same global batches for as many steps, against rank
  0's copied state: each leaf's largest gap and relative norm gap, and
  the reference's loss on the steady batch at both states.
"""

import argparse
import copy
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import torch  # noqa: E402

from portbench import harness, traffic as traffic_lib  # noqa: E402

CELL = "dlrm-kaggle.train-dp4"


def dp4_cell(root: Path = harness.ROOT) -> dict:
    """The four-card cell as `harness.load_cell` would resolve it, from its
    files alone (BENCHMARK.json has no entry for it)."""
    bench = json.loads((root / "BENCHMARK.json").read_text())
    pkg = root / "portbench"
    wl = json.loads((pkg / "workloads" / f"{CELL}.json").read_text())
    entry = [c for c in bench["configs"] if c["name"] == wl["config"]][0]
    e2e = [m for m in bench["end_to_end"]
           if m["name"] in ("setup_s", "train_examples_per_s")]
    layer = [{"name": "dp.allreduce_ms", "unit": "ms", "better": "lower",
              "source": "device_trace", "layer": "kernels",
              "moves": "train_examples_per_s"}]
    return {"name": CELL, "chips": 4,
            "config": json.loads((root / entry["file"]).read_text()),
            "traffic": json.loads(
                (pkg / "traffic" / f"{wl['traffic']}.json").read_text()),
            "limits": wl["limits"], "end_to_end": e2e, "per_layer": layer,
            "pkg": pkg}


def _loss(reference, cfg: dict, params: dict, batch: dict, device) -> float:
    """The reference's loss of `batch` (host tensors) at `params`."""
    offsets = torch.tensor([0, *cfg["ln_emb"][:-1]], device=device) \
        .cumsum(0)
    b = {k: v.to(device) for k, v in batch.items()}
    ids = (b["sparse_features"].long() + offsets).reshape(-1)
    uniq, inv = torch.unique(ids, return_inverse=True)
    dense = {n: v for n, v in params.items() if n != "embed_fused"}
    with torch.no_grad():
        return float(reference.forward(cfg, dense,
                                       params["embed_fused"][uniq], inv, b))


def one_process(cell: dict, seed: int, pool: list, steps: int,
                device) -> dict:
    """The port's one-process trainer after `steps` steps over `pool`
    (global batches, in the order the ranks drew them): its parameters."""
    from portbench.drivers import train
    model, trainer, _ = train.build(cell["config"], seed, device)
    for i in range(steps):
        trainer.train_step({k: v.to(device, non_blocking=True)
                            for k, v in pool[i % len(pool)].items()})
    params = {n: p.detach().clone() for n, p in trainer.params.items()}
    del model, trainer
    return params


def probe(cell: dict, seed: int, seconds: float, device) -> dict:
    """One run of the data-parallel driver at `seed`, and its witnesses."""
    from portbench.drivers import train_dp
    reference = harness.module(cell["config"]["reference"])
    cfg = cell["config"]
    tf32 = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    run = train_dp.run(cell, seed, seconds, False, device,
                       time.perf_counter())
    reps = run["replicas"]
    count = run["steady_count"]
    start = run["steady_start"]["params"]
    pool = traffic_lib.train_pool(cell["traffic"], cfg, seed, device,
                                  pin=False)
    program = run["steady"]["losses"][0]
    shift = {d: _loss(reference, cfg, start, pool[(count + d) % len(pool)],
                      device) - program for d in (-2, -1, 0, 1, 2)}
    torch.backends.cuda.matmul.allow_tf32 = bool(cfg["tf32"])
    torch.backends.cudnn.allow_tf32 = bool(cfg["tf32"])
    alone = one_process(cell, seed, pool, count, device)
    (torch.backends.cuda.matmul.allow_tf32,
     torch.backends.cudnn.allow_tf32) = tf32
    gaps = {}
    for name, p in start.items():
        d = (p - alone[name]).abs()
        gaps[name] = {"max": float(d.max()),
                      "rel_norm": float(d.norm() / alone[name].norm())}
    steady_batch = pool[count % len(pool)]
    losses = {"dp_state": _loss(reference, cfg, start, steady_batch, device),
              "one_process": _loss(reference, cfg, alone, steady_batch,
                                   device)}
    del alone
    readings = reference.check(cell, seed, run, device)
    return {"seed": seed, "steps": count, "attempted": run["attempted"],
            "readings": readings,
            "replicas_equal": all(r == reps[0] for r in reps),
            "replicas": reps if any(r != reps[0] for r in reps) else None,
            "program_first_steady_loss": program,
            "batch_shift": shift,
            "one_process": {"leaf_gaps": gaps, "steady_loss": losses}}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--repeats", type=int, default=2)
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    cell = dp4_cell()
    device = torch.device(args.device)
    if device.type == "cuda":
        device = torch.device("cuda", 0)
    for seed in (int(s) for s in args.seeds.split(",")):
        for _ in range(args.repeats):
            out = probe(copy.deepcopy(cell), seed, args.seconds, device)
            print(json.dumps(out), flush=True)
            if device.type == "cuda":
                torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
