"""Finds a cell by name, runs it once, reads its metrics, judges it and
prints the result.

Everything that belongs to one cell, configuration, traffic mix or
metric sits in a file of its own, found by the name `BENCHMARK.json`
gives it:

- `workloads/<cell>.json`: the cell's configuration and traffic (as
  `BENCHMARK.json` names them) and the limit of each number compared;
- `configs/<config>.json`: the sizes, with the path of the plain
  reference (`reference`) beside them;
- `traffic/<traffic>.json`: the mix's parameters, with the `driver` that
  runs it (`drivers/<driver>.py`);
- `metrics/<metric>.py`: a reader, `read(ctx) -> float | None`, of one
  end-to-end or per-layer metric from the run's host clocks, spans,
  counts and profiled slice. None leaves the metric out of the line.

A cell reports the end-to-end metrics whose `workloads` list it (or that
have none), and with `--trace 1` the per-layer metrics whose `workloads`
list it (or, without the key, those whose `moves` it reports).
"""

from __future__ import annotations

import importlib
import importlib.util
import json
import math
import sys
from pathlib import Path

import torch

PKG = Path(__file__).resolve().parent
ROOT = PKG.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "openrec_tpu")


def _load(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def _applies(metric: dict, cell: str, fallback: bool) -> bool:
    if "workloads" in metric:
        return cell in metric["workloads"]
    return fallback


def reader(name: str, pkg: Path = PKG):
    """The `read` function of `metrics/<name>.py`."""
    path = pkg / "metrics" / f"{name}.py"
    if not path.is_file():
        raise FileNotFoundError(f"no reader for metric {name!r} at {path}")
    spec = importlib.util.spec_from_file_location(
        f"portbench_metric_{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def load_cell(name: str, root: Path = ROOT) -> dict:
    """The cell `name` of `root/BENCHMARK.json`, resolved through its
    files under `root/portbench`; raises on anything missing or at odds."""
    bench = _load(root / "BENCHMARK.json")
    pkg = root / "portbench"
    entries = [w for w in bench["workloads"] if w["name"] == name]
    if len(entries) != 1:
        raise KeyError(f"BENCHMARK.json has no workload {name!r}")
    entry = entries[0]
    wl = _load(pkg / "workloads" / f"{name}.json")
    for key in ("config", "traffic"):
        if wl[key] != entry[key]:
            raise ValueError(f"workloads/{name}.json names {key} "
                             f"{wl[key]!r}, BENCHMARK.json {entry[key]!r}")
    configs = [c for c in bench["configs"] if c["name"] == entry["config"]]
    if len(configs) != 1:
        raise KeyError(f"BENCHMARK.json has no config {entry['config']!r}")
    config = _load(root / configs[0]["file"])
    traffic = _load(pkg / "traffic" / f"{entry['traffic']}.json")
    e2e = [m for m in bench["end_to_end"] if _applies(m, name, True)]
    e2e_names = {m["name"] for m in e2e}
    layer = [m for m in bench["per_layer"]
             if _applies(m, name, m["moves"] in e2e_names)]
    for m in e2e + layer:
        reader(m["name"], pkg)
    for module in (f"drivers/{traffic['driver']}.py", config["reference"]):
        if not (pkg / module).is_file():
            raise FileNotFoundError(f"portbench/{module} is missing")
    return {"name": name, "chips": int(entry["chips"]), "config": config,
            "traffic": traffic, "limits": wl["limits"], "end_to_end": e2e,
            "per_layer": layer, "pkg": pkg}


def module(relpath: str):
    mod = relpath[:-3].replace("/", ".")
    return importlib.import_module(f"portbench.{mod}")


def judge(readings: dict, limits: dict) -> tuple:
    """(correct, checks): every limit's number must be present, finite
    and at most its limit."""
    checks, ok = {}, True
    for key, limit in limits.items():
        value = readings.get(key)
        good = value is not None and math.isfinite(value) \
            and value <= limit
        ok = ok and good
        checks[key] = {"value": value, "limit": limit}
    return ok, checks


def run_cell(cell: dict, seed: int, seconds: float, trace: bool, device,
             t_proc: float) -> dict:
    """One run of `cell` on `device`: the result's fields, its checks
    last."""
    driver = module(f"drivers/{cell['traffic']['driver']}.py")
    run = driver.run(cell, seed, seconds, trace, device, t_proc)
    ctx = {**run, "cell": cell, "seed": seed, "trace": trace}
    metrics = {}
    for m in (cell["per_layer"] if trace else cell["end_to_end"]):
        value = reader(m["name"], cell["pkg"])(ctx)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    reference = module(cell["config"]["reference"])
    readings = reference.check(cell, seed, run, device)
    correct, checks = judge(readings, cell["limits"])
    correct = correct and run["failed"] == 0 and run["attempted"] > 0
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": (torch.cuda.get_device_name(device)
                    if device.type == "cuda" else "cpu"),
           "count": cell["chips"],
           "memory_peak_bytes": int(run["memory_peak_bytes"])}
    out = {"correct": bool(correct), "attempted": int(run["attempted"]),
           "failed": int(run["failed"]), "metrics": metrics, "device": dev}
    if trace and run.get("slice"):
        dev["busy_s"] = run["slice"]["busy_s"]
        dev["window_s"] = run["slice"]["window_s"]
        out["breakdown"] = {"device_ops": run["slice"]["device_ops"],
                            "idle_gaps": run["slice"]["idle_gaps"]}
    out["readings"] = readings
    out["checks"] = checks
    return out


def forbidden_modules() -> list:
    return sorted(m for m in sys.modules if m.split(".")[0] in FORBIDDEN)


def main(argv, t_proc: float) -> int:
    import argparse
    ap = argparse.ArgumentParser(
        description="Run one cell of BENCHMARK.json once on the card and "
                    "print its result as the last line of stdout.")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    cell = load_cell(args.workload)
    if not torch.cuda.is_available() \
            or torch.cuda.device_count() < cell["chips"]:
        print(f"portbench: the cell needs {cell['chips']} CUDA device(s); "
              f"available: {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    out = run_cell(cell, args.seed, args.seconds, bool(args.trace),
                   torch.device("cuda", 0), t_proc)
    found = forbidden_modules()
    if found:
        print(f"portbench: the run loaded {found}", file=sys.stderr)
        return 3
    print(f"readings {json.dumps(out['readings'])}", file=sys.stderr)
    for key, c in out["checks"].items():
        print(f"check {key} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0
