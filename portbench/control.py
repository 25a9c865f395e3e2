"""Readings for the limits of `correct`: the program's, the control's and
the planted faults', at a cell's own size, on several seeds in one
process.

    python3 portbench/control.py --workload <cell> --seeds 11,12,13 \
        [--seconds 2] [--variants program,control,half_batch]

Variants:
- program: the port as the configuration states it (one short run);
- control: the reference put in the program's place one precision below
  the configuration's: fp8 (e4m3, one scale per table) tables for a
  served bf16 model; for fp32 training the port with TF32 on;
- half_batch (training): the port's loss over the first half of each
  batch, as if the rest were left out.

Prints one JSON line per seed and variant with the readings; it is not
part of a benchmark run.
"""

import argparse
import copy
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import torch  # noqa: E402

from portbench import harness  # noqa: E402


def _half_batch(model):
    """The loss of `model` over the first half of each batch only."""
    loss = model.loss

    def half(batch, tables=None, generator=None):
        n = batch["label"].shape[0] // 2
        return loss({k: v[:n] for k, v in batch.items()}, tables=tables,
                    generator=generator)
    model.loss = half


def readings(cell, seed, seconds, variant, device):
    driver = harness.module(f"drivers/{cell['traffic']['driver']}.py")
    reference = harness.module(cell["config"]["reference"])
    cell = copy.deepcopy(cell)
    serve = cell["traffic"]["driver"] == "serve"
    if variant == "control" and not serve:
        cell["config"]["tf32"] = True
    if variant == "half_batch":
        build = driver.build

        def patched(*a, **kw):
            model, trainer, w = build(*a, **kw)
            _half_batch(model)
            return model, trainer, w
        driver.build = patched
    try:
        run = driver.run(cell, seed, seconds, False, device,
                         time.perf_counter())
    finally:
        if variant == "half_batch":
            driver.build = build
    if variant == "control" and serve:
        return reference.control(cell, seed, run["sample"], device)
    return reference.check(cell, seed, run, device)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--variants", default="program,control")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    cell = harness.load_cell(args.workload)
    device = torch.device(args.device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", 0)
    for seed in (int(s) for s in args.seeds.split(",")):
        for variant in args.variants.split(","):
            r = readings(cell, seed, args.seconds, variant, device)
            print(json.dumps({"workload": args.workload, "seed": seed,
                              "variant": variant, **r}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
