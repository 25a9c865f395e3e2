"""Where does a host-fed training run on the card stop repeating itself?

Phase 7 of `chip_smoke.py` trains WRMF at CiteULike width (5,551 users x
16,980 items, dim 50, batch 1,000, lazy_adam lr 1e-3) for 300 steps from
the C++ stratified feed with 2 workers. Two runs of the same checkout
need not reach the same weights. This script runs the pieces apart, on
phase 7's data and seed:

  feed     the first 300 batches of two fresh 2-worker feeds: the same
           sequence, and the same batches in any order;
  card     300 steps on one fixed list of batches, from one init, twice
           by default and twice under torch.use_deterministic_algorithms:
           bit-equal weights, and the largest difference;
  metrics  val AUC and Recall@50 of each run's weights (the spread the
           card's arithmetic alone leaves), then 200 device-sampled steps
           (phase 7's second leg) from each run's weights and from a fresh
           init: how much each moves val Recall@50.

    python3 repeat_check.py [--seed 0] [--out chiprun_out/repeat.json]

Needs one CUDA device; prints one JSON object as its last line.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    # cuBLAS repeats itself only with a fixed workspace
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    import torch
    if not torch.cuda.is_available():
        print("repeat_check: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    import openrec_tpu_torch as port
    from openrec_tpu_torch.data import Dataset, loaders
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    seed, run = args.seed, cs.ZOO
    B, k, steps = cs.TRAIN["batch"], run["k"], run["steps"]
    raw = cs.citeulike_data(loaders, seed)
    U, I = raw["total_users"], raw["total_items"]
    train_ds = Dataset(raw["train_data"], U, I, seed=seed)
    val = Dataset(raw["val_data"], U, I, seed=seed).evaluation(
        cs.BATCH, excl_datasets=[train_ds], device_masks=True)
    out = {"device": torch.cuda.get_device_name(0),
           "nvidia_smi": cs.nvidia_smi("name,power.limit"),
           "torch": torch.__version__}

    def feed_batches():
        feed = train_ds.stratified_pointwise(
            batch_size=B, pos_ratio=run["pos_ratio"], num_parallel_calls=2)
        it = iter(feed)
        got = [next(it) for _ in range(steps)]
        feed.stop()
        return got

    def digest(batch):
        return b"".join(np.ascontiguousarray(batch[key]).tobytes()
                        for key in sorted(batch))

    feeds = [[digest(b) for b in feed_batches()] for _ in range(2)]
    out["feed"] = {"batches": steps,
                   "same_sequence": feeds[0] == feeds[1],
                   "same_batches_any_order":
                       sorted(feeds[0]) == sorted(feeds[1]),
                   "positions_that_differ":
                       sum(a != b for a, b in zip(*feeds))}

    batches = feed_batches()

    def fresh():
        gen = torch.Generator(device=dev).manual_seed(seed)
        model = port.WRMF(U, I, cs.TRAIN["dim"], cs.TRAIN["dim"], device=dev,
                          generator=gen)
        return port.Trainer(model, lr=cs.TRAIN["lr"], seed=seed, device=dev)

    def metrics(trainer):
        ev = trainer.evaluate(val, at=(50,))
        return {"AUC": float(ev["AUC"]), "Recall@50": float(ev["Recall"][0])}

    def train(deterministic):
        torch.use_deterministic_algorithms(deterministic, warn_only=True)
        trainer = fresh()
        for c in range(0, steps, k):
            trainer.train_step_multi(batches[c:c + k])
        torch.cuda.synchronize()
        torch.use_deterministic_algorithms(False)
        return trainer

    def compare(a, b):
        pa, pb = a.model.params(), b.model.params()
        return {"bit_equal": all(torch.equal(pa[key], pb[key])
                                 for key in pa),
                "max_abs_diff": max((pa[key] - pb[key]).abs().max().item()
                                    for key in pa)}

    def device_leg(trainer):
        sampler = port.DevicePointwiseSampler(
            train_ds.store, B, pos_ratio=run["pos_ratio"], device=dev)
        start = metrics(trainer)
        for _ in range(run["device_steps"] // k):
            trainer.train_steps_device(sampler, k)
        end = metrics(trainer)
        return {"start": start, "end": end,
                "recall_delta": end["Recall@50"] - start["Recall@50"]}

    default = [train(False) for _ in range(3)]
    det = [train(True) for _ in range(2)]
    out["card"] = {
        "default": [compare(default[0], t) for t in default[1:]],
        "deterministic": compare(*det),
        "deterministic_vs_default": compare(det[0], default[0])}
    out["metrics"] = {"default": [metrics(t) for t in default],
                      "deterministic": [metrics(t) for t in det]}
    out["device_leg"] = {"from_trained": [device_leg(t) for t in default],
                         "from_init": device_leg(fresh())}
    line = json.dumps(out)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(line + "\n")
    print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
