"""Training driver: `Trainer.train_step` fed by `device_iterator`.

Set-up builds one trainer holding the seed's weights and drives it
through its first `check_steps` steps on the pool's first batches, through
the window's own feed and call: the reference follows these from the
seed's weights. `warmup_steps` more steps follow, and the same trainer and
feed go on into the window. The window's rate is the examples of every
step dispatched in it over the time from its first dispatch to the
synchronize that ends it.

Once the window (and a traced run's profiled slice) has closed, the
trainer's parameters and both Adams' moments are copied, and
`check_steps` more steps run through the same trainer and feed: the
reference follows these from that copy, so a fault that shows only in the
steady state (a replay of a stale batch, a skipped update) shows there.
Each check reads the steps' losses, every leaf's first gradient as the
optimizer state holds it, and each leaf's change over the steps.
"""

from __future__ import annotations

import gc
import inspect
import itertools
import time

import torch

from portbench import devtrace, traffic as traffic_lib, weights


def build(cfg: dict, seed: int, device):
    """(model, trainer, initial weights): the port's DLRM on fused tables
    as the configuration states it, holding the seed's weights, under the
    trainer's O(batch) sparse step."""
    from openrec_tpu_torch.models import DLRM
    from openrec_tpu_torch.training import Trainer
    from openrec_tpu_torch.training.sparse import (dlrm_fused_table_spec,
                                                   make_sparse_train_step)
    if cfg["dtype"] != "float32":
        raise ValueError("the driver runs fp32 DLRM")
    opt = cfg["optimizer"]
    port = inspect.signature(make_sparse_train_step).parameters
    for key in ("b1", "b2", "eps"):
        if opt[key] != port[key].default:
            raise ValueError(f"the trainer's Adam has {key} "
                             f"{port[key].default}, the configuration "
                             f"{opt[key]}")
    model = DLRM(m_spa=cfg["m_spa"], ln_emb=cfg["ln_emb"],
                 ln_bot=cfg["ln_bot"], ln_top=cfg["ln_top"],
                 dim_dense=cfg["dim_dense"],
                 arch_interaction_op=cfg["interaction"],
                 loss_func=cfg["loss"], fused_tables=True,
                 compute_dtype=cfg["dtype"], device=device)
    w = weights.dlrm_weights(cfg, seed, device)
    model.load_params(w)
    trainer = Trainer(model, lr=opt["lr"], device=device,
                      sparse_tables=dlrm_fused_table_spec(
                          model, mode=cfg["dedup"]))
    return model, trainer, w


def moments(trainer) -> tuple:
    """({leaf: first moment}, {leaf: second moment}) of both Adams, the
    trainer's own tensors."""
    sparse, dense = trainer.opt_state["sparse"], trainer.opt_state["dense"]
    mu = {"/".join(path): m for path, m in sparse.mu.items()}
    nu = {"/".join(path): v for path, v in sparse.nu.items()}
    mu.update(dense[0].mu)
    nu.update(dense[0].nu)
    return mu, nu


def state_grads(trainer, cfg: dict, mu0: dict | None = None,
                rows=None) -> dict:
    """{leaf: norm of the last step's gradient}, from the first moments:
    mu = b1 * mu0 + (1 - b1) * gradient, with mu0 the moments before the
    step (None: zero). `rows`, where given, are the table rows the step's
    batch holds: a lazy step leaves the others' moments as they were."""
    b1 = cfg["optimizer"]["b1"]
    out = {}
    with torch.no_grad():
        for name, m in moments(trainer)[0].items():
            if mu0 is None:
                g = m
            elif name == "embed_fused":
                g = m[rows] - b1 * mu0[name][rows]
            else:
                g = m - b1 * mu0[name]
            out[name] = float(g.norm()) / (1.0 - b1)
    return out


def snapshot(trainer) -> dict:
    """A copy of the trainer's state: {"params", "mu", "nu"}, by leaf."""
    mu, nu = moments(trainer)
    with torch.no_grad():
        return {"params": {n: p.detach().clone()
                           for n, p in trainer.params.items()},
                "mu": {n: m.clone() for n, m in mu.items()},
                "nu": {n: v.clone() for n, v in nu.items()}}


def table_rows(cfg: dict, batch: dict, device) -> torch.Tensor:
    """The fused table's rows that a (host) batch looks up."""
    offsets = torch.tensor([0, *cfg["ln_emb"][:-1]], device=device) \
        .cumsum(0)
    ids = batch["sparse_features"].to(device).long() + offsets
    return torch.unique(ids.reshape(-1))


def follow(trainer, feed, cfg: dict, steps: int, start: dict,
           rows) -> dict:
    """`steps` steps of the trainer from the state `start` (a snapshot):
    the losses, the first step's gradients (`rows`: its batch's table
    rows), each leaf's change and the table rows that changed."""
    losses, grads = [], None
    for step in range(steps):
        loss, _ = trainer.train_step(next(feed))
        losses.append(float(loss))
        if step == 0:
            grads = state_grads(trainer, cfg, start["mu"], rows)
    with torch.no_grad():
        params = trainer.params
        w0 = start["params"]
        change = {n: float((p - w0[n]).norm()) for n, p in params.items()}
        changed = int((params["embed_fused"] != w0["embed_fused"])
                      .any(1).sum())
    return {"losses": losses, "grads": grads, "change": change,
            "changed_rows": changed}


def run(cell: dict, seed: int, seconds: float, trace: bool, device,
        t_proc: float) -> dict:
    cfg, traffic = cell["config"], cell["traffic"]
    cuda = device.type == "cuda"
    torch.backends.cuda.matmul.allow_tf32 = bool(cfg["tf32"])
    torch.backends.cudnn.allow_tf32 = bool(cfg["tf32"])
    from openrec_tpu_torch.data.pipeline import device_iterator
    model, trainer, w0 = build(cfg, seed, device)
    pool = traffic_lib.train_pool(traffic, cfg, seed, device, pin=cuda)
    feed = device_iterator(itertools.cycle(pool), device,
                           prefetch=int(traffic["prefetch"]))
    n_check = int(traffic["check_steps"])
    drawn = 0                      # batches taken from the feed so far

    start = {"params": w0, "mu": None}
    program = follow(trainer, feed, cfg, n_check, start, None)
    drawn += n_check
    del w0, start
    for _ in range(int(traffic["warmup_steps"])):
        trainer.train_step(next(feed))
    drawn += int(traffic["warmup_steps"])
    if cuda:
        torch.cuda.synchronize(device)
    setup_s = time.perf_counter() - t_proc

    B = int(traffic["batch"])
    spans = devtrace.Spans(on=trace)
    steps = 0
    t0 = time.perf_counter()
    end = t0 + seconds
    while time.perf_counter() < end:
        with spans("feed.next"):
            batch = next(feed)
        with spans("train.step"):
            last, _ = trainer.train_step(batch)
        steps += 1
    if cuda:
        torch.cuda.synchronize(device)
    elapsed = time.perf_counter() - t0
    spans.on = False
    drawn += steps
    program["last_loss"] = float(last)

    sliced = None
    if trace:
        n = int(traffic["trace_steps"])

        def body():
            for _ in range(n):
                with devtrace.annotate("portbench.feed", True):
                    b = next(feed)
                with devtrace.annotate("portbench.train_step", True):
                    trainer.train_step(b)

        sliced = devtrace.profiled_slice(body, device)
        sliced["steps"] = n
        sliced["examples"] = n * B
        drawn += n
    peak = torch.cuda.max_memory_allocated(device) if cuda else 0

    P = len(pool)
    check_batches = pool[:n_check]
    steady_batches = [pool[(drawn + i) % P] for i in range(n_check)]
    steady_start = snapshot(trainer)
    steady = follow(trainer, feed, cfg, n_check, steady_start,
                    table_rows(cfg, steady_batches[0], device))
    del model, trainer, feed, pool
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    return {
        "setup_s": setup_s,
        "window_s": elapsed,
        "attempted": steps,
        "failed": 0,
        "examples_done": steps * B,
        "spans": dict(spans.durations),
        "slice": sliced,
        "memory_peak_bytes": peak,
        "program": program,
        "check_batches": check_batches,
        "steady": steady,
        "steady_batches": steady_batches,
        "steady_start": steady_start,
        "steady_count": drawn,
    }
