"""The multi-hot DLRM-DCNv2 cell's training run: `Trainer.train_step`
on the port's `DLRM(arch_interaction_op="dcn", multi_hot=...)` over fused
tables, fed by `device_iterator`.

It runs as `drivers/train.py` does: set-up builds one trainer holding the
seed's weights and drives it through its first `check_steps` steps on
the pool's first batches (the reference follows these from the seed's
weights), then `warmup_steps` more; the same trainer and feed go on into
the window, whose rate is the examples of every step dispatched in it
over the time from its first dispatch to the synchronize that ends it.
The peak memory is read from the window's start: the set-up's copy of
the seed's table, held for the first check, is no deployment's.

A traced run profiles `trace_steps` more steps with the program's own
tracer on (`openrec_tpu_torch/trace.py`), and reduces the slice both by
device operation (`devtrace.reduce_trace`) and by the program's spans
(`progtrace.reduce_program`); its counters are read over the slice.

After the window `check_steps` more steps run from a copy of the state:
the dense leaves and their Adam moments whole, and of the table (13.57
GB, which a second copy with both moments would not leave room for) the
rows those steps look up with their moments. The program's changed rows
and the table's change are still read over the whole table, against a
copy of the table alone (from the seed's weights for the first check),
a block of rows at a time; the copy is freed before the reference
runs.
"""

from __future__ import annotations

import gc
import inspect
import itertools
import time

import torch

from portbench import (devtrace, progtrace, slice_events, traffic_multihot,
                       weights_dcn)
from portbench.drivers.train import moments
from portbench.reference.dlrm_dcnv2 import batch_rows


def build(cfg: dict, seed: int, device):
    """(model, trainer, initial weights): the port's DLRM-DCNv2 on fused
    tables as the configuration states it, holding the seed's weights,
    under the trainer's O(batch) sparse step."""
    from openrec_tpu_torch.models import DLRM
    from openrec_tpu_torch.training import Trainer
    from openrec_tpu_torch.training.sparse import (dlrm_fused_table_spec,
                                                   make_sparse_train_step)
    if cfg["dtype"] != "float32":
        raise ValueError("this cell runs fp32 DLRM")
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
                 dcn_layers=cfg["dcn_layers"], dcn_rank=cfg["dcn_rank"],
                 multi_hot=cfg["multi_hot"], loss_func=cfg["loss"],
                 fused_tables=True, compute_dtype=cfg["dtype"],
                 device=device)
    w = weights_dcn.dcn_weights(cfg, seed, device)
    model.load_params(w)
    trainer = Trainer(model, lr=opt["lr"], device=device,
                      sparse_tables=dlrm_fused_table_spec(
                          model, mode=cfg["dedup"]))
    return model, trainer, w


def steady_copy(trainer, rows) -> tuple:
    """(the reference's start, a copy of the whole table): the dense
    leaves and their moments whole; of the table and its moments the
    sorted `rows` alone."""
    mu, nu = moments(trainer)
    with torch.no_grad():
        params = {n: p.detach().clone() for n, p in trainer.params.items()
                  if n != "embed_fused"}
        table = trainer.params["embed_fused"].detach()
        params["embed_fused"] = table[rows]
        state = {"rows": rows, "params": params,
                 "mu": {n: (m[rows] if n == "embed_fused" else m.clone())
                        for n, m in mu.items()},
                 "nu": {n: (v[rows] if n == "embed_fused" else v.clone())
                        for n, v in nu.items()}}
        return state, table.clone()


def table_change(table, table0, chunk: int = 1 << 20) -> tuple:
    """(norm of table - table0, rows that differ), a block of rows at a
    time, so no temporary of the table's size is made."""
    sq, changed = 0.0, 0
    with torch.no_grad():
        for lo in range(0, table.shape[0], chunk):
            a, b = table[lo:lo + chunk], table0[lo:lo + chunk]
            sq += float(((a - b) ** 2).sum(dtype=torch.float64))
            changed += int((a != b).any(1).sum())
    return sq ** 0.5, changed


def follow_from(trainer, feed, cfg: dict, steps: int, start: dict,
                table0, first_rows) -> dict:
    """`steps` steps of the trainer from the state `start` ({"rows",
    "params", "mu"} as `steady_copy` gives it; "mu" None: zero moments),
    as `drivers/train.follow`: the losses, the first step's gradients
    (the table's at `first_rows`, the first batch's rows), each leaf's
    change, and the table's change and changed rows over the whole table
    against `table0`."""
    b1 = cfg["optimizer"]["b1"]
    losses, grads = [], None
    for step in range(steps):
        loss, _ = trainer.train_step(next(feed))
        losses.append(float(loss))
        if step == 0:
            grads = {}
            with torch.no_grad():
                for name, m in moments(trainer)[0].items():
                    if name == "embed_fused":
                        g = m[first_rows]
                        if start["mu"] is not None:
                            at = torch.searchsorted(start["rows"],
                                                    first_rows)
                            g = g - b1 * start["mu"][name][at]
                    else:
                        g = m if start["mu"] is None \
                            else m - b1 * start["mu"][name]
                    grads[name] = float(g.norm()) / (1.0 - b1)
    with torch.no_grad():
        params = trainer.params
        change = {n: float((p - start["params"][n]).norm())
                  for n, p in params.items() if n != "embed_fused"}
        change["embed_fused"], changed = table_change(
            params["embed_fused"], table0)
    return {"losses": losses, "grads": grads, "change": change,
            "changed_rows": changed}


def profiled_slice(body, device) -> tuple:
    """(`devtrace.reduce_trace`, `progtrace.reduce_program`) of `body()`'s
    profiled slice."""
    events = slice_events.profiled_events(body, device)
    return devtrace.reduce_trace(events), progtrace.reduce_program(events)


def run(cell: dict, seed: int, seconds: float, trace: bool, device,
        t_proc: float) -> dict:
    from openrec_tpu_torch import trace as tracer
    from openrec_tpu_torch.data.pipeline import device_iterator
    cfg, traffic = cell["config"], cell["traffic"]
    cuda = device.type == "cuda"
    torch.backends.cuda.matmul.allow_tf32 = bool(cfg["tf32"])
    torch.backends.cudnn.allow_tf32 = bool(cfg["tf32"])
    model, trainer, w0 = build(cfg, seed, device)
    pool = traffic_multihot.train_pool(traffic, cfg, seed, device, pin=cuda)
    feed = device_iterator(itertools.cycle(pool), device,
                           prefetch=int(traffic["prefetch"]))
    n_check = int(traffic["check_steps"])
    drawn = 0                      # batches taken from the feed so far

    program = follow_from(trainer, feed, cfg, n_check,
                          {"params": w0, "mu": None}, w0["embed_fused"],
                          batch_rows(cfg, pool[:1], device))
    drawn += n_check
    del w0
    for _ in range(int(traffic["warmup_steps"])):
        trainer.train_step(next(feed))
    drawn += int(traffic["warmup_steps"])
    if cuda:
        torch.cuda.synchronize(device)
        torch.cuda.reset_peak_memory_stats(device)
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

    sliced, by_span, counters = None, None, {}
    if trace:
        n = int(traffic["trace_steps"])

        def body():
            for _ in range(n):
                with devtrace.annotate("portbench.feed", True):
                    b = next(feed)
                with devtrace.annotate("portbench.train_step", True):
                    trainer.train_step(b)

        was = tracer.enable(True)
        tracer.reset()
        try:
            sliced, by_span = profiled_slice(body, device)
            counters = tracer.snapshot()["counters"]
        finally:
            tracer.enable(was)
            tracer.reset()
        sliced["steps"] = n
        sliced["examples"] = n * B
        drawn += n
    peak = torch.cuda.max_memory_allocated(device) if cuda else 0

    P = len(pool)
    check_batches = pool[:n_check]
    steady_batches = [pool[(drawn + i) % P] for i in range(n_check)]
    rows = batch_rows(cfg, steady_batches, device)
    first_rows = batch_rows(cfg, steady_batches[:1], device)
    steady_start, table0 = steady_copy(trainer, rows)
    steady = follow_from(trainer, feed, cfg, n_check, steady_start, table0,
                         first_rows)
    del model, trainer, feed, pool, table0
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
        "program_slice": by_span,
        "counters": counters,
        "memory_peak_bytes": peak,
        "program": program,
        "check_batches": check_batches,
        "steady": steady,
        "steady_batches": steady_batches,
        "steady_start": steady_start,
        "steady_count": drawn,
    }
