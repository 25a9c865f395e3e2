"""Host spans and one profiled slice of a run, reduced to numbers.

`Spans` keeps host-clock durations by name in memory (the benchmark's own
spans around its calls into the program). `profiled_slice` runs a body
under `torch.profiler` with the CPU and CUDA activities, writes the
Chrome trace under the temporary directory, reads it back and deletes
it. The reduction takes device operations (kernels, copies, sets) inside
the slice's own annotation and reports:

- busy_s: the length of the union of their intervals, so that kernels
  that overlap are counted once; window_s: the slice's length;
- kernels: the number of kernel launches; htod_s: device seconds of
  host-to-device copies;
- device_ops: the operations that took most device time, summed by name;
- idle_gaps: the longest gaps in the union, each named by the innermost
  host annotation or operation running at the gap's start.
"""

from __future__ import annotations

import contextlib
import json
import os
import tempfile
import time
from collections import defaultdict

import torch

SLICE = "portbench.slice"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation")
TOP = 10
NAME_CHARS = 160


class Spans:
    """Host-clock spans by name: `with spans("serve.topk"): ...`. When
    off, a span costs one attribute test."""

    def __init__(self, on: bool):
        self.on = on
        self.durations = defaultdict(list)

    @contextlib.contextmanager
    def __call__(self, name: str):
        if not self.on:
            yield
            return
        t = time.perf_counter()
        try:
            yield
        finally:
            self.durations[name].append(time.perf_counter() - t)


def annotate(name: str, on: bool):
    """A profiler annotation where `on`, else nothing."""
    if on:
        return torch.profiler.record_function(name)
    return contextlib.nullcontext()


def _union(intervals):
    merged = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return merged


def reduce_trace(events: list) -> dict:
    """The numbers above from a Chrome trace's `traceEvents` (times in
    microseconds). Raises where the slice's annotation is missing."""
    marks = [e for e in events if e.get("name") == SLICE
             and e.get("cat") == "user_annotation"]
    if not marks:
        raise RuntimeError(f"the trace holds no {SLICE} annotation")
    lo = float(marks[0]["ts"])
    hi = lo + float(marks[0]["dur"])
    dev, host = [], []
    for e in events:
        if e.get("ph") != "X" or "dur" not in e:
            continue
        s = float(e["ts"])
        t = s + float(e["dur"])
        if e.get("cat") in DEVICE_CATS:
            s, t = max(s, lo), min(t, hi)
            if t > s:
                dev.append((s, t, e["cat"], e["name"]))
        elif e.get("cat") in HOST_CATS and e.get("name") != SLICE \
                and t > lo and s < hi:
            host.append((s, t, e["name"]))
    merged = _union([(s, t) for s, t, _, _ in dev])
    busy = sum(t - s for s, t in merged)
    by_name = defaultdict(float)
    for s, t, _, name in dev:
        by_name[name[:NAME_CHARS]] += t - s
    edges = [lo] + [x for iv in merged for x in iv] + [hi]
    gaps = sorted(((edges[i + 1] - edges[i], edges[i])
                   for i in range(0, len(edges), 2)
                   if edges[i + 1] > edges[i]), reverse=True)[:TOP]

    def host_at(t):
        inner = [h for h in host if h[0] <= t < h[1]]
        if not inner:
            return "host: outside any operation"
        return "host: " + max(inner, key=lambda h: h[0])[2][:NAME_CHARS]

    return {
        "window_s": (hi - lo) * 1e-6,
        "busy_s": busy * 1e-6,
        "kernels": sum(1 for _, _, c, _ in dev if c == "kernel"),
        "htod_s": sum(t - s for s, t, c, n in dev
                      if c == "gpu_memcpy" and "HtoD" in n) * 1e-6,
        "device_ops": [[n, v * 1e-6] for n, v in
                       sorted(by_name.items(), key=lambda kv: -kv[1])[:TOP]],
        "idle_gaps": [[host_at(t), g * 1e-6] for g, t in gaps],
    }


def profiled_slice(body, device: torch.device) -> dict:
    """Run `body()` under the profiler (CUDA activity on a card), inside
    one annotation that ends after a device synchronize, and return
    `reduce_trace` of it."""
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
        torch.cuda.synchronize(device)
    fd, path = tempfile.mkstemp(suffix=".json", prefix="portbench-trace-")
    os.close(fd)
    try:
        with profile(activities=acts) as prof:
            with torch.profiler.record_function(SLICE):
                body()
                if device.type == "cuda":
                    torch.cuda.synchronize(device)
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    finally:
        os.remove(path)
    return reduce_trace(events)
