"""The program's own spans in a profiled slice, reduced to numbers.

The port marks its layers as `openrec.*` annotations in the profiler's
Chrome trace while its tracer is on (`openrec_tpu_torch/trace.py`). Each
device operation (kernel, copy, set) carries the `correlation` id of the
runtime call that launched it; the operation belongs to the innermost
`openrec.*` span of the launching thread whose interval holds that call.
A call from a thread that is inside no program span then (the autograd
engine's device thread, which launches the backward pass while the host
thread waits in `torch.autograd.grad`) belongs to the span the slice's
host thread was in at that moment.
From the same `traceEvents` as `devtrace.reduce_trace`, inside the same
slice annotation, `reduce_program` returns:

- span_device_s: {span: device seconds of the operations it launched,
  itself or through the spans inside it, as the union of their
  intervals};
- span_calls: {span: how many of it start inside the slice};
- idle_by_span: {span: idle seconds of the slice whose gap began while
  the slice's host thread was inside that span (the innermost)}, over
  every gap, with `OUTSIDE` for the gaps that began outside the program.

A trace without program spans (a program without the tracer) gives empty
span maps and all its idle `OUTSIDE`. Nothing here imports the program.
"""

from __future__ import annotations

import bisect
from collections import defaultdict

from portbench.devtrace import DEVICE_CATS, SLICE, _union

PREFIX = "openrec."
OUTSIDE = "outside the program"
RUNTIME_CATS = ("cuda_runtime", "cuda_driver")


def _timeline(spans) -> tuple:
    """(times, chains) of one thread's spans [(start, end, name)]: from
    times[i] until times[i + 1] the host is inside chains[i], its open
    spans outermost first (() outside every span)."""
    times, chains, stack = [], [], []

    def mark(t):
        times.append(t)
        chains.append(tuple(name for _, _, name in stack))

    for s, t, name in sorted(spans, key=lambda x: (x[0], -x[1])):
        while stack and stack[-1][1] <= s:
            mark(stack.pop()[1])
        stack.append((s, t, name))
        mark(s)
    while stack:
        mark(stack.pop()[1])
    return times, chains


def _chain_at(timeline, t) -> tuple:
    times, chains = timeline
    i = bisect.bisect_right(times, t) - 1
    return chains[i] if i >= 0 else ()


def reduce_program(events: list) -> dict:
    """The numbers above from a Chrome trace's `traceEvents` (times in
    microseconds). Raises where the slice's annotation is missing."""
    marks = [e for e in events if e.get("name") == SLICE
             and e.get("cat") == "user_annotation"]
    if not marks:
        raise RuntimeError(f"the trace holds no {SLICE} annotation")
    lo = float(marks[0]["ts"])
    hi = lo + float(marks[0]["dur"])
    host_tid = marks[0].get("tid")
    spans = defaultdict(list)        # tid -> [(start, end, name)]
    launches = {}                    # correlation -> (time, tid)
    ops = []                         # (start, end, correlation)
    for e in events:
        if e.get("ph") != "X" or "dur" not in e:
            continue
        s = float(e["ts"])
        t = s + float(e["dur"])
        cat = e.get("cat")
        corr = (e.get("args") or {}).get("correlation")
        if cat == "user_annotation" and e["name"].startswith(PREFIX):
            spans[e.get("tid")].append((s, t, e["name"]))
        elif cat in RUNTIME_CATS and corr is not None:
            launches[corr] = (s, e.get("tid"))
        elif cat in DEVICE_CATS:
            s, t = max(s, lo), min(t, hi)
            if t > s:
                ops.append((s, t, corr))
    timelines = {tid: _timeline(v) for tid, v in spans.items()}
    host = timelines.get(host_tid, ([], []))
    by_span = defaultdict(list)
    for s, t, corr in ops:
        if corr not in launches:
            continue
        at, tid = launches[corr]
        chain = _chain_at(timelines[tid], at) if tid in timelines else ()
        if not chain:
            chain = _chain_at(host, at)
        for name in set(chain):
            by_span[name].append((s, t))
    calls = defaultdict(int)
    for v in spans.values():
        for s, _, name in v:
            if lo <= s < hi:
                calls[name] += 1
    merged = _union([(s, t) for s, t, _ in ops])
    edges = [lo] + [x for iv in merged for x in iv] + [hi]
    idle = defaultdict(float)
    for i in range(0, len(edges), 2):
        gap = edges[i + 1] - edges[i]
        if gap > 0:
            chain = _chain_at(host, edges[i])
            idle[chain[-1] if chain else OUTSIDE] += gap * 1e-6
    return {
        "span_device_s": {n: sum(t - s for s, t in _union(v)) * 1e-6
                          for n, v in by_span.items()},
        "span_calls": dict(calls),
        "idle_by_span": dict(idle),
    }
