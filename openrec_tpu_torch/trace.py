"""Spans and counters of the program's own layers.

One switch (`enable`) turns spans on. While on, `span(name)` adds its
calls and host nanoseconds (`time.perf_counter_ns`) to a per-name total
in memory: totals, not a list, so a long window costs no memory growth.
While a `torch.profiler` session records as well, each span is also a
`torch.profiler.record_function` annotation of the same name, so the
program's spans sit in the profiler's Chrome trace on the kernels' clock,
and each device operation or idle gap can be named by the span the host
was in.

Counters:

- `count(name, n)`: a host counter, counted whether spans are on or off
  (kernel launches, host waits);
- `count_device(name, tensor)`: adds the tensor's sum on the device, and
  only while on; the host reads it once, at `snapshot()`;
- `host_sync()`: a span around a place where the program waits for the
  device, counted in `openrec.host_syncs` whether on or off.

`snapshot()` returns the totals and counters, `reset()` clears them. When
off, a span costs one read of the switch and returns a shared object
whose `with` does nothing. Every name starts with `openrec.`.
"""

from __future__ import annotations

import time

import torch

HOST_SYNCS = "openrec.host_syncs"

_on = False
_spans: dict = {}          # name -> [calls, host ns]
_counts: dict = {}         # name -> host count
_device: dict = {}         # name -> device tensor (a running sum)


class _Off:
    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, kind, value, tb):
        return None


_OFF = _Off()


class _Span:
    __slots__ = ("name", "t0", "mark")

    def __init__(self, name: str):
        self.name = name
        self.mark = None

    def __enter__(self):
        if torch.autograd._profiler_enabled():
            self.mark = torch.profiler.record_function(self.name)
            self.mark.__enter__()
        self.t0 = time.perf_counter_ns()
        return None

    def __exit__(self, *exc):
        ns = time.perf_counter_ns() - self.t0
        total = _spans.get(self.name)
        if total is None:
            _spans[self.name] = [1, ns]
        else:
            total[0] += 1
            total[1] += ns
        if self.mark is not None:
            self.mark.__exit__(*exc)
        return False


def enable(on: bool = True) -> bool:
    """Turn spans and device counters on or off; returns the previous
    state."""
    global _on
    was, _on = _on, bool(on)
    return was


def enabled() -> bool:
    return _on


def span(name: str):
    """A context that adds its host time to `name`'s total while spans are
    on (and is a profiler annotation while a profiler records)."""
    if not _on:
        return _OFF
    return _Span(name)


def count(name: str, n: int = 1) -> None:
    """Add `n` to the host counter `name`, whether spans are on or off."""
    _counts[name] = _counts.get(name, 0) + n


def counter(name: str) -> int:
    """The host counter `name` (0 if never counted); reads no device
    counter."""
    return _counts.get(name, 0)


def host_sync():
    """Count one wait of the host for the device (`openrec.host_syncs`)
    and return a span, `openrec.host_sync`, to hold the read that
    waits."""
    _counts[HOST_SYNCS] = _counts.get(HOST_SYNCS, 0) + 1
    return span("openrec.host_sync")


def count_device(name: str, value: torch.Tensor) -> None:
    """While on, add `value.sum()` to the device counter `name`, on the
    device: no host read until `snapshot()`."""
    if not _on:
        return
    total = _device.get(name)
    if total is None:
        _device[name] = value.detach().sum()
    else:
        total.add_(value.detach().sum())


def snapshot() -> dict:
    """{"spans": {name: {"calls", "host_s"}}, "counters": {name: value}}:
    the totals since the last `reset()`. Reads each device counter once
    (waiting for the device)."""
    counters = dict(_counts)
    for name, total in _device.items():
        counters[name] = counters.get(name, 0) + total.item()
    return {"spans": {name: {"calls": c, "host_s": ns * 1e-9}
                      for name, (c, ns) in _spans.items()},
            "counters": counters}


def reset() -> None:
    """Clear every span total and counter."""
    _spans.clear()
    _counts.clear()
    _device.clear()
