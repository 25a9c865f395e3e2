"""The program's spans in a profiled slice (`progtrace.reduce_program`)
on a hand-made Chrome trace, and the program counter a serving cell reads
(`serve.host_syncs`)."""

import time

import pytest
import torch

from portbench import devtrace, harness, progtrace


def _x(name, cat, ts, dur, tid=1, corr=None):
    e = {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur,
         "tid": tid}
    if corr is not None:
        e["args"] = {"correlation": corr}
    return e


def _trace(spans=True):
    """A 100 us slice: a request's spans on thread 1, kernels launched by
    correlation, one span on another thread, one after the slice, and a
    launch from a thread with no span (as autograd's device thread)."""
    ev = [_x(devtrace.SLICE, "user_annotation", 0, 100),
          _x("portbench.topk", "user_annotation", 8, 60),
          _x("cudaLaunchKernel", "cuda_runtime", 13, 1, corr=1),
          _x("cudaLaunchKernel", "cuda_runtime", 26, 1, corr=2),
          _x("cudaMemcpyAsync", "cuda_runtime", 37, 1, corr=3),
          _x("cudaLaunchKernel", "cuda_runtime", 70, 1, corr=4),
          _x("cudaLaunchKernel", "cuda_runtime", 90, 1, tid=2, corr=6),
          _x("cudaLaunchKernel", "cuda_runtime", 27, 1, tid=3, corr=7),
          _x("k1", "kernel", 15, 15, corr=1),
          _x("sort", "kernel", 30, 8, corr=2),
          _x("Memcpy DtoH", "gpu_memcpy", 38, 1, corr=3),
          _x("after", "kernel", 72, 8, corr=4),
          _x("unlaunched", "kernel", 95, 2, corr=5),
          _x("other thread", "kernel", 97, 1, corr=6),
          _x("backward", "kernel", 16, 2, corr=7)]
    if spans:
        ev += [_x("openrec.serve.topk", "user_annotation", 10, 50),
               _x("openrec.serve.score", "user_annotation", 12, 8),
               _x("openrec.serve.select", "user_annotation", 25, 30),
               _x("openrec.host_sync", "user_annotation", 36, 14),
               _x("openrec.feed.next", "user_annotation", 85, 10, tid=2),
               _x("openrec.serve.topk", "user_annotation", 150, 10)]
    return ev


def test_ops_go_to_the_innermost_span_by_correlation():
    out = progtrace.reduce_program(_trace())
    dev = {k: round(v * 1e6, 6) for k, v in out["span_device_s"].items()}
    assert dev == {"openrec.serve.topk": 24.0,      # 15..39, union
                   "openrec.serve.score": 15.0,
                   "openrec.serve.select": 11.0,   # 16..18, 30..39
                   "openrec.host_sync": 1.0,
                   "openrec.feed.next": 1.0}       # its own thread
    assert out["span_calls"] == {"openrec.serve.topk": 1,
                                 "openrec.serve.score": 1,
                                 "openrec.serve.select": 1,
                                 "openrec.host_sync": 1,
                                 "openrec.feed.next": 1}


def test_idle_by_the_span_the_host_was_in_at_each_gap():
    out = progtrace.reduce_program(_trace())
    idle = {k: round(v * 1e6, 6) for k, v in out["idle_by_span"].items()}
    # gaps 0..15, 39..72, 80..95 and 98..100: the one at 39 starts
    # inside the host sync; thread 2's span is not the slice's host
    assert idle == {progtrace.OUTSIDE: 15 + 15 + 2,
                    "openrec.host_sync": 33}
    base = devtrace.reduce_trace(_trace())
    assert sum(out["idle_by_span"].values()) == pytest.approx(
        base["window_s"] - base["busy_s"])


def test_no_program_spans_leave_every_gap_outside():
    out = progtrace.reduce_program(_trace(spans=False))
    assert out["span_device_s"] == {} and out["span_calls"] == {}
    assert list(out["idle_by_span"]) == [progtrace.OUTSIDE]


def test_reduce_trace_keys_stay_apart_and_unchanged():
    ev = _trace()
    before = devtrace.reduce_trace(ev)
    out = progtrace.reduce_program(ev)
    assert set(before).isdisjoint(out)
    assert devtrace.reduce_trace(ev) == before


def test_a_trace_without_the_slice_raises():
    with pytest.raises(RuntimeError):
        progtrace.reduce_program(_trace()[1:])


def test_host_syncs_read_zero_on_short_rows(tiny):
    """The CPU's serve-exact catalog (20,000 items) is under `SHORT_ROW`:
    each row is sorted whole and nothing waits; the long-row wait is
    held by the port's own tests."""
    from openrec_tpu_torch import trace
    trace.reset()
    out = harness.run_cell(tiny("bpr-amazon.serve-exact"), 2 ** 31 + 5,
                           0.3, True, torch.device("cpu"),
                           time.perf_counter())
    assert out["correct"] is True
    assert out["metrics"]["serve.host_syncs"]["value"] == 0.0
