"""The trace events of a profiled slice, for drivers that reduce them
further than `devtrace.profiled_slice` does (the program's spans, NCCL
kernels)."""

from __future__ import annotations

import json
import os
import tempfile

import torch

from portbench import devtrace


def profiled_events(body, device: torch.device) -> list:
    """Run `body()` under the profiler, as `devtrace.profiled_slice` runs
    it (CUDA activity on a card, one annotation that ends after a device
    synchronize), and return the trace's `traceEvents`."""
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
        torch.cuda.synchronize(device)
    fd, path = tempfile.mkstemp(suffix=".json", prefix="portbench-trace-")
    os.close(fd)
    try:
        with profile(activities=acts) as prof:
            with torch.profiler.record_function(devtrace.SLICE):
                body()
                if device.type == "cuda":
                    torch.cuda.synchronize(device)
        prof.export_chrome_trace(path)
        with open(path) as f:
            return json.load(f)["traceEvents"]
    finally:
        os.remove(path)
