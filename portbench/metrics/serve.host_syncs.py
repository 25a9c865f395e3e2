"""serve.host_syncs: the program's count of host waits for the device
(`openrec.host_syncs`, `openrec_tpu_torch/trace.py`) over every request
the run made (warm-up, window and profiled slice), so per request. The
counter counts whether the tracer is on or off; a program without it
gives None."""


def read(ctx):
    try:
        from openrec_tpu_torch import trace
    except ImportError:
        return None
    tr, s = ctx["cell"]["traffic"], ctx.get("slice")
    requests = int(tr["warmup_requests"]) + int(ctx["attempted"]) \
        + (int(s["requests"]) if s else 0)
    return trace.counter(trace.HOST_SYNCS) / requests
