"""dcn.backward_ms: device ms a step of the operations launched under the
program's span `openrec.train.backward` (autograd's backward pass of the
whole model, the bags' sort-based gradient included) in the profiled
slice, tracer on."""


def read(ctx):
    by_span = ctx.get("program_slice") or {}
    s = by_span.get("span_device_s", {}).get("openrec.train.backward")
    if not s:
        return None
    return s / ctx["slice"]["steps"] * 1e3
