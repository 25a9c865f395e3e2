"""dcn.cross_ms: device ms a step of the operations launched under the
program's span `openrec.dlrm.cross` (the cross layers, forward) in the
profiled slice, tracer on."""


def read(ctx):
    by_span = ctx.get("program_slice") or {}
    s = by_span.get("span_device_s", {}).get("openrec.dlrm.cross")
    if not s:
        return None
    return s / ctx["slice"]["steps"] * 1e3
