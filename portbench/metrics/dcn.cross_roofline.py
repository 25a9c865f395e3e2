"""dcn.cross_roofline: the cross layers' least forward time by operations
(`roofline_dcn.cross_least_seconds`: 2 x batch x layers x 2 x d x r at
the fp32 peak, 67 TFLOP/s with TF32 off) over `dcn.cross_ms`, in %."""

from portbench import roofline_dcn


def read(ctx):
    by_span = ctx.get("program_slice") or {}
    s = by_span.get("span_device_s", {}).get("openrec.dlrm.cross")
    if not s:
        return None
    steps = ctx["slice"]["steps"]
    batch = int(ctx["cell"]["traffic"]["batch"])
    least = roofline_dcn.cross_least_seconds(ctx["cell"]["config"], batch)
    return 100.0 * least / (s / steps)
