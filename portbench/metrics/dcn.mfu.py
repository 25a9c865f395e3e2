"""dcn.mfu: the model's operations per example
(`roofline_dcn.dcn_train_flops_per_example`, 96,182,784 at the published
widths) times the examples of the profiled slice, over its seconds, as a
share of the peak of the configuration's dtype (fp32 with TF32 off:
67 TFLOP/s), in %."""

from portbench import roofline, roofline_dcn


def read(ctx):
    s = ctx.get("slice")
    if not s or s["busy_s"] <= 0:
        return None
    cfg = ctx["cell"]["config"]
    rate = roofline_dcn.dcn_train_flops_per_example(cfg) * s["examples"] \
        / s["window_s"]
    return 100.0 * rate / roofline.peak_flops(cfg["dtype"])
