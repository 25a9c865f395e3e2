"""serve.mfu: the scores' operations (2*B*I*D a request) of the requests
completed in the profiled slice, over its seconds, as a share of the
peak of the configuration's serve dtype, in %."""

from portbench import roofline


def read(ctx):
    s = ctx.get("slice")
    if not s or s["busy_s"] <= 0:
        return None
    cfg, tr = ctx["cell"]["config"], ctx["cell"]["traffic"]
    flops, _ = roofline.retrieval_work(
        tr["batch"], cfg["total_items"], cfg["dim"], tr["k"],
        cfg["serve_dtype"])
    rate = flops * s["requests"] / s["window_s"]
    return 100.0 * rate / roofline.peak_flops(cfg["serve_dtype"])
