"""serve.roofline: the least time of one request's retrieval work
(`roofline.retrieval_work` at the configuration's serve dtype) over the
device-busy time per request of the profiled slice, in %."""

from portbench import roofline


def read(ctx):
    s = ctx.get("slice")
    if not s or s["busy_s"] <= 0:
        return None
    cfg, tr = ctx["cell"]["config"], ctx["cell"]["traffic"]
    flops, nbytes = roofline.retrieval_work(
        tr["batch"], cfg["total_items"], cfg["dim"], tr["k"],
        cfg["serve_dtype"])
    least, _ = roofline.least_seconds(flops, nbytes, cfg["serve_dtype"])
    return 100.0 * least / (s["busy_s"] / s["requests"])
