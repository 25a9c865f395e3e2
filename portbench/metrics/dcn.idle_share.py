"""dcn.idle_share: the share of the profiled slice in which no device
operation runs (the union of their intervals), in %: `train.idle_share`
in the multi-hot cell."""


def read(ctx):
    s = ctx.get("slice")
    if not s or s["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - s["busy_s"] / s["window_s"])
