"""feed.h2d_ms: device ms of host-to-device copies per step in the
profiled slice (the feed's batches)."""


def read(ctx):
    s = ctx.get("slice")
    if not s or s["htod_s"] <= 0:
        return None
    return s["htod_s"] / s["steps"] * 1e3
