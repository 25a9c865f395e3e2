"""train.launches: device kernels launched per step in the profiled
slice (copies and sets not counted)."""


def read(ctx):
    s = ctx.get("slice")
    if not s or s["kernels"] <= 0:
        return None
    return s["kernels"] / s["steps"]
