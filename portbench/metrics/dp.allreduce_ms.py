"""dp.allreduce_ms: rank 0's device ms a step in NCCL kernels (the
gradients' all_reduce over the data ranks, the union of their intervals)
in the profiled slice."""


def read(ctx):
    s = ctx.get("slice")
    if not s or not s.get("nccl_s"):
        return None
    return s["nccl_s"] / s["steps"] * 1e3
