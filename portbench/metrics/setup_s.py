"""setup_s: host seconds from the process's start to the first timed
request or step (imports, CUDA start, kernel builds, weights and inputs
made from the seed, the check steps of a training cell, the warm-up)."""


def read(ctx):
    return ctx.get("setup_s")
