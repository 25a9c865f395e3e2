"""train.dispatch_ms: mean host ms inside `Trainer.train_step` per step
of the window (benchmark spans)."""


def read(ctx):
    d = ctx.get("spans", {}).get("train.step")
    return sum(d) / len(d) * 1e3 if d else None
