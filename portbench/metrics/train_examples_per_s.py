"""train_examples_per_s: examples of every step dispatched in the window,
over the host time from its first dispatch to the synchronize that ends
it."""


def read(ctx):
    if "examples_done" not in ctx:
        return None
    return ctx["examples_done"] / ctx["window_s"]
