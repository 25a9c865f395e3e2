"""batch.roofline: `serve.roofline`'s reading in an offline cell, which moves
`batch_users_per_s`."""

from portbench import harness


def read(ctx):
    return harness.reader("serve.roofline")(ctx)
