"""batch_users_per_s: in an offline cell, users whose top-k ids and scores
reached the host while the window was open, over the window's seconds
(host clock): `serve_users_per_s`'s reading, under a bound of its own."""

from portbench import harness


def read(ctx):
    return harness.reader("serve_users_per_s")(ctx)
