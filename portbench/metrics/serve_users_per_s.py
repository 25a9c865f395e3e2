"""serve_users_per_s: users whose top-k ids and scores reached the host
while the window was open, over the window's seconds (host clock)."""


def read(ctx):
    if "users_done" not in ctx:
        return None
    return ctx["users_done"] / ctx["window_s"]
