"""serve.dispatch_ms: mean host ms inside `CachedDotProductScorer.topk`
per request of the window (benchmark spans). The call returns before the
device finishes unless the route waits on the host itself."""


def read(ctx):
    d = ctx.get("spans", {}).get("serve.topk")
    return sum(d) / len(d) * 1e3 if d else None
