"""serve_p95_ms: the 95th percentile, over every request dispatched in the
window, of the host time from the start of its dispatch to its results on
the host."""

import numpy as np


def read(ctx):
    lat = ctx.get("latencies_s")
    if not lat:
        return None
    return float(np.percentile(np.asarray(lat), 95)) * 1e3
