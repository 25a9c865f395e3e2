"""dcn.pool_roofline: the bags' least time by bytes
(`roofline_dcn.pool_least_seconds`: the ids a step, as the program's
counter `openrec.dlrm.bag_ids` counts them over the slice, read as int32;
the fp32 rows of the step's distinct ids, as the sparse step's counter
`openrec.train.unique_rows` counts them, read once, or of every id where
that counter is absent; batch x tables pooled vectors written once; at
3.35 TB/s) over `dcn.pool_ms`, in %."""

from portbench import roofline_dcn


def read(ctx):
    by_span = ctx.get("program_slice") or {}
    s = by_span.get("span_device_s", {}).get("openrec.dlrm.pool")
    counters = ctx.get("counters") or {}
    ids = counters.get("openrec.dlrm.bag_ids")
    if not s or not ids:
        return None
    rows = counters.get("openrec.train.unique_rows") or ids
    steps = ctx["slice"]["steps"]
    batch = int(ctx["cell"]["traffic"]["batch"])
    least = roofline_dcn.pool_least_seconds(ctx["cell"]["config"], batch,
                                            ids / steps, rows / steps)
    return 100.0 * least / (s / steps)
