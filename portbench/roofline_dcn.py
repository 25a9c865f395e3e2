"""Operations and bytes of DLRM-DCNv2 (the multi-hot bags and the low-rank
cross network), counted from the configuration's shapes as `roofline.py`
counts them: the work the step needs, whatever code does it.
`roofline.dlrm_forward_macs` assumes the dot interaction; these do not.
"""

from __future__ import annotations

from portbench import roofline


def cross_forward_macs(cfg: dict) -> int:
    """Multiply-adds of one example through the cross layers: x @ v
    [d, r] and then @ w [r, d] a layer, d = (tables + 1) * m_spa. The
    elementwise x0 * (.) + x is not counted."""
    d = (len(cfg["ln_emb"]) + 1) * cfg["m_spa"]
    return cfg["dcn_layers"] * 2 * d * cfg["dcn_rank"]


def dcn_forward_macs(cfg: dict) -> int:
    """Multiply-adds of one example's forward pass: the dense arch, the
    cross layers and the over arch (16,030,464 at the published widths).
    Lookups, pooling, activations and the loss are not counted."""
    d = (len(cfg["ln_emb"]) + 1) * cfg["m_spa"]
    dims_bot = [cfg["dim_dense"], *cfg["ln_bot"]]
    dims_top = [d, *cfg["ln_top"]]
    macs = sum(a * b for a, b in zip(dims_bot[:-1], dims_bot[1:]))
    macs += cross_forward_macs(cfg)
    macs += sum(a * b for a, b in zip(dims_top[:-1], dims_top[1:]))
    return macs


def dcn_train_flops_per_example(cfg: dict) -> float:
    """Model operations of one training example: forward plus backward
    (twice the forward), two operations a multiply-add (96,182,784 at
    the published widths)."""
    return 2.0 * 3.0 * dcn_forward_macs(cfg)


def cross_forward_flops(cfg: dict, batch: int) -> float:
    """Operations of a batch's forward pass through the cross layers."""
    return 2.0 * batch * cross_forward_macs(cfg)


def pool_bytes(cfg: dict, batch: int, ids: float, rows: float) -> float:
    """Bytes of a batch's bag lookups and sum pooling: `ids` int32 ids
    read, the fp32 rows of m_spa of the `rows` distinct ids read once
    (a repeated id's row is read once, as the gathered view holds it
    once), and batch * tables pooled fp32 vectors written once."""
    m = cfg["m_spa"]
    return float(ids * 4 + rows * m * 4 + batch * len(cfg["ln_emb"]) * m * 4)


def pool_least_seconds(cfg: dict, batch: int, ids: float,
                       rows: float) -> float:
    """The bags' least time: their bytes at the memory's peak rate."""
    return pool_bytes(cfg, batch, ids, rows) \
        / roofline.peaks()["hbm_bytes_per_s"]


def cross_least_seconds(cfg: dict, batch: int) -> float:
    """The cross layers' forward least time: their operations at the
    peak of the configuration's dtype (fp32 with TF32 off: 67 TFLOP/s)."""
    return cross_forward_flops(cfg, batch) / roofline.peak_flops(cfg["dtype"])
