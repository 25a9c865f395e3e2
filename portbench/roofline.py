"""Operations, bytes and least times: the benchmark's yardstick.

The peaks are the card's published ones (`peaks.json`). A least time is
the larger of the operations over the peak rate of the configuration's
stated precision and the bytes over the memory's peak rate; the bytes
count every input read once and every output written once, whatever an
implementation reads again. These functions count the work a request or
a step needs from its shapes, so the same work is counted whatever code
does it.
"""

from __future__ import annotations

import json
from pathlib import Path

PEAKS_FILE = Path(__file__).resolve().parent / "peaks.json"

_DTYPE_BYTES = {"bfloat16": 2, "float16": 2, "float32": 4}
_DTYPE_PEAK = {"bfloat16": "bf16_flops", "float16": "bf16_flops",
               "float32": "fp32_flops"}


def peaks() -> dict:
    return json.loads(PEAKS_FILE.read_text())


def peak_flops(dtype: str) -> float:
    """The card's dense peak for arithmetic in `dtype` (float32 with TF32
    off: the CUDA cores' rate)."""
    return peaks()[_DTYPE_PEAK[dtype]]


def least_seconds(flops: float, nbytes: float, dtype: str):
    """(seconds, 'operations' or 'bytes'): the least time and what bounds
    it."""
    t_ops = flops / peak_flops(dtype)
    t_bytes = nbytes / peaks()["hbm_bytes_per_s"]
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def retrieval_work(B: int, I: int, D: int, k: int, dtype: str = "bfloat16"):
    """(flops, bytes) of a top-k request over a dot-product catalog: the
    scores u.V^T + b of B users against I items (2*B*I*D operations), the
    users' B rows and the table V in `dtype`, the fp32 bias b read once,
    and B*k (id, score) pairs written once (4 bytes each: an int32 id
    covers any catalog under 2**31 items)."""
    e = _DTYPE_BYTES[dtype]
    flops = 2.0 * B * I * D
    nbytes = B * D * e + I * D * e + I * 4 + B * k * (4 + 4)
    return flops, float(nbytes)


def bucket_pass_work(B: int, I: int, D: int, L: int,
                     dtype: str = "bfloat16"):
    """(flops, bytes) of the bucket-max pass alone (kernel K1): as
    `retrieval_work`, but its output is B*L (max score, int32 id) pairs,
    one per bucket."""
    e = _DTYPE_BYTES[dtype]
    flops = 2.0 * B * I * D
    nbytes = B * D * e + I * D * e + I * 4 + B * L * (4 + 4)
    return flops, float(nbytes)


def dlrm_forward_macs(cfg: dict) -> int:
    """Multiply-adds of one example's forward pass through DLRM: the
    bottom MLP, the dot interaction as the Gram matrix of its F feature
    vectors (F = tables + 1, an F x F x m_spa batched product) and the top
    MLP. Embedding gathers, activations and the loss are not counted."""
    T = len(cfg["ln_emb"])
    m = cfg["m_spa"]
    dims_bot = [cfg["dim_dense"], *cfg["ln_bot"]]
    F = T + 1
    top_in = cfg["ln_bot"][-1] + F * (F - 1) // 2
    dims_top = [top_in, *cfg["ln_top"]]
    macs = sum(a * b for a, b in zip(dims_bot[:-1], dims_bot[1:]))
    macs += F * F * m
    macs += sum(a * b for a, b in zip(dims_top[:-1], dims_top[1:]))
    return macs


def dlrm_train_flops_per_example(cfg: dict) -> float:
    """Model operations of one training example: forward plus backward
    (twice the forward: the gradients of inputs and of weights), two
    operations a multiply-add."""
    return 2.0 * 3.0 * dlrm_forward_macs(cfg)
