"""The operations, bytes and least times of the four cells' shapes."""

import pytest

from portbench import roofline
from portbench.harness import load_cell

AMAZON = dict(B=256, I=450166, D=64)


def test_peaks_are_the_data_sheets():
    p = roofline.peaks()
    assert p["bf16_flops"] == 989e12
    assert p["fp32_flops"] == 67e12
    assert p["hbm_bytes_per_s"] == 3.35e12


def test_k1_bound_at_amazon_matches_the_kernel_table():
    # the bucket pass alone at bucket 64 (L 7,040): 0.0221 ms of bytes
    flops, nbytes = roofline.bucket_pass_work(L=7040, **AMAZON)
    t, by = roofline.least_seconds(flops, nbytes, "bfloat16")
    assert by == "bytes"
    assert round(t * 1e3, 4) == 0.0221


@pytest.mark.parametrize("cell", ["bpr-amazon.serve-k1",
                                  "bpr-amazon.serve-exact"])
def test_retrieval_bound_of_a_256_user_request(cell):
    c = load_cell(cell)
    tr, cfg = c["traffic"], c["config"]
    flops, nbytes = roofline.retrieval_work(
        tr["batch"], cfg["total_items"], cfg["dim"], tr["k"],
        cfg["serve_dtype"])
    assert flops == 2.0 * 256 * 450166 * 64
    t, by = roofline.least_seconds(flops, nbytes, "bfloat16")
    assert by == "bytes"
    assert t * 1e6 == pytest.approx(17.81, abs=0.01)


def test_batch_k10_is_bound_by_operations():
    c = load_cell("bpr-amazon.batch-k10")
    tr, cfg = c["traffic"], c["config"]
    flops, nbytes = roofline.retrieval_work(
        tr["batch"], cfg["total_items"], cfg["dim"], tr["k"],
        cfg["serve_dtype"])
    assert flops / 1e9 == pytest.approx(59.0, abs=0.05)
    t, by = roofline.least_seconds(flops, nbytes, "bfloat16")
    assert by == "operations"
    assert t * 1e6 == pytest.approx(59.6, abs=0.1)
    assert nbytes / 3.35e12 * 1e6 == pytest.approx(17.8, abs=0.1)


def test_dlrm_flops_per_example():
    cfg = load_cell("dlrm-kaggle.train-zipf")["config"]
    # bottom 155,136 + Gram 27*27*16 + top 319,232 multiply-adds
    assert roofline.dlrm_forward_macs(cfg) == 155136 + 11664 + 319232
    assert roofline.dlrm_train_flops_per_example(cfg) == \
        pytest.approx(2.916e6, rel=1e-3)
