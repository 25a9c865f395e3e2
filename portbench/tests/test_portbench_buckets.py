"""The bucket and candidate count K1 runs at in the serving cells, as the
port chooses them: the recall rule's bucket, then the table-block shrink
rule (a bucket's 128 * bucket rows of bf16 at most 6 MiB), which halves
batch-k10's 512 to 256."""

import pytest

from openrec_tpu_torch.ops.bucketed_topk import bucket_geometry, choose_bucket
from portbench.harness import load_cell


@pytest.mark.parametrize("cell,chosen,bucket,L", [
    ("bpr-amazon.serve-k1", 64, 64, 7040),
    ("bpr-amazon.batch-k10", 512, 256, 1792),
])
def test_bucket_and_candidates(cell, chosen, bucket, L):
    c = load_cell(cell)
    cfg, tr = c["config"], c["traffic"]
    I, D = cfg["total_items"], cfg["dim"]
    got = choose_bucket(I, tr["k"], recall_target=tr["recall_target"])
    assert got == chosen
    b, _, n = bucket_geometry(I, D, 2, got)
    assert (b, n) == (bucket, L)
