"""The generator: the same seed gives the same requests and batches."""

import numpy as np
import pytest
import torch

from portbench import traffic, weights
from portbench.harness import load_cell

SEEDS = [0, 2 ** 31 + 12345, 2 ** 40 + 7, -3]


@pytest.mark.parametrize("seed", SEEDS)
def test_uniform_requests_repeat_with_the_seed(seed):
    c = load_cell("bpr-amazon.serve-k1")
    a = traffic.RequestStream(c["traffic"], c["config"], seed, pin=False)
    b = traffic.RequestStream(c["traffic"], c["config"], seed, pin=False)
    other = traffic.RequestStream(c["traffic"], c["config"], seed + 1,
                                  pin=False)
    assert torch.equal(a.pool, b.pool)
    assert not torch.equal(a.pool, other.pool)
    assert a.pool.shape == (c["traffic"]["pool_requests"], 256)
    assert int(a.pool.min()) >= 0
    assert int(a.pool.max()) < c["config"]["total_users"]


def test_batch_k10_covers_every_user():
    c = load_cell("bpr-amazon.batch-k10")
    U, B = c["config"]["total_users"], c["traffic"]["batch"]
    s = traffic.RequestStream(c["traffic"], c["config"], 2 ** 31 + 9,
                              pin=False)
    seen = np.zeros(U, dtype=bool)
    for j in range(-(-U // B)):
        ids = s.ids(j).numpy()
        assert len(ids) == B
        assert np.all(np.diff(ids) % U == 1)
        seen[ids] = True
    assert seen.all()


def test_sweep_start_repeats_with_the_seed():
    c = load_cell("bpr-amazon.batch-k10")
    a = traffic.RequestStream(c["traffic"], c["config"], 5, pin=False)
    b = traffic.RequestStream(c["traffic"], c["config"], 5, pin=False)
    assert torch.equal(a.ids(3).clone(), b.ids(3).clone())


def test_zipf_ids_stay_in_the_table_and_skew():
    gen = weights.generator(1, weights.TRAFFIC, "cpu")
    ids = traffic.zipf_ids(5000, 200000, 1.05, gen, "cpu")
    assert int(ids.min()) >= 0 and int(ids.max()) < 5000
    counts = torch.bincount(ids, minlength=5000).sort(descending=True)
    top = counts.values.double()
    # rank 1 against rank 10 under exponent 1.05: 10**1.05 = 11.2
    assert 8 < float(top[0] / top[9]) < 15
    assert int((counts.values > 0).sum()) > 2000


def expected_unique(count: int, n: int, exponent: float) -> float:
    """The expected number of distinct ids among n draws of the law."""
    p = torch.arange(1, count + 1, dtype=torch.float64).pow_(-exponent)
    p /= p.sum()
    return float((1.0 - torch.exp(n * torch.log1p(-p))).sum())


def test_a_batch_holds_the_unique_rows_its_law_implies():
    """Each table's distinct ids in one batch of the cell, as generated,
    against the expectation of the Zipf law the traffic file states (no
    measurement of Criteo-Kaggle's frequencies is there to hold it to)."""
    c = load_cell("dlrm-kaggle.train-zipf")
    B, s = c["traffic"]["batch"], c["traffic"]["zipf_exponent"]
    gen = weights.generator(2 ** 31 + 3, weights.TRAFFIC, "cpu")
    total = 0.0
    for count in c["config"]["ln_emb"]:
        want = expected_unique(count, B, s)
        got = len(torch.unique(traffic.zipf_ids(count, B, s, gen, "cpu")))
        assert abs(got - want) <= 5 * want ** 0.5 + 2, (count, got, want)
        total += want
    # about 13 % of the batch's 1,703,936 lookups hit distinct rows
    assert 0.10 < total / (B * len(c["config"]["ln_emb"])) < 0.16


def test_exponent_zero_draws_uniform_ids():
    gen = weights.generator(4, weights.TRAFFIC, "cpu")
    ids = traffic.zipf_ids(1000, 200000, 0.0, gen, "cpu")
    counts = torch.bincount(ids, minlength=1000).double()
    assert float(counts.min()) > 120 and float(counts.max()) < 290


@pytest.mark.parametrize("seed", SEEDS)
def test_train_pool_repeats_with_the_seed(tiny, seed):
    c = tiny("dlrm-kaggle.train-zipf")
    cfg, tr = c["config"], c["traffic"]
    a = traffic.train_pool(tr, cfg, seed, "cpu", pin=False)
    b = traffic.train_pool(tr, cfg, seed, "cpu", pin=False)
    assert len(a) == tr["pool_batches"]
    for x, y in zip(a, b):
        for key in x:
            assert torch.equal(x[key], y[key])
    B, T = tr["batch"], len(cfg["ln_emb"])
    first = a[0]
    assert first["sparse_features"].shape == (B, T)
    assert first["sparse_features"].dtype == torch.int32
    assert first["dense_features"].shape == (B, cfg["dim_dense"])
    assert first["label"].shape == (B,)
    sparse = torch.cat([p["sparse_features"] for p in a])
    counts = torch.tensor(cfg["ln_emb"])
    assert bool((sparse >= 0).all()) and bool((sparse < counts).all())
    labels = torch.cat([p["label"] for p in a])
    assert set(labels.unique().tolist()) <= {0.0, 1.0}


def test_full_pool_is_a_third_of_a_gigabyte():
    c = load_cell("dlrm-kaggle.train-zipf")
    cfg, tr = c["config"], c["traffic"]
    per = tr["batch"] * (4 * cfg["dim_dense"] + 4 * len(cfg["ln_emb"]) + 4)
    assert per * tr["pool_batches"] / 1e9 == pytest.approx(0.34, abs=0.01)


def test_weights_repeat_with_the_seed(tiny):
    cfg = tiny("bpr-amazon.serve-k1")["config"]
    a = weights.bpr_weights(cfg, 2 ** 31 + 1, "cpu")
    b = weights.bpr_weights(cfg, 2 ** 31 + 1, "cpu")
    for key in a:
        assert torch.equal(a[key], b[key])
    assert a["item_bias"].shape == (cfg["total_items"],)
