"""Port parity: the host data layer (InteractionStore, PairwiseSampler,
EvaluationSampler, Dataset, the pipeline and the CiteULike loaders)
against the JAX package's numpy path (`use_native=False`). The same
seed must give bit-identical arrays: same values, same dtypes.
"""

import os

import numpy as np
import pytest
import torch

from openrec_tpu.data import loaders as jloaders
from openrec_tpu.data import pipeline as jpipeline
from openrec_tpu.data.samplers import EvaluationSampler as JEval
from openrec_tpu.data.samplers import PairwiseSampler as JPairwise
from openrec_tpu.data.store import InteractionStore as JStore
from openrec_tpu_torch.data import (Dataset, EvaluationSampler,
                                    InteractionStore, PairwiseSampler,
                                    ShuffledArrayLoader, device_iterator,
                                    loaders, to_device)
from tests.conftest import make_interactions

torch.set_num_threads(1)

USERS, ITEMS = 40, 100
FIXTURES = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "fixtures", "dataset") + os.sep


def _assert_same(a, b):
    assert a.dtype == b.dtype, (a.dtype, b.dtype)
    np.testing.assert_array_equal(a, b)


def _assert_batches(got, want):
    assert sorted(got) == sorted(want)
    for key in want:
        _assert_same(np.asarray(got[key]), np.asarray(want[key]))


def _explicit(seed=0):
    data = make_interactions(seed=seed, timestamps=True)
    rng = np.random.default_rng(seed)
    out = np.zeros(len(data), dtype=[("user_id", np.int32),
                                     ("item_id", np.int32),
                                     ("ts", np.int32), ("label", np.int32)])
    for f in ("user_id", "item_id", "ts"):
        out[f] = data[f]
    out["label"] = rng.integers(0, 2, len(data))
    return out


@pytest.mark.parametrize("kw", [{}, {"num_negatives": 5},
                                {"implicit_negative": False},
                                {"sortby": "ts", "asc": False}])
def test_store_matches_jax(kw):
    data = _explicit() if kw else make_interactions()
    js, ts = (cls(data, USERS, ITEMS, seed=3, **kw)
              for cls in (JStore, InteractionStore))
    rng = np.random.default_rng(0)
    u = rng.integers(0, USERS, 500)
    i = rng.integers(0, ITEMS, 500)
    _assert_same(ts.is_positive(u, i), js.is_positive(u, i))
    for a, b in zip(ts.positive_csr(), js.positive_csr()):
        _assert_same(a, b)
    assert ts.contain_negatives() == js.contain_negatives()
    if js.contain_negatives():
        for a, b in zip(ts.negative_csr(), js.negative_csr()):
            _assert_same(a, b)
    _assert_same(ts.next_random_record_indices(250),
                 js.next_random_record_indices(250))
    _assert_same(ts.sample_negative_items(u[:50]),
                 js.sample_negative_items(u[:50]))
    _assert_same(ts.sample_negative_items_multi(u[:10], 3),
                 js.sample_negative_items_multi(u[:10], 3))
    _assert_same(ts.sample_positive_items(3, 4),
                 js.sample_positive_items(3, 4))
    _assert_same(ts.get_negative_items(5), js.get_negative_items(5))
    _assert_same(ts.warm_users(9), js.warm_users(9))
    if "sortby" in kw:
        _assert_same(ts.get_positive_items(2, sort=True),
                     js.get_positive_items(2, sort=True))
    assert (ts.total_users(), ts.total_items(), ts.total_records()) == \
        (js.total_users(), js.total_items(), js.total_records())


@pytest.mark.parametrize("chronological", [False, True])
def test_pairwise_sampler_bit_identical(chronological):
    data = make_interactions()
    js = JStore(data, USERS, ITEMS, seed=0)
    ts = InteractionStore(data, USERS, ITEMS, seed=0)
    jsam = JPairwise(js, 48, seed=11, use_native=False,
                     chronological=chronological)
    tsam = PairwiseSampler(ts, 48, seed=11, chronological=chronological)
    if chronological:          # one finite epoch, the tail dropped
        got, want = list(tsam), list(jsam)
        assert len(got) == len(want) == 320 // 48
    else:                      # 12 * 48 > 320 records: crosses epochs
        got = [tsam.sample() for _ in range(12)]
        want = [jsam.sample() for _ in range(12)]
    for g, w in zip(got, want):
        _assert_batches(g, w)
    # prefetch workers' clones
    _assert_batches(tsam.with_seed((11, 1)).sample(),
                    jsam.with_seed((11, 1)).sample())


def test_pairwise_native_request_raises():
    ts = InteractionStore(make_interactions(), USERS, ITEMS, seed=0)
    with pytest.raises(NotImplementedError):
        PairwiseSampler(ts, 8, use_native=True)
    assert PairwiseSampler(ts, 8).use_native is False


@pytest.mark.parametrize("device_masks", [False, True])
def test_evaluation_sampler_matches_jax(device_masks):
    train = make_interactions(seed=0)
    val = make_interactions(seed=1, per_user=3)
    extra = make_interactions(seed=2, per_user=2)
    jstores = [JStore(d, USERS, ITEMS, seed=0) for d in (val, train, extra)]
    tstores = [InteractionStore(d, USERS, ITEMS, seed=0)
               for d in (val, train, extra)]
    jev = JEval(jstores[0], 16, excl_stores=jstores[1:],
                device_masks=device_masks)
    tev = EvaluationSampler(tstores[0], 16, excl_stores=tstores[1:],
                            device_masks=device_masks)
    assert len(tev) == len(jev) == 3
    got, want = list(tev), list(jev)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        _assert_batches(g, w)


def test_evaluation_sampler_sampled_negatives():
    data = make_interactions()
    js = JStore(data, USERS, ITEMS, seed=4, num_negatives=10)
    ts = InteractionStore(data, USERS, ITEMS, seed=4, num_negatives=10)
    for g, w in zip(EvaluationSampler(ts, 32), JEval(js, 32)):
        _assert_batches(g, w)
    with pytest.raises(ValueError):
        EvaluationSampler(ts, 32, device_masks=True)


def test_dataset_facade_matches_jax_workers():
    data = make_interactions()
    ds = Dataset(data, USERS, ITEMS, seed=5)
    js = JStore(data, USERS, ITEMS, seed=5)
    # one prefetch worker folds its id into the seed: (seed, 0)
    want = JPairwise(js, 32, seed=5, use_native=False).with_seed((5, 0))
    got = list(ds.pairwise(32, num_parallel_calls=1, take=4))
    assert len(got) == 4
    for g in got:
        _assert_batches(g, want.sample())
    two = list(ds.pairwise(32, num_parallel_calls=2, take=6))
    assert len(two) == 6
    chrono = list(ds.pairwise(64, chronological=True))
    assert len(chrono) == len(data) // 64
    ev = ds.evaluation(10, excl_datasets=[Dataset(data, USERS, ITEMS)],
                       device_masks=True)
    assert isinstance(ev, EvaluationSampler) and len(ev) == 4


def test_synthetic_and_fixture_loaders_match_jax():
    want = jloaders.synthetic_citeulike(num_records=5000, seed=3)
    got = loaders.synthetic_citeulike(num_records=5000, seed=3)
    assert (got["total_users"], got["total_items"]) == (5551, 16980)
    for key in ("train_data", "val_data", "test_data"):
        _assert_same(got[key], want[key])
    full = loaders.synthetic_citeulike()
    assert sum(len(full[k]) for k in ("train_data", "val_data",
                                      "test_data")) == 204_057
    _assert_same(loaders.synthetic_interactions(7, 9, 30, timestamps=True,
                                                seed=1),
                 jloaders.synthetic_interactions(7, 9, 30, timestamps=True,
                                                 seed=1))
    got = loaders.load_citeulike(FIXTURES)
    want = jloaders.load_citeulike(FIXTURES)
    assert got.keys() == want.keys()
    for key in ("train_data", "val_data", "test_data"):
        _assert_same(got[key], want[key])


def test_pipeline_cpu_tensors_and_loader():
    batch = {"a": np.arange(6, dtype=np.int32), "m": np.ones((2, 3), bool)}
    out = to_device(batch, "cpu")
    assert out["a"].dtype == torch.int32 and out["m"].dtype == torch.bool
    assert out["a"].tolist() == list(range(6))
    stream = list(device_iterator(iter([batch] * 5), "cpu", prefetch=2))
    assert len(stream) == 5
    arrays = {"x": np.arange(23), "y": np.arange(23) * 2}
    got = ShuffledArrayLoader(arrays, 5, seed=2)
    want = jpipeline.ShuffledArrayLoader(arrays, 5, seed=2)
    assert len(got) == len(want) == 4
    for g, w in zip(got.epoch(), want.epoch()):
        _assert_batches(g, w)
    assert len(list(ShuffledArrayLoader(arrays, 5, drop_remainder=False)
                    .epoch(shuffle=False))) == 5
