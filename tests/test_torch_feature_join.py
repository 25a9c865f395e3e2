"""Port parity: feature-joined sampling and the Tradesy / Amazon-book
loaders.

`FeatureJoinedSampler` over the port's `PairwiseSampler`, on its numpy
path and on the C++ feeder, and `Dataset.pairwise(joins=...)` over the
`Prefetcher` with 1 and 2 workers, must give batch streams bit-identical
to the JAX package's for the same store and seed, features and all, with
the ids' stream equal to the base sampler's. Like the JAX package's, the
joined sampler has no seed of its own, so the Prefetcher seeds its
workers (0, worker id). Joins read a memmap row by row and give ndarrays.
`load_tradesy` and `load_amazon_book` must be bit-identical to the JAX
package's on `tests/fixtures/dataset/`, the Amazon features still a lazy
memmap.
"""

import os

import numpy as np
import pytest

from openrec_tpu import native as jnative
from openrec_tpu.data import dataset as jdataset
from openrec_tpu.data import loaders as jloaders
from openrec_tpu.data import samplers as jsamplers
from openrec_tpu.data.store import InteractionStore as JStore
from openrec_tpu_torch import native
from openrec_tpu_torch.data import (Dataset, InteractionStore, loaders,
                                    samplers)
from tests.conftest import make_interactions

USERS, ITEMS = 40, 100
FIXTURES = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "fixtures", "dataset") + os.sep
FEATURES = np.random.default_rng(1).random((ITEMS, 7), dtype=np.float32)
JOINS = [("p_item_id", FEATURES, "p_item_vfeature"),
         ("n_item_id", FEATURES, "n_item_vfeature")]


@pytest.fixture(autouse=True)
def fresh_loads(monkeypatch):
    """Both packages decide once per process whether their library loads;
    each test starts from an empty cache."""
    for mod in (jnative, native):
        monkeypatch.setattr(mod, "_lib", None)
        monkeypatch.setattr(mod, "_tried", False)


def _native_or_skip(use_native):
    if use_native and not jnative.available():
        pytest.skip("the JAX package's native library is not available")
    if use_native:
        assert native.available()


def _stores(data=None):
    data = make_interactions() if data is None else data
    return (InteractionStore(data, USERS, ITEMS, seed=0),
            JStore(data, USERS, ITEMS, seed=0))


def _assert_batches(got, want):
    assert sorted(got) == sorted(want)
    for key in want:
        assert type(got[key]) is np.ndarray, key
        assert got[key].dtype == want[key].dtype, key
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)


@pytest.mark.parametrize("use_native", [False, True])
def test_joined_stream_bit_identical(use_native):
    """12 batches of 64 over 320 records (the epoch wraps), then a worker
    clone's; the ids are the base sampler's stream, the features their
    rows."""
    _native_or_skip(use_native)
    ts, js = _stores()
    tbase = samplers.PairwiseSampler(ts, 64, seed=5, use_native=use_native)
    jbase = jsamplers.PairwiseSampler(js, 64, seed=5, use_native=use_native)
    plain = samplers.PairwiseSampler(ts, 64, seed=5, use_native=use_native)
    assert tbase.use_native == jbase.use_native == use_native
    tsam = samplers.FeatureJoinedSampler(tbase, JOINS)
    jsam = jsamplers.FeatureJoinedSampler(jbase, JOINS)
    for _ in range(12):
        got = tsam.sample()
        _assert_batches(got, jsam.sample())
        ids = plain.sample()
        _assert_batches({k: got[k] for k in ids}, ids)
        np.testing.assert_array_equal(got["n_item_vfeature"],
                                      FEATURES[got["n_item_id"]])
    _assert_batches(tsam.with_seed((5, 1)).sample(),
                    jsam.with_seed((5, 1)).sample())
    assert tsam.with_seed(3).base is not tbase


def _match_workers(got, streams):
    """Every batch of `got` is the next one of some worker's stream (the
    queue interleaves workers, each keeps its order)."""
    pos = [0] * len(streams)
    for g in got:
        for w, stream in enumerate(streams):
            want = stream[pos[w]] if pos[w] < len(stream) else None
            if want is not None and all(np.array_equal(g[k], want[k])
                                        for k in want):
                _assert_batches(g, want)
                pos[w] += 1
                break
        else:
            raise AssertionError("a batch is no worker's next batch")
    return pos


@pytest.mark.parametrize("workers", [1, 2])
@pytest.mark.parametrize("use_native", [False, True])
def test_dataset_pairwise_joins_match_jax(monkeypatch, use_native, workers):
    """Dataset(seed=3).pairwise(joins=...) against the JAX package's under
    its default choice of branch; each worker w draws the joined stream
    of seed (0, w), since the joined sampler carries no seed, in both
    packages."""
    _native_or_skip(use_native)
    if not use_native:
        monkeypatch.setenv("OPENREC_TPU_NO_NATIVE", "1")
    data = make_interactions(50, 300, 40, seed=3)
    ds = Dataset(data, 50, 300, seed=3)
    jds = jdataset.Dataset(data, 50, 300, seed=3)
    feats = np.random.default_rng(2).random((300, 5), dtype=np.float32)
    joins = [("p_item_id", feats, "p_item_vfeature"),
             ("n_item_id", feats, "n_item_vfeature")]
    take = 10
    feed = ds.pairwise(64, num_parallel_calls=workers, take=take,
                       joins=joins)
    jfeed = jds.pairwise(64, num_parallel_calls=workers, take=take,
                         joins=joins)
    got = list(feed)
    feed.stop()
    jfeed.stop()
    assert isinstance(feed._sampler, samplers.FeatureJoinedSampler)
    assert feed._sampler.base.use_native == jfeed._sampler.base.use_native \
        == use_native
    assert not hasattr(feed._sampler, "seed") \
        and not hasattr(jfeed._sampler, "seed")
    assert len(got) == take
    streams = []
    for w in range(workers):
        local = jfeed._sampler.with_seed((0, w))
        streams.append([local.sample() for _ in range(take)])
    assert sum(_match_workers(got, streams)) == take


def test_joins_read_a_memmap_row_by_row(tmp_path):
    path = tmp_path / "features.mem"
    mm = np.memmap(path, dtype=np.float32, mode="w+", shape=FEATURES.shape)
    mm[:] = FEATURES
    mm.flush()
    lazy = np.memmap(path, dtype=np.float32, mode="r", shape=FEATURES.shape)
    ts, _ = _stores()
    sam = samplers.FeatureJoinedSampler(
        samplers.PairwiseSampler(ts, 32, seed=1, use_native=False),
        [("p_item_id", lazy, "p_item_vfeature")])
    batch = sam.sample()
    assert type(batch["p_item_vfeature"]) is np.ndarray
    np.testing.assert_array_equal(batch["p_item_vfeature"],
                                  FEATURES[batch["p_item_id"]])


def test_a_chronological_base_ends_the_joined_stream():
    """320 records in batches of 64: five batches, then the stream ends
    (the JAX package's `__iter__` lets EndOfData escape instead)."""
    ts, _ = _stores()
    sam = samplers.FeatureJoinedSampler(
        samplers.PairwiseSampler(ts, 64, seed=0, use_native=False,
                                 chronological=True), JOINS)
    batches = list(sam)
    assert len(batches) == 5
    np.testing.assert_array_equal(
        np.concatenate([b["p_item_id"] for b in batches]),
        ts.raw_data["item_id"])


# ----------------------------------------------------------------- loaders

def test_load_tradesy_bit_identical():
    got = loaders.load_tradesy(FIXTURES)
    want = jloaders.load_tradesy(FIXTURES)
    assert got.keys() == want.keys()
    assert (got["total_users"], got["total_items"]) == (19243, 165906)
    assert loaders.TRADESY == jloaders.TRADESY
    for key in ("train_data", "val_data", "test_data", "item_features"):
        assert got[key].dtype == want[key].dtype, key
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)
    assert got["item_features"].dtype == np.float32
    on_disk = np.load(os.path.join(FIXTURES, "tradesy", "item_features.npy"))
    np.testing.assert_array_equal(got["item_features"],
                                  on_disk / np.float32(32.671101))


@pytest.mark.parametrize("feature_shape", [(50, 16), (100, 8)])
def test_load_amazon_book_bit_identical_and_lazy(feature_shape):
    got = loaders.load_amazon_book(FIXTURES, feature_shape=feature_shape)
    want = jloaders.load_amazon_book(FIXTURES, feature_shape=feature_shape)
    assert got.keys() == want.keys()
    assert loaders.AMAZON_BOOK == jloaders.AMAZON_BOOK \
        == {"total_users": 99473, "total_items": 450166}
    assert isinstance(got["item_features"], np.memmap)
    assert got["item_features"].shape == feature_shape
    assert got["item_features"].dtype == np.float32
    assert got["user_features"].dtype == np.int32
    for key in ("train_data", "val_data", "test_data", "item_features",
                "user_features"):
        np.testing.assert_array_equal(np.asarray(got[key]),
                                      np.asarray(want[key]), err_msg=key)


def test_amazon_default_shape_is_the_catalog_by_4096():
    """Without `feature_shape` the memmap is (total_items, 4096), which the
    fixture's 3,200 bytes cannot hold: numpy refuses to map it, in both
    packages alike."""
    for mod in (loaders, jloaders):
        with pytest.raises(ValueError):
            mod.load_amazon_book(FIXTURES)
