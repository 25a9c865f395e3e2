"""Port parity: the C++ sampler feeder (`openrec_tpu_torch/native/`, the
port's own copy of `openrec_tpu/native/sampler.cpp`) against the JAX
package's, through `PairwiseSampler(use_native=True)`. For one store,
seed and OPENREC_TPU_SAMPLER_THREADS the two batch streams must be
bit-identical: across an epoch wrap, for `with_seed` clones and on the
chronological path.
"""

import numpy as np
import pytest

from openrec_tpu import native as jnative
from openrec_tpu.data.samplers import PairwiseSampler as JPairwise
from openrec_tpu.data.store import InteractionStore as JStore
from openrec_tpu_torch import native
from openrec_tpu_torch.data import InteractionStore, PairwiseSampler
from tests.conftest import make_interactions

# 1,000 users x 40 records = 40,000 records; batches of 4,096 reach the
# feeder's threaded branch (batch >= 4096), and 12 of them wrap the epoch
USERS, ITEMS, PER_USER, BATCH = 1000, 2000, 40, 4096


@pytest.fixture(autouse=True)
def fresh_loads(monkeypatch):
    """Each test loads both libraries afresh (both packages decide once
    per process and cache it; a load that raced another worker's build
    must not decide for the tests that follow)."""
    for mod in (jnative, native):
        monkeypatch.setattr(mod, "_lib", None)
        monkeypatch.setattr(mod, "_tried", False)


def _need_reference():
    """Native availability is decided here, inside each test: the JAX
    package's library is the reference, and where it builds the port's
    must build too."""
    if not jnative.available():
        pytest.skip("the JAX package's native library is not available")
    assert native.available()


def _assert_batches(got, want):
    assert sorted(got) == sorted(want)
    for key in want:
        assert got[key].dtype == want[key].dtype, key
        np.testing.assert_array_equal(got[key], want[key])


@pytest.fixture(scope="module")
def stores():
    data = make_interactions(USERS, ITEMS, PER_USER, seed=1)
    return (InteractionStore(data, USERS, ITEMS, seed=0),
            JStore(data, USERS, ITEMS, seed=0))


@pytest.mark.parametrize("chronological", [False, True])
@pytest.mark.parametrize("threads", [1, 2])
def test_native_stream_bit_identical(monkeypatch, stores, threads,
                                     chronological):
    _need_reference()
    monkeypatch.setenv("OPENREC_TPU_SAMPLER_THREADS", str(threads))
    ts, js = stores
    tsam = PairwiseSampler(ts, BATCH, seed=11, use_native=True,
                           chronological=chronological)
    jsam = JPairwise(js, BATCH, seed=11, use_native=True,
                     chronological=chronological)
    assert tsam.use_native and jsam.use_native
    n_rec = USERS * PER_USER
    if chronological:          # one finite epoch, the tail dropped
        got, want = list(tsam), list(jsam)
        assert len(got) == len(want) == n_rec // BATCH
    else:                      # 12 * 4096 > 40,000 records: one wrap
        got = [tsam.sample() for _ in range(12)]
        want = [jsam.sample() for _ in range(12)]
    for g, w in zip(got, want):
        _assert_batches(g, w)
    # every batch is real: positives are positives, negatives are not
    u = np.concatenate([g["user_id"] for g in got])
    assert ts.is_positive(u, np.concatenate([g["p_item_id"]
                                             for g in got])).all()
    assert not ts.is_positive(u, np.concatenate([g["n_item_id"]
                                                 for g in got])).any()
    # prefetch workers' clones, taken from a parent that is mid-epoch
    tclone, jclone = tsam.with_seed((11, 1)), jsam.with_seed((11, 1))
    for _ in range(2):
        _assert_batches(tclone.sample(), jclone.sample())


def test_native_threads_change_the_stream(monkeypatch, stores):
    """OPENREC_TPU_SAMPLER_THREADS is read per call: 2 threads give each
    half of a batch its own generator, so the negatives differ from the
    1-thread stream while the (user, positive) window does not."""
    _need_reference()
    ts, _ = stores
    batches = {}
    for threads in (1, 2):
        monkeypatch.setenv("OPENREC_TPU_SAMPLER_THREADS", str(threads))
        batches[threads] = PairwiseSampler(ts, BATCH, seed=5,
                                           use_native=True).sample()
    one, two = batches[1], batches[2]
    np.testing.assert_array_equal(one["user_id"], two["user_id"])
    np.testing.assert_array_equal(one["p_item_id"], two["p_item_id"])
    assert (one["n_item_id"] != two["n_item_id"]).any()


def test_native_build_is_keyed_by_source():
    """The port loads only the library it built from its own source: a
    file in its build directory named by the source's hash."""
    _need_reference()
    path = native.library_path()
    assert path.exists() and path.parent.name == "build"
    assert path.parent.parent.name == "openrec_tpu_torch"
    assert (path.parent.parent / "native" / "sampler.cpp").is_file()


def test_binary_search_wrappers_match_jax_on_the_fixture():
    """`sample_negatives`, `is_positive` and `pairwise_batch` over the
    sorted u*I+i keys of the CiteULike fixture's train split: the JAX
    package's outputs, dtypes included, for the same seed; the negatives
    are no positives."""
    import os

    from openrec_tpu.data import loaders as jloaders

    _need_reference()
    raw = jloaders.load_citeulike(os.path.join(
        os.path.dirname(os.path.abspath(__file__)), "fixtures", "dataset")
        + os.sep)
    train, users, items = (raw["train_data"], raw["total_users"],
                           raw["total_items"])
    rec_u = np.ascontiguousarray(train["user_id"], np.int32)
    rec_i = np.ascontiguousarray(train["item_id"], np.int32)
    keys = np.unique(rec_u.astype(np.int64) * items + rec_i)
    rng = np.random.default_rng(0)
    n = len(rec_u)                   # every positive, then random pairs
    qu = np.concatenate([rec_u, rng.integers(0, users, 2000)])
    qi = np.concatenate([rec_i, rng.integers(0, items, 2000)])
    got = native.is_positive(keys, qu, qi, items)
    want = jnative.is_positive(keys, qu, qi, items)
    assert got.dtype == want.dtype == bool
    np.testing.assert_array_equal(got, want)
    assert got[:n].all()
    for seed in (0, 2 ** 63 + 5, -3):
        got = native.sample_negatives(keys, qu, items, seed)
        want = jnative.sample_negatives(keys, qu, items, seed)
        assert got.dtype == want.dtype == np.int32
        np.testing.assert_array_equal(got, want)
        assert not native.is_positive(keys, qu, got, items).any()
        idx = rng.integers(0, len(rec_u), 2000)
        got = native.pairwise_batch(keys, rec_u, rec_i, idx, items, seed,
                                    max_rounds=8)
        want = jnative.pairwise_batch(keys, rec_u, rec_i, idx, items, seed,
                                      max_rounds=8)
        for g, w in zip(got, want):
            assert g.dtype == w.dtype == np.int32
            np.testing.assert_array_equal(g, w)
        np.testing.assert_array_equal(got[0], rec_u[idx])
        np.testing.assert_array_equal(got[1], rec_i[idx])
