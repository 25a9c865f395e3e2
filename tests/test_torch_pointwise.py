"""Port parity: the pointwise data path.

The host samplers (`StratifiedPointwiseSampler` on its numpy and C++
branches, `PerPosStratifiedPointwiseSampler`, `RandomPointwiseSampler`)
and the `Dataset` facade over the `Prefetcher` (1 and 4 workers, each
folding its id into the seed) must give batch streams bit-identical to
the JAX package's for the same store and seed. The on-device
`DevicePointwiseSampler` draws from a torch.Generator, so its properties
are held instead, as tests/test_torch_device_sampler.py holds the
pairwise one's: membership answers equal JAX's, a negative is a positive
only when all its 1 + rounds draws were, labels are 1 then 0, record picks
are uniform (chi-square), and the per-step device loop trains.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from openrec_tpu import native as jnative
from openrec_tpu.data import dataset as jdataset
from openrec_tpu.data import samplers as jsamplers
from openrec_tpu.data.device_sampler import DevicePointwiseSampler as JDev
from openrec_tpu.data.store import InteractionStore as JStore
from openrec_tpu_torch import native
from openrec_tpu_torch.data import (Dataset, DevicePointwiseSampler,
                                    EvaluationSampler, InteractionStore,
                                    samplers)
from openrec_tpu_torch.models import WRMF
from openrec_tpu_torch.training import Trainer
from tests.conftest import make_interactions, make_low_rank

torch.set_num_threads(1)

USERS, ITEMS = 40, 100


@pytest.fixture(autouse=True)
def fresh_loads(monkeypatch):
    """Both packages decide once per process whether their library loads;
    each test starts from an empty cache so both decide on the same
    library state (and OPENREC_TPU_NO_NATIVE as the test sets it)."""
    for mod in (jnative, native):
        monkeypatch.setattr(mod, "_lib", None)
        monkeypatch.setattr(mod, "_tried", False)


def _stores(data=None, users=USERS, items=ITEMS):
    data = make_interactions() if data is None else data
    return (InteractionStore(data, users, items, seed=0),
            JStore(data, users, items, seed=0))


def _assert_batches(got, want):
    assert sorted(got) == sorted(want)
    for key in want:
        assert got[key].dtype == want[key].dtype, key
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)


def _native_or_skip(use_native):
    if use_native and not jnative.available():
        pytest.skip("the JAX package's native library is not available")
    if use_native:
        assert native.available()


# ------------------------------------------------------------ host samplers

@pytest.mark.parametrize("chronological", [False, True])
@pytest.mark.parametrize("use_native", [False, True])
def test_stratified_stream_bit_identical(use_native, chronological):
    _native_or_skip(use_native)
    ts, js = _stores()
    # 320 records, 48 positives a batch: the shuffled stream wraps its
    # epoch; the chronological one ends after 6 batches
    tsam = samplers.StratifiedPointwiseSampler(
        ts, 240, pos_ratio=0.2, seed=9, use_native=use_native,
        chronological=chronological)
    jsam = jsamplers.StratifiedPointwiseSampler(
        js, 240, pos_ratio=0.2, seed=9, use_native=use_native,
        chronological=chronological)
    assert tsam.use_native == jsam.use_native == use_native
    got, want = [], []
    for _ in range(8):
        try:
            w = jsam.sample()
        except jsamplers.EndOfData:
            with pytest.raises(samplers.EndOfData):
                tsam.sample()
            break
        g = tsam.sample()
        _assert_batches(g, w)
        got.append(g)
        want.append(w)
    assert len(got) == (6 if chronological else 8)
    u = np.concatenate([g["user_id"] for g in got])
    i = np.concatenate([g["item_id"] for g in got])
    label = np.concatenate([g["label"] for g in got])
    np.testing.assert_array_equal(ts.is_positive(u, i), label == 1.0)
    assert label.reshape(len(got), -1)[:, :48].all()
    if not chronological:   # worker clones: streams of their own
        _assert_batches(tsam.with_seed((9, 2)).sample(),
                        jsam.with_seed((9, 2)).sample())


def test_stratified_default_follows_the_jax_rule(monkeypatch):
    """use_native None: the C++ feeder wherever it builds, unless the store
    holds pre-sampled negatives; numpy under OPENREC_TPU_NO_NATIVE=1."""
    ts, js = _stores()
    got = samplers.StratifiedPointwiseSampler(ts, 32)
    want = jsamplers.StratifiedPointwiseSampler(js, 32)
    assert got.use_native == want.use_native == jnative.available()
    _assert_batches(got.sample(), want.sample())
    data = make_interactions()
    neg = InteractionStore(data, USERS, ITEMS, seed=0, num_negatives=5)
    assert not samplers.StratifiedPointwiseSampler(neg, 32).use_native
    for mod in (jnative, native):
        monkeypatch.setattr(mod, "_lib", None)
        monkeypatch.setattr(mod, "_tried", False)
    monkeypatch.setenv("OPENREC_TPU_NO_NATIVE", "1")
    assert not samplers.StratifiedPointwiseSampler(ts, 32).use_native
    with pytest.raises(RuntimeError, match="native"):
        samplers.StratifiedPointwiseSampler(ts, 32, use_native=True)


@pytest.mark.parametrize("name,kw", [
    ("PerPosStratifiedPointwiseSampler", {"pos_ratio": 0.25}),
    ("PerPosStratifiedPointwiseSampler", {"pos_ratio": 0.3}),  # ragged cut
    ("RandomPointwiseSampler", {}),
])
def test_other_pointwise_streams_bit_identical(name, kw):
    ts, js = _stores()
    tsam = getattr(samplers, name)(ts, 50, seed=4, **kw)
    jsam = getattr(jsamplers, name)(js, 50, seed=4, **kw)
    for _ in range(10):
        got = tsam.sample()
        _assert_batches(got, jsam.sample())
        assert len(got["label"]) == 50
    if name.startswith("PerPos"):
        group = 1 + tsam.k_neg
        labels = got["label"]
        assert labels[::group].all() and labels.sum() == -(-50 // group)
        pos = got["item_id"][::group].repeat(group)[:50]
        assert not (got["item_id"] == pos)[labels == 0].any()
    else:
        np.testing.assert_array_equal(
            ts.is_positive(got["user_id"], got["item_id"]),
            got["label"] == 1.0)


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


@pytest.mark.parametrize("workers", [1, 4])
@pytest.mark.parametrize("method,kw,use_native", [
    ("stratified_pointwise", {"pos_ratio": 0.2}, False),
    ("stratified_pointwise", {"pos_ratio": 0.2}, True),
    ("per_pos_stratified_pointwise", {"pos_ratio": 0.5}, False),
    ("random_pointwise", {}, False),
])
def test_dataset_facade_matches_jax(monkeypatch, method, kw, use_native,
                                    workers):
    """The Dataset methods against the JAX package's samplers under its
    DEFAULT choice of branch (native where it builds, numpy under
    OPENREC_TPU_NO_NATIVE=1; only the stratified sampler has a native
    branch), each worker w drawing the stream of seed (seed, w)."""
    _native_or_skip(use_native)
    if not use_native:
        monkeypatch.setenv("OPENREC_TPU_NO_NATIVE", "1")
    data = make_interactions(50, 300, 40, seed=3)
    ds = Dataset(data, 50, 300, seed=3)
    jds = jdataset.Dataset(data, 50, 300, seed=3)
    take = 12
    feed = getattr(ds, method)(64, num_parallel_calls=workers, take=take,
                               **kw)
    jfeed = getattr(jds, method)(64, num_parallel_calls=workers, take=take,
                                 **kw)
    got = list(feed)
    feed.stop()
    jfeed.stop()
    if method == "stratified_pointwise":
        assert feed._sampler.use_native == jfeed._sampler.use_native \
            == use_native
    assert len(got) == take
    streams = []
    for w in range(workers):
        local = jfeed._sampler.with_seed((3, w))
        streams.append([local.sample() for _ in range(take)])
    assert sum(_match_workers(got, streams)) == take


def test_stratified_chronological_facade_is_one_epoch():
    data = make_interactions()
    ds = Dataset(data, USERS, ITEMS, seed=1)
    js = JStore(data, USERS, ITEMS, seed=1)
    got = list(ds.stratified_pointwise(100, pos_ratio=0.5,
                                       num_parallel_calls=4,
                                       chronological=True))
    want = jsamplers.StratifiedPointwiseSampler(
        js, 100, pos_ratio=0.5, seed=1, chronological=True).with_seed((1, 0))
    assert len(got) == len(data) // 50
    for g in got:
        _assert_batches(g, want.sample())


# ----------------------------------------------------------- device sampler

def _dense_store(users=30, items=12, seed=0):
    """Each user holds about half the catalog: rejection often fails."""
    rng = np.random.default_rng(seed)
    rows = [(u, i) for u in range(users) for i in range(items)
            if rng.random() < 0.5]
    data = np.array(rows, dtype=[("user_id", np.int32),
                                 ("item_id", np.int32)])
    return (InteractionStore(data, users, items, seed=0),
            JStore(data, users, items, seed=0))


@pytest.mark.parametrize("membership", ["bitmap", "searchsorted"])
def test_device_pointwise_is_positive_matches_jax(membership):
    ts, js = _stores()
    tsam = DevicePointwiseSampler(ts, 64, membership=membership,
                                  device="cpu")
    jsam = JDev(js, 64, membership=membership)
    assert tsam.membership == jsam.membership == membership
    u, i = np.meshgrid(np.arange(USERS), np.arange(ITEMS), indexing="ij")
    u, i = u.ravel().astype(np.int32), i.ravel().astype(np.int32)
    want = np.asarray(jsam.is_positive(jnp.asarray(u), jnp.asarray(i)))
    got = tsam.is_positive(torch.from_numpy(u), torch.from_numpy(i))
    np.testing.assert_array_equal(got.numpy(), want)
    assert not hasattr(tsam, "sample_stacked") \
        and not hasattr(jsam, "sample_stacked")


@pytest.mark.parametrize("membership", ["bitmap", "searchsorted"])
def test_device_pointwise_follows_the_rejection_rounds(membership):
    ts, _ = _dense_store()
    B, ratio = 512, 0.25
    s = DevicePointwiseSampler(ts, B, pos_ratio=ratio, membership=membership,
                               device="cpu")
    P, R = s.n_pos, s.reject_rounds
    assert P == int(B * ratio) == 128
    batch = s.sample(torch.Generator().manual_seed(7))
    # replay the same draws: records [P], users and items [R + 1, B - P]
    g = torch.Generator().manual_seed(7)
    idx = torch.randint(0, s.num_records, (P,), generator=g,
                        dtype=torch.int32).numpy()
    users = torch.randint(0, 30, (R + 1, B - P), generator=g,
                          dtype=torch.int32).numpy()
    items = torch.randint(0, 12, (R + 1, B - P), generator=g,
                          dtype=torch.int32).numpy()
    u, i = batch["user_id"].numpy(), batch["item_id"].numpy()
    np.testing.assert_array_equal(u[:P], ts._pos_users[idx])
    np.testing.assert_array_equal(i[:P], ts._pos_items[idx])
    pos = np.stack([ts.is_positive(a, b) for a, b in zip(users, items)])
    # the first draw that is not a positive, else the last round's draw
    first_ok = np.where(pos[:R].all(axis=0), R, np.argmin(pos[:R], axis=0))
    np.testing.assert_array_equal(
        u[P:], np.take_along_axis(users, first_ok[None], axis=0)[0])
    np.testing.assert_array_equal(
        i[P:], np.take_along_axis(items, first_ok[None], axis=0)[0])
    bad = ts.is_positive(u[P:], i[P:])
    np.testing.assert_array_equal(bad, pos.all(axis=0))
    assert ts.is_positive(u[:P], i[:P]).all()
    density = len(ts._pos_keys) / (30 * 12)
    assert bad.mean() <= 3 * density ** (R + 1)
    # labels: P ones, then zeros; ids int32, labels float32
    label = batch["label"]
    assert label.dtype == torch.float32 and batch["user_id"].dtype \
        == batch["item_id"].dtype == torch.int32
    assert torch.equal(label, torch.cat([torch.ones(P),
                                         torch.zeros(B - P)]))


def test_device_pointwise_record_picks_are_uniform():
    ts, _ = _stores()
    s = DevicePointwiseSampler(ts, 1000, pos_ratio=0.5, device="cpu")
    g = torch.Generator().manual_seed(3)
    keys = []
    for _ in range(40):
        b = s.sample(g)
        keys.append(b["user_id"][:s.n_pos].long() * ITEMS
                    + b["item_id"][:s.n_pos].long())
    keys = torch.cat(keys).numpy()
    counts = np.bincount(np.searchsorted(ts._pos_keys, keys),
                         minlength=len(ts._pos_keys))
    expected = len(keys) / len(ts._pos_keys)
    chi2 = ((counts - expected) ** 2 / expected).sum()
    df = len(ts._pos_keys) - 1
    assert chi2 < df + 6 * np.sqrt(2 * df), chi2      # p < 1e-6 to fail


def test_device_pointwise_loop_learns_low_rank():
    """WRMF trained on the device sampler through both K-step entry
    points; the sampler has no sample_stacked, so every step draws its own
    batch inside the loop. The bar is the JAX package's for WRMF on the
    same planted data (tests/test_models_train.py: AUC > 0.75)."""
    train, test = make_low_rank()
    store = InteractionStore(train, 64, 256, seed=0)
    model = WRMF(64, 256, 16, 16, a=1.0, b=0.05, l2_weight=1e-4,
                 device="cpu", generator=torch.Generator().manual_seed(0))
    tr = Trainer(model, lr=0.05, seed=0, device="cpu")
    s = DevicePointwiseSampler(store, 256, pos_ratio=0.5, device="cpu")
    first = tr.train_steps_device(s, 10)
    for _ in range(3):
        last = tr.train_steps_device(s, 50)
    assert tr.global_step == 160
    assert torch.isfinite(last).all() and last.mean() < first.mean()
    assert tr.train_steps_device(s, 5, fused=True).shape == (5,)
    ev = EvaluationSampler(InteractionStore(test, 64, 256, seed=0), 32,
                           excl_stores=[store])
    tr.train(40, s, steps_per_call=20, verbose=False)
    assert tr.global_step == 205
    assert tr.evaluate(ev, at=(50,))["AUC"] > 0.75
