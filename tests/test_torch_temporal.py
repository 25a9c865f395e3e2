"""Port parity: the sequence models' data path and evaluator.

The same numpy records go through the JAX package and the port:
`TemporalSampler` and `TemporalEvaluationSampler` give bit-identical
batches for the same seed, bare and wrapped in `FeatureJoinedSampler`;
`Dataset.temporal` through one prefetch worker and
`Dataset.temporal_evaluation` with and without `joins=` too; the on-device
`DeviceTemporalSampler` (run here on the CPU) draws users and positions
from its generator and gathers windows, padding and labels from the
time-sorted CSR, replayed draw by draw; `load_lastfm` reads the fixture
as JAX's does; `Trainer.evaluate_temporal` agrees with JAX's on the same
weights and batches within 1e-6. The JAX package's own bars are mirrored
(`tests/test_samplers.py:105-142`, `tests/test_device_sampler.py:86`,
`tests/test_loaders_fixtures.py:89`, `tests/test_models_extended.py:371`).
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from openrec_tpu import Dataset as JDataset
from openrec_tpu.data import loaders as jloaders
from openrec_tpu.data import samplers as jsamplers
from openrec_tpu.data.store import InteractionStore as JStore
from openrec_tpu.models import sequence as jseq
from openrec_tpu.training import Trainer as JTrainer
from openrec_tpu_torch import convert, models
from openrec_tpu_torch.data import (Dataset, DeviceTemporalSampler,
                                    InteractionStore, loaders, samplers)
from openrec_tpu_torch.training import Trainer
from tests.conftest import make_interactions

torch.set_num_threads(1)

USERS, ITEMS = 50, 80
FIXTURES = os.path.join(os.path.dirname(__file__), "fixtures", "dataset")


def _records(seed=0, n=900):
    """Users with 0, 1, 2 and up to ~60 records, time stamps with ties
    broken by the stable sort, items repeating within a user."""
    rng = np.random.default_rng(seed)
    users = rng.choice(USERS - 3, n, p=np.linspace(1, 20, USERS - 3)
                       / np.linspace(1, 20, USERS - 3).sum())
    users = np.concatenate([users, [USERS - 2, USERS - 1, USERS - 1]])
    data = np.zeros(len(users), dtype=[("user_id", np.int32),
                                       ("item_id", np.int32),
                                       ("ts", np.int64)])
    data["user_id"] = users
    data["item_id"] = rng.integers(0, ITEMS, len(users))
    data["ts"] = rng.integers(0, 500, len(users))
    return data


def _stores(data=None, **kw):
    data = _records() if data is None else data
    return (InteractionStore(data, USERS, ITEMS, sortby="ts", **kw),
            JStore(data, USERS, ITEMS, sortby="ts", **kw))


def _equal(a, b):
    assert sorted(a) == sorted(b)
    for k in a:
        assert np.asarray(a[k]).dtype == np.asarray(b[k]).dtype, k
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


FEATS = np.random.default_rng(1).integers(0, 5, USERS).astype(np.int32)
JOINS = [("user_id", FEATS, "user_gender"),
         ("user_id", FEATS * 3, "user_geo")]


@pytest.mark.parametrize("joins", [False, True])
@pytest.mark.parametrize("seed,batch,L", [(0, 32, 5), (7, 17, 1),
                                          (3, 64, 100)])
def test_temporal_sampler_bit_identical(seed, batch, L, joins):
    store, jstore = _stores()
    s = samplers.TemporalSampler(store, batch, L, seed=seed)
    js = jsamplers.TemporalSampler(jstore, batch, L, seed=seed)
    if joins:
        s = samplers.FeatureJoinedSampler(s, JOINS)
        js = jsamplers.FeatureJoinedSampler(js, JOINS)
    for _ in range(6):
        _equal(s.sample(), js.sample())
    _equal(s.with_seed((seed, 1)).sample(), js.with_seed((seed, 1)).sample())


@pytest.mark.parametrize("joins", [False, True])
@pytest.mark.parametrize("batch,L", [(16, 5), (30, 100), (7, 3)])
def test_temporal_evaluation_bit_identical(batch, L, joins):
    """Every warm user's last item, one epoch, the last batch padded, via
    `Dataset.temporal_evaluation` (joined rows added to each batch)."""
    data = _records(2)
    ds = Dataset(data, USERS, ITEMS, sortby="ts", seed=0)
    jds = JDataset(data, USERS, ITEMS, sortby="ts", seed=0)
    kw = {"joins": JOINS} if joins else {}
    got = list(ds.temporal_evaluation(batch, L, **kw).epoch())
    want = list(jds.temporal_evaluation(batch, L, **kw).epoch())
    assert len(got) == len(want) > 1
    for a, b in zip(got, want):
        _equal(a, b)
    assert not got[-1]["valid"].all()
    assert (got[-1]["seq_len"][~got[-1]["valid"]] == 0).all()


@pytest.mark.parametrize("joins", [False, True])
def test_dataset_temporal_one_worker_bit_identical(joins):
    data = _records(3)
    kw = {"joins": JOINS} if joins else {}
    got = Dataset(data, USERS, ITEMS, sortby="ts", seed=4).temporal(
        24, 10, num_parallel_calls=1, take=12, **kw)
    want = JDataset(data, USERS, ITEMS, sortby="ts", seed=4).temporal(
        24, 10, num_parallel_calls=1, take=12, **kw)
    got, want = list(got), list(want)
    assert len(got) == len(want) == 12
    for a, b in zip(got, want):
        _equal(a, b)


def test_temporal_sampler_windows():
    """tests/test_samplers.py:105 on the port."""
    store = InteractionStore(make_interactions(timestamps=True), 40, 100,
                             seed=0, sortby="ts")
    b = samplers.TemporalSampler(store, batch_size=32, max_seq_len=5,
                                 seed=4).sample()
    assert b["seq_item_id"].shape == (32, 5)
    assert (b["seq_len"] >= 1).all() and (b["seq_len"] <= 5).all()
    for k in range(32):
        hist = store.get_positive_items(b["user_id"][k], sort=True).tolist()
        n = b["seq_len"][k]
        pos = hist.index(b["label"][k])
        assert hist[pos - n:pos] == b["seq_item_id"][k][:n].tolist()
        assert (b["seq_item_id"][k][n:] == 0).all()


def test_temporal_evaluation_last_item_holdout():
    """tests/test_samplers.py:125 on the port."""
    store = InteractionStore(make_interactions(timestamps=True), 40, 100,
                             seed=0, sortby="ts")
    s = samplers.TemporalEvaluationSampler(store, batch_size=16,
                                           max_seq_len=5)
    seen = []
    for b in s.epoch():
        for k in np.flatnonzero(b["valid"]):
            u = b["user_id"][k]
            seen.append(u)
            hist = store.get_positive_items(u, sort=True).tolist()
            assert b["label"][k] == hist[-1]
            n = b["seq_len"][k]
            assert b["seq_item_id"][k][:n].tolist() == hist[-1 - n:-1]
    warm = store.warm_users()
    assert sorted(seen) == sorted(
        warm[store.user_positive_counts()[warm] > 1].tolist())


def test_temporal_sampler_needs_a_sequence():
    data = np.array([(0, 1, 5), (1, 2, 3)], dtype=[
        ("user_id", np.int32), ("item_id", np.int32), ("ts", np.int64)])
    store = InteractionStore(data, 3, 4, sortby="ts")
    with pytest.raises(ValueError, match="more than one"):
        samplers.TemporalSampler(store, 4, 3)
    with pytest.raises(ValueError, match="more than one"):
        DeviceTemporalSampler(store, 4, 3, device="cpu")


# ---------------------------------------------------------- device sampler

@pytest.mark.parametrize("L", [1, 5, 40])
def test_device_temporal_sampler_replayed(L):
    """The batch is what the CSR gives for the draws a same-seeded
    generator makes: users [B] from the warm users, then positions
    1 + randint(0, 2^31 - 1) % (count - 1), the window before the
    position zero-padded, the item at it the label; int32 tensors."""
    store, _ = _stores()
    B = 300
    s = DeviceTemporalSampler(store, B, L, device="cpu")
    batch = s.sample(torch.Generator().manual_seed(5))
    gen = torch.Generator().manual_seed(5)
    counts = store.user_positive_counts()
    warm = np.flatnonzero(counts > 1)
    users = warm[torch.randint(0, len(warm), (B,), generator=gen).numpy()]
    draw = torch.randint(0, 2 ** 31 - 1, (B,), generator=gen,
                         dtype=torch.int32).numpy().astype(np.int64)
    pos = 1 + draw % (counts[users] - 1)
    ptr, _ = store.positive_csr()
    items = store._csr_items_sorted
    assert all(v.dtype == torch.int32 for v in batch.values())
    np.testing.assert_array_equal(batch["user_id"].numpy(), users)
    np.testing.assert_array_equal(batch["label"].numpy(),
                                  items[ptr[users] + pos])
    n = np.minimum(pos, L)
    np.testing.assert_array_equal(batch["seq_len"].numpy(), n)
    for k in range(B):
        lo = ptr[users[k]] + pos[k] - n[k]
        want = np.zeros(L, np.int32)
        want[:n[k]] = items[lo:lo + n[k]]
        np.testing.assert_array_equal(batch["seq_item_id"][k].numpy(), want)


def test_device_temporal_matches_host_semantics():
    """tests/test_device_sampler.py:86 on the port: every window is the
    items before some position of the user's sorted history that holds
    the label."""
    store = InteractionStore(make_interactions(timestamps=True), 40, 100,
                             seed=0, sortby="ts")
    L = 5
    b = DeviceTemporalSampler(store, 128, L, device="cpu").sample(
        torch.Generator().manual_seed(0))
    seq, seq_len = b["seq_item_id"].numpy(), b["seq_len"].numpy()
    labels, users = b["label"].numpy(), b["user_id"].numpy()
    assert seq.shape == (128, L)
    for k in range(128):
        hist = store.get_positive_items(users[k], sort=True).tolist()
        assert len(hist) > 1
        assert any(hist[p] == labels[k] and seq_len[k] == min(p, L)
                   and seq[k][:min(p, L)].tolist() == hist[p - min(p, L):p]
                   for p in range(1, len(hist)))
        assert (seq[k][seq_len[k]:] == 0).all()


def test_device_temporal_feeds_train_steps_device():
    """`Trainer.train_steps_device` draws each step's batch from the
    trainer's generator: one seed, one trajectory."""
    store, _ = _stores()

    def run(seed):
        model = models.RNNRec(ITEMS, 6, 8, 5, softmax_samples=10,
                              device="cpu",
                              generator=torch.Generator().manual_seed(0))
        s = DeviceTemporalSampler(store, 32, 8, device="cpu")
        return Trainer(model, lr=1e-2, seed=seed,
                       device="cpu").train_steps_device(s, 4)
    a = run(0)
    assert a.shape == (4,) and torch.isfinite(a).all()
    assert torch.equal(a, run(0)) and not torch.equal(a, run(1))


# ----------------------------------------------------------------- loaders

def test_load_lastfm_fixture_bit_identical():
    got, want = loaders.load_lastfm(FIXTURES), jloaders.load_lastfm(FIXTURES)
    assert sorted(got) == sorted(want)
    assert loaders.LASTFM == jloaders.LASTFM == {"total_users": 992,
                                                 "total_items": 14598}
    for key in ("train_data", "test_data", "val_data", "user_features"):
        assert got[key].dtype == want[key].dtype
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)
    assert got["val_data"] is got["test_data"]


def test_load_lastfm_without_user_features(tmp_path):
    folder = tmp_path / "lastfm"
    folder.mkdir()
    for name in ("lastfm_train.npy", "lastfm_test.npy"):
        np.save(folder / name, np.load(os.path.join(FIXTURES, "lastfm",
                                                    name)))
    assert "user_features" not in loaders.load_lastfm(str(tmp_path))


def test_lastfm_fixture_roundtrip_sequence():
    """tests/test_loaders_fixtures.py:89 on the port: the sortby='ts'
    pipeline and one RNNRec step."""
    raw = loaders.load_lastfm(FIXTURES)
    assert {"user_id", "user_gender", "user_geo"} <= set(
        raw["user_features"].dtype.names)
    U, I = 30, 50
    ds = Dataset(raw["train_data"], U, I, sortby="ts", seed=0)
    model = models.RNNRec(I, 8, 6, 8, device="cpu",
                          generator=torch.Generator().manual_seed(0))
    tr = Trainer(model, lr=0.05, seed=0, device="cpu")
    batch = next(iter(ds.temporal(batch_size=8, max_seq_len=6)))
    assert np.isfinite(float(tr.train_step(batch)[0]))


# --------------------------------------------------------------- evaluator

def _pair(cls, **kw):
    jmodel = getattr(jseq, cls)(**kw)
    params = jax.tree.map(np.asarray, jmodel.init(jax.random.PRNGKey(3)))
    params["item_embed"] = params["item_embed"] * 50.0
    model = getattr(models, cls)(**kw, device="cpu")
    model.load_params(convert.params_from_jax(params, device="cpu"))
    jt = JTrainer(jmodel, seed=0)
    jt.params = jax.tree.map(jnp.asarray, params)
    return jt, Trainer(model, device="cpu")


@pytest.mark.parametrize("name", ["RNNRec", "RNNRec-lstm", "YouTubeRec"])
def test_evaluate_temporal_matches_jax(name):
    """The same weights and batches (the last batch padded): AUC,
    Recall@k and NDCG@k means within 1e-6, at k 5 and 20."""
    data = _records(4)
    ds = Dataset(data, USERS, ITEMS, sortby="ts", seed=0)
    jds = JDataset(data, USERS, ITEMS, sortby="ts", seed=0)
    kw = dict(total_items=ITEMS, dim_item_embed=6, max_seq_len=8)
    joins = ()
    if name == "YouTubeRec":
        kw.update(total_genders=5, total_geos=15, dim_gender_embed=3,
                  dim_geo_embed=4)
        joins = JOINS
    else:
        kw.update(num_units=5, cell_type="lstm" if "lstm" in name else "gru")
    jt, tt = _pair(name.split("-")[0], **kw)
    got = tt.evaluate_temporal(ds.temporal_evaluation(20, 8, joins=joins),
                               at=(5, 20))
    want = jt.evaluate_temporal(jds.temporal_evaluation(20, 8, joins=joins),
                                at=(5, 20))
    assert sorted(got) == sorted(want) == ["AUC", "NDCG", "Recall"]
    for k in got:
        assert np.shape(got[k]) == np.shape(want[k])
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=1e-6,
                                   err_msg=k)
    assert 0.3 < got["AUC"] < 0.7 and got["Recall"][1] > got["Recall"][0]


def test_evaluate_temporal_counts_strictly_higher_scores():
    """rank = the items that score strictly above the label: a label tied
    with every item ranks first (AUC 1, Recall@1 1, NDCG 1)."""
    store, _ = _stores()
    model = models.RNNRec(ITEMS, 4, 5, 3, device="cpu")
    with torch.no_grad():
        model.out_weight.zero_()
        model.out_bias.zero_()
    res = Trainer(model, device="cpu").evaluate_temporal(
        samplers.TemporalEvaluationSampler(store, 16, 5), at=(1, 3))
    assert res["AUC"] == 1.0
    np.testing.assert_array_equal(res["Recall"], [1.0, 1.0])
    np.testing.assert_array_equal(res["NDCG"], [1.0, 1.0])


def test_temporal_evaluation_flow():
    """tests/test_models_extended.py:371 on the port."""
    store = InteractionStore(make_interactions(timestamps=True), 40, 100,
                             seed=0, sortby="ts")
    model = models.RNNRec(100, 8, 5, 16, device="cpu",
                          generator=torch.Generator().manual_seed(0))
    tr = Trainer(model, lr=0.01, seed=0, device="cpu")
    s = samplers.TemporalSampler(store, batch_size=32, max_seq_len=5, seed=0)
    for _ in range(20):
        tr.train_step(s.sample())
    res = tr.evaluate_temporal(
        samplers.TemporalEvaluationSampler(store, 16, 5), at=(10, 50))
    assert 0.0 <= res["AUC"] <= 1.0
    assert res["Recall"].shape == (2,)
    assert np.isfinite(res["NDCG"]).all()
