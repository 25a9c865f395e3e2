"""Port parity: the explicit-rating path (ItrMLP's data and evaluation).

The same numpy records go through the JAX package and the port:
`ExplicitSampler` plain and chronological, `Dataset.explicit` through one
prefetch worker (chronological=True forces it), `RegressionEvalSampler`
and `Dataset.regression_evaluation` give bit-identical batches for the
same seed; the per-record regression eval (`Trainer.evaluate` on
regression batches: MSE) of PMF and ItrMLP agrees with JAX's within
1e-6, with a padded last batch and under `defer_metrics`;
`Trainer.train(update_interval=)` equals the hand-rolled protocol and
JAX's; the chronological stream ends training where JAX's does; `MSE`.
The JAX package's own bars are mirrored (`tests/test_trainer_features.py:
37-100`, `tests/test_samplers.py:290-325`).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from openrec_tpu import Dataset as JDataset
from openrec_tpu.data import samplers as jsamplers
from openrec_tpu.data.store import InteractionStore as JStore
from openrec_tpu.metrics import MSE as JMSE
from openrec_tpu.models import ItrMLP as JItrMLP
from openrec_tpu.models import PMF as JPMF
from openrec_tpu.training import Trainer as JTrainer
from openrec_tpu_torch import convert, models
from openrec_tpu_torch.data import Dataset, InteractionStore, samplers
from openrec_tpu_torch.metrics import MSE
from openrec_tpu_torch.training import Trainer
from tests.conftest import make_interactions

torch.set_num_threads(1)

USERS, ITEMS = 30, 60
# the tables (entries of O(1)) after updates, against JAX: each update
# feeds the MLP's output back into it, and the port's fp64 run lies as
# far from JAX's fp32 run (4.7e-6 after three) as its fp32 run (2.8e-6)
TABLE_ATOL = 1e-5


def assert_itr_mlp_close(jmodel, jparams, model, steps, lr=1e-3):
    """ItrMLP's parameters against JAX's after `steps` Adam steps: rtol
    1e-5, atol 1e-6 (the tables atol `TABLE_ATOL`), but for the MLPs'
    biases `b`. A batch norm follows each, so its true gradient is 0 and
    both packages step it by Adam on rounding noise, each its own: those
    are held to |b| <= steps * lr, and the function they leave unchanged,
    the scores of a batch, to rtol = atol = 1e-5."""
    want = convert.flatten_tree(jax.tree.map(np.asarray, jparams))
    for key, value in model.params().items():
        got = value.detach().numpy()
        if "_mlp/" in key and key.endswith("/b"):
            assert np.abs(got).max() <= steps * lr
            assert np.abs(want[key]).max() <= steps * lr
            continue
        np.testing.assert_allclose(got, want[key], rtol=1e-5, atol=(
            TABLE_ATOL if key.endswith("_embed") else 1e-6), err_msg=key)
    users = np.arange(model.total_users, dtype=np.int32)
    with torch.no_grad():
        got = model.score({"user_id": torch.from_numpy(users)}).numpy()
    np.testing.assert_allclose(got, np.asarray(jmodel.score(
        jparams, {"user_id": users})), rtol=1e-5, atol=1e-5)


def _ratings(seed=0, users=USERS, items=ITEMS, per_user=6,
             label_field="label", dtype=np.float32):
    """Unique (user, item) records in a random order, with a rating in
    [0, 1] (the rating of `tests/test_trainer_features.py:26`)."""
    base = make_interactions(num_users=users, num_items=items,
                             per_user=per_user, seed=seed)
    data = np.zeros(len(base), dtype=[("user_id", np.int32),
                                      ("item_id", np.int32),
                                      (label_field, dtype)])
    data["user_id"], data["item_id"] = base["user_id"], base["item_id"]
    rng = np.random.default_rng(seed)
    data[label_field] = rng.uniform(0, 1, len(base))
    return data[rng.permutation(len(data))]


def _equal(a, b):
    assert sorted(a) == sorted(b)
    for k in a:
        assert np.asarray(a[k]).dtype == np.asarray(b[k]).dtype, k
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


# ---------------------------------------------------------------- samplers

@pytest.mark.parametrize("chronological", [False, True])
@pytest.mark.parametrize("seed,batch", [(0, 16), (5, 37), (2, 180)])
def test_explicit_sampler_bit_identical(seed, batch, chronological):
    """Epochs of shuffled records (over the epoch wrap), or the one
    chronological epoch in raw order up to its dropped partial batch."""
    data = _ratings(seed)
    mine = samplers.ExplicitSampler(InteractionStore(data, USERS, ITEMS),
                                    batch, seed=seed,
                                    chronological=chronological)
    ref = jsamplers.ExplicitSampler(JStore(data, USERS, ITEMS), batch,
                                    seed=seed, chronological=chronological)
    got, want = list(zip(range(25), mine)), list(zip(range(25), ref))
    assert len(got) == len(want) == (min(25, len(data) // batch)
                                     if chronological else 25)
    for (_, a), (_, b) in zip(got, want):
        _equal(a, b)
        assert a["label"].dtype == np.float32


@pytest.mark.parametrize("chronological", [False, True])
def test_explicit_sampler_reads_label_field_as_float32(chronological):
    data = _ratings(3, label_field="rating", dtype=np.float64)
    mine = samplers.ExplicitSampler(InteractionStore(data, USERS, ITEMS), 20,
                                    label_field="rating",
                                    chronological=chronological)
    ref = jsamplers.ExplicitSampler(JStore(data, USERS, ITEMS), 20,
                                    label_field="rating",
                                    chronological=chronological)
    for _ in range(4):
        a, b = mine.sample(), ref.sample()
        _equal(a, b)
        assert a["label"].dtype == np.float32
    if chronological:
        np.testing.assert_array_equal(
            a["label"], data["rating"][60:80].astype(np.float32))


def test_chronological_sampler_ends_and_rewinds():
    data = _ratings(1)
    s = samplers.ExplicitSampler(InteractionStore(data, USERS, ITEMS), 50,
                                 chronological=True)
    out = list(s)
    assert len(out) == len(data) // 50
    np.testing.assert_array_equal(np.concatenate([b["label"] for b in out]),
                                  data["label"][:len(out) * 50])
    with pytest.raises(samplers.EndOfData):
        s.sample()
    s.reset()
    _equal(s.sample(), out[0])
    clone = s.with_seed(9)
    _equal(clone.sample(), out[0])


@pytest.mark.parametrize("workers,chronological", [(1, False), (1, True),
                                                   (4, True)])
def test_dataset_explicit_bit_identical(workers, chronological):
    """One worker's stream (with_seed((seed, 0))), and chronological=True
    forcing one worker whatever is asked: finite, as JAX's."""
    data = _ratings(4)
    mine = Dataset(data, USERS, ITEMS, seed=3).explicit(
        24, num_parallel_calls=workers, chronological=chronological,
        take=None if chronological else 12)
    ref = JDataset(data, USERS, ITEMS, seed=3).explicit(
        24, num_parallel_calls=workers, chronological=chronological,
        take=None if chronological else 12)
    got, want = list(mine), list(ref)
    assert len(got) == len(want) == (len(data) // 24 if chronological
                                     else 12)
    for a, b in zip(got, want):
        _equal(a, b)


@pytest.mark.parametrize("batch", [16, 45, 180, 500])
def test_regression_eval_sampler_bit_identical(batch):
    """Every record once, in data order, zero-padded with `valid`; its
    len() the number of batches; through `Dataset.regression_evaluation`
    too."""
    data = _ratings(6)
    mine = samplers.RegressionEvalSampler(
        InteractionStore(data, USERS, ITEMS), batch)
    ref = jsamplers.RegressionEvalSampler(JStore(data, USERS, ITEMS), batch)
    got, want = list(mine), list(ref)
    assert len(mine) == len(ref) == len(got) == len(want) \
        == -(-len(data) // batch)
    for a, b in zip(got, want):
        _equal(a, b)
        assert a["user_id"].shape == (batch,)
    np.testing.assert_array_equal(
        np.concatenate([b["label"][b["valid"]] for b in got]),
        data["label"])
    assert int(sum(b["valid"].sum() for b in got)) == len(data)
    ds = Dataset(data, USERS, ITEMS).regression_evaluation(batch)
    for a, b in zip(ds, want):
        _equal(a, b)
    for a, b in zip(list(ds), want):          # a second pass, the same
        _equal(a, b)


def test_regression_eval_sampler_label_field():
    data = _ratings(7, label_field="rating", dtype=np.float64)
    ds = Dataset(data, USERS, ITEMS).regression_evaluation(
        64, label_field="rating")
    ref = JDataset(data, USERS, ITEMS).regression_evaluation(
        64, label_field="rating")
    for a, b in zip(ds, ref):
        _equal(a, b)


# ---------------------------------------------------------- the MSE eval

def test_mse_is_jax():
    rng = np.random.default_rng(0)
    pred, label = rng.normal(size=(2, 50)).astype(np.float32)
    got = MSE(torch.from_numpy(pred), torch.from_numpy(label)).numpy()
    np.testing.assert_array_equal(got, np.asarray(JMSE(pred, label)))
    np.testing.assert_array_equal(got, (pred - label) ** 2)


def _pmf(seed=0):
    jmodel = JPMF(total_users=USERS, total_items=ITEMS, dim_user_embed=8,
                  dim_item_embed=8)
    params = jax.tree.map(np.asarray, jmodel.init(jax.random.PRNGKey(seed)))
    params["item_bias"] = np.random.default_rng(seed).normal(
        scale=0.3, size=(ITEMS, 1)).astype(np.float32)
    model = models.PMF(USERS, ITEMS, 8, 8, device="cpu")
    model.load_params(convert.params_from_jax(params, device="cpu"))
    return jmodel, params, model


def _itr_mlp(seed=0):
    kw = dict(total_users=USERS, total_items=ITEMS, dim_embed=6,
              user_dims=(10, 6), item_dims=(10, 6))
    jmodel = JItrMLP(**kw)
    params = jax.tree.map(np.asarray, jmodel.init(jax.random.PRNGKey(seed)))
    rng = np.random.default_rng(seed + 50)
    for key in ("user_embed", "item_embed"):
        params[key] = params[key] * 30.0
    params["item_bias"] = rng.normal(scale=0.3, size=(ITEMS, 1)).astype(
        np.float32)
    model = models.ItrMLP(**kw, device="cpu")
    model.load_params(convert.params_from_jax(params, device="cpu"))
    return jmodel, params, model


MAKERS = {"PMF": _pmf, "ItrMLP": _itr_mlp}


@pytest.mark.parametrize("defer", [False, True])
@pytest.mark.parametrize("batch", [32, 50])
@pytest.mark.parametrize("name", list(MAKERS))
def test_regression_eval_matches_jax(name, batch, defer):
    """MSE over every record, the last batch padded with user 0 / item 0
    (which enter ItrMLP's user batch norm, as in JAX): within 1e-6 of
    JAX's and of a numpy oracle over the same padded score rows."""
    jmodel, params, model = MAKERS[name]()
    data = _ratings(8)
    assert len(data) % batch
    jt = JTrainer(jmodel, lr=0.01, seed=0)
    jt.params = jax.tree.map(jnp.asarray, params)
    want = float(jt.evaluate(jsamplers.RegressionEvalSampler(
        JStore(data, USERS, ITEMS), batch))["MSE"])
    tt = Trainer(model, lr=0.01, device="cpu")
    res = tt.evaluate(Dataset(data, USERS, ITEMS).regression_evaluation(
        batch), defer_metrics=defer)
    assert sorted(res) == ["MSE"]
    if defer:
        assert isinstance(res["MSE"], torch.Tensor)
    got = float(res["MSE"])
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    errs = []
    for b in samplers.RegressionEvalSampler(
            InteractionStore(data, USERS, ITEMS), batch):
        with torch.no_grad():
            rows = model.score({"user_id": torch.from_numpy(
                b["user_id"])}).numpy()
        pred = rows[np.arange(batch), b["item_id"]]
        errs.append(((pred - b["label"]) ** 2)[b["valid"]])
    np.testing.assert_allclose(got, np.concatenate(errs).mean(), rtol=1e-6)


def test_regression_eval_inside_train_loop():
    """tests/test_trainer_features.py:51 on the port: the interval eval
    reports a finite MSE."""
    data = _ratings(0)
    ds = Dataset(data, USERS, ITEMS, seed=0)
    tr = Trainer(models.PMF(USERS, ITEMS, 8, 8, device="cpu"), lr=0.01,
                 device="cpu")
    res = tr.train(total_iter=4, train_batches=ds.explicit(batch_size=16),
                   eval_samplers={"val": ds.regression_evaluation(32)},
                   eval_interval=2, verbose=False)
    assert "val" in res and np.isfinite(float(res["val"]["MSE"]))


# --------------------------------------------- train(update_interval=)

def test_update_interval_matches_manual_protocol():
    """tests/test_trainer_features.py:63 on the port: train(
    update_interval=3) equals 3 steps, update_embeddings, 3 steps, ... on
    the same chronological stream, and without it the frozen tables never
    move."""
    data = _ratings(3)
    kw = dict(total_users=USERS, total_items=ITEMS, dim_embed=8)

    def model():
        return models.ItrMLP(**kw, device="cpu",
                             generator=torch.Generator().manual_seed(0))

    def manual():
        m = model()
        tr = Trainer(m, lr=1e-3, device="cpu")
        it = iter(Dataset(data, USERS, ITEMS, seed=0).explicit(
            16, chronological=True))
        for i in range(1, 7):
            tr.train_step(next(it))
            if i % 3 == 0:
                m.update_embeddings()
        return m.params()

    def via_hook(update_interval=3):
        m = model()
        tr = Trainer(m, lr=1e-3, device="cpu")
        tr.train(total_iter=6, train_batches=Dataset(
            data, USERS, ITEMS, seed=0).explicit(16, chronological=True),
            update_interval=update_interval, verbose=False)
        return m.params()

    a, b = manual(), via_hook()
    for k in a:
        assert torch.equal(a[k], b[k]), k
    frozen = model().params()
    unchanged = via_hook(None)
    for k in ("user_embed", "item_embed"):
        assert torch.equal(unchanged[k], frozen[k])
        assert not torch.allclose(a[k], frozen[k])
    assert unchanged["user_flag"].sum() > 0 == a["user_flag"].sum()


@pytest.mark.parametrize("steps_per_call", [1, 2])
def test_update_interval_matches_jax_trainer(steps_per_call):
    """Both Trainers' train(update_interval=4) on the same chronological
    stream from the same weights: the parameters agree after 12 steps
    (`assert_itr_mlp_close`);
    with k steps a call the interval counts steps (i advances by k)."""
    jmodel, params, model = _itr_mlp(1)
    data = _ratings(2)
    jt = JTrainer(jmodel, lr=1e-3, seed=0)
    jt.params = jax.tree.map(jnp.asarray, params)
    jt.opt_state = jt.tx.init(jt.params)
    jt.train(total_iter=12, train_batches=JDataset(
        data, USERS, ITEMS, seed=0).explicit(15, chronological=True),
        update_interval=4, steps_per_call=steps_per_call, verbose=False)
    calls = []
    tt = Trainer(model, lr=1e-3, device="cpu")
    tt.train(total_iter=12, train_batches=Dataset(
        data, USERS, ITEMS, seed=0).explicit(15, chronological=True),
        update_interval=4, steps_per_call=steps_per_call, verbose=False,
        update_fn=lambda: (calls.append(tt.global_step),
                           model.update_embeddings()))
    assert calls == [4, 8, 12]
    assert_itr_mlp_close(jmodel, jt.params, model, steps=12)
    assert not tt.params["user_flag"].any()


def test_chronological_stream_ends_training(capsys):
    """The one chronological epoch ends Trainer.train with "train stream
    exhausted" at the step JAX's ends at, with the interval eval of the
    last full interval run."""
    data = _ratings(5)
    n = len(data) // 40
    jt = JTrainer(JPMF(total_users=USERS, total_items=ITEMS,
                       dim_user_embed=4, dim_item_embed=4), lr=0.01, seed=0)
    jt.train(total_iter=10 * n, train_batches=JDataset(
        data, USERS, ITEMS).explicit(40, chronological=True))
    tt = Trainer(models.PMF(USERS, ITEMS, 4, 4, device="cpu"), lr=0.01,
                 device="cpu")
    res = tt.train(total_iter=10 * n, train_batches=Dataset(
        data, USERS, ITEMS).explicit(40, chronological=True),
        eval_samplers={"val": Dataset(data, USERS, ITEMS)
                       .regression_evaluation(64)}, eval_interval=2)
    out = capsys.readouterr().out
    assert tt.global_step == jt.global_step == n
    assert f"train stream exhausted at iter {n}" in out
    assert np.isfinite(float(res["val"]["MSE"]))
