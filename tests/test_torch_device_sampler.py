"""Port properties of the on-device sampler (run here on CPU tensors).

The port draws from a torch.Generator (Philox on the card), not JAX's
threefry, so its batches cannot equal the JAX package's. What is held:
`is_positive` answers exactly as the JAX index does on the same queries,
in both membership modes; a negative is a positive only when every one of
its 1 + reject_rounds draws was (checked draw by draw on a dense store);
record picks are uniform (chi-square); and the fused device loop trains.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from openrec_tpu.data.device_sampler import _MembershipIndex as JIndex
from openrec_tpu.data.store import InteractionStore as JStore
from openrec_tpu_torch.data import DevicePairwiseSampler, InteractionStore
from openrec_tpu_torch.data.device_sampler import _MembershipIndex
from openrec_tpu_torch.models import BPR
from openrec_tpu_torch.training import Trainer
from tests.conftest import make_interactions, make_low_rank

torch.set_num_threads(1)


def _dense_store(cls, users=30, items=12, seed=0):
    """Each user holds about half the catalog: rejection often fails."""
    rng = np.random.default_rng(seed)
    rows = [(u, i) for u in range(users) for i in range(items)
            if rng.random() < 0.5]
    data = np.array(rows, dtype=[("user_id", np.int32),
                                 ("item_id", np.int32)])
    return cls(data, users, items, seed=0)


@pytest.mark.parametrize("membership", ["bitmap", "searchsorted"])
def test_is_positive_matches_jax(membership):
    data = make_interactions()
    jidx = JIndex(JStore(data, 40, 100, seed=0), membership)
    tidx = _MembershipIndex(InteractionStore(data, 40, 100, seed=0),
                            membership, device="cpu")
    assert tidx.membership == jidx.membership == membership
    u, i = np.meshgrid(np.arange(40), np.arange(100), indexing="ij")
    u, i = u.ravel().astype(np.int32), i.ravel().astype(np.int32)
    want = np.asarray(jidx.is_positive(jnp.asarray(u), jnp.asarray(i)))
    got = tidx.is_positive(torch.from_numpy(u), torch.from_numpy(i))
    np.testing.assert_array_equal(got.numpy(), want)
    assert want.sum() == len(data)


def test_auto_membership_follows_the_bitmap_limit():
    store = InteractionStore(make_interactions(), 40, 100, seed=0)
    assert _MembershipIndex(store, device="cpu").membership == "bitmap"
    assert _MembershipIndex(store, bitmap_limit_bytes=10,
                            device="cpu").membership == "searchsorted"


@pytest.mark.parametrize("membership", ["bitmap", "searchsorted"])
def test_negatives_follow_the_rejection_rounds(membership):
    store = _dense_store(InteractionStore)
    s = DevicePairwiseSampler(store, batch_size=64, membership=membership,
                              device="cpu")
    k, R = 50, s.reject_rounds
    batch = s.sample_stacked(torch.Generator().manual_seed(7), k)
    # replay the same draws: record picks, then all rounds' negatives
    g = torch.Generator().manual_seed(7)
    idx = torch.randint(0, s.num_records, (k, 64), generator=g,
                        dtype=torch.int32).numpy()
    draws = torch.randint(0, 12, (R + 1, k, 64), generator=g,
                          dtype=torch.int32).numpy()
    users = store._pos_users[idx]
    np.testing.assert_array_equal(batch["user_id"].numpy(), users)
    np.testing.assert_array_equal(batch["p_item_id"].numpy(),
                                  store._pos_items[idx])
    assert store.is_positive(users, batch["p_item_id"].numpy()).all()
    pos = np.stack([store.is_positive(users, d) for d in draws])
    # the first draw that is not a positive, else the last round's draw
    first_ok = np.where(pos[:R].all(axis=0), R, np.argmin(pos[:R], axis=0))
    want = np.take_along_axis(draws, first_ok[None], axis=0)[0]
    neg = batch["n_item_id"].numpy()
    np.testing.assert_array_equal(neg, want)
    bad = store.is_positive(users, neg)
    np.testing.assert_array_equal(bad, pos.all(axis=0))
    # the share of negatives that are positives: about density^(R+1)
    density = len(store._pos_keys) / (30 * 12)
    assert bad.mean() <= 3 * density ** (R + 1)
    assert batch["n_item_id"].dtype == torch.int32


def test_record_picks_are_uniform():
    store = InteractionStore(make_interactions(), 40, 100, seed=0)
    s = DevicePairwiseSampler(store, batch_size=1000, device="cpu")
    batch = s.sample_stacked(torch.Generator().manual_seed(3), 64)
    keys = (batch["user_id"].long() * 100 + batch["p_item_id"].long())
    counts = np.bincount(np.searchsorted(store._pos_keys, keys.numpy()
                                         .ravel()), minlength=320)
    n, cells = keys.numel(), len(store._pos_keys)
    expected = n / cells
    chi2 = ((counts - expected) ** 2 / expected).sum()
    df = cells - 1
    assert chi2 < df + 6 * np.sqrt(2 * df), chi2      # p < 1e-6 to fail
    one = s.sample(torch.Generator().manual_seed(3))
    assert tuple(one["user_id"].shape) == (1000,)


def test_device_loop_learns_low_rank():
    train, test = make_low_rank()
    store = InteractionStore(train, 64, 256, seed=0)
    model = BPR(64, 256, 16, 16, l2_weight=1e-4, device="cpu",
                generator=torch.Generator().manual_seed(0))
    tr = Trainer(model, lr=0.05, seed=0, device="cpu")
    s = DevicePairwiseSampler(store, batch_size=512, device="cpu")
    first = tr.train_steps_device(s, 20)
    for _ in range(4):
        last = tr.train_steps_device(s, 50)
    assert tr.global_step == 220
    assert torch.isfinite(last).all() and last.mean() < first.mean()
    fused = tr.train_steps_device(s, 5, fused=True)
    assert fused.shape == (5,) and tr.global_step == 225
    from openrec_tpu_torch.data import EvaluationSampler
    ev = EvaluationSampler(InteractionStore(test, 64, 256, seed=0), 32,
                           excl_stores=[store])
    assert tr.evaluate(ev, at=(50,))["AUC"] > 0.8
