"""On-device batch sampling.

Counterpart of `openrec_tpu/data/device_sampler.py:30-256`: the
interaction index lives in device memory (a bit array, or the sorted
composite keys, plus the flat record arrays; for sequences the users'
time-sorted CSR) and batches are drawn on the card, so the host sends
nothing per step:

  - positive picks: uniform records (with replacement);
  - negatives: uniform over the catalog (`DevicePairwiseSampler`: items
    for the record's user; `DevicePointwiseSampler`: (user, item) pairs)
    with `REJECT_ROUNDS` fixed resampling rounds against the membership
    index. The residual chance that a negative is a positive is
    density^(rounds+1): below 1e-13 at CiteULike's density (~2e-3) and 4
    rounds;
  - sequence windows (`DeviceTemporalSampler`): a warm user, a uniform
    position in [1, count - 1] and the zero-padded window before it.

Random numbers come from a `torch.Generator` on the sampler's device
(Philox on the card), not JAX's threefry: the streams differ from the
JAX package's, the distributions are the same.
"""

from __future__ import annotations

import numpy as np
import torch

from openrec_tpu_torch.device import resolve_device

REJECT_ROUNDS = 4


class _MembershipIndex:
    """On-device (user, item) in positives test.

    membership:
      'bitmap'      - a U*I bit array in device memory; one gather + bit
                      test per query (used automatically when the bitmap
                      is <= `bitmap_limit_bytes`).
      'searchsorted'- binary search over the sorted key array (any scale).
    Keys are int32 whenever U*I < 2**31 (CiteULike: 94 M pairs, an
    11.8 MB bitmap), else int64. The bitmap is built on the host with
    numpy, as 32-bit words, and copied once; the words are stored as
    int32 (torch's uint32 shifts are thin on CUDA) and a bit is read as
    (w >> s) & 1, which an arithmetic shift gets right too.
    """

    def __init__(self, store, membership: str = "auto",
                 bitmap_limit_bytes: int = 64 * 1024 * 1024, device=None):
        dev = resolve_device(device)
        self.total_items = store.total_items()
        n_pairs = store.total_users() * store.total_items()
        if membership == "auto":
            membership = ("bitmap" if n_pairs // 8 <= bitmap_limit_bytes
                          else "searchsorted")
        if membership not in ("bitmap", "searchsorted"):
            raise ValueError(f"unknown membership {membership!r}")
        self.membership = membership
        self._key_dtype = torch.int32 if n_pairs < 2 ** 31 else torch.int64
        if membership == "bitmap":
            nwords = (n_pairs + 31) // 32
            words = np.zeros(nwords, dtype=np.uint32)
            keys = store._pos_keys
            np.bitwise_or.at(words, keys >> 5,
                             np.uint32(1) << (keys & 31).astype(np.uint32))
            self._bitmap = torch.from_numpy(words.view(np.int32)).to(dev)
        else:
            self._pos_keys = torch.from_numpy(store._pos_keys).to(
                device=dev, dtype=self._key_dtype)

    def is_positive(self, users, items):
        keys = users.to(self._key_dtype) * self.total_items \
            + items.to(self._key_dtype)
        if self.membership == "bitmap":
            words = self._bitmap[keys >> 5]
            return ((words >> (keys & 31).to(torch.int32)) & 1) != 0
        n = self._pos_keys.shape[0]
        if n == 0:
            return torch.zeros_like(keys, dtype=torch.bool)
        idx = torch.searchsorted(self._pos_keys, keys).clamp_(0, n - 1)
        return self._pos_keys[idx] == keys


class _DeviceSampler:
    """The membership index and the record arrays on the device, shared
    by the samplers below. `generator` arguments are `torch.Generator`s on
    the sampler's device; batches are tensors on that device."""

    def __init__(self, store, batch_size: int, membership: str = "auto",
                 bitmap_limit_bytes: int = 64 * 1024 * 1024,
                 reject_rounds: int = REJECT_ROUNDS, device=None):
        self.device = resolve_device(device)
        self.reject_rounds = int(reject_rounds)
        self.batch_size = int(batch_size)
        self.total_users = store.total_users()
        self.total_items = store.total_items()
        self._index = _MembershipIndex(store, membership,
                                       bitmap_limit_bytes, self.device)
        self.membership = self._index.membership
        self._rec_users = torch.from_numpy(np.asarray(
            store._pos_users, dtype=np.int32)).to(self.device)
        self._rec_items = torch.from_numpy(np.asarray(
            store._pos_items, dtype=np.int32)).to(self.device)
        self.num_records = int(self._rec_users.shape[0])

    def is_positive(self, users, items):
        return self._index.is_positive(users, items)

    def _randint(self, high, shape, generator):
        return torch.randint(0, high, shape, generator=generator,
                             device=self.device, dtype=torch.int32)


class DevicePairwiseSampler(_DeviceSampler):
    """On-device (user, pos, neg) triplet sampler over a static index.

    `sample(generator)` draws one [B] batch; `sample_stacked(generator, k)`
    draws k batches as [k, B] in three batched draws (records, all the
    rounds' negatives), the form `Trainer.train_steps_device` feeds to
    its K-step loop. Batches are int32.
    """

    def _draw(self, shape, generator):
        idx = self._randint(self.num_records, shape, generator)
        users = self._rec_users[idx]
        pos = self._rec_items[idx]
        draws = self._randint(self.total_items,
                              (self.reject_rounds + 1, *shape), generator)
        neg = draws[0]
        for round_i in range(1, self.reject_rounds + 1):
            bad = self.is_positive(users, neg)
            neg = torch.where(bad, draws[round_i], neg)
        return {"user_id": users, "p_item_id": pos, "n_item_id": neg}

    def sample(self, generator):
        """One batch: dict of [B] tensors."""
        return self._draw((self.batch_size,), generator)

    def sample_stacked(self, generator, k: int):
        """k batches at once: dict of [k, B] tensors; same per-batch
        semantics as k `sample` calls (another stream)."""
        return self._draw((int(k), self.batch_size), generator)


class DevicePointwiseSampler(_DeviceSampler):
    """On-device stratified pointwise batches: n_pos = int(B * pos_ratio)
    uniform records (label 1), then B - n_pos uniform (user, item) pairs
    (label 0), each resampled, user and item both, in every one of the
    fixed rejection rounds where it is a positive. `sample(generator)`
    draws in the order records [n_pos], users [rounds + 1, B - n_pos],
    items [rounds + 1, B - n_pos]. Like the JAX package's sampler it has
    no `sample_stacked`: `Trainer.train_steps_device` samples each step's
    batch inside its K-step loop."""

    def __init__(self, store, batch_size: int, pos_ratio: float = 0.5,
                 membership: str = "auto",
                 bitmap_limit_bytes: int = 64 * 1024 * 1024,
                 reject_rounds: int = REJECT_ROUNDS, device=None):
        super().__init__(store, batch_size, membership, bitmap_limit_bytes,
                         reject_rounds, device)
        self.n_pos = int(batch_size * pos_ratio)

    def sample(self, generator):
        """One batch: user_id, item_id (int32) and label (float32), [B]."""
        B, P, R = self.batch_size, self.n_pos, self.reject_rounds
        idx = self._randint(self.num_records, (P,), generator)
        users = self._randint(self.total_users, (R + 1, B - P), generator)
        items = self._randint(self.total_items, (R + 1, B - P), generator)
        nu, ni = users[0], items[0]
        for round_i in range(1, R + 1):
            bad = self.is_positive(nu, ni)
            nu = torch.where(bad, users[round_i], nu)
            ni = torch.where(bad, items[round_i], ni)
        labels = torch.zeros(B, device=self.device)
        labels[:P] = 1.0
        return {"user_id": torch.cat([self._rec_users[idx], nu]),
                "item_id": torch.cat([self._rec_items[idx], ni]),
                "label": labels}


class DeviceTemporalSampler:
    """On-device sequence windows: the host `TemporalSampler`'s semantics
    (`samplers.py`) with the time-sorted CSR (pointers, counts, items) in
    device memory. `sample(generator)` draws the users [B], then the
    positions as 1 + randint(0, 2^31 - 1) % (count - 1) (the host draws
    its integer below 2^62; the bias of either is O(count / 2^31)), and
    gathers the left-aligned window of up to max_seq_len items before the
    position, zero-padded, and the item at it as the label. Int32
    tensors; no `sample_stacked`, so `Trainer.train_steps_device` draws
    each step's batch inside its K-step loop."""

    def __init__(self, store, batch_size: int, max_seq_len: int,
                 device=None):
        self.device = resolve_device(device)
        self.batch_size = int(batch_size)
        self.max_seq_len = int(max_seq_len)
        counts = store.user_positive_counts()
        seq_users = np.flatnonzero(counts > 1)
        if len(seq_users) == 0:
            raise ValueError("No user has more than one interaction.")
        ptr, _ = store.positive_csr()
        items = (store._csr_items_sorted
                 if store._csr_items_sorted is not None
                 else store._csr_items)

        def put(a):
            return torch.from_numpy(np.asarray(a, dtype=np.int32)).to(
                self.device)
        self._seq_users, self._counts = put(seq_users), put(counts)
        self._ptr, self._items = put(ptr), put(items)
        self._offs = torch.arange(self.max_seq_len, dtype=torch.int32,
                                  device=self.device)

    def sample(self, generator):
        """One batch: seq_item_id [B, L], seq_len, label, user_id [B]."""
        B = self.batch_size
        pick = torch.randint(0, self._seq_users.shape[0], (B,),
                             generator=generator, device=self.device)
        users = self._seq_users[pick]
        cnt = self._counts[users]
        draw = torch.randint(0, 2 ** 31 - 1, (B,), generator=generator,
                             device=self.device, dtype=torch.int32)
        predict_pos = 1 + draw % (cnt - 1)
        lo = self._ptr[users]
        seq_len = torch.clamp(predict_pos, max=self.max_seq_len)
        start = predict_pos - seq_len
        idx = lo[:, None] + start[:, None] + self._offs[None, :]
        valid = self._offs[None, :] < seq_len[:, None]
        idx = torch.where(valid, idx, lo[:, None])     # a safe gather index
        seq = torch.where(valid, self._items[idx], 0)
        return {"seq_item_id": seq, "seq_len": seq_len,
                "label": self._items[lo + predict_pos], "user_id": users}
