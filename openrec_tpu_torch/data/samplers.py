"""Seeded, vectorized host batch samplers.

Counterpart of `openrec_tpu/data/samplers.py:34-341, 458-591`: the base
`BatchSampler` with its per-sampler epoch stream, `PairwiseSampler`
(user, positive, uniform negative), the pointwise samplers
(`StratifiedPointwiseSampler`, `PerPosStratifiedPointwiseSampler`,
`RandomPointwiseSampler`: user, item, 0/1 label) and the full-catalog
`EvaluationSampler` (mask batches, or -1-padded id lists with
`device_masks=True`), and `NPairwiseSampler` (user, positive, K
negatives: `samplers.py:225-238`). The same seed gives bit-identical batches to the
JAX package on every path, the numpy paths (`use_native=False`) and the
C++ feeder (`openrec_tpu_torch/native/`, the default of `PairwiseSampler`
and `StratifiedPointwiseSampler` whenever it builds, as in the JAX
package). The explicit, temporal and feature-joined samplers come with
the models that use them.

Batches are dicts of fixed-shape numpy arrays; `pipeline.to_device` moves
them onto the card.
"""

from __future__ import annotations

import numpy as np

from openrec_tpu_torch import native
from openrec_tpu_torch.data.store import InteractionStore


class EndOfData(Exception):
    """Raised by chronological samplers when the single sequential epoch is
    exhausted; turns the sampler into a finite iterator."""


class BatchSampler:
    """Base: infinite iterator of dict-of-ndarray batches.

    Each sampler owns its epoch-shuffled record stream (seeded by its own
    rng): prefetch workers cloned via with_seed draw independent streams
    and share no mutable state.

    chronological=True streams records in raw-data order, no shuffling,
    ONE pass, and drops the final partial batch; the iterator is then
    finite.
    """

    def __init__(self, store: InteractionStore, batch_size: int, seed=0,
                 chronological: bool = False):
        self.store = store
        self.batch_size = int(batch_size)
        self.seed = seed
        self.rng = np.random.default_rng(seed)
        self.chronological = bool(chronological)
        self._chrono_pos = 0
        self._perm = np.empty(0, dtype=np.int64)
        self._perm_pos = 0

    def _next_record_indices(self, n: int) -> np.ndarray:
        """Per-sampler epoch stream (every record once per epoch)."""
        n_rec = self.store.total_records()
        if self.chronological:
            if self._chrono_pos + n > n_rec:
                raise EndOfData
            out = np.arange(self._chrono_pos, self._chrono_pos + n,
                            dtype=np.int64)
            self._chrono_pos += n
            return out
        out = np.empty(n, dtype=np.int64)
        filled = 0
        while filled < n:
            if self._perm_pos >= len(self._perm):
                self._perm = self.rng.permutation(n_rec)
                self._perm_pos = 0
            take = min(n - filled, len(self._perm) - self._perm_pos)
            out[filled:filled + take] = \
                self._perm[self._perm_pos:self._perm_pos + take]
            self._perm_pos += take
            filled += take
        return out

    def _next_records(self, n: int) -> np.ndarray:
        return self.store.raw_data[self._next_record_indices(n)]

    def sample(self) -> dict:
        raise NotImplementedError

    def reset(self):
        """Rewind a chronological sampler to the start of its epoch."""
        self._chrono_pos = 0

    def __iter__(self):
        while True:
            try:
                batch = self.sample()
            except EndOfData:
                return
            yield batch

    def _init_native(self, use_native):
        """use_native None takes the C++ feeder when the library is
        available (`native.available()`) and the store has no pre-sampled
        negatives; True asks for the feeder and raises when it cannot be
        built; False takes numpy. The feeder reads the store's records as
        int32 arrays and a hash table of its positive keys."""
        if use_native is None:
            use_native = (native.available()
                          and not self.store.contain_negatives())
        self.use_native = bool(use_native)
        if self.use_native:
            self._rec_users = np.ascontiguousarray(
                self.store._pos_users, dtype=np.int32)
            self._rec_items = np.ascontiguousarray(
                self.store._pos_items, dtype=np.int32)
            self._hash_table = native.build_hash_table(self.store._pos_keys)

    def with_seed(self, seed):
        """Fresh sampler with a different seed (used per prefetch worker)."""
        clone = type(self).__new__(type(self))
        clone.__dict__.update(self.__dict__)
        clone.seed = seed
        clone.rng = np.random.default_rng(seed)
        clone._chrono_pos = 0
        clone._perm = np.empty(0, dtype=np.int64)
        clone._perm_pos = 0
        return clone


class PairwiseSampler(BatchSampler):
    """(user, positive, uniform-negative) triplets.

    use_native: see `BatchSampler._init_native` (None, the default, takes
    the C++ feeder wherever it builds).

    The native non-chronological path applies the epoch permutation to a
    private copy of the record arrays (one C++ Fisher-Yates per epoch,
    sampler.cpp `shuffle_pairs`), so each batch is a sequential window,
    and draws negatives with the block-prefetched rejection kernel
    (`pairwise_negatives_seq`). Every record comes once per epoch, as on
    the numpy path, in another (still uniform) order. Each call's seed is
    drawn from the sampler's numpy rng.
    """

    def __init__(self, store, batch_size, seed=0, use_native=None,
                 chronological=False):
        super().__init__(store, batch_size, seed,
                         chronological=chronological)
        self._init_native(use_native)
        if self.use_native:
            self._seq_pos = None      # shuffled at the first sample

    def _reshuffle(self):
        if self._seq_pos is None:
            # private copies: the epoch shuffle works in place, and the
            # arrays may be shared with the store or sibling workers
            self._rec_users = self._rec_users.copy()
            self._rec_items = self._rec_items.copy()
        native.shuffle_pairs(self._rec_users, self._rec_items,
                             int(self.rng.integers(0, 2 ** 63)))
        self._seq_pos = 0

    def _next_window(self, b):
        """Sequential [b] window over the epoch-shuffled record copies, as
        fresh arrays (the copies are reshuffled at the epoch wrap while a
        consumer may still hold the batch)."""
        n_rec = len(self._rec_users)
        if self._seq_pos is None:
            self._reshuffle()
        u = np.empty(b, np.int32)
        p = np.empty(b, np.int32)
        filled = 0
        while filled < b:
            if self._seq_pos >= n_rec:
                self._reshuffle()
            take = min(b - filled, n_rec - self._seq_pos)
            u[filled:filled + take] = \
                self._rec_users[self._seq_pos:self._seq_pos + take]
            p[filled:filled + take] = \
                self._rec_items[self._seq_pos:self._seq_pos + take]
            self._seq_pos += take
            filled += take
        return u, p

    def sample(self):
        if self.use_native:
            seed = int(self.rng.integers(0, 2 ** 63))
            if self.chronological:
                idx = self._next_record_indices(self.batch_size)
                u, p, n = native.pairwise_batch_hash(
                    self._hash_table, self._rec_users, self._rec_items,
                    idx, self.store.total_items(), seed)
                return {"user_id": u, "p_item_id": p, "n_item_id": n}
            u, p = self._next_window(self.batch_size)
            n = native.pairwise_negatives_seq(
                self._hash_table, u, self.store.total_items(), seed)
            return {"user_id": u, "p_item_id": p, "n_item_id": n}
        rec = self._next_records(self.batch_size)
        user_id = np.asarray(rec["user_id"], dtype=np.int32)
        p_item_id = np.asarray(rec["item_id"], dtype=np.int32)
        n_item_id = self.store.sample_negative_items(
            user_id, rng=self.rng).astype(np.int32)
        return {"user_id": user_id, "p_item_id": p_item_id,
                "n_item_id": n_item_id}

    def with_seed(self, seed):
        clone = super().with_seed(seed)
        if clone.use_native and not clone.chronological:
            # copy from the store's arrays, not the parent's: the parent may
            # be mid-epoch, and its private copy is reshuffled in place
            clone._rec_users = np.ascontiguousarray(
                clone.store._pos_users, dtype=np.int32)
            clone._rec_items = np.ascontiguousarray(
                clone.store._pos_items, dtype=np.int32)
            clone._seq_pos = None     # fresh private copy + shuffle
        return clone


class NPairwiseSampler(BatchSampler):
    """(user, positive, K uniform negatives) from the epoch stream; numpy
    only, as in the JAX package (`samplers.py:225-238`)."""

    def __init__(self, store, batch_size, num_negatives, seed=0):
        super().__init__(store, batch_size, seed)
        self.num_negatives = int(num_negatives)

    def sample(self):
        rec = self._next_records(self.batch_size)
        user_id = np.asarray(rec["user_id"], dtype=np.int32)
        p_item_id = np.asarray(rec["item_id"], dtype=np.int32)
        n_item_id = self.store.sample_negative_items_multi(
            user_id, self.num_negatives, rng=self.rng).astype(np.int32)
        return {"user_id": user_id, "p_item_id": p_item_id,
                "n_item_id": n_item_id}


class StratifiedPointwiseSampler(BatchSampler):
    """int(batch_size * pos_ratio) positives from the record stream, then
    uniform (user, item) negatives rejected against the positives; labels
    1 then 0. use_native as `PairwiseSampler`'s: the C++ feeder builds the
    whole batch in one pass (`native.stratified_pointwise_batch_hash`,
    seeded from the sampler's rng AFTER the batch's record indices are
    drawn), numpy resamples the negatives that hit a positive until none
    does."""

    def __init__(self, store, batch_size, pos_ratio=0.5, seed=0,
                 use_native=None, chronological=False):
        super().__init__(store, batch_size, seed,
                         chronological=chronological)
        self.pos_ratio = float(pos_ratio)
        self._init_native(use_native)

    def sample(self):
        n_pos = int(self.batch_size * self.pos_ratio)
        n_neg = self.batch_size - n_pos
        if self.use_native:
            idx = self._next_record_indices(n_pos)
            seed = int(self.rng.integers(0, 2 ** 63))
            u, i, l = native.stratified_pointwise_batch_hash(
                self._hash_table, self._rec_users, self._rec_items, idx,
                n_neg, self.store.total_users(), self.store.total_items(),
                seed)
            return {"user_id": u, "item_id": i, "label": l}
        rec = self._next_records(n_pos)
        users = np.empty(self.batch_size, dtype=np.int32)
        items = np.empty(self.batch_size, dtype=np.int32)
        labels = np.zeros(self.batch_size, dtype=np.float32)
        users[:n_pos] = rec["user_id"]
        items[:n_pos] = rec["item_id"]
        labels[:n_pos] = 1.0
        nu = self.rng.integers(0, self.store.total_users(), size=n_neg)
        ni = self.rng.integers(0, self.store.total_items(), size=n_neg)
        bad = self.store.is_positive(nu, ni)
        while bad.any():
            k = int(bad.sum())
            nu[bad] = self.rng.integers(0, self.store.total_users(), size=k)
            ni[bad] = self.rng.integers(0, self.store.total_items(), size=k)
            bad = self.store.is_positive(nu, ni)
        users[n_pos:] = nu
        items[n_pos:] = ni
        return {"user_id": users, "item_id": items, "label": labels}


class PerPosStratifiedPointwiseSampler(BatchSampler):
    """Each positive followed by int((1 - r)/r) uniform negatives for the
    same user, cut to batch_size. A negative is only kept apart from its
    own positive, not from the user's other positives (the reference's
    rule, tf2 dataset.py:36-58)."""

    def __init__(self, store, batch_size, pos_ratio=0.5, seed=0):
        super().__init__(store, batch_size, seed)
        self.pos_ratio = float(pos_ratio)
        self.k_neg = int((1 - self.pos_ratio) / self.pos_ratio)

    def sample(self):
        group = 1 + self.k_neg
        n_groups = -(-self.batch_size // group)
        rec = self._next_records(n_groups)
        gu = np.asarray(rec["user_id"], dtype=np.int64)
        gp = np.asarray(rec["item_id"], dtype=np.int64)
        neg = self.rng.integers(0, self.store.total_items(),
                                size=(n_groups, self.k_neg))
        clash = neg == gp[:, None]
        while clash.any():
            neg[clash] = self.rng.integers(0, self.store.total_items(),
                                           size=int(clash.sum()))
            clash = neg == gp[:, None]
        users = np.repeat(gu, group)
        items = np.concatenate([gp[:, None], neg], axis=1).reshape(-1)
        labels = np.zeros(n_groups * group, dtype=np.float32)
        labels[::group] = 1.0
        sl = slice(0, self.batch_size)
        return {"user_id": users[sl].astype(np.int32),
                "item_id": items[sl].astype(np.int32),
                "label": labels[sl]}


class RandomPointwiseSampler(BatchSampler):
    """Uniform (user, item) pairs; label = observed membership."""

    def sample(self):
        users = self.rng.integers(0, self.store.total_users(),
                                  size=self.batch_size)
        items = self.rng.integers(0, self.store.total_items(),
                                  size=self.batch_size)
        labels = self.store.is_positive(users, items).astype(np.float32)
        return {"user_id": users.astype(np.int32),
                "item_id": items.astype(np.int32), "label": labels}


class EvaluationSampler:
    """Full-catalog evaluation batches: per warm user a row of predictions is
    scored against pos_mask/excl_mask over the whole catalog. Finite
    iterator (one epoch).

    When the store has explicit/pre-sampled negatives, items outside
    pos∪neg are excluded (the reference's sampled-negative evaluation).

    device_masks=True emits padded id lists (pos_ids/excl_ids, -1 padded)
    instead of [B, total_items] bool masks; the trainer scatters them into
    masks on the card. Only for implicit stores without pre-sampled
    negatives (otherwise excl = complement-of-negatives is dense).
    """

    def __init__(self, store: InteractionStore, batch_size: int,
                 excl_stores=(), pad_to_batch=True, device_masks=False):
        self.store = store
        self.batch_size = int(batch_size)
        self.excl_stores = list(excl_stores)
        self.pad_to_batch = pad_to_batch
        self.eval_users = store.warm_users()
        self.device_masks = bool(device_masks)
        if self.device_masks:
            if store.contain_negatives():
                raise ValueError("device_masks requires an implicit store "
                                 "without pre-sampled negatives")
            self._pos_pad = int(store.user_positive_counts().max())
            # Exclusion ids of ALL excl stores are concatenated per user,
            # so the pad width is the max over users of the summed counts.
            if self.excl_stores:
                n_users = max(len(ex.user_positive_counts())
                              for ex in self.excl_stores)
                total = np.zeros(n_users, dtype=np.int64)
                for ex in self.excl_stores:
                    c = ex.user_positive_counts()
                    total[:len(c)] += c
                self._excl_pad = max(1, int(total.max()))
            else:
                self._excl_pad = 1

    def __len__(self):
        return -(-len(self.eval_users) // self.batch_size)

    def _masks(self, users):
        I = self.store.total_items()
        B = len(users)
        pos = np.zeros((B, I), dtype=bool)
        ptr, items = self.store.positive_csr()
        row = np.repeat(np.arange(B), (ptr[users + 1] - ptr[users]))
        col = np.concatenate([items[ptr[u]:ptr[u + 1]] for u in users]) \
            if B else np.empty(0, np.int64)
        pos[row, col] = True

        if self.store.contain_negatives():
            excl = np.ones((B, I), dtype=bool)
            excl[pos] = False
            nptr, nitems = self.store.negative_csr()
            nrow = np.repeat(np.arange(B), (nptr[users + 1] - nptr[users]))
            ncol = np.concatenate(
                [nitems[nptr[u]:nptr[u + 1]] for u in users]) \
                if B else np.empty(0, np.int64)
            excl[nrow, ncol] = False
        else:
            excl = np.zeros((B, I), dtype=bool)

        for ex in self.excl_stores:
            eptr, eitems = ex.positive_csr()
            erow = np.repeat(np.arange(B), (eptr[users + 1] - eptr[users]))
            ecol = np.concatenate(
                [eitems[eptr[u]:eptr[u + 1]] for u in users]) \
                if B else np.empty(0, np.int64)
            excl[erow, ecol] = True
        return pos, excl

    def _padded_ids(self, users):
        B = len(users)
        pos_ids = np.full((B, self._pos_pad), -1, dtype=np.int32)
        ptr, items = self.store.positive_csr()
        for r, u in enumerate(users):
            row = items[ptr[u]:ptr[u + 1]]
            pos_ids[r, :len(row)] = row
        excl_ids = np.full((B, self._excl_pad), -1, dtype=np.int32)
        # each store appends at the running per-row offset, so several
        # excl stores concatenate instead of overwriting each other
        offs = np.zeros(B, dtype=np.int64)
        for ex in self.excl_stores:
            eptr, eitems = ex.positive_csr()
            for r, u in enumerate(users):
                if u + 1 >= len(eptr):
                    continue
                row = eitems[eptr[u]:eptr[u + 1]]
                excl_ids[r, offs[r]:offs[r] + len(row)] = row
                offs[r] += len(row)
        return pos_ids, excl_ids

    def __iter__(self):
        bs = self.batch_size
        for i in range(0, len(self.eval_users), bs):
            users = self.eval_users[i:i + bs]
            valid = np.ones(len(users), dtype=bool)
            pad = bs - len(users) if self.pad_to_batch else 0
            if self.device_masks:
                pos_ids, excl_ids = self._padded_ids(users)
                if pad:
                    users = np.pad(users, (0, pad))
                    # padded rows: no positives, exclude nothing; dropped
                    # from aggregation via `valid`
                    pos_ids = np.pad(pos_ids, ((0, pad), (0, 0)),
                                     constant_values=-1)
                    excl_ids = np.pad(excl_ids, ((0, pad), (0, 0)),
                                      constant_values=-1)
                    valid = np.pad(valid, (0, pad))
                yield {"user_id": users.astype(np.int32),
                       "pos_ids": pos_ids, "excl_ids": excl_ids,
                       "valid": valid}
                continue
            pos, excl = self._masks(users)
            if pad:
                users = np.pad(users, (0, pad))
                pos = np.pad(pos, ((0, pad), (0, 0)))
                # padded rows: everything excluded, no positives; `valid`
                # drops them from metric aggregation
                excl = np.pad(excl, ((0, pad), (0, 0)),
                              constant_values=True)
                valid = np.pad(valid, (0, pad))
            yield {"user_id": users.astype(np.int32), "pos_mask": pos,
                   "excl_mask": excl, "valid": valid}
