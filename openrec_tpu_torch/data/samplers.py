"""Seeded, vectorized host batch samplers.

Counterpart of `openrec_tpu/data/samplers.py:34-223, 458-591`: the base
`BatchSampler` with its per-sampler epoch stream, `PairwiseSampler`
(user, positive, uniform negative) and the full-catalog
`EvaluationSampler` (mask batches, or -1-padded id lists with
`device_masks=True`). The same seed gives bit-identical batches to the
JAX package's numpy path (`use_native=False`).

The JAX package's C++ feeder (`openrec_tpu/native/`) is not ported yet:
`PairwiseSampler(use_native=True)` raises NotImplementedError and the
default takes the numpy path. The other sampling strategies come with
the models that use them.

Batches are dicts of fixed-shape numpy arrays; `pipeline.to_device` moves
them onto the card.
"""

from __future__ import annotations

import numpy as np

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
    """(user, positive, uniform-negative) triplets, vectorized numpy.

    use_native: None or False take the numpy path; True asks for the JAX
    package's C++ feeder, which the port does not have yet, and raises.
    """

    def __init__(self, store, batch_size, seed=0, use_native=None,
                 chronological=False):
        if use_native:
            raise NotImplementedError(
                "the native C++ sampler feeder is not ported; use "
                "use_native=False (the numpy path)")
        super().__init__(store, batch_size, seed,
                         chronological=chronological)
        self.use_native = False

    def sample(self):
        rec = self._next_records(self.batch_size)
        user_id = np.asarray(rec["user_id"], dtype=np.int32)
        p_item_id = np.asarray(rec["item_id"], dtype=np.int32)
        n_item_id = self.store.sample_negative_items(
            user_id, rng=self.rng).astype(np.int32)
        return {"user_id": user_id, "p_item_id": p_item_id,
                "n_item_id": n_item_id}


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
