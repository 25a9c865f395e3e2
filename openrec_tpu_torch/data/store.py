"""In-memory interaction index on flat numpy arrays.

The port's own copy of `openrec_tpu/data/store.py:28-322` (numpy only;
importing the JAX package's module would import JAX through its package
`__init__`). Same arrays, same seeded draws, same results:

  - membership tests use a single sorted int64 key array (user*I + item) and
    np.searchsorted → is_positive() is O(log N) and fully batch-vectorizable;
  - per-user positive lists live in a CSR layout (indptr + items), so mask
    construction and per-user slicing are numpy fancy-indexing, not loops;
  - negative rejection-sampling is batched (draw, test membership on the whole
    batch at once, redraw only rejects).
"""

from __future__ import annotations

import numpy as np


def _as_int64(a) -> np.ndarray:
    return np.asarray(a, dtype=np.int64)


class InteractionStore:
    """Index over a structured interaction array.

    Args:
      raw_data: numpy structured array with at least ``user_id`` and
        ``item_id`` fields; ``label`` required when ``implicit_negative`` is
        False; the ``sortby`` field required when ``sortby`` is given.
      total_users / total_items: catalog sizes.
      implicit_negative: if True every record is a positive and negatives are
        "anything not observed"; if False records carry explicit 0/1 labels.
      num_negatives: if set, pre-sample this many negatives per user (mirrors
        reference utils.py:37-49) — evaluation then ranks positives against
        the pre-sampled negatives only.
      seed: RNG seed; all sampling in the store is deterministic given it.
      sortby: optional field name to time-sort each user's positives by.
      asc: sort ascending (True) or descending.
    """

    def __init__(self, raw_data, total_users, total_items,
                 implicit_negative=True, num_negatives=None, seed=None,
                 sortby=None, asc=True, name=None):
        if not isinstance(raw_data, np.ndarray):
            raise TypeError(
                "Unsupported data input schema. Use a structured numpy array.")
        self.name = name
        self._raw_data = raw_data
        self._total_users = int(total_users)
        self._total_items = int(total_items)
        self._num_negatives = num_negatives
        self._implicit_negative = bool(implicit_negative)
        self._sortby = sortby
        self._rng = np.random.default_rng(seed)

        users = _as_int64(raw_data["user_id"])
        items = _as_int64(raw_data["item_id"])

        if implicit_negative:
            pos_sel = np.ones(len(raw_data), dtype=bool)
        else:
            labels = np.asarray(raw_data["label"])
            pos_sel = labels > 0

        self._pos_users = users[pos_sel]
        self._pos_items = items[pos_sel]
        self._pos_records = np.flatnonzero(pos_sel)

        # Sorted composite keys give O(log N) membership for any (u, i) batch.
        self._pos_keys = np.sort(self._pos_users * self._total_items
                                 + self._pos_items)

        # CSR layout: user u's positives are _csr_items[_csr_ptr[u]:_csr_ptr[u+1]].
        order = np.argsort(self._pos_users, kind="stable")
        csr_items = self._pos_items[order]
        counts = np.bincount(self._pos_users, minlength=self._total_users)
        self._csr_ptr = np.concatenate(
            [[0], np.cumsum(counts)]).astype(np.int64)
        self._csr_items = csr_items
        self._csr_records = self._pos_records[order]

        if sortby is not None:
            ts = np.asarray(raw_data[sortby])[pos_sel][order]
            # Per-user stable sort by timestamp: sort (user, ts) pairs.
            sort_key = ts if asc else -ts
            within = np.lexsort((sort_key, self._pos_users[order]))
            self._csr_items_sorted = csr_items[within]
        else:
            self._csr_items_sorted = None

        # Explicit negatives (implicit_negative=False path).
        if not implicit_negative:
            neg_sel = ~pos_sel
            self._neg_users = users[neg_sel]
            self._neg_items = items[neg_sel]
            norder = np.argsort(self._neg_users, kind="stable")
            ncounts = np.bincount(self._neg_users,
                                  minlength=self._total_users)
            self._neg_ptr = np.concatenate(
                [[0], np.cumsum(ncounts)]).astype(np.int64)
            self._neg_items_csr = self._neg_items[norder]
        elif num_negatives is not None:
            # Pre-sample `num_negatives` negatives per warm user
            # (reference utils.py:37-49).
            warm = np.flatnonzero(counts > 0)
            neg_rows = self._presample_negatives_batch(warm, num_negatives)
            ptr = np.zeros(self._total_users + 1, dtype=np.int64)
            for u, negs in zip(warm, neg_rows):
                ptr[u + 1] = len(negs)
            self._neg_ptr = np.cumsum(ptr).astype(np.int64)
            self._neg_items_csr = (np.concatenate(neg_rows)
                                   if neg_rows else np.empty(0, np.int64))
        else:
            self._neg_ptr = None
            self._neg_items_csr = None

        # Epoch-shuffled record stream (reference utils.py:82-87 semantics:
        # every record appears once per epoch, order re-shuffled each epoch).
        # Guarded by a lock — samplers keep their own streams (see
        # BatchSampler._next_record_indices), but direct store use must be
        # safe under the threaded Prefetcher.
        import threading
        self._perm = np.empty(0, dtype=np.int64)
        self._perm_pos = 0
        self._perm_lock = threading.Lock()

    # ------------------------------------------------------------------ #
    # basic accessors
    # ------------------------------------------------------------------ #

    def total_users(self) -> int:
        return self._total_users

    def total_items(self) -> int:
        return self._total_items

    def total_records(self) -> int:
        return len(self._raw_data)

    @property
    def raw_data(self) -> np.ndarray:
        return self._raw_data

    def contain_negatives(self) -> bool:
        """True when explicit/pre-sampled negatives exist
        (reference utils.py:75-80)."""
        return self._neg_items_csr is not None

    # ------------------------------------------------------------------ #
    # record stream
    # ------------------------------------------------------------------ #

    def next_random_record_indices(self, n: int) -> np.ndarray:
        """Next `n` record indices of the epoch-shuffled stream."""
        with self._perm_lock:
            out = np.empty(n, dtype=np.int64)
            filled = 0
            while filled < n:
                if self._perm_pos >= len(self._perm):
                    self._perm = self._rng.permutation(len(self._raw_data))
                    self._perm_pos = 0
                take = min(n - filled, len(self._perm) - self._perm_pos)
                out[filled:filled + take] = \
                    self._perm[self._perm_pos:self._perm_pos + take]
                self._perm_pos += take
                filled += take
            return out

    def next_random_records(self, n: int) -> np.ndarray:
        """Return the next `n` records of the epoch-shuffled stream."""
        return self._raw_data[self.next_random_record_indices(n)]

    # ------------------------------------------------------------------ #
    # membership / sampling
    # ------------------------------------------------------------------ #

    def is_positive(self, user_ids, item_ids) -> np.ndarray:
        """Vectorized membership test; accepts scalars or arrays."""
        keys = _as_int64(user_ids) * self._total_items + _as_int64(item_ids)
        idx = np.searchsorted(self._pos_keys, keys)
        idx = np.minimum(idx, len(self._pos_keys) - 1)
        if len(self._pos_keys) == 0:
            return np.zeros_like(keys, dtype=bool)
        return self._pos_keys[idx] == keys

    def sample_negative_items(self, user_ids, max_rounds: int = 64,
                              rng=None) -> np.ndarray:
        """One uniform negative per user, batched rejection sampling.

        Mirrors reference utils.py:102-116 (uniform over catalog, reject
        observed positives; pre-sampled negatives used when present).
        Pass `rng` for thread-independent draws (samplers pass their own —
        np.random.Generator is not thread-safe).
        """
        rng = rng if rng is not None else self._rng
        user_ids = np.atleast_1d(_as_int64(user_ids))
        if self._num_negatives is not None:
            return self._sample_presampled_negatives(user_ids, rng)
        cand = rng.integers(0, self._total_items, size=len(user_ids))
        bad = self.is_positive(user_ids, cand)
        rounds = 0
        while bad.any() and rounds < max_rounds:
            resample = rng.integers(0, self._total_items,
                                    size=int(bad.sum()))
            cand[bad] = resample
            bad = self.is_positive(user_ids, cand)
            rounds += 1
        return cand

    def sample_negative_items_multi(self, user_ids, k: int,
                                    rng=None) -> np.ndarray:
        """k negatives per user, shape [len(user_ids), k]."""
        user_ids = np.atleast_1d(_as_int64(user_ids))
        flat_users = np.repeat(user_ids, k)
        return self.sample_negative_items(flat_users,
                                          rng=rng).reshape(-1, k)

    def sample_positive_items(self, user_id: int, num_samples: int = 1):
        lo, hi = self._csr_ptr[user_id], self._csr_ptr[user_id + 1]
        if hi - lo == 0:
            return np.empty(0, dtype=np.int64)
        picks = self._rng.integers(lo, hi, size=num_samples)
        return self._csr_items[picks]

    def _presample_user_negatives(self, user_id: int, k: int) -> np.ndarray:
        seen = set(self.get_positive_items(user_id).tolist())
        out = []
        chosen = set()
        while len(out) < k and len(chosen) + len(seen) < self._total_items:
            cand = int(self._rng.integers(0, self._total_items))
            if cand in seen or cand in chosen:
                continue
            chosen.add(cand)
            out.append(cand)
        return np.asarray(out, dtype=np.int64)

    def _presample_negatives_batch(self, users: np.ndarray, k: int) -> list:
        """First-k-distinct-non-positive uniform draws per user, for all
        users at once: one [W, m] oversampled candidate matrix with a
        vectorized positive check + order-preserving per-row dedupe,
        instead of the O(U·k) per-draw Python loop (advisor r2 note —
        that loop dominated init at 450k-item catalogs). Rows where the
        oversample comes up short (k near the catalog size, or dense
        users) fall back to the exact per-user loop; the sampled
        DISTRIBUTION is identical either way (first k distinct valid
        entries of a uniform stream)."""
        W = len(users)
        if W == 0:
            return []
        m = min(self._total_items, int(k * 1.5) + 32)
        cand = self._rng.integers(0, self._total_items, size=(W, m))
        pos = self.is_positive(np.repeat(users, m),
                               cand.reshape(-1)).reshape(W, m)
        # keep only each value's FIRST occurrence within its row (stable
        # sort ⇒ the first of each equal-run is the earliest position)
        order = np.argsort(cand, axis=1, kind="stable")
        sc = np.take_along_axis(cand, order, axis=1)
        first_sorted = np.ones_like(sc, dtype=bool)
        first_sorted[:, 1:] = sc[:, 1:] != sc[:, :-1]
        first = np.empty_like(first_sorted)
        np.put_along_axis(first, order, first_sorted, axis=1)
        valid = first & ~pos
        enough = valid.sum(axis=1) >= k
        rows = []
        for i in range(W):
            if enough[i]:
                rows.append(cand[i][valid[i]][:k].astype(np.int64))
            else:
                rows.append(self._presample_user_negatives(int(users[i]),
                                                           k))
        return rows

    def _sample_presampled_negatives(self, user_ids: np.ndarray,
                                     rng=None) -> np.ndarray:
        rng = rng if rng is not None else self._rng
        lo = self._neg_ptr[user_ids]
        hi = self._neg_ptr[user_ids + 1]
        width = np.maximum(hi - lo, 1)
        picks = lo + rng.integers(0, 1 << 62, size=len(user_ids)) % width
        picks = np.minimum(picks, len(self._neg_items_csr) - 1)
        return self._neg_items_csr[picks]

    # ------------------------------------------------------------------ #
    # per-user views
    # ------------------------------------------------------------------ #

    def get_positive_items(self, user_id: int, sort: bool = False
                           ) -> np.ndarray:
        lo, hi = self._csr_ptr[user_id], self._csr_ptr[user_id + 1]
        if sort:
            assert self._sortby is not None, "sortby key is not specified."
            return self._csr_items_sorted[lo:hi]
        return self._csr_items[lo:hi]

    def get_negative_items(self, user_id: int) -> np.ndarray:
        if self._neg_items_csr is not None:
            lo, hi = self._neg_ptr[user_id], self._neg_ptr[user_id + 1]
            return self._neg_items_csr[lo:hi]
        # All unobserved items (reference utils.py:136-141).
        mask = np.ones(self._total_items, dtype=bool)
        mask[self.get_positive_items(user_id)] = False
        return np.flatnonzero(mask)

    def user_positive_counts(self) -> np.ndarray:
        return np.diff(self._csr_ptr)

    def warm_users(self, threshold: int = 1) -> np.ndarray:
        return np.flatnonzero(self.user_positive_counts() >= threshold)

    def positive_csr(self):
        """(indptr, items) CSR view — used by mask builders and eval."""
        return self._csr_ptr, self._csr_items

    def negative_csr(self):
        if self._neg_items_csr is None:
            return None
        return self._neg_ptr, self._neg_items_csr
