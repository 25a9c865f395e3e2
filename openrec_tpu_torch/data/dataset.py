"""User-facing Dataset facade.

Counterpart of `openrec_tpu/data/dataset.py`: `Dataset.__init__` builds an
`InteractionStore`; `pairwise`, `stratified_pointwise`,
`per_pos_stratified_pointwise` and `random_pointwise` each return a
`Prefetcher` over a sampler seeded with the dataset's seed (each worker
folds its id into it), `n_pairwise` one over K negatives per positive
(NBPR, WCML), and `evaluation` an `EvaluationSampler`. The explicit and
temporal strategies of the JAX package come with the models that use
them.
"""

from __future__ import annotations

from openrec_tpu_torch.data.pipeline import Prefetcher
from openrec_tpu_torch.data.samplers import (
    EvaluationSampler, NPairwiseSampler, PairwiseSampler,
    PerPosStratifiedPointwiseSampler, RandomPointwiseSampler,
    StratifiedPointwiseSampler)
from openrec_tpu_torch.data.store import InteractionStore


class Dataset:

    def __init__(self, raw_data, total_users, total_items,
                 implicit_negative=True, num_negatives=None, seed=None,
                 sortby=None, asc=True, name=None):
        self.store = InteractionStore(
            raw_data=raw_data, total_users=total_users,
            total_items=total_items, implicit_negative=implicit_negative,
            num_negatives=num_negatives, seed=seed, sortby=sortby, asc=asc,
            name=name)
        self._seed = seed if seed is not None else 0

    def pairwise(self, batch_size, num_parallel_calls=1, take=None,
                 chronological=False):
        """Infinite (user, pos, neg) batches from `num_parallel_calls`
        prefetch threads. chronological=True: one unshuffled sequential
        epoch in raw-data order (finite; forces 1 worker)."""
        s = PairwiseSampler(self.store, batch_size, seed=self._seed,
                            chronological=chronological)
        if chronological:
            num_parallel_calls = 1
        return Prefetcher(s, num_workers=num_parallel_calls, take=take)

    def n_pairwise(self, batch_size, num_negatives, num_parallel_calls=1,
                   take=None):
        """Infinite (user, pos, [K] negatives) batches (numpy sampler)."""
        s = NPairwiseSampler(self.store, batch_size, num_negatives,
                             seed=self._seed)
        return Prefetcher(s, num_workers=num_parallel_calls, take=take)

    def stratified_pointwise(self, batch_size, pos_ratio=0.5,
                             num_parallel_calls=1, take=None,
                             chronological=False):
        """Infinite (user, item, label) batches, pos_ratio of them
        positives (chronological: finite, forces 1 worker)."""
        s = StratifiedPointwiseSampler(self.store, batch_size, pos_ratio,
                                       seed=self._seed,
                                       chronological=chronological)
        if chronological:
            num_parallel_calls = 1
        return Prefetcher(s, num_workers=num_parallel_calls, take=take)

    def per_pos_stratified_pointwise(self, batch_size, pos_ratio=0.5,
                                     num_parallel_calls=1, take=None):
        s = PerPosStratifiedPointwiseSampler(self.store, batch_size,
                                             pos_ratio, seed=self._seed)
        return Prefetcher(s, num_workers=num_parallel_calls, take=take)

    def random_pointwise(self, batch_size, num_parallel_calls=1, take=None):
        s = RandomPointwiseSampler(self.store, batch_size, seed=self._seed)
        return Prefetcher(s, num_workers=num_parallel_calls, take=take)

    def evaluation(self, batch_size, excl_datasets=(), device_masks=False):
        return EvaluationSampler(
            self.store, batch_size,
            excl_stores=[d.store for d in excl_datasets],
            device_masks=device_masks)
