"""User-facing Dataset facade.

Counterpart of `openrec_tpu/data/dataset.py`: `Dataset.__init__` builds an
`InteractionStore`; `pairwise`, `stratified_pointwise`,
`per_pos_stratified_pointwise` and `random_pointwise` each return a
`Prefetcher` over a sampler seeded with the dataset's seed (each worker
folds its id into it; `pairwise(joins=...)` wraps its sampler in a
`FeatureJoinedSampler`), `n_pairwise` one over K negatives per positive
(NBPR, WCML), `temporal` one over history windows and next-item labels
(the sequence models; a store built with `sortby`, e.g. "ts"), and
`evaluation` an `EvaluationSampler`, `temporal_evaluation` a
`TemporalEvaluationSampler`; both temporal methods take `joins=` (the
user features of YouTubeRec). `explicit` streams records with their
ratings (ItrMLP; chronological=True forces one worker) and
`regression_evaluation` gives a `RegressionEvalSampler` (the per-record
MSE eval).
"""

from __future__ import annotations

from openrec_tpu_torch.data.pipeline import Prefetcher
from openrec_tpu_torch.data.samplers import (
    EvaluationSampler, ExplicitSampler, FeatureJoinedSampler,
    NPairwiseSampler, PairwiseSampler,
    PerPosStratifiedPointwiseSampler, RandomPointwiseSampler,
    RegressionEvalSampler,
    StratifiedPointwiseSampler, TemporalEvaluationSampler, TemporalSampler)
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
                 joins=(), chronological=False):
        """Infinite (user, pos, neg) batches from `num_parallel_calls`
        prefetch threads. joins: (id_key, features, out_key) triples,
        e.g. ("p_item_id", feats, "p_item_vfeature"), joined into every
        batch (`FeatureJoinedSampler`). chronological=True: one unshuffled
        sequential epoch in raw-data order (finite; forces 1 worker)."""
        s = PairwiseSampler(self.store, batch_size, seed=self._seed,
                            chronological=chronological)
        if joins:
            s = FeatureJoinedSampler(s, joins)
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

    def explicit(self, batch_size, label_field="label",
                 num_parallel_calls=1, take=None, chronological=False):
        """(user, item, float32 label) batches; chronological=True: one
        unshuffled sequential epoch in raw-data order (finite; forces 1
        worker)."""
        s = ExplicitSampler(self.store, batch_size, label_field,
                            seed=self._seed, chronological=chronological)
        if chronological:
            num_parallel_calls = 1
        return Prefetcher(s, num_workers=num_parallel_calls, take=take)

    def temporal(self, batch_size, max_seq_len, num_parallel_calls=1,
                 take=None, joins=()):
        """Infinite (window, seq_len, next-item label, user) batches;
        joins as for `pairwise`, e.g. ("user_id", gender, "user_gender")."""
        s = TemporalSampler(self.store, batch_size, max_seq_len,
                            seed=self._seed)
        if joins:
            s = FeatureJoinedSampler(s, joins)
        return Prefetcher(s, num_workers=num_parallel_calls, take=take)

    def evaluation(self, batch_size, excl_datasets=(), device_masks=False):
        return EvaluationSampler(
            self.store, batch_size,
            excl_stores=[d.store for d in excl_datasets],
            device_masks=device_masks)

    def regression_evaluation(self, batch_size, label_field="label"):
        """Every record once, as (user, item, label) batches with a
        `valid` mask: the per-record regression (MSE) eval."""
        return RegressionEvalSampler(self.store, batch_size, label_field)

    def temporal_evaluation(self, batch_size, max_seq_len, joins=()):
        """A `TemporalEvaluationSampler`; with joins its `epoch()` adds
        `batch[out_key] = feats[batch[id_key]]` to every batch (padding
        rows join user 0's row)."""
        s = TemporalEvaluationSampler(self.store, batch_size, max_seq_len)
        if joins:
            epoch = s.epoch

            def joined_epoch():
                for batch in epoch():
                    for id_key, feats, out_key in joins:
                        batch[out_key] = feats[batch[id_key]]
                    yield batch
            s.epoch = joined_epoch
        return s
