"""Host input pipeline: prefetching and device placement.

Counterpart of `openrec_tpu/data/pipeline.py`. `Prefetcher` (daemon
threads over vectorized samplers, each worker folding its id into the
seed) and `ShuffledArrayLoader` are the JAX package's, unchanged.
`to_device` / `device_iterator` (`pipeline.py:93-120`) become copies
from pinned host memory with `non_blocking=True` on the card, so the
copy of the next batch overlaps the steps of the current one, and plain
tensors on the CPU.
"""

from __future__ import annotations

import collections
import queue
import threading

import numpy as np
import torch

from openrec_tpu_torch.device import resolve_device


class Prefetcher:
    """Background-thread batch producer with per-worker seed folding.

    Iterating yields batches; `take` bounds the number of batches (finite
    iteration), otherwise infinite for infinite samplers.
    """

    def __init__(self, sampler, num_workers: int = 1, capacity: int = 8,
                 take=None):
        self._sampler = sampler
        self._num_workers = max(1, int(num_workers))
        self._take = take
        self._q: queue.Queue = queue.Queue(maxsize=capacity)
        self._stop = threading.Event()
        self._threads = []
        self._started = False

    def _worker(self, worker_id: int):
        base_seed = getattr(self._sampler, "seed", 0) or 0
        local = (self._sampler.with_seed((base_seed, worker_id))
                 if hasattr(self._sampler, "with_seed") else self._sampler)
        it = iter(local)
        while not self._stop.is_set():
            try:
                batch = next(it)
            except StopIteration:
                self._q.put(None)
                return
            while not self._stop.is_set():
                try:
                    self._q.put(batch, timeout=0.1)
                    break
                except queue.Full:
                    continue

    def start(self):
        if self._started:
            return
        self._started = True
        for i in range(self._num_workers):
            t = threading.Thread(target=self._worker, args=(i,), daemon=True)
            t.start()
            self._threads.append(t)

    def stop(self):
        self._stop.set()
        # Drain so workers blocked on put() can exit.
        try:
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass

    def __iter__(self):
        self.start()
        produced = 0
        finished_workers = 0
        while self._take is None or produced < self._take:
            item = self._q.get()
            if item is None:
                finished_workers += 1
                if finished_workers >= self._num_workers:
                    return
                continue
            produced += 1
            yield item

    def __del__(self):
        self._stop.set()


def to_device(batch: dict, device=None) -> dict:
    """numpy (or tensor) batch -> tensors on `device` (default CUDA).

    On the card each array is staged in pinned host memory and copied with
    `non_blocking=True` on the current stream: the call returns before the
    copy ends, and PyTorch's pinned-memory allocator keeps the staging
    buffer alive until it has. On the CPU the tensors share the arrays'
    memory where they can."""
    dev = resolve_device(device)
    out = {}
    for key, value in batch.items():
        t = value if isinstance(value, torch.Tensor) \
            else torch.from_numpy(np.ascontiguousarray(value))
        if dev.type == "cuda" and t.device.type == "cpu":
            t = t.pin_memory().to(dev, non_blocking=True)
        else:
            t = t.to(dev)
        out[key] = t
    return out


def device_iterator(batches, device=None, prefetch: int = 2):
    """Iterate batches as tensors on `device`, keeping `prefetch` copies in
    flight so host->device copies overlap with compute."""
    dev = resolve_device(device)
    buf = collections.deque()
    it = iter(batches)
    try:
        while True:
            while len(buf) < prefetch:
                buf.append(to_device(next(it), dev))
            yield buf.popleft()
    except StopIteration:
        while buf:
            yield buf.popleft()


class ShuffledArrayLoader:
    """Epoch-shuffling minibatch loader over aligned dense arrays: a seeded
    permutation per epoch + contiguous slices."""

    def __init__(self, arrays: dict, batch_size: int, seed=0,
                 drop_remainder=True):
        self.arrays = {k: np.asarray(v) for k, v in arrays.items()}
        lens = {len(v) for v in self.arrays.values()}
        if len(lens) != 1:
            raise ValueError("all arrays must share the leading dim")
        self.n = lens.pop()
        self.batch_size = int(batch_size)
        self.rng = np.random.default_rng(seed)
        self.drop_remainder = drop_remainder

    def __len__(self):
        if self.drop_remainder:
            return self.n // self.batch_size
        return -(-self.n // self.batch_size)

    def epoch(self, shuffle=True):
        idx = self.rng.permutation(self.n) if shuffle else np.arange(self.n)
        end = (self.n - self.n % self.batch_size
               if self.drop_remainder else self.n)
        for i in range(0, end, self.batch_size):
            take = idx[i:i + self.batch_size]
            yield {k: v[take] for k, v in self.arrays.items()}

    def __iter__(self):
        while True:
            yield from self.epoch()
