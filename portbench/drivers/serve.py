"""Serving driver: a closed-loop client of `CachedDotProductScorer.topk`.

The client keeps `in_flight` requests outstanding: it copies request j's
user ids to the device, calls `topk`, queues the copy of the ids and
scores into pinned host buffers and an event, and only then waits for the
oldest request still out. A request's latency runs from the start of its
dispatch to the moment the host sees its event. The window counts the
users whose results reached the host before it closed; requests still out
at the close are drained and keep their latencies. A sample of the
finished requests, drawn from the seed, goes to the reference.
"""

from __future__ import annotations

import gc
import time
from collections import deque
from typing import NamedTuple

import numpy as np
import torch

from portbench import devtrace, traffic as traffic_lib, weights


class Pending(NamedTuple):
    j: int
    t: float
    event: object
    slot: int
    host_ids: torch.Tensor


class Reservoir:
    """A uniform sample of `size` finished requests, drawn from the seed
    (Algorithm R): (user ids, scores, item ids) as numpy arrays."""

    def __init__(self, size: int, seed: int):
        self.size = size
        self.rng = np.random.default_rng(
            weights.stream_seed(seed, weights.SAMPLE))
        self.seen = 0
        self.kept = []

    def offer(self, users, vals, ids):
        n = self.seen
        self.seen += 1
        if n < self.size:
            slot = len(self.kept)
            self.kept.append(None)
        else:
            slot = int(self.rng.integers(0, n + 1))
            if slot >= self.size:
                return
        self.kept[slot] = (users.numpy().copy(), vals.numpy().copy(),
                           ids.numpy().copy())


def build(cfg: dict, seed: int, device):
    """The port's BPR holding the seed's weights, and its scorer with the
    serve cache made."""
    from openrec_tpu_torch.models import BPR
    from openrec_tpu_torch.modules.embedding import embedding_lookup
    from openrec_tpu_torch.serving import CachedDotProductScorer
    U, I, D = cfg["total_users"], cfg["total_items"], cfg["dim"]
    model = BPR(total_users=U, total_items=I, dim_user_embed=D,
                dim_item_embed=D, device=device)
    w = weights.bpr_weights(cfg, seed, device)
    with torch.no_grad():
        model.user_embed.copy_(w["user_embed"])
        model.item_embed.copy_(w["item_embed"])
        model.item_bias.copy_(w["item_bias"][:, None])
    del w
    scorer = CachedDotProductScorer(
        model, U, I,
        extract_user_vecs=lambda p, i: embedding_lookup(p["user_embed"], i),
        extract_item_vecs=lambda p, i: embedding_lookup(p["item_embed"], i),
        extract_item_bias=lambda p, i: embedding_lookup(p["item_bias"], i),
        serve_dtype=getattr(torch, cfg["serve_dtype"]), device=device)
    params = model.params()
    scorer.cache(params)
    return model, scorer, params


class Client:
    def __init__(self, scorer, params, stream, traffic: dict, device,
                 spans: devtrace.Spans):
        self.scorer, self.params, self.stream = scorer, params, stream
        self.k = int(traffic["k"])
        self.method = traffic["method"]
        self.recall_target = float(traffic["recall_target"])
        self.in_flight = int(traffic["in_flight"])
        self.device = device
        self.cuda = device.type == "cuda"
        self.spans = spans
        self.annotate = False
        self.ring = self.in_flight + 1
        self.out = None

    def _buffers(self, vals, ids):
        def host(t):
            return torch.empty(t.shape, dtype=t.dtype, pin_memory=self.cuda)
        self.out = [(host(vals), host(ids)) for _ in range(self.ring)]

    def dispatch(self, j: int) -> Pending:
        host_ids = self.stream.ids(j)
        t = time.perf_counter()
        with devtrace.annotate("portbench.h2d_ids", self.annotate):
            users = host_ids.to(self.device, non_blocking=True)
        with self.spans("serve.topk"), \
                devtrace.annotate("portbench.topk", self.annotate):
            vals, ids = self.scorer.topk(self.params, users, k=self.k,
                                         method=self.method,
                                         recall_target=self.recall_target)
        if self.out is None:
            self._buffers(vals, ids)
        slot = j % self.ring
        with devtrace.annotate("portbench.d2h", self.annotate):
            out_v, out_i = self.out[slot]
            out_v.copy_(vals, non_blocking=True)
            out_i.copy_(ids, non_blocking=True)
            event = None
            if self.cuda:
                event = torch.cuda.Event()
                event.record()
        return Pending(j, t, event, slot, host_ids)

    def finish(self, p: Pending) -> float:
        with devtrace.annotate("portbench.wait", self.annotate):
            if p.event is not None:
                p.event.synchronize()
        return time.perf_counter()

    def loop(self, j0: int, until=None, count=None, on_done=None) -> int:
        """Requests from j0 on, `in_flight` outstanding, until the host
        clock passes `until` or `count` have been sent; every one is
        finished before it returns. on_done(pending, t_done) is called
        for each. Returns the next request number."""
        pending = deque()
        j = j0
        while (until is None or time.perf_counter() < until) and \
                (count is None or j - j0 < count):
            pending.append(self.dispatch(j))
            j += 1
            if len(pending) >= self.in_flight:
                p = pending.popleft()
                t_done = self.finish(p)
                if on_done is not None:
                    on_done(p, t_done)
        while pending:
            p = pending.popleft()
            t_done = self.finish(p)
            if on_done is not None:
                on_done(p, t_done)
        return j


def run(cell: dict, seed: int, seconds: float, trace: bool, device,
        t_proc: float) -> dict:
    cfg, traffic = cell["config"], cell["traffic"]
    cuda = device.type == "cuda"
    model, scorer, params = build(cfg, seed, device)
    stream = traffic_lib.RequestStream(traffic, cfg, seed, pin=cuda,
                                       ring=int(traffic["in_flight"]) + 2)
    spans = devtrace.Spans(on=False)
    client = Client(scorer, params, stream, traffic, device, spans)
    j = client.loop(0, count=int(traffic["warmup_requests"]))
    setup_s = time.perf_counter() - t_proc

    B = int(traffic["batch"])
    spans.on = trace
    sample = Reservoir(int(traffic["sample_requests"]), seed)
    lat, done = [], [0]
    t0 = time.perf_counter()
    end = t0 + seconds

    def on_done(p, t_done):
        lat.append(t_done - p.t)
        if t_done <= end:
            done[0] += B
        out_v, out_i = client.out[p.slot]
        sample.offer(p.host_ids, out_v, out_i)

    j_end = client.loop(j, until=end, on_done=on_done)
    spans.on = False

    sliced = None
    if trace:
        client.annotate = True
        n = int(traffic["trace_requests"])
        sliced = devtrace.profiled_slice(
            lambda: client.loop(j_end, count=n), device)
        sliced["requests"] = n
        client.annotate = False
    peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    del model, scorer, params, client
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    return {
        "setup_s": setup_s,
        "window_s": seconds,
        "attempted": j_end - j,
        "failed": 0,
        "latencies_s": lat,
        "users_done": done[0],
        "spans": dict(spans.durations),
        "slice": sliced,
        "memory_peak_bytes": peak,
        "sample": sample.kept,
    }
