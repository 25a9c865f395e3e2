#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA GPU (written for the H100).

    python3 chip_smoke.py          # from the root of the repository

Phases, in order; any failure raises and exits non-zero:
  1. print the card's name and power limit; build the CUDA kernels from
     openrec_tpu_torch/csrc with nvcc, one process per source, all at once
     (set-up time, printed).
  2. hold each kernel against its plain PyTorch version on the card: f32
     and bf16, D in {50, 64}, a ragged catalog tail, bucket = 1, a split
     bucket range, and the serving shapes (K1/K2); for K3 k in {1, 100,
     128, 129, 1000}, k == I on a 300-item catalog, B and I off the
     kernel's tiling, duplicated item rows (exact ties), tables that do not
     start on a 16-byte boundary, and both serving shapes. Values within rtol=atol=1e-5; an id may differ only where the
     two picks score within that tolerance (a different summation order);
     K2's second slot as id sets.
  3. the serving path at full width: BPR at the Amazon catalog of
     examples/serving_retrieval.py (99,473 users x 450,166 items x 64,
     bf16 serve tables) with random weights made from --seed by numpy and
     loaded through convert.params_from_jax, then 8 requests of 256 users
     with top-100 by 'pallas' (recall target 0.99), 'pallas2' (0.995),
     'exact' and 'approx'. Every returned score must equal the fp32 score
     at its id, recall against 'exact' must reach the target less 0.01,
     both kernels' launch counters must move, and one eval_metrics batch
     must match the dense metrics. Then the same at the BPR-CiteULike shape
     of bench.py (5,551 x 16,980 x 50, fp32 tables).
  4. time each kernel with CUDA events (median of 30 after warm-up) beside
     its plain version, a library yardstick (torch.matmul + torch.topk,
     which the port never calls) and its bound (bytes at 3.35 TB/s,
     operations at the peak for the input type): K1/K2 at the Amazon
     serving shape, K3 at the CiteULike retrieval shape of phase 5 and at
     the Amazon shape.
  5. the training path at full width: BPR 5,551 x 16,980 x dim 50, batch
     1000, lazy_adam at lr 1e-3 on the card, on synthetic_citeulike()'s
     records with each item redrawn from a long-tailed popularity (see
     `citeulike_data`). Trainer.train, with val eval and a checkpoint every
     200 steps: host-fed (Dataset.pairwise, 2 threads, 100 steps a call),
     then device-sampled (DevicePairwiseSampler, 200 steps a call).
     Checks: the mean loss of each 200 steps falls in both feeds and val
     AUC rises above its step-0 value; on one stacked
     sample the share of negatives that are positives is within
     10 x density^(rounds+1); 20 steps on the card equal the same 20 steps
     on the CPU (rtol 1e-4, atol 1e-6); the checkpoint restored into a
     fresh model scores as the trained model does; 8 requests of 256
     users with top-100 by `ops.fused_score_topk` (K3) on the restored
     tables match topk_xla, and K3's launch counter reads 8. Prints
     steps/s and examples/s of both feeds and the device's idle share
     under torch.profiler.

After the checks, each serving shape also times 110 requests per method
(closed loop, one client: median and p90) and profiles 5 more with
torch.profiler (device time by kernel, idle share).

Prints a {"requests": ...} line with the serving latencies, a
{"training": ...} line, a {"kernels": [...]} line (K1, K2, K3), and last
the line {"ok": true, "device": {"platform": "gpu", "kind": ...,
"count": ...}}. With --out FILE, the full record (every check, latency,
profile and timing) is also written there as JSON.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS = {"bfloat16": 989e12, "float32": 67e12}   # H100 SXM, dense
TOL = 1e-5
AMAZON = dict(name="amazon", users=99_473, items=450_166, dim=64,
              dtype="bfloat16")
CITEULIKE = dict(name="citeulike", users=5_551, items=16_980, dim=50,
                 dtype="float32")
BATCH, K, REQUESTS = 256, 100, 8
TIMED = 110
METHODS = ("pallas", "pallas2", "exact", "approx")
TARGETS = {"pallas": 0.99, "pallas2": 0.995}


def fail(msg):
    raise RuntimeError(msg)


def make_params(rng, users, items, dim):
    """BPR weights as the JAX package would hand them over: numpy arrays,
    uniform(-0.05, 0.05) embeddings and a nonzero bias."""
    return {
        "user_embed": rng.uniform(-0.05, 0.05, (users, dim)).astype(
            np.float32),
        "item_embed": rng.uniform(-0.05, 0.05, (items, dim)).astype(
            np.float32),
        "item_bias": rng.normal(0.0, 0.01, (items, 1)).astype(np.float32),
    }


# ------------------------------------------------------------ phase 2

def compare_kernel(torch, bt, u, v, b, bucket, top2):
    """Kernel vs plain version on the same card tensors. Returns
    (max_abs_err, non-tie id mismatches, tie id mismatches)."""
    plain = bt.bucket_max_plain(u, v, b, bucket, top2=top2)
    kern = (bt.bucket_max2_scores if top2 else bt.bucket_max_scores)(
        u, v, b, bucket=bucket)
    torch.cuda.synchronize()
    for p, q in zip(plain, kern):
        if p.shape != q.shape or p.dtype != q.dtype:
            fail(f"kernel output {q.shape}/{q.dtype} != plain "
                 f"{p.shape}/{p.dtype}")
    B, I = u.shape[0], v.shape[0]
    L = plain[0].shape[1]
    full = u.float() @ v.float().T
    if b is not None:
        full = full + b.reshape(-1)
    full = torch.cat([full, full.new_full((B, L * bucket_of(bt, v, bucket)
                                            - I), -1e30)], dim=1)

    def at(ids):
        return full.gather(1, ids.long())

    def near(x, y):
        return (x - y).abs() <= TOL + TOL * y.abs()

    vals_p, vals_k = plain[0::2], kern[0::2]
    err = 0.0
    for vp, vk in zip(vals_p, vals_k):
        fin = torch.isfinite(vp)
        if not torch.equal(fin, torch.isfinite(vk)):
            fail("kernel and plain disagree on which values are finite")
        if fin.any():
            err = max(err, (vp[fin] - vk[fin]).abs().max().item())
            if not near(vk[fin], vp[fin]).all():
                fail(f"values differ beyond rtol=atol={TOL}: max {err}")
    v1p, i1p = plain[0], plain[1]
    v1k, i1k = kern[0], kern[1]
    # every kernel id lies in the bucket of its column
    col = torch.arange(L, device=u.device)[None, :]
    item_block = 128 * bucket_of(bt, v, bucket)
    ids_k = kern[1::2]
    for ik in ids_k:
        if not ((ik // item_block) * 128 + ik % 128 == col).all():
            fail("a kernel id lies outside its column's bucket")
    if not top2:
        diff = i1k != i1p
        tie = diff & near(at(i1k), v1p)
        return err, int((diff & ~tie).sum()), int(tie.sum())
    v2p, i2p = plain[2], plain[3]
    v2k, i2k = kern[2], kern[3]
    same = ((i1k == i1p) & (i2k == i2p)) | ((i1k == i2p) & (i2k == i1p))
    empty2 = torch.isinf(v2p)           # bucket == 1: slot 2 stays -inf
    same = same | (empty2 & (i1k == i1p) & (i2k == i2p))
    diff = ~same
    tie = diff & near(at(i1k), v1p) & (empty2 | near(at(i2k), v2p))
    return err, int((diff & ~tie).sum()), int(tie.sum())


def bucket_of(bt, v, bucket):
    return bt.bucket_geometry(v.shape[0], v.shape[1], v.element_size(),
                              bucket)[0]


def phase_compare(torch, bt, gen, dev):
    cases = [
        # name, B, I, D, dtype, bucket
        ("f32 D=50 ragged", 37, 5_000, 50, torch.float32, 4),
        ("bf16 D=64", 70, 20_000, 64, torch.bfloat16, 16),
        ("bf16 bucket=1", 9, 1_000, 64, torch.bfloat16, 1),
        ("f32 split", 64, 30_000, 64, torch.float32, 64),
        ("amazon K1 shape", BATCH, AMAZON["items"], 64, torch.bfloat16, 64),
        ("amazon K2 shape", BATCH, AMAZON["items"], 64, torch.bfloat16, 256),
        ("citeulike shape", BATCH, CITEULIKE["items"], 50, torch.float32,
         16),
    ]
    errs = {"K1": 0.0, "K2": 0.0}
    report = []
    for name, B, I, D, dt, bucket in cases:
        u = torch.randn(B, D, generator=gen, device=dev).to(dt)
        v = torch.randn(I, D, generator=gen, device=dev).to(dt)
        b = torch.randn(I, generator=gen, device=dev)
        for kname, top2 in (("K1", False), ("K2", True)):
            err, bad, ties = compare_kernel(torch, bt, u, v, b, bucket, top2)
            errs[kname] = max(errs[kname], err)
            line = dict(case=name, kernel=kname, B=B, I=I, D=D,
                        dtype=str(dt).split(".")[-1], bucket=bucket,
                        max_abs_err=err, id_mismatch_not_tie=bad,
                        id_mismatch_tie=ties)
            print("compare", json.dumps(line), flush=True)
            report.append(line)
            if bad:
                fail(f"{kname} {name}: {bad} id mismatches that are not "
                     "near-ties")
    return errs, report


K3_CASES = [
    # name, B, I, D, dtype, k, layout: "" | "dup" (item 3j+1 repeats item
    # 3j: exact ties) | "offset" (the table is a view one row into its
    # storage, so it does not start on a 16-byte boundary)
    ("K3 f32 D=50 k=100 ragged", 37, 5_003, 50, "float32", 100, ""),
    ("K3 bf16 D=64 k=1", 70, 20_001, 64, "bfloat16", 1, ""),
    ("K3 f32 D=64 k=128", 33, 12_345, 64, "float32", 128, ""),
    ("K3 bf16 D=50 k=129", 9, 7_777, 50, "bfloat16", 129, ""),
    ("K3 f32 D=64 k=1000", 70, 30_000, 64, "float32", 1000, ""),
    ("K3 f32 D=50 k==I", 11, 300, 50, "float32", 300, ""),
    ("K3 bf16 D=64 duplicated rows", 40, 9_000, 64, "bfloat16", 100, "dup"),
    ("K3 f32 D=50 offset view", 20, 3_001, 50, "float32", 100, "offset"),
    ("K3 bf16 D=50 offset view", 20, 3_001, 50, "bfloat16", 100, "offset"),
    ("K3 citeulike shape", BATCH, CITEULIKE["items"], 50, "float32", K, ""),
    ("K3 amazon shape", BATCH, AMAZON["items"], 64, "bfloat16", K, ""),
]


def check_topk(torch, vals, ids, want_v, want_i, full, what):
    """(max_abs_err, non-tie id mismatches, tie id mismatches) of a top-k
    against a reference top-k of the same fp32 scores `full` [B, I]: shape
    and dtype, finite values within rtol=atol=TOL, ids in range, best
    first, each value the score at its id, and ids equal except where both
    picks score within TOL."""
    if vals.shape != want_v.shape or ids.dtype != torch.int32 \
            or vals.dtype != torch.float32:
        fail(f"{what}: output {tuple(vals.shape)}/{vals.dtype}/{ids.dtype}")
    if not torch.isfinite(vals).all():
        fail(f"{what}: non-finite values")
    if ids.min() < 0 or ids.max() >= full.shape[1]:
        fail(f"{what}: an id lies outside the catalog")
    if (vals[:, 1:] > vals[:, :-1]).any():
        fail(f"{what}: values are not best first")

    def near(x, y):
        return (x - y).abs() <= TOL + TOL * y.abs()

    err = (vals - want_v).abs().max().item()
    if not near(vals, want_v).all():
        fail(f"{what}: values differ beyond rtol=atol={TOL}: max {err}")
    at = full.gather(1, ids.long())
    if not near(at, vals).all():
        fail(f"{what}: a value is not the fp32 score at its id")
    diff = ids != want_i.to(ids.dtype)
    tie = diff & near(at, want_v)
    return err, int((diff & ~tie).sum()), int(tie.sum())


def phase_compare_k3(torch, tk, gen, dev):
    """K3 (ops.fused_score_topk) against fused_topk_plain on card tensors."""
    err_max, report = 0.0, []
    for name, B, I, D, dt, k, layout in K3_CASES:
        dtype = getattr(torch, dt)
        u = torch.randn(B, D, generator=gen, device=dev).to(dtype)
        v = torch.randn(I, D, generator=gen, device=dev)
        b = torch.randn(I, generator=gen, device=dev)
        dup = layout == "dup"
        if dup:     # item 3j+1 repeats item 3j, bias and all: exact ties
            n = v[1::3].shape[0]
            v[1::3] = v[0::3][:n]
            b[1::3] = b[0::3][:n]
        v = v.to(dtype).contiguous()
        if layout == "offset":
            v = torch.cat([v[:1], v])[1:]
            if v.data_ptr() % 16 == 0:
                fail(f"{name}: the view is 16-byte aligned")
        want_v, want_i = tk.fused_topk_plain(u, v, b, k)
        vals, ids = tk.fused_score_topk(u, v, b, k)
        torch.cuda.synchronize()
        full = tk.dot_scores(u, v, b)
        err, bad, ties = check_topk(torch, vals, ids, want_v, want_i, full,
                                    name)
        err_max = max(err_max, err)
        Kb, G, n_slices, tps, smem = tk.fused_geometry(
            B, I, D, k, torch.cuda.get_device_properties(dev)
            .multi_processor_count)
        line = dict(case=name, kernel="K3", B=B, I=I, D=D, dtype=dt, k=k,
                    Kb=Kb, users_per_block=G, slices=n_slices,
                    smem_bytes=smem, max_abs_err=err,
                    id_mismatch_not_tie=bad, id_mismatch_tie=ties)
        if dup:   # the planted twins must resolve to the smaller id
            twins = (ids % 3 == 1)[:, 1:] & (ids[:, 1:] - 1 != ids[:, :-1])
            line["twin_after_twin"] = not bool(twins.any())
            if twins.any():
                fail(f"{name}: a planted tie did not put the smaller id "
                     "first")
        print("compare", json.dumps(line), flush=True)
        report.append(line)
        if bad:
            fail(f"K3 {name}: {bad} id mismatches that are not near-ties")
    return err_max, report


# ------------------------------------------------------------ phase 3

def phase_serve(torch, port, cfg, rng, dev):
    from openrec_tpu_torch.metrics.ranking import (AUC, NDCG, Precision,
                                                   Recall, ids_to_masks)
    from openrec_tpu_torch.modules.embedding import embedding_lookup
    bt = port.ops.bucketed_topk
    users, items, dim = cfg["users"], cfg["items"], cfg["dim"]
    t0 = time.perf_counter()
    np_params = make_params(rng, users, items, dim)
    flat = port.convert.params_from_jax(np_params, device=dev)
    model = port.BPR(users, items, dim, dim, device=dev)
    model.load_params(flat)
    serve_dtype = getattr(torch, cfg["dtype"])
    scorer = port.CachedDotProductScorer(
        model, users, items,
        extract_user_vecs=lambda p, i: embedding_lookup(p["user_embed"], i),
        extract_item_vecs=lambda p, i: embedding_lookup(p["item_embed"], i),
        extract_item_bias=lambda p, i: embedding_lookup(p["item_bias"], i),
        serve_dtype=serve_dtype, device=dev)
    params = model.params()
    scorer.cache(params)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    requests = [rng.integers(0, users, BATCH).astype(np.int64)
                for _ in range(REQUESTS)]
    methods = METHODS

    bt.bucket_max_scores.launches = 0
    bt.bucket_max2_scores.launches = 0
    results = {m: [] for m in methods}
    for req in requests:
        for m in methods:
            results[m].append(_request(scorer, params, req, m))
            torch.cuda.synchronize()
    launches = {"K1": bt.bucket_max_scores.launches,
                "K2": bt.bucket_max2_scores.launches}
    if launches["K1"] != REQUESTS or launches["K2"] != REQUESTS:
        fail(f"{cfg['name']}: kernel launches {launches}, want "
             f"{REQUESTS} each")

    recall = {}
    for m in methods:
        hits = 0
        for req, (vals, ids), (_, ex_ids) in zip(requests, results[m],
                                                 results["exact"]):
            if tuple(vals.shape) != (BATCH, K) or not torch.isfinite(
                    vals).all():
                fail(f"{m}: bad output shape/values {tuple(vals.shape)}")
            if ids.min() < 0 or ids.max() >= items:
                fail(f"{m}: item id out of range")
            ref = scorer.serve(params, req).gather(1, ids.long())
            if not ((vals - ref).abs() <= TOL + TOL * ref.abs()).all():
                fail(f"{m}: a returned score is not the fp32 score at its "
                     "id")
            ex_sorted = torch.sort(ex_ids, dim=1).values
            found = torch.searchsorted(ex_sorted, ids.to(ex_sorted.dtype))
            found = found.clamp(max=K - 1)
            hits += int((ex_sorted.gather(1, found) == ids).sum())
        recall[m] = hits / (REQUESTS * BATCH * K)
        floor = TARGETS.get(m, 1.0) - 0.01
        print(f"{cfg['name']}: recall of {m} vs exact = {recall[m]:.6f} "
              f"(floor {floor:.3f})", flush=True)
        if recall[m] < floor:
            fail(f"{m}: recall {recall[m]} < {floor}")

    # one eval batch on numpy-made id lists, held against the dense
    # metrics on the same users
    B_eval, P, E, at = min(64, BATCH), 10, 20, (50, 100)
    uids = requests[0][:B_eval]
    pos = np.full((B_eval, P), -1, np.int64)
    excl = np.full((B_eval, E), -1, np.int64)
    for r in range(B_eval):
        n_pos = int(rng.integers(1, P + 1))
        picks = rng.choice(items, size=n_pos + E, replace=False)
        pos[r, :n_pos], excl[r] = picks[:n_pos], picks[n_pos:]
    got = scorer.eval_metrics(params, uids, pos, excl, at=at, chunk=16384)
    # dense scores from the same chunked matmuls as the eval path, so both
    # rank bit-identical scores
    u32 = flat["user_embed"][torch.as_tensor(uids, device=dev)]
    chunk = 16384
    pred = torch.cat([port.ops.topk.dot_scores(
        u32, flat["item_embed"][lo:lo + chunk],
        flat["item_bias"][lo:lo + chunk]) for lo in range(0, items, chunk)],
        dim=1)
    pm, em = ids_to_masks(torch.as_tensor(pos, device=dev),
                          torch.as_tensor(excl, device=dev), items)
    want = {"AUC": AUC(pm, pred, em), "Recall": Recall(pm, pred, em, at),
            "NDCG": NDCG(pm, pred, em, at),
            "Precision": Precision(pm, pred, em, at)}
    for key, w in want.items():
        g = got[key]
        if g.shape != w.shape or not torch.isfinite(g).all():
            fail(f"eval {key}: shape {tuple(g.shape)} or non-finite")
        if not torch.allclose(g, w, rtol=1e-5, atol=1e-6):
            fail(f"eval {key}: chunked {g} != dense {w}")
    print(f"{cfg['name']}: eval_metrics AUC mean "
          f"{got['AUC'].mean().item():.6f} matches the dense metrics",
          flush=True)
    latency = measure_requests(torch, scorer, params, rng, users)
    return {
        "config": {k: cfg[k] for k in ("users", "items", "dim", "dtype")},
        "setup_s": setup_s,
        "launches": launches,
        "recall_vs_exact": recall,
        "latency": latency,
        "profile": profile_requests(torch, scorer, params, rng, users,
                                    latency),
    }


def _request(scorer, params, req, method):
    return scorer.topk(params, req, k=K, method=method,
                       recall_target=TARGETS.get(method, 0.99))


def measure_requests(torch, scorer, params, rng, users):
    """Closed loop, one client: each request of BATCH random users is sent
    when the previous one has returned (synchronised). Median and p90 of
    TIMED requests after one warm-up (p90 then has 11 samples beyond
    it)."""
    out = {}
    for m in METHODS:
        ms = []
        for _ in range(TIMED + 1):
            req = rng.integers(0, users, BATCH)
            t = time.perf_counter()
            _request(scorer, params, req, m)
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t) * 1e3)
        ms = np.asarray(ms[1:])
        out[m] = {"n": len(ms), "p50_ms": float(np.median(ms)),
                  "p90_ms": float(np.percentile(ms, 90)),
                  "requests_per_s": float(1e3 / np.median(ms))}
    return out


def profile_requests(torch, scorer, params, rng, users, latency, n=5):
    """Device time per request by kernel over n requests under
    torch.profiler, and the device's idle share of the unprofiled median
    request time."""
    from torch.profiler import ProfilerActivity, profile
    out = {}
    for m in METHODS:
        reqs = [rng.integers(0, users, BATCH) for _ in range(n)]
        _request(scorer, params, reqs[0], m)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for req in reqs:
                _request(scorer, params, req, m)
                torch.cuda.synchronize()
        per = {}
        for e in prof.key_averages():
            if e.device_type == torch.autograd.DeviceType.CUDA:
                per[e.key] = per.get(e.key, 0.0) \
                    + e.self_device_time_total / 1e3 / n
        busy = sum(per.values())
        top = sorted(per.items(), key=lambda kv: -kv[1])[:6]
        out[m] = {"device_busy_ms": busy,
                  "idle_share": 1.0 - busy / latency[m]["p50_ms"],
                  "top_device_ms": {k[:80]: v for k, v in top}}
    return out


# ------------------------------------------------------------ phase 5

TRAIN = dict(dim=50, batch=1000, lr=1e-3, host_steps=400, host_k=100,
             eval_every=200, device_steps=400, device_k=200,
             timed_host_calls=5, timed_device_calls=5, profiled_calls=2)


def citeulike_data(loaders, seed):
    """synthetic_citeulike()'s records, users, sizes and 80/10/10 split,
    with every record's item redrawn from a long-tailed popularity
    p(rank r) ~ (r + 10)^-0.9 over a seeded permutation of the catalog.
    synthetic_citeulike() draws items uniformly and independently of
    users, so its val split holds nothing a model could learn and val AUC
    stays at 0.5 whatever the trainer does; real CiteULike's items are
    long-tailed, and BPR's unregularised item bias learns that."""
    raw = loaders.synthetic_citeulike(seed=seed)
    rng = np.random.default_rng(seed + 1)
    items = raw["total_items"]
    p = 1.0 / (np.arange(items) + 10.0) ** 0.9
    order = rng.permutation(items)
    for key in ("train_data", "val_data", "test_data"):
        data = raw[key].copy()
        data["item_id"] = order[rng.choice(items, len(data), p=p / p.sum())]
        raw[key] = data
    return raw


def profile_device(torch, fn, calls, wall_per_call_ms):
    """Device busy time per call by kernel over `calls` calls under
    torch.profiler, and the idle share of the unprofiled wall time."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    per, launches = {}, 0
    for e in prof.key_averages():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            per[e.key] = per.get(e.key, 0.0) \
                + e.self_device_time_total / 1e3 / calls
            launches += e.count
    busy = sum(per.values())
    top = sorted(per.items(), key=lambda kv: -kv[1])[:6]
    return {"device_busy_ms_per_call": busy,
            "device_ops_per_call": launches / calls,
            "idle_share": 1.0 - busy / wall_per_call_ms,
            "top_device_ms_per_call": {k[:80]: v for k, v in top}}


def timed_calls(torch, fn, calls):
    """Wall ms per call over `calls` synchronised calls after one warm-up."""
    fn()
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(calls):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t) * 1e3 / calls


def phase_train(torch, port, seed, dev):
    """The training path at full width, then retrieval through K3 from the
    restored tables. Returns the record; raises on any failed check."""
    from openrec_tpu_torch import checkpoint as ckpt_lib
    from openrec_tpu_torch.data import (Dataset, DevicePairwiseSampler,
                                        PairwiseSampler, loaders)
    from openrec_tpu_torch.ops import bucketed_topk as bt
    from openrec_tpu_torch.ops import topk as tk
    cfg = TRAIN
    counters = (bt.bucket_max_scores, bt.bucket_max2_scores,
                tk.fused_score_topk)
    for fn in counters:         # the path's run starts here
        fn.launches = 0
    raw = citeulike_data(loaders, seed)
    U, I, D = raw["total_users"], raw["total_items"], cfg["dim"]
    train_ds = Dataset(raw["train_data"], U, I, seed=seed)
    val_ds = Dataset(raw["val_data"], U, I, seed=seed)
    val = val_ds.evaluation(BATCH, excl_datasets=[train_ds],
                            device_masks=True)
    gen = torch.Generator(device=dev).manual_seed(seed)
    model = port.BPR(U, I, D, D, device=dev, generator=gen)
    out = {"config": {"users": U, "items": I, "dim": D,
                      "batch": cfg["batch"], "lr": cfg["lr"],
                      "optimizer": "lazy_adam",
                      "train_records": len(raw["train_data"])}}

    with tempfile.TemporaryDirectory() as ckpt_dir:
        log_file = Path(ckpt_dir) / "train.jsonl"
        trainer = port.Trainer(model, lr=cfg["lr"], seed=seed,
                               save_model_dir=ckpt_dir,
                               log_file=str(log_file), device=dev)
        auc0 = float(trainer.evaluate(val, at=(50, 100))["AUC"])

        def train(batches, steps, k, what):
            """Trainer.train with a val eval (and a checkpoint) every
            eval_every steps; returns the JSONL records it wrote."""
            done = len(log_file.read_text().splitlines()) \
                if log_file.exists() else 0
            trainer.train(steps, batches, eval_samplers={"val": val},
                          eval_interval=cfg["eval_every"],
                          save_interval=cfg["eval_every"],
                          steps_per_call=k, at=(50, 100), verbose=False)
            log = [json.loads(line) for line in
                   log_file.read_text().splitlines()[done:]]
            for rec in log:
                print(f"train {what}", json.dumps(rec), flush=True)
            losses = [rec["loss"] for rec in log]
            if len(losses) < 2 or not np.isfinite(losses).all() \
                    or not losses[-1] < losses[0]:
                fail(f"{what} loss did not fall: {losses}")
            return log

        log = train(train_ds.pairwise(batch_size=cfg["batch"],
                                      num_parallel_calls=2),
                    cfg["host_steps"], cfg["host_k"], "host-fed")
        auc = log[-1]["eval"]["val"]["AUC"]
        if not auc > auc0:
            fail(f"val AUC did not rise: {auc0} at step 0, {auc} at "
                 f"step {trainer.global_step}")
        out["host_fed"] = {"val_auc_step0": auc0, "log": log}

        # the checkpoint restored into a fresh model scores alike
        ckpt = ckpt_lib.latest_checkpoint(ckpt_dir)
        fresh = port.BPR(U, I, D, D, device=dev)
        restored = port.Trainer(fresh, seed=seed, save_model_dir=ckpt_dir,
                                device=dev)
        restored.restore(ckpt)
        users = torch.arange(0, U, 7, device=dev)
        with torch.no_grad():
            same = torch.equal(fresh.score({"user_id": users}),
                               model.score({"user_id": users}))
        if not same or int(restored.opt_state.count) != trainer.global_step:
            fail("the restored checkpoint does not score as the trained "
                 "model does")
        out["restore"] = {"checkpoint": Path(ckpt).name, "score_equal": same}

        # device-sampled training on the same trainer
        sampler = DevicePairwiseSampler(train_ds.store, cfg["batch"],
                                        device=dev)
        out["device_sampled"] = {
            "membership": sampler.membership,
            "log": train(sampler, cfg["device_steps"], cfg["device_k"],
                         "device-sampled")}

        # the share of sampled negatives that are positives
        stacked = sampler.sample_stacked(gen, cfg["device_k"])
        u_np = stacked["user_id"].cpu().numpy()
        n_np = stacked["n_item_id"].cpu().numpy()
        p_np = stacked["p_item_id"].cpu().numpy()
        store = train_ds.store
        density = len(store._pos_keys) / (U * I)
        bad = int(store.is_positive(u_np, n_np).sum())
        allowed = 10 * density ** (sampler.reject_rounds + 1) * n_np.size
        out["negatives"] = {"drawn": int(n_np.size), "positives": bad,
                            "density": density,
                            "allowed": allowed}
        if not store.is_positive(u_np, p_np).all() or bad > allowed:
            fail(f"sampled negatives: {bad} positives among {n_np.size}, "
                 f"allowed {allowed}")

        # 20 steps on the card == the same 20 steps on the CPU
        start = {k: v.detach().clone() for k, v in model.params().items()}
        batches = [s for s, _ in zip(PairwiseSampler(
            train_ds.store, cfg["batch"], seed=seed + 7), range(20))]
        cpu_model = port.BPR(U, I, D, D, device="cpu")
        cpu_model.load_params({k: v.cpu() for k, v in start.items()})
        card_model = port.BPR(U, I, D, D, device=dev)
        card_model.load_params(start)
        t_cpu = port.Trainer(cpu_model, lr=cfg["lr"], device="cpu")
        t_card = port.Trainer(card_model, lr=cfg["lr"], device=dev)
        l_cpu = t_cpu.train_step_multi(batches)
        l_card = t_card.train_step_multi(batches).cpu()
        worst = 0.0
        for key, p in cpu_model.params().items():
            q = card_model.params()[key].detach().cpu()
            worst = max(worst, (q - p.detach()).abs().max().item())
            if not torch.allclose(q, p.detach(), rtol=1e-4, atol=1e-6):
                fail(f"card and CPU disagree on '{key}' after 20 steps: "
                     f"max {worst}")
        if not torch.allclose(l_card, l_cpu, rtol=1e-4, atol=1e-6):
            fail("card and CPU losses disagree over 20 steps")
        out["card_vs_cpu"] = {"steps": 20, "max_abs_param_diff": worst}

        # retrieval through K3 from the restored tables
        table_u = fresh.user_embed.detach()
        table_v = fresh.item_embed.detach().contiguous()
        table_b = fresh.item_bias.detach().reshape(-1).contiguous()
        rng = np.random.default_rng(seed + 3)
        reqs = [torch.as_tensor(rng.integers(0, U, BATCH), device=dev)
                for _ in range(REQUESTS)]
        answers = [tk.fused_score_topk(table_u[r].contiguous(), table_v,
                                       table_b, K) for r in reqs]
        torch.cuda.synchronize()
        k3_launches = tk.fused_score_topk.launches
        checks = []
        for r, (vals, ids) in zip(reqs, answers):
            rows = table_u[r]
            want_v, want_i = tk.topk_xla(rows, table_v, table_b, K)
            full = tk.dot_scores(rows, table_v, table_b)
            checks.append(check_topk(torch, vals, ids, want_v, want_i, full,
                                     "retrieval"))
        bad = sum(c[1] for c in checks)
        out["retrieval"] = {"requests": REQUESTS, "users": BATCH, "k": K,
                            "k3_launches": k3_launches,
                            "max_abs_err": max(c[0] for c in checks),
                            "id_mismatch_not_tie": bad,
                            "id_mismatch_tie": sum(c[2] for c in checks)}
        print("retrieval", json.dumps(out["retrieval"]), flush=True)
        if k3_launches != REQUESTS or bad:
            fail(f"retrieval: K3 launches {k3_launches} (want {REQUESTS}), "
                 f"{bad} id mismatches that are not near-ties")

    # throughput of both feeds, then the device's idle share
    feed = train_ds.pairwise(batch_size=cfg["batch"], num_parallel_calls=2)
    host_it = iter(feed)

    def host_call():
        trainer.train_step_multi([next(host_it)
                                  for _ in range(cfg["host_k"])]).cpu()

    def device_call():
        trainer.train_steps_device(sampler, cfg["device_k"]).cpu()

    speed = {}
    for name, fn, k, calls in (
            ("host_fed", host_call, cfg["host_k"], cfg["timed_host_calls"]),
            ("device_sampled", device_call, cfg["device_k"],
             cfg["timed_device_calls"])):
        ms = timed_calls(torch, fn, calls)
        speed[name] = {"steps_per_call": k, "calls": calls,
                       "ms_per_call": ms,
                       "steps_per_s": k / ms * 1e3,
                       "examples_per_s": k * cfg["batch"] / ms * 1e3}
        speed[name]["profile"] = profile_device(
            torch, fn, cfg["profiled_calls"], ms)
        print(f"train {name}: {speed[name]['steps_per_s']:.1f} steps/s, "
              f"{speed[name]['examples_per_s']:.0f} examples/s, device "
              f"idle {speed[name]['profile']['idle_share']:.3f}", flush=True)
    feed.stop()
    out["speed"] = speed
    # ... and ends here: K3 ran on the 8 requests and nowhere else
    out["launches"] = dict(zip(("K1", "K2", "K3"),
                               (fn.launches for fn in counters)))
    if out["launches"] != {"K1": 0, "K2": 0, "K3": REQUESTS}:
        fail(f"training path launches {out['launches']}")
    return out


# ------------------------------------------------------------ phase 4

def nvidia_smi(query):
    return subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
        timeout=60).stdout.strip().splitlines()[0]


def time_ms(torch, fn, runs=30, warmup=3):
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    out = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        out.append(start.elapsed_time(end))
    return float(np.median(out))


def phase_time(torch, bt, gen, dev, errs, launches):
    B, I, D = BATCH, AMAZON["items"], AMAZON["dim"]
    u = (torch.rand(B, D, generator=gen, device=dev) * 0.1 - 0.05).to(
        torch.bfloat16)
    v = (torch.rand(I, D, generator=gen, device=dev) * 0.1 - 0.05).to(
        torch.bfloat16)
    b = torch.randn(I, generator=gen, device=dev) * 0.01
    entries = []
    for kname, func, top2, bucket, line, fn_name in (
            ("K1", bt.bucket_max_scores, False, 64, 68,
             "_bucket_max_kernel"),
            ("K2", bt.bucket_max2_scores, True, 256, 143,
             "_bucket_max2_kernel")):
        bucket, _, L = bt.bucket_geometry(I, D, 2, bucket)
        ms = time_ms(torch, lambda: func(u, v, b, bucket=bucket))
        plain_ms = time_ms(torch, lambda: bt.bucket_max_plain(
            u, v, b, bucket, top2=top2), runs=20)
        clocks = nvidia_smi("clocks.sm,power.draw,temperature.gpu")
        library_ms = time_ms(torch, lambda: torch.topk(
            torch.matmul(u, v.T), K, dim=1))
        nbytes = (B * D + I * D) * 2 + I * 4 + B * L * (16 if top2 else 8)
        ops = 2.0 * B * I * D
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = ops / PEAK_OPS["bfloat16"] * 1e3
        entries.append({
            "name": f"{kname} bucket_max_kernel<top{2 if top2 else 1}>",
            "route": "cuda",
            "source": "openrec_tpu_torch/csrc/bucket_max.cu",
            "replaces": f"openrec_tpu/ops/bucketed_topk.py:{line}",
            "replaces_function": fn_name,
            "launches": launches[kname],
            "max_abs_err": errs[kname],
            "ms": ms, "plain_ms": plain_ms,
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": library_ms,
            # SM clock, power draw and temperature right after the timing
            "card_after_timing": clocks,
            "shape": {"B": B, "I": I, "D": D, "dtype": "bfloat16",
                      "bucket": bucket, "L": L, "k": K},
        })
    return entries


def time_k3(torch, tk, gen, dev, B, I, D, dtype):
    """K3 at one shape: kernel, plain version and library yardstick times
    (CUDA-event medians) and the bound for this shape."""
    dt = getattr(torch, dtype)
    u = (torch.rand(B, D, generator=gen, device=dev) * 0.1 - 0.05).to(dt)
    v = (torch.rand(I, D, generator=gen, device=dev) * 0.1 - 0.05).to(dt)
    b = torch.randn(I, generator=gen, device=dev) * 0.01
    ms = time_ms(torch, lambda: tk.fused_score_topk(u, v, b, K))
    plain_ms = time_ms(torch, lambda: tk.fused_topk_plain(u, v, b, K),
                       runs=5, warmup=1)
    clocks = nvidia_smi("clocks.sm,power.draw,temperature.gpu")
    library_ms = time_ms(torch, lambda: torch.topk(
        torch.matmul(u, v.T) + b, K, dim=1))
    # u and V read once in their type, the f32 bias once, the [B, k] f32
    # values and i32 ids written once; 2*B*I*D dot-product operations
    nbytes = (B * D + I * D) * u.element_size() + 4 * I + 8 * B * K
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = 2.0 * B * I * D / PEAK_OPS[dtype] * 1e3
    Kb, G, n_slices, tps, smem = tk.fused_geometry(
        B, I, D, K, torch.cuda.get_device_properties(dev)
        .multi_processor_count)
    return {"ms": ms, "plain_ms": plain_ms,
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": library_ms, "card_after_timing": clocks,
            "shape": {"B": B, "I": I, "D": D, "dtype": dtype, "k": K,
                      "Kb": Kb, "users_per_block": G, "slices": n_slices,
                      "tiles_per_slice": tps, "smem_bytes": smem}}


def phase_time_k3(torch, tk, gen, dev, err):
    """K3's entry of the kernels line: its numbers at the CiteULike
    retrieval shape of phase 5 (fp32 tables), with the Amazon serving
    shape (bf16) beside them. `launches` is filled in by phase 5."""
    entry = {"name": "K3 fused_topk_kernel", "route": "cuda",
             "source": "openrec_tpu_torch/csrc/fused_topk.cu",
             "replaces": "openrec_tpu/ops/topk.py:58",
             "replaces_function": "_fused_topk_kernel",
             "launches": None, "max_abs_err": err}
    entry.update(time_k3(torch, tk, gen, dev, BATCH, CITEULIKE["items"],
                         CITEULIKE["dim"], "float32"))
    entry["amazon"] = time_k3(torch, tk, gen, dev, BATCH, AMAZON["items"],
                              AMAZON["dim"], "bfloat16")
    # the same dot products with 32-entry lists (k = 1): what the list
    # merges of k = 100 add to the kernel's time
    u = torch.rand(BATCH, AMAZON["dim"], generator=gen, device=dev).to(
        torch.bfloat16)
    v = torch.rand(AMAZON["items"], AMAZON["dim"], generator=gen,
                   device=dev).to(torch.bfloat16)
    entry["amazon"]["ms_at_k1"] = time_ms(
        torch, lambda: tk.fused_score_topk(u, v, None, 1))
    return entry


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", type=Path, default=None,
                    help="write the full record here as JSON")
    args = ap.parse_args(argv)

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run",
              file=sys.stderr)
        return 2
    if not (ROOT / "openrec_tpu_torch" / "csrc").is_dir():
        print(f"chip_smoke: {ROOT} holds no openrec_tpu_torch package",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    import openrec_tpu_torch as port
    from openrec_tpu_torch.ops import _build
    from openrec_tpu_torch.ops import bucketed_topk as bt
    from openrec_tpu_torch.ops import topk as tk

    # fp32 products stay fp32: no TF32 anywhere
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)

    # phase 1
    smi = nvidia_smi("name,power.limit")
    print(smi, flush=True)
    t = time.perf_counter()
    logs = _build.build_all()
    build_s = time.perf_counter() - t
    print(f"build: {build_s:.1f} s for {sorted(logs) or 'nothing (cached)'}",
          flush=True)
    for name, text in logs.items():
        for ln in text.splitlines():
            if "registers" in ln or "spill" in ln:
                print(f"ptxas {name}: {ln.strip()}", flush=True)

    gen = torch.Generator(device=dev).manual_seed(args.seed)
    rng = np.random.default_rng(args.seed)

    # phase 2
    errs, compare_report = phase_compare(torch, bt, gen, dev)
    errs["K3"], k3_report = phase_compare_k3(torch, tk, gen, dev)
    compare_report += k3_report
    torch.cuda.empty_cache()

    # phase 3
    serve = {}
    for cfg in (AMAZON, CITEULIKE):
        serve[cfg["name"]] = phase_serve(torch, port, cfg, rng, dev)
        torch.cuda.empty_cache()

    # phase 4
    kernels = phase_time(torch, bt, gen, dev, errs,
                         serve["amazon"]["launches"])
    kernels.append(phase_time_k3(torch, tk, gen, dev, errs["K3"]))
    torch.cuda.empty_cache()

    # phase 5
    train = phase_train(torch, port, args.seed, dev)
    kernels[-1]["launches"] = train["launches"]["K3"]

    if args.out is not None:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps(
            {"card": smi, "build_s": build_s, "compare": compare_report,
             "serve": serve, "training": train, "kernels": kernels},
            indent=1))
    print(json.dumps({"requests": {name: {
        "latency": s["latency"], "recall_vs_exact": s["recall_vs_exact"],
        "launches": s["launches"]} for name, s in serve.items()}}))
    print(json.dumps({"training": {
        "val_auc_step0": train["host_fed"]["val_auc_step0"],
        "val_auc": train["host_fed"]["log"][-1]["eval"]["val"]["AUC"],
        "val_auc_device_sampled":
            train["device_sampled"]["log"][-1]["eval"]["val"]["AUC"],
        "speed": {k: {m: v[m] for m in ("steps_per_s", "examples_per_s")}
                  | {"idle_share": v["profile"]["idle_share"]}
                  for k, v in train["speed"].items()},
        "retrieval": train["retrieval"]}}))
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
