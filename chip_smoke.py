#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA GPU (written for the H100).

    python3 chip_smoke.py               # every phase, from the repo root
    python3 chip_smoke.py --phases 1,2  # build and compare the kernels
    python3 chip_smoke.py --phases 1,2,4    # ... and time them

Phases, in order (`--phases` picks some; phase 1 always runs); any
failure raises and exits non-zero:
  1. print the card's name and power limit; build the CUDA kernels from
     openrec_tpu_torch/csrc with nvcc, one process per source, all at once
     (set-up time, printed).
  2. hold each kernel against its plain PyTorch version on the card: for
     K1/K2 (`K1K2_CASES`; bf16 runs the tensor-core route, f32 the
     CUDA-core route) f32 and bf16, D in {50, 60, 64, 384}, a ragged
     catalog tail, bucket = 1, a split bucket range, B = 37, tables whose
     rows start 8-, 4- or 2-byte aligned (views into their storage), twin
     bucket members (exact ties: slot 1 keeps the earlier, K2's slot 2 the
     twin), no bias, and the serving shapes; for K3 k in {1, 100,
     128, 129, 1000}, k == I on a 300-item catalog, B and I off the
     kernel's tiling, duplicated item rows (exact ties), tables that do not
     start on a 16-byte boundary, all-equal scores (K3's rescan branch),
     a catalog of fewer than 8*Kb items, and both serving shapes. Values
     within rtol=atol=1e-5; an id may differ only where the two picks
     score within that tolerance (a different summation order); K2's
     second slot as id sets. Every user must have at least min(k, I) K3
     candidates.
  3. the serving path at full width: BPR at the Amazon catalog of
     examples/serving_retrieval.py (99,473 users x 450,166 items x 64,
     bf16 serve tables) with random weights made from --seed by numpy and
     loaded through convert.params_from_jax, then 8 requests of 256 users
     with top-100 by 'pallas' (recall target 0.99), 'pallas2' (0.995),
     'exact' and 'approx'. Every returned score must equal the fp32 score
     at its id, recall against 'exact' must reach the target less 0.01,
     K1's and K2's launch counters must read one a request and K3's 0
     (the Amazon entry of the kernels line reports that count), and one
     eval_metrics batch must match the dense metrics. Then the same at the BPR-CiteULike shape
     of bench.py (5,551 x 16,980 x 50, fp32 tables).
  4. time each kernel with CUDA events (median of 30 after warm-up) beside
     its plain version, a library yardstick (torch.matmul + torch.topk,
     which the port never calls) and its bound (bytes at 3.35 TB/s,
     operations at the peak for the input type), with its device time by
     kernel under torch.profiler: K1/K2 at the Amazon serving shape (bf16)
     and at the CiteULike shape (fp32), each at the bucket its method
     picks there, K3 at the CiteULike retrieval shape of phase 5 and at
     the Amazon shape, each of K3's four launches (K1 bound pass, tau,
     filter, final) on its own too.
  5. the training path at full width: BPR 5,551 x 16,980 x dim 50, batch
     1000, lazy_adam at lr 1e-3 on the card, on synthetic_citeulike()'s
     records with each item redrawn from a long-tailed popularity (see
     `citeulike_data`). Trainer.train, with val eval and a checkpoint every
     200 steps: host-fed (Dataset.pairwise, 2 threads, 100 steps a call,
     which must run the C++ sampler feeder, the JAX package's default),
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

  6. the DLRM-Criteo flagship. (a) The flagship layout of
     __graft_entry__._flagship() (20 x 1,000 + 6 x 100,000 rows, m_spa 16,
     bottom MLP 64-16, top 128-64-1, BCE, batch 256): one seeded
     torch.Generator's weights on the card and copied to the CPU; forward
     predictions with separate and fused tables, then 20 sparse steps of
     the fused model through Trainer(sparse_tables=...), card against CPU
     at rtol 1e-4, atol 1e-6. (b) Full Criteo-Kaggle width
     (benchmarks/dlrm_throughput.py: 33,762,577 rows in 26 tables, m_spa
     16, bottom 512-256-64-16, top 512-256-1, batch 4096, lr 1e-3) on
     synthetic_criteo(1,000,000 records): the fused sparse step, host-fed
     from ShuffledArrayLoader (10 warm-up, 300 timed and 5 profiled steps),
     with val AUC on 8,192 val records before and after; then the dense
     path (separate tables, lazy_adam, 20 timed steps). Per path: wall
     ms/step, examples/s, device busy ms and idle share (torch.profiler),
     peak memory. Checks: the loss falls and val AUC rises on the sparse
     path, no value is NaN, 10,000 sampled rows of the fused table that no
     batch touched are bit-identical afterwards, and a bf16 forward is
     within 2e-2 of the fp32 one.

  7. the rest of the tf2 zoo (PMF, WRMF, GMF, UCML) at phase 5's width,
     data and optimizer (dim 50, batch 1000, lazy_adam lr 1e-3): 300
     host-fed steps each through Trainer.train, 100 a call (PMF, WRMF, GMF
     on Dataset.stratified_pointwise with pos_ratio 0.2, UCML on
     Dataset.pairwise with margin 0.5; the C++ feeder in both), then 200
     device-sampled WRMF steps (DevicePointwiseSampler). Per model and
     feed: steps/s, examples/s, device busy ms per call and idle share
     (torch.profiler, one call), val AUC and Recall@50 at step 0 and at
     the end (both must rise), peak memory; UCML's touched rows must lie
     in the unit ball (1 + 1e-4). 20 steps card against CPU from the same
     weights (rtol 1e-4, atol 1e-6). Then each model's trained tables
     answer 8 requests of 256 users, top-100, through the scorer's
     'exact', 'pallas' and 'pallas2' with extractors u (GMF u * w; UCML
     2u), v and b (UCML b - ||v||^2), and through K3: every score the fp32
     score at its id, K3's ids those of torch.topk of model.score but for
     near-ties; recall below target - 0.01 is printed as a finding. K1,
     K2 and K3 count their launches over the phase.

  8. the multi-negative, NCF and content models at phase 5's width, data
     and optimizer (batch 1000, lazy_adam lr 1e-3), 300 host-fed steps
     each through Trainer.train, 100 a call, val eval every call: NBPR
     and WCML (dim 50, margin 0.5) on Dataset.n_pairwise (K = 5, the
     numpy sampler, 2 workers); MLPRec (32 + 32, MLP 64-32-1, dropout
     0.2), NeuMF (GE 32, MLP 32, 64-32-1, alpha 0.5, dropout 0.2) and CDL
     (dim 50, SDAE 8,000-200-50, dropout 0.1, a 1, b 0.01, l2_reconst
     0.1) on Dataset.stratified_pointwise(pos_ratio=0.2) (C++ feeder);
     CDL's items carry a synthetic binary bag of words (16,980 x 8,000
     fp32, 1 % dense, from --seed). Checks: every loss finite, the mean
     loss of the last 100 steps below the first 100's, val AUC and
     Recall@50 above their step-0 values, MLPRec's and NeuMF's numpy
     EvalManager AUC (full mode) too, CDL's reconstruction loss falling,
     WCML's touched rows in the unit ball (1 + 1e-4), 20 steps card
     against CPU with dropout off (rtol 1e-4, atol 1e-6; fp32, and for
     CDL fp64, its fp32 difference recorded). NBPR (u, v, b), WCML (2u,
     v, b - ||v||^2) and CDL (u, item_embed + enc(features), b) then
     serve as phase 7's models do; MLPRec and NeuMF answer 8 requests
     by model.score + torch.topk, their full-catalog score at sampled
     pairs equal to the training logit (rtol 1e-4, atol 1e-6). Per
     model: steps/s, examples/s, device busy ms and launches per step
     and the idle share (torch.profiler over one 10-step call), peak
     memory, seconds by part.

After the checks, each serving shape also times 110 requests per method
(closed loop, one client: median and p90) and profiles 5 more with
torch.profiler (device time by kernel, idle share).

Prints a {"requests": ...} line with the serving latencies, a
{"training": ...} line, a {"dlrm": ...} line, a {"zoo": ...} line, a
{"legacy": ...} line, a {"kernels": [...]} line (K1, K2, K3; `launches`
from the serving path for K1/K2 and the training path for K3,
`launches_zoo` from phase 7, `launches_legacy` from phase 8), and last
the line {"ok": true, "device": {"platform": "gpu", "kind": ...,
"count": ...}}; a phase that did not run prints nothing, and the fields
it fills stay null. With --out FILE, the full record (every check, latency,
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
F32_VARIANT = "fma-f32-cp.async"      # K1/K2's fp32 route
PHASES = range(1, 9)


def fail(msg):
    raise RuntimeError(msg)


def kernel_name(symbol):
    """'bucket_max_f32_kernel<Lb1>' from a mangled kernel symbol such as
    _ZN12_GLOBAL__N_121bucket_max_f32_kernelILb1EEEv...: the last name of
    the nested name and its raw template arguments."""
    i, name = (3 if symbol.startswith("_ZN") else 2), symbol
    while i < len(symbol) and symbol[i].isdigit():
        j = i
        while symbol[j].isdigit():
            j += 1
        name, i = symbol[j:j + int(symbol[i:j])], j + int(symbol[i:j])
    if symbol[i:i + 1] == "I":
        name += "<" + symbol[i + 1:symbol.index("E", i)] + ">"
    return name


def near(x, y):
    """x equals y within rtol = atol = TOL (elementwise, tensors)."""
    return (x - y).abs() <= TOL + TOL * y.abs()


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


K1K2_CASES = [
    # name, B, I, D, dtype, bucket, layout: "" | "row" (the table is a view
    # one row into its storage: bf16 D = 60 rows of 120 bytes and f32 D =
    # 50 rows of 200 bytes start 8-byte aligned) | "element" (a view one
    # element in: 2-byte aligned bf16 rows, 4-byte aligned f32 rows) |
    # "twins" (member 2m+1 of every bucket repeats member 2m, bias and all:
    # exact ties inside a bucket, where slot 1 must keep the earlier member)
    # | "nobias" (item_bias None)
    ("f32 D=50 ragged", 37, 5_000, 50, "float32", 4, ""),
    ("bf16 D=64", 70, 20_000, 64, "bfloat16", 16, ""),
    ("bf16 bucket=1", 9, 1_000, 64, "bfloat16", 1, ""),
    ("f32 split", 64, 30_000, 64, "float32", 64, ""),
    ("bf16 D=50 (Dp 64, 100-byte rows)", 64, 20_001, 50, "bfloat16", 16, ""),
    ("bf16 D=60 view one row in", 50, 9_999, 60, "bfloat16", 8, "row"),
    ("bf16 D=64 view one element in", 20, 5_000, 64, "bfloat16", 4,
     "element"),
    ("bf16 D=64 twin members", 40, 30_000, 64, "bfloat16", 16, "twins"),
    ("bf16 B=37", 37, 10_000, 64, "bfloat16", 8, ""),
    # the fp32 route's cp.async ring: ties across slots, every view, no
    # bias, one slot at D = 384 reused by 8 members, one member a block
    ("f32 twin members", 40, 30_000, 50, "float32", 16, "twins"),
    ("f32 D=50 view one row in", 50, 9_999, 50, "float32", 8, "row"),
    ("f32 view one element in", 20, 5_000, 64, "float32", 4, "element"),
    ("f32 no bias", 256, 30_000, 50, "float32", 64, "nobias"),
    ("f32 D=384", 256, 20_000, 384, "float32", 16, ""),
    ("f32 bucket=1", 9, 1_000, 50, "float32", 1, ""),
    ("amazon K1 shape", BATCH, AMAZON["items"], 64, "bfloat16", 64, ""),
    ("amazon K2 shape", BATCH, AMAZON["items"], 64, "bfloat16", 256, ""),
    # the buckets `pallas` (K1) and `pallas2` (K2) pick at CiteULike
    ("citeulike K1 shape", BATCH, CITEULIKE["items"], 50, "float32", 2, ""),
    ("citeulike K2 shape", BATCH, CITEULIKE["items"], 50, "float32", 16, ""),
]


def k1k2_inputs(torch, bt, gen, dev, B, I, D, dtype, bucket, layout):
    """(u, v, b) on the card for one K1/K2 case, laid out as it says."""
    dt = getattr(torch, dtype)
    u = torch.randn(B, D, generator=gen, device=dev).to(dt)
    v = torch.randn(I, D, generator=gen, device=dev)
    b = torch.randn(I, generator=gen, device=dev)
    if layout == "twins":
        blk = 128 * bt.bucket_geometry(I, D, torch.finfo(dt).bits // 8,
                                       bucket)[0]
        t = torch.arange(I, device=dev)
        odd = ((t % blk) // 128) % 2 == 1
        v[odd] = v[t[odd] - 128]
        b[odd] = b[t[odd] - 128]
    v = v.to(dt)
    if layout == "row":
        v = torch.cat([v[:1], v])[1:]
    elif layout == "element":
        flat = torch.empty(I * D + 1, device=dev, dtype=dt)
        flat[1:] = v.reshape(-1)
        v = flat[1:].view(I, D)
    if layout in ("row", "element") and v.data_ptr() % 16 == 0:
        fail(f"{layout} view is 16-byte aligned")
    return u, v, None if layout == "nobias" else b


def phase_compare(torch, bt, gen, dev):
    errs = {"K1": 0.0, "K2": 0.0}
    report = []
    for name, B, I, D, dtype, bucket, layout in K1K2_CASES:
        u, v, b = k1k2_inputs(torch, bt, gen, dev, B, I, D, dtype, bucket,
                              layout)
        for kname, top2 in (("K1", False), ("K2", True)):
            err, bad, ties = compare_kernel(torch, bt, u, v, b, bucket, top2)
            errs[kname] = max(errs[kname], err)
            line = dict(case=name, kernel=kname, B=B, I=I, D=D, dtype=dtype,
                        bucket=bucket,
                        route="mma-bf16" if dtype == "bfloat16"
                        else F32_VARIANT,
                        row_address_mod_16=v.data_ptr() % 16,
                        max_abs_err=err, id_mismatch_not_tie=bad,
                        id_mismatch_tie=ties)
            if layout == "twins":
                line["twins_earliest"] = check_twins(torch, bt, u, v, b,
                                                     bucket, top2, name)
            print("compare", json.dumps(line), flush=True)
            report.append(line)
            if bad:
                fail(f"{kname} {name}: {bad} id mismatches that are not "
                     "near-ties")
    return errs, report


def check_twins(torch, bt, u, v, b, bucket, top2, name):
    """With member 2m+1 a copy of member 2m, slot 1 must name the even
    member of its pair (the earlier one, strict `>`), and K2's slot 2 its
    twin, at the same value."""
    out = (bt.bucket_max2_scores if top2 else bt.bucket_max_scores)(
        u, v, b, bucket=bucket)
    torch.cuda.synchronize()
    blk = 128 * bucket_of(bt, v, bucket)
    v1, i1 = out[0], out[1].long()
    real = v1 > -1e29
    if (((i1 % blk) // 128 % 2 == 1) & real).any():
        fail(f"{name}: slot 1 kept the later twin of a tie")
    if top2:
        v2, i2 = out[2], out[3].long()
        has = real & (i1 + 128 < v.shape[0])
        if not ((i2 == i1 + 128) & (v2 == v1))[has].all():
            fail(f"{name}: slot 2 is not the twin of slot 1")
    return True


K3_CASES = [
    # name, B, I, D, dtype, k, layout: "" | "dup" (item 3j+1 repeats item
    # 3j: exact ties) | "offset" (the table is a view one row into its
    # storage, so it does not start on a 16-byte boundary) | "zero" (zero
    # table and bias: all scores equal, so more than C candidates pass and
    # the final kernel rescans; the answer is ids 0 .. k-1)
    ("K3 f32 D=50 k=100 ragged", 37, 5_003, 50, "float32", 100, ""),
    ("K3 bf16 D=64 k=1", 70, 20_001, 64, "bfloat16", 1, ""),
    ("K3 f32 D=64 k=128", 33, 12_345, 64, "float32", 128, ""),
    ("K3 bf16 D=50 k=129", 9, 7_777, 50, "bfloat16", 129, ""),
    ("K3 f32 D=64 k=1000", 70, 30_000, 64, "float32", 1000, ""),
    ("K3 f32 D=50 k==I", 11, 300, 50, "float32", 300, ""),
    ("K3 bf16 D=64 duplicated rows", 40, 9_000, 64, "bfloat16", 100, "dup"),
    ("K3 f32 D=50 offset view", 20, 3_001, 50, "float32", 100, "offset"),
    ("K3 bf16 D=50 offset view", 20, 3_001, 50, "bfloat16", 100, "offset"),
    ("K3 f32 D=50 all-equal scores", 30, 5_000, 50, "float32", 100, "zero"),
    ("K3 bf16 D=64 I < 8*Kb", 25, 700, 64, "bfloat16", 100, ""),
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
        if layout == "zero":
            v.zero_()
            b.zero_()
        v = v.to(dtype).contiguous()
        if layout == "offset":
            v = torch.cat([v[:1], v])[1:]
            if v.data_ptr() % 16 == 0:
                fail(f"{name}: the view is 16-byte aligned")
        want_v, want_i = tk.fused_topk_plain(u, v, b, k)
        vals, ids = tk.fused_score_topk(u, v, b, k)
        torch.cuda.synchronize()
        count = tk.fused_score_topk.last_count
        full = tk.dot_scores(u, v, b)
        err, bad, ties = check_topk(torch, vals, ids, want_v, want_i, full,
                                    name)
        err_max = max(err_max, err)
        plan = tk.fused_geometry(
            B, I, D, k, v.element_size(),
            torch.cuda.get_device_properties(dev).multi_processor_count)
        line = dict(case=name, kernel="K3", B=B, I=I, D=D, dtype=dt, k=k,
                    **plan._asdict(), count_min=int(count.min()),
                    count_max=int(count.max()),
                    rescan_users=int((count > plan.C).sum()),
                    max_abs_err=err, id_mismatch_not_tie=bad,
                    id_mismatch_tie=ties)
        if line["count_min"] < min(k, I):
            fail(f"{name}: a user has {line['count_min']} candidates, fewer "
                 f"than min(k, I) = {min(k, I)}")
        if layout == "zero" and (line["rescan_users"] != B or not torch.equal(
                ids, torch.arange(k, device=dev, dtype=ids.dtype)
                .expand(B, -1))):
            fail(f"{name}: not every user took the rescan branch and "
                 "returned ids 0 .. k-1")
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

    k3 = port.ops.topk.fused_score_topk
    bt.bucket_max_scores.launches = 0
    bt.bucket_max2_scores.launches = 0
    k3.launches = 0
    results = {m: [] for m in methods}
    for req in requests:
        for m in methods:
            results[m].append(_request(scorer, params, req, m))
            torch.cuda.synchronize()
    launches = {"K1": bt.bucket_max_scores.launches,
                "K2": bt.bucket_max2_scores.launches,
                "K3": k3.launches}
    # serving answers through K1/K2; K3 is the training path's retrieval
    if launches != {"K1": REQUESTS, "K2": REQUESTS, "K3": 0}:
        fail(f"{cfg['name']}: kernel launches {launches}, want "
             f"{REQUESTS} of K1 and K2 each and none of K3")

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

        host_feed = train_ds.pairwise(batch_size=cfg["batch"],
                                      num_parallel_calls=2)
        # the host feed is the JAX package's default: the C++ feeder
        if not host_feed._sampler.use_native:
            fail("the host-fed feed did not take the native sampler")
        log = train(host_feed, cfg["host_steps"], cfg["host_k"], "host-fed")
        auc = log[-1]["eval"]["val"]["AUC"]
        if not auc > auc0:
            fail(f"val AUC did not rise: {auc0} at step 0, {auc} at "
                 f"step {trainer.global_step}")
        out["host_fed"] = {"val_auc_step0": auc0, "use_native": True,
                           "log": log}

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
    if not feed._sampler.use_native:
        fail("the timed host feed did not take the native sampler")
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
        print(f"train {name}"
              f"{' (native sampler)' if name == 'host_fed' else ''}: "
              f"{speed[name]['steps_per_s']:.1f} steps/s, "
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


# ------------------------------------------------------------ phase 6

# Criteo Kaggle's per-table cardinalities (benchmarks/dlrm_throughput.py:
# 25-27, the facebookresearch/dlrm counts): 33,762,577 rows in 26 tables
CRITEO_COUNTS = (1460, 583, 10131227, 2202608, 305, 24, 12517, 633, 3,
                 93145, 5683, 8351593, 3194, 27, 14992, 5461306, 10, 5652,
                 2173, 4, 7046547, 18, 15, 286181, 105, 142572)
# __graft_entry__._flagship(): the downscaled Criteo-like layout
FLAGSHIP = dict(m_spa=16, ln_emb=(1000,) * 20 + (100000,) * 6,
                ln_bot=(64, 16), ln_top=(128, 64, 1), dim_dense=13,
                loss_func="bce")
# benchmarks/dlrm_throughput.py:52-53: full Criteo-Kaggle width
KAGGLE = dict(m_spa=16, ln_emb=CRITEO_COUNTS, ln_bot=(512, 256, 64, 16),
              ln_top=(512, 256, 1), dim_dense=13, loss_func="bce")
DLRM_RUN = dict(flagship_batch=256, flagship_steps=20, batch=4096, lr=1e-3,
                records=1_000_000, val=8192, warmup_steps=10,
                sparse_steps=300, dense_steps=20, profiled_steps=5,
                untouched_sample=10_000)


def roc_auc(pred, label):
    """Binary ROC AUC by the rank sum, ties at their mean rank."""
    pred, label = np.asarray(pred, np.float64), np.asarray(label) > 0.5
    _, inv, counts = np.unique(pred, return_inverse=True, return_counts=True)
    ranks = (np.cumsum(counts) - (counts - 1) / 2.0)[inv]
    n_pos = label.sum()
    n_neg = len(label) - n_pos
    return float((ranks[label].sum() - n_pos * (n_pos + 1) / 2.0)
                 / (n_pos * n_neg))


def dlrm_batch(rng, cfg, B):
    return {"dense_features": rng.normal(size=(B, cfg["dim_dense"])).astype(
                np.float32),
            "sparse_features": np.stack(
                [rng.integers(0, c, B) for c in cfg["ln_emb"]],
                axis=1).astype(np.int32),
            "label": rng.integers(0, 2, B).astype(np.float32)}


def fused_params(torch, model):
    """A separate-tables DLRM's parameters with the tables stacked as one
    `embed_fused`, for a fused model holding the same weights."""
    flat = {k: v.detach() for k, v in model.params().items()
            if not k.startswith("embed_tables/")}
    flat["embed_fused"] = torch.cat([t.detach() for t in model.embed_tables])
    return flat


def dlrm_card_vs_cpu(torch, port, seed, dev, cfg, run):
    """The flagship's forward (separate and fused tables) and 20 sparse
    steps of the fused model on the card against the same on the CPU,
    from the same weights (rtol 1e-4, atol 1e-6)."""
    from openrec_tpu_torch.training.sparse import dlrm_fused_table_spec
    gen = torch.Generator(device=dev).manual_seed(seed)
    card = {"separate": port.DLRM(**cfg, device=dev, generator=gen)}
    cpu = {"separate": port.DLRM(**cfg, device="cpu")}
    cpu["separate"].load_params({k: v.detach().cpu() for k, v in
                                 card["separate"].params().items()})
    card["fused"] = port.DLRM(**cfg, fused_tables=True, device=dev)
    card["fused"].load_params(fused_params(torch, card["separate"]))
    cpu["fused"] = port.DLRM(**cfg, fused_tables=True, device="cpu")
    cpu["fused"].load_params(fused_params(torch, cpu["separate"]))
    rng = np.random.default_rng(seed + 11)
    B = run["flagship_batch"]
    batch = dlrm_batch(rng, cfg, B)
    out = {"batch": B, "tables": len(cfg["ln_emb"]),
           "rows": int(sum(cfg["ln_emb"]))}
    for layout in ("separate", "fused"):
        with torch.no_grad():
            p_card = card[layout].score(batch).cpu()
            p_cpu = cpu[layout].score(batch)
        if p_card.shape != (B,) or not torch.isfinite(p_card).all() \
                or not torch.allclose(p_card, p_cpu, rtol=1e-4, atol=1e-6):
            fail(f"dlrm flagship forward ({layout}): card and CPU disagree, "
                 f"max {(p_card - p_cpu).abs().max().item()}")
        out[f"forward_max_abs_diff_{layout}"] = \
            (p_card - p_cpu).abs().max().item()
    batches = [dlrm_batch(rng, cfg, B) for _ in range(run["flagship_steps"])]
    losses = {}
    for where, model, d in (("card", card["fused"], dev),
                            ("cpu", cpu["fused"], "cpu")):
        trainer = port.Trainer(model, lr=run["lr"], device=d,
                               sparse_tables=dlrm_fused_table_spec(model))
        losses[where] = trainer.train_step_multi(batches).cpu()
    worst = 0.0
    for key, p in cpu["fused"].params().items():
        q = card["fused"].params()[key].detach().cpu()
        worst = max(worst, (q - p.detach()).abs().max().item())
        if not torch.allclose(q, p.detach(), rtol=1e-4, atol=1e-6):
            fail(f"dlrm flagship: card and CPU disagree on '{key}' after "
                 f"{len(batches)} sparse steps: max {worst}")
    if not torch.allclose(losses["card"], losses["cpu"], rtol=1e-4,
                          atol=1e-6):
        fail("dlrm flagship: card and CPU losses disagree")
    out.update({"sparse_steps": len(batches), "max_abs_param_diff": worst,
                "max_abs_loss_diff":
                    (losses["card"] - losses["cpu"]).abs().max().item()})
    return out


def criteo_arrays(raw, split, n=None):
    sl = slice(0, n)
    return {"dense_features": raw[f"X_int_{split}"][sl],
            "sparse_features": raw[f"X_cat_{split}"][sl],
            "label": raw[f"y_{split}"][sl]}


def dlrm_val_auc(torch, model, val):
    with torch.no_grad():
        pred = model.score(val).cpu().numpy()
    if not np.isfinite(pred).all():
        fail("dlrm: non-finite val predictions")
    return roc_auc(pred, val["label"]), pred


def run_steps(torch, trainer, batches):
    """Trainer.train_step over host batches; the losses stay on the card
    until the end. Returns (losses [n], wall ms per step)."""
    torch.cuda.synchronize()
    t = time.perf_counter()
    losses = [trainer.train_step(b)[0] for b in batches]
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t) * 1e3 / len(batches)
    return torch.stack(losses).cpu().numpy(), ms


def dlrm_path(torch, trainer, batches, run, what):
    """Warm-up, timed and profiled host-fed steps of one training path:
    wall ms/step, examples/s, device busy and idle share, and the peak
    memory since the path's model was made."""
    nw, nt = run["warmup_steps"], run[f"{what}_steps"]
    run_steps(torch, trainer, batches[:nw])
    losses, ms = run_steps(torch, trainer, batches[nw:nw + nt])
    prof_it = iter(batches[nw + nt:])
    profile = profile_device(torch, lambda: trainer.train_step(
        next(prof_it)), run["profiled_steps"], ms)
    if not np.isfinite(losses).all():
        fail(f"dlrm {what}: non-finite loss")
    window = max(1, nt // 6)
    return {"steps": nt, "ms_per_step": ms,
            "examples_per_s": run["batch"] / ms * 1e3,
            "loss_window": window,
            "loss_first": float(losses[:window].mean()),
            "loss_last": float(losses[-window:].mean()),
            "device_busy_ms_per_step": profile["device_busy_ms_per_call"],
            "idle_share": profile["idle_share"],
            "device_ops_per_step": profile["device_ops_per_call"],
            "top_device_ms_per_step": profile["top_device_ms_per_call"],
            "max_memory_allocated_gb":
                torch.cuda.max_memory_allocated(trainer.device) / 1e9}


def dlrm_criteo_kaggle(torch, port, seed, dev, cfg, run):
    """Full Criteo-Kaggle width on synthetic_criteo's records: the fused
    sparse step through Trainer(sparse_tables=...), val AUC before and
    after, untouched rows bit-identical, one bf16 forward; then the dense
    path (separate tables, lazy_adam)."""
    from openrec_tpu_torch.data import ShuffledArrayLoader, loaders
    from openrec_tpu_torch.training.sparse import dlrm_fused_table_spec
    raw = loaders.synthetic_criteo(num_records=run["records"],
                                   counts=cfg["ln_emb"], seed=seed)
    val = criteo_arrays(raw, "val", run["val"])
    loader = iter(ShuffledArrayLoader(criteo_arrays(raw, "train"),
                                      run["batch"], seed=seed))
    n_batches = run["warmup_steps"] + run["sparse_steps"] \
        + run["profiled_steps"]
    batches = [next(loader) for _ in range(n_batches)]
    offsets = np.concatenate([[0], np.cumsum(cfg["ln_emb"])])[:-1]
    rows = int(sum(cfg["ln_emb"]))
    used = np.zeros(rows, bool)
    for b in batches:
        used[(b["sparse_features"] + offsets).reshape(-1)] = True
    rng = np.random.default_rng(seed + 13)
    sample = np.sort(rng.choice(rows, run["untouched_sample"],
                                replace=False))
    out = {"config": {k: list(v) if isinstance(v, tuple) else v
                      for k, v in cfg.items()} | {
        "rows": rows, "batch": run["batch"], "lr": run["lr"],
        "train_records": len(raw["y_train"]), "val_records": run["val"]}}

    # the sparse path: one fused table + O(batch) Adam
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    gen = torch.Generator(device=dev).manual_seed(seed)
    model = port.DLRM(**cfg, fused_tables=True, device=dev, generator=gen)
    sample_t = torch.as_tensor(sample, device=dev)
    before = model.embed_fused.detach()[sample_t].cpu()
    trainer = port.Trainer(model, lr=run["lr"], device=dev,
                           sparse_tables=dlrm_fused_table_spec(model))
    auc0, _ = dlrm_val_auc(torch, model, val)
    sparse = dlrm_path(torch, trainer, batches, run, "sparse")
    auc, pred32 = dlrm_val_auc(torch, model, val)
    sparse.update({"val_auc_step0": auc0, "val_auc": auc})
    after = model.embed_fused.detach()[sample_t].cpu()
    untouched = ~used[sample]
    same = torch.equal(after[untouched], before[untouched])
    moved = (after[~untouched] != before[~untouched]).any(dim=1)
    sparse["untouched_rows"] = {
        "sampled": int(len(sample)), "untouched": int(untouched.sum()),
        "bit_identical": same,
        "touched_sampled": int((~untouched).sum()),
        "touched_moved": int(moved.sum())}
    model.compute_dtype = "bfloat16"
    with torch.no_grad():
        pred16 = model.score(val).cpu().numpy()
    model.compute_dtype = "float32"
    out["bf16_forward_max_abs_diff"] = float(np.abs(pred16 - pred32).max())
    out["sparse"] = sparse
    if not sparse["loss_last"] < sparse["loss_first"]:
        fail(f"dlrm sparse: loss did not fall: {sparse['loss_first']} "
             f"-> {sparse['loss_last']}")
    if not auc > auc0:
        fail(f"dlrm sparse: val AUC did not rise: {auc0} -> {auc}")
    # at full width most sampled rows lie in the big tables, untouched
    if not same or untouched.sum() < len(sample) // 4 \
            or moved.sum() < 0.9 * (~untouched).sum():
        fail(f"dlrm sparse: untouched rows changed or touched rows did "
             f"not move ({sparse['untouched_rows']})")
    if not np.isfinite(pred16).all() \
            or out["bf16_forward_max_abs_diff"] > 2e-2:
        fail(f"dlrm bf16 forward: max |diff| "
             f"{out['bf16_forward_max_abs_diff']} > 2e-2")
    del model, trainer, before, after
    torch.cuda.empty_cache()

    # the dense path: separate tables, lazy_adam over every row
    torch.cuda.reset_peak_memory_stats(dev)
    gen = torch.Generator(device=dev).manual_seed(seed)
    model = port.DLRM(**cfg, device=dev, generator=gen)
    trainer = port.Trainer(model, optimizer=port.lazy_adam(run["lr"]),
                           device=dev)
    out["dense"] = dlrm_path(torch, trainer, batches, run, "dense")
    del model, trainer
    torch.cuda.empty_cache()
    return out


def phase_dlrm(torch, port, seed, dev, flagship=FLAGSHIP, kaggle=KAGGLE,
               run=DLRM_RUN):
    out = {"flagship_card_vs_cpu": dlrm_card_vs_cpu(
        torch, port, seed, dev, flagship, run)}
    f = out["flagship_card_vs_cpu"]
    print(f"dlrm flagship card-vs-cpu: forward max |diff| "
          f"{f['forward_max_abs_diff_separate']:.3g} (separate) "
          f"{f['forward_max_abs_diff_fused']:.3g} (fused), "
          f"{f['sparse_steps']} sparse steps: params max |diff| "
          f"{f['max_abs_param_diff']:.3g}, losses "
          f"{f['max_abs_loss_diff']:.3g}", flush=True)
    out["criteo_kaggle"] = k = dlrm_criteo_kaggle(torch, port, seed, dev,
                                                  kaggle, run)
    for what in ("sparse", "dense"):
        r = k[what]
        print(f"dlrm criteo-kaggle {what}: {r['ms_per_step']:.3f} ms/step, "
              f"{r['examples_per_s']:.0f} examples/s, device busy "
              f"{r['device_busy_ms_per_step']:.3f} ms/step, idle "
              f"{r['idle_share']:.3f}, peak "
              f"{r['max_memory_allocated_gb']:.2f} GB, mean loss of the "
              f"first / last {r['loss_window']} steps "
              f"{r['loss_first']:.4f} -> {r['loss_last']:.4f}",
              flush=True)
    s = k["sparse"]
    print(f"dlrm criteo-kaggle sparse: val AUC {s['val_auc_step0']:.4f} -> "
          f"{s['val_auc']:.4f}; untouched rows "
          + json.dumps(s["untouched_rows"])
          + f"; bf16 forward max |diff| {k['bf16_forward_max_abs_diff']:.3g}",
          flush=True)
    return out


# ------------------------------------------------------------ phase 7

ZOO_MODELS = ("PMF", "WRMF", "GMF", "UCML")
ZOO = dict(steps=300, k=100, pos_ratio=0.2, margin=0.5, device_steps=200,
           card_vs_cpu_steps=20, profiled_calls=1)


def zoo_extractors(torch, name, model):
    """(user, item, bias) extractors whose u.v + b ranks items as the
    model's score does: u, v, b for PMF, WRMF and NBPR; GMF's own
    `user_vecs` (u * w); 2u, v and b - ||v||^2 for UCML and WCML, whose
    -||u - v||^2 + b differs from that by -||u||^2, the same for every
    item of a user; CDL's own `item_vecs` (item_embed + enc(features)),
    whose sigmoid keeps the order."""
    from openrec_tpu_torch.modules.embedding import embedding_lookup
    euclid = name in ("UCML", "WCML")

    def item(p, i):
        if name == "CDL":
            return model.item_vecs(i)
        return embedding_lookup(p["item_embed"], i)

    def bias(p, i):
        b = embedding_lookup(p["item_bias"], i).reshape(-1)
        if euclid:
            b = b - torch.sum(item(p, i) ** 2, dim=1)
        return b

    def user(p, i):
        if name == "GMF":
            return model.user_vecs(i)
        u = embedding_lookup(p["user_embed"], i)
        return 2.0 * u if euclid else u
    return user, item, bias


def zoo_serving(torch, port, name, model, dev, rng):
    """8 requests of 256 users, top-100 from the trained tables: through
    the cached scorer ('exact', 'pallas', 'pallas2') and through K3, with
    the extractors of `zoo_extractors`. Every returned score must be the
    fp32 score at its id and K3's ids those of torch.topk of model.score
    but for near-ties, and K1 and K2 must agree with their plain version
    on every request at the bucket their method picks; recall below its
    floor is recorded, not raised (the bucket law promises it in
    expectation only)."""
    from openrec_tpu_torch.ops import bucketed_topk as bt
    from openrec_tpu_torch.ops import topk as tk
    U, I = model.total_users, model.total_items
    params = {k: v.detach() for k, v in model.params().items()}
    user, item, bias = zoo_extractors(torch, name, model)
    scorer = port.CachedDotProductScorer(model, U, I, user, item, bias,
                                         device=dev)
    requests = [torch.as_tensor(rng.integers(0, U, BATCH), device=dev)
                for _ in range(REQUESTS)]
    answers = {m: [_request(scorer, params, r, m) for r in requests]
               for m in ("exact", "pallas", "pallas2")}
    out = {"requests": REQUESTS, "recall_vs_exact": {},
           "score_max_abs_err": 0.0}
    for m, results in answers.items():
        hits = 0
        for r, (vals, ids), (_, ex_ids) in zip(requests, results,
                                               answers["exact"]):
            if tuple(vals.shape) != (BATCH, K) or not torch.isfinite(
                    vals).all() or ids.min() < 0 or ids.max() >= I:
                fail(f"zoo {name} {m}: bad output")
            ref = scorer.serve(params, r).gather(1, ids.long())
            out["score_max_abs_err"] = max(out["score_max_abs_err"],
                                           (vals - ref).abs().max().item())
            if not near(vals, ref).all():
                fail(f"zoo {name} {m}: a returned score is not the fp32 "
                     "score at its id")
            ex_sorted = torch.sort(ex_ids, dim=1).values
            found = torch.searchsorted(ex_sorted, ids.to(ex_sorted.dtype))
            hits += int((ex_sorted.gather(1, found.clamp(max=K - 1))
                         == ids).sum())
        out["recall_vs_exact"][m] = hits / (REQUESTS * BATCH * K)
    out["recall_below_floor"] = {
        m: r for m, r in out["recall_vs_exact"].items()
        if r < TARGETS.get(m, 1.0) - 0.01}

    # K3 on the same tables, against torch.topk of the model's own score
    with torch.no_grad():
        table_u = user(params, torch.arange(U, device=dev))
        table_v = item(params, torch.arange(I, device=dev)).contiguous()
        table_b = bias(params, torch.arange(I, device=dev)).contiguous()
    # K1 and K2 against their plain version at the serving path's own
    # buckets; these launches are not the path's, so their counts go back
    counted = (bt.bucket_max_scores.launches, bt.bucket_max2_scores.launches)
    out["k1k2_vs_plain"] = {}
    for kname, m, top2 in (("K1", "pallas", False), ("K2", "pallas2", True)):
        bucket = bt.choose_bucket(I, K, recall_target=TARGETS[m],
                                  per_bucket=2 if top2 else 1)
        res = [compare_kernel(torch, bt, table_u[r].contiguous(), table_v,
                              table_b, bucket, top2) for r in requests]
        out["k1k2_vs_plain"][kname] = {
            "bucket": bucket, "max_abs_err": max(c[0] for c in res),
            "id_mismatch_not_tie": sum(c[1] for c in res),
            "id_mismatch_tie": sum(c[2] for c in res)}
        if out["k1k2_vs_plain"][kname]["id_mismatch_not_tie"]:
            fail(f"zoo {name} {kname}: id mismatches against its plain "
                 f"version that are not near-ties "
                 f"{out['k1k2_vs_plain'][kname]}")
    bt.bucket_max_scores.launches, bt.bucket_max2_scores.launches = counted

    k3 = [tk.fused_score_topk(table_u[r].contiguous(), table_v, table_b, K)
          for r in requests]
    torch.cuda.synchronize()
    checks, bad_model, ties_model = [], 0, 0
    for r, (vals, ids) in zip(requests, k3):
        full = tk.dot_scores(table_u[r], table_v, table_b)
        want_v, want_i = torch.topk(full, K, dim=1)
        checks.append(check_topk(torch, vals, ids, want_v, want_i, full,
                                 f"zoo {name} K3"))
        with torch.no_grad():
            ms = model.score({"user_id": r})
        ref_v, ref_i = torch.topk(ms, K, dim=1)
        diff = ids != ref_i.to(ids.dtype)
        tie = diff & near(ms.gather(1, ids.long()), ref_v)
        bad_model += int((diff & ~tie).sum())
        ties_model += int(tie.sum())
    out["k3"] = {"max_abs_err": max(c[0] for c in checks),
                 "id_mismatch_not_tie": sum(c[1] for c in checks),
                 "id_mismatch_tie": sum(c[2] for c in checks),
                 "vs_model_score_not_tie": bad_model,
                 "vs_model_score_tie": ties_model}
    if out["k3"]["id_mismatch_not_tie"] or bad_model:
        fail(f"zoo {name} K3: id mismatches that are not near-ties "
             f"{out['k3']}")
    out["calls"] = {"pallas": len(answers["pallas"]),
                    "pallas2": len(answers["pallas2"]), "k3": len(k3)}
    return out


def zoo_card_vs_cpu(torch, port, name, kw, start, batches, dev):
    """The same steps on the card and on the CPU from the same weights,
    lazy_adam at phase 5's learning rate (UCML's censor included)."""
    U, I = start["user_embed"].shape[0], start["item_embed"].shape[0]
    D = start["user_embed"].shape[1]
    models = {}
    for where, d in (("card", dev), ("cpu", "cpu")):
        models[where] = getattr(port, name)(U, I, D, D, device=d, **kw)
        models[where].load_params({k: v.to(d) for k, v in start.items()})
    losses = {w: port.Trainer(m, lr=TRAIN["lr"], device=m.user_embed.device)
              .train_step_multi(batches).cpu() for w, m in models.items()}
    worst = 0.0
    for key, p in models["cpu"].params().items():
        q = models["card"].params()[key].detach().cpu()
        worst = max(worst, (q - p.detach()).abs().max().item())
        if not torch.allclose(q, p.detach(), rtol=1e-4, atol=1e-6):
            fail(f"zoo {name}: card and CPU disagree on '{key}' after "
                 f"{len(batches)} steps: max {worst}")
    if not torch.allclose(losses["card"], losses["cpu"], rtol=1e-4,
                          atol=1e-6):
        fail(f"zoo {name}: card and CPU losses disagree")
    return {"steps": len(batches), "max_abs_param_diff": worst,
            "max_abs_loss_diff":
                (losses["card"] - losses["cpu"]).abs().max().item()}


def zoo_model(torch, port, name, train_ds, val, seed, dev, log_dir, run):
    """One model of phase 7: host-fed training through Trainer.train (and
    for WRMF device-sampled training after it), card against CPU, the
    touched rows' norms (UCML), serving. Returns the record."""
    from openrec_tpu_torch.data import samplers
    store = train_ds.store
    U, I = store.total_users(), store.total_items()
    D, B, k = TRAIN["dim"], TRAIN["batch"], run["k"]
    kw = {"margin": run["margin"]} if name == "UCML" else {}
    torch.cuda.reset_peak_memory_stats(dev)
    gen = torch.Generator(device=dev).manual_seed(seed)
    model = getattr(port, name)(U, I, D, D, device=dev, generator=gen, **kw)
    init = {k_: v.detach().clone() for k_, v in model.params().items()}
    log_file = log_dir / f"{name}.jsonl"
    trainer = port.Trainer(model, lr=TRAIN["lr"], seed=seed, device=dev,
                           log_file=str(log_file))
    ev0 = trainer.evaluate(val, at=(50,))
    out = {"config": {"users": U, "items": I, "dim": D, "batch": B,
                      "lr": TRAIN["lr"], "optimizer": "lazy_adam", **kw},
           "val_step0": {"AUC": float(ev0["AUC"]),
                         "Recall@50": float(ev0["Recall"][0])}}
    if name == "UCML":
        feed = train_ds.pairwise(batch_size=B, num_parallel_calls=2)
        host = samplers.PairwiseSampler(store, B, seed=seed + 7)
    else:
        feed = train_ds.stratified_pointwise(
            batch_size=B, pos_ratio=run["pos_ratio"], num_parallel_calls=2)
        host = samplers.StratifiedPointwiseSampler(
            store, B, pos_ratio=run["pos_ratio"], seed=seed + 7)
    if not (feed._sampler.use_native and host.use_native):
        fail(f"zoo {name}: the host feed did not take the native sampler")
    batches = [host.sample() for _ in range(k)]

    def feed_run(what, batches_or_sampler, steps, call, start):
        """`start`: the val metrics the leg must rise above."""
        done = len(log_file.read_text().splitlines()) \
            if log_file.exists() else 0
        res = trainer.train(steps, batches_or_sampler,
                            eval_samplers={"val": val}, eval_interval=steps,
                            steps_per_call=k, at=(50,), verbose=False)
        rec = json.loads(log_file.read_text().splitlines()[done])
        its = rec["iters_per_s"]
        wall_ms = k / its * 1e3
        prof = profile_device(torch, call, run["profiled_calls"], wall_ms)
        r = {"steps": steps, "steps_per_call": k, "steps_per_s": its,
             "examples_per_s": its * B, "mean_loss": rec["loss"],
             "val": {"AUC": float(res["val"]["AUC"]),
                     "Recall@50": float(res["val"]["Recall"][0])},
             "device_busy_ms_per_call": prof["device_busy_ms_per_call"],
             "device_ops_per_call": prof["device_ops_per_call"],
             "idle_share": prof["idle_share"],
             "top_device_ms_per_call": prof["top_device_ms_per_call"]}
        r["val_start"] = start
        for metric in ("AUC", "Recall@50"):
            if not r["val"][metric] > start[metric]:
                fail(f"zoo {name} {what}: val {metric} did not rise: "
                     f"{start[metric]} -> {r['val'][metric]}")
        print(f"zoo {name} {what}: {steps} steps, {its:.1f} steps/s, "
              f"{its * B:.0f} examples/s, device busy "
              f"{r['device_busy_ms_per_call']:.3f} ms per {k}-step call, "
              f"idle {r['idle_share']:.3f}; val AUC "
              f"{start['AUC']:.4f} -> {r['val']['AUC']:.4f}, "
              f"Recall@50 {start['Recall@50']:.4f} -> "
              f"{r['val']['Recall@50']:.4f}", flush=True)
        return r

    seconds = {}
    t = time.perf_counter()
    out["host_fed"] = feed_run(
        "host-fed (native sampler)", feed, run["steps"],
        lambda: trainer.train_step_multi(batches).cpu(), out["val_step0"])
    seconds["host_fed"] = time.perf_counter() - t
    t = time.perf_counter()
    start = {k_: v.detach().clone() for k_, v in model.params().items()}
    out["card_vs_cpu"] = zoo_card_vs_cpu(
        torch, port, name, kw, start, batches[:run["card_vs_cpu_steps"]],
        dev)
    seconds["card_vs_cpu"] = time.perf_counter() - t
    if name == "WRMF":
        t = time.perf_counter()
        sampler = port.DevicePointwiseSampler(
            store, B, pos_ratio=run["pos_ratio"], device=dev)
        # the leg starts from the host-fed weights and the profiled call
        # after them, and must rise above what they score
        ev = trainer.evaluate(val, at=(50,))
        out["device_sampled"] = feed_run(
            "device-sampled", sampler, run["device_steps"],
            lambda: trainer.train_steps_device(sampler, k).cpu(),
            {"AUC": float(ev["AUC"]), "Recall@50": float(ev["Recall"][0])})
        out["device_sampled"]["membership"] = sampler.membership
        seconds["device_sampled"] = time.perf_counter() - t
    if name == "UCML":
        norms = {}
        for table in ("user_embed", "item_embed"):
            t = model.params()[table].detach()
            touched = (t != init[table]).any(dim=1)
            norms[table] = {
                "touched_rows": int(touched.sum()),
                "max_touched_norm": torch.linalg.vector_norm(
                    t[touched], dim=1).max().item()}
        out["touched_norms"] = norms
        worst = max(v["max_touched_norm"] for v in norms.values())
        if worst > 1.0 + 1e-4 or not all(v["touched_rows"]
                                         for v in norms.values()):
            fail(f"zoo UCML: touched rows outside the unit ball {norms}")
    out["max_memory_allocated_gb"] = \
        torch.cuda.max_memory_allocated(dev) / 1e9
    t = time.perf_counter()
    out["serving"] = zoo_serving(torch, port, name, model, dev,
                                 np.random.default_rng(seed + 5))
    seconds["serving"] = time.perf_counter() - t
    out["seconds"] = seconds
    c, sv = out["card_vs_cpu"], out["serving"]
    print(f"zoo {name}: card-vs-cpu {c['steps']} steps, params max |diff| "
          f"{c['max_abs_param_diff']:.3g}; peak "
          f"{out['max_memory_allocated_gb']:.3f} GB"
          + (f"; touched row norms max "
             f"{max(v['max_touched_norm'] for v in norms.values()):.6f}"
             if name == "UCML" else "")
          + "; serving recall " + json.dumps(sv["recall_vs_exact"])
          + f", scores max |err| {sv['score_max_abs_err']:.3g}, K1/K2 vs "
          + "plain " + json.dumps(sv["k1k2_vs_plain"]) + ", K3 "
          + json.dumps(sv["k3"]) + "; seconds "
          + json.dumps({k_: round(v, 2) for k_, v in seconds.items()}),
          flush=True)
    for m, r in sv["recall_below_floor"].items():
        print(f"zoo {name} finding: {m} recall {r:.6f} is below its floor "
              f"{TARGETS[m] - 0.01:.3f} on trained tables", flush=True)
    return out


def phase_zoo(torch, port, seed, dev, run=ZOO):
    """Phase 7: PMF, WRMF, GMF and UCML at CiteULike width on phase 5's
    data, then served through K1/K2/K3. The kernels' counters are set to
    0 here and read at the end."""
    from openrec_tpu_torch.data import Dataset, loaders
    from openrec_tpu_torch.ops import bucketed_topk as bt
    from openrec_tpu_torch.ops import topk as tk
    counters = {"K1": bt.bucket_max_scores, "K2": bt.bucket_max2_scores,
                "K3": tk.fused_score_topk}
    for fn in counters.values():
        fn.launches = 0
    raw = citeulike_data(loaders, seed)
    U, I = raw["total_users"], raw["total_items"]
    train_ds = Dataset(raw["train_data"], U, I, seed=seed)
    val = Dataset(raw["val_data"], U, I, seed=seed).evaluation(
        BATCH, excl_datasets=[train_ds], device_masks=True)
    out = {}
    with tempfile.TemporaryDirectory() as log_dir:
        for name in ZOO_MODELS:
            out[name] = zoo_model(torch, port, name, train_ds, val, seed,
                                  dev, Path(log_dir), run)
            torch.cuda.empty_cache()
    launches = {k: fn.launches for k, fn in counters.items()}
    want = {"K1": sum(o["serving"]["calls"]["pallas"] for o in out.values()),
            "K2": sum(o["serving"]["calls"]["pallas2"]
                      for o in out.values()),
            "K3": sum(o["serving"]["calls"]["k3"] for o in out.values())}
    out["launches"] = launches
    if launches != want:
        fail(f"zoo: kernel launches {launches}, the path made {want}")
    return out


# ------------------------------------------------------------ phase 8

LEGACY_MODELS = ("NBPR", "WCML", "MLPRec", "NeuMF", "CDL")
LEGACY_SERVED = ("NBPR", "WCML", "CDL")      # dot-product tables: K1/K2/K3
# One profiled call of 10 steps: under torch.profiler a 100-step call
# of these models took 14-24 s of host time each.
LEGACY = dict(steps=300, k=100, num_negatives=5, pos_ratio=0.2,
              card_vs_cpu_steps=20, profiled_steps=10, vocab=8_000,
              word_density=0.01, logit_pairs=256)


def legacy_features(seed, items, run=LEGACY):
    """CDL's item content: a binary bag of words [items, vocab] fp32 at
    `word_density`, from the seed. citeulike-a's vocabulary has 8,000
    words (the CDL paper's corpus); the corpus is not in the repository,
    so synthetic words stand in for it."""
    rng = np.random.default_rng(seed + 8)
    return (rng.random((items, run["vocab"]), dtype=np.float32)
            < run["word_density"]).astype(np.float32)


def legacy_model(port, name, U, I, features, dev, gen=None, dropout=True):
    """One of phase 8's models at its configuration; dropout=False turns
    MLPRec's, NeuMF's and CDL's dropout off (card against CPU)."""
    if name in ("NBPR", "WCML"):
        kw = {"margin": 0.5} if name == "WCML" else {}
        return getattr(port, name)(U, I, 50, device=dev, generator=gen, **kw)
    if name == "CDL":
        return port.CDL(U, I, 50, features, encoder_dims=(200,),
                        dropout=0.1 if dropout else 0.0, l2_reconst=0.1,
                        a=1.0, b=0.01, device=dev, generator=gen)
    kw = {"alpha": 0.5} if name == "NeuMF" else {}
    return getattr(port, name)(U, I, 32, 32, mlp_units=(64, 32, 1),
                               dropout=0.2 if dropout else None, device=dev,
                               generator=gen, **kw)


def legacy_card_vs_cpu(torch, port, name, model, features, batches, dev,
                       dtype):
    """The same steps on the card and on the CPU from `model`'s weights in
    `dtype`, dropout off (the card's and the CPU's generators differ),
    lazy_adam at phase 5's learning rate (WCML's censor included). Returns
    the largest differences and whether every parameter and loss agrees
    within rtol 1e-4, atol 1e-6."""
    U, I = model.total_users, model.total_items
    start = {k: v.detach() for k, v in model.params().items()}
    models = {w: legacy_model(port, name, U, I, features, d,
                              dropout=False).to(dtype)
              for w, d in (("card", dev), ("cpu", torch.device("cpu")))}
    for w, m in models.items():
        m.load_params({k: v.to(m.item_bias.device, dtype)
                       for k, v in start.items()})
    losses = {w: port.Trainer(m, lr=TRAIN["lr"], device=m.item_bias.device)
              .train_step_multi(batches).cpu() for w, m in models.items()}
    worst, outside = 0.0, 0
    for key, p in models["cpu"].params().items():
        q = models["card"].params()[key].detach().cpu()
        worst = max(worst, (q - p.detach()).abs().max().item())
        outside += int((~torch.isclose(q, p.detach(), rtol=1e-4,
                                       atol=1e-6)).sum())
    if not torch.isfinite(losses["card"]).all():
        fail(f"legacy {name}: non-finite losses on the card")
    return {"steps": len(batches), "dtype": str(dtype).split(".")[-1],
            "max_abs_param_diff": worst, "params_outside_tolerance": outside,
            "max_abs_loss_diff":
                (losses["card"] - losses["cpu"]).abs().max().item(),
            "within": outside == 0 and torch.allclose(
                losses["card"], losses["cpu"], rtol=1e-4, atol=1e-6)}


def legacy_eval_manager(torch, port, model, val_store, train_store, seed):
    """The ported numpy EvalManager in full mode on the model's score
    rows (val positives against every item that is not a train
    positive)."""
    def score_fn(users):
        with torch.no_grad():
            return model.score({"user_id": torch.as_tensor(
                users, device=model.item_bias.device)}).cpu().numpy()
    return port.EvalManager(at=(50,), seed=seed).evaluate(
        score_fn, val_store, excl_stores=[train_store])


def legacy_mlp_serving(torch, name, model, dev, rng, run):
    """8 requests of 256 users, top-100 from `model.score` + torch.topk (no
    kernel scores an MLP); the full-catalog score at sampled (user, item)
    pairs must equal the training path's logit within rtol 1e-4, atol
    1e-6 (the JAX bar, tests/test_ncf_and_numpy_eval.py:54-64)."""
    U, I = model.total_users, model.total_items
    out = {"requests": REQUESTS, "logit_max_abs_diff": 0.0, "ms": []}
    for _ in range(REQUESTS):
        r = torch.as_tensor(rng.integers(0, U, BATCH), device=dev)
        t = time.perf_counter()
        with torch.no_grad():
            scores = model.score({"user_id": r})
            vals, ids = torch.topk(scores, K, dim=1)
        torch.cuda.synchronize()
        out["ms"].append((time.perf_counter() - t) * 1e3)
        if tuple(vals.shape) != (BATCH, K) or not torch.isfinite(
                scores).all() or ids.min() < 0 or ids.max() >= I:
            fail(f"legacy {name}: bad serving output")
        rows = torch.as_tensor(rng.integers(0, BATCH, run["logit_pairs"]),
                               device=dev)
        items = torch.as_tensor(rng.integers(0, I, run["logit_pairs"]),
                                device=dev)
        with torch.no_grad():
            logit = model.logit(r[rows], items)
        at = scores[rows, items]
        out["logit_max_abs_diff"] = max(out["logit_max_abs_diff"],
                                        (at - logit).abs().max().item())
        if not torch.allclose(at, logit, rtol=1e-4, atol=1e-6):
            fail(f"legacy {name}: the full-catalog score is not the "
                 f"training path's logit: max {out['logit_max_abs_diff']}")
    out["p50_ms"] = float(np.median(out["ms"][1:]))
    return out


def legacy_run(torch, port, name, train_ds, val_ds, val, features, seed,
               dev, log_dir, run):
    """One model of phase 8: host-fed training through Trainer.train,
    checks, card against CPU, serving. Returns the record."""
    from openrec_tpu_torch.data import samplers
    store = train_ds.store
    U, I = store.total_users(), store.total_items()
    B, k, steps = TRAIN["batch"], run["k"], run["steps"]
    seconds, t = {}, time.perf_counter()
    gen = torch.Generator(device=dev).manual_seed(seed)
    model = legacy_model(port, name, U, I, features, dev, gen)
    # after the first allocation: before it the allocator has no stats
    torch.cuda.reset_peak_memory_stats(dev)
    init = {k_: v.detach().clone() for k_, v in model.params().items()}
    log_file = log_dir / f"{name}.jsonl"
    trainer = port.Trainer(model, lr=TRAIN["lr"], seed=seed, device=dev,
                           log_file=str(log_file))
    ev0 = trainer.evaluate(val, at=(50,))
    out = {"config": {"users": U, "items": I, "batch": B, "lr": TRAIN["lr"],
                      "optimizer": "lazy_adam",
                      "params": {k_: list(v.shape) for k_, v in init.items()}},
           "val_step0": {"AUC": float(ev0["AUC"]),
                         "Recall@50": float(ev0["Recall"][0])}}
    if name in ("NBPR", "WCML"):
        feed = train_ds.n_pairwise(B, run["num_negatives"],
                                   num_parallel_calls=2)
        host = samplers.NPairwiseSampler(store, B, run["num_negatives"],
                                         seed=seed + 7)
        out["feed"] = "n_pairwise (numpy sampler), 2 workers"
    else:
        feed = train_ds.stratified_pointwise(B, pos_ratio=run["pos_ratio"],
                                             num_parallel_calls=2)
        host = samplers.StratifiedPointwiseSampler(
            store, B, pos_ratio=run["pos_ratio"], seed=seed + 7)
        if not (feed._sampler.use_native and host.use_native):
            fail(f"legacy {name}: the host feed did not take the native "
                 "sampler")
        out["feed"] = "stratified_pointwise (native sampler), 2 workers"
    batches = [host.sample() for _ in range(k)]
    if name == "MLPRec" or name == "NeuMF":
        out["eval_manager_step0"] = legacy_eval_manager(
            torch, port, model, val_ds.store, store, seed)
    if name == "CDL":
        with torch.no_grad():
            reconst0 = model.loss(batches[0])[1]["reconst_loss"].item()
    seconds["setup"] = time.perf_counter() - t

    t = time.perf_counter()
    res = trainer.train(steps, feed, eval_samplers={"val": val},
                        eval_interval=k, steps_per_call=k, at=(50,),
                        verbose=False)
    recs = [json.loads(x) for x in log_file.read_text().splitlines()]
    seconds["train"] = time.perf_counter() - t
    losses = [r_["loss"] for r_ in recs]
    its = [r_["iters_per_s"] for r_ in recs]
    steps_per_s = float(np.median(its))
    if len(recs) != steps // k or not np.all(np.isfinite(losses)):
        fail(f"legacy {name}: losses {losses}")
    if not losses[-1] < losses[0]:
        fail(f"legacy {name}: the mean loss of the last {k} steps "
             f"{losses[-1]} is not below that of the first {losses[0]}")
    out["host_fed"] = r = {
        "steps": steps, "steps_per_call": k,
        "steps_per_s_by_call": its, "steps_per_s": steps_per_s,
        "examples_per_s": steps_per_s * B, "mean_loss_by_call": losses,
        "val": {"AUC": float(res["val"]["AUC"]),
                "Recall@50": float(res["val"]["Recall"][0])}}
    for metric in ("AUC", "Recall@50"):
        if not r["val"][metric] > out["val_step0"][metric]:
            fail(f"legacy {name}: val {metric} did not rise: "
                 f"{out['val_step0'][metric]} -> {r['val'][metric]}")
    t = time.perf_counter()
    if "eval_manager_step0" in out:
        out["eval_manager"] = legacy_eval_manager(
            torch, port, model, val_ds.store, store, seed)
        a0, a1 = out["eval_manager_step0"]["AUC"], out["eval_manager"]["AUC"]
        if not a1 > a0:
            fail(f"legacy {name}: EvalManager AUC did not rise: {a0} -> "
                 f"{a1}")
    if name == "CDL":
        with torch.no_grad():
            reconst = model.loss(batches[0])[1]["reconst_loss"].item()
        out["reconst_loss"] = {"step0": reconst0, "end": reconst}
        if not reconst < reconst0:
            fail(f"legacy CDL: reconst_loss did not fall: {reconst0} -> "
                 f"{reconst}")
    seconds["end_checks"] = time.perf_counter() - t
    # one more call under the profiler, after the checks of step 300
    t = time.perf_counter()
    n = run["profiled_steps"]
    prof = profile_device(torch, lambda: trainer.train_step_multi(
        batches[:n]).cpu(), 1, n / steps_per_s * 1e3)
    r.update({"profiled_steps": n,
              "device_busy_ms_per_step": prof["device_busy_ms_per_call"] / n,
              "device_ops_per_step": prof["device_ops_per_call"] / n,
              "idle_share": prof["idle_share"],
              "top_device_ms_per_step": {
                  key: v / n for key, v in
                  prof["top_device_ms_per_call"].items()}})
    seconds["profile"] = time.perf_counter() - t
    print(f"legacy {name} host-fed ({out['feed']}): {steps} steps, "
          f"{steps_per_s:.1f} steps/s, {steps_per_s * B:.0f} examples/s, "
          f"device busy {r['device_busy_ms_per_step']:.4f} ms a step "
          f"({r['device_ops_per_step']:.0f} launches; one {n}-step call), "
          f"idle {r['idle_share']:.3f}; mean loss by call "
          + ", ".join(f"{x:.4f}" for x in losses)
          + f"; val AUC {out['val_step0']['AUC']:.4f} -> "
          f"{r['val']['AUC']:.4f}, Recall@50 "
          f"{out['val_step0']['Recall@50']:.4f} -> "
          f"{r['val']['Recall@50']:.4f}", flush=True)
    if name == "WCML":
        norms = {}
        for table in ("user_embed", "item_embed"):
            tab = model.params()[table].detach()
            touched = (tab != init[table]).any(dim=1)
            norms[table] = {
                "touched_rows": int(touched.sum()),
                "max_touched_norm": torch.linalg.vector_norm(
                    tab[touched], dim=1).max().item()}
        out["touched_norms"] = norms
        if max(v["max_touched_norm"] for v in norms.values()) > 1.0 + 1e-4 \
                or not all(v["touched_rows"] for v in norms.values()):
            fail(f"legacy WCML: touched rows outside the unit ball {norms}")
    out["max_memory_allocated_gb"] = \
        torch.cuda.max_memory_allocated(dev) / 1e9

    # Card against CPU in fp32, the type that trains. CDL's fp32 run is
    # recorded and its fp64 run is the check: in fp32 Adam's first step,
    # lr * g / (|g| + eps), turns the summation-order noise of its
    # near-cancelling SDAE gradient sums (over 1,000 rows and 8,000
    # words) into step differences beyond atol 1e-6, whatever the two
    # devices, so only fp64 holds the card to the CPU's arithmetic.
    t = time.perf_counter()
    cmp = [torch.float32] + ([torch.float64] if name == "CDL" else [])
    out["card_vs_cpu"] = [legacy_card_vs_cpu(
        torch, port, name, model, features,
        batches[:run["card_vs_cpu_steps"]], dev, dtype) for dtype in cmp]
    if not out["card_vs_cpu"][-1]["within"]:
        fail(f"legacy {name}: card and CPU disagree after "
             f"{run['card_vs_cpu_steps']} steps: {out['card_vs_cpu'][-1]}")
    seconds["card_vs_cpu"] = time.perf_counter() - t
    t = time.perf_counter()
    rng = np.random.default_rng(seed + 5)
    if name in LEGACY_SERVED:
        out["serving"] = zoo_serving(torch, port, name, model, dev, rng)
    else:
        out["serving"] = legacy_mlp_serving(torch, name, model, dev, rng,
                                            run)
    seconds["serving"] = time.perf_counter() - t
    out["seconds"] = seconds
    sv = out["serving"]
    extra = ""
    if name == "WCML":
        extra = (f"; touched row norms max "
                 f"{max(v['max_touched_norm'] for v in norms.values()):.6f}")
    if name == "CDL":
        extra = (f"; reconst_loss {reconst0:.4f} -> {reconst:.4f}")
    if "eval_manager" in out:
        extra = (f"; EvalManager AUC {out['eval_manager_step0']['AUC']:.4f}"
                 f" -> {out['eval_manager']['AUC']:.4f}")
    if name in LEGACY_SERVED:
        served = ("serving recall " + json.dumps(sv["recall_vs_exact"])
                  + f", scores max |err| {sv['score_max_abs_err']:.3g}, "
                  "K1/K2 vs plain " + json.dumps(sv["k1k2_vs_plain"])
                  + ", K3 " + json.dumps(sv["k3"]))
    else:
        served = (f"serving score + topk p50 {sv['p50_ms']:.3f} ms, score "
                  f"vs training logit max |diff| "
                  f"{sv['logit_max_abs_diff']:.3g}")
    print(f"legacy {name}: card-vs-cpu {run['card_vs_cpu_steps']} steps, "
          + ", ".join(f"{c['dtype']} params max |diff| "
                      f"{c['max_abs_param_diff']:.3g} ("
                      f"{c['params_outside_tolerance']} outside)"
                      for c in out["card_vs_cpu"]) + "; peak "
          f"{out['max_memory_allocated_gb']:.3f} GB{extra}; {served}; "
          "seconds " + json.dumps({k_: round(v, 2)
                                   for k_, v in seconds.items()}),
          flush=True)
    for m, rec in sv.get("recall_below_floor", {}).items():
        print(f"legacy {name} finding: {m} recall {rec:.6f} is below its "
              f"floor {TARGETS[m] - 0.01:.3f} on trained tables", flush=True)
    return out


def phase_legacy(torch, port, seed, dev, run=LEGACY):
    """Phase 8: NBPR, WCML, MLPRec, NeuMF and CDL at CiteULike width on
    phase 5's data; NBPR's, WCML's and CDL's tables then served through
    K1/K2/K3. The kernels' counters are set to 0 here and read at the
    end."""
    from openrec_tpu_torch.data import Dataset, loaders
    from openrec_tpu_torch.ops import bucketed_topk as bt
    from openrec_tpu_torch.ops import topk as tk
    counters = {"K1": bt.bucket_max_scores, "K2": bt.bucket_max2_scores,
                "K3": tk.fused_score_topk}
    for fn in counters.values():
        fn.launches = 0
    t = time.perf_counter()
    raw = citeulike_data(loaders, seed)
    U, I = raw["total_users"], raw["total_items"]
    train_ds = Dataset(raw["train_data"], U, I, seed=seed)
    val_ds = Dataset(raw["val_data"], U, I, seed=seed)
    val = val_ds.evaluation(BATCH, excl_datasets=[train_ds],
                            device_masks=True)
    features = legacy_features(seed, I, run)
    out = {"features": {"shape": list(features.shape),
                        "density": float(features.mean())},
           "setup_s": time.perf_counter() - t}
    with tempfile.TemporaryDirectory() as log_dir:
        for name in LEGACY_MODELS:
            out[name] = legacy_run(torch, port, name, train_ds, val_ds, val,
                                   features, seed, dev, Path(log_dir), run)
            torch.cuda.empty_cache()
    launches = {k: fn.launches for k, fn in counters.items()}
    want = {kname: sum(out[n]["serving"]["calls"][m]
                       for n in LEGACY_SERVED)
            for kname, m in (("K1", "pallas"), ("K2", "pallas2"),
                             ("K3", "k3"))}
    out["launches"] = launches
    if launches != want:
        fail(f"legacy: kernel launches {launches}, the path made {want}")
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


def time_bucket_kernel(torch, bt, u, v, b, top2, bucket):
    """K1 (top2 False) or K2 at one shape: CUDA-event median ms, device ms
    of the kernel (and its split merge) under the profiler, the plain
    version's and the library yardstick's ms, and the bound."""
    func = bt.bucket_max2_scores if top2 else bt.bucket_max_scores
    (B, D), I = u.shape, v.shape[0]
    dtype = str(u.dtype).split(".")[-1]
    bucket, _, L = bt.bucket_geometry(I, D, v.element_size(), bucket)
    ms = time_ms(torch, lambda: func(u, v, b, bucket=bucket))
    profile = profile_device(torch, lambda: func(u, v, b, bucket=bucket),
                             10, ms)
    device_ms = sum(t for name, t in
                    profile["top_device_ms_per_call"].items()
                    if "bucket_max" in name or "merge_splits" in name)
    plain_ms = time_ms(torch, lambda: bt.bucket_max_plain(
        u, v, b, bucket, top2=top2), runs=20)
    clocks = nvidia_smi("clocks.sm,power.draw,temperature.gpu")
    library_ms = time_ms(torch, lambda: torch.topk(
        torch.matmul(u, v.T), K, dim=1))
    nbytes = (B * D + I * D) * u.element_size() + I * 4 \
        + B * L * (16 if top2 else 8)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = 2.0 * B * I * D / PEAK_OPS[dtype] * 1e3
    shape = {"B": B, "I": I, "D": D, "dtype": dtype, "bucket": bucket,
             "L": L, "k": K}
    plan = bt.mma_plan if dtype == "bfloat16" else bt.f32_plan
    shape.update(plan(B, I, D, bucket, top2, torch.cuda.get_device_properties(
        u.device).multi_processor_count)._asdict())
    return {"ms": ms, "device_ms": device_ms, "plain_ms": plain_ms,
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": library_ms,
            # SM clock, power draw and temperature right after the timing
            "card_after_timing": clocks, "profile": profile, "shape": shape}


def phase_time(torch, bt, gen, dev, errs, launches, compare_report):
    """K1's and K2's entries of the kernels line: their numbers at the
    Amazon serving shape (bf16, the tensor-core route), with the
    CiteULike shape (fp32, the CUDA-core route) beside them, each at the
    bucket `bucket_score_topk` picks there for its method's target. The
    CiteULike entry's `max_abs_err` is phase 2's at that shape and
    bucket."""
    def inputs(I, D, dtype):
        u = (torch.rand(BATCH, D, generator=gen, device=dev) * 0.1 - 0.05)
        v = (torch.rand(I, D, generator=gen, device=dev) * 0.1 - 0.05)
        b = torch.randn(I, generator=gen, device=dev) * 0.01
        return u.to(dtype), v.to(dtype), b

    amazon = inputs(AMAZON["items"], AMAZON["dim"], torch.bfloat16)
    citeulike = inputs(CITEULIKE["items"], CITEULIKE["dim"], torch.float32)
    entries = []
    for kname, top2, line, fn_name in (
            ("K1", False, 68, "_bucket_max_kernel"),
            ("K2", True, 143, "_bucket_max2_kernel")):
        method = "pallas2" if top2 else "pallas"

        def bucket_at(cfg):
            return bt.choose_bucket(cfg["items"], K,
                                    recall_target=TARGETS[method],
                                    per_bucket=2 if top2 else 1)
        entry = {
            "name": f"{kname} bucket_max_mma<top{2 if top2 else 1}>",
            "route": "cuda",
            "source": "openrec_tpu_torch/csrc/bucket_max.cu",
            "replaces": f"openrec_tpu/ops/bucketed_topk.py:{line}",
            "replaces_function": fn_name,
            "variant": "mma-bf16",
            "launches": launches[kname],
            "max_abs_err": errs[kname]}
        entry.update(time_bucket_kernel(torch, bt, *amazon, top2,
                                        bucket_at(AMAZON)))
        entry["citeulike"] = time_bucket_kernel(torch, bt, *citeulike, top2,
                                                bucket_at(CITEULIKE))
        entry["citeulike"]["variant"] = F32_VARIANT
        entry["citeulike"]["max_abs_err"] = next(
            (c["max_abs_err"] for c in compare_report
             if c["kernel"] == kname and c["dtype"] == "float32"
             and c["I"] == CITEULIKE["items"]
             and c["bucket"] == entry["citeulike"]["shape"]["bucket"]),
            None)
        entry["citeulike"]["launches"] = entry["launches_zoo"] = \
            entry["launches_legacy"] = None
        entries.append(entry)
        for name, t in (("amazon", entry), ("citeulike", entry["citeulike"])):
            print(f"{kname} {name} ({t['variant']}, bucket "
                  f"{t['shape']['bucket']}): {t['ms']:.4f} ms by events, "
                  f"{t['device_ms']:.4f} ms device (library "
                  f"{t['library_ms']:.4f}, plain {t['plain_ms']:.3f}, bound "
                  f"{t['bound_ms']:.4f})", flush=True)
    return entries


def time_k3_stages(torch, tk, u, v, b, runs=30, warmup=3):
    """CUDA-event median ms of each of K3's four stages: each run launches
    all four in order, one at a time, with an event between two stages
    (a stage's time includes the host's launch gap wherever the host is
    slower than the card)."""
    run, _ = tk._prepare(u, v, b, K)
    out = (torch.empty(u.shape[0], K, device=u.device),
           torch.empty(u.shape[0], K, device=u.device, dtype=torch.int32))
    for _ in range(warmup):
        run(0, 3, out)
    torch.cuda.synchronize()
    ms = [[] for _ in tk.STAGES]
    for _ in range(runs):
        ev = [torch.cuda.Event(enable_timing=True)
              for _ in range(len(tk.STAGES) + 1)]
        ev[0].record()
        for i, e in enumerate(ev[1:]):
            run(i, i, out)
            e.record()
        ev[-1].synchronize()
        for i, x in enumerate(ms):
            x.append(ev[i].elapsed_time(ev[i + 1]))
    return {name: float(np.median(x)) for name, x in zip(tk.STAGES, ms)}


def time_k3(torch, tk, gen, dev, B, I, D, dtype):
    """K3 at one shape: kernel, plain version and library yardstick times
    (CUDA-event medians), its four stages, device time by kernel under
    the profiler, and the bound for this shape."""
    dt = getattr(torch, dtype)
    u = (torch.rand(B, D, generator=gen, device=dev) * 0.1 - 0.05).to(dt)
    v = (torch.rand(I, D, generator=gen, device=dev) * 0.1 - 0.05).to(dt)
    b = torch.randn(I, generator=gen, device=dev) * 0.01
    ms = time_ms(torch, lambda: tk.fused_score_topk(u, v, b, K))
    stages_ms = time_k3_stages(torch, tk, u, v, b)
    plain_ms = time_ms(torch, lambda: tk.fused_topk_plain(u, v, b, K),
                       runs=5, warmup=1)
    clocks = nvidia_smi("clocks.sm,power.draw,temperature.gpu")
    library_ms = time_ms(torch, lambda: torch.topk(
        torch.matmul(u, v.T) + b, K, dim=1))
    profile = profile_device(
        torch, lambda: tk.fused_score_topk(u, v, b, K), 10, ms)
    # u and V read once in their type, the f32 bias once, the [B, k] f32
    # values and i32 ids written once; 2*B*I*D dot-product operations
    nbytes = (B * D + I * D) * u.element_size() + 4 * I + 8 * B * K
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = 2.0 * B * I * D / PEAK_OPS[dtype] * 1e3
    plan = tk.fused_geometry(
        B, I, D, K, v.element_size(),
        torch.cuda.get_device_properties(dev).multi_processor_count)
    return {"ms": ms, "plain_ms": plain_ms,
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": library_ms, "stages_ms": stages_ms,
            "profile": profile, "card_after_timing": clocks,
            "shape": {"B": B, "I": I, "D": D, "dtype": dtype, "k": K,
                      **plan._asdict()}}


def phase_time_k3(torch, tk, gen, dev, err, amazon_launches):
    """K3's entry of the kernels line: its numbers at the CiteULike
    retrieval shape of phase 5 (fp32 tables), with the Amazon serving
    shape (bf16) beside them. `launches` is filled in by phase 5;
    `amazon_launches` is K3's count over phase 3's Amazon requests."""
    entry = {"name": "K3 fused_topk (K1 bound pass, tau, filter, final)",
             "route": "cuda",
             "source": "openrec_tpu_torch/csrc/fused_topk.cu",
             "replaces": "openrec_tpu/ops/topk.py:58",
             "replaces_function": "_fused_topk_kernel",
             "launches": None, "launches_zoo": None,
             "launches_legacy": None, "max_abs_err": err}
    entry.update(time_k3(torch, tk, gen, dev, BATCH, CITEULIKE["items"],
                         CITEULIKE["dim"], "float32"))
    entry["amazon"] = time_k3(torch, tk, gen, dev, BATCH, AMAZON["items"],
                              AMAZON["dim"], "bfloat16")
    entry["amazon"]["launches"] = amazon_launches
    for name, t in (("citeulike", entry), ("amazon", entry["amazon"])):
        print(f"K3 {name}: {t['ms']:.4f} ms (library {t['library_ms']:.4f}, "
              f"plain {t['plain_ms']:.3f}, bound {t['bound_ms']:.4f}); "
              "stages " + json.dumps(t["stages_ms"]), flush=True)
    return entry


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", type=Path, default=None,
                    help="write the full record here as JSON")
    ap.add_argument("--phases", default=",".join(map(str, PHASES)),
                    help="comma list of the phases to run (default all; "
                    "phase 1 always runs): e.g. 1,2 builds and compares "
                    "the kernels, 1,2,4 times them too")
    args = ap.parse_args(argv)
    phases = {1} | {int(x) for x in args.phases.split(",") if x.strip()}
    if not phases <= set(PHASES):
        ap.error(f"--phases: {sorted(phases - set(PHASES))} is no phase")
    t_start = time.perf_counter()

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
    ptxas = []
    for name, text in logs.items():
        kernel = "?"
        for ln in text.splitlines():
            if "Function properties for " in ln:
                kernel = kernel_name(ln.split("Function properties for ")[1])
            if "registers" in ln or "spill" in ln:
                ptxas.append(f"ptxas {name} {kernel}: {ln.strip()}")
                print(ptxas[-1], flush=True)

    gen = torch.Generator(device=dev).manual_seed(args.seed)
    rng = np.random.default_rng(args.seed)

    # A skipped phase prints nothing; what it would fill stays null.
    errs, compare_report = {"K1": None, "K2": None, "K3": None}, []
    serve, kernels, train, dlrm, zoo, legacy = {}, [], None, None, None, None

    # phase 2
    if 2 in phases:
        errs, compare_report = phase_compare(torch, bt, gen, dev)
        errs["K3"], k3_report = phase_compare_k3(torch, tk, gen, dev)
        compare_report += k3_report
        torch.cuda.empty_cache()

    # phase 3
    if 3 in phases:
        for cfg in (AMAZON, CITEULIKE):
            serve[cfg["name"]] = phase_serve(torch, port, cfg, rng, dev)
            torch.cuda.empty_cache()

    # phase 4
    if 4 in phases:
        launches = serve["amazon"]["launches"] if serve else dict.fromkeys(
            ("K1", "K2", "K3"))
        kernels = phase_time(torch, bt, gen, dev, errs, launches,
                             compare_report)
        kernels.append(phase_time_k3(torch, tk, gen, dev, errs["K3"],
                                     launches["K3"]))
        torch.cuda.empty_cache()

    # phase 5
    if 5 in phases:
        train = phase_train(torch, port, args.seed, dev)
        if kernels:
            kernels[-1]["launches"] = train["launches"]["K3"]
        torch.cuda.empty_cache()

    # phase 6
    if 6 in phases:
        t6 = time.perf_counter()
        dlrm = phase_dlrm(torch, port, args.seed, dev)
        dlrm["phase_s"] = time.perf_counter() - t6
        print(f"phase 6 (dlrm): {dlrm['phase_s']:.1f} s", flush=True)
        torch.cuda.empty_cache()

    # phase 7
    if 7 in phases:
        t7 = time.perf_counter()
        zoo = phase_zoo(torch, port, args.seed, dev)
        zoo["phase_s"] = time.perf_counter() - t7
        for entry in kernels:
            entry["launches_zoo"] = zoo["launches"][entry["name"][:2]]
            if "citeulike" in entry:
                entry["citeulike"]["launches"] = entry["launches_zoo"]
        torch.cuda.empty_cache()

    # phase 8
    if 8 in phases:
        t8 = time.perf_counter()
        legacy = phase_legacy(torch, port, args.seed, dev)
        legacy["phase_s"] = time.perf_counter() - t8
        for entry in kernels:
            entry["launches_legacy"] = legacy["launches"][entry["name"][:2]]
    total_s = time.perf_counter() - t_start
    print((f"phase 7 (zoo): {zoo['phase_s']:.1f} s; " if zoo else "")
          + (f"phase 8 (legacy): {legacy['phase_s']:.1f} s; " if legacy
             else "")
          + f"chip_smoke: {total_s:.1f} s in all", flush=True)

    if args.out is not None:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps(
            {"card": smi, "phases": sorted(phases), "build_s": build_s,
             "ptxas": ptxas, "total_s": total_s, "compare": compare_report,
             "serve": serve, "training": train, "kernels": kernels,
             "dlrm": dlrm, "zoo": zoo, "legacy": legacy},
            indent=1))
    if serve:
        print(json.dumps({"requests": {name: {
            "latency": s["latency"], "recall_vs_exact": s["recall_vs_exact"],
            "launches": s["launches"]} for name, s in serve.items()}}))
    if train:
        print(json.dumps({"training": {
            "use_native": train["host_fed"]["use_native"],
            "val_auc_step0": train["host_fed"]["val_auc_step0"],
            "val_auc": train["host_fed"]["log"][-1]["eval"]["val"]["AUC"],
            "val_auc_device_sampled":
                train["device_sampled"]["log"][-1]["eval"]["val"]["AUC"],
            "speed": {k: {m: v[m] for m in ("steps_per_s", "examples_per_s")}
                      | {"idle_share": v["profile"]["idle_share"]}
                      for k, v in train["speed"].items()},
            "retrieval": train["retrieval"]}}))
    if dlrm:
        k = dlrm["criteo_kaggle"]
        print(json.dumps({"dlrm": {
            "flagship_card_vs_cpu": dlrm["flagship_card_vs_cpu"],
            "criteo_kaggle": {
                what: {m: k[what][m] for m in (
                    "ms_per_step", "examples_per_s", "device_busy_ms_per_step",
                    "idle_share", "max_memory_allocated_gb", "loss_first",
                    "loss_last")} for what in ("sparse", "dense")}
            | {"val_auc_step0": k["sparse"]["val_auc_step0"],
               "val_auc": k["sparse"]["val_auc"],
               "untouched_rows": k["sparse"]["untouched_rows"],
               "bf16_forward_max_abs_diff": k["bf16_forward_max_abs_diff"]}}}))
    if zoo:
        print(json.dumps({"zoo": {"launches": zoo["launches"]} | {
            name: {"host_fed": {m: zoo[name]["host_fed"][m] for m in (
                "steps_per_s", "examples_per_s", "device_busy_ms_per_call",
                "idle_share", "val")},
                "val_step0": zoo[name]["val_step0"],
                "card_vs_cpu": zoo[name]["card_vs_cpu"]["max_abs_param_diff"],
                "max_memory_allocated_gb":
                    zoo[name]["max_memory_allocated_gb"],
                "recall_vs_exact": zoo[name]["serving"]["recall_vs_exact"],
                "k1k2_vs_plain": zoo[name]["serving"]["k1k2_vs_plain"],
                "k3": zoo[name]["serving"]["k3"]}
            | ({"device_sampled": {m: zoo[name]["device_sampled"][m] for m in (
                "steps_per_s", "examples_per_s", "idle_share", "val_start",
                "val")}}
               if "device_sampled" in zoo[name] else {})
            | ({"touched_norms": zoo[name]["touched_norms"]}
               if "touched_norms" in zoo[name] else {})
            for name in ZOO_MODELS}}))
    if legacy:
        print(json.dumps({"legacy": {
            "launches": legacy["launches"], "features": legacy["features"],
            "phase_s": legacy["phase_s"], "setup_s": legacy["setup_s"]} | {
            name: {"host_fed": {m: legacy[name]["host_fed"][m] for m in (
                "steps_per_s", "examples_per_s", "device_busy_ms_per_step",
                "device_ops_per_step", "idle_share", "mean_loss_by_call",
                "val")},
                "val_step0": legacy[name]["val_step0"],
                "card_vs_cpu": {c["dtype"]: c["max_abs_param_diff"]
                                for c in legacy[name]["card_vs_cpu"]},
                "max_memory_allocated_gb":
                    legacy[name]["max_memory_allocated_gb"],
                "serving": {m: v for m, v in legacy[name]["serving"].items()
                            if m != "ms"},
                "seconds": legacy[name]["seconds"]}
            | {m: legacy[name][m] for m in (
                "eval_manager_step0", "eval_manager", "reconst_loss",
                "touched_norms") if m in legacy[name]}
            for name in LEGACY_MODELS}}))
    if kernels:
        print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
