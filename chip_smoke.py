#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA GPU (written for the H100).

    python3 chip_smoke.py               # every phase, from the repo root
    python3 chip_smoke.py --phases 1,4  # build and time the kernels
    python3 chip_smoke.py --phases 1,5  # the training path alone
    python3 chip_smoke.py --phases 1,9  # the visual family alone
    python3 chip_smoke.py --phases 1,10 # the sequence models alone
    python3 chip_smoke.py --phases 1,11 # ItrMLP at Netflix width alone
    python3 chip_smoke.py --phases 1,12 # the distribution layer alone

The card tests check each hand-written kernel against its plain version
at its edge cases (`tests/test_torch_*_card.py`); this script holds each
kernel against its plain version at the main path's shapes by the same
checks (`tests/kernel_cases.py`) as it times it, and runs the models at
their published widths.

Phases, in order (`--phases` picks some; phase 1 always runs); any
failure raises and exits non-zero:
  1. print the card's name and power limit; build the CUDA kernels from
     openrec_tpu_torch/csrc with nvcc, one process per source, all at once
     (set-up time, printed).
  4. time each kernel with CUDA events (median of 30 after warm-up) beside
     its plain version, a library yardstick (torch.matmul + torch.topk,
     which the port never calls) and its bound (bytes at 3.35 TB/s,
     operations at the peak for the input type), with its device time by
     kernel under torch.profiler: K1/K2 at the Amazon serving shape (bf16),
     at the CiteULike shape (fp32), at VBPR's Tradesy shape (256 x
     165,906 x 100, bf16), at RNNRec's LastFM shape (256 x 14,598 x
     32, fp32), at ItrMLP's Netflix shape (256 x 17,770 x 20, fp32,
     with a bias) and at phase 12's row shards, each at the bucket its
     method picks there, K3 at the CiteULike retrieval shape of phase 5,
     at the Amazon, Tradesy, LastFM and Netflix shapes, each of K3's four
     launches (K1 bound pass, tau, filter, final) on its own too;
     `sparse_adam` at train-zipf's shapes in the flat layout, beside its
     plain version and its bound (no library yardstick: no library op
     does this), and again at dlrm-dcnv2's whole 26,500,127 x 128 table
     (its `dcnv2` entry); `view_grad` (the backward of the sparse step's
     gathered-view lookups and bags) at both training cells' shapes
     (`kernel_cases.VIEW_GRAD`, each with the flat dedup's order as the
     sparse step hands it), beside the stable sort of the positions
     that a view without that order adds, its plain version, ATen's
     autograd backward as the library yardstick and the bytes bound,
     with its max |diff| against the plain version. Before it is timed,
     each kernel is held against its plain version on the very tensors
     it is timed on, by the card tests' own checks (`tests/
     kernel_cases.py`: `hold_k1k2`, `hold_k3`, `hold_sparse_adam`,
     `hold_view_grad`), one launch counted a call. Then BPR at the Amazon
     catalog (bf16 serve tables) through `CachedDotProductScorer`: one
     request of 256 users by `pallas`, `pallas2`, `exact` and `approx`
     (`hold_serving`: K1 once a `pallas` request, K2 once a `pallas2`
     request, K3 never, every score the fp32 score at its id, recall
     against `exact` at least the target less 0.01) and one
     `eval_metrics` batch equal to the dense metrics. The shapes come
     from `tests/kernel_cases.py`; the card tests (`python -m pytest
     --noconftest -p no:cacheprovider -m card tests/test_torch_*_card.py`)
     hold each kernel there and at its edge cases.

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
     within 2e-2 of the fp32 one. (c) The sparse step's four dedup modes
     (flat, columns, mixed, hash) from the same init, 10 steps each under
     torch.use_deterministic_algorithms(True): params and moments
     bit-identical to the flat mode's (or, as a finding, within rtol
     1e-6); then 50 timed steps each: wall ms/step, device busy ms,
     launches, idle share, the hash mode's host checks a step and the
     rows one batch gathers. Over the whole phase the view-gradient
     kernel's launch counter (`openrec.view_grad.launches`) must read one
     a table and step of every card trainer (`card_table_steps`): the
     training path's own launches; and its sort counter
     (`openrec.view_grad.sorts`) one a table and step of the modes other
     than flat, none of the flat steps, which hand the kernel their
     dedup's order.

  7. the rest of the tf2 zoo (PMF, WRMF, GMF, UCML) at phase 5's width,
     data and optimizer (dim 50, batch 1000, lazy_adam lr 1e-3): 300
     host-fed steps each through Trainer.train, 100 a call (PMF, WRMF, GMF
     on Dataset.stratified_pointwise with pos_ratio 0.2, UCML on
     Dataset.pairwise with margin 0.5; the C++ feeder in both), then 200
     device-sampled WRMF steps (DevicePointwiseSampler) on a fresh copy
     from the same init, held against its own step 0. Per model and
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
     against CPU with dropout off from the trained weights and the
     trainer's lazy_adam moments (rtol 1e-4, atol 1e-6 in fp32; a run
     outside is rerun in fp64 before the phase stops; CDL's fp32 run is
     recorded and its fp64 run is the check), beside a control
     of the same card steps with TF32 matmuls, which must lie outside
     for at least one model of the phase (`card_vs_cpu_checked`,
     `check_tf32_controls`). NBPR (u, v, b), WCML (2u,
     v, b - ||v||^2) and CDL (u, item_embed + enc(features), b) then
     serve as phase 7's models do; MLPRec and NeuMF answer 8 requests
     by model.score + torch.topk, their full-catalog score at sampled
     pairs equal to the training logit (rtol 1e-4, atol 1e-6). Per
     model: steps/s, examples/s, device busy ms and launches per step
     and the idle share (torch.profiler over one 10-step call), peak
     memory, seconds by part.

  9. the visual family and the user-feature PMFs at Tradesy width
     (19,243 users x 165,906 items; 410,000 records, the VBPR paper's
     Tradesy count, with items from phase 5's long-tailed popularity,
     split 90/10; item features 165,906 x 4,096 fp32, relu of normals
     scaled as load_tradesy scales the real ones (/ 32.671101), and 3
     int32 user category columns of 5 values, all from --seed by numpy; the
     features copied to the card once and shared by every model): batch
     1000, lazy_adam lr 1e-3, 300 host-fed steps each through
     Trainer.train with val eval every 100 through the model's
     CachedDotProductScorer. VBPR (user 100, item 50, MLP 4,096-50, l2
     0.001) on the example's feed, Dataset.pairwise(joins=...) with the
     C++ feeder, one step a call; VisualBPR (dim 50, MLP 4,096-50,
     dropout 0.2, which a one-layer MLP never applies), VisualCML (margin
     0.5) and ConcatVisualBPR (dim 100, dim_ve 50) on Dataset.pairwise;
     VisualPMF (a 1, b 0.01), VisualGMF, UserPMF (user MLP 3-50) and
     UserVisualPMF on stratified_pointwise(pos_ratio=0.2), 100 steps a
     call, every model gathering its feature rows on the card. Checks:
     losses finite, the mean loss of the last 100 steps below the first
     100's, val AUC and Recall@50 above step 0, VisualCML's touched rows
     in the unit ball (1 + 1e-4), 20 steps card against CPU from the
     trained weights and moments in fp32 with the TF32 control, as phase
     8 holds its models (VisualCML, whose hinge makes a few fp32 weights
     differ, within max |diff| 1e-4, UserVisualPMF within 3e-5, each
     control beyond its limit and each fp64 run within the tolerance).
     Then each
     model serves as phase 7's do, VBPR from bf16 tables at D = 100 (its
     example's), the others from fp32 tables; K1, K2 and K3 count their
     launches over the phase. Per model: steps/s, examples/s, device
     busy ms and launches per step, idle share (one 10-step call under
     the profiler), peak memory, seconds by part.

 10. the sequence models at LastFM width (992 users x 14,598 items) on
     synthetic sequences from --seed (`lastfm_data`: 250-350 records a
     user, popularity falling with the item id, each next item its
     predecessor's fixed successor with probability 0.5; each user's
     last 10 % the test split), lazy_adam lr 1e-3, host-fed from each
     model's example feed (Dataset.temporal, 4 workers, one step a
     call): RNNRec with a GRU (dim 50, L 100, 32 units, 1,000
     log-uniform samples, batch 256), 150 steps, then 100 steps of a
     fresh copy from the same init on DeviceTemporalSampler; RNNRec
     with an LSTM and the full softmax, 100 steps; VanillaYouTubeRec
     (dim 50, L 20, batch 100) and YouTubeRec (gender 10 of 3, geo 40
     of 67, L 20, batch 256, `temporal(joins=...)`), 300 steps each
     (`SEQUENCE` gives the depths and why). Checks: losses finite, the
     mean loss of the last call (50 steps; 100 for the YouTube models)
     below the first's, evaluate_temporal's AUC and Recall@100 on the
     test split above step 0 (the device leg against its own start), 20
     steps card against CPU from the trained weights and moments with
     the TF32 control, as phase 8's: fp32 within rtol 1e-4 / atol 1e-6,
     but for the GRU (as a full-softmax copy: the two generators
     differ), whose 20-step fp32 run is recorded and whose fp64 run is
     the check there, and whose fp32 check is one step's loss and
     gradients through the 100-step scan, without Adam, from the
     trained weights (each gradient scaled by its max |entry|, rtol
     1e-4 / atol 1e-5, its TF32 control outside: `gradient_card_vs_cpu`);
     and `sampled_softmax_loss` card against CPU with 1,000 pinned
     candidates (loss and gradients, rtol 1e-4, atol 1e-6). Then
     RNNRec-gru (state [256, 32] against out_weight + out_bias) and
     YouTubeRec (last hidden layer [256, 50] against the transposed last
     weight, no bias) serve every test user's last window, 4 requests
     of 256, fp32: `pallas` and `pallas2` scores exact and recall at
     least the target less 0.01, K1/K2 equal to their plain version, K3
     equal to torch.topk of model.score but for near-ties; K1, K2 and
     K3 count their launches over the phase. Prints each model's test
     Recall@100 beside a popularity ranker's. Per model: steps/s,
     examples/s, device busy ms and launches per step, idle share (one
     profiled call: 1 step for RNNRec, 10 for the others), peak memory,
     seconds by part.

 11. ItrMLP at Netflix width (480,189 users x 17,770 movies) on
     synthetic time-ordered ratings from --seed (`netflix_data`: 2,000,000
     records, uniform users and items, label the sigmoid of a rank-8
     affinity computed per record; the first 90 % train, the first
     51,200 held-out records evaluate), at examples/itr_mlp.py's
     configuration (dim 20, user and item MLPs 30-30-20 with batch norm,
     batch 256, lazy_adam lr 1e-3): identity pretraining (2,000 steps of
     32 per MLP), then 1,200 host-fed steps through Trainer.train on
     Dataset.explicit(chronological=True) with the tables
     forward-propagated every 200 steps (`update_interval`) and the
     per-record MSE eval every 600 (`ITR` gives the depths and why).
     Checks: losses finite, the val MSE at the end below its value after
     pretraining (a constant predictor's MSE, the train mean label, is
     printed beside it); after one more `update_embeddings()` on 50 steps'
     flags, the flags read 0, the visited rows hold the MLP over the full
     table, some change, and the rows not visited keep their bits; 8
     requests of 256 users served from `user_vecs` against
     `serving_tables()` (fp32 D = 20 with a bias) as phase 10 serves,
     sigmoid of the logits equal to `model.score`, K3's ids those of
     torch.topk of the logits but for near-ties; 20 steps card against
     CPU with an update after steps 10 and 20, from the trained weights
     and moments, with its TF32 control. Prints steps/s, examples/s,
     device busy ms and launches a step, idle share (one profiled 10-step
     call), peak memory, the device ms of one update, seconds by part.

 12. the distribution layer (`openrec_tpu_torch/parallel/`) on the card:
     a one-rank NCCL process group (its TCPStore on a free localhost
     port; a failed init raises) and a 1 x 1 ('data', 'model') mesh.
     (a) At the Amazon serving shape (450,166 x 64 bf16 items,
     99,473 users, 8 requests of 256, k 100), `sharded_pallas_topk` with
     per_bucket 1 (target 0.99) and 2 (0.995) must equal the
     single-device `bucket_score_topk` bit for bit, K1 and K2 launched
     once a request. (b) The shard-local parts for m = 2 and m = 4 row
     shards (225,083 and 112,542 rows, the last shard's two pad rows at
     bias -1e30) called in turn in this process and merged: every score
     the fp32 score at its id, recall against the exact top-k at least
     the target less 0.01, ids those of the same merge over K1's / K2's
     plain versions but for near-ties. (c) `make_parallel_sparse_
     train_step` at world 1 in every dedup mode at full Criteo-Kaggle
     width (batch 4096): 10 steps under deterministic algorithms,
     bit-identical to the single-device sparse step of that mode from the
     same init; then the flat mode's wall ms/step both ways. (d)
     ParallelTrainer on BPR at phase 5's CiteULike width and data, 200
     host-fed steps; `sharded_dot_eval_metrics` over the val id batches
     equal to the trainer's dense evaluate (rtol 1e-5, atol 1e-6); a
     sharded checkpoint restored into a fresh trainer bit for bit. (e)
     ParallelTrainer on ItrMLP at phase 11's Netflix width on the
     one-rank mesh: 50 host-fed steps and an `update_embeddings` under
     deterministic algorithms, bit-identical to the flat Trainer's from
     the same init (parameters, Adam moments, losses). Then the NCCL group
     is taken down and (f) two ranks share the card over gloo (NCCL
     refuses two ranks on one card; gloo runs the collectives through the
     host), launched by `parallel.launch.spawn_local`: ItrMLP at Netflix
     width (its batch norm over the global batch), NeuMF with dropout at
     CiteULike width and the sampled-softmax GRU RNNRec at LastFM width
     (device-sampled), 10 SGD steps each at two data ranks, held against
     the flat Trainer on one rank of the same card from the same init and
     seeds within the CPU tests' rtol 1e-5 / atol 1e-6; ms/step both ways.
     (g) The same two gloo ranks as one data rank x two model ranks,
     every table row-sharded by the default rules: the GRU RNNRec at
     LastFM width with the full (vocabulary-parallel) softmax, host-fed,
     and with the sampled softmax, device-sampled; UCML at CiteULike width
     (one pad user row); ItrMLP at Netflix width (one pad user row) and
     one `update_embeddings` over each shard; 10 SGD steps each, held
     against the flat Trainer on one rank within (f)'s bars, pad rows 0;
     then 256 requests served from RNNRec's two 7,299-row shards through
     K1 and K2 (`sharded_pallas_topk`): every score the fp32 score at its
     id, recall@100 against the exact top-k at least the target less
     0.01, one launch per rank and kernel; ms/step both ways and its
     seconds.

Prints a {"training": ...} line, a {"dlrm": ...} line, a {"zoo": ...}
line, a {"legacy": ...} line, a {"visual": ...} line, a {"sequence": ...}
line, an {"itr": ...} line, a {"parallel": ...} line (each model phase
with its own kernel launch counts), a {"kernels": [...]} line (phase 4:
K1 and K2 at the Amazon shape with `citeulike`, `tradesy`, `lastfm`,
`netflix`, `amazon_shard2`, `amazon_shard4` and `lastfm_shard2` entries;
K3 at the CiteULike shape with `amazon`, `tradesy`, `lastfm` and
`netflix` entries; `sparse_adam` at train-zipf's shapes with a `dcnv2`
entry; `view_grad` at train-zipf's with a `train-multihot` entry), a
{"serving": ...} line (phase 4's Amazon requests), and last the line {"ok": true, "device": {"platform": "gpu", "kind": ...,
"count": ...}}; a phase that did not run prints nothing, and the fields
it fills stay null. With --out FILE, the full record (every check,
profile and timing) is also written there as JSON.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
# the kernels' shapes and the checks that the card tests share
sys.path.append(str(ROOT / "tests"))
from kernel_cases import (  # noqa: E402
    AMAZON, BATCH, BATCH_K10, CITEULIKE, CRITEO_COUNTS, K, KERNEL_COUNTERS,
    LASTFM, LASTFM_SHARD2, METHODS, NETFLIX, REQUESTS, SHARD2, SHARD4,
    SPARSE_ADAM, SPARSE_ADAM_DCN, TARGETS, TRADESY, VIEW_GRAD, bpr_serving,
    check_topk,
    compare_kernel, fail, hold_eval_metrics, hold_k1k2, hold_k3,
    hold_serving, hold_sparse_adam, hold_view_grad, launch_counts, near,
    serve_topk, sparse_adam_hyper, sparse_adam_inputs, view_grad_inputs)
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS = {"bfloat16": 989e12, "float32": 67e12}   # H100 SXM, dense
F32_VARIANT = "fma-f32-cp.async"      # K1/K2's fp32 route
PHASES = (1, 4, 5, 6, 7, 8, 9, 10, 11, 12)


def give_back(since):
    """Take the launches counted after `since` off the counters: those of
    a check, not of the path being counted."""
    from openrec_tpu_torch import trace
    for k, n in launch_counts(since).items():
        trace.count(KERNEL_COUNTERS[k], -n)


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
    keys = ("train_data", "val_data", "test_data")
    drawn = long_tail_items(rng, raw["total_items"],
                            [len(raw[key]) for key in keys])
    for key, items in zip(keys, drawn):
        raw[key] = raw[key].copy()
        raw[key]["item_id"] = items
    return raw


def long_tail_items(rng, items, sizes):
    """One array of item ids for each of `sizes`, drawn from the
    long-tailed popularity p(rank r) ~ (r + 10)^-0.9 over one permutation
    of the catalog that `rng` draws first."""
    p = 1.0 / (np.arange(items) + 10.0) ** 0.9
    order = rng.permutation(items)
    return [order[rng.choice(items, n, p=p / p.sum())] for n in sizes]


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
    base = launch_counts()      # the path's run starts here
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
        k3_launches = launch_counts(base)["K3"]
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
    out["launches"] = launch_counts(base)
    if out["launches"] != {"K1": 0, "K2": 0, "K3": REQUESTS}:
        fail(f"training path launches {out['launches']}")
    return out


# ------------------------------------------------------------ phase 6

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
                untouched_sample=10_000, mode_det_steps=10,
                mode_timed_steps=50)

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
        if where == "card":
            out["card_table_steps"] = card_table_steps(trainer)
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


def card_table_steps(trainer):
    """The sparse tables a step times the steps a card trainer has run:
    the view-gradient kernel's launches on its path (one a table and
    step)."""
    return trainer.global_step * len(trainer.sparse_tables)


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
    sparse["card_table_steps"] = card_table_steps(trainer)
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
    out["modes"] = dlrm_dedup_modes(torch, port, seed, dev, cfg, run,
                                    batches)

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


DEDUP_MODES = ("flat", "columns", "mixed", "hash")


def sparse_snapshot(torch, model, state):
    """{name: tensor} of a sparse run's params and moments (references;
    `.clone()` them to keep a step's values)."""
    out = {k: p.detach() for k, p in model.params().items()}
    for m in ("mu", "nu"):
        for path, t in getattr(state["sparse"], m).items():
            out[f"{m}/{'/'.join(map(str, path))}"] = t
    return out


def sparse_state_equal(torch, a, b):
    """(bit-identical, max relative difference) of two `sparse_snapshot`s."""
    if a.keys() != b.keys():
        fail(f"sparse snapshots differ in their leaves: {sorted(a)} "
             f"{sorted(b)}")
    same, worst = True, 0.0
    for k in a:
        x, y = a[k], b[k]
        if not torch.equal(x, y):
            same = False
            worst = max(worst, ((x - y).abs() / y.abs().clamp(min=1e-30))
                        .max().item())
    return same, worst


def dlrm_dedup_modes(torch, port, seed, dev, cfg, run, batches):
    """The four dedup modes of the fused sparse step at full Criteo-Kaggle
    width, each from the same init: 10 steps under
    torch.use_deterministic_algorithms(True), which must leave params and
    moments bit-identical to the flat mode's (the fallback: rtol 1e-6, a
    finding); then `mode_timed_steps` timed steps each with wall ms/step,
    device busy ms, launches and idle share (torch.profiler), the hash
    mode's host checks and the gathered row count of one batch."""
    from openrec_tpu_torch import trace
    from openrec_tpu_torch.training import sparse as tsparse
    n_det, n_timed = run["mode_det_steps"], run["mode_timed_steps"]
    out, ref = {}, None
    for mode in DEDUP_MODES:
        gen = torch.Generator(device=dev).manual_seed(seed)
        model = port.DLRM(**cfg, fused_tables=True, device=dev,
                          generator=gen)
        spec = tsparse.dlrm_fused_table_spec(model, mode=mode)
        trainer = port.Trainer(model, lr=run["lr"], device=dev,
                               sparse_tables=spec)
        torch.use_deterministic_algorithms(True)
        try:
            losses, _ = run_steps(torch, trainer, batches[:n_det])
        finally:
            torch.use_deterministic_algorithms(False)
        r = {"det_losses": losses.tolist()}
        snap = sparse_snapshot(torch, model, trainer.opt_state)
        if ref is None:                 # flat's state after the 10 steps
            ref = ({k: v.clone() for k, v in snap.items()}, losses)
            r["vs_flat"] = "reference"
        else:
            same, worst = sparse_state_equal(torch, snap, ref[0])
            same = same and np.array_equal(losses, ref[1])
            r["vs_flat"] = {"bit_identical": same, "max_rel_diff": worst}
            if not same and worst > 1e-6:
                fail(f"dlrm mode {mode}: {n_det} deterministic steps differ "
                     f"from the flat mode's beyond rtol 1e-6 ({worst})")
        ids = {k: torch.as_tensor(v, device=dev)
               for k, v in batches[n_det].items()}
        uids, valid, _, _ = tsparse._dedup(spec["embed_fused"](ids), dev,
                                           None)
        r["gathered_rows"] = int(uids.shape[0])
        r["unique_ids"] = int(valid.sum())
        checks = trace.counter(trace.HOST_SYNCS)
        timed = batches[n_det:n_det + n_timed]
        _, ms = run_steps(torch, trainer, timed)
        r["host_checks_per_step"] = \
            (trace.counter(trace.HOST_SYNCS) - checks) / len(timed)
        prof_it = iter(batches[n_det + n_timed:])
        profile = profile_device(torch, lambda: trainer.train_step(
            next(prof_it)), run["profiled_steps"], ms)
        r.update({"ms_per_step": ms,
                  "card_table_steps": card_table_steps(trainer),
                  "device_busy_ms_per_step":
                      profile["device_busy_ms_per_call"],
                  "device_ops_per_step": profile["device_ops_per_call"],
                  "idle_share": profile["idle_share"]})
        out[mode] = r
        print(f"dlrm criteo-kaggle mode {mode}: vs flat "
              f"{json.dumps(r['vs_flat'])}; {r['ms_per_step']:.3f} ms/step, "
              f"device busy {r['device_busy_ms_per_step']:.3f} ms, "
              f"{r['device_ops_per_step']:.0f} launches, idle "
              f"{r['idle_share']:.3f}; gathered rows {r['gathered_rows']} "
              f"({r['unique_ids']} unique ids); host checks/step "
              f"{r['host_checks_per_step']:.2f}", flush=True)
        del model, trainer, snap
        torch.cuda.empty_cache()
    del ref
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
    out["card_table_steps"] = (
        f["card_table_steps"] + k["sparse"]["card_table_steps"]
        + sum(m["card_table_steps"] for m in k["modes"].values()))
    # of which the view's gradient sorts its lookups itself: the modes
    # other than flat, whose views hold no dedup order
    out["card_table_steps_unsorted"] = sum(
        m["card_table_steps"] for mode, m in k["modes"].items()
        if mode != "flat")
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
    model's score does: the model's own `user_vecs` where it has them
    (GMF's and VisualGMF's u * w, the user-feature PMFs' user_embed +
    MLP(features)), else its user table; its own `item_vecs` where it has
    them (CDL's item_embed + enc(features), the visual family's fused
    vectors), else its item table; and its bias. UCML, WCML and VisualCML
    take 2u, v and b - ||v||^2: their -||u - v||^2 + b differs from that
    by -||u||^2, the same for every item of a user. A sigmoid (PMF-like
    scores) keeps the order."""
    from openrec_tpu_torch.modules.embedding import embedding_lookup
    euclid = name in ("UCML", "WCML", "VisualCML")

    def item(p, i):
        if hasattr(model, "item_vecs"):
            return model.item_vecs(i)
        return embedding_lookup(p["item_embed"], i)

    def bias(p, i):
        b = embedding_lookup(p["item_bias"], i).reshape(-1)
        if euclid:
            b = b - torch.sum(item(p, i) ** 2, dim=1)
        return b

    def user(p, i):
        if hasattr(model, "user_vecs"):
            return model.user_vecs(i)
        u = embedding_lookup(p["user_embed"], i)
        return 2.0 * u if euclid else u
    return user, item, bias


def zoo_serving(torch, port, name, model, dev, rng,
                serve_dtype="float32"):
    """8 requests of 256 users, top-100 from the trained tables: through
    the cached scorer ('exact', 'pallas', 'pallas2') and through K3, with
    the extractors of `zoo_extractors`, in `serve_dtype` tables (bf16 for
    VBPR, as its example serves it). Every returned score must be the
    fp32 score of the served tables at its id; K3's ids those of
    torch.topk of those scores and, for fp32 tables, of model.score, but
    for near-ties; and K1 and K2 must agree with their plain version on
    every request at the bucket their method picks; recall below its
    floor is recorded, not raised (the bucket law promises it in
    expectation only)."""
    from openrec_tpu_torch.ops import bucketed_topk as bt
    from openrec_tpu_torch.ops import topk as tk
    U, I = model.total_users, model.total_items
    dt = getattr(torch, serve_dtype)
    params = {k: v.detach() for k, v in model.params().items()}
    user, item, bias = zoo_extractors(torch, name, model)
    scorer = port.CachedDotProductScorer(model, U, I, user, item, bias,
                                         serve_dtype=dt, device=dev)
    requests = [torch.as_tensor(rng.integers(0, U, BATCH), device=dev)
                for _ in range(REQUESTS)]
    answers = {m: [serve_topk(scorer, params, r, m) for r in requests]
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
        table_u = user(params, torch.arange(U, device=dev)).to(dt)
        table_v = item(params, torch.arange(I, device=dev)).to(
            dt).contiguous()
        table_b = bias(params, torch.arange(I, device=dev)).contiguous()
    # K1 and K2 against their plain version at the serving path's own
    # buckets; these launches are not the path's, so their counts go back
    counted = launch_counts()
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
    give_back(counted)

    k3 = [tk.fused_score_topk(table_u[r].contiguous(), table_v, table_b, K)
          for r in requests]
    torch.cuda.synchronize()
    checks, bad_model, ties_model = [], 0, 0
    for r, (vals, ids) in zip(requests, k3):
        full = tk.dot_scores(table_u[r], table_v, table_b)
        want_v, want_i = torch.topk(full, K, dim=1)
        checks.append(check_topk(torch, vals, ids, want_v, want_i, full,
                                 f"zoo {name} K3"))
        if dt != torch.float32:     # bf16 tables rank apart from the model
            continue
        with torch.no_grad():
            ms = model.score({"user_id": r})
        ref_v, ref_i = torch.topk(ms, K, dim=1)
        diff = ids != ref_i.to(ids.dtype)
        tie = diff & near(ms.gather(1, ids.long()), ref_v)
        bad_model += int((diff & ~tie).sum())
        ties_model += int(tie.sum())
    held = dt == torch.float32          # against model.score too
    out["k3"] = {"max_abs_err": max(c[0] for c in checks),
                 "id_mismatch_not_tie": sum(c[1] for c in checks),
                 "id_mismatch_tie": sum(c[2] for c in checks),
                 "vs_model_score_not_tie": bad_model if held else None,
                 "vs_model_score_tie": ties_model if held else None,
                 "tables": serve_dtype}
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
    gen = torch.Generator(device=dev).manual_seed(seed)
    model = getattr(port, name)(U, I, D, D, device=dev, generator=gen, **kw)
    # after the first allocation: before it the allocator has no stats
    torch.cuda.reset_peak_memory_stats(dev)
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

    def feed_run(what, trainer, batches_or_sampler, steps, call, start):
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
        "host-fed (native sampler)", trainer, feed, run["steps"],
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
        # the leg trains a fresh copy from the same init and must rise
        # above its own step 0: from the host-fed weights, at val's
        # plateau, 200 more steps move Recall@50 either way (PERF.md)
        fresh = port.Trainer(
            getattr(port, name)(U, I, D, D, device=dev,
                                generator=torch.Generator(device=dev)
                                .manual_seed(seed)),
            lr=TRAIN["lr"], seed=seed, device=dev, log_file=str(log_file))
        ev = fresh.evaluate(val, at=(50,))
        out["device_sampled"] = feed_run(
            "device-sampled", fresh, sampler, run["device_steps"],
            lambda: fresh.train_steps_device(sampler, k).cpu(),
            {"AUC": float(ev["AUC"]), "Recall@50": float(ev["Recall"][0])})
        out["device_sampled"]["membership"] = sampler.membership
        seconds["device_sampled"] = time.perf_counter() - t
    if name == "UCML":
        out["touched_norms"] = norms = touched_norms(torch, model, init,
                                                     "zoo UCML")
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
    base = launch_counts()
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
    launches = launch_counts(base)
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


def param_diff(torch, a, b):
    """(max |a - b|, {name: entries outside rtol 1e-4, atol 1e-6},
    {name: max |a - b| of a parameter with entries outside}) over two
    {name: tensor} dicts on the CPU, compared in the wider type."""
    worst, by_param, worst_by_param = 0.0, {}, {}
    for key, q in b.items():
        p = a[key].to(torch.promote_types(a[key].dtype, q.dtype))
        q = q.to(p.dtype)
        diff = (p - q).abs().max().item()
        worst = max(worst, diff)
        n_out = int((~torch.isclose(p, q, rtol=1e-4, atol=1e-6)).sum())
        if n_out:
            by_param[key], worst_by_param[key] = n_out, diff
    return worst, by_param, worst_by_param


def card_vs_cpu(torch, port, what, make, trainer, batches, dev, dtype,
                cpu_params=None, update_interval=None):
    """The same steps on the card and on the CPU in `dtype`, from where
    `trainer` stands: its model's weights and its lazy_adam state (count
    and moments), carried into both copies. `make(device)` builds a fresh
    model there with dropout off (the card's and the CPU's generators
    differ); each copy trains at phase 5's learning rate (a model's
    `post_step`, such as a censor, included). Carried moments keep Adam's
    first step out of the check: from zero moments that step is
    lr * g / (|g| + eps), which turns the summation-order noise of a
    near-cancelling gradient sum (an MLP's over 1,000 rows) into a step of
    either sign, whatever the two devices. In fp32 a second card run with
    TF32 matmuls on is the control. Returns one record per card run: the
    largest differences and whether every parameter and loss agrees
    within rtol 1e-4, atol 1e-6, and the entries outside by parameter.
    `cpu_params`, a dict, receives the CPU run's parameters under the
    dtype's name. With `update_interval` (ItrMLP) each copy calls its
    model's `update_embeddings()` after every `update_interval` steps,
    as `Trainer.train(update_interval=)` does."""
    start = {k: v.detach() for k, v in trainer.model.params().items()}
    state = trainer.opt_state

    def run(d, tf32=False):
        m = make(d).to(dtype)
        m.load_params({k: v.to(d, dtype) for k, v in start.items()})
        t = port.Trainer(m, lr=TRAIN["lr"], device=d)
        t.opt_state = state._replace(
            count=state.count.to(d),
            mu={k: v.to(d, dtype, copy=True) for k, v in state.mu.items()},
            nu={k: v.to(d, dtype, copy=True) for k, v in state.nu.items()})
        k = update_interval or len(batches)
        torch.backends.cuda.matmul.allow_tf32 = tf32
        try:
            losses = []
            for i in range(0, len(batches), k):
                losses.append(t.train_step_multi(batches[i:i + k]))
                if update_interval:
                    m.update_embeddings()
            losses = torch.cat(losses).cpu()
        finally:
            torch.backends.cuda.matmul.allow_tf32 = False
        return ({k: v.detach().cpu() for k, v in m.params().items()},
                losses)

    cpu, cpu_losses = run(torch.device("cpu"))
    if cpu_params is not None:
        cpu_params[str(dtype).split(".")[-1]] = cpu
    runs = []
    for tf32 in (False, True) if dtype == torch.float32 else (False,):
        card, losses = run(dev, tf32)
        if not torch.isfinite(losses).all():
            fail(f"{what}: non-finite losses on the card")
        worst, by_param, worst_by_param = param_diff(torch, card, cpu)
        outside = sum(by_param.values())
        loss_ok = torch.allclose(losses, cpu_losses, rtol=1e-4, atol=1e-6)
        runs.append({
            "steps": len(batches),
            "dtype": "tf32" if tf32 else str(dtype).split(".")[-1],
            "max_abs_param_diff": worst, "params_outside_tolerance": outside,
            "outside_by_param": by_param,
            "max_abs_diff_outside_by_param": worst_by_param,
            "max_abs_loss_diff": (losses - cpu_losses).abs().max().item(),
            "losses_within": loss_ok, "within": outside == 0 and loss_ok})
    return runs


def card_vs_cpu_checked(torch, port, what, make, trainer, batches, dev,
                        limit=None, fp64_check=False, update_interval=None,
                        noise_limit=None):
    """`card_vs_cpu` in fp32, the type that trains, which must agree (its
    TF32 control is recorded). An fp32 run outside the tolerance is
    rerun in fp64 before the phase stops, to tell the card's arithmetic
    from a fault, and the CPU's own fp32 run is then held against its
    fp64 run too (a record of dtype "cpu float32 vs float64": where it lies
    as far out as the card's, the gap is fp32 rounding that the training
    amplifies on any device). With `limit` (VisualCML, whose hinge turns a
    rounding difference at a triple on its margin into a different step;
    UserVisualPMF, one entry of which lay out in one run, the CPU's own
    fp32 run as far out; PERF.md §6) the fp32 parameters need only lie
    within max |diff| `limit`, its TF32 control must lie beyond it, and
    an fp64 run must agree within the tolerance. With `fp64_check` (CDL,
    whose SDAE sums over 1,000 rows and 8,000 words put its fp32 run far
    outside in some runs even from trained moments; the GRU RNNRec of
    phase 10) the fp32 run is recorded and an fp64 run is
    the check. With `noise_limit` = (names, limit) (ItrMLP, whose MLP
    biases before a batch norm have a true gradient of 0 that Adam steps
    on rounding noise, each device its own; PERF.md §6) the fp32 run must
    agree within the tolerance but at the parameters `names`, which need
    only lie within max |diff| `limit`; its TF32 control must lie outside
    at some other parameter, and an fp64 run must agree within the
    tolerance. Returns the runs."""
    cpu = {}
    runs = card_vs_cpu(torch, port, what, make, trainer, batches, dev,
                       torch.float32, cpu, update_interval)
    fp32, control = runs
    if fp64_check or limit is not None or noise_limit is not None \
            or not fp32["within"]:
        runs += card_vs_cpu(torch, port, what, make, trainer, batches, dev,
                            torch.float64, cpu, update_interval)
    ok = runs[-1]["within"] if fp64_check else fp32["within"]
    if limit is not None:
        ok = (fp32["losses_within"] and fp32["max_abs_param_diff"] <= limit
              and runs[-1]["within"])
        if not control["max_abs_param_diff"] > limit:
            fail(f"{what}: the TF32 control lies within the fp32 limit "
                 f"{limit}: {runs}")
    if noise_limit is not None:
        names, lim = noise_limit
        ok = (fp32["losses_within"] and runs[-1]["within"]
              and set(fp32["outside_by_param"]) <= set(names)
              and all(fp32["max_abs_diff_outside_by_param"][n] <= lim
                      for n in fp32["outside_by_param"]))
        if set(control["outside_by_param"]) <= set(names):
            fail(f"{what}: the TF32 control lies outside only at the "
                 f"parameters {sorted(names)} its limit covers: {runs}")
    if "float64" in cpu:
        worst, by_param, worst_by_param = param_diff(
            torch, cpu["float32"], cpu["float64"])
        runs.append({"steps": len(batches), "dtype": "cpu float32 vs float64",
                     "max_abs_param_diff": worst,
                     "params_outside_tolerance": sum(by_param.values()),
                     "outside_by_param": by_param,
                     "max_abs_diff_outside_by_param": worst_by_param})
    if not ok:
        fail(f"{what}: card and CPU disagree after {len(batches)} steps: "
             f"{runs}")
    return runs


def check_tf32_controls(what, out, names):
    """The TF32 controls of a phase's card-vs-CPU checks: at least one
    must lie outside the tolerance, or the check cannot see a
    lower-precision matmul at that phase's shapes. Returns the models
    whose control lies outside."""
    caught = [n for n in names if not out[n]["card_vs_cpu"][1]["within"]]
    if not caught:
        fail(f"{what}: no TF32 control lies outside the card-vs-cpu "
             "tolerance")
    print(f"{what}: the TF32 control lies outside for {caught}", flush=True)
    return caught


def touched_norms(torch, model, init, what):
    """Norms of the user and item rows that training moved (away from
    `init`): each table must have some, all in the unit ball (1 + 1e-4),
    where a censoring `post_step` puts them."""
    norms = {}
    for table in ("user_embed", "item_embed"):
        tab = model.params()[table].detach()
        touched = (tab != init[table]).any(dim=1)
        norms[table] = {
            "touched_rows": int(touched.sum()),
            "max_touched_norm": torch.linalg.vector_norm(
                tab[touched], dim=1).max().item()}
    if max(v["max_touched_norm"] for v in norms.values()) > 1.0 + 1e-4 \
            or not all(v["touched_rows"] for v in norms.values()):
        fail(f"{what}: touched rows outside the unit ball {norms}")
    return norms


def train_host_fed(torch, trainer, feed, val, log_file, run, what,
                   val_step0, steps_per_call, scorer=None):
    """`run["steps"]` steps through Trainer.train on `feed`,
    `steps_per_call` a call, val eval every `run["k"]` (through `scorer`
    where given); checks every mean loss finite, the last `k` steps' mean
    below the first's, val AUC and Recall@50 above `val_step0`. Returns
    the record."""
    k, steps, B = run["k"], run["steps"], TRAIN["batch"]
    res = trainer.train(steps, feed, eval_samplers={"val": val},
                        eval_interval=k, steps_per_call=steps_per_call,
                        at=(50,), scorer=scorer, verbose=False)
    recs = [json.loads(x) for x in log_file.read_text().splitlines()]
    losses = [r_["loss"] for r_ in recs]
    its = [r_["iters_per_s"] for r_ in recs]
    steps_per_s = float(np.median(its))
    if len(recs) != steps // k or not np.all(np.isfinite(losses)):
        fail(f"{what}: losses {losses}")
    if not losses[-1] < losses[0]:
        fail(f"{what}: the mean loss of the last {k} steps {losses[-1]} is "
             f"not below that of the first {losses[0]}")
    r = {"steps": steps, "steps_per_call": steps_per_call, "eval_every": k,
         "steps_per_s_by_call": its, "steps_per_s": steps_per_s,
         "examples_per_s": steps_per_s * B, "mean_loss_by_call": losses,
         "val": {"AUC": float(res["val"]["AUC"]),
                 "Recall@50": float(res["val"]["Recall"][0])}}
    for metric in ("AUC", "Recall@50"):
        if not r["val"][metric] > val_step0[metric]:
            fail(f"{what}: val {metric} did not rise: {val_step0[metric]} "
                 f"-> {r['val'][metric]}")
    return r


def profile_steps(torch, r, call, n):
    """One call of `n` steps under the profiler, after the checks: device
    busy ms, launches and largest items a step, and the idle share of the
    steps' unprofiled wall time, into the host-fed record `r`."""
    prof = profile_device(torch, call, 1, n / r["steps_per_s"] * 1e3)
    r.update({"profiled_steps": n,
              "device_busy_ms_per_step": prof["device_busy_ms_per_call"] / n,
              "device_ops_per_step": prof["device_ops_per_call"] / n,
              "idle_share": prof["idle_share"],
              "top_device_ms_per_step": {
                  key: v / n for key, v in
                  prof["top_device_ms_per_call"].items()}})


def host_fed_line(what, out):
    r, vs = out["host_fed"], out["val_step0"]
    return (f"{what} host-fed ({out['feed']}): {r['steps']} steps, "
            f"{r['steps_per_s']:.1f} steps/s, {r['examples_per_s']:.0f} "
            f"examples/s, device busy {r['device_busy_ms_per_step']:.4f} ms "
            f"a step ({r['device_ops_per_step']:.0f} launches; one "
            f"{r['profiled_steps']}-step call), idle {r['idle_share']:.3f}; "
            "mean loss by call "
            + ", ".join(f"{x:.4f}" for x in r["mean_loss_by_call"])
            + f"; val AUC {vs['AUC']:.4f} -> {r['val']['AUC']:.4f}, "
            f"Recall@50 {vs['Recall@50']:.4f} -> "
            f"{r['val']['Recall@50']:.4f}")


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
    B, k = TRAIN["batch"], run["k"]
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
    out["host_fed"] = r = train_host_fed(
        torch, trainer, feed, val, log_file, run, f"legacy {name}",
        out["val_step0"], k)
    seconds["train"] = time.perf_counter() - t
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
    profile_steps(torch, r, lambda: trainer.train_step_multi(
        batches[:n]).cpu(), n)
    seconds["profile"] = time.perf_counter() - t
    print(host_fed_line(f"legacy {name}", out), flush=True)
    if name == "WCML":
        out["touched_norms"] = norms = touched_norms(
            torch, model, init, "legacy WCML")
    out["max_memory_allocated_gb"] = \
        torch.cuda.max_memory_allocated(dev) / 1e9

    t = time.perf_counter()
    out["card_vs_cpu"] = card_vs_cpu_checked(
        torch, port, f"legacy {name}",
        lambda d: legacy_model(port, name, U, I, features, d, dropout=False),
        trainer, batches[:run["card_vs_cpu_steps"]], dev,
        fp64_check=name == "CDL")
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
    base = launch_counts()
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
    launches = launch_counts(base)
    want = {kname: sum(out[n]["serving"]["calls"][m]
                       for n in LEGACY_SERVED)
            for kname, m in (("K1", "pallas"), ("K2", "pallas2"),
                             ("K3", "k3"))}
    out["launches"] = launches
    if launches != want:
        fail(f"legacy: kernel launches {launches}, the path made {want}")
    out["tf32_caught"] = check_tf32_controls("legacy", out, LEGACY_MODELS)
    return out


# ------------------------------------------------------------ phase 9

VISUAL_MODELS = ("VBPR", "VisualBPR", "VisualCML", "VisualPMF", "VisualGMF",
                 "ConcatVisualBPR", "UserPMF", "UserVisualPMF")
VISUAL_POINTWISE = ("VisualPMF", "VisualGMF", "UserPMF", "UserVisualPMF")
# records: the VBPR paper's Tradesy feedback count; features: its CNN
# width; 3 category columns of 5 values a user, the layout (and range) of
# the Amazon-book fixture's user_features_categories.npy
# fp32_limit: per-model card-vs-CPU limits, above the largest fp32
# difference of the runs whose fp64 run agreed and below the TF32
# control's (PERF.md §6): VisualCML's (2.3e-5; control >= 5.4e-4), and
# UserVisualPMF's (one item_embed entry out by 3.41e-6, the CPU's own fp32
# run as far from its fp64 run at that entry; control 2.44e-3)
VISUAL = dict(records=410_000, features=4096, categories=5, steps=300,
              k=100, pos_ratio=0.2, card_vs_cpu_steps=20, profiled_steps=10,
              eval_batch=1000,
              fp32_limit={"VisualCML": 1e-4, "UserVisualPMF": 3e-5})


def tradesy_data(loaders, seed, run=VISUAL):
    """Tradesy's width (19,243 users x 165,906 items) on synthetic data:
    `run["records"]` records of uniform users with items drawn from the
    long-tailed popularity of `citeulike_data`, split 90/10; item
    features [items, 4096] fp32, relu of normals (non-negative, as a
    CNN's outputs) divided by `load_tradesy`'s 32.671101, as the loader
    hands the real features to a model; int32 user categories
    [users, 3]. All from the seed by numpy. (Unscaled, 4,096 features
    of mean 0.4 let Adam's even steps on a visual MLP column move a
    projection by ~1.6 a step: UserVisualPMF's scores saturate its
    sigmoid within 100 steps.)"""
    U, I = loaders.TRADESY["total_users"], loaders.TRADESY["total_items"]
    n = run["records"]
    data = loaders.synthetic_interactions(U, I, n, seed=seed)
    rng = np.random.default_rng(seed + 1)
    data["item_id"] = long_tail_items(rng, I, [n])[0]
    feats = rng.standard_normal((I, run["features"]), dtype=np.float32)
    np.maximum(feats, 0.0, out=feats)
    feats /= np.float32(32.671101)
    cut = n - n // 10
    return {"total_users": U, "total_items": I, "train_data": data[:cut],
            "val_data": data[cut:], "item_features": feats,
            "user_features": rng.integers(0, run["categories"], (U, 3))
            .astype(np.int32)}


def visual_model(port, name, U, I, feats, cats, dev, gen=None):
    """One of phase 9's models at its configuration. VisualBPR's dropout
    0.2 follows hidden layers only, as in the JAX package, so its
    one-layer MLP never drops."""
    kw = {"device": dev, "generator": gen}
    if name == "VBPR":
        return port.VBPR(U, I, 100, 50, item_features=feats,
                         l2_weight=0.001, **kw)
    if name == "ConcatVisualBPR":
        return port.ConcatVisualBPR(U, I, 100, 50, item_features=feats, **kw)
    if name == "UserPMF":
        return port.UserPMF(U, I, 50, user_features=cats, **kw)
    if name == "UserVisualPMF":
        return port.UserVisualPMF(U, I, 50, user_features=cats,
                                  item_features=feats, **kw)
    kw.update({"VisualBPR": {"dropout": 0.2}, "VisualCML": {"margin": 0.5},
               "VisualPMF": {"a": 1.0, "b": 0.01}}.get(name, {}))
    return getattr(port, name)(U, I, 50, item_features=feats, **kw)


def visual_run(torch, port, name, data, train_ds, val, feats_card, seed, dev,
               log_dir, run):
    """One model of phase 9: host-fed training through Trainer.train with
    val eval through its CachedDotProductScorer, checks, card against
    CPU, serving. Returns the record."""
    from openrec_tpu_torch.data import samplers
    store = train_ds.store
    U, I = store.total_users(), store.total_items()
    B, k = TRAIN["batch"], run["k"]
    seconds, t = {}, time.perf_counter()
    gen = torch.Generator(device=dev).manual_seed(seed)
    model = visual_model(port, name, U, I, feats_card, data["user_features"],
                         dev, gen)
    torch.cuda.reset_peak_memory_stats(dev)
    init = {k_: v.detach().clone() for k_, v in model.params().items()}
    log_file = log_dir / f"{name}.jsonl"
    trainer = port.Trainer(model, lr=TRAIN["lr"], seed=seed, device=dev,
                           log_file=str(log_file))
    serve_dtype = "bfloat16" if name == "VBPR" else "float32"
    scorer = port.CachedDotProductScorer(
        model, U, I, *zoo_extractors(torch, name, model),
        serve_dtype=getattr(torch, serve_dtype), device=dev)
    ev0 = trainer.evaluate(val, at=(50,), scorer=scorer)
    out = {"config": {"users": U, "items": I, "batch": B, "lr": TRAIN["lr"],
                      "optimizer": "lazy_adam", "serve_dtype": serve_dtype,
                      "params": {k_: list(v.shape) for k_, v in init.items()}},
           "val_step0": {"AUC": float(ev0["AUC"]),
                         "Recall@50": float(ev0["Recall"][0])}}
    # VBPR: the example's feed, feature rows joined on the host and one
    # step a call; the others gather their rows on the card
    call_k = k
    if name == "VBPR":
        joins = [("p_item_id", data["item_features"], "p_item_vfeature"),
                 ("n_item_id", data["item_features"], "n_item_vfeature")]
        feed = train_ds.pairwise(B, num_parallel_calls=2, joins=joins)
        host = samplers.FeatureJoinedSampler(
            samplers.PairwiseSampler(store, B, seed=seed + 7), joins)
        native = feed._sampler.base.use_native and host.base.use_native
        out["feed"] = "pairwise(joins=...) (native sampler), 2 workers"
        call_k = 1
    elif name in VISUAL_POINTWISE:
        feed = train_ds.stratified_pointwise(B, pos_ratio=run["pos_ratio"],
                                             num_parallel_calls=2)
        host = samplers.StratifiedPointwiseSampler(
            store, B, pos_ratio=run["pos_ratio"], seed=seed + 7)
        native = feed._sampler.use_native and host.use_native
        out["feed"] = "stratified_pointwise (native sampler), 2 workers"
    else:
        feed = train_ds.pairwise(B, num_parallel_calls=2)
        host = samplers.PairwiseSampler(store, B, seed=seed + 7)
        native = feed._sampler.use_native and host.use_native
        out["feed"] = "pairwise (native sampler), 2 workers"
    if not native:
        fail(f"visual {name}: the host feed did not take the native sampler")
    batches = [host.sample() for _ in range(run["card_vs_cpu_steps"])]
    seconds["setup"] = time.perf_counter() - t

    t = time.perf_counter()
    out["host_fed"] = r = train_host_fed(
        torch, trainer, feed, val, log_file, run, f"visual {name}",
        out["val_step0"], call_k, scorer)
    seconds["train"] = time.perf_counter() - t
    # one more call under the profiler, after the checks of step 300: VBPR
    # profiles 10 of its one-step calls on joined batches
    t = time.perf_counter()
    n = run["profiled_steps"]
    if call_k == 1:
        def call():
            return [trainer.train_step(b)[0] for b in batches[:n]][-1].cpu()
    else:
        def call():
            return trainer.train_step_multi(batches[:n]).cpu()
    profile_steps(torch, r, call, n)
    seconds["profile"] = time.perf_counter() - t
    print(host_fed_line(f"visual {name}", out), flush=True)
    if name == "VisualCML":
        out["touched_norms"] = norms = touched_norms(
            torch, model, init, "visual VisualCML")
    out["max_memory_allocated_gb"] = \
        torch.cuda.max_memory_allocated(dev) / 1e9

    t = time.perf_counter()

    def make(d):
        feats = feats_card if d.type == "cuda" else data["item_features"]
        return visual_model(port, name, U, I, feats, data["user_features"],
                            d)
    out["card_vs_cpu"] = card_vs_cpu_checked(
        torch, port, f"visual {name}", make, trainer, batches, dev,
        run["fp32_limit"].get(name))
    seconds["card_vs_cpu"] = time.perf_counter() - t
    torch.cuda.empty_cache()
    t = time.perf_counter()
    out["serving"] = sv = zoo_serving(torch, port, name, model, dev,
                                      np.random.default_rng(seed + 5),
                                      serve_dtype=serve_dtype)
    seconds["serving"] = time.perf_counter() - t
    out["seconds"] = seconds
    extra = ""
    if name == "VisualCML":
        extra = (f"; touched row norms max "
                 f"{max(v['max_touched_norm'] for v in norms.values()):.6f}")
    print(f"visual {name}: card-vs-cpu {len(batches)} steps, "
          + ", ".join(f"{c['dtype']} params max |diff| "
                      f"{c['max_abs_param_diff']:.3g} ("
                      f"{c['params_outside_tolerance']} outside)"
                      for c in out["card_vs_cpu"]) + "; peak "
          f"{out['max_memory_allocated_gb']:.3f} GB{extra}; serving "
          f"({serve_dtype} tables) recall "
          + json.dumps(sv["recall_vs_exact"])
          + f", scores max |err| {sv['score_max_abs_err']:.3g}, K1/K2 vs "
          "plain " + json.dumps(sv["k1k2_vs_plain"]) + ", K3 "
          + json.dumps(sv["k3"]) + "; seconds "
          + json.dumps({k_: round(v, 2) for k_, v in seconds.items()}),
          flush=True)
    for m, rec in sv["recall_below_floor"].items():
        print(f"visual {name} finding: {m} recall {rec:.6f} is below its "
              f"floor {TARGETS[m] - 0.01:.3f} on trained tables", flush=True)
    return out


def phase_visual(torch, port, seed, dev, run=VISUAL):
    """Phase 9: the visual family and the user-feature PMFs at Tradesy
    width, one copy of the item features on the card shared by all
    eight; each model's tables then served through K1/K2/K3 (VBPR's in
    bf16 at D = 100). The kernels' counters are set to 0 here and read
    at the end."""
    from openrec_tpu_torch.data import Dataset, loaders
    from openrec_tpu_torch.ops import bucketed_topk as bt
    from openrec_tpu_torch.ops import topk as tk
    base = launch_counts()
    t = time.perf_counter()
    data = tradesy_data(loaders, seed, run)
    U, I = data["total_users"], data["total_items"]
    train_ds = Dataset(data["train_data"], U, I, seed=seed)
    val = Dataset(data["val_data"], U, I, seed=seed).evaluation(
        run["eval_batch"], excl_datasets=[train_ds], device_masks=True)
    feats_card = torch.from_numpy(data["item_features"]).to(dev)
    out = {"data": {"users": U, "items": I,
                    "train_records": len(data["train_data"]),
                    "val_records": len(data["val_data"]),
                    "item_features": list(data["item_features"].shape),
                    "user_features": list(data["user_features"].shape)},
           "setup_s": time.perf_counter() - t}
    print(f"visual data: {out['data']} in {out['setup_s']:.1f} s",
          flush=True)
    with tempfile.TemporaryDirectory() as log_dir:
        for name in VISUAL_MODELS:
            out[name] = visual_run(torch, port, name, data, train_ds, val,
                                   feats_card, seed, dev, Path(log_dir), run)
            torch.cuda.empty_cache()
    launches = launch_counts(base)
    calls = {"K1": "pallas", "K2": "pallas2", "K3": "k3"}
    want = {kname: sum(out[n]["serving"]["calls"][m] for n in VISUAL_MODELS)
            for kname, m in calls.items()}
    out["launches"] = launches
    # VBPR's bf16 tables at D = 100: the Tradesy entries' shape
    out["launches_tradesy_bf16"] = {
        kname: out["VBPR"]["serving"]["calls"][m]
        for kname, m in calls.items()}
    if launches != want:
        fail(f"visual: kernel launches {launches}, the path made {want}")
    out["tf32_caught"] = check_tf32_controls("visual", out, VISUAL_MODELS)
    return out


# ------------------------------------------------------------ phase 10

SEQUENCE_MODELS = ("RNNRec-gru", "RNNRec-lstm", "VanillaYouTubeRec",
                   "YouTubeRec")
SEQUENCE_SERVED = ("RNNRec-gru", "YouTubeRec")
# (batch, max_seq_len) of each model's example
SEQUENCE_FEED = {"RNNRec-gru": (256, 100), "RNNRec-lstm": (256, 100),
                 "VanillaYouTubeRec": (100, 20), "YouTubeRec": (256, 20)}
# LastFM's width (992 x 14,598) with ~300 records a user, so that L = 100
# windows fill; 3 genders and 67 geos (examples/youtube_rec_lastfm.py)
# Depth, cut to keep the phase near 90 s (PERF.md §4): RNNRec 150 (GRU)
# and 100 (LSTM) host-fed steps in calls of 50 and 100 device-sampled (the
# example asks for 10,000; one GRU step at L 100 is ~6,300 launches, ~0.1 s
# of host time; at 100 steps the GRU's `pallas` recall sat at its floor,
# PERF.md §6), one profiled step (under the profiler a GRU step takes
# ~7 s); the YouTube models 300 in calls of 100 and a 10-step profiled
# call. Widths, L and batches are the examples'. fp64_check: the models
# whose fp32 card-vs-CPU run is recorded and whose fp64 run is the check
# (as CDL's in phase 8): the GRU RNNRec, whose fp32 run lay
# 319,805-414,431 weights outside in every run with its TF32 control as
# far (PERF.md §6); its fp32 check is `gradient_card_vs_cpu`'s one step
# without Adam. gradient_atol: that check's atol on gradients scaled by
# their max |entry|, above its fp32 readings (cell/wz's, <= 1.43e-6) and
# below its TF32 control's (1.2e-4-5.5e-4 in the cell; PERF.md §6).
SEQUENCE = dict(records_per_user=(250, 351), follow=0.5, test_share=0.1,
                genders=3, geos=67,
                steps={"RNNRec-gru": 150, "RNNRec-lstm": 100,
                       "VanillaYouTubeRec": 300, "YouTubeRec": 300},
                k={"RNNRec-gru": 50, "RNNRec-lstm": 50,
                   "VanillaYouTubeRec": 100, "YouTubeRec": 100},
                profiled_steps={"RNNRec-gru": 1, "RNNRec-lstm": 1,
                                "VanillaYouTubeRec": 10, "YouTubeRec": 10},
                device_steps=100, card_vs_cpu_steps=20, at=(100, 500),
                eval_batch=256, workers=4, fp64_check=("RNNRec-gru",),
                gradient_atol=1e-5)


def lastfm_data(loaders, seed, run=SEQUENCE):
    """LastFM's width on synthetic data from the seed, by numpy: each of
    the 992 users gets 250-350 time-stamped records (ts = position); the
    first item is a popularity draw, and each next one is, with
    probability `follow`, `succ[previous]` for one fixed random
    permutation `succ` of the catalog, else a popularity draw.
    Popularity is `long_tail_items`'s law p(rank r) ~ (r + 10)^-0.9 with
    rank = id, the order TF's log-uniform sampler assumes. Each user's
    last 10 % of records by ts form the test split, as the examples split
    theirs; int32 genders and geos for every user."""
    U, I = loaders.LASTFM["total_users"], loaders.LASTFM["total_items"]
    rng = np.random.default_rng(seed + 10)
    lo, hi = run["records_per_user"]
    n_u = rng.integers(lo, hi, U)
    T = int(n_u.max())
    p = 1.0 / (np.arange(I) + 10.0) ** 0.9
    pop = rng.choice(I, (T, U), p=p / p.sum())
    follow = rng.random((T, U)) < run["follow"]
    succ = rng.permutation(I)
    items = np.empty((T, U), np.int64)
    items[0] = pop[0]
    for t in range(1, T):
        items[t] = np.where(follow[t], succ[items[t - 1]], pop[t])
    t_idx = np.arange(T)[:, None]
    keep = t_idx < n_u[None, :]
    test = keep & (t_idx >= (n_u - np.ceil(run["test_share"] * n_u)
                             .astype(np.int64))[None, :])
    dtype = [("user_id", np.int32), ("item_id", np.int32), ("ts", np.int64)]

    def records(mask):
        t, u = np.nonzero(mask)
        out = np.zeros(len(t), dtype=dtype)
        out["user_id"], out["item_id"], out["ts"] = u, items[t, u], t
        return out
    return {"total_users": U, "total_items": I,
            "train_data": records(keep & ~test),
            "test_data": records(test),
            "gender": rng.integers(0, run["genders"], U).astype(np.int32),
            "geo": rng.integers(0, run["geos"], U).astype(np.int32)}


def sequence_model(port, name, I, dev, gen=None, sampled=True):
    """One of phase 10's models at its example's configuration; sampled=
    False gives the GRU RNNRec a full softmax (card against CPU, whose
    generators differ)."""
    if name.startswith("RNNRec"):
        gru = name == "RNNRec-gru"
        return port.RNNRec(I, 50, 100, 32, cell_type="gru" if gru
                           else "lstm",
                           softmax_samples=1000 if gru and sampled else None,
                           device=dev, generator=gen)
    if name == "VanillaYouTubeRec":
        return port.VanillaYouTubeRec(I, 50, 20, device=dev, generator=gen)
    return port.YouTubeRec(I, 50, 20, total_genders=SEQUENCE["genders"],
                           total_geos=SEQUENCE["geos"], dim_gender_embed=10,
                           dim_geo_embed=40, device=dev, generator=gen)


def popularity_recall(data, test_ds, at):
    """Recall@k of the popularity ranker (train counts; ties rank the
    label first, as `evaluate_temporal`'s strict `>` does) on the test
    split's held-out items, the labels of every model's evaluation."""
    counts = np.bincount(data["train_data"]["item_id"],
                         minlength=data["total_items"])
    hits, n = np.zeros(len(at)), 0
    for b in test_ds.temporal_evaluation(SEQUENCE["eval_batch"],
                                         1).epoch():
        lab = b["label"][b["valid"]]
        rank = (counts[None, :] > counts[lab][:, None]).sum(axis=1)
        hits += [(rank < k).sum() for k in at]
        n += len(lab)
    return {f"Recall@{k}": float(h / n) for k, h in zip(at, hits)}


def evaluate_sequence(trainer, test_ds, L, joins, run):
    m = trainer.evaluate_temporal(test_ds.temporal_evaluation(
        run["eval_batch"], L, joins=joins), at=run["at"])
    out = {"AUC": float(m["AUC"])}
    for i, k in enumerate(run["at"]):
        out[f"Recall@{k}"] = float(m["Recall"][i])
        out[f"NDCG@{k}"] = float(m["NDCG"][i])
    return out


def run_sequence_calls(torch, call, steps, k):
    """`steps` steps in calls of `k` (each returns its [k] losses on the
    device, copied after the call): losses and steps/s by call."""
    losses, its = [], []
    for _ in range(steps // k):
        t = time.perf_counter()
        out = call(k).cpu()
        its.append(k / (time.perf_counter() - t))
        losses.append(out)
    return torch.cat(losses).numpy(), its


def sequence_leg(torch, trainer, call, steps, k, val0, what, evaluate, B):
    """A training leg and its checks: every loss finite, the mean of the
    last `k` below the first `k`'s, AUC and Recall@100 above `val0`."""
    losses, its = run_sequence_calls(torch, call, steps, k)
    means = [float(losses[i:i + k].mean()) for i in range(0, steps, k)]
    if not np.all(np.isfinite(losses)):
        fail(f"{what}: non-finite losses")
    if not means[-1] < means[0]:
        fail(f"{what}: the mean loss of the last {k} steps {means[-1]} is "
             f"not below that of the first {means[0]}")
    val = evaluate(trainer)
    for metric in ("AUC", "Recall@100"):
        if not val[metric] > val0[metric]:
            fail(f"{what}: {metric} did not rise: {val0[metric]} -> "
                 f"{val[metric]}")
    steps_per_s = float(np.median(its))
    return {"steps": steps, "steps_per_call": k, "steps_per_s_by_call": its,
            "steps_per_s": steps_per_s, "examples_per_s": steps_per_s * B,
            "mean_loss_by_call": means, "test": val}


def sampled_softmax_card_vs_cpu(torch, port, model, batch, dev, seed):
    """`sampled_softmax_loss` on the card and on the CPU with the same 1,000
    pinned log-uniform candidates and their expected counts, from the
    trained model's state and output table: the loss and its gradients by
    the table, the bias and the state, rtol 1e-4, atol 1e-6."""
    from openrec_tpu_torch.data import to_device
    from openrec_tpu_torch.modules import losses
    I, S = model.total_items, model.softmax_samples
    with torch.no_grad():
        state = model.hidden(to_device(batch, dev)).cpu()
    ids = losses.log_uniform_sample(S, I, torch.Generator().manual_seed(seed))
    labels = torch.as_tensor(batch["label"]).long()
    values = (ids, S * torch.exp(losses.log_uniform_logprob(labels, I)),
              S * torch.exp(losses.log_uniform_logprob(ids, I)))
    out = {}
    for where, d in (("card", dev), ("cpu", torch.device("cpu"))):
        ts = [t.detach().to(d).clone().requires_grad_() for t in (
            model.out_weight, model.out_bias, state)]
        loss = losses.sampled_softmax_loss(
            *ts, labels.to(d), S, sampled_values=tuple(v.to(d)
                                                       for v in values))
        loss.backward()
        out[where] = [loss.detach().cpu()] + [t.grad.cpu() for t in ts]
    worst = max((a - b).abs().max().item()
                for a, b in zip(out["card"], out["cpu"]))
    within = all(torch.allclose(a, b, rtol=1e-4, atol=1e-6)
                 for a, b in zip(out["card"], out["cpu"]))
    hits = int((ids[None, :] == labels[:, None]).sum())
    if not within:
        fail(f"sequence sampled_softmax_loss: card and CPU differ by {worst}")
    return {"candidates": S, "accidental_hits": hits, "max_abs_diff": worst,
            "loss": out["cpu"][0].item(), "within": within}


def gradient_card_vs_cpu(torch, what, make, trainer, batch, dev, atol):
    """One step's loss and gradients by every parameter on the card and
    on the CPU in fp32, from `trainer`'s weights and without the
    optimizer: forward and backward through the whole model (RNNRec's
    100-step scan). Each gradient is divided by its largest |entry| on
    the CPU before the compare (rtol 1e-4, `atol`): a batch-mean
    gradient lies below 1e-2, where the weights' atol 1e-6 alone would
    pass a TF32 product. A second card run with TF32 matmuls on is the
    control and must lie outside, or the check cannot see a
    lower-precision product in the cell. The fp32 check of a model whose
    20-step run card against CPU cannot be told from its control (the
    GRU RNNRec, PERF.md §6). Returns one record per card run, by
    parameter: the largest |gradient|, |difference| and scaled
    difference, the entries outside, and those whose difference exceeds
    1e-4 of their own |gradient| (what Adam's normalised step
    amplifies)."""
    from openrec_tpu_torch.data import to_device
    start = {k: v.detach() for k, v in trainer.model.params().items()}

    def run(d, tf32=False):
        m = make(d)
        m.load_params({k: v.to(d) for k, v in start.items()})
        names, params = zip(*m.params().items())
        torch.backends.cuda.matmul.allow_tf32 = tf32
        try:
            loss, _ = m.loss(to_device(batch, d))
            grads = torch.autograd.grad(loss, params)
        finally:
            torch.backends.cuda.matmul.allow_tf32 = False
        out = {n: g.cpu() for n, g in zip(names, grads)}
        out["loss"] = loss.detach().cpu()
        return out

    cpu = run(torch.device("cpu"))
    runs = []
    for tf32 in (False, True):
        card, by_param = run(dev, tf32), {}
        for n, q in cpu.items():
            scale = q.abs().max().item() if n != "loss" else 1.0
            scale = scale or 1.0
            diff = (card[n] - q).abs()
            by_param[n] = {
                "max_abs_grad": q.abs().max().item(),
                "max_abs_diff": diff.max().item(),
                "max_scaled_diff": diff.max().item() / scale,
                "outside": int((~torch.isclose(card[n] / scale, q / scale,
                                               rtol=1e-4, atol=atol))
                               .sum()),
                "outside_own_rtol_1e-4": int((diff > 1e-4 * q.abs()).sum())}
        outside = sum(r["outside"] for r in by_param.values())
        runs.append({"dtype": "tf32" if tf32 else "float32",
                     "outside_tolerance": outside, "within": outside == 0,
                     "by_param": by_param})
    if not runs[0]["within"]:
        fail(f"{what}: one step's loss and gradients differ card against "
             f"CPU in fp32: {runs}")
    if runs[1]["within"]:
        fail(f"{what}: the TF32 control of one step's gradients lies "
             f"within the tolerance: {runs}")
    return runs


def sequence_serving(torch, name, model, test_ds, joins, dev):
    """Every test user's last window (the test split's
    `temporal_evaluation`, 4 requests of up to 256: the padding rows of
    its last batch, empty windows, are no user's and are not served)
    served from `model.hidden` against `serving_tables()` in
    fp32: `pallas` and `pallas2` through `bucket_score_topk` and K3
    (`fused_score_topk`). Every returned score must be the fp32 score at
    its id, recall against the exact top-100 at least the target less
    0.01, K3's ids those of torch.topk of `model.score` but for picks
    scoring within 1e-5, and K1 and K2 equal to their plain version at
    their buckets (those launches are given back to the counters)."""
    from openrec_tpu_torch.data import to_device
    from openrec_tpu_torch.ops import bucketed_topk as bt
    from openrec_tpu_torch.ops import topk as tk
    table, bias = model.serving_tables()
    I = table.shape[0]
    ev = test_ds.temporal_evaluation(BATCH, model.max_seq_len, joins=joins)
    hits = {"pallas": 0, "pallas2": 0}
    out = {"requests": 0, "users": 0, "score_max_abs_err": 0.0,
           "score_vs_model_max_abs_diff": 0.0, "ms": {"pallas": [],
                                                      "pallas2": [],
                                                      "k3": []}}
    k3_checks, bad_model, ties_model = [], 0, 0
    plain = {"K1": [], "K2": []}
    for batch in ev.epoch():
        valid = batch["valid"]
        feed = to_device({k: v[valid] for k, v in batch.items()
                          if k not in ("label", "valid")}, dev)
        with torch.no_grad():
            u = model.hidden(feed).contiguous()
            ms = model.score(feed)
        full = tk.dot_scores(u, table, bias)
        out["score_vs_model_max_abs_diff"] = max(
            out["score_vs_model_max_abs_diff"],
            (full - ms).abs().max().item())
        if not near(full, ms).all():
            fail(f"sequence {name}: hidden . table + bias is not the "
                 "model's score")
        ex_v, ex_i = torch.topk(full, K, dim=1)
        ex_sorted = torch.sort(ex_i, dim=1).values
        for m, per in (("pallas", 1), ("pallas2", 2)):
            t = time.perf_counter()
            vals, ids = bt.bucket_score_topk(u, table, bias, K,
                                             recall_target=TARGETS[m],
                                             per_bucket=per)
            torch.cuda.synchronize()
            out["ms"][m].append((time.perf_counter() - t) * 1e3)
            ref = full.gather(1, ids.long())
            out["score_max_abs_err"] = max(out["score_max_abs_err"],
                                           (vals - ref).abs().max().item())
            if not near(vals, ref).all():
                fail(f"sequence {name} {m}: a returned score is not the "
                     "fp32 score at its id")
            found = torch.searchsorted(ex_sorted, ids.to(ex_sorted.dtype))
            hits[m] += int((ex_sorted.gather(1, found.clamp(max=K - 1))
                            == ids).sum())
        t = time.perf_counter()
        vals, ids = tk.fused_score_topk(u, table, bias, K)
        torch.cuda.synchronize()
        out["ms"]["k3"].append((time.perf_counter() - t) * 1e3)
        k3_checks.append(check_topk(torch, vals, ids, ex_v, ex_i, full,
                                    f"sequence {name} K3"))
        ref_v, ref_i = torch.topk(ms, K, dim=1)
        diff = ids != ref_i.to(ids.dtype)
        tie = diff & near(ms.gather(1, ids.long()), ref_v)
        bad_model += int((diff & ~tie).sum())
        ties_model += int(tie.sum())
        counted = launch_counts()
        for kname, m, top2 in (("K1", "pallas", False),
                               ("K2", "pallas2", True)):
            bucket = bt.choose_bucket(I, K, recall_target=TARGETS[m],
                                      per_bucket=2 if top2 else 1)
            plain[kname].append((bucket,) + compare_kernel(
                torch, bt, u, table, bias, bucket, top2))
        give_back(counted)
        out["requests"] += 1
        out["users"] += int(valid.sum())
    n = out["users"] * K
    out["recall_vs_exact"] = {m: h / n for m, h in hits.items()}
    for m, r in out["recall_vs_exact"].items():
        if r < TARGETS[m] - 0.01:
            fail(f"sequence {name} {m}: recall {r} below its floor "
                 f"{TARGETS[m] - 0.01}")
    out["k1k2_vs_plain"] = {
        kname: {"bucket": c[0][0], "max_abs_err": max(x[1] for x in c),
                "id_mismatch_not_tie": sum(x[2] for x in c),
                "id_mismatch_tie": sum(x[3] for x in c)}
        for kname, c in plain.items()}
    for kname, c in out["k1k2_vs_plain"].items():
        if c["id_mismatch_not_tie"]:
            fail(f"sequence {name} {kname}: id mismatches against its "
                 f"plain version that are not near-ties {c}")
    out["k3"] = {"max_abs_err": max(c[0] for c in k3_checks),
                 "id_mismatch_not_tie": sum(c[1] for c in k3_checks),
                 "id_mismatch_tie": sum(c[2] for c in k3_checks),
                 "vs_model_score_not_tie": bad_model,
                 "vs_model_score_tie": ties_model}
    if out["k3"]["id_mismatch_not_tie"] or bad_model:
        fail(f"sequence {name} K3: id mismatches that are not near-ties "
             f"{out['k3']}")
    out["calls"] = {m: out["requests"] for m in ("pallas", "pallas2", "k3")}
    out["table"] = {"shape": list(table.shape), "bias": bias is not None,
                    "dtype": "float32"}
    out["p50_ms"] = {m: float(np.median(v)) for m, v in out["ms"].items()}
    return out


def sequence_run(torch, port, name, data, train_ds, test_ds, seed, dev,
                 run):
    """One model of phase 10: host-fed training from its example's feed,
    the checks of `sequence_leg`, the profiled call, card against CPU,
    and for the GRU RNNRec a device-sampled leg from a fresh copy and the
    pinned sampled-softmax compare; serving for RNNRec-gru and
    YouTubeRec. Returns the record."""
    from openrec_tpu_torch.data import samplers
    store = train_ds.store
    I = store.total_items()
    B, L = SEQUENCE_FEED[name]
    k = run["k"][name]
    joins = ([("user_id", data["gender"], "user_gender"),
              ("user_id", data["geo"], "user_geo")]
             if name == "YouTubeRec" else ())
    seconds, t = {}, time.perf_counter()
    gen = torch.Generator(device=dev).manual_seed(seed)
    model = sequence_model(port, name, I, dev, gen)
    torch.cuda.reset_peak_memory_stats(dev)
    init = {k_: v.detach().clone() for k_, v in model.params().items()}
    trainer = port.Trainer(model, lr=TRAIN["lr"], seed=seed, device=dev)

    def evaluate(tr):
        return evaluate_sequence(tr, test_ds, L, joins, run)
    out = {"config": {"items": I, "batch": B, "max_seq_len": L,
                      "lr": TRAIN["lr"], "optimizer": "lazy_adam",
                      "softmax_samples": getattr(model, "softmax_samples",
                                                 None),
                      "params": {k_: list(v.shape) for k_, v in init.items()}},
           "test_step0": evaluate(trainer),
           "feed": f"temporal{'(joins=...)' if joins else ''}, "
                   f"{run['workers']} workers"}
    host = samplers.TemporalSampler(store, B, L, seed=seed + 7)
    if joins:
        host = samplers.FeatureJoinedSampler(host, joins)
    batches = [host.sample() for _ in range(run["card_vs_cpu_steps"])]
    seconds["setup"] = time.perf_counter() - t

    t = time.perf_counter()
    feed = train_ds.temporal(B, L, num_parallel_calls=run["workers"],
                             joins=joins)
    it = iter(feed)
    out["host_fed"] = r = sequence_leg(
        torch, trainer,
        lambda n: torch.stack([trainer.train_step(next(it))[0]
                               for _ in range(n)]),
        run["steps"][name], k, out["test_step0"],
        f"sequence {name} host-fed", evaluate, B)
    feed.stop()
    seconds["train"] = time.perf_counter() - t
    t = time.perf_counter()
    n = run["profiled_steps"][name]
    profile_steps(torch, r, lambda: trainer.train_step_multi(
        batches[:n]).cpu(), n)
    seconds["profile"] = time.perf_counter() - t
    out["max_memory_allocated_gb"] = \
        torch.cuda.max_memory_allocated(dev) / 1e9

    if name == "RNNRec-gru":
        # F3's rule: the device-sampled leg starts fresh from the same
        # init and is held against its own step 0
        t = time.perf_counter()
        fresh = sequence_model(port, name, I, dev)
        fresh.load_params(init)
        tr_d = port.Trainer(fresh, lr=TRAIN["lr"], seed=seed + 1, device=dev)
        dsamp = port.DeviceTemporalSampler(store, B, L, device=dev)
        out["device_sampled"] = d = sequence_leg(
            torch, tr_d, lambda n_: tr_d.train_steps_device(dsamp, n_),
            run["device_steps"], k, out["test_step0"],
            f"sequence {name} device-sampled", evaluate, B)
        seconds["device_sampled"] = time.perf_counter() - t
        t = time.perf_counter()
        out["sampled_softmax_card_vs_cpu"] = sampled_softmax_card_vs_cpu(
            torch, port, model, batches[0], dev, seed)
        seconds["sampled_softmax_compare"] = time.perf_counter() - t

    val0, val = out["test_step0"], r["test"]
    line = (f"sequence {name} host-fed ({out['feed']}): {r['steps']} steps, "
            f"{r['steps_per_s']:.2f} steps/s, {r['examples_per_s']:.0f} "
            f"examples/s, device busy {r['device_busy_ms_per_step']:.3f} ms "
            f"a step ({r['device_ops_per_step']:.0f} launches; one "
            f"{n}-step call), idle {r['idle_share']:.3f}; mean loss by call "
            + ", ".join(f"{x:.4f}" for x in r["mean_loss_by_call"])
            + f"; test AUC {val0['AUC']:.4f} -> {val['AUC']:.4f}, "
            f"Recall@100 {val0['Recall@100']:.4f} -> "
            f"{val['Recall@100']:.4f}")
    if "device_sampled" in out:
        d = out["device_sampled"]
        line += (f"; device-sampled (fresh copy): {d['steps']} steps, "
                 f"{d['steps_per_s']:.2f} steps/s, mean loss by call "
                 + ", ".join(f"{x:.4f}" for x in d["mean_loss_by_call"])
                 + f", AUC -> {d['test']['AUC']:.4f}, Recall@100 -> "
                 f"{d['test']['Recall@100']:.4f}")
    print(line + "; seconds " + json.dumps(
        {k_: round(v, 2) for k_, v in seconds.items()}), flush=True)

    t = time.perf_counter()

    out["card_vs_cpu"] = card_vs_cpu_checked(
        torch, port, f"sequence {name}",
        lambda d: sequence_model(port, name, I, d, sampled=False), trainer,
        batches, dev, fp64_check=name in run["fp64_check"])
    seconds["card_vs_cpu"] = time.perf_counter() - t
    if name in run["fp64_check"]:
        t = time.perf_counter()
        out["gradient_card_vs_cpu"] = gradient_card_vs_cpu(
            torch, f"sequence {name}",
            lambda d: sequence_model(port, name, I, d, sampled=False),
            trainer, batches[0], dev, run["gradient_atol"])
        seconds["gradient_compare"] = time.perf_counter() - t
    if name in SEQUENCE_SERVED:
        t = time.perf_counter()
        out["serving"] = sequence_serving(torch, name, model, test_ds,
                                          joins, dev)
        seconds["serving"] = time.perf_counter() - t
    out["seconds"] = seconds
    served = ""
    if "serving" in out:
        sv = out["serving"]
        served = ("; serving recall " + json.dumps(sv["recall_vs_exact"])
                  + f", scores max |err| {sv['score_max_abs_err']:.3g}, "
                  "K1/K2 vs plain " + json.dumps(sv["k1k2_vs_plain"])
                  + ", K3 " + json.dumps(sv["k3"]))
    print(f"sequence {name}: card-vs-cpu {len(batches)} steps, "
          + ", ".join(f"{c['dtype']} params max |diff| "
                      f"{c['max_abs_param_diff']:.3g} ("
                      f"{c['params_outside_tolerance']} outside: "
                      f"{json.dumps(c['outside_by_param'])})"
                      for c in out["card_vs_cpu"])
          + "".join(f"; one step's gradients {c['dtype']}: "
                    f"{c['outside_tolerance']} outside, scaled max |diff| "
                    "by param " + json.dumps(
                        {n: float(f"{r['max_scaled_diff']:.3g}")
                         for n, r in c["by_param"].items()})
                    for c in out.get("gradient_card_vs_cpu", ()))
          + "; peak "
          f"{out['max_memory_allocated_gb']:.3f} GB{served}; seconds "
          + json.dumps({k_: round(v, 2) for k_, v in seconds.items()}),
          flush=True)
    return out


def phase_sequence(torch, port, seed, dev, run=SEQUENCE):
    """Phase 10: RNNRec (GRU with sampled softmax, LSTM with the full
    one), VanillaYouTubeRec and YouTubeRec at LastFM width on the
    synthetic sequences of `lastfm_data`; RNNRec-gru's and YouTubeRec's
    next-item top-100 served through K1/K2/K3. The kernels' counters are
    set to 0 here and read at the end."""
    from openrec_tpu_torch.data import Dataset, loaders
    from openrec_tpu_torch.ops import bucketed_topk as bt
    from openrec_tpu_torch.ops import topk as tk
    base = launch_counts()
    t = time.perf_counter()
    data = lastfm_data(loaders, seed, run)
    U, I = data["total_users"], data["total_items"]
    train_ds = Dataset(data["train_data"], U, I, sortby="ts", seed=seed)
    test_ds = Dataset(data["test_data"], U, I, sortby="ts", seed=seed)
    out = {"data": {"users": U, "items": I,
                    "train_records": len(data["train_data"]),
                    "test_records": len(data["test_data"]),
                    "follow": run["follow"]},
           "popularity": popularity_recall(data, test_ds, run["at"]),
           "setup_s": time.perf_counter() - t}
    print(f"sequence data: {out['data']}, popularity ranker "
          + json.dumps(out["popularity"]) + f" in {out['setup_s']:.1f} s",
          flush=True)
    for name in SEQUENCE_MODELS:
        out[name] = sequence_run(torch, port, name, data, train_ds, test_ds,
                                 seed, dev, run)
        pop = out["popularity"]["Recall@100"]
        print(f"sequence {name}: test Recall@100 "
              f"{out[name]['host_fed']['test']['Recall@100']:.4f}, "
              f"popularity ranker {pop:.4f}", flush=True)
        torch.cuda.empty_cache()
    launches = launch_counts(base)
    calls = {"K1": "pallas", "K2": "pallas2", "K3": "k3"}
    want = {kname: sum(out[n]["serving"]["calls"][m]
                       for n in SEQUENCE_SERVED)
            for kname, m in calls.items()}
    out["launches"] = launches
    # RNNRec-gru's requests: the LastFM entries' fp32 D = 32 shape
    out["launches_lastfm_d32"] = {
        kname: out["RNNRec-gru"]["serving"]["calls"][m]
        for kname, m in calls.items()}
    if launches != want:
        fail(f"sequence: kernel launches {launches}, the path made {want}")
    # the fp64-checked models' 20-step controls read as their fp32 runs;
    # `gradient_card_vs_cpu` holds theirs outside
    out["tf32_caught"] = check_tf32_controls(
        "sequence", out,
        [n for n in SEQUENCE_MODELS if n not in run["fp64_check"]])
    return out


# ------------------------------------------------------------ phase 11

# ItrMLP at the example's configuration (examples/itr_mlp.py:26-31,
# 54-57): dim 20, user and item MLPs 30-30-20, batch 256, lazy_adam lr
# 1e-3, the tables forward-propagated every 200 steps, identity
# pretraining 2,000 steps of 32 per MLP; at Netflix's width (NETFLIX) on
# `netflix_data`'s synthetic ratings. Depth, cut to keep the phase near
# 90 s (PERF.md §4): 1,200 host-fed steps (one chronological epoch of
# the 1.8 M training records is 7,031) with val eval every 600, and the
# first 51,200 held-out records evaluated (200 batches).
# bias_noise_limit: card against CPU, the max |diff| allowed at the MLP
# biases before a batch norm (their true gradient is 0, and Adam steps
# them on each device's rounding noise; the batch norm removes them from
# every output): 6.8x their card-vs-CPU reading on one H100 (2.94e-4
# in three runs; the CPU's own fp32 against its fp64 run 2.36e-4, and
# 6.04e-4 in a CPU rehearsal at 20,000 x 2,000), 10x below Adam's bound
# of steps x lr, while every other parameter stays within rtol 1e-4 /
# atol 1e-6, where the TF32 control lies outside (PERF.md §6).
ITR = dict(records=2_000_000, train_share=0.9, eval_records=51_200,
           rank=8, dim=20, mlp=(30, 30, 20), batch=256, lr=1e-3,
           update_interval=200, eval_interval=600, steps=1200,
           pretrain_steps=2000, pretrain_batch=32, profiled_steps=10,
           card_vs_cpu_steps=20, card_vs_cpu_update=10, update_steps=50,
           bias_noise_limit=2e-3, users=None, items=None)


def netflix_data(seed, run=ITR):
    """Netflix's width (480,189 users x 17,770 movies unless `run` says
    otherwise) with `run["records"]` synthetic time-ordered ratings from
    the seed, by numpy, in the example's law: uniform users and items,
    label = sigmoid of a rank-8 affinity, computed per record (the
    example's dense [U, I] affinity would take 34 GB here). The first
    `train_share` of the records (in time order) train, the rest are
    held out."""
    U = run["users"] or NETFLIX["users"]
    I = run["items"] or NETFLIX["items"]
    rng = np.random.default_rng(seed + 11)
    n = run["records"]
    raw = np.zeros(n, dtype=[("user_id", np.int32), ("item_id", np.int32),
                             ("label", np.float32)])
    raw["user_id"] = rng.integers(0, U, n)
    raw["item_id"] = rng.integers(0, I, n)
    p = rng.normal(size=(U, run["rank"])).astype(np.float32)
    q = rng.normal(size=(I, run["rank"])).astype(np.float32)
    affinity = np.einsum("nr,nr->n", p[raw["user_id"]], q[raw["item_id"]])
    raw["label"] = 1 / (1 + np.exp(-affinity))
    split = int(n * run["train_share"])
    return {"total_users": U, "total_items": I, "train_data": raw[:split],
            "held_out": raw[split:]}


def itr_model(port, U, I, dev, gen=None, run=ITR):
    return port.ItrMLP(U, I, run["dim"], user_dims=run["mlp"],
                       item_dims=run["mlp"], device=dev, generator=gen)


def explicit_batches(records, start, n, B):
    """`n` batches of `B` records from `start` on, in order, as
    `ExplicitSampler(chronological=True)` makes them."""
    return [{"user_id": records["user_id"][i:i + B].copy(),
             "item_id": records["item_id"][i:i + B].copy(),
             "label": records["label"][i:i + B].copy()}
            for i in range(start, start + n * B, B)]


def itr_update_check(torch, model):
    """One `update_embeddings()` on the card over the flags that steps
    since the last update set, timed by CUDA events and, from the same
    state again, under the profiler. The flags must read 0 after it; the
    visited rows must hold the MLP over the full table as it stood
    (computed beside it, rtol 1e-6), and some of them change (a row the
    MLP maps to itself, such as a zero row through relus that stay off,
    keeps its value: the share that changed is recorded); the rows not
    visited keep their bits."""
    out = {}
    for table, flag, mlp in (("user_embed", "user_flag", model.user_mlp),
                             ("item_embed", "item_flag", model.item_mlp)):
        t, f = model.params()[table], model.params()[flag]
        visited = f.detach() > 0
        with torch.no_grad():
            want = mlp(t.detach())
        out[table] = {"before": t.detach().clone(), "visited": visited,
                      "want": want}
    saved = {k: v.detach().clone() for k, v in model.params().items()}
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    model.update_embeddings()
    end.record()
    end.synchronize()
    rec = {"events_ms": start.elapsed_time(end)}
    after = {k: v.detach().clone() for k, v in model.params().items()}
    for table, flag in (("user_embed", "user_flag"),
                        ("item_embed", "item_flag")):
        o = out[table]
        now, vis = after[table], o["visited"]
        changed = (now != o["before"]).any(dim=1)
        r = {"rows": int(now.shape[0]), "visited": int(vis.sum()),
             "visited_changed": int((changed & vis).sum()),
             "flags_after": int((after[flag] != 0).sum()),
             "unvisited_bit_identical": bool(torch.equal(
                 now[~vis], o["before"][~vis])),
             "visited_max_abs_diff_vs_mlp": (
                 now[vis] - o["want"][vis]).abs().max().item()
             if vis.any() else 0.0}
        rec[table] = r
        if r["flags_after"] or not r["unvisited_bit_identical"] \
                or not r["visited"] \
                or not torch.allclose(now[vis], o["want"][vis], rtol=1e-6,
                                      atol=1e-6) \
                or not r["visited_changed"]:
            fail(f"itr ItrMLP: the update's checks failed {rec}")
    # device time of one update by the profiler, from the same state
    model.load_params(saved)
    prof = profile_device(torch, model.update_embeddings, 1,
                          rec["events_ms"])
    rec["device_ms"] = prof["device_busy_ms_per_call"]
    rec["launches"] = prof["device_ops_per_call"]
    rec["top_device_ms"] = prof["top_device_ms_per_call"]
    for table in ("user_embed", "item_embed"):
        if not torch.allclose(model.params()[table], after[table],
                              rtol=1e-6, atol=1e-6):
            fail("itr ItrMLP: a second update from the same state gave "
                 "other rows")
    return rec


def itr_serving(torch, model, dev, rng):
    """8 requests of 256 users, each request's user vectors from
    `model.user_vecs` (batch norm over the request) against
    `serving_tables()` in fp32: `pallas` and `pallas2` through
    `bucket_score_topk` and K3 (`fused_score_topk`). Every returned score
    must be the fp32 logit at its id, recall against the exact top-100 at
    least the target less 0.01, K3's ids those of torch.topk of the
    logits but for picks scoring within 1e-5 (sigmoid ties large logits
    in fp32, so ids are compared on the logits), sigmoid(logits) near
    `model.score`, and K1 and K2 equal to their plain version at their
    buckets (those launches are given back to the counters)."""
    from openrec_tpu_torch.ops import bucketed_topk as bt
    from openrec_tpu_torch.ops import topk as tk
    table, bias = model.serving_tables()
    I = table.shape[0]
    hits = {"pallas": 0, "pallas2": 0}
    out = {"requests": 0, "score_max_abs_err": 0.0,
           "sigmoid_vs_score_max_abs_diff": 0.0,
           "ms": {"pallas": [], "pallas2": [], "k3": []}}
    k3_checks, plain = [], {"K1": [], "K2": []}
    for _ in range(REQUESTS):
        users = torch.as_tensor(rng.integers(0, model.total_users, BATCH),
                                device=dev)
        with torch.no_grad():
            u = model.user_vecs({"user_id": users}).contiguous()
            ms = model.score({"user_id": users})
        full = tk.dot_scores(u, table, bias)
        sig = torch.sigmoid(full)
        out["sigmoid_vs_score_max_abs_diff"] = max(
            out["sigmoid_vs_score_max_abs_diff"],
            (sig - ms).abs().max().item())
        if not near(sig, ms).all():
            fail("itr ItrMLP: sigmoid(user_vecs . table + bias) is not the "
                 "model's score")
        ex_v, ex_i = torch.topk(full, K, dim=1)
        ex_sorted = torch.sort(ex_i, dim=1).values
        for m, per in (("pallas", 1), ("pallas2", 2)):
            t = time.perf_counter()
            vals, ids = bt.bucket_score_topk(u, table, bias, K,
                                             recall_target=TARGETS[m],
                                             per_bucket=per)
            torch.cuda.synchronize()
            out["ms"][m].append((time.perf_counter() - t) * 1e3)
            ref = full.gather(1, ids.long())
            out["score_max_abs_err"] = max(out["score_max_abs_err"],
                                           (vals - ref).abs().max().item())
            if not near(vals, ref).all():
                fail(f"itr ItrMLP {m}: a returned score is not the fp32 "
                     "logit at its id")
            found = torch.searchsorted(ex_sorted, ids.to(ex_sorted.dtype))
            hits[m] += int((ex_sorted.gather(1, found.clamp(max=K - 1))
                            == ids).sum())
        t = time.perf_counter()
        vals, ids = tk.fused_score_topk(u, table, bias, K)
        torch.cuda.synchronize()
        out["ms"]["k3"].append((time.perf_counter() - t) * 1e3)
        k3_checks.append(check_topk(torch, vals, ids, ex_v, ex_i, full,
                                    "itr ItrMLP K3"))
        counted = launch_counts()
        for kname, m, top2 in (("K1", "pallas", False),
                               ("K2", "pallas2", True)):
            bucket = bt.choose_bucket(I, K, recall_target=TARGETS[m],
                                      per_bucket=2 if top2 else 1)
            plain[kname].append((bucket,) + compare_kernel(
                torch, bt, u, table, bias, bucket, top2))
        give_back(counted)
        out["requests"] += 1
    n = out["requests"] * BATCH * K
    out["recall_vs_exact"] = {m: h / n for m, h in hits.items()}
    for m, r in out["recall_vs_exact"].items():
        if r < TARGETS[m] - 0.01:
            fail(f"itr ItrMLP {m}: recall {r} below its floor "
                 f"{TARGETS[m] - 0.01}")
    out["k1k2_vs_plain"] = {
        kname: {"bucket": c[0][0], "max_abs_err": max(x[1] for x in c),
                "id_mismatch_not_tie": sum(x[2] for x in c),
                "id_mismatch_tie": sum(x[3] for x in c)}
        for kname, c in plain.items()}
    for kname, c in out["k1k2_vs_plain"].items():
        if c["id_mismatch_not_tie"]:
            fail(f"itr ItrMLP {kname}: id mismatches against its plain "
                 f"version that are not near-ties {c}")
    out["k3"] = {"max_abs_err": max(c[0] for c in k3_checks),
                 "id_mismatch_not_tie": sum(c[1] for c in k3_checks),
                 "id_mismatch_tie": sum(c[2] for c in k3_checks)}
    if out["k3"]["id_mismatch_not_tie"]:
        fail(f"itr ItrMLP K3: id mismatches that are not near-ties "
             f"{out['k3']}")
    out["calls"] = {m: out["requests"] for m in ("pallas", "pallas2", "k3")}
    out["table"] = {"shape": list(table.shape), "bias": True,
                    "dtype": str(table.dtype).split(".")[-1],
                    "contiguous": table.is_contiguous()}
    out["p50_ms"] = {m: float(np.median(v)) for m, v in out["ms"].items()}
    return out


def phase_itr(torch, port, seed, dev, run=ITR):
    """Phase 11: ItrMLP at Netflix width on `netflix_data`: identity
    pretraining, host-fed chronological training through Trainer.train
    with the table update every `update_interval` steps and the
    per-record MSE eval, the update's checks, the profiled call, serving
    through K1/K2/K3, and card against CPU across a full-table update.
    The kernels' counters are set to 0 here and read at the end."""
    with tempfile.TemporaryDirectory() as log_dir:
        return itr_run(torch, port, seed, dev, Path(log_dir), run)


def itr_run(torch, port, seed, dev, log_dir, run):
    from openrec_tpu_torch.data import Dataset
    from openrec_tpu_torch.ops import bucketed_topk as bt
    from openrec_tpu_torch.ops import topk as tk
    base = launch_counts()
    seconds, t = {}, time.perf_counter()
    data = netflix_data(seed, run)
    U, I, B = data["total_users"], data["total_items"], run["batch"]
    train = data["train_data"]
    train_ds = Dataset(train, U, I, seed=seed)
    val_ds = Dataset(data["held_out"][:run["eval_records"]], U, I,
                     seed=seed)
    val = val_ds.regression_evaluation(B)
    const_mse = float(np.mean((val_ds.store.raw_data["label"]
                               - train["label"].mean()) ** 2))
    gen = torch.Generator(device=dev).manual_seed(seed)
    model = itr_model(port, U, I, dev, gen, run)
    torch.cuda.reset_peak_memory_stats(dev)
    log_file = log_dir / "ItrMLP.jsonl"
    trainer = port.Trainer(model, lr=run["lr"], seed=seed, device=dev,
                           log_file=str(log_file))
    out = {"data": {"users": U, "items": I, "records": run["records"],
                    "train_records": len(train),
                    "eval_records": len(val_ds.store.raw_data),
                    "rank": run["rank"]},
           "config": {"dim": run["dim"], "mlp": list(run["mlp"]),
                      "batch": B, "lr": run["lr"], "optimizer": "lazy_adam",
                      "update_interval": run["update_interval"],
                      "pretrain": [run["pretrain_steps"],
                                   run["pretrain_batch"]]},
           "val_step0": float(trainer.evaluate(val)["MSE"]),
           "constant_predictor_mse": const_mse}
    seconds["setup"] = time.perf_counter() - t

    t = time.perf_counter()
    model.pretrain_identity(gen, steps=run["pretrain_steps"],
                            batch=run["pretrain_batch"])
    torch.cuda.synchronize()
    seconds["pretrain"] = time.perf_counter() - t
    out["val_pretrained"] = float(trainer.evaluate(val)["MSE"])

    t = time.perf_counter()
    feed = train_ds.explicit(B, chronological=True)
    res = trainer.train(run["steps"], feed, eval_samplers={"val": val},
                        eval_interval=run["eval_interval"],
                        update_interval=run["update_interval"],
                        verbose=False)
    seconds["train"] = time.perf_counter() - t
    recs = [json.loads(x) for x in log_file.read_text().splitlines()]
    losses = [r_["loss"] for r_ in recs]
    its = [r_["iters_per_s"] for r_ in recs]
    steps_per_s = float(np.median(its))
    r = {"steps": trainer.global_step, "steps_per_s_by_call": its,
         "steps_per_s": steps_per_s, "examples_per_s": steps_per_s * B,
         "mean_loss_by_call": losses,
         "val_mse_by_call": [r_["eval"]["val"]["MSE"] for r_ in recs],
         "val": float(res["val"]["MSE"])}
    out["host_fed"] = r
    if trainer.global_step != run["steps"] \
            or len(recs) != run["steps"] // run["eval_interval"] \
            or not np.all(np.isfinite(losses)):
        fail(f"itr ItrMLP: steps {trainer.global_step}, losses {losses}")
    if not r["val"] < out["val_pretrained"]:
        fail(f"itr ItrMLP: val MSE did not fall below its value after "
             f"pretraining: {out['val_pretrained']} -> {r['val']}")
    if model.user_flag.any() or model.item_flag.any():
        fail("itr ItrMLP: flags set after the last scheduled update")

    t = time.perf_counter()
    n = run["profiled_steps"]
    batches = explicit_batches(train, run["steps"] * B,
                               max(n, run["card_vs_cpu_steps"],
                                   run["update_steps"]), B)
    profile_steps(torch, r, lambda: trainer.train_step_multi(
        batches[:n]).cpu(), n)
    seconds["profile"] = time.perf_counter() - t
    t = time.perf_counter()
    trainer.train_step_multi(batches[n:run["update_steps"]])
    out["update"] = itr_update_check(torch, model)
    seconds["update_check"] = time.perf_counter() - t
    out["max_memory_allocated_gb"] = \
        torch.cuda.max_memory_allocated(dev) / 1e9
    up = out["update"]
    print(f"itr ItrMLP host-fed (explicit, chronological): {r['steps']} "
          f"steps, {r['steps_per_s']:.1f} steps/s, "
          f"{r['examples_per_s']:.0f} examples/s, device busy "
          f"{r['device_busy_ms_per_step']:.4f} ms a step "
          f"({r['device_ops_per_step']:.0f} launches; one {n}-step call), "
          f"idle {r['idle_share']:.3f}; mean loss by call "
          + ", ".join(f"{x:.4f}" for x in losses)
          + f"; val MSE {out['val_step0']:.5f} (init) -> "
          f"{out['val_pretrained']:.5f} (pretrained) -> {r['val']:.5f} "
          f"(constant predictor {const_mse:.5f}); update_embeddings "
          f"{up['device_ms']:.4f} ms device ({up['launches']:.0f} "
          f"launches), {up['events_ms']:.4f} ms by events, visited "
          f"users {up['user_embed']['visited']} / items "
          f"{up['item_embed']['visited']}; peak "
          f"{out['max_memory_allocated_gb']:.3f} GB; seconds "
          + json.dumps({k_: round(v, 2) for k_, v in seconds.items()}),
          flush=True)

    t = time.perf_counter()
    out["serving"] = sv = itr_serving(torch, model, dev,
                                      np.random.default_rng(seed + 12))
    seconds["serving"] = time.perf_counter() - t
    launches = launch_counts(base)
    want = {"K1": sv["calls"]["pallas"], "K2": sv["calls"]["pallas2"],
            "K3": sv["calls"]["k3"]}
    out["launches"] = launches
    if launches != want:
        fail(f"itr: kernel launches {launches}, the path made {want}")
    print(f"itr ItrMLP serving (fp32 D = {run['dim']}, {BATCH} x {I:,}): "
          "recall "
          + json.dumps(sv["recall_vs_exact"])
          + f", scores max |err| {sv['score_max_abs_err']:.3g}, "
          f"sigmoid vs score {sv['sigmoid_vs_score_max_abs_diff']:.3g}, "
          "K1/K2 vs plain " + json.dumps(sv["k1k2_vs_plain"]) + ", K3 "
          + json.dumps(sv["k3"]) + ", p50 ms " + json.dumps(sv["p50_ms"])
          + f"; launches {json.dumps(launches)}", flush=True)

    t = time.perf_counter()
    pre_bn_biases = [n for n in model.params()
                     if "_mlp/" in n and n.endswith("/b")]
    out["card_vs_cpu"] = card_vs_cpu_checked(
        torch, port, "itr ItrMLP", lambda d: itr_model(port, U, I, d,
                                                       run=run),
        trainer, batches[:run["card_vs_cpu_steps"]], dev,
        update_interval=run["card_vs_cpu_update"],
        noise_limit=(pre_bn_biases, run["bias_noise_limit"]))
    seconds["card_vs_cpu"] = time.perf_counter() - t
    out["seconds"] = seconds
    print(f"itr ItrMLP: card-vs-cpu {run['card_vs_cpu_steps']} steps "
          f"(update every {run['card_vs_cpu_update']}), "
          + ", ".join(f"{c['dtype']} params max |diff| "
                      f"{c['max_abs_param_diff']:.3g} ("
                      f"{c['params_outside_tolerance']} outside, max |diff| "
                      "by param " + json.dumps(
                          {n: float(f"{v:.3g}") for n, v in
                           c["max_abs_diff_outside_by_param"].items()})
                      + ")" for c in out["card_vs_cpu"])
          + f"; the MLP biases before a batch norm within "
          f"{run['bias_noise_limit']:g}, the rest within rtol 1e-4 / atol "
          "1e-6; seconds " + json.dumps({k_: round(v, 2)
                                         for k_, v in seconds.items()}),
          flush=True)
    return out


# ------------------------------------------------------------ phase 12

PARALLEL = dict(shards=(2, 4), sparse_steps=10, sparse_timed=20, batch=4096,
                lr=1e-3, trainer_steps=200, trainer_k=100, trainer_batch=1000,
                trainer_lr=1e-3, dim=50, itr_steps=50, itr_records=100_000)
# (f): two gloo ranks sharing the card, each model `steps` SGD steps
# (a step the size of the gradient, so that rounding stays rounding; the
# CPU tests' choice) at its phase's width and batch (global, split over
# the ranks), held against one rank within the CPU tests' bars.
# widths: None (the published ones) or smaller ones for a CPU rehearsal:
# {"netflix": (U, I), "citeulike": (U, I), "lastfm": (U, I)}.
DP2 = dict(steps=10, records=100_000, device="cuda", timeout=300,
           lr={"ItrMLP": 1e-3, "NeuMF": 1e-3, "RNNRec": 0.05},
           batch={"ItrMLP": 256, "NeuMF": 1000, "RNNRec": 256},
           rtol=1e-5, atol=1e-6, widths=None)
DP2_MODELS = ("ItrMLP", "NeuMF", "RNNRec")
# the code of one rank of (f), as `parallel/launch.py` starts it
DP2_RANK = r"""
import json, os
import chip_smoke
chip_smoke.dp2_rank(int(os.environ["CHIP_SMOKE_SEED"]),
                    json.loads(os.environ["CHIP_SMOKE_DP2"]))
"""
# (g): the same two gloo ranks as ONE data rank x TWO model ranks, every
# table row-sharded over 'model' by the default rules: the GRU RNNRec at
# LastFM width with its full (vocabulary-parallel) softmax, host-fed, and
# with the sampled softmax, device-sampled; then its shards serve
# `requests` windows through K1 and K2; UCML at CiteULike width (one pad
# user row; tables x `ucml_scale`, so that censoring bites); ItrMLP at
# Netflix width (one pad user row) with one `update_embeddings` after its
# steps. Each held against the flat Trainer on one rank of the same card
# within (f)'s bars. widths: as DP2's.
MP2 = dict(steps=10, records=100_000, device="cuda", timeout=300,
           lr={"RNNRec": 0.05, "RNNRec-sampled": 0.05, "UCML": 0.01,
               "ItrMLP": 1e-3},
           batch={"RNNRec": 256, "RNNRec-sampled": 256, "UCML": 1000,
                  "ItrMLP": 256},
           ucml_scale=10.0, requests=256, rtol=1e-5, atol=1e-6, widths=None)
MP2_MODELS = ("RNNRec", "RNNRec-sampled", "UCML", "ItrMLP")
MP2_RANK = r"""
import json, os
import chip_smoke
chip_smoke.mp2_rank(int(os.environ["CHIP_SMOKE_SEED"]),
                    json.loads(os.environ["CHIP_SMOKE_MP2"]))
"""


def one_rank_mesh(torch, par, dev):
    """A one-rank NCCL process group (its TCPStore on a free localhost
    port) and a 1 x 1 ('data', 'model') mesh. A failed init raises."""
    import torch.distributed as dist
    t = time.perf_counter()
    par.initialize_multihost(f"127.0.0.1:{par.mesh._free_port()}",
                             num_processes=1, process_id=0, device=dev)
    mesh = par.make_mesh(1, 1, device=dev)
    return mesh, {"backend": dist.get_backend(), "world": 1,
                  "mesh": list(mesh.mesh.shape),
                  "init_s": time.perf_counter() - t}


def shard_merge(torch, par, bt, u, Vp, bp, m, target, per_bucket, plain):
    """The shard-local parts of `sharded_pallas_topk` for m shards of the
    padded table, called in turn in this process, then merged. plain=True
    runs K1's / K2's plain version per shard instead of the kernel."""
    n = Vp.shape[0] // m
    vals, ids = [], []
    for s in range(m):
        v, b = Vp[s * n:(s + 1) * n], bp[s * n:(s + 1) * n]
        if plain:
            bucket = bt.choose_bucket(n, K, recall_target=target,
                                      per_bucket=per_bucket)
            out = bt.bucket_max_plain(u, v, b, bucket,
                                      top2=per_bucket == 2)
            cv = torch.cat(out[0::2], dim=1)
            ci = torch.cat(out[1::2], dim=1)
            tv, pos = par.embedding.topk_ordered(cv, K)
            vals.append(tv)
            ids.append(ci.gather(1, pos) + s * n)
        else:
            tv, ti = par.embedding.pallas_topk_local(
                u, v, b, K, s, recall_target=target, per_bucket=per_bucket)
            vals.append(tv)
            ids.append(ti)
    return par.merge_topk(torch.cat(vals, dim=1), torch.cat(ids, dim=1), K)


def parallel_retrieval(torch, par, bt, mesh, seed, dev, run):
    """(a) `sharded_pallas_topk` on the one-rank mesh at the Amazon serving
    shape against the single-device `bucket_score_topk`, bit for bit,
    K1/K2 launched once a request; (b) the shard-local parts for m = 2 and
    m = 4 in one process, merged: every score the fp32 score at its id,
    recall against 'exact' at least the target less 0.01, ids equal to
    the same merge over the plain versions but for near-ties."""
    gen = torch.Generator(device=dev).manual_seed(seed + 21)
    I, D = AMAZON["items"], AMAZON["dim"]
    V = (torch.rand(I, D, generator=gen, device=dev) * 0.1 - 0.05).to(
        torch.bfloat16)
    b = torch.randn(I, generator=gen, device=dev) * 0.01
    U = (torch.rand(AMAZON["users"], D, generator=gen, device=dev) * 0.1
         - 0.05).to(torch.bfloat16)
    rng = np.random.default_rng(seed + 22)
    reqs = [U[torch.as_tensor(rng.choice(AMAZON["users"], BATCH,
                                         replace=False), device=dev)]
            for _ in range(REQUESTS)]
    out = {"a": {}, "b": {}}
    for kname, method in (("K1", "pallas"), ("K2", "pallas2")):
        pb, target = (2 if kname == "K2" else 1), TARGETS[method]
        launched, ms_sharded, ms_single = 0, [], []
        for u in reqs:
            before = launch_counts()
            torch.cuda.synchronize()
            t = time.perf_counter()
            sv, si = par.sharded_pallas_topk(u, V, b, K, mesh,
                                             recall_target=target,
                                             per_bucket=pb)
            torch.cuda.synchronize()
            ms_sharded.append((time.perf_counter() - t) * 1e3)
            launched += launch_counts(before)[kname]
            t = time.perf_counter()
            rv, ri = bt.bucket_score_topk(u, V, b, K, recall_target=target,
                                          per_bucket=pb)
            torch.cuda.synchronize()
            ms_single.append((time.perf_counter() - t) * 1e3)
            if not (torch.equal(sv, rv) and torch.equal(si, ri)):
                fail(f"parallel (a) {method}: the one-rank sharded top-k "
                     "differs from bucket_score_topk")
        if launched != REQUESTS:
            fail(f"parallel (a): {kname} launched {launched} times over "
                 f"{REQUESTS} requests")
        p50 = float(np.median(ms_sharded))
        prof = profile_device(torch, lambda: par.sharded_pallas_topk(
            reqs[0], V, b, K, mesh, recall_target=target, per_bucket=pb),
            5, p50)
        out["a"][kname] = {"launches": launched, "bit_identical": True,
                           "p50_ms_sharded": p50,
                           "p50_ms_single": float(np.median(ms_single)),
                           "device_ms_sharded":
                               prof["device_busy_ms_per_call"],
                           "device_ops_sharded": prof["device_ops_per_call"]}
    for m in run["shards"]:
        pad = par.pad_rows(I, m) - I
        Vp = torch.cat([V, V.new_zeros(pad, D)])
        bp = torch.cat([b, b.new_full((pad,), -1e30)])
        for kname, method in (("K1", "pallas"), ("K2", "pallas2")):
            pb, target = (2 if kname == "K2" else 1), TARGETS[method]
            launched, recall, err, ties = 0, [], 0.0, 0
            for u in reqs:
                before = launch_counts()
                vals, ids = shard_merge(torch, par, bt, u, Vp, bp, m,
                                        target, pb, plain=False)
                launched += launch_counts(before)[kname]
                full = u.float() @ V.float().T + b
                ev, ei = par.embedding.topk_ordered(full, K)
                pv, pi = shard_merge(torch, par, bt, u, Vp, bp, m, target,
                                     pb, plain=True)
                e, bad, tie = check_topk(torch, vals, ids, pv, pi, full,
                                         f"parallel (b) m={m} {method}")
                if bad:
                    fail(f"parallel (b) m={m} {method}: {bad} ids differ "
                         "from the plain merge beyond near-ties")
                err, ties = max(err, e), ties + tie
                recall.append(np.mean([
                    len(set(a) & set(c)) / K for a, c in
                    zip(ids.tolist(), ei.tolist())]))
            rec = float(np.mean(recall))
            if rec < target - 0.01:
                fail(f"parallel (b) m={m} {method}: recall {rec} < "
                     f"{target} - 0.01")
            if launched != REQUESTS * m:
                fail(f"parallel (b) m={m}: {kname} launched {launched} "
                     f"times, want {REQUESTS * m}")
            out["b"][f"m{m}_{kname}"] = {
                "shard_rows": Vp.shape[0] // m, "launches": launched,
                "recall_vs_exact": rec, "max_abs_err_vs_plain": err,
                "id_mismatch_tie": ties}
    return out


def parallel_sparse(torch, port, par, mesh, seed, dev, run, cfg=KAGGLE):
    """(c) `make_parallel_sparse_train_step` on the one-rank mesh in every
    dedup mode at full Criteo-Kaggle width: 10 steps under deterministic
    algorithms, bit-identical to the single-device sparse step of the same
    mode from the same init; then the flat mode's wall ms/step both ways
    (the distribution layer's host time at world 1)."""
    from openrec_tpu_torch.training import sparse as tsparse
    rng = np.random.default_rng(seed + 31)
    n, n_timed = run["sparse_steps"], run["sparse_timed"]
    batches = [dlrm_batch(rng, cfg, run["batch"]) for _ in range(n + n_timed)]
    out = {}

    def model():
        return port.DLRM(**cfg, fused_tables=True, device=dev,
                         generator=torch.Generator(device=dev)
                         .manual_seed(seed))

    for mode in DEDUP_MODES:
        single = model()
        tr = port.Trainer(single, lr=run["lr"], device=dev,
                          sparse_tables=tsparse.dlrm_fused_table_spec(
                              single, mode=mode))
        sharded = model()
        step, init = par.make_parallel_sparse_train_step(
            sharded, tsparse.dlrm_fused_table_spec(sharded, mode=mode),
            mesh, learning_rate=run["lr"])
        _, state, _ = init()
        torch.use_deterministic_algorithms(True)
        try:
            ls = [tr.train_step(bt_)[0] for bt_ in batches[:n]]
            lp = []
            for bt_ in batches[:n]:
                state, loss = step(state, bt_)
                lp.append(loss)
        finally:
            torch.use_deterministic_algorithms(False)
        same, worst = sparse_state_equal(
            torch, sparse_snapshot(torch, sharded, state),
            sparse_snapshot(torch, single, tr.opt_state))
        same = same and torch.equal(torch.stack(ls), torch.stack(lp))
        if not same:
            fail(f"parallel (c) {mode}: the world-1 sparse step differs from "
                 f"the single-device one (max rel {worst})")
        r = {"steps": n, "bit_identical": True}
        if mode == "flat":
            for what, call in (
                    ("single", lambda b_: tr.train_step(b_)),
                    ("world1", lambda b_: step(state, b_))):
                torch.cuda.synchronize()
                t = time.perf_counter()
                for b_ in batches[n:]:
                    call(b_)
                torch.cuda.synchronize()
                ms = (time.perf_counter() - t) * 1e3 / n_timed
                prof = profile_device(torch, lambda: call(batches[n]), 5, ms)
                r[f"ms_per_step_{what}"] = ms
                r[f"device_ms_per_step_{what}"] = \
                    prof["device_busy_ms_per_call"]
                r[f"device_ops_per_step_{what}"] = \
                    prof["device_ops_per_call"]
        out[mode] = r
        print(f"parallel (c) {mode}: {n} deterministic steps at world 1 "
              "bit-identical to the single-device step"
              + (f"; flat wall {r['ms_per_step_single']:.3f} ms/step "
                 f"single, {r['ms_per_step_world1']:.3f} ms/step world 1; "
                 f"device {r['device_ms_per_step_single']:.3f} / "
                 f"{r['device_ms_per_step_world1']:.3f} ms, launches "
                 f"{r['device_ops_per_step_single']:.0f} / "
                 f"{r['device_ops_per_step_world1']:.0f}"
                 if mode == "flat" else ""), flush=True)
        del single, tr, sharded, state, step
        torch.cuda.empty_cache()
    return out


def parallel_trainer(torch, port, par, mesh, seed, dev, run):
    """(d) ParallelTrainer on BPR at CiteULike width (phase 5's data, dim
    50, batch 1000, lazy_adam lr 1e-3) on the one-rank mesh: 200 host-fed
    steps; `sharded_dot_eval_metrics` over the val id batches against
    the trainer's dense `evaluate` (rtol 1e-5, atol 1e-6); a sharded
    checkpoint restored into a fresh trainer, bit for bit."""
    from openrec_tpu_torch.data import Dataset, loaders
    from openrec_tpu_torch.metrics import DictMean
    raw = citeulike_data(loaders, seed)
    U, I, D = raw["total_users"], raw["total_items"], run["dim"]
    train_ds = Dataset(raw["train_data"], U, I, seed=seed)
    val_ds = Dataset(raw["val_data"], U, I, seed=seed)
    val = val_ds.evaluation(BATCH, excl_datasets=[train_ds],
                            device_masks=True)
    gen = torch.Generator(device=dev).manual_seed(seed)
    with tempfile.TemporaryDirectory() as ckpt_dir:
        pt = port.ParallelTrainer(port.BPR(U, I, D, D, device=dev,
                                           generator=gen),
                                  mesh, lr=run["trainer_lr"], seed=seed,
                                  save_model_dir=ckpt_dir)
        feed = train_ds.pairwise(batch_size=run["trainer_batch"],
                                 num_parallel_calls=2)
        torch.cuda.synchronize()
        t = time.perf_counter()
        pt.train(run["trainer_steps"], feed,
                 steps_per_call=run["trainer_k"], verbose=False)
        torch.cuda.synchronize()
        train_s = time.perf_counter() - t
        # train() stopped its feed: a fresh one for the profiled steps
        extra = train_ds.pairwise(batch_size=run["trainer_batch"],
                                  num_parallel_calls=2)
        more = iter(extra)
        prof = profile_device(torch, lambda: pt.train_step(next(more)), 5,
                              train_s * 1e3 / run["trainer_steps"])
        extra.stop()
        dense = pt.evaluate(val, at=(50, 100))
        acc = None
        p = pt.model.params()
        for batch in val:
            ids = torch.as_tensor(batch["user_id"], device=dev).long()
            got = par.sharded_dot_eval_metrics(
                p["user_embed"].detach()[ids], p["item_embed"].detach(),
                p["item_bias"].detach(),
                torch.as_tensor(batch["pos_ids"], device=dev),
                torch.as_tensor(batch["excl_ids"], device=dev),
                total_items=I, mesh=mesh, at=(50, 100))
            got = {k: v.cpu().numpy() for k, v in got.items()}
            if acc is None:
                acc = DictMean({k: list(v.shape[1:]) for k, v in got.items()})
            acc.update_state(got, valid=batch.get("valid"))
        sharded = acc.result()
        for k, v in dense.items():
            if not np.allclose(sharded[k], v, rtol=1e-5, atol=1e-6):
                fail(f"parallel (d): sharded eval {k} {sharded[k]} != dense "
                     f"{v}")
        pt.save()
        fresh = port.ParallelTrainer(port.BPR(U, I, D, D, device=dev), mesh,
                                     lr=run["trainer_lr"], seed=seed + 1,
                                     save_model_dir=ckpt_dir)
        fresh.restore()
        from openrec_tpu_torch.convert import flatten_tree
        a = flatten_tree(pt._state_tree())
        b = flatten_tree(fresh._state_tree())
        if a.keys() != b.keys() or not all(torch.equal(a[k], b[k])
                                           for k in a):
            fail("parallel (d): the sharded checkpoint did not restore bit "
                 "for bit")
    out = {"steps": run["trainer_steps"], "train_s": train_s,
           "steps_per_s": run["trainer_steps"] / train_s,
           "device_ms_per_step": prof["device_busy_ms_per_call"],
           "device_ops_per_step": prof["device_ops_per_call"],
           "idle_share": prof["idle_share"],
           "dense": {k: np.asarray(v).tolist() for k, v in dense.items()},
           "sharded": {k: np.asarray(v).tolist() for k, v in sharded.items()},
           "checkpoint_bitwise": True, "leaves": len(a)}
    print(f"parallel (d) ParallelTrainer BPR citeulike: "
          f"{out['steps_per_s']:.1f} steps/s host-fed, device "
          f"{out['device_ms_per_step']:.3f} ms and "
          f"{out['device_ops_per_step']:.0f} launches a step, idle "
          f"{out['idle_share']:.3f}; val AUC dense "
          f"{float(dense['AUC']):.6f} sharded {float(sharded['AUC']):.6f}; "
          f"checkpoint round trip bitwise ({len(a)} leaves)", flush=True)
    return out


def sgd(lr):
    """Plain SGD as a `GradientTransformation` (params <- params - lr * g)."""
    from openrec_tpu_torch.training.optim import GradientTransformation
    return GradientTransformation(
        lambda params, device=None: {},
        lambda g, s, p=None: ({k: -lr * v for k, v in g.items()}, s))


def parallel_itr(torch, port, par, mesh, seed, dev, run):
    """(e) ParallelTrainer on ItrMLP at phase 11's Netflix width on the
    one-rank mesh (replicated, `rules=()`; (g) shards its tables):
    `itr_steps` host-fed steps of the chronological stream under
    deterministic algorithms, then `update_embeddings`, bit-identical to
    the flat Trainer's from the same init (lazy_adam: parameters,
    moments, losses); the wall ms/step of each."""
    from openrec_tpu_torch.convert import flatten_tree
    data = netflix_data(seed, dict(ITR, records=run["itr_records"]))
    U, I, n = data["total_users"], data["total_items"], run["itr_steps"]
    batches = explicit_batches(data["train_data"], 0, n, ITR["batch"])

    def model():
        return itr_model(port, U, I, dev,
                         torch.Generator(device=dev).manual_seed(seed))

    trainers = {"flat": port.Trainer(model(), lr=ITR["lr"], seed=seed,
                                     device=dev),
                "world1": port.ParallelTrainer(model(), mesh, lr=ITR["lr"],
                                               seed=seed, rules=())}
    ms, losses = {}, {}
    torch.use_deterministic_algorithms(True)
    try:
        for what, tr in trainers.items():
            torch.cuda.synchronize()
            t = time.perf_counter()
            losses[what] = torch.stack([tr.train_step(b)[0]
                                        for b in batches])
            torch.cuda.synchronize()
            ms[what] = (time.perf_counter() - t) * 1e3 / n
            tr.model.update_embeddings()
    finally:
        torch.use_deterministic_algorithms(False)
    a, b = ({**flatten_tree(tr.params), **flatten_tree(tr.opt_state)}
            for tr in trainers.values())
    if a.keys() != b.keys() or not all(torch.equal(a[k], b[k]) for k in a) \
            or not torch.equal(losses["flat"], losses["world1"]):
        fail("parallel (e): ItrMLP's world-1 ParallelTrainer differs from "
             "the flat Trainer")
    out = {"users": U, "items": I, "dim": ITR["dim"], "steps": n,
           "batch": ITR["batch"], "bit_identical": True, "leaves": len(a),
           "ms_per_step_flat": ms["flat"], "ms_per_step_world1":
           ms["world1"], "loss_first": float(losses["flat"][0]),
           "loss_last": float(losses["flat"][-1])}
    print(f"parallel (e) ParallelTrainer ItrMLP netflix ({U:,} x {I:,}, D "
          f"{ITR['dim']}) at world 1: {n} deterministic host-fed steps and "
          f"an update bit-identical to the flat Trainer ({len(a)} leaves, "
          f"losses); wall {ms['flat']:.3f} ms/step flat, "
          f"{ms['world1']:.3f} ms/step world 1", flush=True)
    return out


def dp2_setup(torch, port, name, seed, dev, run):
    """(make, global batches or None, device sampler or None, global
    batch) of one (f) model at its phase's width: `make()` builds it from
    a generator seeded `seed`, the same on every rank."""
    from types import SimpleNamespace

    from openrec_tpu_torch.data import (DeviceTemporalSampler,
                                        InteractionStore, loaders)
    widths = run["widths"] or {}
    B, n = run["batch"][name], run["steps"]

    def gen():
        return torch.Generator(device=dev).manual_seed(seed)
    if name == "ItrMLP":
        U, I = widths.get("netflix", (None, None))
        data = netflix_data(seed, dict(ITR, records=run["records"], users=U,
                                       items=I))
        U, I = data["total_users"], data["total_items"]
        return (lambda: itr_model(port, U, I, dev, gen()),
                explicit_batches(data["train_data"], 0, n, B), None, B)
    if name == "NeuMF":
        U, I = widths.get("citeulike", (CITEULIKE["users"],
                                        CITEULIKE["items"]))
        rng = np.random.default_rng(seed + 41)
        batches = [{"user_id": rng.integers(0, U, B).astype(np.int32),
                    "item_id": rng.integers(0, I, B).astype(np.int32),
                    "label": (rng.random(B) < LEGACY["pos_ratio"]).astype(
                        np.float32)} for _ in range(n)]
        return (lambda: legacy_model(port, "NeuMF", U, I, None, dev, gen()),
                batches, None, B)
    if "lastfm" in widths:
        U, I = widths["lastfm"]
        loaders = SimpleNamespace(LASTFM={"total_users": U,
                                          "total_items": I})
    data = lastfm_data(loaders, seed)
    I = data["total_items"]
    store = InteractionStore(data["train_data"], data["total_users"], I,
                             sortby="ts")
    L = SEQUENCE_FEED["RNNRec-gru"][1]
    sampler = DeviceTemporalSampler(store, B // 2, L, device=dev)
    return (lambda: sequence_model(port, "RNNRec-gru", I, dev, gen()),
            None, sampler, B)


def dp2_case(torch, port, par, mesh, name, seed, dev, run, rank):
    """One (f) model: `steps` steps of a ParallelTrainer at two data ranks
    (host-fed: every rank passes the global batch; device-sampled: each
    rank draws its half from fold_in(seed, rank), the loss from the
    shared generator), and on rank 0 the flat Trainer on the same global
    batches from the same init and seed. Wall ms/step of each."""
    make, batches, sampler, B = dp2_setup(torch, port, name, seed, dev, run)
    n, lr = run["steps"], run["lr"][name]

    def timed(fn):
        sync = torch.cuda.synchronize if dev.type == "cuda" else (
            lambda: None)
        sync()
        t = time.perf_counter()
        out = fn()
        sync()
        return out, (time.perf_counter() - t) * 1e3 / n

    pt = port.ParallelTrainer(make(), mesh, optimizer=sgd(lr), seed=seed,
                              rules=())
    if batches is not None:
        losses, ms = timed(lambda: torch.stack(
            [pt.train_step(b)[0] for b in batches]))
    else:
        losses, ms = timed(lambda: pt.train_steps_device(sampler, n))
    out = {"steps": n, "global_batch": B, "lr": lr,
           "feed": "host-fed" if batches is not None else
           "device-sampled (DeviceTemporalSampler, half a rank)",
           "ms_per_step_gloo_d2": ms}
    if rank != 0:
        return out
    ref = port.Trainer(make(), optimizer=sgd(lr), seed=seed, device=dev)
    if batches is None:
        gens = [torch.Generator(device=dev).manual_seed(par.fold_in(seed, r))
                for r in range(2)]
        batches = []
        for _ in range(n):
            parts = [sampler.sample(g) for g in gens]
            batches.append({k: torch.cat([p[k] for p in parts])
                            for k in parts[0]})
    want, ms1 = timed(lambda: torch.stack([ref.train_step(b)[0]
                                           for b in batches]))
    init = {k: v.detach() for k, v in make().params().items()}
    got_p, want_p = pt.params, ref.params
    outside, worst, moved = 0, 0.0, 0.0
    for k, w in want_p.items():
        g, w = got_p[k].detach(), w.detach()
        diff = (g - w).abs()
        outside += int((diff > run["atol"] + run["rtol"] * w.abs()).sum())
        worst = max(worst, float(diff.max()))
        moved = max(moved, float((w - init[k]).abs().max()))
    loss_rel = float(((losses - want).abs() / want.abs()).max())
    out.update({"ms_per_step_one_rank": ms1, "loss_first": float(want[0]),
                "loss_last": float(want[-1]), "loss_max_rel_diff": loss_rel,
                "params_max_abs_diff": worst, "params_outside": outside,
                "params_max_moved": moved,
                "ok": outside == 0 and loss_rel <= run["rtol"]
                and bool(torch.isfinite(want).all())})
    return out


def dp2_rank(seed, run):
    """One rank of (f): joins the two-rank gloo job that
    `parallel.launch.spawn_local` started (CUDA tensors over the host),
    runs every DP2_MODELS case and, on rank 0, prints their results as
    one `DP2 {...}` line."""
    import torch
    import torch.distributed as dist

    import openrec_tpu_torch as port
    from openrec_tpu_torch import parallel as par
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    mesh = par.make_mesh(2, 1, device=run["device"], backend="gloo")
    dev = par.mesh.mesh_device(mesh)
    rank = dist.get_rank()
    out = {"backend": dist.get_backend(), "world": dist.get_world_size(),
           "device": str(dev)}
    for name in DP2_MODELS:
        out[name] = dp2_case(torch, port, par, mesh, name, seed, dev, run,
                             rank)
    if rank == 0:
        print("DP2 " + json.dumps(out), flush=True)


def parallel_gloo(torch, seed, run=DP2):
    """(f) DP2_MODELS at two data ranks sharing the card over gloo (NCCL
    refuses two ranks on one card), launched as `parallel/launch.py`
    launches ranks; each held against one rank on the same card from the
    same init and seed, within rtol / atol. A rank that fails, a result
    outside the bars or a launch past its timeout fails the phase."""
    from openrec_tpu_torch.parallel.launch import spawn_local
    t = time.perf_counter()
    try:
        outs = spawn_local(DP2_RANK, 2, timeout=run["timeout"], env={
            "CHIP_SMOKE_SEED": str(seed), "CHIP_SMOKE_DP2": json.dumps(run)})
    except (RuntimeError, TimeoutError) as e:
        fail(f"parallel (f): the two gloo ranks failed: {str(e)[-3000:]}")
    lines = [ln for ln in outs[0].splitlines() if ln.startswith("DP2 ")]
    if not lines:
        fail(f"parallel (f): rank 0 printed no result: {outs[0][-3000:]}")
    out = json.loads(lines[-1][4:])
    out["launch_s"] = time.perf_counter() - t
    for name in DP2_MODELS:
        r = out[name]
        print(f"parallel (f) {name} at 2 data ranks on one card over gloo "
              f"(collectives through the host, not NCCL), {r['feed']}, "
              f"global batch {r['global_batch']}, {r['steps']} SGD steps: "
              f"{r['ms_per_step_gloo_d2']:.2f} ms/step at d 2, "
              f"{r['ms_per_step_one_rank']:.2f} ms/step one rank; loss "
              f"{r['loss_first']:.6g} -> {r['loss_last']:.6g}, max rel diff "
              f"{r['loss_max_rel_diff']:.3g}; params max |diff| "
              f"{r['params_max_abs_diff']:.3g} ({r['params_outside']} "
              f"outside rtol {run['rtol']:g} / atol {run['atol']:g}), moved "
              f"up to {r['params_max_moved']:.3g}", flush=True)
        if not r["ok"]:
            fail(f"parallel (f): {name} at two data ranks differs from one "
                 f"rank: {json.dumps(r)}")
    return out


def mp2_setup(torch, port, name, seed, dev, run):
    """(make, global batches or None, device sampler or None, global
    batch, request batch or None) of one (g) model at its phase's width:
    `make()` builds it from a generator seeded `seed`, the same on every
    rank; RNNRec's host-fed batches and requests are drawn on the card
    from seeded generators, alike on every rank."""
    from types import SimpleNamespace

    from openrec_tpu_torch.data import (DeviceTemporalSampler,
                                        InteractionStore, loaders)
    widths = run["widths"] or {}
    B, n = run["batch"][name], run["steps"]

    def gen(offset=0):
        return torch.Generator(device=dev).manual_seed(seed + offset)
    if name == "ItrMLP":
        U, I = widths.get("netflix", (None, None))
        data = netflix_data(seed, dict(ITR, records=run["records"], users=U,
                                       items=I))
        U, I = data["total_users"], data["total_items"]
        return (lambda: itr_model(port, U, I, dev, gen()),
                explicit_batches(data["train_data"], 0, n, B), None, B, None)
    if name == "UCML":
        U, I = widths.get("citeulike", (CITEULIKE["users"],
                                        CITEULIKE["items"]))
        rng = np.random.default_rng(seed + 43)
        batches = []
        for _ in range(n):
            p = rng.integers(0, I, B)
            batches.append({"user_id": rng.integers(0, U, B).astype(np.int32),
                            "p_item_id": p.astype(np.int32),
                            "n_item_id": ((p + rng.integers(1, I, B)) % I
                                          ).astype(np.int32)})

        def make():
            model = port.UCML(U, I, CITEULIKE["dim"], CITEULIKE["dim"],
                              margin=ZOO["margin"], device=dev,
                              generator=gen())
            with torch.no_grad():
                model.user_embed.mul_(run["ucml_scale"])
                model.item_embed.mul_(run["ucml_scale"])
            return model
        return make, batches, None, B, None
    if "lastfm" in widths:
        U, I = widths["lastfm"]
        loaders = SimpleNamespace(LASTFM={"total_users": U,
                                          "total_items": I})
    data = lastfm_data(loaders, seed)
    I = data["total_items"]
    store = InteractionStore(data["train_data"], data["total_users"], I,
                             sortby="ts")
    L = SEQUENCE_FEED["RNNRec-gru"][1]
    sampler = DeviceTemporalSampler(store, B, L, device=dev)
    sampled = name == "RNNRec-sampled"
    g = gen(31)
    batches = None if sampled else [sampler.sample(g) for _ in range(n)]
    request = None if sampled else DeviceTemporalSampler(
        store, run["requests"], L, device=dev).sample(gen(32))
    return (lambda: sequence_model(port, "RNNRec-gru", I, dev, gen(),
                                   sampled=sampled),
            batches, None if batches is not None else sampler, B, request)


def pad_report(torch, views):
    """{table: [pad rows of this rank's shard, max |value| there]}."""
    out = {}
    for name, v in views.items():
        pads = v.shard[~v.real_rows()]
        out[name] = [int(pads.shape[0]),
                     float(pads.abs().max()) if pads.numel() else 0.0]
    return out


def mp2_serve(torch, par, bt, model, views, request, full, mesh, k):
    """RNNRec's shards served through `sharded_pallas_topk` (K1 for
    `pallas`, K2 for `pallas2`): each rank its [I/2, 32] out_weight shard,
    pad rows at bias -1e30 (`serving_tables(views)`); after one untimed
    warm-up call of each (the rank process loads the kernels' library),
    launches counted from 0 over the two timed calls; on rank 0 (`full`
    the gathered whole tables, else None) each score against the fp32
    score at its id and recall@k against the exact top-k."""
    with torch.no_grad():
        u = model.hidden(request, tables=views)
        w, b = model.serving_tables(views)
    sync = torch.cuda.synchronize if u.is_cuda else (lambda: None)
    methods = (("K1", "pallas"), ("K2", "pallas2"))
    for kname, method in methods:
        par.sharded_pallas_topk(u, w, b, k, mesh,
                                recall_target=TARGETS[method],
                                per_bucket=2 if kname == "K2" else 1)
    base = launch_counts()
    out = {}
    for kname, method in methods:
        pb, target = (2 if kname == "K2" else 1), TARGETS[method]
        sync()
        t = time.perf_counter()
        vals, ids = par.sharded_pallas_topk(u, w, b, k, mesh,
                                            recall_target=target,
                                            per_bucket=pb)
        sync()
        r = {"launches": launch_counts(base)[kname], "shard_rows":
             int(w.shape[0]), "ms": (time.perf_counter() - t) * 1e3,
             "target": target}
        if full is not None:
            scores = u @ full["out_weight"].T + full["out_bias"]
            ev, ei = torch.topk(scores, k, dim=1)
            at = scores.gather(1, ids.long())
            r.update({
                "ids_in_catalog": bool(((ids >= 0)
                                        & (ids < scores.shape[1])).all()),
                "max_abs_err": float((at - vals).abs().max()),
                "scores_ok": bool(near(at, vals).all()
                                  and torch.isfinite(vals).all()),
                "recall_vs_exact": float(np.mean([
                    len(set(a) & set(c)) / k for a, c in
                    zip(ids.tolist(), ei.tolist())]))})
            r["ok"] = r["ids_in_catalog"] and r["scores_ok"] \
                and r["recall_vs_exact"] >= target - 0.01
        out[kname] = r
    return out


def mp2_case(torch, port, par, bt, mesh, name, seed, dev, run, rank):
    """One (g) model: `steps` SGD steps of a ParallelTrainer whose tables
    are row-sharded over the two model ranks (host-fed: every rank passes
    the global batch; device-sampled: the rank generator of data rank 0,
    the loss's from the shared generator), ItrMLP's `update_embeddings`
    over each shard, RNNRec's shards served; on rank 0 the flat Trainer
    on the same batches from the same init and seed. Wall ms of each."""
    make, batches, sampler, B, request = mp2_setup(torch, port, name, seed,
                                                   dev, run)
    n, lr = run["steps"], run["lr"][name]
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)

    def timed(fn, per=n):
        sync()
        t = time.perf_counter()
        out = fn()
        sync()
        return out, (time.perf_counter() - t) * 1e3 / per

    pt = port.ParallelTrainer(make(), mesh, optimizer=sgd(lr), seed=seed)
    if batches is not None:
        losses, ms = timed(lambda: torch.stack(
            [pt.train_step(b)[0] for b in batches]))
    else:
        losses, ms = timed(lambda: pt.train_steps_device(sampler, n))
    views = pt.tables()
    out = {"steps": n, "global_batch": B, "lr": lr,
           "feed": "host-fed" if batches is not None else
           "device-sampled (DeviceTemporalSampler)",
           "sharded": sorted(views), "ms_per_step_m2": ms}
    if name == "ItrMLP":
        _, out["update_ms_m2"] = timed(
            lambda: pt.model.update_embeddings(tables=views), 1)
    out["pads"] = pad_report(torch, views)
    with par.full_params(pt.model, pt.shardings, mesh):
        got = {k: v.detach().clone() for k, v in pt.params.items()}
    if request is not None:
        out["serving"] = mp2_serve(torch, par, bt, pt.model, views, request,
                                   got if rank == 0 else None, mesh,
                                   K)
    if rank != 0:
        return out
    ref = port.Trainer(make(), optimizer=sgd(lr), seed=seed, device=dev)
    if batches is None:
        g = torch.Generator(device=dev).manual_seed(par.fold_in(seed, 0))
        batches = [sampler.sample(g) for _ in range(n)]
    want, ms1 = timed(lambda: torch.stack([ref.train_step(b)[0]
                                           for b in batches]))
    if name == "ItrMLP":
        _, out["update_ms_one_rank"] = timed(ref.model.update_embeddings, 1)
    init = {k: v.detach() for k, v in make().params().items()}
    outside, worst, moved = 0, 0.0, 0.0
    for k, w in ref.params.items():
        g, w = got[k], w.detach()
        if g.shape != w.shape:
            fail(f"parallel (g) {name}: gathered '{k}' is "
                 f"{tuple(g.shape)}, not {tuple(w.shape)}")
        diff = (g - w).abs()
        outside += int((diff > run["atol"] + run["rtol"] * w.abs()).sum())
        worst = max(worst, float(diff.max()))
        moved = max(moved, float((w - init[k]).abs().max()))
    loss_rel = float(((losses - want).abs() / want.abs()).max())
    out.update({"ms_per_step_one_rank": ms1, "loss_first": float(want[0]),
                "loss_last": float(want[-1]), "loss_max_rel_diff": loss_rel,
                "params_max_abs_diff": worst, "params_outside": outside,
                "params_max_moved": moved})
    if name == "UCML":
        ids = {"user_embed": np.concatenate([b["user_id"] for b in batches]),
               "item_embed": np.concatenate(
                   [np.r_[b["p_item_id"], b["n_item_id"]] for b in batches])}
        out["touched_norms_max"] = max(
            float(torch.linalg.vector_norm(got[t][torch.as_tensor(
                np.unique(i), device=dev).long()], dim=1).max())
            for t, i in ids.items())
    out["ok"] = (outside == 0 and loss_rel <= run["rtol"]
                 and bool(torch.isfinite(want).all())
                 and out.get("touched_norms_max", 0.0) <= 1.0 + 1e-4
                 and all(r["ok"] for r in out.get("serving", {}).values()))
    return out


def mp2_rank(seed, run):
    """One rank of (g): joins the two-rank gloo job as a 1 x 2 mesh (one
    data rank, two model ranks; CUDA tensors over the host), runs every
    MP2_MODELS case and prints its results as one `MP2 {...}` line (rank
    0's hold the comparisons)."""
    import torch
    import torch.distributed as dist

    import openrec_tpu_torch as port
    from openrec_tpu_torch import parallel as par
    from openrec_tpu_torch.ops import bucketed_topk as bt
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    mesh = par.make_mesh(1, 2, device=run["device"], backend="gloo")
    dev = par.mesh.mesh_device(mesh)
    rank = dist.get_rank()
    out = {"rank": rank, "backend": dist.get_backend(),
           "world": dist.get_world_size(), "mesh": list(mesh.mesh.shape),
           "device": str(dev)}
    for name in MP2_MODELS:
        out[name] = mp2_case(torch, port, par, bt, mesh, name, seed, dev, run,
                             rank)
    print("MP2 " + json.dumps(out), flush=True)


def parallel_model(torch, seed, run=MP2):
    """(g) MP2_MODELS at one data rank x two model ranks sharing the card
    over gloo, launched as (f) is; each held against one rank on the same
    card from the same init and seed within rtol / atol, RNNRec's shards
    served through K1 and K2. A rank that fails, a result outside the
    bars or a launch past its timeout fails the phase. Returns the
    results with the launches of K1 and K2 summed over both ranks."""
    from openrec_tpu_torch.parallel.launch import spawn_local
    t = time.perf_counter()
    try:
        outs = spawn_local(MP2_RANK, 2, timeout=run["timeout"], env={
            "CHIP_SMOKE_SEED": str(seed), "CHIP_SMOKE_MP2": json.dumps(run)})
    except (RuntimeError, TimeoutError) as e:
        fail(f"parallel (g): the two gloo ranks failed: {str(e)[-3000:]}")
    ranks = []
    for text in outs:
        lines = [ln for ln in text.splitlines() if ln.startswith("MP2 ")]
        if not lines:
            fail(f"parallel (g): a rank printed no result: {text[-3000:]}")
        ranks.append(json.loads(lines[-1][4:]))
    out = ranks[0]
    out["launch_s"] = time.perf_counter() - t
    out["launches"] = {k: sum(r["RNNRec"]["serving"][k]["launches"]
                              for r in ranks) for k in ("K1", "K2")}
    for name in MP2_MODELS:
        r = out[name]
        # the last rank holds the pad rows
        r["pads"] = ranks[-1][name]["pads"]
        r["ok"] = r["ok"] and all(v[1] == 0.0 for rk in ranks
                                  for v in rk[name]["pads"].values())
        extra = ""
        if "update_ms_m2" in r:
            extra += (f"; update_embeddings {r['update_ms_m2']:.2f} ms at "
                      f"m 2, {r['update_ms_one_rank']:.2f} ms one rank")
        if "touched_norms_max" in r:
            extra += f"; touched row norms max {r['touched_norms_max']:.6f}"
        for kname, s in r.get("serving", {}).items():
            extra += (f"; {kname} served {run['requests']} requests from "
                      f"{s['shard_rows']:,}-row shards: recall@{K} "
                      f"{s['recall_vs_exact']:.4f} (target {s['target']}), "
                      f"max |err| {s['max_abs_err']:.3g}, {s['ms']:.2f} ms, "
                      f"launches {out['launches'][kname]}")
        print(f"parallel (g) {name} at 1 data x 2 model ranks on one card "
              f"over gloo, tables {r['sharded']} row-sharded (pad rows "
              f"{r['pads']}), {r['feed']}, global batch {r['global_batch']}, "
              f"{r['steps']} SGD steps: {r['ms_per_step_m2']:.2f} ms/step at "
              f"m 2, {r['ms_per_step_one_rank']:.2f} ms/step one rank; loss "
              f"{r['loss_first']:.6g} -> {r['loss_last']:.6g}, max rel diff "
              f"{r['loss_max_rel_diff']:.3g}; params max |diff| "
              f"{r['params_max_abs_diff']:.3g} ({r['params_outside']} "
              f"outside rtol {run['rtol']:g} / atol {run['atol']:g}), moved "
              f"up to {r['params_max_moved']:.3g}{extra}", flush=True)
        if not r["ok"]:
            fail(f"parallel (g): {name} with row-sharded tables differs from "
                 f"one rank: {json.dumps(r)}")
    # (CPU tensors, in a rehearsal, launch no kernel)
    if run["device"] == "cuda" and any(out["launches"][k] != 2
                                       for k in ("K1", "K2")):
        fail(f"parallel (g): launches {out['launches']}, want 2 each (one "
             "per rank)")
    return out


def phase_parallel(torch, port, seed, dev, run=PARALLEL):
    """Phase 12: the distribution layer on the card (its docstring at the
    top of this file)."""
    import torch.distributed as dist
    from openrec_tpu_torch import parallel as par
    from openrec_tpu_torch.ops import bucketed_topk as bt
    mesh, info = one_rank_mesh(torch, par, dev)
    print("parallel mesh", json.dumps(info), flush=True)
    out = {"mesh": info}
    t = time.perf_counter()
    out["retrieval"] = parallel_retrieval(torch, par, bt, mesh, seed, dev,
                                          run)
    out["retrieval_s"] = time.perf_counter() - t
    print("parallel retrieval", json.dumps(out["retrieval"]), flush=True)
    torch.cuda.empty_cache()
    t = time.perf_counter()
    out["sparse"] = parallel_sparse(torch, port, par, mesh, seed, dev, run)
    out["sparse_s"] = time.perf_counter() - t
    t = time.perf_counter()
    out["trainer"] = parallel_trainer(torch, port, par, mesh, seed, dev, run)
    out["trainer_s"] = time.perf_counter() - t
    torch.cuda.empty_cache()
    t = time.perf_counter()
    out["itr_world1"] = parallel_itr(torch, port, par, mesh, seed, dev, run)
    out["itr_world1_s"] = time.perf_counter() - t
    dist.destroy_process_group()
    torch.cuda.empty_cache()
    t = time.perf_counter()
    out["gloo_d2"] = parallel_gloo(torch, seed)
    out["gloo_d2_s"] = time.perf_counter() - t
    t = time.perf_counter()
    out["gloo_m2"] = parallel_model(torch, seed)
    out["gloo_m2_s"] = time.perf_counter() - t
    print(f"parallel (g): {out['gloo_m2_s']:.1f} s", flush=True)
    return out


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


def time_bucket_kernel(torch, bt, u, v, b, top2, bucket, what, k=K):
    """K1 (top2 False) or K2 at one shape, first held against its plain
    version on these tensors (`hold_k1k2`): CUDA-event median ms, device
    ms of the kernel (and its split merge) under the profiler, the plain
    version's and the library yardstick's ms, and the bound."""
    func = bt.bucket_max2_scores if top2 else bt.bucket_max_scores
    (B, D), I = u.shape, v.shape[0]
    dtype = str(u.dtype).split(".")[-1]
    bucket, _, L = bt.bucket_geometry(I, D, v.element_size(), bucket)
    err, ties = hold_k1k2(torch, bt, u, v, b, bucket, top2, what)
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
        torch.matmul(u, v.T), k, dim=1))
    nbytes = (B * D + I * D) * u.element_size() + I * 4 \
        + B * L * (16 if top2 else 8)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = 2.0 * B * I * D / PEAK_OPS[dtype] * 1e3
    shape = {"B": B, "I": I, "D": D, "dtype": dtype, "bucket": bucket,
             "L": L, "k": k}
    sm_count = torch.cuda.get_device_properties(
        u.device).multi_processor_count
    if bt.tma_route(v.dtype, D, v.data_ptr()):
        shape.update(bt.tma_plan(B, I, D, bucket, sm_count)._asdict())
    else:
        plan = bt.mma_plan if dtype == "bfloat16" else bt.f32_plan
        shape.update(plan(B, I, D, bucket, top2, sm_count)._asdict())
    return {"ms": ms, "device_ms": device_ms, "plain_ms": plain_ms,
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": library_ms, "max_abs_err_plain": err,
            "id_mismatch_tie": ties,
            # SM clock, power draw and temperature right after the timing
            "card_after_timing": clocks, "profile": profile, "shape": shape}


def phase_time(torch, bt, gen, dev):
    """K1's and K2's entries of the kernels line: their numbers at the
    Amazon serving shape (bf16, the tensor-core route), with the
    CiteULike shape (fp32, the CUDA-core route), VBPR's Tradesy shape
    (bf16, D = 100), RNNRec's LastFM shape (fp32, D = 32) and ItrMLP's
    Netflix shape (fp32, D = 20) beside them, and the row shards phase 12
    serves from (Amazon's over m = 2 and 4, LastFM's over m = 2), each at
    the bucket `bucket_score_topk` picks there for its method's target;
    and K1 at the `batch-k10` cell's request (1,024 Amazon users, top 10,
    bucket 512 shrunk to 256)."""
    def inputs(I, D, dtype, B=BATCH):
        u = (torch.rand(B, D, generator=gen, device=dev) * 0.1 - 0.05)
        v = (torch.rand(I, D, generator=gen, device=dev) * 0.1 - 0.05)
        b = torch.randn(I, generator=gen, device=dev) * 0.01
        return u.to(dtype), v.to(dtype), b

    shapes = {c["name"]: (c["items"], c)
              for c in (AMAZON, CITEULIKE, TRADESY, LASTFM, NETFLIX)} | {
        "amazon_shard2": (SHARD2, AMAZON), "amazon_shard4": (SHARD4, AMAZON),
        "lastfm_shard2": (LASTFM_SHARD2, LASTFM)}
    shapes = {name: inputs(I, c["dim"], getattr(torch, c["dtype"]))
              for name, (I, c) in shapes.items()}
    batch = inputs(AMAZON["items"], AMAZON["dim"], torch.bfloat16,
                   B=BATCH_K10)
    entries = []
    for kname, top2, line, fn_name in (
            ("K1", False, 68, "_bucket_max_kernel"),
            ("K2", True, 143, "_bucket_max2_kernel")):
        method = "pallas2" if top2 else "pallas"
        entry = {
            "name": f"{kname} bucket_max<top{2 if top2 else 1}>",
            "route": "cuda",
            "source": "openrec_tpu_torch/csrc/bucket_max.cu",
            "replaces": f"openrec_tpu/ops/bucketed_topk.py:{line}",
            "replaces_function": fn_name}
        runs = [(name, u, v, b, K) for name, (u, v, b) in shapes.items()]
        if not top2:
            runs.append(("amazon_batch_k10", *batch, 10))
        for name, u, v, b, k in runs:
            t = time_bucket_kernel(torch, bt, u, v, b, top2, bt.choose_bucket(
                v.shape[0], k, recall_target=TARGETS[method],
                per_bucket=2 if top2 else 1), f"{kname} {name}", k)
            t["variant"] = F32_VARIANT if v.dtype != torch.bfloat16 else (
                "wgmma-tma-bf16" if bt.tma_route(v.dtype, v.shape[1],
                                                 v.data_ptr())
                else "mma-bf16")
            if name == "amazon":
                entry.update(t)
            else:
                entry[name] = t
            print(f"{kname} {name} ({t['variant']}, bucket "
                  f"{t['shape']['bucket']}): {t['ms']:.4f} ms by events, "
                  f"{t['device_ms']:.4f} ms device (library "
                  f"{t['library_ms']:.4f}, plain {t['plain_ms']:.3f}, bound "
                  f"{t['bound_ms']:.4f}); max |err| against plain "
                  f"{t['max_abs_err_plain']:.3g}", flush=True)
        entries.append(entry)
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


def time_k3(torch, tk, gen, dev, B, I, D, dtype, what):
    """K3 at one shape, first held against its plain version on these
    tensors (`hold_k3`): kernel, plain version and library yardstick times
    (CUDA-event medians), its four stages, device time by kernel under
    the profiler, and the bound for this shape."""
    dt = getattr(torch, dtype)
    u = (torch.rand(B, D, generator=gen, device=dev) * 0.1 - 0.05).to(dt)
    v = (torch.rand(I, D, generator=gen, device=dev) * 0.1 - 0.05).to(dt)
    b = torch.randn(I, generator=gen, device=dev) * 0.01
    _, _, _, err, ties = hold_k3(torch, tk, u, v, b, K, what)
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
            "max_abs_err_plain": err, "id_mismatch_tie": ties,
            "profile": profile, "card_after_timing": clocks,
            "shape": {"B": B, "I": I, "D": D, "dtype": dtype, "k": K,
                      **plan._asdict()}}


def phase_time_k3(torch, tk, gen, dev):
    """K3's entry of the kernels line: its numbers at the CiteULike
    retrieval shape of phase 5 (fp32 tables), with the Amazon serving
    shape (bf16), VBPR's Tradesy shape (bf16, D = 100), RNNRec's LastFM
    shape (fp32, D = 32) and ItrMLP's Netflix shape (fp32, D = 20)
    beside them."""
    entry = {"name": "K3 fused_topk (K1 bound pass, tau, filter, final)",
             "route": "cuda",
             "source": "openrec_tpu_torch/csrc/fused_topk.cu",
             "replaces": "openrec_tpu/ops/topk.py:58",
             "replaces_function": "_fused_topk_kernel"}
    for cfg in (CITEULIKE, AMAZON, TRADESY, LASTFM, NETFLIX):
        t = time_k3(torch, tk, gen, dev, BATCH, cfg["items"], cfg["dim"],
                    cfg["dtype"], f"K3 {cfg['name']}")
        if cfg is CITEULIKE:
            entry.update(t)
        else:
            entry[cfg["name"]] = t
        print(f"K3 {cfg['name']}: {t['ms']:.4f} ms (library "
              f"{t['library_ms']:.4f}, plain {t['plain_ms']:.3f}, bound "
              f"{t['bound_ms']:.4f}); max |err| against plain "
              f"{t['max_abs_err_plain']:.3g}; stages "
              + json.dumps(t["stages_ms"]),
              flush=True)
    return entry


def time_sparse_adam_at(torch, gen, dev, cfg, what):
    """One shape's timing of the sparse-Adam kernel in the flat layout,
    first held against its plain version on this state
    (`hold_sparse_adam`): CUDA-event median ms, device ms under the
    profiler, the plain version's ms and the bytes bound."""
    from openrec_tpu_torch.ops import sparse_adam as sa
    table, mu, nu, at, write, g, alpha = sparse_adam_inputs(
        torch, gen, dev, "flat", cfg)
    args = (table, mu, nu, at, write, g, alpha, *sparse_adam_hyper(cfg))
    hold_sparse_adam(torch, sa, args, what)
    ms = time_ms(torch, lambda: sa.sparse_adam_apply(*args))
    profile = profile_device(torch, lambda: sa.sparse_adam_apply(*args), 10,
                             ms)
    device_ms = sum(t for name, t in
                    profile["top_device_ms_per_call"].items()
                    if "sparse_adam" in name)
    plain_ms = time_ms(torch, lambda: sa.sparse_adam_plain(*args), runs=20)
    clocks = nvidia_smi("clocks.sm,power.draw,temperature.gpu")
    (rows, D), cap = table.shape, at.shape[0]
    live = int(write.sum())
    # a live slot reads its index and its table, mu, nu and gradient rows
    # and writes three rows; every slot reads its mask byte
    nbytes = live * (7 * 4 * D + at.element_size()) + cap
    return {"ms": ms, "device_ms": device_ms, "plain_ms": plain_ms,
            "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3, "bound_by": "bytes",
            "card_after_timing": clocks, "profile": profile,
            "shape": {"rows": rows, "D": D, "slots": cap, "live": live,
                      "index": str(at.dtype).split(".")[-1]}}


def time_sparse_adam(torch, gen, dev):
    """`sparse_adam`'s entry of the kernels line, at train-zipf's shapes
    (`SPARSE_ADAM`), with a `dcnv2` entry at dlrm-dcnv2's whole table
    (`SPARSE_ADAM_DCN`, D 128): each `time_sparse_adam_at`."""
    entry = {"name": "sparse_adam (the sparse step's keras Adam, live rows "
                     "written back)",
             "route": "cuda",
             "source": "openrec_tpu_torch/csrc/sparse_adam.cu",
             "replaces": None, "replaces_function": None}
    entry.update(time_sparse_adam_at(torch, gen, dev, SPARSE_ADAM,
                                     "sparse_adam train-zipf"))
    torch.cuda.empty_cache()
    entry["dcnv2"] = time_sparse_adam_at(torch, gen, dev, SPARSE_ADAM_DCN,
                                         "sparse_adam dcnv2")
    for name, t in (("train-zipf", entry), ("dcnv2", entry["dcnv2"])):
        print(f"sparse_adam {name}: {t['ms']:.4f} ms (device "
              f"{t['device_ms']:.4f}, plain {t['plain_ms']:.3f}, bound "
              f"{t['bound_ms']:.4f}); equal to plain", flush=True)
    return entry


def time_view_grad_at(torch, dev, seed, cell):
    """The view gradient at one cell's shape (`VIEW_GRAD`), with the flat
    dedup's order as the sparse step hands it, first held against its
    plain version and ATen's backward (`hold_view_grad`): CUDA-event
    median ms, device ms under the profiler, the stable sort of the
    positions that a view without that order adds, its plain version and
    ATen's autograd backward (`index_select`'s, `embedding_bag`'s:
    `library_ms`), the bytes bound, and the kernel's max |diff| against
    its plain version."""
    import torch.nn.functional as F
    from openrec_tpu_torch.ops import view_grad as vg
    x = view_grad_inputs(torch, dev, seed, cell)
    grad, pos, cap, order, bag = (x[k] for k in ("grad", "pos", "cap",
                                                 "order", "bag"))
    D = grad.shape[1]

    def kernel():
        return vg.view_grad(grad, pos, cap, order=order, bag=bag)

    def sort():
        return torch.sort(pos, stable=True).indices

    rows = torch.zeros(cap, D, device=dev, requires_grad=True)
    y = (rows.index_select(0, pos) if bag is None
         else F.embedding_bag(pos, rows, x["offsets"], mode="sum"))

    def library():
        return torch.autograd.grad(y, rows, grad, retain_graph=True)[0]

    _, diff = hold_view_grad(torch, vg, x, f"view_grad {cell}")
    ms = time_ms(torch, kernel)
    profile = profile_device(torch, kernel, 10, ms)
    sort_ms = time_ms(torch, sort)
    sort_profile = profile_device(torch, sort, 10, sort_ms)
    lib_ms = time_ms(torch, library, runs=20)
    lib_profile = profile_device(torch, library, 5, lib_ms)
    plain_ms = time_ms(torch, lambda: vg.view_grad_plain(grad, pos, cap,
                                                         bag), runs=20)
    # inputs read once (the gradient, positions, the sort's order, bags),
    # the [cap, D] gradient written once
    nbytes = (grad.numel() * 4 + cap * D * 4
              + pos.numel() * (pos.element_size() + 8
                               + (0 if bag is None else 8)))
    rec = {
        "lookups": pos.shape[0], "cap": cap, "D": D, "live": x["live"],
        "bags": None if bag is None else x["offsets"].shape[0],
        "max_abs_diff_plain": diff,
        "ms": ms, "device_ms": profile["device_busy_ms_per_call"],
        "sort_ms": sort_ms,
        "sort_device_ms": sort_profile["device_busy_ms_per_call"],
        "plain_ms": plain_ms, "library_ms": lib_ms,
        "library_device_ms": lib_profile["device_busy_ms_per_call"],
        "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3, "bound_by": "bytes",
        # the bound with a bag's gradient row read once for each lookup
        "bound_ms_row_per_lookup": (nbytes + (0 if bag is None else (
            pos.numel() - grad.shape[0]) * D * 4)) / HBM_BYTES_PER_S * 1e3,
        "profile": profile, "library_profile": lib_profile,
        "card_after_timing": nvidia_smi("clocks.sm,power.draw,"
                                        "temperature.gpu")}
    bags = "" if bag is None else f" in {rec['bags']} bags"
    print(f"view_grad {cell}: {rec['lookups']} lookups into [{cap}, {D}]"
          f"{bags}: {ms:.4f} ms (device {rec['device_ms']:.4f}; a sort "
          f"{rec['sort_device_ms']:.4f} more without the dedup's order; "
          f"plain {plain_ms:.3f}, library {lib_ms:.4f} / device "
          f"{rec['library_device_ms']:.4f}, bound {rec['bound_ms']:.4f}); "
          f"max |diff| plain {rec['max_abs_diff_plain']:.3g}, within two "
          "fp32 orders of plain and library", flush=True)
    return rec


def time_view_grad(torch, dev, seed):
    """`view_grad`'s entry of the kernels line: `time_view_grad_at` at
    train-zipf's shape, with a `train-multihot` entry."""
    entry = {"name": "view_grad (the gradient of the sparse step's "
                     "gathered-view lookups and bags)",
             "route": "cuda", "source": "openrec_tpu_torch/csrc/view_grad.cu",
             "replaces": None, "replaces_function": None}
    for cell in VIEW_GRAD:
        rec = time_view_grad_at(torch, dev, seed, cell)
        if cell == "train-zipf":
            entry.update(rec)
        else:
            entry[cell] = rec
        torch.cuda.empty_cache()
    return entry


def serve_amazon(torch, dev):
    """BPR at the Amazon catalog (bf16 serve tables) through
    `CachedDotProductScorer`: one request of BATCH users by each method
    (`hold_serving`: K1 once a `pallas` request, K2 once a `pallas2`
    request, K3 never, every score the fp32 score at its id, recall
    against `exact`) and one `eval_metrics` batch against the dense
    metrics (`hold_eval_metrics`)."""
    s = bpr_serving(torch, AMAZON, dev, requests=1)
    out = {"recall_vs_exact": {}, "launches": {}}
    for m in METHODS:
        out["recall_vs_exact"][m], out["launches"][m] = hold_serving(
            torch, s, m)
    out["eval_auc_mean"] = hold_eval_metrics(torch, s)
    print(f"serving amazon: recall vs exact {out['recall_vs_exact']}, "
          f"launches {out['launches']}; eval_metrics equal to the dense "
          "metrics", flush=True)
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", type=Path, default=None,
                    help="write the full record here as JSON")
    ap.add_argument("--phases", default=",".join(map(str, PHASES)),
                    help="comma list of the phases to run (default all; "
                    "phase 1 always runs): e.g. 1,4 builds and times the "
                    "kernels")
    args = ap.parse_args(argv)
    phases = {1} | {int(x) for x in args.phases.split(",") if x.strip()}
    if not phases <= set(PHASES):
        ap.error(f"--phases: {sorted(phases - set(PHASES))} is no phase")
    t_start = time.perf_counter()

    # cuBLAS needs a fixed workspace to run deterministically (phases 6
    # and 12 switch torch.use_deterministic_algorithms on)
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
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

    # A skipped phase prints nothing; what it would fill stays null.
    kernels, serving = [], None
    train = dlrm = zoo = legacy = visual = sequence = itr = parallel = None

    # phase 4
    if 4 in phases:
        kernels = phase_time(torch, bt, gen, dev)
        kernels.append(phase_time_k3(torch, tk, gen, dev))
        torch.cuda.empty_cache()
        kernels.append(time_sparse_adam(torch, gen, dev))
        torch.cuda.empty_cache()
        kernels.append(time_view_grad(torch, dev, args.seed))
        torch.cuda.empty_cache()
        serving = serve_amazon(torch, dev)

    # phase 5
    if 5 in phases:
        train = phase_train(torch, port, args.seed, dev)
        torch.cuda.empty_cache()

    # phase 6
    if 6 in phases:
        t6 = time.perf_counter()
        from openrec_tpu_torch import trace
        from openrec_tpu_torch.ops import view_grad as vg
        before = launch_counts(kernels=("sparse_adam", "view_grad"))
        sorts = trace.counter(vg.SORTS)
        dlrm = phase_dlrm(torch, port, args.seed, dev)
        dlrm["phase_s"] = time.perf_counter() - t6
        counted = launch_counts(before, kernels=("sparse_adam", "view_grad"))
        dlrm["sparse_adam_launches"] = counted["sparse_adam"]
        # the training path's own launches of the view-gradient kernel:
        # one a table and step of every card trainer of the phase; the
        # flat steps hand it their dedup's order, the other modes sort
        dlrm["view_grad_launches"] = counted["view_grad"]
        dlrm["view_grad_sorts"] = trace.counter(vg.SORTS) - sorts
        if counted["view_grad"] != dlrm["card_table_steps"] \
                or dlrm["view_grad_sorts"] \
                != dlrm["card_table_steps_unsorted"]:
            fail(f"dlrm: {counted['view_grad']} view_grad launches and "
                 f"{dlrm['view_grad_sorts']} sorts for "
                 f"{dlrm['card_table_steps']} table-steps on the card, "
                 f"{dlrm['card_table_steps_unsorted']} of them not flat")
        print(f"phase 6 (dlrm): view_grad {counted['view_grad']} launches "
              f"for {dlrm['card_table_steps']} table-steps, "
              f"{dlrm['view_grad_sorts']} sorts for the "
              f"{dlrm['card_table_steps_unsorted']} not flat", flush=True)
        print(f"phase 6 (dlrm): {dlrm['phase_s']:.1f} s", flush=True)
        torch.cuda.empty_cache()

    # phase 7
    if 7 in phases:
        t7 = time.perf_counter()
        zoo = phase_zoo(torch, port, args.seed, dev)
        zoo["phase_s"] = time.perf_counter() - t7
        torch.cuda.empty_cache()

    # phase 8
    if 8 in phases:
        t8 = time.perf_counter()
        legacy = phase_legacy(torch, port, args.seed, dev)
        legacy["phase_s"] = time.perf_counter() - t8
        torch.cuda.empty_cache()

    # phase 9
    if 9 in phases:
        t9 = time.perf_counter()
        visual = phase_visual(torch, port, args.seed, dev)
        visual["phase_s"] = time.perf_counter() - t9
        torch.cuda.empty_cache()

    # phase 10
    if 10 in phases:
        t10 = time.perf_counter()
        sequence = phase_sequence(torch, port, args.seed, dev)
        sequence["phase_s"] = time.perf_counter() - t10
        torch.cuda.empty_cache()

    # phase 11
    if 11 in phases:
        t11 = time.perf_counter()
        itr = phase_itr(torch, port, args.seed, dev)
        itr["phase_s"] = time.perf_counter() - t11
        torch.cuda.empty_cache()

    # phase 12
    if 12 in phases:
        t12 = time.perf_counter()
        parallel = phase_parallel(torch, port, args.seed, dev)
        parallel["phase_s"] = time.perf_counter() - t12
    total_s = time.perf_counter() - t_start
    print((f"phase 7 (zoo): {zoo['phase_s']:.1f} s; " if zoo else "")
          + (f"phase 8 (legacy): {legacy['phase_s']:.1f} s; " if legacy
             else "")
          + (f"phase 9 (visual): {visual['phase_s']:.1f} s; " if visual
             else "")
          + (f"phase 10 (sequence): {sequence['phase_s']:.1f} s; "
             if sequence else "")
          + (f"phase 11 (itr): {itr['phase_s']:.1f} s; " if itr else "")
          + (f"phase 12 (parallel): {parallel['phase_s']:.1f} s; "
             if parallel else "")
          + f"chip_smoke: {total_s:.1f} s in all", flush=True)

    if args.out is not None:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps(
            {"card": smi, "phases": sorted(phases), "build_s": build_s,
             "ptxas": ptxas, "total_s": total_s, "training": train,
             "kernels": kernels, "serving": serving,
             "dlrm": dlrm, "zoo": zoo, "legacy": legacy, "visual": visual,
             "sequence": sequence, "itr": itr, "parallel": parallel},
            indent=1))
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
            "modes": {mode: {m: r[m] for m in (
                "vs_flat", "ms_per_step", "device_busy_ms_per_step",
                "device_ops_per_step", "idle_share", "gathered_rows",
                "unique_ids", "host_checks_per_step")}
                for mode, r in k["modes"].items()},
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
            "tf32_caught": legacy["tf32_caught"],
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
    if visual:
        print(json.dumps({"visual": {
            m: visual[m] for m in ("launches", "launches_tradesy_bf16",
                                   "tf32_caught", "data", "phase_s",
                                   "setup_s")} | {
            name: {"feed": visual[name]["feed"],
                   "host_fed": {m: visual[name]["host_fed"][m] for m in (
                       "steps_per_s", "examples_per_s",
                       "device_busy_ms_per_step", "device_ops_per_step",
                       "idle_share", "mean_loss_by_call", "val")},
                   "val_step0": visual[name]["val_step0"],
                   "card_vs_cpu": {c["dtype"]: c["max_abs_param_diff"]
                                   for c in visual[name]["card_vs_cpu"]},
                   "max_memory_allocated_gb":
                       visual[name]["max_memory_allocated_gb"],
                   "serving": {m: visual[name]["serving"][m] for m in (
                       "recall_vs_exact", "score_max_abs_err",
                       "k1k2_vs_plain", "k3", "calls")},
                   "seconds": visual[name]["seconds"]}
            | ({"touched_norms": visual[name]["touched_norms"]}
               if "touched_norms" in visual[name] else {})
            for name in VISUAL_MODELS}}))
    if sequence:
        print(json.dumps({"sequence": {
            m: sequence[m] for m in ("launches", "launches_lastfm_d32",
                                     "tf32_caught", "data", "popularity",
                                     "phase_s", "setup_s")} | {
            name: {"feed": sequence[name]["feed"],
                   "host_fed": {m: sequence[name]["host_fed"][m] for m in (
                       "steps_per_s", "examples_per_s",
                       "device_busy_ms_per_step", "device_ops_per_step",
                       "idle_share", "mean_loss_by_call", "test")},
                   "test_step0": sequence[name]["test_step0"],
                   "card_vs_cpu": {c["dtype"]: c["max_abs_param_diff"]
                                   for c in sequence[name]["card_vs_cpu"]},
                   "max_memory_allocated_gb":
                       sequence[name]["max_memory_allocated_gb"],
                   "seconds": sequence[name]["seconds"]}
            | ({"device_sampled": {m: sequence[name]["device_sampled"][m]
                                   for m in ("steps", "steps_per_s",
                                             "examples_per_s",
                                             "mean_loss_by_call", "test")},
                "sampled_softmax_card_vs_cpu":
                    sequence[name]["sampled_softmax_card_vs_cpu"]}
               if "device_sampled" in sequence[name] else {})
            | ({"gradient_card_vs_cpu": {
                c["dtype"]: {n: r["max_scaled_diff"]
                             for n, r in c["by_param"].items()}
                for c in sequence[name]["gradient_card_vs_cpu"]}}
               if "gradient_card_vs_cpu" in sequence[name] else {})
            | ({"serving": {m: sequence[name]["serving"][m] for m in (
                "recall_vs_exact", "score_max_abs_err", "k1k2_vs_plain",
                "k3", "calls", "p50_ms")}}
               if "serving" in sequence[name] else {})
            for name in SEQUENCE_MODELS}}))
    if itr:
        print(json.dumps({"itr": {
            m: itr[m] for m in ("launches", "data", "config", "val_step0",
                                "val_pretrained", "constant_predictor_mse",
                                "max_memory_allocated_gb", "seconds",
                                "phase_s")}
            | {"host_fed": {m: itr["host_fed"][m] for m in (
                "steps_per_s", "examples_per_s", "device_busy_ms_per_step",
                "device_ops_per_step", "idle_share", "mean_loss_by_call",
                "val_mse_by_call", "val")},
               "update": {m: itr["update"][m] for m in (
                   "events_ms", "device_ms", "launches", "user_embed",
                   "item_embed")},
               "card_vs_cpu": {c["dtype"]: c["max_abs_param_diff"]
                               for c in itr["card_vs_cpu"]},
               "serving": {m: itr["serving"][m] for m in (
                   "recall_vs_exact", "score_max_abs_err",
                   "sigmoid_vs_score_max_abs_diff", "k1k2_vs_plain", "k3",
                   "calls", "p50_ms")}}}))
    if parallel:
        print(json.dumps({"parallel": {
            "mesh": parallel["mesh"], "retrieval": parallel["retrieval"],
            "sparse": parallel["sparse"],
            "trainer": {m: parallel["trainer"][m] for m in (
                "steps", "steps_per_s", "device_ms_per_step",
                "device_ops_per_step", "idle_share", "sharded",
                "checkpoint_bitwise")},
            "itr_world1": parallel["itr_world1"],
            "gloo_d2": parallel["gloo_d2"],
            "gloo_m2": parallel["gloo_m2"],
            "seconds": {m: parallel[m + "_s"] for m in (
                "retrieval", "sparse", "trainer", "itr_world1", "gloo_d2",
                "gloo_m2")},
            "phase_s": parallel["phase_s"]}}))
    if kernels:
        print(json.dumps({"kernels": kernels}))
        print(json.dumps({"serving": serving}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
