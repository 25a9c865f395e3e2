"""The shapes at which the card checks and times the hand-written kernels,
and the checks both sides share: one list for the card tests
(`tests/test_torch_*_card.py`, which hold each kernel against its plain
version) and `chip_smoke.py` (phase 4 times the kernels at these shapes;
its model phases use the same bars).

Imports numpy alone; the functions take the `torch` module as their first
argument, so that the lists are built before torch is imported (the CPU
tests read `K1K2_CASES` too). Nothing here imports JAX.
"""

import importlib.util
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent
TOL = 1e-5
AMAZON = dict(name="amazon", users=99_473, items=450_166, dim=64,
              dtype="bfloat16")
CITEULIKE = dict(name="citeulike", users=5_551, items=16_980, dim=50,
                 dtype="float32")


def port_catalog(name):
    """`openrec_tpu_torch.data.loaders.<name>` ({"total_users",
    "total_items"}), read from its file: the module needs only numpy, and
    the case lists below are built when this module is imported, before
    torch or the package is. {} where the checkout holds no port."""
    path = ROOT / "openrec_tpu_torch" / "data" / "loaders.py"
    if not path.is_file():
        return {}
    spec = importlib.util.spec_from_file_location("_port_loaders", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return getattr(module, name)


# VBPR's serving shape (examples/vbpr_tradesy.py: dim_user 100, bf16) over
# the Tradesy catalog
TRADESY = dict(name="tradesy", dim=100, dtype="bfloat16",
               items=port_catalog("TRADESY").get("total_items"))
# the sequence models' serving shapes over the LastFM catalog: RNNRec's
# GRU state (32 units) against its output table and bias, fp32; and
# YouTubeRec's last hidden layer (dim 50) against the transposed last MLP
# weight, no bias
LASTFM = dict(name="lastfm", dim=32, dtype="float32",
              items=port_catalog("LASTFM").get("total_items"))
# ItrMLP's serving shape (examples/itr_mlp.py: dim 20, fp32) over the
# Netflix Prize catalog: 480,189 users x 17,770 movies, the dataset's
# public counts
NETFLIX = dict(name="netflix", users=480_189, items=17_770, dim=20,
               dtype="float32")
BATCH, K, REQUESTS = 256, 100, 8
# the Amazon catalog's row shards over m = 2 and m = 4 ranks (pad_rows)
SHARD2, SHARD4 = 225_083, 112_542
# the LastFM catalog's row shards over m = 2 ranks (chip_smoke.py phase
# 12 (g)'s RNNRec out_weight / out_bias)
LASTFM_SHARD2 = -(-(LASTFM["items"] or 0) // 2)
TARGETS = {"pallas": 0.99, "pallas2": 0.995}
# the serving methods of `CachedDotProductScorer.topk`
METHODS = ("pallas", "pallas2", "exact", "approx")


KERNEL_COUNTERS = {"K1": "openrec.k1.launches", "K2": "openrec.k2.launches",
                   "K3": "openrec.k3.launches",
                   "sparse_adam": "openrec.sparse_adam.launches",
                   "view_grad": "openrec.view_grad.launches"}
# the serving kernels, whose launches the serving paths count and check
SERVING_KERNELS = ("K1", "K2", "K3")


def fail(msg):
    raise RuntimeError(msg)


def launch_counts(since=None, kernels=SERVING_KERNELS):
    """{kernel: launches counted by the port's tracer (`trace.py`)} for
    `kernels`, less those of `since` (an earlier reading) where given."""
    from openrec_tpu_torch import trace
    return {k: trace.counter(KERNEL_COUNTERS[k]) - (since or {}).get(k, 0)
            for k in kernels}


def counted_once(kernel, since, what):
    if launch_counts(since, (kernel,))[kernel] != 1:
        fail(f"{what}: {kernel} was not counted once for one call")


def serve_topk(scorer, params, req, method):
    """One request's top-K through a `CachedDotProductScorer` by `method`,
    at the method's recall target."""
    return scorer.topk(params, req, k=K, method=method,
                       recall_target=TARGETS.get(method, 0.99))


def near(x, y):
    """x equals y within rtol = atol = TOL (elementwise, tensors)."""
    return (x - y).abs() <= TOL + TOL * y.abs()


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


def hold_k1k2(torch, bt, u, v, b, bucket, top2, what):
    """K1 (top2 False) or K2 held against its plain version on these card
    tensors by `compare_kernel`'s bars, ids equal but for near-ties, one
    launch counted; returns (max_abs_err, tie id mismatches)."""
    kernel = "K2" if top2 else "K1"
    before = launch_counts(kernels=(kernel,))
    err, bad, ties = compare_kernel(torch, bt, u, v, b, bucket, top2)
    counted_once(kernel, before, what)
    if bad:
        fail(f"{what}: {bad} {kernel} id mismatches that are not near-ties "
             f"(max |err| {err})")
    return err, ties



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
    # VBPR's D = 100: bf16 rows of 200 bytes (Dp 112, 240-byte smem rows),
    # every other row 8-byte aligned, at the buckets `pallas` (32) and
    # `pallas2` (128) pick at Tradesy; fp32 rows of 400 bytes
    ("tradesy K1 shape", BATCH, TRADESY["items"], 100, "bfloat16", 32, ""),
    ("tradesy K2 shape", BATCH, TRADESY["items"], 100, "bfloat16", 128, ""),
    ("bf16 D=100 twin members", 40, 30_000, 100, "bfloat16", 16, "twins"),
    ("bf16 D=100 view one row in", 50, 9_999, 100, "bfloat16", 8, "row"),
    ("f32 D=100", 64, 20_000, 100, "float32", 8, ""),
    # the LastFM serving shapes (chip_smoke.py phase 10) at the buckets
    # `pallas` (2) and `pallas2` (8) pick there: fp32 D = 32 (128-byte
    # rows) with a bias, and D = 50 with none (YouTubeRec's head)
    ("lastfm K1 shape", BATCH, LASTFM["items"], 32, "float32", 2, ""),
    ("lastfm K2 shape", BATCH, LASTFM["items"], 32, "float32", 8, ""),
    ("lastfm no-bias K1 shape", BATCH, LASTFM["items"], 50, "float32", 2,
     "nobias"),
    ("lastfm no-bias K2 shape", BATCH, LASTFM["items"], 50, "float32", 8,
     "nobias"),
    ("f32 D=32 twin members", 40, 30_000, 32, "float32", 16, "twins"),
    # ItrMLP's Netflix serving shape (chip_smoke.py phase 11) at the
    # buckets `pallas` (2) and `pallas2` (16) pick there: fp32 D = 20,
    # 80-byte rows, with a bias; twins and rows 4-byte aligned at D = 20
    ("netflix K1 shape", BATCH, NETFLIX["items"], 20, "float32", 2, ""),
    ("netflix K2 shape", BATCH, NETFLIX["items"], 20, "float32", 16, ""),
    ("f32 D=20 twin members", 40, 30_000, 20, "float32", 16, "twins"),
    ("f32 D=20 view one element in", 20, 5_000, 20, "float32", 4,
     "element"),
    # chip_smoke.py phase 12's row shards of the Amazon catalog at the
    # buckets `pallas` and `pallas2` pick there: m = 2 (225,083 rows) and
    # m = 4 (112,542, the last shard's two pad rows zero at bias -1e30)
    ("amazon shard m=2 K1 shape", BATCH, SHARD2, 64, "bfloat16", 32, ""),
    ("amazon shard m=2 K2 shape", BATCH, SHARD2, 64, "bfloat16", 128, ""),
    ("amazon shard m=4 K1 shape", BATCH, SHARD4, 64, "bfloat16", 16, "pad2"),
    ("amazon shard m=4 K2 shape", BATCH, SHARD4, 64, "bfloat16", 64, "pad2"),
    # chip_smoke.py phase 12 (g)'s row shards of RNNRec's LastFM output
    # layer over m = 2 (7,299 rows, fp32 D = 32) at the buckets `pallas`
    # (1) and `pallas2` (4) pick there
    ("lastfm shard m=2 K1 shape", BATCH, LASTFM_SHARD2, 32, "float32", 1,
     ""),
    ("lastfm shard m=2 K2 shape", BATCH, LASTFM_SHARD2, 32, "float32", 4,
     ""),
]


K3_CASES = [
    # name, B, I, D, dtype, k, layout: "" | "dup" (item 3j+1 repeats item
    # 3j: exact ties) | "offset" (the table is a view one row into its
    # storage, so it does not start on a 16-byte boundary) | "zero" (zero
    # table and bias: all scores equal, so more than C candidates pass and
    # the final kernel rescans; the answer is ids 0 .. k-1) | "nobias"
    # (item_bias None)
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
    # bf16 rows of 200 bytes: tau's scalar item_score path
    ("K3 tradesy shape", BATCH, TRADESY["items"], 100, "bfloat16", K, ""),
    # the LastFM shapes: fp32 D = 32 (128-byte rows) with a bias; D = 50
    # without
    ("K3 lastfm shape", BATCH, LASTFM["items"], 32, "float32", K, ""),
    ("K3 lastfm no-bias shape", BATCH, LASTFM["items"], 50, "float32", K,
     "nobias"),
    # the Netflix shape: fp32 D = 20 (80-byte rows, five 16-byte chunks) with a
    # bias; and D = 20 with B and I off the kernel's tiling
    ("K3 netflix shape", BATCH, NETFLIX["items"], 20, "float32", K, ""),
    ("K3 f32 D=20 k=100", 37, 5_003, 20, "float32", 100, ""),
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


def hold_k3(torch, tk, u, v, b, k, what):
    """K3 held against `fused_topk_plain` on these card tensors by
    `check_topk`'s bars, ids equal but for near-ties, every user at least
    min(k, I) candidates, one launch counted; returns (values, ids,
    candidate counts, max_abs_err, tie id mismatches)."""
    want_v, want_i = tk.fused_topk_plain(u, v, b, k)
    before = launch_counts(kernels=("K3",))
    vals, ids = tk.fused_score_topk(u, v, b, k)
    torch.cuda.synchronize()
    counted_once("K3", before, what)
    count = tk.fused_score_topk.last_count
    err, bad, ties = check_topk(torch, vals, ids, want_v, want_i,
                                tk.dot_scores(u, v, b), what)
    if bad:
        fail(f"{what}: {bad} id mismatches that are not near-ties (max "
             f"|err| {err})")
    if int(count.min()) < min(k, v.shape[0]):
        fail(f"{what}: a user has fewer than min(k, I) candidates")
    return vals, ids, count, err, ties


def bpr_serving(torch, cfg, dev, requests=REQUESTS, seed=0):
    """BPR's serve tables at one catalog's full width (`AMAZON`,
    `CITEULIKE`), from weights made by numpy (uniform(-0.05, 0.05)
    embeddings, a nonzero bias) as the JAX package would hand them over
    and loaded through `convert.params_from_jax`; `requests` requests of
    BATCH users and their `exact` answers."""
    import types
    from openrec_tpu_torch import BPR, CachedDotProductScorer, convert
    from openrec_tpu_torch.modules.embedding import embedding_lookup
    users, items, dim = cfg["users"], cfg["items"], cfg["dim"]
    rng = np.random.default_rng(seed)
    flat = convert.params_from_jax({
        "user_embed": rng.uniform(-0.05, 0.05, (users, dim)).astype(
            np.float32),
        "item_embed": rng.uniform(-0.05, 0.05, (items, dim)).astype(
            np.float32),
        "item_bias": rng.normal(0.0, 0.01, (items, 1)).astype(np.float32),
    }, device=dev)
    model = BPR(users, items, dim, dim, device=dev)
    model.load_params(flat)
    scorer = CachedDotProductScorer(
        model, users, items,
        extract_user_vecs=lambda p, i: embedding_lookup(p["user_embed"], i),
        extract_item_vecs=lambda p, i: embedding_lookup(p["item_embed"], i),
        extract_item_bias=lambda p, i: embedding_lookup(p["item_bias"], i),
        serve_dtype=getattr(torch, cfg["dtype"]), device=dev)
    params = model.params()
    scorer.cache(params)
    reqs = [rng.integers(0, users, BATCH).astype(np.int64)
            for _ in range(requests)]
    exact = [serve_topk(scorer, params, req, "exact")[1] for req in reqs]
    return types.SimpleNamespace(name=cfg["name"], dev=dev, items=items,
                                 flat=flat, scorer=scorer, params=params,
                                 requests=reqs, exact=exact, rng=rng)


def hold_serving(torch, s, method):
    """Every request of `bpr_serving`'s `s` by `method`: K1 counted once a
    `pallas` request, K2 once a `pallas2` request, K3 never (serving
    answers through K1 / K2; K3 is the training path's retrieval);
    [BATCH, K] finite values, ids in the catalog, every score the fp32
    score at its id, recall against `exact` at least the target less
    0.01. Returns (recall, launches)."""
    before = launch_counts()
    results = [serve_topk(s.scorer, s.params, req, method)
               for req in s.requests]
    torch.cuda.synchronize()
    n = len(s.requests)
    launched = launch_counts(before)
    if launched != {"K1": n * (method == "pallas"),
                    "K2": n * (method == "pallas2"), "K3": 0}:
        fail(f"{s.name} {method}: {launched} launches for {n} requests")
    hits = 0
    for req, (vals, ids), ex_ids in zip(s.requests, results, s.exact):
        if tuple(vals.shape) != (BATCH, K) or not torch.isfinite(vals).all():
            fail(f"{s.name} {method}: output {tuple(vals.shape)} or "
                 "non-finite")
        if ids.min() < 0 or ids.max() >= s.items:
            fail(f"{s.name} {method}: an id lies outside the catalog")
        ref = s.scorer.serve(s.params, req).gather(1, ids.long())
        if not near(vals, ref).all():
            fail(f"{s.name} {method}: a returned score is not the fp32 "
                 "score at its id")
        ex_sorted = torch.sort(ex_ids, dim=1).values
        found = torch.searchsorted(ex_sorted, ids.to(ex_sorted.dtype))
        hits += int((ex_sorted.gather(1, found.clamp(max=K - 1))
                     == ids).sum())
    recall = hits / (n * BATCH * K)
    if recall < TARGETS.get(method, 1.0) - 0.01:
        fail(f"{s.name} {method}: recall {recall} against exact below "
             f"{TARGETS.get(method, 1.0) - 0.01}")
    return recall, launched


def hold_eval_metrics(torch, s, chunk=16384):
    """One eval batch of `bpr_serving`'s `s` on numpy-made id lists, held
    against the dense metrics on the same users (rtol 1e-5, atol 1e-6);
    the dense scores come from the same chunked matmuls as the eval path,
    so both rank bit-identical scores. Returns the mean AUC."""
    from openrec_tpu_torch.metrics.ranking import (AUC, NDCG, Precision,
                                                   Recall, ids_to_masks)
    from openrec_tpu_torch.ops import topk as tk
    B, P, E, at = min(64, BATCH), 10, 20, (50, 100)
    uids = s.requests[0][:B]
    pos = np.full((B, P), -1, np.int64)
    excl = np.full((B, E), -1, np.int64)
    for r in range(B):
        n_pos = int(s.rng.integers(1, P + 1))
        picks = s.rng.choice(s.items, size=n_pos + E, replace=False)
        pos[r, :n_pos], excl[r] = picks[:n_pos], picks[n_pos:]
    got = s.scorer.eval_metrics(s.params, uids, pos, excl, at=at,
                                chunk=chunk)
    u32 = s.flat["user_embed"][torch.as_tensor(uids, device=s.dev)]
    pred = torch.cat([tk.dot_scores(
        u32, s.flat["item_embed"][lo:lo + chunk],
        s.flat["item_bias"][lo:lo + chunk])
        for lo in range(0, s.items, chunk)], dim=1)
    pm, em = ids_to_masks(torch.as_tensor(pos, device=s.dev),
                          torch.as_tensor(excl, device=s.dev), s.items)
    want = {"AUC": AUC(pm, pred, em), "Recall": Recall(pm, pred, em, at),
            "NDCG": NDCG(pm, pred, em, at),
            "Precision": Precision(pm, pred, em, at)}
    for key, w in want.items():
        g = got[key]
        if g.shape != w.shape or not torch.isfinite(g).all():
            fail(f"{s.name} eval {key}: shape {tuple(g.shape)} or "
                 "non-finite")
        if not torch.allclose(g, w, rtol=1e-5, atol=1e-6):
            fail(f"{s.name} eval {key}: chunked {g} != dense {w}")
    return got["AUC"].mean().item()


# Criteo Kaggle's per-table cardinalities (benchmarks/dlrm_throughput.py:
# 25-27, the facebookresearch/dlrm counts): 33,762,577 rows in 26 tables
CRITEO_COUNTS = (1460, 583, 10131227, 2202608, 305, 24, 12517, 633, 3,
                 93145, 5683, 8351593, 3194, 27, 14992, 5461306, 10, 5652,
                 2173, 4, 7046547, 18, 15, 286181, 105, 142572)
# dlrm-kaggle.train-zipf's sparse Adam (portbench/traffic/train-zipf.json,
# batch 65,536): the 26 tables fused into one of 33,762,577 x 16 fp32
# rows, 26 x 65,536 id slots, 210,127 of them live (the distinct rows a
# batch of its Zipf(1.05) ids holds, `openrec.train.unique_rows`); Adam at
# the sparse step's defaults
SPARSE_ADAM = dict(rows=sum(CRITEO_COUNTS), dim=16,
                   cap=26 * 65_536, live=210_127, lr=1e-3, b1=0.9,
                   b2=0.999, eps=1e-7)
# dlrm-dcnv2.train-multihot's (portbench/configs/dlrm-dcnv2.json, batch
# 8,192 of 214 ids): one fused table of 26,500,127 x 128 fp32 rows (32
# float4 chunks a row), 1,753,088 id slots, 714,574 of them live
# (`openrec.train.unique_rows` of its traced slice)
SPARSE_ADAM_DCN = dict(SPARSE_ADAM, rows=26_500_127, dim=128,
                       cap=8_192 * 214, live=714_574)


def sparse_adam_inputs(torch, gen, dev, layout, cfg):
    """One table's call of `sparse_adam_apply` at `cfg`'s shapes (one of
    the `SPARSE_ADAM` dicts): table, mu, nu, rows, write mask, gradient,
    alpha.
    layout "flat": the flat dedup's, the live rows sorted at the front
    (int32) and every pad repeating the last; "partial": the partial
    path's, live slots scattered over the cap (int64) and each dead slot
    at a random row, live rows included."""
    from openrec_tpu_torch.training.optim import _adam_alpha
    rows, D, cap, live = cfg["rows"], cfg["dim"], cfg["cap"], cfg["live"]
    table = (torch.rand(rows, D, generator=gen, device=dev) - 0.5) * 0.1
    mu = torch.randn(rows, D, generator=gen, device=dev) * 1e-3
    nu = torch.rand(rows, D, generator=gen, device=dev) ** 4 * 1e-4
    g = torch.randn(cap, D, generator=gen, device=dev) * 1e-2
    picked = torch.randperm(rows, generator=gen, device=dev)[:live]
    if layout == "flat":
        picked = picked.sort().values
        at = picked[-1:].repeat(cap)
        at[:live] = picked
        at = at.to(torch.int32)
        write = torch.arange(cap, device=dev) < live
    else:
        slots = torch.randperm(cap, generator=gen, device=dev)[:live]
        at = torch.randint(0, rows, (cap,), generator=gen, device=dev)
        at[slots] = picked
        write = torch.zeros(cap, dtype=torch.bool, device=dev)
        write[slots] = True
    alpha = _adam_alpha(torch.tensor(10, device=dev), cfg["lr"],
                        cfg["b1"], cfg["b2"])
    return table, mu, nu, at, write, g, alpha


def sparse_adam_hyper(cfg):
    return cfg["b1"], cfg["b2"], cfg["eps"]


def state_checksum(torch, tensors, rows=1 << 18):
    """Two exact checksums of float32 tensors' bits: their sum, and their
    sum weighted by each element's position (so that rows swapped or
    moved change it), as int64 sums that wrap, whose order of summation
    does not matter; `rows` rows at a time."""
    plain = weighted = 0
    for t in tensors:
        at = 0
        for chunk in t.view(torch.int32).split(rows):
            bits = chunk.reshape(-1).long()
            plain = plain + bits.sum()
            weighted = weighted + (bits * torch.arange(
                at + 1, at + 1 + bits.numel(), device=bits.device)).sum()
            at += bits.numel()
    return int(plain), int(weighted)


def hold_sparse_adam(torch, sa, args, what):
    """The sparse-Adam kernel held against `sparse_adam_plain` on one card
    state, `args` as `sparse_adam_apply` takes them, with no second copy
    of the state (dlrm-dcnv2's is half the card): the plain version runs
    first, its live rows are kept and the old ones put back; then the
    kernel runs. Its live rows of table, mu and nu must equal the plain
    version's (`torch.equal`), at least half the live rows must move,
    every other row must be as it was (`state_checksum` of the whole
    state with the old live rows put back), and one launch is counted.
    Leaves the kernel's state; returns the number of live rows."""
    table, mu, nu, at, write = args[:5]
    state = (table, mu, nu)
    live = at[write].long().unique()
    old = [t.index_select(0, live) for t in state]
    sums = state_checksum(torch, state)
    sa.sparse_adam_plain(*args)
    want = [t.index_select(0, live) for t in state]
    for t, o in zip(state, old):
        t.index_copy_(0, live, o)
    if state_checksum(torch, state) != sums:
        fail(f"{what}: the plain version wrote a row that is not live")
    before = launch_counts(kernels=("sparse_adam",))
    sa.sparse_adam_apply(*args)
    torch.cuda.synchronize()
    counted_once("sparse_adam", before, what)
    got = [t.index_select(0, live) for t in state]
    for name, g, w in zip(("table", "mu", "nu"), got, want):
        if not torch.equal(g, w):
            fail(f"{what}: the kernel's {name} is not the plain version's")
    moved = int((got[0] != old[0]).any(1).sum())
    if moved < live.numel() // 2:
        fail(f"{what}: {moved} of {live.numel()} live rows moved")
    for t, o in zip(state, old):
        t.index_copy_(0, live, o)
    if state_checksum(torch, state) != sums:
        fail(f"{what}: the kernel wrote a row that is not live")
    for t, g in zip(state, got):
        t.index_copy_(0, live, g)
    return live.numel()


# the view gradient at the training cells' shapes, one batch of each
# cell's ids: train-zipf's 26 x 65,536 Zipf(1.05) ids over Criteo-Kaggle's
# tables into the flat dedup's [1,703,936, 16] view, and train-multihot's
# 8,192 examples of 214 ids in MLPerf's 26 bags into a [1,753,088, 128]
# view (MLPerf DLRM-DCNv2's row counts and bag sizes; each bag's first id
# Zipf(1.05), its others uniform over the table's rows)
DCN_COUNTS = (5_000_000, 39_060, 17_295, 7_424, 20_265, 3, 7_122, 1_543, 63,
              5_000_000, 383_495, 405_282, 10, 2_209, 11_938, 155, 4, 976,
              14, 5_000_000, 5_000_000, 5_000_000, 590_152, 12_973, 108, 36)
DCN_BAGS = (3, 2, 1, 2, 6, 1, 1, 1, 1, 7, 3, 8, 1, 6, 9, 5, 1, 1, 1, 12,
            100, 27, 10, 3, 1, 1)
VIEW_GRAD = {
    "train-zipf": dict(ln_emb=CRITEO_COUNTS, bags=None, D=16, batch=65_536,
                       zipf=1.05),
    "train-multihot": dict(ln_emb=DCN_COUNTS, bags=DCN_BAGS, D=128,
                           batch=8_192, zipf=1.05)}


def zipf_ids(torch, count, n, exponent, gen, dev):
    """n ids in [0, count): rank r (0-based) with probability proportional
    to (r + 1)**-exponent, by inverse transform over the exact CDF, mapped
    through a seeded permutation of the rows."""
    ranks = torch.arange(1, count + 1, dtype=torch.float64, device=dev)
    cdf = torch.cumsum(ranks.pow_(-exponent), 0)
    cdf /= cdf[-1].clone()
    u = torch.rand(n, dtype=torch.float64, device=dev, generator=gen)
    r = torch.searchsorted(cdf, u).clamp_(max=count - 1)
    return torch.randperm(count, device=dev, generator=gen)[r]


def view_grad_inputs(torch, dev, seed, cell):
    """One batch of `cell`'s ids through the flat dedup, as the sparse step
    makes them: {grad (of the lookups, or of the bags), positions, cap,
    order (the dedup's), bag (None for lookups), offsets, live}; the
    gradient drawn at 1e-3 scale."""
    from openrec_tpu_torch.ops import view_grad as vg
    from openrec_tpu_torch.training import sparse as tsparse
    shape = VIEW_GRAD[cell]
    B, counts = shape["batch"], shape["ln_emb"]
    sizes = shape["bags"] or (1,) * len(counts)
    gen = torch.Generator(device=dev).manual_seed(seed)
    cols = []
    for count, size in zip(counts, sizes):
        cols.append(zipf_ids(torch, count, B, shape["zipf"], gen, dev))
        cols += [torch.randint(0, count, (B,), generator=gen, device=dev)
                 for _ in range(size - 1)]
    starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
    ids = (torch.stack(cols, 1) + torch.as_tensor(
        np.repeat(starts, sizes), device=dev)).reshape(-1)
    n = ids.shape[0]
    uids, valid, order = tsparse.unique_padded_order(ids, n)
    # SubTable.positions: every id is in the view, so nothing clamps
    pos = torch.searchsorted(uids, ids)
    offsets, bag = None, None
    if shape["bags"]:
        first = torch.as_tensor(np.concatenate([[0], np.cumsum(sizes)[:-1]]),
                                device=dev)
        offsets = (torch.arange(B, device=dev)[:, None] * sum(sizes)
                   + first[None, :]).reshape(-1)
        bag = vg.bag_of(offsets, n)
    rows = n if bag is None else offsets.shape[0]
    grad = torch.randn(rows, shape["D"], generator=gen, device=dev) * 1e-3
    return dict(grad=grad, pos=pos, cap=n, order=order, bag=bag,
                offsets=offsets, live=int(valid.sum()))


def check_view_grad(torch, vg, got, grad, pos, cap, bag, others, what):
    """`got`, the [cap, D] view gradient of `grad` at positions `pos` (in
    bags `bag`, or None), within the bound of two fp32 summation orders
    of each of `others` ({name: gradient}), and every row that no lookup
    reads exactly zero. The bound: each of two sums of a row of L lookups
    lies within (L - 1) * 2**-24 * sum(|g|) of the exact sum (recursive
    summation's error bound, every partial sum a sum of the same terms),
    so they lie within twice that of each other; a row of one lookup is
    that lookup in both."""
    mass = vg.view_grad_plain(grad.abs(), pos, cap, bag)
    count = torch.bincount(pos.long(), minlength=cap)
    bound = 2 * (count - 1).clamp(min=0)[:, None] * 2.0 ** -24 * mass
    for name, want in others.items():
        if not bool(((got - want).abs() <= bound).all()):
            fail(f"{what}: beyond two fp32 summation orders of {name}")
    if not bool((got[count == 0] == 0).all()):
        fail(f"{what}: a row that no lookup reads is not zero")


def hold_view_grad(torch, vg, x, what):
    """The view-gradient kernel on `view_grad_inputs`' `x`, with the
    dedup's order: two calls `torch.equal`, one launch counted a call,
    and `check_view_grad` against its plain version and ATen's autograd
    backward (`index_select`'s, `embedding_bag`'s) on the card. Returns
    (the gradient, max |diff| against the plain version)."""
    grad, pos, cap, bag = x["grad"], x["pos"], x["cap"], x["bag"]
    before = launch_counts(kernels=("view_grad",))
    got = vg.view_grad(grad, pos, cap, order=x["order"], bag=bag)
    torch.cuda.synchronize()
    counted_once("view_grad", before, what)
    if not torch.equal(got, vg.view_grad(grad, pos, cap, order=x["order"],
                                         bag=bag)):
        fail(f"{what}: two calls differ")
    rows = torch.zeros(cap, grad.shape[1], device=grad.device,
                       requires_grad=True)
    y = rows.index_select(0, pos) if bag is None \
        else torch.nn.functional.embedding_bag(pos, rows, x["offsets"],
                                               mode="sum")
    plain = vg.view_grad_plain(grad, pos, cap, bag)
    check_view_grad(torch, vg, got, grad, pos, cap, bag,
                    {"plain": plain,
                     "library": torch.autograd.grad(y, rows, grad)[0]},
                    what)
    return got, (got - plain).abs().max().item()
