"""Port parity, row-sharded (model-parallel) training at widths that do
not split evenly, on a gloo mesh of 1 data x 4 model CPU ranks:

  - the vocabulary-parallel softmax (`parallel.sharded_softmax_ce`)
    against `softmax_ce_loss` over the whole table, values and gradients;
  - the default rules accept every model class of `openrec_tpu_torch.
    models` at model > 1, in the step builders and `ParallelTrainer`;
  - three SGD steps of the sequence models (RNNRec with the full softmax,
    GRU and LSTM; the sampled softmax host-fed and device-sampled; the
    YouTube models with dropout), the censoring models (UCML, WCML,
    VisualCML) and ItrMLP (`train(update_interval=)`, so
    `update_embeddings` runs on every rank over its shard), each held
    against the port's flat Trainer on one rank from the same init and
    seeds (UCML also through the sparse step, its bias a dense leaf read
    through its view): losses and the gathered parameters; rows no batch
    touched keep their bits, and the pad rows stay zero;
  - `ParallelTrainer.evaluate` / `evaluate_temporal` equal the flat
    Trainer's (mask and id batches, next-item, per-record MSE), so
    `full_params` cuts the pad rows off;
  - a rank serves its shard of a trained RNNRec or ItrMLP through
    `sharded_pallas_topk` (K1 and K2's plain version on the CPU): no pad
    row is served, every score is the fp32 score of its id.

30 users x 62 items over 4 ranks leaves two pad rows in each table. JAX
cannot place such widths (its `device_put` demands divisibility), so the
flat Trainer is the reference; `test_torch_dp_models.py` holds the same
models against JAX's GSPMD step at divisible widths. The ranks are
processes of `python -c WORKER` (`parallel.launch`, one launch for the
file, under its own timeout); WORKER never imports JAX. Bars: losses rtol
1e-5; parameters and metrics rtol 1e-5, atol 1e-6.
"""

import os
import pickle

import numpy as np
import pytest
import torch

from openrec_tpu_torch import models
from openrec_tpu_torch.data import (DeviceTemporalSampler, EvaluationSampler,
                                    InteractionStore, RegressionEvalSampler,
                                    TemporalEvaluationSampler)
from openrec_tpu_torch.modules.losses import softmax_ce_loss
from openrec_tpu_torch.parallel import fold_in
from openrec_tpu_torch.parallel.launch import spawn_local
from openrec_tpu_torch.training import Trainer
from openrec_tpu_torch.training.optim import GradientTransformation

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLD = 4                      # a 1 (data) x 4 (model) mesh
USERS, ITEMS, DIM, B, K, L, LR = 30, 62, 8, 16, 4, 5, 0.05
STEPS, SEED, SAMPLE_SEED = 3, 7, 5
RTOL, ATOL = 1e-5, 1e-6
FEATS = np.maximum(np.random.default_rng(3).normal(size=(ITEMS, 12)),
                   0.0).astype(np.float32)
SEQ = dict(total_items=ITEMS, dim_item_embed=DIM, max_seq_len=L)

# name -> (class, positional widths, keyword arguments, batch kind, how the
# mesh steps: "step" make_parallel_train_step, "device" make_parallel_
# device_train_step, "trainer" ParallelTrainer.train_step, "train"
# ParallelTrainer.train with update_interval, "sparse" ParallelTrainer's
# sparse step over SPARSE_SPECS, item_bias left to the dense optimizer)
CASES = {
    "RNNRec-gru": ("RNNRec", (), dict(SEQ, num_units=5), "sequence",
                   "trainer"),
    "RNNRec-lstm": ("RNNRec", (), dict(SEQ, num_units=5, cell_type="lstm"),
                    "sequence", "step"),
    "RNNRec-sampled": ("RNNRec", (), dict(SEQ, num_units=5,
                                          softmax_samples=15),
                       "sequence", "step"),
    "RNNRec-sampled-device": ("RNNRec", (), dict(SEQ, num_units=5,
                                                 softmax_samples=15),
                              "device", "device"),
    "VanillaYouTubeRec": ("VanillaYouTubeRec", (), dict(
        SEQ, mlp_units=(16, ITEMS), dropout=0.5), "sequence", "step"),
    "YouTubeRec": ("YouTubeRec", (), dict(
        SEQ, mlp_units=(16, 8, ITEMS), dropout=0.5, total_genders=3,
        total_geos=10, dim_gender_embed=3, dim_geo_embed=4),
        "sequence", "trainer"),
    "UCML": ("UCML", (USERS, ITEMS, DIM, DIM),
             dict(margin=0.5, l2_weight=0.01), "pairwise", "trainer"),
    "UCML-sparse": ("UCML", (USERS, ITEMS, DIM, DIM),
                    dict(margin=0.5, l2_weight=0.01), "pairwise", "sparse"),
    "WCML": ("WCML", (USERS, ITEMS, DIM), dict(margin=0.5, l2_weight=0.01),
             "npairwise", "step"),
    "VisualCML": ("VisualCML", (USERS, ITEMS, DIM), dict(
        mlp_units=(10,), margin=0.5, l2_weight=0.01, item_features=FEATS),
        "pairwise", "trainer"),
    "ItrMLP": ("ItrMLP", (USERS, ITEMS, 6), dict(user_dims=(10, 6),
                                                 item_dims=(12, 6)),
               "rating", "train"),
}
UPDATE_INTERVAL = 2
# the softmax's inputs: bias shift of the real rows
SOFTMAX_CASES = {"spread": 0.0, "below_pad": -50.0}
SPARSE_SPECS = {"user_embed": ["user_id"],
                "item_embed": ["p_item_id", "n_item_id"]}
SPARSE_LR = 0.01
# the table of each kind's ids in a batch, for the untouched rows
TOUCH = {"sequence": {"item_embed": ("seq_item_id",)},
         "pairwise": {"user_embed": ("user_id",),
                      "item_embed": ("p_item_id", "n_item_id")},
         "npairwise": {"user_embed": ("user_id",),
                       "item_embed": ("p_item_id", "n_item_id")}}

# every model class at a small width, for the refusal check
ALL_MODELS = {
    "BPR": ("BPR", (USERS, ITEMS, DIM, DIM), {}),
    "PMF": ("PMF", (USERS, ITEMS, DIM, DIM), {}),
    "WRMF": ("WRMF", (USERS, ITEMS, DIM, DIM), {}),
    "GMF": ("GMF", (USERS, ITEMS, DIM, DIM), {}),
    "UCML": ("UCML", (USERS, ITEMS, DIM, DIM), {}),
    "CML": ("CML", (USERS, ITEMS, DIM, DIM), {}),
    "DLRM": ("DLRM", (), dict(m_spa=4, ln_emb=(30, 62), ln_bot=(4, 4),
                              ln_top=(8, 1), dim_dense=3)),
    "NBPR": ("NBPR", (USERS, ITEMS, DIM), {}),
    "WCML": ("WCML", (USERS, ITEMS, DIM), {}),
    "MLPRec": ("MLPRec", (USERS, ITEMS, DIM, DIM), {}),
    "NeuMF": ("NeuMF", (USERS, ITEMS, DIM, DIM), {}),
    "CDL": ("CDL", (USERS, ITEMS, DIM, FEATS), {}),
    "VBPR": ("VBPR", (USERS, ITEMS, DIM, DIM), dict(item_features=FEATS)),
    "ConcatVisualBPR": ("ConcatVisualBPR", (USERS, ITEMS, DIM, 3),
                        dict(item_features=FEATS)),
    "VisualBPR": ("VisualBPR", (USERS, ITEMS, DIM),
                  dict(item_features=FEATS)),
    "VisualCML": ("VisualCML", (USERS, ITEMS, DIM),
                  dict(item_features=FEATS)),
    "VisualGMF": ("VisualGMF", (USERS, ITEMS, DIM),
                  dict(item_features=FEATS)),
    "VisualPMF": ("VisualPMF", (USERS, ITEMS, DIM),
                  dict(item_features=FEATS)),
    "UserPMF": ("UserPMF", (USERS, ITEMS, DIM), dict(
        user_features=np.random.default_rng(4).random((USERS, 5)).astype(
            np.float32))),
    "UserVisualPMF": ("UserVisualPMF", (USERS, ITEMS, DIM), dict(
        user_features=np.random.default_rng(4).random((USERS, 5)).astype(
            np.float32), item_features=FEATS)),
    "RNNRec": ("RNNRec", (), dict(SEQ, num_units=5)),
    "VanillaYouTubeRec": ("VanillaYouTubeRec", (), SEQ),
    "YouTubeRec": ("YouTubeRec", (), SEQ),
    "ItrMLP": ("ItrMLP", (USERS, ITEMS, 6), {}),
}

WORKER = r'''
import os, pickle
import numpy as np
import torch
torch.set_num_threads(1)
import torch.distributed as dist
from openrec_tpu_torch import ParallelTrainer, models
from openrec_tpu_torch import parallel as par
from openrec_tpu_torch.data import (DeviceTemporalSampler, EvaluationSampler,
                                    InteractionStore, RegressionEvalSampler,
                                    TemporalEvaluationSampler)
from openrec_tpu_torch.training.optim import GradientTransformation

inp = pickle.load(open(os.environ["CASES_IN"], "rb"))
out = {}
mesh = par.make_mesh(1, 4, device="cpu")
lr = inp["lr"]
sgd = GradientTransformation(
    lambda params, device=None: {},
    lambda g, s, p=None: ({k: -lr * v for k, v in g.items()}, s))


def batch_t(b):
    return {k: torch.as_tensor(v) for k, v in b.items()}


def gathered(model, shardings):
    with par.full_params(model, shardings, mesh):
        return {k: v.detach().numpy().copy()
                for k, v in model.params().items()}


def build(c):
    model = getattr(models, c["cls"])(*c["widths"], device="cpu", **c["kw"])
    model.load_params(c["params"])
    return model


def pad_rows(model, shardings):
    """{name: this rank's pad rows of each sharded leaf}."""
    views = par.table_views(model, shardings, mesh)
    return {n: v.shard[~v.real_rows()].detach().numpy().copy()
            for n, v in views.items()}


# the vocabulary-parallel softmax: values and gradients
for case, sm in inp["softmax"].items():
    h = torch.tensor(sm["hidden"], requires_grad=True)
    n = -(-sm["weight"].shape[0] // 4)
    r = dist.get_rank()
    w_full = np.zeros((4 * n, sm["weight"].shape[1]), np.float32)
    w_full[:sm["weight"].shape[0]] = sm["weight"]
    b_full = np.zeros(4 * n, np.float32)
    b_full[:sm["bias"].shape[0]] = sm["bias"]
    w = torch.tensor(w_full[r * n:(r + 1) * n], requires_grad=True)
    b = torch.tensor(b_full[r * n:(r + 1) * n], requires_grad=True)
    loss = par.sharded_softmax_ce(h, w, b, torch.as_tensor(sm["labels"]),
                                  sm["weight"].shape[0], mesh)
    gh, gw, gb = torch.autograd.grad(loss, [h, w, b])
    out["softmax_" + case] = (float(loss), gh.numpy(), gw.numpy(),
                              gb.numpy())

# every model class: no refusal at model > 1 under the default rules
accepted = {}
for name, (cls, widths, kw) in inp["all_models"].items():
    got = []
    for how in ("step", "device", "trainer"):
        model = getattr(models, cls)(*widths, device="cpu", **kw)
        try:
            if how == "step":
                sh = par.make_parallel_train_step(model, sgd, mesh)[1]()[2]
            elif how == "device":
                sh = par.make_parallel_device_train_step(
                    model, sgd, mesh, sampler=None)[1]()[2]
            else:
                sh = ParallelTrainer(model, mesh, optimizer=sgd).shardings
            got.append(sorted(n for n, s in sh.items()
                              if s.spec and s.spec[0] == "model"))
        except NotImplementedError as e:
            got.append("refused: " + str(e))
    accepted[name] = got
out["accepted"] = accepted

# three SGD steps of each case, then evaluation and serving
for name, c in inp["cases"].items():
    model = build(c)
    how = c["how"]
    res = {}
    if how in ("trainer", "train", "sparse"):
        opt = (dict(lr=c["sparse_lr"], sparse_tables=c["specs"])
               if how == "sparse" else dict(optimizer=sgd))
        tr = ParallelTrainer(model, mesh, seed=c["seed"], **opt)
        sh = tr.shardings
        if how != "train":
            res["losses"] = [float(tr.train_step(b)[0])
                             for b in c["batches"]]
        else:
            tr.train(total_iter=len(c["batches"]),
                     train_batches=iter(c["batches"]),
                     update_interval=c["update_interval"], verbose=False)
    elif how == "step":
        step, init = par.make_parallel_train_step(model, sgd, mesh)
        _, st, sh = init()
        gen = par.shared_generator(c["seed"], mesh)
        res["losses"] = []
        for b in c["batches"]:
            st, loss, _ = step(st, batch_t(b), gen)
            res["losses"].append(float(loss))
    else:
        store = InteractionStore(c["raw"], c["users"], c["items"],
                                 sortby="ts")
        sampler = DeviceTemporalSampler(store, c["batch"], c["L"],
                                        device="cpu")
        step, init = par.make_parallel_device_train_step(
            model, sgd, mesh, sampler, steps_per_call=c["steps"])
        _, st, sh = init()
        st, losses = step(st, par.rank_generator(c["sample_seed"], mesh),
                          par.shared_generator(c["seed"], mesh))
        res["losses"] = losses.tolist()
    res["params"] = gathered(model, sh)
    res["pads"] = pad_rows(model, sh)
    res["local_rows"] = {n: model.params()[n].shape[0]
                         for n, s in sh.items()
                         if s.spec and s.spec[0] == "model"}
    views = par.table_views(model, sh, mesh)
    ev = c.get("eval")
    if ev is not None:
        kind = ev["kind"]
        if kind == "mask":
            train_store = InteractionStore(ev["train"], c["users"],
                                           c["items"])
            test_store = InteractionStore(ev["test"], c["users"],
                                          c["items"])
            res["eval"] = {
                "mask": tr.evaluate(EvaluationSampler(
                    test_store, 8, excl_stores=[train_store]), at=(5, 10)),
                "ids": tr.evaluate(EvaluationSampler(
                    test_store, 8, excl_stores=[train_store],
                    device_masks=True), at=(5, 10))}
        elif kind == "temporal":
            store = InteractionStore(ev["raw"], c["users"], c["items"],
                                     sortby="ts")
            res["eval"] = tr.evaluate_temporal(TemporalEvaluationSampler(
                store, 8, c["L"]), at=(5, 10))
        else:
            store = InteractionStore(ev["raw"], c["users"], c["items"])
            res["eval"] = tr.evaluate(RegressionEvalSampler(store, 8))
    serve = c.get("serve")
    if serve is not None:
        with torch.no_grad():
            if c["cls"] == "RNNRec":
                w, bias = model.serving_tables(views)
                u = model.hidden(batch_t(serve["batch"]), tables=views)
            else:
                w, bias = model.serving_tables(views)
                u = model.user_vecs(batch_t(serve["batch"]), tables=views)
            res["serve"] = {"u": u.numpy().copy(),
                            "table": w.numpy().copy(),
                            "bias": bias.numpy().copy(),
                            "offset": views[serve["table"]].offset}
            for pb in (1, 2):
                vals, ids = par.sharded_pallas_topk(
                    u, w, bias, serve["k"], mesh, per_bucket=pb)
                res["serve"][pb] = (vals.numpy().copy(), ids.numpy().copy())
    out[name] = res

pickle.dump(out, open(os.path.join(os.environ["CASES_OUT"],
                                   f"out-{dist.get_rank()}.pkl"), "wb"))
'''


def _sgd():
    return GradientTransformation(
        lambda params, device=None: {},
        lambda g, s, p=None: ({k: -LR * v for k, v in g.items()}, s))


def _batches(kind, seed):
    """STEPS global batches of `kind`; negatives apart from positives; ids
    up to the last real row."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(STEPS):
        users = rng.integers(0, USERS, B).astype(np.int32)
        users[0] = USERS - 1
        if kind == "rating":
            items = rng.integers(0, ITEMS, B).astype(np.int32)
            items[0] = ITEMS - 1
            out.append({"user_id": users, "item_id": items,
                        "label": rng.uniform(0, 1, B).astype(np.float32)})
        elif kind in ("pairwise", "npairwise"):
            p = rng.integers(0, ITEMS, B)
            p[0] = ITEMS - 1
            if kind == "npairwise":
                n = (p[:, None] + rng.integers(1, ITEMS, (B, K))) % ITEMS
            else:
                n = (p + rng.integers(1, ITEMS, B)) % ITEMS
            out.append({"user_id": users, "p_item_id": p.astype(np.int32),
                        "n_item_id": n.astype(np.int32)})
        else:
            seq_len = rng.integers(0, L + 1, B).astype(np.int32)
            seq_len[:3] = [0, 1, L]
            seq = rng.integers(0, ITEMS, (B, L)).astype(np.int32)
            seq[np.arange(L)[None, :] >= seq_len[:, None]] = 0
            label = rng.integers(0, ITEMS, B).astype(np.int32)
            label[0] = ITEMS - 1
            out.append({"seq_item_id": seq, "seq_len": seq_len,
                        "label": label,
                        "user_gender": rng.integers(0, 3, B).astype(
                            np.int32),
                        "user_geo": rng.integers(0, 10, B).astype(np.int32)})
    return out


def _model(cls, widths, kw, seed):
    return getattr(models, cls)(*widths, device="cpu",
                                generator=torch.Generator().manual_seed(seed),
                                **kw)


def _params(model, seed):
    """The model's init with its tables widened (censoring and batch norms
    that bite) and nonzero biases, as numpy."""
    params = {k: v.detach().numpy().copy()
              for k, v in model.params().items()}
    rng = np.random.default_rng(seed + 100)
    for key in ("user_embed", "item_embed"):
        if key in params:
            params[key] = params[key] * 30.0
    for key in ("item_bias", "out_bias"):
        if key in params:
            params[key] = rng.normal(scale=0.1, size=params[key].shape
                                     ).astype(np.float32)
    return params


def _raw(seed, n, ts=False, label=False):
    rng = np.random.default_rng(seed)
    fields = [("user_id", np.int32), ("item_id", np.int32)]
    fields += [("ts", np.int64)] * ts + [("label", np.float32)] * label
    raw = np.zeros(n, dtype=fields)
    raw["user_id"] = rng.integers(0, USERS, n)
    raw["item_id"] = rng.integers(0, ITEMS, n)
    if ts:
        raw["ts"] = rng.integers(0, 500, n)
    if label:
        raw["label"] = rng.uniform(0, 1, n)
    return raw


def _flat(c, model):
    """The flat Trainer's losses, parameters, evaluation and serving
    scores from the same init and seeds."""
    opt = (dict(lr=SPARSE_LR, sparse_tables=SPARSE_SPECS)
           if c["how"] == "sparse" else dict(optimizer=_sgd()))
    tr = Trainer(model, seed=c["seed"], device="cpu", **opt)
    batches = c["batches"]
    if batches is None:
        sampler = DeviceTemporalSampler(
            InteractionStore(c["raw"], USERS, ITEMS, sortby="ts"),
            c["batch"], L, device="cpu")
        gen = torch.Generator().manual_seed(fold_in(c["sample_seed"], 0))
        batches = [sampler.sample(gen) for _ in range(c["steps"])]
    if c["how"] == "train":
        tr.train(total_iter=len(batches), train_batches=iter(batches),
                 update_interval=c["update_interval"], verbose=False)
        losses = None
    else:
        losses = [float(tr.train_step(b)[0]) for b in batches]
    out = {"losses": losses, "batches": batches,
           "params": {k: v.detach().numpy().copy()
                      for k, v in model.params().items()}}
    ev = c.get("eval")
    if ev is not None:
        kind = ev["kind"]
        if kind == "mask":
            train_store = InteractionStore(ev["train"], USERS, ITEMS)
            test_store = InteractionStore(ev["test"], USERS, ITEMS)
            out["eval"] = {
                "mask": tr.evaluate(EvaluationSampler(
                    test_store, 8, excl_stores=[train_store]), at=(5, 10)),
                "ids": tr.evaluate(EvaluationSampler(
                    test_store, 8, excl_stores=[train_store],
                    device_masks=True), at=(5, 10))}
        elif kind == "temporal":
            out["eval"] = tr.evaluate_temporal(TemporalEvaluationSampler(
                InteractionStore(ev["raw"], USERS, ITEMS, sortby="ts"), 8,
                L), at=(5, 10))
        else:
            out["eval"] = tr.evaluate(RegressionEvalSampler(
                InteractionStore(ev["raw"], USERS, ITEMS), 8))
    serve = c.get("serve")
    if serve is not None:
        with torch.no_grad():
            b = {k: torch.as_tensor(v) for k, v in serve["batch"].items()}
            w, bias = model.serving_tables()
            if c["cls"] == "RNNRec":
                u = model.hidden(b)
            else:
                u = model.user_vecs(b)
            out["serve"] = {"u": u.numpy(), "table": w.numpy(),
                            "bias": bias.numpy()}
    return out


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """(inputs, flat references, per-rank outputs) of one launch of 4 gloo
    ranks."""
    tmp = tmp_path_factory.mktemp("model_parallel")
    rng = np.random.default_rng(0)
    inp = {"lr": LR, "cases": {}, "all_models": ALL_MODELS,
           "softmax": {}}
    for case, shift in SOFTMAX_CASES.items():
        inp["softmax"][case] = {
            "hidden": rng.normal(size=(B, 6)).astype(np.float32),
            "weight": rng.normal(size=(ITEMS, 6)).astype(np.float32),
            "bias": (rng.normal(size=ITEMS) + shift).astype(np.float32),
            "labels": np.r_[ITEMS - 1, rng.integers(
                0, ITEMS, B - 1)].astype(np.int64)}
    ref = {}
    traw = _raw(1, 600, ts=True)
    for i, (name, (cls, widths, kw, kind, how)) in enumerate(CASES.items()):
        model = _model(cls, widths, kw, i)
        params = _params(model, i)
        if cls == "RNNRec" and name == "RNNRec-gru":
            # real rows that score below the pad rows' 0 unless served
            # with the pad rule
            params["out_bias"] = params["out_bias"] - 50.0
        model.load_params(params)
        c = dict(cls=cls, widths=widths, kw=kw, params=params, how=how,
                 seed=SEED + i, sample_seed=SAMPLE_SEED, steps=STEPS,
                 batches=None if kind == "device" else _batches(kind,
                                                                20 + i),
                 raw=traw, users=USERS, items=ITEMS, batch=B, L=L,
                 update_interval=UPDATE_INTERVAL, kind=kind,
                 specs=SPARSE_SPECS, sparse_lr=SPARSE_LR)
        if name in ("UCML", "VisualCML"):
            raw = _raw(30 + i, 400)
            c["eval"] = {"kind": "mask", "train": raw[:300],
                         "test": raw[300:]}
        elif name == "RNNRec-gru":
            c["eval"] = {"kind": "temporal", "raw": traw}
            c["serve"] = {"batch": _batches("sequence", 90)[0], "k": 10,
                          "table": "out_weight"}
        elif name == "ItrMLP":
            c["eval"] = {"kind": "mse", "raw": _raw(40, 100, label=True)}
            c["serve"] = {"batch": _batches("rating", 91)[0], "k": 10,
                          "table": "item_embed"}
        inp["cases"][name] = c
        ref[name] = _flat(c, model)
        ref[name]["init"] = params

    path = tmp / "in.pkl"
    with open(path, "wb") as f:
        pickle.dump(inp, f)
    spawn_local(WORKER, WORLD, timeout=240,
                env={"PYTHONPATH": REPO, "CASES_IN": str(path),
                     "CASES_OUT": str(tmp)})
    outs = []
    for r in range(WORLD):
        with open(tmp / f"out-{r}.pkl", "rb") as f:
            outs.append(pickle.load(f))
    return inp, ref, outs


def _close(got, want, what):
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL,
                               err_msg=what)


@pytest.mark.parametrize("case", list(SOFTMAX_CASES))
def test_vocabulary_parallel_softmax_matches_the_whole_table(run, case):
    """The mean softmax CE over 62 items row-sharded over 4 ranks (two pad
    rows on the last, which enter no denominator) equals
    `softmax_ce_loss` over the whole [B, 62] logits, and its gradients:
    the hidden state's (the sum of every shard's part, the same on every
    rank) and each shard's rows of the weight's and bias's. In
    "below_pad" every real logit lies far below the 0 a pad row would
    score, so a pad row in a denominator would swamp it."""
    inp, _, outs = run
    sm = inp["softmax"][case]
    h = torch.tensor(sm["hidden"], requires_grad=True)
    w = torch.tensor(sm["weight"], requires_grad=True)
    b = torch.tensor(sm["bias"], requires_grad=True)
    loss = softmax_ce_loss(h @ w.T + b, torch.as_tensor(sm["labels"]))
    gh, gw, gb = torch.autograd.grad(loss, [h, w, b])
    n = -(-ITEMS // WORLD)
    got_w = np.concatenate([o["softmax_" + case][2] for o in outs])
    got_b = np.concatenate([o["softmax_" + case][3] for o in outs])
    for o in outs:
        value, got_h, _, _ = o["softmax_" + case]
        np.testing.assert_allclose(value, float(loss.detach()), rtol=RTOL)
        _close(got_h, gh.numpy(), "hidden")
    _close(got_w[:ITEMS], gw.numpy(), "weight")
    _close(got_b[:ITEMS], gb.numpy(), "bias")
    assert not got_w[ITEMS:].any() and not got_b[ITEMS:].any()
    assert got_w.shape[0] == n * WORLD


@pytest.mark.parametrize("name", list(ALL_MODELS))
def test_every_model_shards_its_tables_without_refusal(run, name):
    """On a mesh with four model ranks, `make_parallel_train_step`,
    `make_parallel_device_train_step` and `ParallelTrainer` take every
    model class under the default rules, and shard its tables."""
    _, _, outs = run
    for o in outs:
        got = o["accepted"][name]
        assert not any(isinstance(g, str) for g in got), got
        assert got[0] and got[0] == got[1] == got[2], got


@pytest.mark.parametrize("name", list(CASES))
def test_row_sharded_steps_match_one_rank(run, name):
    """Three SGD steps with the tables row-sharded over four model ranks
    (two pad rows each) against the flat Trainer on one rank: the losses
    and the gathered parameters (ItrMLP's tables moved by
    `update_embeddings` every two steps, its batch norm over the real
    rows only); every rank agrees; rows that no batch touched keep their
    bits (censoring touched only the batch's ids); the pad rows stay
    zero."""
    inp, ref, outs = run
    c = inp["cases"][name]
    want = ref[name]
    for o in outs:
        got = o[name]
        if want["losses"] is not None:
            np.testing.assert_allclose(got["losses"], want["losses"],
                                       rtol=RTOL)
        assert set(got["params"]) == set(want["params"])
        for k, w in want["params"].items():
            assert got["params"][k].shape == w.shape, k
            _close(got["params"][k], w, k)
        for k, rows in got["local_rows"].items():
            assert rows == -(-want["params"][k].shape[0] // WORLD), k
    sharded = outs[0][name]["local_rows"]
    assert sharded, "no table was sharded"
    for k in sharded:                    # the last rank holds the pads
        pads = outs[-1][name]["pads"][k]
        assert pads.shape[0] == WORLD * sharded[k] \
            - want["params"][k].shape[0] and not pads.any(), k
    for table, keys in TOUCH.get(c["kind"], {}).items():
        touched = np.unique(np.concatenate(
            [np.asarray(b[key]).reshape(-1) for b in want["batches"]
             for key in keys]))
        untouched = np.setdiff1d(np.arange(want["params"][table].shape[0]),
                                 touched)
        assert untouched.size
        np.testing.assert_array_equal(
            outs[0][name]["params"][table][untouched],
            want["init"][table][untouched], err_msg=table)


@pytest.mark.parametrize("name", ["UCML", "VisualCML", "RNNRec-gru",
                                  "ItrMLP"])
def test_parallel_evaluation_matches_one_rank(run, name):
    """`ParallelTrainer.evaluate` (mask and id batches; ItrMLP's
    per-record MSE) and `evaluate_temporal` (RNNRec) on the row-sharded
    model equal the flat Trainer's: `full_params` gathers the tables and
    cuts their pad rows off, so no score matrix is wider than the
    catalog."""
    _, ref, outs = run
    want = ref[name]["eval"]
    for o in outs:
        got = o[name]["eval"]
        if "mask" in want:
            for what in ("mask", "ids"):
                assert set(got[what]) == set(want[what])
                for k in want[what]:
                    _close(got[what][k], want[what][k], f"{what} {k}")
        else:
            assert set(got) == set(want)
            for k in want:
                _close(got[k], want[k], k)


@pytest.mark.parametrize("name", ["RNNRec-gru", "ItrMLP"])
@pytest.mark.parametrize("per_bucket", [1, 2])
def test_sharded_serving_never_returns_a_pad_row(run, name, per_bucket):
    """Each rank serves its shard of the trained tables
    (`serving_tables(views)`: pad rows at bias -1e30, ItrMLP's item MLP
    over the shard with its batch norm over the whole table's real rows)
    through `sharded_pallas_topk` (K1 per_bucket=1, K2 per_bucket=2; the
    plain version on CPU tensors): the request vectors and the served
    table equal the flat model's, every served id is a real item, each
    score is the fp32 score of its id, and every rank returns the same.
    RNNRec's real biases sit 50 below zero, so a pad row served at bias 0
    would lead every list."""
    inp, ref, outs = run
    k = inp["cases"][name]["serve"]["k"]
    want = ref[name]["serve"]
    exact = want["u"] @ want["table"].T + want["bias"]
    first = outs[0][name]["serve"][per_bucket]
    for o in outs:
        s = o[name]["serve"]
        _close(s["u"], want["u"], "request vectors")
        n = s["bias"].shape[0]
        lo = s["offset"]
        real = np.arange(lo, lo + n) < ITEMS
        _close(s["bias"][real], want["bias"][lo:lo + real.sum()], "bias")
        _close(s["table"][real], want["table"][lo:lo + real.sum()],
               "served table")
        assert (s["bias"][~real] == -1e30).all()
        vals, ids = s[per_bucket]
        assert vals.shape == ids.shape == (want["u"].shape[0], k)
        assert (ids >= 0).all() and (ids < ITEMS).all()
        for row in ids:
            assert len(set(row.tolist())) == k
        _close(vals, np.take_along_axis(exact, ids, 1), "scores")
        np.testing.assert_array_equal(ids, first[1])
