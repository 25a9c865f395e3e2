"""Port parity, data-parallel training of the model zoo with the JAX step's
global-batch semantics, on a gloo mesh of 2 data x 2 model CPU ranks:

  - against JAX's `make_parallel_train_step` on a 2 x 2 mesh of its CPU
    devices, two SGD steps, every table row-sharded over the two model
    ranks by the default rules on both sides: ItrMLP (a batch norm over
    the global batch), UCML, WCML and VisualCML (`post_step` censors each
    shard's rows after the all_reduce), CDL with the SDAE's dropout 0,
    RNNRec with the full softmax (vocabulary-parallel), GRU and LSTM, and
    VanillaYouTubeRec without dropout;
  - against the port at one data rank (the flat `Trainer`, on the global
    batch, its generator seeded as the mesh's shared one), where the draws
    are torch's own: NeuMF, MLPRec and YouTubeRec with dropout, CDL with
    the SDAE's dropout, RNNRec with the sampled softmax, host-fed and
    device-sampled (each data rank's slice from its own generator, the
    loss's draws from the shared one), and NeuMF through the
    device-sampled sparse step;
  - the two data slices' dropout masks differ, and together are the mask
    one rank draws for the whole batch (a mask drawn with the slice's
    shape from a generator seeded alike on every rank repeats itself);
  - the batch norm outside a data-parallel context is bit for bit the
    formula it had before.

The ranks are processes of `python -c WORKER` (`parallel.launch`, one
launch for the file, under its own timeout); WORKER never imports JAX.
Bars: losses and aux rtol 1e-5; parameters rtol 1e-5, atol 1e-6.
"""

import os
import pickle

import jax
import numpy as np
import optax
import pytest
import torch

from openrec_tpu import models as jmodels
from openrec_tpu.data.pipeline import to_device
from openrec_tpu.models.itr_mlp import ItrMLP as JItrMLP
from openrec_tpu.models.sequence import RNNRec as JRNNRec
from openrec_tpu.models.sequence import \
    VanillaYouTubeRec as JVanillaYouTubeRec
from openrec_tpu.parallel import batch_sharding, make_parallel_train_step
from openrec_tpu.parallel.mesh import make_mesh, shard_params
from openrec_tpu_torch import convert, models
from openrec_tpu_torch.data import (DevicePointwiseSampler,
                                    DeviceTemporalSampler, InteractionStore)
from openrec_tpu_torch.modules import global_batch
from openrec_tpu_torch.modules.mlp import MLP
from openrec_tpu_torch.parallel import fold_in
from openrec_tpu_torch.parallel.launch import spawn_local
from openrec_tpu_torch.training import Trainer
from openrec_tpu_torch.training import sparse as tsparse
from openrec_tpu_torch.training.optim import GradientTransformation

pytestmark = pytest.mark.skipif(len(jax.devices()) < 4,
                                reason="needs 4 virtual devices")
torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLD = 4                      # a 2 (data) x 2 (model) mesh
USERS, ITEMS, DIM, B, K, L, LR = 32, 64, 8, 16, 4, 5, 0.05
STEPS, LOSS_SEED, SAMPLE_SEED = 2, 7, 5
RTOL, ATOL = 1e-5, 1e-6
FEATS = np.maximum(np.random.default_rng(3).normal(size=(ITEMS, 12)),
                   0.0).astype(np.float32)
CDL_FEATS = (np.random.default_rng(11).random((ITEMS, 20)) < 0.2).astype(
    np.float32)

# against JAX, both sides under the default rules: name -> (model class,
# positional widths, keyword arguments, batch kind)
JAX_CASES = {
    "ItrMLP": ("ItrMLP", (6,), dict(user_dims=(10, 6), item_dims=(12, 6)),
               "rating"),
    "UCML": ("UCML", (DIM, DIM), dict(margin=0.5, l2_weight=0.01),
             "pairwise"),
    "WCML": ("WCML", (DIM,), dict(margin=0.5, l2_weight=0.01), "npairwise"),
    "VisualCML": ("VisualCML", (DIM,), dict(mlp_units=(10,), margin=0.5,
                                            l2_weight=0.01), "pairwise"),
    "CDL": ("CDL", (DIM,), dict(encoder_dims=(12,), l2_reconst=0.1, a=1.0,
                                b=0.01, l2_weight=0.01, dropout=0.0),
            "pointwise"),
    "RNNRec": ("RNNRec", (), dict(total_items=ITEMS, dim_item_embed=DIM,
                                  max_seq_len=L, num_units=5),
               "sequence"),
    "RNNRec-lstm": ("RNNRec", (), dict(total_items=ITEMS, dim_item_embed=DIM,
                                       max_seq_len=L, num_units=5,
                                       cell_type="lstm"),
                    "sequence"),
    "VanillaYouTubeRec": ("VanillaYouTubeRec", (), dict(
        total_items=ITEMS, dim_item_embed=DIM, max_seq_len=L,
        mlp_units=(16, ITEMS)), "sequence"),
}
# against the port at one data rank: name -> (class, positional widths,
# keyword arguments, batch kind, rules, how the mesh steps)
D1_CASES = {
    "NeuMF": ("NeuMF", (DIM, 6), dict(mlp_units=(16, 8, 1), alpha=0.4,
                                      dropout=0.5, l2_weight=0.01),
              "pointwise", None, "trainer"),
    "MLPRec": ("MLPRec", (DIM, DIM), dict(mlp_units=(16, 8, 1), dropout=0.5,
                                          l2_weight=0.01),
               "pointwise", None, "step"),
    "YouTubeRec": ("YouTubeRec", (), dict(
        total_items=ITEMS, dim_item_embed=DIM, max_seq_len=L,
        mlp_units=(16, 8, ITEMS), dropout=0.5, total_genders=3,
        total_geos=10, dim_gender_embed=3, dim_geo_embed=4),
        "sequence", (), "step"),
    "CDL": ("CDL", (DIM,), dict(encoder_dims=(12,), l2_reconst=0.1,
                                dropout=0.3, l2_weight=0.01),
            "pointwise", None, "trainer"),
    "RNNRec": ("RNNRec", (), dict(total_items=ITEMS, dim_item_embed=DIM,
                                  max_seq_len=L, num_units=5,
                                  softmax_samples=15),
               "sequence", (), "step"),
    "RNNRec-device": ("RNNRec", (), dict(
        total_items=ITEMS, dim_item_embed=DIM, max_seq_len=L, num_units=5,
        softmax_samples=15), "device", (), "device_step"),
    "RNNRec-device-trainer": ("RNNRec", (), dict(
        total_items=ITEMS, dim_item_embed=DIM, max_seq_len=L, num_units=5,
        softmax_samples=15), "device", (), "device_trainer"),
    "NeuMF-device-sparse": ("NeuMF", (DIM, 6), dict(
        mlp_units=(16, 8, 1), alpha=0.4, dropout=0.5, l2_weight=0.01),
        "device", None, "device_sparse"),
}
# the sparse step's tables and the batch keys that index them (NeuMF)
SPARSE_SPECS = {"user_ge": ["user_id"], "item_ge": ["item_id"],
                "user_mlp_embed": ["user_id"],
                "item_mlp_embed": ["item_id"], "item_bias": ["item_id"]}

WORKER = r'''
import os, pickle
import numpy as np
import torch
torch.set_num_threads(1)
import torch.distributed as dist
from openrec_tpu_torch import ParallelTrainer, models
from openrec_tpu_torch import parallel as par
from openrec_tpu_torch.data import (DevicePointwiseSampler,
                                    DeviceTemporalSampler, InteractionStore)
from openrec_tpu_torch.models.base import Recommender
from openrec_tpu_torch.modules.mlp import MLP
from openrec_tpu_torch.training.optim import GradientTransformation

inp = pickle.load(open(os.environ["CASES_IN"], "rb"))
out = {}
mesh = par.make_mesh(2, 2, device="cpu")
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


def build(cls, widths, kw, params):
    model = getattr(models, cls)(*widths, device="cpu", **kw)
    model.load_params(params)
    return model


def rules_kw(rules):
    return {} if rules is None else {"rules": rules}


# against JAX: make_parallel_train_step's host-fed step, SGD
for name, c in inp["jax"].items():
    model = build(c["cls"], c["widths"], c["kw"], c["params"])
    step, init = par.make_parallel_train_step(model, sgd, mesh)
    _, st, sh = init()
    gen = par.shared_generator(0, mesh)
    losses, auxes = [], []
    for b in c["batches"]:
        st, loss, aux = step(st, batch_t(b), gen)
        losses.append(float(loss))
        auxes.append({k: float(v) for k, v in aux.items()})
    out["jax_" + name] = (losses, auxes, gathered(model, sh))

# against the port at one data rank: the draws from the shared generator
for name, c in inp["d1"].items():
    model = build(c["cls"], c["widths"], c["kw"], c["params"])
    how = c["how"]
    if how in ("trainer", "device_trainer"):
        tr = ParallelTrainer(model, mesh, optimizer=sgd, seed=c["seed"],
                             **rules_kw(c["rules"]))
        sh = tr.shardings
        if how == "trainer":
            losses = [float(tr.train_step(b)[0]) for b in c["batches"]]
        else:
            store = InteractionStore(c["raw"], c["users"], c["items"],
                                     sortby="ts")
            sampler = DeviceTemporalSampler(store, c["slice"], c["L"],
                                            device="cpu")
            losses = tr.train_steps_device(sampler, c["steps"]).tolist()
    elif how == "step":
        step, init = par.make_parallel_train_step(model, sgd, mesh,
                                                  **rules_kw(c["rules"]))
        _, st, sh = init()
        gen = par.shared_generator(c["seed"], mesh)
        losses = []
        for b in c["batches"]:
            st, loss, _ = step(st, batch_t(b), gen)
            losses.append(float(loss))
    elif how == "device_sparse":
        store = InteractionStore(c["raw"], c["users"], c["items"])
        sampler = DevicePointwiseSampler(store, c["slice"], device="cpu")
        step, init = par.make_parallel_device_sparse_train_step(
            model, c["specs"], mesh, sampler, steps_per_call=c["steps"],
            learning_rate=lr, **rules_kw(c["rules"]))
        _, st, sh = init()
        st, losses = step(st, par.rank_generator(c["sample_seed"], mesh),
                          par.shared_generator(c["seed"], mesh))
        losses = losses.tolist()
    else:
        store = InteractionStore(c["raw"], c["users"], c["items"],
                                 sortby="ts")
        sampler = DeviceTemporalSampler(store, c["slice"], c["L"],
                                        device="cpu")
        step, init = par.make_parallel_device_train_step(
            model, sgd, mesh, sampler, steps_per_call=c["steps"],
            **rules_kw(c["rules"]))
        _, st, sh = init()
        st, losses = step(st, par.rank_generator(c["sample_seed"], mesh),
                          par.shared_generator(c["seed"], mesh))
        losses = losses.tolist()
    out["d1_" + name] = (losses, gathered(model, sh))


# the dropout mask of each data slice: a probe whose loss keeps the mask
# of its MLP's hidden layer (all of whose units are positive)
class Probe(Recommender):
    loss_reduction = "sum"

    def __init__(self):
        super().__init__()
        self.mlp = MLP(4, (6, 1), dropout_rate=0.5, device="cpu")
        with torch.no_grad():
            self.mlp[0].w.fill_(1.0)
        self.masks = []

    def loss(self, batch, tables=None, generator=None):
        h = self.mlp(batch["x"], train=True, generator=generator, layers=1)
        self.masks.append((h != 0).detach().numpy().copy())
        total = h.sum() * 0.0          # the weights stay, the units > 0
        return total, {"loss": total}


probe = Probe()
step, init = par.make_parallel_train_step(probe, sgd, mesh, rules=())
_, st, _ = init()
gen = torch.Generator().manual_seed(inp["probe_seed"])
for _ in range(2):
    st, _, _ = step(st, {"x": torch.ones(inp["probe_rows"], 4)}, gen)
out["probe_masks"] = probe.masks

pickle.dump(out, open(os.path.join(os.environ["CASES_OUT"],
                                   f"out-{dist.get_rank()}.pkl"), "wb"))
'''


def _sgd():
    return GradientTransformation(
        lambda params, device=None: {},
        lambda g, s, p=None: ({k: -LR * v for k, v in g.items()}, s))


def _flat(tree):
    return convert.flatten_tree(jax.tree.map(np.array, tree))


def _batches(kind, seed):
    """STEPS global batches of `kind`; negatives apart from positives."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(STEPS):
        users = rng.integers(0, USERS, B).astype(np.int32)
        if kind in ("pointwise", "rating"):
            label = (rng.uniform(0, 1, B) if kind == "rating"
                     else rng.random(B) < 0.3).astype(np.float32)
            out.append({"user_id": users, "label": label,
                        "item_id": rng.integers(0, ITEMS, B).astype(
                            np.int32)})
        elif kind in ("pairwise", "npairwise"):
            p = rng.integers(0, ITEMS, B)
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
            out.append({"seq_item_id": seq, "seq_len": seq_len,
                        "label": rng.integers(0, ITEMS, B).astype(np.int32),
                        "user_gender": rng.integers(0, 3, B).astype(
                            np.int32),
                        "user_geo": rng.integers(0, 10, B).astype(np.int32)})
    return out


def _jax_model(cls, widths, kw):
    if cls == "ItrMLP":
        return JItrMLP(USERS, ITEMS, *widths, **kw)
    if cls == "RNNRec":
        return JRNNRec(**kw)
    if cls == "VanillaYouTubeRec":
        return JVanillaYouTubeRec(**kw)
    if cls in ("VisualCML", "CDL"):
        kw = dict(kw, item_features=FEATS if cls == "VisualCML"
                  else CDL_FEATS)
    return getattr(jmodels, cls)(USERS, ITEMS, *widths, **kw)


def _port_args(cls, widths, kw):
    """(positional widths, keyword arguments) of the port's constructor."""
    if cls in ("RNNRec", "VanillaYouTubeRec", "YouTubeRec"):
        return widths, kw
    if cls == "VisualCML":
        kw = dict(kw, item_features=FEATS)
    if cls == "CDL":
        return (USERS, ITEMS) + widths + (CDL_FEATS,), kw
    return (USERS, ITEMS) + widths, kw


def _jax_params(jmodel, seed=0):
    """The model's init with its tables widened (batch norms and scores far
    from flat) and nonzero biases."""
    params = jax.tree.map(np.asarray, jmodel.init(jax.random.PRNGKey(seed)))
    rng = np.random.default_rng(seed + 100)
    for key in ("user_embed", "item_embed"):
        if key in params:
            params[key] = params[key] * 30.0
    for key in ("item_bias", "out_bias"):
        if key in params:
            params[key] = rng.normal(scale=0.1, size=params[key].shape
                                     ).astype(np.float32)
    return params


def _temporal_raw(seed=1, n=600):
    rng = np.random.default_rng(seed)
    raw = np.zeros(n, dtype=[("user_id", np.int32), ("item_id", np.int32),
                             ("ts", np.int64)])
    raw["user_id"] = rng.integers(0, USERS, n)
    raw["item_id"] = rng.integers(0, ITEMS, n)
    raw["ts"] = rng.integers(0, 500, n)
    return raw


def _d1_reference(c, model):
    """The flat Trainer's (or flat sparse step's) losses and parameters on
    the global batches, its generator seeded as the mesh's shared one;
    for a device-sampled case the global batch is the data ranks' slices
    concatenated, each drawn from fold_in(seed, data rank)."""
    sparse = c["how"] == "device_sparse"
    if sparse:
        init, step = tsparse.make_sparse_train_step(model, c["specs"],
                                                    learning_rate=LR)
        st, gen = init(model.params()), torch.Generator().manual_seed(
            c["seed"])
    else:
        tr = Trainer(model, optimizer=_sgd(), seed=c["seed"], device="cpu")
    batches = c["batches"]
    if batches is None:
        if sparse:
            sampler = DevicePointwiseSampler(
                InteractionStore(c["raw"], USERS, ITEMS), c["slice"],
                device="cpu")
        else:
            sampler = DeviceTemporalSampler(
                InteractionStore(c["raw"], USERS, ITEMS, sortby="ts"),
                c["slice"], L, device="cpu")
        gens = [torch.Generator().manual_seed(fold_in(c["sample_seed"], r))
                for r in range(2)]
        batches = []
        for _ in range(c["steps"]):
            parts = [sampler.sample(g) for g in gens]
            assert not all(torch.equal(parts[0][k], parts[1][k])
                           for k in parts[0])
            batches.append({k: torch.cat([p[k] for p in parts])
                            for k in parts[0]})
    losses = []
    for b in batches:
        if sparse:
            st, loss = step(st, b, gen)
        else:
            loss = tr.train_step(b)[0]
        losses.append(float(loss))
    return losses, {k: v.detach().numpy().copy()
                    for k, v in model.params().items()}


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """(inputs, JAX and d = 1 references, per-rank outputs) of one launch of
    4 gloo ranks."""
    tmp = tmp_path_factory.mktemp("dp_models")
    inp = {"lr": LR, "jax": {}, "d1": {}, "probe_seed": 3, "probe_rows": 8}
    ref = {}
    mesh = make_mesh(data=2, model=2, devices=jax.devices()[:4])
    for i, (name, (cls, widths, kw, kind)) in enumerate(JAX_CASES.items()):
        jmodel = _jax_model(cls, widths, kw)
        params = _jax_params(jmodel)
        batches = _batches(kind, seed=20 + i)
        pwidths, pkw = _port_args(cls, widths, kw)
        inp["jax"][name] = dict(cls=cls, widths=pwidths, kw=pkw,
                                params=_flat(params), batches=batches)
        tx = optax.sgd(LR)
        step_fn, _ = make_parallel_train_step(jmodel, tx, mesh)
        placed, _ = shard_params(params, mesh)
        opt_state = tx.init(placed)
        losses, auxes = [], []
        for b in batches:
            placed, opt_state, loss, aux = step_fn(
                placed, opt_state, to_device(b, batch_sharding(mesh)),
                jax.random.PRNGKey(1))
            losses.append(float(loss))
            auxes.append({k: float(v) for k, v in aux.items()})
        ref["jax_" + name] = (losses, auxes, _flat(placed))

    raw = _temporal_raw()
    for i, (name, (cls, widths, kw, kind, rules, how)) in enumerate(
            D1_CASES.items()):
        pwidths, pkw = _port_args(cls, widths, kw)
        model = getattr(models, cls)(
            *pwidths, device="cpu", generator=torch.Generator().manual_seed(i),
            **pkw)
        params = {k: v.detach().numpy().copy()
                  for k, v in model.params().items()}
        c = dict(cls=cls, widths=pwidths, kw=pkw, params=params,
                 rules=rules, how=how, seed=LOSS_SEED + i, steps=STEPS,
                 batches=None if kind == "device" else _batches(kind, 40 + i),
                 raw=raw, users=USERS, items=ITEMS, slice=B // 2, L=L,
                 specs=SPARSE_SPECS,
                 sample_seed=LOSS_SEED + i if how == "device_trainer"
                 else SAMPLE_SEED)
        inp["d1"][name] = c
        ref["d1_" + name] = _d1_reference(c, model)

    path = tmp / "in.pkl"
    with open(path, "wb") as f:
        pickle.dump(inp, f)
    spawn_local(WORKER, WORLD, timeout=180,
                env={"PYTHONPATH": REPO, "CASES_IN": str(path),
                     "CASES_OUT": str(tmp)})
    outs = []
    for r in range(WORLD):
        with open(tmp / f"out-{r}.pkl", "rb") as f:
            outs.append(pickle.load(f))
    return inp, ref, outs


def _params_close(got, want):
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=RTOL, atol=ATOL,
                                   err_msg=k)


@pytest.mark.parametrize("name", list(JAX_CASES))
def test_dp_step_matches_jax_global_batch(run, name):
    """Two SGD steps at two data ranks, every table row-sharded over two
    model ranks under the default rules, as in JAX: the loss, aux and
    parameters of JAX's GSPMD step over the global batch. ItrMLP's batch
    norm takes the global batch's mean and variance and reads its tables
    through their views; UCML / WCML / VisualCML censor the global batch's
    rows in each shard after the all_reduce; RNNRec's full softmax runs
    vocabulary-parallel over its sharded out_weight / out_bias; the
    YouTube model looks its items up in the sharded table."""
    _, ref, outs = run
    want_losses, want_aux, want_params = ref["jax_" + name]
    for o in outs:
        losses, auxes, params = o["jax_" + name]
        np.testing.assert_allclose(losses, want_losses, rtol=RTOL)
        for got, want in zip(auxes, want_aux):
            assert set(got) == set(want)
            for k in want:
                np.testing.assert_allclose(got[k], want[k], rtol=RTOL,
                                           atol=1e-7, err_msg=k)
        _params_close(params, want_params)


@pytest.mark.parametrize("name", list(D1_CASES))
def test_dp_step_matches_one_data_rank(run, name):
    """Two SGD steps at two data ranks against the flat Trainer on the
    global batch from the same init and loss seed: dropout masks, the
    SDAE's corruption and the sampled softmax's candidates are the draws
    one rank makes for the whole batch. Device-sampled: each data rank
    samples its slice from fold_in(seed, rank), the loss draws from the
    shared generator, through `make_parallel_device_train_step` and
    through ParallelTrainer, and NeuMF's through
    `make_parallel_device_sparse_train_step` (its tables' Adam rows, the
    flat sparse step's)."""
    _, ref, outs = run
    want_losses, want_params = ref["d1_" + name]
    for o in outs:
        losses, params = o["d1_" + name]
        np.testing.assert_allclose(losses, want_losses, rtol=RTOL)
        _params_close(params, want_params)


def test_data_slices_draw_their_part_of_the_global_mask(run):
    """Each data slice's dropout mask is its rows of the mask one rank
    draws over the global batch from the same seed, so the two slices'
    masks differ (drawn with the slice's shape from a generator seeded
    alike on every rank, they would be one mask repeated)."""
    inp, _, outs = run
    rows = inp["probe_rows"]
    gen = torch.Generator().manual_seed(inp["probe_seed"])
    for step in range(2):
        want = (torch.rand((rows, 6), generator=gen) < 0.5).numpy()
        slices = [outs[r]["probe_masks"][step] for r in (0, 2)]
        assert not np.array_equal(slices[0], slices[1])
        np.testing.assert_array_equal(np.concatenate(slices), want)
        for r in (1, 3):        # the model ranks of a data slice agree
            np.testing.assert_array_equal(outs[r]["probe_masks"][step],
                                          slices[r // 2])


def test_batch_norm_outside_the_context_is_the_old_formula():
    """Outside a data-parallel step the batch norm's statistics are
    torch.mean and the biased torch.var, bit for bit, forward and
    backward."""
    rng = np.random.default_rng(0)
    x = torch.tensor(rng.normal(size=(33, 7)).astype(np.float32) * 5 + 2,
                     requires_grad=True)
    mlp = MLP(7, (5, 3), batch_norm=True, device="cpu",
              generator=torch.Generator().manual_seed(0))
    got = mlp(x)
    (gx,) = torch.autograd.grad(got.sum(), [x])

    def old(x):
        for i, layer in enumerate(mlp):
            x = x @ layer.w + layer.b
            mean = torch.mean(x, dim=0, keepdim=True)
            var = torch.var(x, dim=0, keepdim=True, correction=0)
            x = (x - mean) * torch.rsqrt(var + 1e-5)
            x = torch.relu(x * layer.bn_scale + layer.bn_bias) \
                if i < len(mlp) - 1 else x * layer.bn_scale + layer.bn_bias
        return x
    want = old(x)
    (wx,) = torch.autograd.grad(want.sum(), [x])
    assert torch.equal(got, want) and torch.equal(gx, wx)
    m, v = global_batch.batch_moments(x.detach())
    assert torch.equal(m, torch.mean(x.detach(), dim=0, keepdim=True))
    assert torch.equal(v, torch.var(x.detach(), dim=0, keepdim=True,
                                    correction=0))


def test_global_batch_context_rows_and_statistics():
    """In one process, a context of d slices with the identity as its sum:
    `rand` returns this slice's rows of the global draw (the generator
    advancing as for the global draw) and refuses a tensor whose leading
    dim is not the slice; `batch_moments` divides the summed statistics
    by the global batch; leaving the context restores the local draws."""
    g1 = torch.Generator().manual_seed(4)
    g2 = torch.Generator().manual_seed(4)
    full = torch.rand((12, 3), generator=g1)
    with global_batch.data_parallel(3, 1, 12, lambda t: t):
        part = global_batch.rand((4, 3), g2)
        with pytest.raises(ValueError, match="rows"):
            global_batch.rand((12, 3), g2)
        x = torch.arange(12.0).reshape(4, 3)
        m, v = global_batch.batch_moments(x)
    assert torch.equal(part, full[4:8])
    assert torch.equal(g1.get_state(), g2.get_state())
    torch.testing.assert_close(m, x.sum(0, keepdim=True) / 12)
    torch.testing.assert_close(v, ((x - m) ** 2).sum(0, keepdim=True) / 12)
    assert global_batch.rand((4, 3), g2).shape == (4, 3)   # context left
