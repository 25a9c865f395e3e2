"""Port parity, the distribution layer on a gloo mesh of 8 CPU ranks:
sharded lookup (values, zero rows outside, gradients), sharded scores /
top-k / `sharded_pallas_topk` in the exact and the collision regime,
the data-parallel dense step (BPR, with and without L2; ItrMLP's batch
norm over the global batch), the model-parallel DLRM step, the parallel
eval step, the parallel sparse step in every dedup mode, the
device-sampled builders, the sharded eval metrics and the 8-rank dry
run; against the JAX package on its 8 virtual
CPU devices with the same mesh shape (tests/test_parallel.py,
tests/test_catalog_scale_eval.py:79-110).

The ranks are processes of `python -c WORKER` (`parallel.launch`, one
launch for every case, under its own timeout); WORKER never imports
JAX. Bars: lookups exact; scores rtol 1e-5 and ids equal but where two
picks score within 1e-5; steps rtol 1e-4, atol 1e-6 (JAX's own); the
dedup modes bit-identical to one another on the mesh; metrics rtol 1e-5,
atol 1e-6.
"""

import os
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from openrec_tpu.data.pipeline import to_device
from openrec_tpu import models as jmodels
from openrec_tpu.models import BPR as JBPR
from openrec_tpu.models import DLRM as JDLRM
from openrec_tpu.parallel import (
    batch_sharding, make_mesh, make_parallel_eval_step,
    make_parallel_sparse_train_step, make_parallel_train_step, pad_rows,
    sharded_dot_eval_metrics, sharded_eval_metrics, sharded_lookup,
    sharded_pallas_topk, sharded_scores, sharded_topk)
from openrec_tpu.parallel.mesh import row_sharding, shard_params
from openrec_tpu.training import sparse as jsparse
from openrec_tpu.training.optim import lazy_adam
from openrec_tpu_torch import convert
from openrec_tpu_torch.parallel.launch import spawn_local
from tests.conftest import make_interactions

pytestmark = pytest.mark.skipif(len(jax.devices()) < 8,
                                reason="needs 8 virtual devices")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLD = 8
DLRM_KW = dict(m_spa=8, ln_emb=(64, 128, 32), ln_bot=(8, 8), ln_top=(16, 1),
               dim_dense=3, loss_func="bce")
MODES = ("flat", "columns", "mixed", "hash")
# data-parallel steps of losses that are not a batch mean plus the L2 of
# the batch's rows: name -> (positional widths, keyword arguments)
DP_MODELS = {
    "GMF": ((8, 8), dict(l2_weight=0.1)),             # + its MLP's L2
    "NeuMF": ((8, 6), dict(mlp_units=(16, 8, 1), alpha=0.4,
                           l2_weight=0.1)),           # BCE summed
    "PMF": ((8, 8), dict(l2_reg=0.1)),                # squares summed
    "VisualGMF": ((8,), dict(mlp_units=(10,),
                             l2_weight=0.1)),         # + grad_transform
}
DP_LR = 0.1

WORKER = r'''
import os, pickle
import numpy as np
import torch
torch.set_num_threads(1)
import torch.distributed as dist
from openrec_tpu_torch import convert
from openrec_tpu_torch import parallel as par
from openrec_tpu_torch.data import DevicePairwiseSampler, InteractionStore
from openrec_tpu_torch.models import BPR, DLRM
from openrec_tpu_torch.parallel import train as ptrain
from openrec_tpu_torch.training import sparse as tsparse
from openrec_tpu_torch.training.optim import lazy_adam

inp = pickle.load(open(os.environ["CASES_IN"], "rb"))
out = {}
T = torch.as_tensor


def mesh_of(d, m):
    return par.make_mesh(d, m, device="cpu")


def shard_of(full, mesh):
    m = par.mesh.axis_size(mesh, "model")
    j = par.mesh.axis_index(mesh, "model")
    n = full.shape[0] // m
    return T(full[j * n:(j + 1) * n]).clone()


def gathered(model, shardings, mesh):
    with par.full_params(model, shardings, mesh):
        return {k: v.detach().numpy().copy()
                for k, v in model.params().items()}


def batch_t(b):
    return {k: T(v) for k, v in b.items()}


# A: lookup values, zero rows outside, gradients (2 x 4)
mesh = mesh_of(2, 4)
c = inp["lookup"]
shard = shard_of(c["table"], mesh)
out["lookup"] = par.sharded_lookup(shard, T(c["ids"]), mesh).numpy()
out["lookup_outside"] = par.sharded_lookup(shard, T(c["outside"]),
                                           mesh).numpy()
g = shard_of(c["gtable"], mesh).requires_grad_()
(par.sharded_lookup(g, T(c["gids"]), mesh) ** 2).sum().backward()
out["lookup_grad"] = g.grad.numpy()
view = par.ShardedTable(shard, mesh, c["table"].shape[0])
out["view_shape"] = tuple(view.shape)

# B: scores and top-k (1 x 8)
mesh = mesh_of(1, 8)
c = inp["topk"]
scores = par.sharded_scores(T(c["U"]), shard_of(c["V"], mesh),
                            shard_of(c["b"], mesh), mesh)
out["scores"] = scores.numpy()
out["topk"] = [t.numpy() for t in par.sharded_topk(scores, 10, mesh)]
out["topk_approx"] = [t.numpy() for t in par.sharded_topk(
    scores, 10, mesh, approx=True)]

# C: sharded_pallas_topk, exact and collision regimes (1 x 8)
c = inp["pallas"]
out["pallas_exact"] = [t.numpy() for t in par.sharded_pallas_topk(
    T(c["U"]), shard_of(c["V"], mesh), shard_of(c["b"], mesh), 10, mesh)]
for pb in (1, 2):
    out[f"pallas_coll{pb}"] = [t.numpy() for t in par.sharded_pallas_topk(
        T(c["U2"]), shard_of(c["V2"], mesh), None, 10, mesh,
        per_bucket=pb)]

# D: data-parallel BPR step, fully replicated (8 x 1)
mesh = mesh_of(8, 1)
for l2 in (0.0, 0.1):
    c = inp[f"dp{l2}"]
    model = BPR(32, 64, 8, 8, l2_weight=l2, device="cpu")
    model.load_params(c["params"])
    step, init = par.make_parallel_train_step(model, lazy_adam(0.01), mesh,
                                              rules=())
    _, st, sh = init()
    st, loss, aux = step(st, batch_t(c["batch"]))
    out[f"dp{l2}"] = (float(loss), {k: v.detach().numpy().copy()
                                    for k, v in model.params().items()},
                      {k: float(v) for k, v in aux.items()})

# D2: SGD steps (whose size is the gradient's, which Adam's is not) of
# the DP_MODELS, tables row-sharded (2 x 4), and of ItrMLP, whose batch
# norm takes the global batch's statistics
from openrec_tpu_torch import models as tmodels
from openrec_tpu_torch.training.optim import GradientTransformation
sgd = GradientTransformation(
    lambda params, device=None: {},
    lambda g, s, p=None: ({k: -inp["dp_lr"] * v for k, v in g.items()}, s))
mesh = mesh_of(2, 4)
for name, (widths, kw) in inp["dp_models"].items():
    c = inp[f"dp_{name}"]
    if name == "VisualGMF":
        kw = dict(kw, item_features=c["features"])
    model = getattr(tmodels, name)(32, 64, *widths, device="cpu", **kw)
    model.load_params(c["params"])
    step, init = par.make_parallel_train_step(model, sgd, mesh)
    _, st, sh = init()
    for i in range(2):
        st, loss, aux = step(st, batch_t(c["batch"]))
    out[f"dp_{name}"] = (float(loss), gathered(model, sh, mesh),
                         {k: float(v) for k, v in aux.items()})
c = inp["dp_itr"]
model = tmodels.ItrMLP(32, 64, 8, **c["kw"], device="cpu")
model.load_params(c["params"])
step, init = par.make_parallel_train_step(model, sgd, mesh, rules=())
_, st, sh = init()
for i in range(2):
    st, loss, aux = step(st, batch_t(c["batch"]))
out["dp_itr"] = (float(loss), gathered(model, sh, mesh),
                 {k: float(v) for k, v in aux.items()})

# E: model-parallel DLRM step, tables row-sharded (4 x 2)
mesh = mesh_of(4, 2)
c = inp["mp"]
model = DLRM(**c["kw"], device="cpu")
model.load_params(c["params"])
step, init = par.make_parallel_train_step(model, lazy_adam(1e-3), mesh)
_, st, sh = init()
out["mp_local_rows"] = model.params()["embed_tables/2"].shape[0]
losses = []
for i in range(3):
    st, loss, _ = step(st, batch_t(c["batch"]))
    losses.append(float(loss))
out["mp"] = (losses, gathered(model, sh, mesh))

# F: parallel eval step (8 x 1)
mesh = mesh_of(8, 1)
c = inp["eval"]
model = BPR(32, 64, 8, 8, device="cpu")
model.load_params(c["params"])
ev = par.make_parallel_eval_step(model, mesh, at=(10,))
out["eval"] = {k: v.numpy() for k, v in ev(
    T(c["user_id"]), T(c["pos"]), T(c["excl"])).items()}

# G: parallel sparse step, every dedup mode (4 x 2)
mesh = mesh_of(4, 2)
c = inp["sparse"]
for mode in c["modes"]:
    model = DLRM(**c["kw"], device="cpu")
    model.load_params(c["params"])
    step, init = par.make_parallel_sparse_train_step(
        model, tsparse.dlrm_fused_table_spec(model, mode=mode), mesh,
        learning_rate=0.01)
    _, st, sh = init()
    assert model.embed_fused.shape[0] * 2 == 224
    losses = []
    for i in range(3):
        st, loss = step(st, batch_t(c["batch"]))
        losses.append(float(loss))
    out[f"sparse_{mode}"] = (losses, gathered(model, sh, mesh))

# G2: JAX's parallel sparse state, carried in mid-trajectory (4 x 2)
c = inp["carry"]
model = DLRM(**inp["sparse"]["kw"], device="cpu")
step, init = par.make_parallel_sparse_train_step(
    model, tsparse.dlrm_fused_table_spec(model), mesh, learning_rate=0.01)
_, st, sh = init()
local, _ = convert.shard_params_from_jax(c["params"], mesh, device="cpu")
model.load_params(local)
st = convert.shard_opt_state_from_jax(c["state"], sh, sparse=True,
                                      device="cpu")
out["carry_rows"] = st["sparse"].mu[("embed_fused",)].shape[0]
losses = []
for i in range(2):
    st, loss = step(st, batch_t(c["batch"]))
    losses.append(float(loss))
out["carry"] = (losses, gathered(model, sh, mesh))

# H: device-sampled builders (2 x 4)
mesh = mesh_of(2, 4)
c = inp["device"]
store = InteractionStore(c["raw"], 24, 64, seed=0)
sampler = DevicePairwiseSampler(store, batch_size=8, device="cpu")
specs = {"user_embed": ["user_id"], "item_embed": ["p_item_id", "n_item_id"],
         "item_bias": ["p_item_id", "n_item_id"]}
for kind in ("sparse", "dense"):
    model = BPR(24, 64, 8, 8, l2_weight=0.0, device="cpu")
    model.load_params(c["params"])
    if kind == "sparse":
        step, init = par.make_parallel_device_sparse_train_step(
            model, specs, mesh, sampler, steps_per_call=2,
            learning_rate=0.01)
    else:
        step, init = par.make_parallel_device_train_step(
            model, lazy_adam(0.01), mesh, sampler, steps_per_call=2)
    _, st, sh = init()
    gen = par.rank_generator(5, mesh)
    st, losses = step(st, gen)
    out[f"device_{kind}"] = (losses.numpy(), gathered(model, sh, mesh))
out["device_seed"] = par.fold_in(5, par.mesh.axis_index(mesh, "data"))

# I: sharded eval metrics (1 x 8 dot; 2 x 4 from sharded scores)
c = inp["seval"]
mesh = mesh_of(1, 8)
out["seval_dot"] = {k: v.numpy() for k, v in par.sharded_dot_eval_metrics(
    T(c["U"]), shard_of(c["V8"], mesh), shard_of(c["b8"], mesh),
    T(c["pos"]), T(c["excl"]), total_items=c["I"], mesh=mesh,
    at=c["at"]).items()}
out["seval_dup"] = {k: v.numpy() for k, v in par.sharded_dot_eval_metrics(
    T(c["U"]), shard_of(c["V8"], mesh), shard_of(c["b8"], mesh),
    T(c["pos_dup"]), T(c["excl"]), total_items=c["I"], mesh=mesh,
    at=c["at"]).items()}
mesh = mesh_of(2, 4)
i = par.mesh.axis_index(mesh, "data")
users = slice(i * 4, (i + 1) * 4)
scores = par.sharded_scores(T(c["U"][users]), shard_of(c["V4"], mesh),
                            shard_of(c["b4"], mesh), mesh)
out["seval_scores"] = {k: v.numpy() for k, v in par.sharded_eval_metrics(
    scores, T(c["pos"][users]), T(c["excl"][users]), total_items=c["I"],
    mesh=mesh, at=c["at"]).items()}

pickle.dump(out, open(os.path.join(os.environ["CASES_OUT"],
                                   f"out-{dist.get_rank()}.pkl"), "wb"))
'''


def _np(tree):
    return jax.tree.map(np.array, tree)


def _flat(tree):
    return convert.flatten_tree(_np(tree))


def _dlrm_batch(seed, B=32, counts=(64, 128, 32)):
    rng = np.random.default_rng(seed)
    return {"dense_features": rng.normal(size=(B, 3)).astype(np.float32),
            "sparse_features": np.stack([rng.integers(0, c, B)
                                         for c in counts],
                                        axis=1).astype(np.int32),
            "label": rng.integers(0, 2, B).astype(np.float32)}


def _bpr_batch(seed, users=32, items=64, B=64):
    rng = np.random.default_rng(seed)
    return {"user_id": rng.integers(0, users, B).astype(np.int32),
            "p_item_id": rng.integers(0, items, B).astype(np.int32),
            "n_item_id": rng.integers(0, items, B).astype(np.int32)}


def _eval_case(seed=2, B=8, I=300, D=16, P=5, E=4):
    rng = np.random.default_rng(seed)
    U = rng.normal(size=(B, D)).astype(np.float32)
    V = rng.normal(size=(I, D)).astype(np.float32)
    b = rng.normal(size=(I,)).astype(np.float32)
    pos = np.full((B, P), -1, np.int32)
    excl = np.full((B, E), -1, np.int32)
    for r in range(B):
        picks = rng.choice(I, size=P + E, replace=False)
        n_pos = rng.integers(1, P + 1)
        pos[r, :n_pos] = picks[:n_pos]
        n_excl = rng.integers(0, E + 1)
        excl[r, :n_excl] = picks[P:P + n_excl]
    excl[0, -1] = pos[0, 0]
    return U, V, b, pos, excl


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """(inputs, JAX references, per-rank outputs) of one 8-rank launch."""
    tmp = tmp_path_factory.mktemp("parallel")
    inp, ref = {}, {}
    rng = np.random.default_rng(0)

    # A: lookup (JAX test_parallel.py:23-52)
    mesh = make_mesh(data=2, model=4)
    table = rng.normal(size=(pad_rows(100, 4), 8)).astype(np.float32)
    ids = rng.integers(0, 100, 16).astype(np.int32)
    outside = np.array([-1, 100, 5, 99], np.int32)
    gtable = np.random.default_rng(1).normal(size=(64, 4)).astype(
        np.float32)
    gids = np.array([3, 3, 10, 63], np.int32)
    inp["lookup"] = dict(table=table, ids=ids, outside=outside,
                         gtable=gtable, gids=gids)
    placed = jax.device_put(table, row_sharding(mesh))
    ref["lookup"] = np.asarray(sharded_lookup(placed, jnp.asarray(ids),
                                              mesh))
    ref["lookup_outside"] = np.asarray(sharded_lookup(
        placed, jnp.asarray(outside), mesh))
    ref["lookup_grad"] = np.asarray(jax.grad(
        lambda t: jnp.sum(sharded_lookup(t, jnp.asarray(gids), mesh) ** 2))(
        jax.device_put(gtable, row_sharding(mesh))))

    # B, C: scores / top-k / pallas (:55-143)
    mesh = make_mesh(data=1, model=8)
    rng = np.random.default_rng(2)
    I = pad_rows(200, 8)
    V = rng.normal(size=(I, 16)).astype(np.float32)
    b = rng.normal(size=(I, 1)).astype(np.float32)
    U = rng.normal(size=(8, 16)).astype(np.float32)
    inp["topk"] = dict(U=U, V=V, b=b)
    Vd = jax.device_put(V, row_sharding(mesh))
    bd = jax.device_put(b, row_sharding(mesh))
    scores = sharded_scores(jnp.asarray(U), Vd, bd, mesh)
    ref["scores"] = np.asarray(scores)
    ref["topk"] = [np.asarray(t) for t in sharded_topk(scores, 10, mesh)]
    ref["topk_approx"] = [np.asarray(t) for t in sharded_topk(
        scores, 10, mesh, approx=True)]
    rng = np.random.default_rng(7)
    Vp = rng.normal(size=(I, 16)).astype(np.float32)
    bp = rng.normal(size=(I, 1)).astype(np.float32)
    Up = rng.normal(size=(8, 16)).astype(np.float32)
    V2 = rng.normal(size=(8 * 2048, 16)).astype(np.float32)
    U2 = rng.normal(size=(8, 16)).astype(np.float32)
    inp["pallas"] = dict(U=Up, V=Vp, b=bp, U2=U2, V2=V2)
    ref["pallas_exact"] = [np.asarray(t) for t in sharded_pallas_topk(
        jnp.asarray(Up), jax.device_put(Vp, row_sharding(mesh)),
        jax.device_put(bp, row_sharding(mesh)), 10, mesh)]
    for pb in (1, 2):
        ref[f"pallas_coll{pb}"] = [np.asarray(t) for t in
                                   sharded_pallas_topk(
            jnp.asarray(U2), jax.device_put(V2, row_sharding(mesh)), None,
            10, mesh, per_bucket=pb)]

    # D: data-parallel BPR step (:145-180), with and without L2
    mesh = make_mesh(data=8, model=1)
    batch = _bpr_batch(3)
    for l2 in (0.0, 0.1):
        model = JBPR(total_users=32, total_items=64, dim_user_embed=8,
                     dim_item_embed=8, l2_weight=l2)
        step_fn, init_fn = make_parallel_train_step(model, lazy_adam(0.01),
                                                    mesh, rules=())
        params, opt_state, _ = init_fn(jax.random.PRNGKey(0))
        inp[f"dp{l2}"] = dict(params=_flat(params), batch=batch)
        params, _, loss, aux = step_fn(params, opt_state,
                                       to_device(batch, batch_sharding(mesh)),
                                       jax.random.PRNGKey(1))
        ref[f"dp{l2}"] = (float(loss), _flat(params),
                          {k: float(v) for k, v in aux.items()})

    # D2: SGD steps of the DP_MODELS on a 2 x 4 mesh
    mesh = make_mesh(data=2, model=4)
    rng = np.random.default_rng(8)
    batch = {"user_id": rng.integers(0, 32, 32).astype(np.int32),
             "item_id": rng.integers(0, 64, 32).astype(np.int32),
             "label": (rng.random(32) < 0.3).astype(np.float32)}
    feats = np.maximum(rng.normal(size=(64, 12)), 0.0).astype(np.float32)
    inp["dp_models"], inp["dp_lr"] = DP_MODELS, DP_LR
    for name, (widths, kw) in DP_MODELS.items():
        if name == "VisualGMF":
            kw = dict(kw, item_features=feats)
        model = getattr(jmodels, name)(32, 64, *widths, **kw)
        step_fn, init_fn = make_parallel_train_step(model, optax.sgd(DP_LR),
                                                    mesh)
        params, opt_state, _ = init_fn(jax.random.PRNGKey(0))
        inp[f"dp_{name}"] = dict(params=_flat(params), batch=batch,
                                 features=feats)
        for i in range(2):
            params, opt_state, loss, aux = step_fn(
                params, opt_state, to_device(batch, batch_sharding(mesh)),
                jax.random.PRNGKey(1))
        ref[f"dp_{name}"] = (float(loss), _flat(params),
                             {k: float(v) for k, v in aux.items()})
    # ItrMLP: its tables widened from 0.01 and a nonzero item bias, so that
    # the batch norms are far from flat
    kw = dict(user_dims=(10, 8), item_dims=(12, 8))
    model = jmodels.ItrMLP(32, 64, 8, **kw)
    params = _np(model.init(jax.random.PRNGKey(0)))
    params["user_embed"] = params["user_embed"] * 30.0
    params["item_embed"] = params["item_embed"] * 30.0
    params["item_bias"] = rng.normal(scale=0.3, size=(64, 1)).astype(
        np.float32)
    inp["dp_itr"] = dict(kw=kw, params=_flat(params), batch=batch)
    tx = optax.sgd(DP_LR)
    step_fn, _ = make_parallel_train_step(model, tx, mesh)
    params, _ = shard_params(params, mesh)
    opt_state = tx.init(params)
    for i in range(2):
        params, opt_state, loss, aux = step_fn(
            params, opt_state, to_device(batch, batch_sharding(mesh)),
            jax.random.PRNGKey(1))
    ref["dp_itr"] = (float(loss), _flat(params),
                     {k: float(v) for k, v in aux.items()})

    # E: model-parallel DLRM step (:183-207)
    mesh = make_mesh(data=4, model=2)
    kw = dict(DLRM_KW, ln_emb=(64, 64, 256), dim_dense=4)
    model = JDLRM(**kw)
    step_fn, init_fn = make_parallel_train_step(model, lazy_adam(1e-3), mesh)
    params, opt_state, _ = init_fn(jax.random.PRNGKey(0))
    rng = np.random.default_rng(4)
    batch = {"dense_features": rng.normal(size=(32, 4)).astype(np.float32),
             "sparse_features": np.stack([rng.integers(0, n, 32)
                                          for n in (64, 64, 256)],
                                         axis=1).astype(np.int32),
             "label": rng.integers(0, 2, 32).astype(np.float32)}
    inp["mp"] = dict(kw=kw, params=_flat(params), batch=batch)
    losses = []
    for i in range(3):
        params, opt_state, loss, _ = step_fn(
            params, opt_state, to_device(batch, batch_sharding(mesh)),
            jax.random.PRNGKey(i))
        losses.append(float(loss))
    ref["mp"] = (losses, _flat(params))

    # F: parallel eval step (:210-224)
    mesh = make_mesh(data=8, model=1)
    model = JBPR(total_users=32, total_items=64, dim_user_embed=8,
                 dim_item_embed=8)
    params = model.init(jax.random.PRNGKey(0))
    rng = np.random.default_rng(5)
    e = dict(user_id=rng.integers(0, 32, 16).astype(np.int32),
             pos=rng.random((16, 64)) < 0.1, excl=rng.random((16, 64)) < 0.05)
    inp["eval"] = dict(e, params=_flat(params))
    ev = make_parallel_eval_step(model, mesh, at=(10,))
    ref["eval"] = {k: np.asarray(v) for k, v in ev(
        params, jnp.asarray(e["user_id"]), jnp.asarray(e["pos"]),
        jnp.asarray(e["excl"])).items()}

    # G: parallel sparse step (:227-272)
    mesh = make_mesh(data=4, model=2)
    kw = dict(DLRM_KW, fused_tables=True)
    model = JDLRM(**kw)
    step_fn, init_fn = make_parallel_sparse_train_step(
        model, jsparse.dlrm_fused_table_spec(model), mesh,
        learning_rate=0.01)
    params, opt_state, _ = init_fn(jax.random.PRNGKey(0))
    batch = _dlrm_batch(0)
    inp["sparse"] = dict(kw=kw, params=_flat(params), batch=batch,
                         modes=MODES)
    losses = []
    for i in range(3):
        params, opt_state, loss = step_fn(
            params, opt_state, to_device(batch, batch_sharding(mesh)),
            jax.random.PRNGKey(i))
        losses.append(float(loss))
    ref["sparse"] = (losses, _flat(params))
    # the JAX step's mid-trajectory state carried into the port's ranks
    from types import SimpleNamespace as NS
    st = _np(opt_state)
    sp, dn = st["sparse"], st["dense"][0]
    inp["carry"] = dict(
        params=_flat(params), batch=_dlrm_batch(1),
        state={"sparse": NS(count=sp.count, mu=dict(sp.mu), nu=dict(sp.nu)),
               "dense": (NS(count=dn.count, mu=dn.mu, nu=dn.nu), None)})
    losses = []
    for i in range(2):
        params, opt_state, loss = step_fn(
            params, opt_state,
            to_device(inp["carry"]["batch"], batch_sharding(mesh)),
            jax.random.PRNGKey(10 + i))
        losses.append(float(loss))
    ref["carry"] = (losses, _flat(params))

    # H: device-sampled builders (law; the generators differ from JAX's)
    raw = make_interactions(num_users=24, num_items=64, per_user=6, seed=9)
    bpr = JBPR(total_users=24, total_items=64, dim_user_embed=8,
               dim_item_embed=8, l2_weight=0.0)
    inp["device"] = dict(raw=raw, params=_flat(bpr.init(
        jax.random.PRNGKey(0))))

    # I: sharded eval (test_catalog_scale_eval.py:79-110)
    U, V, b, pos, excl = _eval_case()
    I8, I4 = pad_rows(300, 8), pad_rows(300, 4)
    pos_dup = pos.copy()
    pos_dup[:, -1] = pos_dup[:, 0]          # every user lists one twice
    inp["seval"] = dict(
        U=U, pos=pos, excl=excl, I=300, at=(5, 20), pos_dup=pos_dup,
        V8=np.pad(V, ((0, I8 - 300), (0, 0)), constant_values=999.0),
        b8=np.pad(b, (0, I8 - 300), constant_values=999.0),
        V4=np.pad(V, ((0, I4 - 300), (0, 0))),
        b4=np.pad(b, (0, I4 - 300))[:, None])
    mesh = make_mesh(data=1, model=8)
    for key, p in (("seval_dot", pos), ("seval_dup_jax", pos_dup)):
        ref[key] = {k: np.asarray(v) for k, v in sharded_dot_eval_metrics(
            U, jax.device_put(jnp.asarray(inp["seval"]["V8"]),
                              row_sharding(mesh)),
            jnp.asarray(inp["seval"]["b8"]), jnp.asarray(p),
            jnp.asarray(excl), total_items=300, mesh=mesh,
            at=(5, 20)).items()}
    mesh = make_mesh(data=2, model=4)
    sc = sharded_scores(
        jnp.asarray(U), jax.device_put(jnp.asarray(inp["seval"]["V4"]),
                                       row_sharding(mesh)),
        jax.device_put(jnp.asarray(inp["seval"]["b4"]), row_sharding(mesh)),
        mesh)
    ref["seval_scores"] = {k: np.asarray(v) for k, v in sharded_eval_metrics(
        sc, jnp.asarray(pos), jnp.asarray(excl), total_items=300, mesh=mesh,
        at=(5, 20)).items()}

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


def _ids_close(got, want, scores, tol=1e-5):
    """ids equal but where two picks score within tol of each other."""
    got, want = np.asarray(got, np.int64), np.asarray(want, np.int64)
    diff = got != want
    if diff.any():
        np.testing.assert_allclose(
            np.take_along_axis(scores, got, 1)[diff],
            np.take_along_axis(scores, want, 1)[diff], rtol=0, atol=tol)


def _params_close(got, want, rtol=1e-4, atol=1e-6, atol_of=None):
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=rtol,
                                   atol=(atol_of or {}).get(k, atol),
                                   err_msg=k)


# Adam's first step moves a parameter by about lr * g / (|g| + eps); a bias
# whose pos and neg terms nearly cancel has a tiny g, which the order of a
# sum changes relatively much, so the bias is held at lr * 1e-3 (JAX's own
# test holds item_embed only, tests/test_parallel.py:178)
BIAS_ATOL = {"item_bias": 1e-5}


def test_sharded_lookup(run):
    inp, ref, outs = run
    c = inp["lookup"]
    for o in outs:
        np.testing.assert_array_equal(o["lookup"], c["table"][c["ids"]])
        np.testing.assert_array_equal(o["lookup"], ref["lookup"])
        # ids outside the table give zero rows, as JAX's
        np.testing.assert_array_equal(o["lookup_outside"],
                                      ref["lookup_outside"])
        assert (o["lookup_outside"][[0, 1]] == 0).all()
        assert o["view_shape"] == (100, 8)


def test_sharded_lookup_gradients(run):
    inp, ref, outs = run
    c = inp["lookup"]
    dense = np.zeros_like(c["gtable"])
    np.add.at(dense, c["gids"], 2 * c["gtable"][c["gids"]])
    for data in range(2):
        got = np.concatenate([outs[data * 4 + j]["lookup_grad"]
                              for j in range(4)])
        np.testing.assert_allclose(got, dense, rtol=1e-6)
        np.testing.assert_allclose(got, ref["lookup_grad"], rtol=1e-6)


def test_sharded_scores_and_topk(run):
    inp, ref, outs = run
    c = inp["topk"]
    want = c["U"] @ c["V"].T + c["b"].reshape(1, -1)
    got = np.concatenate([o["scores"] for o in outs], axis=1)
    np.testing.assert_allclose(got, ref["scores"], rtol=1e-5, atol=1e-5)
    for key in ("topk", "topk_approx"):
        for o in outs:
            v, i = o[key]
            np.testing.assert_allclose(v, ref["topk"][0], rtol=1e-5)
            _ids_close(i, ref[key][1], want)
            np.testing.assert_allclose(np.take_along_axis(want, i, 1), v,
                                       rtol=1e-5, atol=1e-5)


def test_sharded_pallas_topk(run):
    """Exact regime (25 rows a shard: every item its own bucket) and the
    collision regime (2048 rows a shard) for K1 and K2, against JAX's
    interpret-mode kernels on the same mesh."""
    inp, ref, outs = run
    c = inp["pallas"]
    exact = c["U"] @ c["V"].T + c["b"].reshape(1, -1)
    dv, di = jax.lax.top_k(jnp.asarray(exact), 10)
    coll = c["U2"] @ c["V2"].T
    for o in outs:
        v, i = o["pallas_exact"]
        np.testing.assert_allclose(v, np.asarray(dv), rtol=1e-5)
        _ids_close(i, np.asarray(di), exact)
        _ids_close(i, ref["pallas_exact"][1], exact)
        for pb in (1, 2):
            v, i = o[f"pallas_coll{pb}"]
            rv, ri = ref[f"pallas_coll{pb}"]
            np.testing.assert_allclose(v, rv, rtol=1e-5, atol=1e-5)
            _ids_close(i, ri, coll)
            np.testing.assert_allclose(np.take_along_axis(coll, i, 1), v,
                                       rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("l2", [0.0, 0.1])
def test_dp_train_step_matches_jax(run, l2):
    """8 data ranks, replicated parameters: the loss of the global batch
    and the updated parameters equal JAX's parallel step; with L2 the
    summed term is not scaled by the slice's share."""
    _, ref, outs = run
    want_loss, want_params, want_aux = ref[f"dp{l2}"]
    for o in outs:
        loss, params, aux = o[f"dp{l2}"]
        np.testing.assert_allclose(loss, want_loss, rtol=1e-5)
        _params_close(params, want_params, atol_of=BIAS_ATOL)
        for k in want_aux:
            np.testing.assert_allclose(aux[k], want_aux[k], rtol=1e-5,
                                       atol=1e-7)


@pytest.mark.parametrize("name", list(DP_MODELS))
def test_dp_step_of_summed_and_batch_free_losses_matches_jax(run, name):
    """2 data x 4 model ranks, two SGD steps: NeuMF, PMF and VisualGMF sum
    their loss over the batch (a slice's part counts whole), GMF's L2
    holds its MLP's weights (independent of the batch: a slice counts its
    share), VisualGMF's grad_transform scales by the global batch. The
    parameters, the loss and aux equal JAX's parallel step."""
    _, ref, outs = run
    want_loss, want_params, want_aux = ref[f"dp_{name}"]
    for o in outs:
        loss, params, aux = o[f"dp_{name}"]
        np.testing.assert_allclose(loss, want_loss, rtol=1e-5)
        _params_close(params, want_params)
        assert set(aux) == set(want_aux)
        for k in want_aux:
            np.testing.assert_allclose(aux[k], want_aux[k], rtol=1e-5,
                                       atol=1e-7, err_msg=k)


def test_dp_step_of_a_batch_norm_model_matches_jax(run):
    """ItrMLP's MLPs normalise over the batch: at 2 data ranks (x 4 model
    ranks, replicated) the batch norm takes the global batch's mean and
    variance, so two SGD steps give JAX's loss, aux and parameters."""
    _, ref, outs = run
    want_loss, want_params, want_aux = ref["dp_itr"]
    for o in outs:
        loss, params, aux = o["dp_itr"]
        np.testing.assert_allclose(loss, want_loss, rtol=1e-5)
        _params_close(params, want_params)
        assert set(aux) == set(want_aux)
        for k in want_aux:
            np.testing.assert_allclose(aux[k], want_aux[k], rtol=1e-5,
                                       atol=1e-7, err_msg=k)


def test_model_parallel_dlrm_step_matches_jax(run):
    _, ref, outs = run
    want_losses, want_params = ref["mp"]
    for o in outs:
        assert o["mp_local_rows"] == 128          # 256 rows over 2 ranks
        np.testing.assert_allclose(o["mp"][0], want_losses, rtol=1e-5)
        _params_close(o["mp"][1], want_params)


def test_parallel_eval_step_matches_jax(run):
    _, ref, outs = run
    for o in outs:
        for k, v in ref["eval"].items():
            np.testing.assert_allclose(o["eval"][k], v, rtol=1e-5,
                                       atol=1e-6, err_msg=k)


@pytest.mark.parametrize("mode", MODES)
def test_parallel_sparse_step_matches_jax(run, mode):
    """3 steps on a 4 x 2 mesh in each dedup mode: JAX's parallel sparse
    step within rtol 1e-4, and the flat mode within rounding (on a mesh
    the data ranks' all_reduce sums a row's gradient in an order set by
    the row's place in the reduced buffer, which the modes lay out
    differently; at one rank they agree bit for bit,
    test_torch_dedup_modes.py)."""
    _, ref, outs = run
    want_losses, want_params = ref["sparse"]
    for o in outs:
        losses, params = o[f"sparse_{mode}"]
        np.testing.assert_allclose(losses, want_losses, rtol=1e-5)
        _params_close(params, want_params)
        flat_losses, flat_params = o["sparse_flat"]
        np.testing.assert_allclose(losses, flat_losses, rtol=1e-6)
        _params_close(params, flat_params, rtol=1e-5, atol=1e-7)


def test_jax_sparse_state_carries_into_the_mesh(run):
    """shard_params_from_jax / shard_opt_state_from_jax give each rank its
    rows of JAX's mid-trajectory parameters and Adam moments; two more
    steps then match JAX's."""
    _, ref, outs = run
    want_losses, want_params = ref["carry"]
    for o in outs:
        assert o["carry_rows"] == 112                  # 224 rows over 2
        np.testing.assert_allclose(o["carry"][0], want_losses, rtol=1e-5)
        _params_close(o["carry"][1], want_params)


@pytest.mark.parametrize("kind", ["sparse", "dense"])
def test_device_sampled_builders_law(run, kind):
    """Each data rank's stream is what the single-device sampler draws
    from fold_in(seed, rank), the ranks' streams differ, and the steps
    equal the single-device sparse step (or dense step) replayed on the
    concatenation of the data ranks' batches."""
    from openrec_tpu_torch.data import DevicePairwiseSampler, \
        InteractionStore
    from openrec_tpu_torch.models import BPR
    from openrec_tpu_torch.parallel import fold_in
    from openrec_tpu_torch.training import Trainer
    from openrec_tpu_torch.training import sparse as tsparse
    from openrec_tpu_torch.training.optim import lazy_adam

    inp, _, outs = run
    c = inp["device"]
    seeds = [o["device_seed"] for o in outs]
    assert seeds == [fold_in(5, 0)] * 4 + [fold_in(5, 1)] * 4
    store = InteractionStore(c["raw"], 24, 64, seed=0)
    sampler = DevicePairwiseSampler(store, batch_size=8, device="cpu")
    gens = [torch.Generator().manual_seed(fold_in(5, r)) for r in range(2)]
    model = BPR(24, 64, 8, 8, l2_weight=0.0, device="cpu")
    model.load_params(c["params"])
    specs = {"user_embed": ["user_id"],
             "item_embed": ["p_item_id", "n_item_id"],
             "item_bias": ["p_item_id", "n_item_id"]}
    if kind == "sparse":
        init, step = tsparse.make_sparse_train_step(model, specs,
                                                    learning_rate=0.01)
        st = init(model.params())
    else:
        tr = Trainer(model, optimizer=lazy_adam(0.01), device="cpu")
    losses = []
    for _ in range(2):
        parts = [sampler.sample(g) for g in gens]
        assert not all(torch.equal(parts[0][k], parts[1][k])
                       for k in parts[0])
        batch = {k: torch.cat([p[k] for p in parts]) for k in parts[0]}
        if kind == "sparse":
            st, loss = step(st, batch)
        else:
            loss, _ = tr.train_step(batch)
        losses.append(loss.item())
    want = {k: v.detach().numpy() for k, v in model.params().items()}
    for o in outs:
        got_losses, got = o[f"device_{kind}"]
        np.testing.assert_allclose(got_losses, losses, rtol=1e-5)
        _params_close(got, want, atol_of=BIAS_ATOL)


@pytest.mark.parametrize("key", ["seval_dot", "seval_scores"])
def test_sharded_eval_metrics_match_jax(run, key):
    _, ref, outs = run
    for r, o in enumerate(outs):
        want = ref[key]
        if key == "seval_scores":      # this rank's data slice of users
            i = r // 4
            want = {k: v[i * 4:(i + 1) * 4] for k, v in want.items()}
        for k, v in want.items():
            np.testing.assert_allclose(o[key][k], v, rtol=1e-5, atol=1e-6,
                                       err_msg=k)


def test_dryrun_multichip_8_ranks():
    """One DLRM step on a 4 x 2 mesh of 8 gloo ranks, asserting that every
    per-rank table, batch and moment holds 1/axis-size of the rows."""
    from openrec_tpu_torch.parallel.dryrun import dryrun_multichip
    outs = dryrun_multichip(8, device="cpu", timeout=240)
    assert len(outs) == 8
    assert all("dryrun ok" in o for o in outs)


def test_sharded_eval_counts_a_duplicated_positive_once(run):
    """A positive listed twice counts once, as in the dense path's mask
    (the metric the JAX module's docstring promises); the JAX package's
    sharded eval counts it twice, a departure this test records."""
    from openrec_tpu_torch.metrics.ranking import (ids_to_masks,
                                                   ranking_metrics)
    inp, ref, outs = run
    c = inp["seval"]
    scores = torch.as_tensor(c["U"] @ c["V8"][:c["I"]].T + c["b8"][:c["I"]])
    pm, em = ids_to_masks(torch.as_tensor(c["pos_dup"]),
                          torch.as_tensor(c["excl"]), c["I"])
    want = ranking_metrics(pm, scores, em, at=c["at"])
    for o in outs:
        for k, v in want.items():
            np.testing.assert_allclose(o["seval_dup"][k], v.numpy(),
                                       rtol=1e-5, atol=1e-6, err_msg=k)
    assert not np.allclose(ref["seval_dup_jax"]["AUC"], want["AUC"].numpy(),
                           rtol=1e-5, atol=1e-6)
