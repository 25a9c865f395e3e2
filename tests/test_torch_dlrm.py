"""Port parity, DLRM: the MLP, the dot interaction, the DLRM losses, DLRM
predict / loss / gradients (dot and cat, separate and fused tables,
loss_threshold, bf16 compute), the dense Trainer path with lazy_adam, the
Criteo loaders and a JAX DLRM checkpoint, each against the JAX package on
the same numpy inputs, parameters carried over by `convert`.

Tolerances: fp32 values rtol 1e-5, atol 1e-6 (sums taken in another
order); the losses 1e-6; bf16 compute 2e-2 of the JAX bf16 prediction;
5 trainer steps rtol 1e-5, atol 1e-6; loaders bit-identical.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from openrec_tpu import checkpoint as jckpt
from openrec_tpu.data import loaders as jloaders
from openrec_tpu.models import DLRM as JDLRM
from openrec_tpu.models import criteo_dlrm as jcriteo_dlrm
from openrec_tpu.modules import interactions as jinter
from openrec_tpu.modules import losses as jlosses
from openrec_tpu.modules import mlp as jmlp
from openrec_tpu.training import Trainer as JTrainer
from openrec_tpu.training import optim as joptim
from openrec_tpu_torch import checkpoint as tckpt
from openrec_tpu_torch import convert
from openrec_tpu_torch.data import loaders as tloaders
from openrec_tpu_torch.models import DLRM, criteo_dlrm
from openrec_tpu_torch.modules import interactions as tinter
from openrec_tpu_torch.modules import losses as tlosses
from openrec_tpu_torch.modules.mlp import MLP
from openrec_tpu_torch.training import Trainer
from openrec_tpu_torch.training import optim as toptim

torch.set_num_threads(1)

RTOL, ATOL = 1e-5, 1e-6
LN_EMB, M_SPA, DIM_DENSE = (50, 80, 30), 4, 3
KW = dict(m_spa=M_SPA, ln_emb=LN_EMB, ln_bot=(8, M_SPA), ln_top=(16, 1),
          dim_dense=DIM_DENSE, loss_func="bce")
FIXTURES = "tests/fixtures/dataset"


def _batch(seed=0, B=24, ln_emb=LN_EMB, dim_dense=DIM_DENSE):
    rng = np.random.default_rng(seed)
    return {
        "dense_features": rng.normal(size=(B, dim_dense)).astype(np.float32),
        "sparse_features": np.stack([rng.integers(0, c, B) for c in ln_emb],
                                    axis=1).astype(np.int32),
        "label": rng.integers(0, 2, B).astype(np.float32)}


def _pair(seed=0, **kw):
    """A JAX DLRM with its params and a port DLRM holding the same."""
    jm = JDLRM(**{**KW, **kw})
    jp = jm.init(jax.random.PRNGKey(seed))
    tm = DLRM(**{**KW, **kw}, device="cpu")
    tm.load_params(convert.params_from_jax(
        jax.tree.map(np.asarray, jp), device="cpu"))
    return jm, jp, tm


def _jbatch(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


# ------------------------------------------------------------------ MLP

@pytest.mark.parametrize("activation,out_activation,batch_norm", [
    ("relu", None, False), ("sigmoid", "sigmoid", False),
    ("linear", "relu", False), ("relu", "sigmoid", True),
    ("tanh", "gelu", False), ("elu", "softmax", True)])
def test_mlp_apply_matches_jax(activation, out_activation, batch_norm):
    jm = jmlp.MLP(units=[7, 5, 3], activation=activation,
                  out_activation=out_activation, batch_norm=batch_norm)
    jp = jm.init(jax.random.PRNGKey(1), 6)
    if batch_norm:      # non-trivial scale and bias
        rng = np.random.default_rng(2)
        jp = [dict(layer, bn_scale=jnp.asarray(rng.normal(
            size=layer["bn_scale"].shape).astype(np.float32)),
            bn_bias=jnp.asarray(rng.normal(
                size=layer["bn_bias"].shape).astype(np.float32)))
            for layer in jp]
    tm = MLP(6, [7, 5, 3], activation=activation,
             out_activation=out_activation, batch_norm=batch_norm,
             device="cpu")
    flat = convert.params_from_jax(jax.tree.map(np.asarray, jp),
                                   device="cpu")
    assert set(flat) == {n.replace(".", "/")
                         for n, _ in tm.named_parameters()}
    with torch.no_grad():
        for name, p in tm.named_parameters():
            p.copy_(flat[name.replace(".", "/")])
    x = np.random.default_rng(3).normal(size=(11, 6)).astype(np.float32)
    want = np.asarray(jm.apply(jp, jnp.asarray(x)))
    got = tm(torch.from_numpy(x)).detach().numpy()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(tm.l2().item(), float(jm.l2(jp)),
                               rtol=RTOL)


def test_mlp_batch_norm_uses_biased_variance():
    tm = MLP(2, [2], activation=None, out_activation=None, batch_norm=True,
             use_bias=False, device="cpu")
    with torch.no_grad():
        tm[0].w.copy_(torch.eye(2))
    x = torch.tensor([[0.0, 1.0], [2.0, 5.0]])
    out = tm(x)
    # biased variance of [0, 2] is 1: (x - 1)/sqrt(1 + 1e-5)
    np.testing.assert_allclose(out[:, 0].detach().numpy(),
                               np.array([-1.0, 1.0]) / np.sqrt(1 + 1e-5),
                               rtol=1e-6)


def test_mlp_glorot_bounds_and_zero_bias():
    gen = torch.Generator().manual_seed(0)
    tm = MLP(30, [20, 10], device="cpu", generator=gen)
    for d_in, d_out, layer in ((30, 20, tm[0]), (20, 10, tm[1])):
        limit = np.sqrt(6.0 / (d_in + d_out))
        w = layer.w.detach().numpy()
        assert np.abs(w).max() <= limit and np.abs(w).max() > 0.8 * limit
        assert not layer.b.detach().any()


def test_mlp_dropout_keep_rate_and_scale():
    """Dropout follows every hidden layer in training only: kept units
    are scaled by 1/keep, about `keep` of them are kept (the mask's bits
    are the generator's, not JAX's). Layer 1 is the identity, so the
    output is the dropped hidden layer."""
    rate, keep = 0.25, 0.75
    tm = MLP(16, [512, 512], activation="linear", dropout_rate=rate,
             device="cpu", generator=torch.Generator().manual_seed(0))
    x = torch.from_numpy(
        np.random.default_rng(6).normal(size=(8, 16)).astype(np.float32))
    with torch.no_grad():
        tm[1].w.copy_(torch.eye(512))
        h = x @ tm[0].w + tm[0].b
        out = tm(x, train=True)
        kept = out != 0
        assert abs(kept.float().mean().item() - keep) < 0.03
        np.testing.assert_allclose(out[kept].numpy(),
                                   (h[kept] / keep).numpy(), rtol=1e-6)
        np.testing.assert_array_equal(tm(x).numpy(), h.numpy())
        # a generator passed in draws the mask instead of the module's
        masks = [tm(x, train=True,
                    generator=torch.Generator().manual_seed(5)) != 0
                 for _ in range(2)]
        assert torch.equal(masks[0], masks[1])
        assert not torch.equal(masks[0], kept)
    tm.generator = None
    with pytest.raises(ValueError, match="generator"):
        tm(x, train=True)


# ---------------------------------------------------------- interaction

@pytest.mark.parametrize("self_interaction", [False, True])
@pytest.mark.parametrize("as_list", [False, True])
def test_second_order_interaction_matches_jax(self_interaction, as_list):
    x = np.random.default_rng(4).normal(size=(9, 6, 5)).astype(np.float32)
    if as_list:
        jin = [jnp.asarray(x[:, f]) for f in range(6)]
        tin = [torch.from_numpy(x[:, f]) for f in range(6)]
    else:
        jin, tin = jnp.asarray(x), torch.from_numpy(x)
    want = np.asarray(jinter.second_order_interaction(
        jin, self_interaction=self_interaction))
    got = tinter.second_order_interaction(
        tin, self_interaction=self_interaction).numpy()
    assert got.shape == (9, 21 if self_interaction else 15)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("F", [2, 5, 27])
@pytest.mark.parametrize("k", [0, 1])
def test_triu_indices_order_is_numpys(F, k):
    iu = torch.triu_indices(F, F, offset=k).numpy()
    want = np.triu_indices(F, k=k)
    np.testing.assert_array_equal(iu[0], want[0])
    np.testing.assert_array_equal(iu[1], want[1])


# --------------------------------------------------------------- losses

def test_dlrm_losses_match_jax():
    rng = np.random.default_rng(5)
    label = rng.integers(0, 2, 64).astype(np.float32)
    prob = rng.random(64).astype(np.float32)
    prob[:3] = [0.0, 1.0, 1e-9]          # the clip range's edges
    for name in ("bce_loss", "mse_loss"):
        want = float(getattr(jlosses, name)(jnp.asarray(label),
                                            jnp.asarray(prob)))
        got = getattr(tlosses, name)(torch.from_numpy(label),
                                     torch.from_numpy(prob)).item()
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


# ----------------------------------------------------------------- DLRM

@pytest.mark.parametrize("kw", [
    {}, {"fused_tables": True}, {"arch_interaction_op": "cat"},
    {"arch_interaction_op": "cat", "fused_tables": True},
    {"arch_interaction_itself": True}, {"loss_threshold": 0.2},
    {"loss_func": "mse", "sigmoid_bot": True, "sigmoid_top": False},
], ids=lambda kw: "-".join(f"{k}={v}" for k, v in kw.items()) or "dot")
def test_dlrm_predict_loss_grads_match_jax(kw):
    jm, jp, tm = _pair(**kw)
    batch = _batch()
    jb = _jbatch(batch)
    want_pred = np.asarray(jm.predict(jp, jb["dense_features"],
                                      jb["sparse_features"]))
    got_pred = tm.predict(batch["dense_features"],
                          batch["sparse_features"]).detach().numpy()
    np.testing.assert_allclose(got_pred, want_pred, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(tm.score(batch).detach().numpy(), want_pred,
                               rtol=RTOL, atol=ATOL)
    if kw.get("loss_threshold"):
        assert got_pred.min() >= 0.2 and got_pred.max() <= 0.8
    (jl, _), jg = jax.value_and_grad(lambda p: jm.loss(p, jb),
                                     has_aux=True)(jp)
    tl, aux = tm.loss(batch)
    np.testing.assert_allclose(tl.item(), float(jl), rtol=RTOL)
    assert aux["loss"] is tl
    params = tm.params()
    grads = torch.autograd.grad(tl, list(params.values()))
    jflat = convert.flatten_tree(jax.tree.map(np.asarray, jg))
    assert set(jflat) == set(params)
    for name, g in zip(params, grads):
        np.testing.assert_allclose(g.numpy(), jflat[name], rtol=1e-4,
                                   atol=ATOL, err_msg=name)


def test_dlrm_param_names_are_jax_paths():
    _, jp, tm = _pair()
    assert set(tm.params()) == set(convert.flatten_tree(jp))
    assert "embed_tables/2" in tm.params() and "mlp_top/1/b" in tm.params()
    _, jpf, tmf = _pair(fused_tables=True)
    assert set(tmf.params()) == set(convert.flatten_tree(jpf))
    assert tuple(tmf.params()["embed_fused"].shape) == (sum(LN_EMB), M_SPA)


def test_dlrm_bf16_compute_matches_jax():
    jm, jp, _ = _pair()
    batch = _batch(B=32)
    jb = _jbatch(batch)
    j16 = JDLRM(**KW, compute_dtype="bfloat16")
    t16 = DLRM(**KW, compute_dtype="bfloat16", device="cpu")
    t16.load_params(convert.params_from_jax(jax.tree.map(np.asarray, jp),
                                            device="cpu"))
    want = np.asarray(j16.predict(jp, jb["dense_features"],
                                  jb["sparse_features"]))
    got = t16.predict(batch["dense_features"], batch["sparse_features"])
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.detach().numpy(), want, atol=2e-2)
    fp32 = np.asarray(jm.predict(jp, jb["dense_features"],
                                 jb["sparse_features"]))
    np.testing.assert_allclose(got.detach().numpy(), fp32, atol=2e-2)
    # the parameters stay fp32
    assert all(p.dtype == torch.float32 for p in t16.parameters())


def test_dlrm_fused_tables_match_separate():
    gen_sep = torch.Generator().manual_seed(0)
    gen_fused = torch.Generator().manual_seed(0)
    sep = DLRM(**KW, device="cpu", generator=gen_sep)
    fused = DLRM(**KW, fused_tables=True, device="cpu", generator=gen_fused)
    # one generator draws the same rows in either layout
    np.testing.assert_array_equal(
        fused.embed_fused.detach()[:LN_EMB[0]].numpy(),
        sep.embed_tables[0].detach().numpy())
    flat = {k: v.detach() for k, v in sep.params().items()
            if not k.startswith("embed_tables")}
    flat["embed_fused"] = torch.cat([t.detach() for t in sep.embed_tables])
    fused.load_params(flat)
    batch = _batch(seed=3, B=16)
    np.testing.assert_allclose(
        fused.predict(batch["dense_features"],
                      batch["sparse_features"]).detach().numpy(),
        sep.predict(batch["dense_features"],
                    batch["sparse_features"]).detach().numpy(),
        rtol=RTOL, atol=ATOL)
    np.testing.assert_array_equal(
        fused.flat_sparse_ids(batch["sparse_features"]).numpy(),
        batch["sparse_features"] + np.array([0, 50, 130], np.int32))


def test_dlrm_checks_and_criteo_config():
    with pytest.raises(ValueError, match="ln_bot"):
        DLRM(**{**KW, "ln_bot": (8, 3)}, device="cpu")
    with pytest.raises(ValueError, match="not supported"):
        DLRM(**KW, arch_interaction_op="sum", device="cpu")
    with pytest.raises(ValueError, match="not supported"):
        DLRM(**{**KW, "loss_func": "hinge"}, device="cpu")
    counts = [5, 7, 3] + [2] * 23
    tm = criteo_dlrm(counts, device="cpu")
    jm = jcriteo_dlrm(counts)
    assert tm._top_in_dim() == jm._top_in_dim() == 4 + 27 * 26 // 2
    assert tm.loss_func == "bce" and tm.dim_dense == 13
    np.testing.assert_array_equal(tm.table_offsets, jm.table_offsets)


# ------------------------------------------------------ dense Trainer

def test_dense_trainer_lazy_adam_matches_jax():
    """DLRM through the dense Trainer with lazy_adam for 5 steps: the
    table rows AND the MLP weights (every >= 2-D leaf is row-masked)."""
    jt = JTrainer(JDLRM(**KW), optimizer=joptim.lazy_adam(1e-2), seed=0)
    init = convert.flatten_tree(jax.tree.map(np.array, jt.params))
    tm = DLRM(**KW, device="cpu")
    tm.load_params(convert.params_from_jax(
        jax.tree.map(np.asarray, jt.params), device="cpu"))
    tt = Trainer(tm, optimizer=toptim.lazy_adam(1e-2), device="cpu")
    for step in range(5):
        batch = _batch(seed=10 + step, B=16)
        jl, _ = jt.train_step(batch)
        tl, _ = tt.train_step(batch)
        np.testing.assert_allclose(tl.item(), float(jl), rtol=RTOL)
    jflat = convert.flatten_tree(jax.tree.map(np.asarray, jt.params))
    for name, p in tt.params.items():
        np.testing.assert_allclose(p.detach().numpy(), jflat[name],
                                   rtol=RTOL, atol=ATOL, err_msg=name)
    # rows no batch touched kept their values in both
    touched = set()
    for step in range(5):
        touched |= set(_batch(seed=10 + step, B=16)["sparse_features"][:, 1]
                       .tolist())
    untouched = sorted(set(range(LN_EMB[1])) - touched)
    assert untouched
    np.testing.assert_array_equal(
        tt.params["embed_tables/1"].detach().numpy()[untouched],
        init["embed_tables/1"][untouched])
    np.testing.assert_array_equal(jflat["embed_tables/1"][untouched],
                                  init["embed_tables/1"][untouched])


# -------------------------------------------------------------- loaders

def test_load_criteo_fixture_bit_identical():
    for seed in (0, 1):
        want = jloaders.load_criteo(FIXTURES, seed=seed)
        got = tloaders.load_criteo(FIXTURES, seed=seed)
        assert set(got) == set(want)
        for key, value in want.items():
            assert got[key].dtype == value.dtype, key
            np.testing.assert_array_equal(got[key], value, err_msg=key)


@pytest.mark.parametrize("counts", [None, (11, 3, 400) + (5,) * 23])
def test_synthetic_criteo_bit_identical(counts):
    want = jloaders.synthetic_criteo(num_records=700, counts=counts, seed=3)
    got = tloaders.synthetic_criteo(num_records=700, counts=counts, seed=3)
    assert set(got) == set(want)
    for key, value in want.items():
        assert got[key].dtype == value.dtype, key
        np.testing.assert_array_equal(got[key], value, err_msg=key)


def test_write_synthetic_criteo_npz_bit_identical(tmp_path):
    size_j = jloaders.write_synthetic_criteo_npz(
        str(tmp_path / "j" / "criteo" / "kaggle_processed.npz"),
        num_records=500, seed=4)
    size_t = tloaders.write_synthetic_criteo_npz(
        str(tmp_path / "t" / "criteo" / "kaggle_processed.npz"),
        num_records=500, seed=4)
    assert size_j == size_t
    with np.load(tmp_path / "j" / "criteo" / "kaggle_processed.npz") as a, \
            np.load(tmp_path / "t" / "criteo" / "kaggle_processed.npz") as b:
        assert a.files == b.files
        for key in a.files:
            assert a[key].dtype == b[key].dtype
            np.testing.assert_array_equal(a[key], b[key])
    got = tloaders.load_criteo(str(tmp_path / "t"), seed=0)
    want = jloaders.load_criteo(str(tmp_path / "j"), seed=0)
    for key, value in want.items():
        np.testing.assert_array_equal(got[key], value, err_msg=key)


# ----------------------------------------------------------- checkpoint

@pytest.mark.parametrize("fused", [False, True])
def test_jax_dlrm_checkpoint_restores_into_port(tmp_path, fused):
    """A JAX Trainer checkpoint of a DLRM (keys params/mlp_bot/0/w,
    params/embed_tables/3 ...) restores into the port, which then
    predicts as the JAX model does."""
    jt = JTrainer(JDLRM(**KW, fused_tables=fused), seed=2,
                  save_model_dir=str(tmp_path))
    for step in range(2):
        jt.train_step(_batch(seed=step, B=16))
    path = jt.save()
    tm = DLRM(**KW, fused_tables=fused, device="cpu")
    tt = Trainer(tm, device="cpu", save_model_dir=str(tmp_path))
    assert tt.restore() == path
    batch = _batch(seed=9, B=16)
    jb = _jbatch(batch)
    np.testing.assert_allclose(
        tm.predict(batch["dense_features"],
                   batch["sparse_features"]).detach().numpy(),
        np.asarray(jt.model.predict(jt.params, jb["dense_features"],
                                    jb["sparse_features"])),
        rtol=RTOL, atol=ATOL)
    assert int(tt.opt_state.count) == 2
    # and the plain restore, templated by the model's own names
    flat = tckpt.restore(path, template={
        f"params/{k}": v.detach() for k, v in tm.params().items()})
    assert set(flat) == {f"params/{k}" for k in tm.params()}


def test_port_dlrm_checkpoint_restores_into_jax(tmp_path):
    tm = DLRM(**KW, device="cpu", generator=torch.Generator().manual_seed(4))
    tckpt.save(str(tmp_path), 3, {"params": {k: v.detach() for k, v in
                                             tm.params().items()}})
    jm = JDLRM(**KW)
    template = {"params": jm.init(jax.random.PRNGKey(0))}
    restored = jckpt.restore(jckpt.latest_checkpoint(str(tmp_path)),
                             template)["params"]
    batch = _batch(seed=1, B=8)
    jb = _jbatch(batch)
    np.testing.assert_allclose(
        np.asarray(jm.predict(restored, jb["dense_features"],
                              jb["sparse_features"])),
        tm.score(batch).detach().numpy(), rtol=RTOL, atol=ATOL)


def test_bpr_names_checkpoint_and_state_keys_unchanged(tmp_path):
    """params() maps "." to "/" for every model; BPR's names hold neither,
    so its names, npz keys and optimizer-state keys are the JAX ones."""
    from openrec_tpu.models import BPR as JBPR
    from openrec_tpu_torch.models import BPR
    model = BPR(6, 9, 3, 3, device="cpu")
    assert list(model.params()) == [n for n, _ in model.named_parameters()] \
        == ["user_embed", "item_embed", "item_bias"]
    tt = Trainer(model, device="cpu", save_model_dir=str(tmp_path / "t"))
    jt = JTrainer(JBPR(6, 9, 3, 3), save_model_dir=str(tmp_path / "j"))
    with np.load(tt.save(0)) as a, np.load(jt.save(0)) as b:
        assert set(a.files) == set(b.files) == {
            f"{part}/{name}" for part in ("params", "opt_state/mu",
                                          "opt_state/nu")
            for name in ("user_embed", "item_embed", "item_bias")} \
            | {"opt_state/count"}
    assert set(tt.opt_state.mu) == {"user_embed", "item_embed", "item_bias"}
