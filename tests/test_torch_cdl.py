"""Port parity: CDL and its SDAE.

The same numpy inputs go through the JAX package and the port: the SDAE's
code and reconstruction term with autograd gradients against jax.grad, its
mirrored decoder, CDL's loss, aux and gradients (SDAE dropout 0; sigmoid on
and off; item features looked up from the model or given in the batch),
its full-catalog scores, 20 steps of lazy_adam and keras_adam through both
Trainers, and the JAX package's npz checkpoints both ways (the item
features are a buffer, in neither). The corruption mask draws from a
torch.Generator, so its law is held: each kept entry is x / keep, the rest
0, at the keep rate. The JAX package's own bar is mirrored
(`tests/test_models_extended.py:215`).

Tolerances: rtol = atol = 1e-5 for losses, gradients and scores; 20-step
parameters and losses rtol 1e-5, atol 1e-6.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from openrec_tpu import checkpoint as jckpt
from openrec_tpu import models as jmodels
from openrec_tpu.modules.sdae import SDAE as JSDAE
from openrec_tpu.training import Trainer as JTrainer
from openrec_tpu.training import optim as joptim
from openrec_tpu_torch import checkpoint as tckpt
from openrec_tpu_torch import convert, models
from openrec_tpu_torch.data import InteractionStore, samplers
from openrec_tpu_torch.modules.sdae import SDAE
from openrec_tpu_torch.training import Trainer, optim as toptim
from tests.conftest import make_interactions

torch.set_num_threads(1)

TOL = 1e-5
RTOL, ATOL = 1e-5, 1e-6
USERS, ITEMS, DIM, BATCH, FEAT, LR = 30, 70, 8, 16, 20, 1e-3
FEATURES = (np.random.default_rng(11).random((ITEMS, FEAT)) < 0.2).astype(
    np.float32)
SPECS = {
    "CDL": dict(encoder_dims=(12,), l2_reconst=0.1, a=1.0, b=0.01,
                l2_weight=0.01),
    "CDL-linear": dict(encoder_dims=(), l2_reconst=1.0, a=2.0, b=0.5,
                       sigmoid=False),
    "CDL-deep": dict(encoder_dims=(16, 12), l2_reconst=0.5),
}


def _models(name, seed=0):
    """(JAX model, numpy params, port model holding the same params)."""
    kw = SPECS[name]
    jmodel = jmodels.CDL(USERS, ITEMS, DIM, item_features=FEATURES, **kw)
    params = jax.tree.map(np.asarray, jmodel.init(jax.random.PRNGKey(seed)))
    rng = np.random.default_rng(seed)
    params["item_bias"] = rng.normal(scale=0.1, size=(ITEMS, 1)).astype(
        np.float32)
    for layer in params["sdae"]["encoder"] + params["sdae"]["decoder"]:
        layer["b"] = rng.normal(scale=0.1, size=layer["b"].shape).astype(
            np.float32)
    model = models.CDL(USERS, ITEMS, DIM, FEATURES, device="cpu", **kw)
    model.load_params(convert.params_from_jax(params, device="cpu"))
    return jmodel, params, model


def _batch(rng, with_features=False):
    batch = {"user_id": rng.integers(0, USERS, BATCH).astype(np.int32),
             "item_id": rng.integers(0, ITEMS, BATCH).astype(np.int32),
             "label": (rng.random(BATCH) < 0.3).astype(np.float32)}
    if with_features:
        batch["item_feature"] = rng.random((BATCH, FEAT)).astype(np.float32)
    return batch


# -------------------------------------------------------------------- SDAE

@pytest.mark.parametrize("dims", [[6], [12, 6], [16, 12, 6]])
def test_sdae_matches_jax(dims):
    """Code and reconstruction term with their gradients, dropout 0; the
    decoder mirrors the encoder's hidden dims and ends at in_dim."""
    jsdae = JSDAE(in_dim=FEAT, dims=dims, l2_reconst=0.3)
    params = jax.tree.map(np.asarray, jsdae.init(jax.random.PRNGKey(1)))
    sdae = SDAE(FEAT, dims, l2_reconst=0.3, device="cpu")
    flat = convert.flatten_tree(params)
    assert {k: tuple(v.shape) for k, v in sdae.named_parameters()} \
        == {k.replace("/", "."): v.shape for k, v in flat.items()}
    assert [layer.w.shape[1] for layer in sdae.decoder] \
        == dims[-2::-1] + [FEAT]
    sdae.load_state_dict({k.replace("/", "."): torch.tensor(v)
                          for k, v in flat.items()})
    x = FEATURES[:9]

    def jloss(p):
        rec, code = jsdae.reconstruction_loss(p, jnp.asarray(x))
        return rec, code
    (want, want_code), grads = jax.value_and_grad(jloss, has_aux=True)(
        jax.tree.map(jnp.asarray, params))
    rec, code = sdae.reconstruction_loss(torch.from_numpy(x))
    rec.backward()
    np.testing.assert_allclose(rec.item(), float(want), rtol=TOL, atol=TOL)
    np.testing.assert_allclose(code.detach().numpy(), np.asarray(want_code),
                               rtol=TOL, atol=TOL)
    np.testing.assert_allclose(
        sdae.encode(torch.from_numpy(x)).detach().numpy(),
        np.asarray(jsdae.encode(params, jnp.asarray(x))), rtol=TOL, atol=TOL)
    for key, g in convert.flatten_tree(grads).items():
        np.testing.assert_allclose(
            sdae.get_parameter(key.replace("/", ".")).grad.numpy(),
            np.asarray(g), rtol=TOL, atol=TOL, err_msg=key)


def test_sdae_corruption_keeps_x_over_keep_at_the_keep_rate():
    """An identity encoder returns the corrupted input: every entry is
    x / keep or 0, the kept share of 60,000 entries within 5 standard
    deviations of keep; no generator, no corruption."""
    rate, H = 0.1, 60
    sdae = SDAE(H, [H], dropout=rate, device="cpu")
    with torch.no_grad():
        sdae.encoder[0].w.copy_(torch.eye(H))
    x = torch.from_numpy(np.random.default_rng(2).random(
        (1000, H)).astype(np.float32) + 0.5)
    with torch.no_grad():
        _, code = sdae.reconstruction_loss(
            x, torch.Generator().manual_seed(4))
        _, clean = sdae.reconstruction_loss(x)
    keep = 1.0 - rate
    kept = code != 0
    assert torch.equal(code[kept], (x / keep)[kept])
    share = kept.float().mean().item()
    assert abs(share - keep) < 5 * np.sqrt(keep * (1 - keep) / x.numel())
    assert torch.equal(clean, x)


# ------------------------------------------------------------------- model

@pytest.mark.parametrize("with_features", [False, True])
@pytest.mark.parametrize("name", list(SPECS))
def test_loss_aux_and_grads_match_jax(name, with_features):
    jmodel, params, model = _models(name)
    batch = _batch(np.random.default_rng(1), with_features)
    (want, want_aux), want_grads = jax.value_and_grad(
        jmodel.loss, has_aux=True)(jax.tree.map(jnp.asarray, params),
                                   jax.tree.map(jnp.asarray, batch))
    loss, aux = model.loss({k: torch.from_numpy(v)
                            for k, v in batch.items()})
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(want), rtol=TOL, atol=TOL)
    assert sorted(aux) == sorted(want_aux) \
        == ["l2_loss", "loss", "reconst_loss"]
    for key in aux:
        np.testing.assert_allclose(aux[key].item(), float(want_aux[key]),
                                   rtol=TOL, atol=TOL, err_msg=key)
    flat_grads = convert.flatten_tree(want_grads)
    assert sorted(flat_grads) == sorted(model.params())
    for key, param in model.params().items():
        np.testing.assert_allclose(param.grad.numpy(),
                                   np.asarray(flat_grads[key]),
                                   rtol=TOL, atol=TOL, err_msg=key)


@pytest.mark.parametrize("name", list(SPECS))
def test_score_matches_jax(name):
    """The whole catalog re-encoded, sigmoid where the model has it; the
    serving side item_vecs is item_embed + enc(features)."""
    jmodel, params, model = _models(name)
    users = np.array([0, 5, 29, 12, 12], np.int32)
    want = np.asarray(jmodel.score(jax.tree.map(jnp.asarray, params),
                                   {"user_id": users}))
    with torch.no_grad():
        got = model.score({"user_id": torch.from_numpy(users)})
        vecs = model.item_vecs(torch.arange(ITEMS))
    assert tuple(got.shape) == want.shape == (5, ITEMS)
    np.testing.assert_allclose(got.numpy(), want, rtol=TOL, atol=TOL)
    code = np.asarray(JSDAE(FEAT, list(SPECS[name]["encoder_dims"]) + [DIM])
                      .encode(params["sdae"], jnp.asarray(FEATURES)))
    np.testing.assert_allclose(vecs.numpy(), params["item_embed"] + code,
                               rtol=TOL, atol=TOL)


@pytest.mark.parametrize("optimizer", ["lazy_adam", "keras_adam"])
def test_twenty_steps_match_jax(optimizer):
    """20 steps (two K-step calls of 10) from the same parameters, SDAE
    dropout 0."""
    jmodel, params, model = _models("CDL")
    rng = np.random.default_rng(7)
    batches = [_batch(rng) for _ in range(20)]
    jt = JTrainer(jmodel, optimizer=getattr(joptim, optimizer)(LR), seed=0)
    jt.params = jax.tree.map(jnp.asarray, params)
    jt.opt_state = jt.tx.init(jt.params)
    tt = Trainer(model, optimizer=getattr(toptim, optimizer)(LR),
                 device="cpu")
    jl = np.concatenate([np.asarray(jt.train_step_multi(batches[:10])),
                         np.asarray(jt.train_step_multi(batches[10:]))])
    tl = torch.cat([tt.train_step_multi(batches[:10]),
                    tt.train_step_multi(batches[10:])]).numpy()
    np.testing.assert_allclose(tl, jl, rtol=RTOL, atol=ATOL)
    want = convert.flatten_tree(jax.tree.map(np.asarray, jt.params))
    for key, value in tt.params.items():
        np.testing.assert_allclose(value.detach().numpy(), want[key],
                                   rtol=RTOL, atol=ATOL, err_msg=key)


def test_jax_checkpoints_restore_both_ways(tmp_path):
    """By name (`sdae/encoder/0/w`, `sdae/decoder/1/b`, ...); the item
    features are in neither file nor state_dict."""
    jmodel, params, model = _models("CDL", seed=2)
    assert "item_features" not in model.state_dict()
    assert not any("feature" in k for k in model.params())
    path = jckpt.save(str(tmp_path / "jax"), 4, params)
    fresh = models.CDL(USERS, ITEMS, DIM, FEATURES, device="cpu",
                       **SPECS["CDL"])
    fresh.load_params(tckpt.restore(path, device="cpu"))
    for key, value in convert.flatten_tree(params).items():
        np.testing.assert_array_equal(fresh.params()[key].detach().numpy(),
                                      value, err_msg=key)
    back = tckpt.save(str(tmp_path / "torch"), 5, fresh.params())
    assert "sdae/decoder/1/b" in np.load(back).files
    template = jmodel.init(jax.random.PRNGKey(9))
    got = jax.tree.map(np.asarray, jckpt.restore(back, template=template))
    assert jax.tree.structure(got) == jax.tree.structure(template)
    for key, value in convert.flatten_tree(got).items():
        np.testing.assert_array_equal(
            value, convert.flatten_tree(params)[key], err_msg=key)


def test_init_is_truncated_normal_and_features_stay_a_buffer():
    model = models.CDL(200, 300, 16, np.ones((300, 5), np.float32),
                       encoder_dims=(8,), device="cpu",
                       generator=torch.Generator().manual_seed(3))
    for table in (model.user_embed, model.item_embed):
        t = table.detach()
        assert t.abs().max() <= 0.02 and 0.007 < t.std() < 0.0095
    assert not model.item_bias.any()
    assert dict(model.named_buffers())["item_features"].shape == (300, 5)


# ----------------------------------------------- the JAX package's own bar

def test_cdl_reconstruction_plus_rating():
    """tests/test_models_extended.py:215 on the port, and with SDAE dropout
    the Trainer's generator reaches the corruption."""
    store = InteractionStore(make_interactions(), 40, 100, seed=0)
    feats = np.random.default_rng(3).normal(size=(100, 20)).astype(
        np.float32)
    for dropout in (0.0, 0.2):
        model = models.CDL(40, 100, 8, feats, encoder_dims=(16,),
                           l2_reconst=0.1, dropout=dropout, device="cpu",
                           generator=torch.Generator().manual_seed(0))
        s = samplers.StratifiedPointwiseSampler(store, batch_size=64,
                                                seed=0, use_native=False)
        _, aux = model.loss(s.sample())
        assert aux["reconst_loss"].item() > 0
        tr = Trainer(model, lr=0.01, seed=0, device="cpu")
        state = tr.generator.get_state()
        losses = [float(tr.train_step(b)[0])
                  for b, _ in zip(iter(s), range(40))]
        assert np.isfinite(losses).all()
        assert np.mean(losses[-5:]) < np.mean(losses[:5])
        assert torch.equal(tr.generator.get_state(), state) \
            == (dropout == 0.0)
