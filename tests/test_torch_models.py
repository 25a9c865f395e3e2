"""Port parity: embedding functions, BPR losses, BPR score / loss / aux and
autograd gradients against the JAX package (jax.grad) on the same
parameters and batch.

Tolerances: rtol=atol=1e-5 (fp32 sums taken in another order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from openrec_tpu.models import BPR as JBPR
from openrec_tpu.modules import embedding as jemb
from openrec_tpu.modules import losses as jlosses
from openrec_tpu_torch import convert
from openrec_tpu_torch.models import BPR
from openrec_tpu_torch.modules import embedding as temb
from openrec_tpu_torch.modules import losses as tlosses

torch.set_num_threads(1)

TOL = 1e-5
USERS, ITEMS, DIM, BATCH = 30, 70, 8, 16


def _params(seed=0):
    params = jax.tree.map(np.asarray, JBPR(
        total_users=USERS, total_items=ITEMS, dim_user_embed=DIM,
        dim_item_embed=DIM).init(jax.random.PRNGKey(seed)))
    params["item_bias"] = np.random.default_rng(seed).normal(
        scale=0.1, size=(ITEMS, 1)).astype(np.float32)
    return params


def _batch(seed=1):
    rng = np.random.default_rng(seed)
    return {"user_id": rng.integers(0, USERS, BATCH).astype(np.int32),
            "p_item_id": rng.integers(0, ITEMS, BATCH).astype(np.int32),
            "n_item_id": rng.integers(0, ITEMS, BATCH).astype(np.int32)}


def _torch_bpr(np_params):
    model = BPR(USERS, ITEMS, DIM, DIM, device="cpu")
    model.load_params(convert.params_from_jax(np_params, device="cpu"))
    return model


def test_embedding_lookup_clamps_like_jax():
    table = np.random.default_rng(0).normal(size=(10, 4)).astype(np.float32)
    ids = np.array([[-5, 0, 3], [9, 10, 1000]], np.int32)
    want = np.asarray(jemb.embedding_lookup(jnp.asarray(table),
                                            jnp.asarray(ids)))
    got = temb.embedding_lookup(torch.from_numpy(table),
                                torch.from_numpy(ids))
    assert tuple(got.shape) == want.shape == (2, 3, 4)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("fn", ["censor_norm", "censor_max_norm"])
def test_censoring_matches_jax(fn):
    rng = np.random.default_rng(1)
    table = (rng.normal(size=(12, 5)) * 2).astype(np.float32)
    table[4] *= 0.01                   # a row under eps / max_norm
    ids = np.array([0, 4, 4, 7, 11], np.int32)        # duplicates too
    want = np.asarray(getattr(jemb, fn)(jnp.asarray(table),
                                        jnp.asarray(ids)))
    got = getattr(temb, fn)(torch.from_numpy(table), torch.from_numpy(ids))
    np.testing.assert_allclose(got.numpy(), want, rtol=TOL, atol=TOL)


def test_embedding_init_range_and_generator():
    g1 = torch.Generator().manual_seed(3)
    g2 = torch.Generator().manual_seed(3)
    a = temb.embedding_init(50, 6, generator=g1, device="cpu")
    b = temb.embedding_init(50, 6, generator=g2, device="cpu")
    assert torch.equal(a, b)
    assert a.abs().max() <= 0.05 and a.std() > 0.02
    z = temb.embedding_init(5, 6, zero_init=True, device="cpu")
    assert not z.any()


def test_pairwise_log_loss_clamp_and_l2_match_jax():
    rng = np.random.default_rng(2)
    u, p, n = (rng.normal(size=(9, 4)).astype(np.float32) for _ in range(3))
    pb, nb = (rng.normal(size=(9, 1)).astype(np.float32) for _ in range(2))
    nb[0] = 100.0                     # pos - neg far below -30: clamped
    for args in [(u, p, n), (u, p, n, pb, nb)]:
        want = float(jlosses.pairwise_log_loss(*map(jnp.asarray, args)))
        got = float(tlosses.pairwise_log_loss(*map(torch.from_numpy, args)))
        np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)
    np.testing.assert_allclose(
        float(tlosses.l2_half(*map(torch.from_numpy, (u, p)))),
        float(jlosses.l2_half(*map(jnp.asarray, (u, p)))), rtol=TOL)


def test_bpr_parameters_named_like_jax():
    np_params = _params()
    model = _torch_bpr(np_params)
    assert set(model.params()) == {"user_embed", "item_embed", "item_bias"}
    for key, value in model.params().items():
        np.testing.assert_array_equal(value.detach().numpy(),
                                      np_params[key])
    assert tuple(model.item_bias.shape) == (ITEMS, 1)
    with pytest.raises(ValueError):
        model.load_params({**model.params(),
                           "item_bias": torch.zeros(ITEMS)})


def test_bpr_score_matches_jax():
    np_params = _params()
    users = np.array([0, 5, 29, 12], np.int32)
    want = np.asarray(JBPR(USERS, ITEMS, DIM, DIM).score(
        jax.tree.map(jnp.asarray, np_params), {"user_id": users}))
    got = _torch_bpr(np_params).score({"user_id": torch.from_numpy(users)})
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=TOL,
                               atol=TOL)


@pytest.mark.parametrize("l2_weight", [1.0, 0.0])
def test_bpr_loss_aux_and_grads_match_jax(l2_weight):
    np_params = _params()
    batch = _batch()
    jmodel = JBPR(USERS, ITEMS, DIM, DIM, l2_weight=l2_weight)
    jparams = jax.tree.map(jnp.asarray, np_params)
    (want_loss, want_aux), want_grads = jax.value_and_grad(
        jmodel.loss, has_aux=True)(jparams, jax.tree.map(jnp.asarray, batch))

    model = _torch_bpr(np_params)
    model.l2_weight = l2_weight
    loss, aux = model.loss({k: torch.from_numpy(v) for k, v in batch.items()})
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(want_loss), rtol=TOL,
                               atol=TOL)
    for key in ("loss", "l2_loss"):
        np.testing.assert_allclose(aux[key].item(), float(want_aux[key]),
                                   rtol=TOL, atol=TOL)
    for key, param in model.params().items():
        np.testing.assert_allclose(param.grad.numpy(),
                                   np.asarray(want_grads[key]),
                                   rtol=TOL, atol=TOL, err_msg=key)


def test_params_round_trip_through_numpy():
    np_params = _params()
    flat = convert.params_from_jax(np_params, device="cpu")
    back = convert.params_to_numpy(flat)
    assert set(back) == set(np_params)
    for key in np_params:
        np.testing.assert_array_equal(back[key], np_params[key])
    nested = convert.params_from_jax({"a": {"w": np.ones(2)},
                                      "b": [np.zeros(1), np.ones(3)]},
                                     device="cpu")
    assert sorted(nested) == ["a/w", "b/0", "b/1"]
