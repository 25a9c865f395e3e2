"""Port parity: the npz checkpoints of the two packages are one format.
A JAX `save` is read by the port's `restore` and the other way round,
optimistic partial restores included."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from openrec_tpu import checkpoint as jckpt
from openrec_tpu.models import BPR as JBPR
from openrec_tpu_torch import checkpoint as tckpt
from openrec_tpu_torch import convert
from openrec_tpu_torch.models import BPR

torch.set_num_threads(1)


def _jax_params(seed=0, users=12, items=20, dim=4):
    return JBPR(total_users=users, total_items=items, dim_user_embed=dim,
                dim_item_embed=dim).init(jax.random.PRNGKey(seed))


def test_jax_save_port_restore(tmp_path):
    params = _jax_params()
    path = jckpt.save(str(tmp_path), 7, params)
    flat = tckpt.restore(path, device="cpu")
    assert set(flat) == {"user_embed", "item_embed", "item_bias"}
    for key, value in flat.items():
        np.testing.assert_array_equal(value.numpy(),
                                      np.asarray(params[key]))
    model = BPR(12, 20, 4, 4, device="cpu")
    model.load_params(tckpt.restore(path, template=model.state_dict()))
    np.testing.assert_array_equal(model.user_embed.detach().numpy(),
                                  np.asarray(params["user_embed"]))


def test_port_save_jax_restore(tmp_path):
    model = BPR(12, 20, 4, 4, device="cpu",
                generator=torch.Generator().manual_seed(1))
    path = tckpt.save(str(tmp_path), 3, model.params())
    template = _jax_params(seed=5)
    got = jckpt.restore(path, template=template)
    for key, value in model.params().items():
        np.testing.assert_array_equal(np.asarray(got[key]),
                                      value.detach().numpy())
    assert jckpt.latest_step(str(tmp_path)) == 3


def test_optimistic_restore_both_ways(tmp_path):
    # A checkpoint of a smaller model: user_embed shapes differ.
    small = _jax_params(users=5)
    path = jckpt.save(str(tmp_path / "jax"), 1, small)
    model = BPR(12, 20, 4, 4, device="cpu")
    before = {k: v.detach().clone() for k, v in model.params().items()}
    with pytest.raises(KeyError):
        tckpt.restore(path, template=model.state_dict())
    got = tckpt.restore(path, template=model.state_dict(), optimistic=True)
    assert torch.equal(got["user_embed"], before["user_embed"])
    np.testing.assert_array_equal(got["item_embed"].numpy(),
                                  np.asarray(small["item_embed"]))

    # The port's checkpoint of a model without item_bias, read by JAX.
    partial = {k: v for k, v in model.params().items() if k != "item_bias"}
    tpath = tckpt.save(str(tmp_path / "torch"), 2, partial)
    template = _jax_params(seed=9)
    with pytest.raises(KeyError):
        jckpt.restore(tpath, template=template)
    got = jckpt.restore(tpath, template=template, optimistic=True)
    np.testing.assert_array_equal(np.asarray(got["item_bias"]),
                                  np.asarray(template["item_bias"]))
    np.testing.assert_array_equal(np.asarray(got["user_embed"]),
                                  partial["user_embed"].detach().numpy())


def test_max_to_keep_and_latest_match_jax(tmp_path):
    params = convert.params_from_jax(jax.tree.map(np.asarray,
                                                  _jax_params()),
                                     device="cpu")
    for step in (1, 20, 3, 100):
        tckpt.save(str(tmp_path), step, params, max_to_keep=2)
    assert tckpt.sorted_checkpoints(str(tmp_path)) \
        == jckpt.sorted_checkpoints(str(tmp_path)) \
        == ["ckpt-20.npz", "ckpt-100.npz"]
    assert tckpt.latest_step(str(tmp_path)) == 100
    assert tckpt.latest_checkpoint(str(tmp_path)) \
        == jckpt.latest_checkpoint(str(tmp_path))
    assert tckpt.latest_step(str(tmp_path / "none")) is None
    # and a nested tree round-trips to JAX-style keys
    path = tckpt.save(str(tmp_path / "n"), 0,
                      {"mlp": [{"w": torch.ones(2)}, {"w": torch.zeros(3)}]})
    assert sorted(jckpt.restore(path)) == ["mlp/0/w", "mlp/1/w"]
    restored = jckpt.restore(path, template={"mlp": [
        {"w": jnp.zeros(2)}, {"w": jnp.ones(3)}]})
    np.testing.assert_array_equal(np.asarray(restored["mlp"][0]["w"]),
                                  np.ones(2))
