"""Port parity: lazy_adam, keras_adam and lazy_adagrad against
`openrec_tpu.training.optim` over a multi-step schedule where rows move in
and out of the batch and one present row gets an all-zero gradient (the
schedule of tests/test_optim.py), with a dense 1-D leaf beside the table.

Tolerances: rtol 1e-5, atol 1e-7 (the same fp32 formulas; pow, sqrt and
division may round differently in the two libraries).
"""

import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from openrec_tpu.training import optim as joptim
from openrec_tpu_torch import convert
from openrec_tpu_torch.training import optim as toptim

torch.set_num_threads(1)

R, D = 8, 3
SCHEDULE = [[0, 1, 2], [2, 3], [5], [0, 3, 5, 7], [1], [], [6, 2]]
ZERO_GRAD = 4      # step index whose present row [1] gets a zero gradient


def _grads(rng, step, rows):
    g = np.zeros((R, D), np.float32)
    if step != ZERO_GRAD:
        g[rows] = rng.normal(size=(len(rows), D))
    dense = rng.normal(size=(D,)).astype(np.float32)
    return {"table": g, "dense": dense}


def _np_state(state):
    return {k: np.asarray(v) for k, v in
            convert.flatten_tree(state).items()}


@pytest.mark.parametrize("name,kw", [("lazy_adam", {"learning_rate": 0.01}),
                                     ("keras_adam", {"learning_rate": 0.01}),
                                     ("lazy_adagrad", {"learning_rate": 0.1})])
def test_trajectory_matches_jax(name, kw):
    rng = np.random.default_rng(0)
    init = {"table": rng.normal(size=(R, D)).astype(np.float32),
            "dense": rng.normal(size=(D,)).astype(np.float32)}
    jtx = getattr(joptim, name)(**kw)
    ttx = getattr(toptim, name)(**kw)
    jp = {k: jnp.asarray(v) for k, v in init.items()}
    tp = convert.params_from_jax(init, device="cpu")
    js, ts = jtx.init(jp), ttx.init(tp)
    for step, rows in enumerate(SCHEDULE):
        g = _grads(rng, step, rows)
        ju, js = jtx.update({k: jnp.asarray(v) for k, v in g.items()}, js,
                            jp)
        jp = optax.apply_updates(jp, ju)
        tu, ts = ttx.update({k: torch.from_numpy(v) for k, v in g.items()},
                            ts, tp)
        toptim.apply_updates(tp, tu)
        for k in init:
            np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]),
                                       rtol=1e-5, atol=1e-7)
        want, got = _np_state(js), _np_state(ts)
        assert sorted(want) == sorted(got)
        for key in want:
            assert got[key].dtype == want[key].dtype, key
            np.testing.assert_allclose(got[key], want[key], rtol=1e-5,
                                       atol=1e-7)
    if name != "keras_adam":
        # rows never in a batch, and rows whose only later steps carried
        # zero gradients, stay put under the lazy rules
        np.testing.assert_array_equal(tp["table"][4].numpy(),
                                      init["table"][4])


def test_lazy_adam_keeps_untouched_moments_and_keras_decays_them():
    params = {"t": torch.zeros((4, 2))}
    g1 = {"t": torch.zeros((4, 2))}
    g1["t"][1] = 1.0
    g0 = {"t": torch.zeros((4, 2))}
    lazy, keras = toptim.lazy_adam(0.1), toptim.keras_adam(0.1)
    ls, ks = lazy.init(params), keras.init(params)
    _, ls = lazy.update(g1, ls, params)
    _, ks = keras.update(g1, ks, params)
    mu1 = ls.mu["t"].clone()
    lu, ls = lazy.update(g0, ls, params)
    ku, ks = keras.update(g0, ks, params)
    assert torch.equal(ls.mu["t"], mu1)
    assert torch.equal(lu["t"], torch.zeros_like(lu["t"]))
    assert not torch.equal(ks.mu["t"], mu1)
    assert ku["t"][1].abs().min() > 0          # residual momentum moves it
    assert int(ls.count) == int(ks.count) == 2
    assert ls.count.dtype == torch.int32


def test_state_follows_the_parameters_device():
    params = {"t": torch.zeros((3, 2)), "b": torch.zeros(2)}
    for tx in (toptim.lazy_adam(), toptim.keras_adam()):
        st = tx.init(params)
        assert st.count.device.type == "cpu"
        assert st.mu["t"].shape == (3, 2) and st.nu["b"].shape == (2,)
    acc = toptim.lazy_adagrad().init(params)
    assert sorted(acc) == ["b", "t"]
