"""Port parity, the bucketed id exchange (`parallel/bucketed.py`) on a
2 x 4 gloo mesh of 8 CPU ranks against the JAX package's on its 2 x 4
CPU mesh (tests/test_bucketed.py): the host bucketing bit-identical,
`gathered_lookup` and `alltoall_lookup` values and gradients (the
all_gather's reduce-scatter, the all_to_all's all_to_all), a BPR SGD step
routed through the exchange, and the two exchanges against the masked
`sharded_lookup`.

One launch of `python -c WORKER` (never imports JAX) serves every case.
Bars: bucketing, lookups exact; gradients rtol 1e-6, atol 1e-6; the SGD
step rtol 1e-5, atol 1e-6 (JAX's own).
"""

import os
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from openrec_tpu.modules.losses import pairwise_log_loss
from openrec_tpu.parallel import bucketed as jb
from openrec_tpu.parallel import (alltoall_lookup, gathered_lookup,
                                  make_mesh, pad_rows)
from openrec_tpu.parallel.mesh import row_sharding
from openrec_tpu_torch.parallel import bucketed as tb
from openrec_tpu_torch.parallel.launch import spawn_local

pytestmark = pytest.mark.skipif(len(jax.devices()) < 8,
                                reason="needs 8 virtual devices")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

WORKER = r'''
import os, pickle
import numpy as np
import torch
torch.set_num_threads(1)
import torch.distributed as dist
from openrec_tpu_torch import parallel as par
from openrec_tpu_torch.modules.losses import pairwise_log_loss
from openrec_tpu_torch.parallel import collectives as col

inp = pickle.load(open(os.environ["CASES_IN"], "rb"))
mesh = par.make_mesh(2, 4, device="cpu")
i, j = (par.mesh.axis_index(mesh, a) for a in ("data", "model"))
data_group = par.mesh.axis_group(mesh, "data")
T = torch.as_tensor
out = {}


def shard_of(full):
    n = full.shape[0] // 4
    return T(full[j * n:(j + 1) * n]).clone()


c = inp["gathered"]
out["gathered"] = par.gathered_lookup(shard_of(c["table"]), c["buckets"],
                                      c["inv"], mesh).numpy()
out["masked"] = par.sharded_lookup(shard_of(c["table"]), T(c["ids"])[
    i * 16:(i + 1) * 16], mesh).numpy()

c = inp["gathered_grad"]
t = shard_of(c["table"]).requires_grad_()
rows = par.gathered_lookup(t, c["buckets"], c["inv"], mesh)
(rows * T(c["cot"])[i * 4:(i + 1) * 4]).sum().backward()
out["gathered_grad"] = col.all_reduce_sum([t.grad], data_group)[0].numpy()

c = inp["alltoall"]
out["alltoall"] = par.alltoall_lookup(shard_of(c["table"]), c["buckets"],
                                      c["inv"], mesh).numpy()

c = inp["alltoall_grad"]
t = shard_of(c["table"]).requires_grad_()
rows = par.alltoall_lookup(t, c["buckets"], c["inv"], mesh)
(rows * T(c["cot"])[i, j]).sum().backward()
out["alltoall_grad"] = col.all_reduce_sum([t.grad], data_group)[0].numpy()

c = inp["step"]
ut = shard_of(c["u_tab"]).requires_grad_()
it = shard_of(c["i_tab"]).requires_grad_()
b, dim, half = c["b"], c["u_tab"].shape[1], c["b"] // 2
u = par.gathered_lookup(ut, c["ub"], c["uinv"], mesh)
vecs = par.gathered_lookup(it, c["ib"], c["iinv"], mesh)
zero = torch.zeros((half, 1))
loss = pairwise_log_loss(u, vecs[:half], vecs[half:], zero, zero)
(loss / 2).backward()                     # this data rank's half of the mean
gu, gi = col.all_reduce_sum([ut.grad, it.grad], data_group)
out["step"] = (col.all_reduce_sum([loss.detach() / 2], data_group)[0].item(),
               (ut - c["lr"] * gu).detach().numpy(),
               (it - c["lr"] * gi).detach().numpy())

pickle.dump(out, open(os.path.join(os.environ["CASES_OUT"],
                                   f"out-{dist.get_rank()}.pkl"), "wb"))
'''


def _table(v, d, seed=0):
    return np.random.default_rng(seed).normal(size=(v, d)).astype(
        np.float32)


@pytest.mark.parametrize("seed,n,shards,rows,cap", [
    (0, 64, 4, 32, None), (1, 37, 3, 20, 40), (2, 8, 8, 1, 8)])
def test_bucket_ids_equal_jax(seed, n, shards, rows, cap):
    ids = np.random.default_rng(seed).integers(0, shards * rows, n).astype(
        np.int32)
    for got, want in zip(tb.bucket_ids(ids, shards, rows, cap),
                         jb.bucket_ids(ids, shards, rows, cap)):
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
    buckets, inv = tb.bucket_ids(ids, shards, rows, cap)
    np.testing.assert_array_equal(buckets.reshape(-1)[inv], ids)


def test_bucket_batches_and_capacity_equal_jax():
    ids = np.random.default_rng(3).integers(0, 96, 64).astype(np.int32)
    for got, want in zip(tb.bucket_batch(ids, 4, 24, data_shards=2),
                         jb.bucket_batch(ids, 4, 24, data_shards=2)):
        np.testing.assert_array_equal(got, want)
    for got, want in zip(tb.bucket_batch_2d(ids, 4, 24, data_shards=2),
                         jb.bucket_batch_2d(ids, 4, 24, data_shards=2)):
        np.testing.assert_array_equal(got, want)
    for args in ((100, 4), (7, 3, 1.0), (4096, 8, 1.5)):
        assert tb.default_capacity(*args) == jb.default_capacity(*args)
    with pytest.raises(ValueError, match="overflow"):
        tb.bucket_ids(np.zeros(64, np.int32), 4, 32, capacity=16)


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("bucketed")
    mesh = make_mesh(data=2, model=4)
    rs = row_sharding(mesh)
    inp, ref = {}, {}

    v = pad_rows(100, 4)
    table = _table(v, 8)
    ids = np.random.default_rng(1).integers(0, 100, 32).astype(np.int32)
    buckets, inv = tb.bucket_batch(ids, 4, v // 4, data_shards=2)
    inp["gathered"] = dict(table=table, ids=ids, buckets=buckets, inv=inv)
    ref["gathered"] = np.asarray(gathered_lookup(
        jax.device_put(table, rs), jnp.asarray(buckets), jnp.asarray(inv),
        mesh))

    v = pad_rows(64, 4)
    table = _table(v, 4, seed=2)
    ids = np.asarray([3, 3, 10, 63, 0, 17, 31, 32], np.int32)
    buckets, inv = tb.bucket_batch(ids, 4, v // 4, data_shards=2)
    cot = np.random.default_rng(3).normal(size=(8, 4)).astype(np.float32)
    inp["gathered_grad"] = dict(table=table, buckets=buckets, inv=inv,
                                cot=cot)
    ref["gathered_grad"] = np.asarray(jax.grad(lambda t: jnp.vdot(
        gathered_lookup(t, jnp.asarray(buckets), jnp.asarray(inv), mesh),
        jnp.asarray(cot)))(jax.device_put(table, rs)))
    dense = np.zeros_like(table)
    np.add.at(dense, ids, cot)
    ref["gathered_grad_dense"] = dense

    v = pad_rows(96, 4)
    table = _table(v, 8, seed=4)
    ids = np.random.default_rng(5).integers(0, 96, 64).astype(np.int32)
    buckets, inv = tb.bucket_batch_2d(ids, 4, v // 4, data_shards=2)
    inp["alltoall"] = dict(table=table, buckets=buckets, inv=inv)
    ref["alltoall"] = np.asarray(alltoall_lookup(
        jax.device_put(table, rs), jnp.asarray(buckets), jnp.asarray(inv),
        mesh))
    ref["alltoall_dense"] = table[ids].reshape(2, 4, 8, 8)

    v = pad_rows(64, 4)
    table = _table(v, 4, seed=6)
    rng = np.random.default_rng(7)
    ids = rng.integers(0, 64, 32).astype(np.int32)
    buckets, inv = tb.bucket_batch_2d(ids, 4, v // 4, data_shards=2)
    cot = rng.normal(size=(2, 4, 4, 4)).astype(np.float32)
    inp["alltoall_grad"] = dict(table=table, buckets=buckets, inv=inv,
                                cot=cot)
    ref["alltoall_grad"] = np.asarray(jax.grad(lambda t: jnp.vdot(
        alltoall_lookup(t, jnp.asarray(buckets), jnp.asarray(inv), mesh),
        jnp.asarray(cot)))(jax.device_put(table, rs)))
    dense = np.zeros_like(table)
    np.add.at(dense, ids, cot.reshape(32, 4))
    ref["alltoall_grad_dense"] = dense

    # the BPR SGD step through the exchange (tests/test_bucketed.py:107)
    users, items, dim, b, lr = 24, 40, 4, 16, 0.1
    rng = np.random.default_rng(10)
    u_tab = _table(pad_rows(users, 4), dim, seed=11)
    i_tab = _table(pad_rows(items, 4), dim, seed=12)
    uid = rng.integers(0, users, size=(b,)).astype(np.int32)
    pid = rng.integers(0, items, size=(b,)).astype(np.int32)
    nid = rng.integers(0, items, size=(b,)).astype(np.int32)
    ub, uinv = tb.bucket_batch(uid, 4, u_tab.shape[0] // 4, data_shards=2)
    pn = np.concatenate([pid.reshape(2, b // 2), nid.reshape(2, b // 2)],
                        axis=1).reshape(-1)
    ib, iinv = tb.bucket_batch(pn, 4, i_tab.shape[0] // 4, data_shards=2)
    inp["step"] = dict(u_tab=u_tab, i_tab=i_tab, ub=ub, uinv=uinv, ib=ib,
                       iinv=iinv, b=b, lr=lr)

    def loss_fn(tabs):
        u = gathered_lookup(tabs[0], jnp.asarray(ub), jnp.asarray(uinv),
                            mesh)
        vecs = gathered_lookup(tabs[1], jnp.asarray(ib), jnp.asarray(iinv),
                               mesh)
        pv = vecs.reshape(2, b, dim)[:, :b // 2].reshape(b, dim)
        nv = vecs.reshape(2, b, dim)[:, b // 2:].reshape(b, dim)
        zero = jnp.zeros((b, 1))
        return pairwise_log_loss(u, pv, nv, zero, zero)

    loss, grads = jax.value_and_grad(loss_fn)(
        (jax.device_put(u_tab, rs), jax.device_put(i_tab, rs)))
    ref["step"] = (float(loss), u_tab - lr * np.asarray(grads[0]),
                   i_tab - lr * np.asarray(grads[1]))

    path = tmp / "in.pkl"
    with open(path, "wb") as f:
        pickle.dump(inp, f)
    spawn_local(WORKER, 8, timeout=180,
                env={"PYTHONPATH": REPO, "CASES_IN": str(path),
                     "CASES_OUT": str(tmp)})
    outs = []
    for r in range(8):
        with open(tmp / f"out-{r}.pkl", "rb") as f:
            outs.append(pickle.load(f))
    return inp, ref, outs


def test_gathered_lookup_equals_jax(run):
    inp, ref, outs = run
    c = inp["gathered"]
    for r, o in enumerate(outs):
        i = r // 4
        np.testing.assert_array_equal(o["gathered"],
                                      ref["gathered"][i * 16:(i + 1) * 16])
        np.testing.assert_array_equal(
            o["gathered"], c["table"][c["ids"][i * 16:(i + 1) * 16]])
        # the two explicit exchanges agree (tests/test_bucketed.py:169)
        np.testing.assert_array_equal(o["gathered"], o["masked"])


def test_gathered_lookup_gradient(run):
    _, ref, outs = run
    for data in range(2):
        got = np.concatenate([outs[data * 4 + j]["gathered_grad"]
                              for j in range(4)])
        np.testing.assert_allclose(got, ref["gathered_grad_dense"],
                                   rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(got, ref["gathered_grad"], rtol=1e-6,
                                   atol=1e-6)


def test_alltoall_lookup_equals_jax(run):
    _, ref, outs = run
    for r, o in enumerate(outs):
        i, j = divmod(r, 4)
        np.testing.assert_array_equal(o["alltoall"], ref["alltoall"][i, j])
        np.testing.assert_array_equal(o["alltoall"],
                                      ref["alltoall_dense"][i, j])


def test_alltoall_lookup_gradient(run):
    _, ref, outs = run
    for data in range(2):
        got = np.concatenate([outs[data * 4 + j]["alltoall_grad"]
                              for j in range(4)])
        np.testing.assert_allclose(got, ref["alltoall_grad_dense"],
                                   rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(got, ref["alltoall_grad"], rtol=1e-6,
                                   atol=1e-6)


def test_bucketed_sgd_step_equals_jax(run):
    _, ref, outs = run
    loss, u_new, i_new = ref["step"]
    for r, o in enumerate(outs):
        j = r % 4
        np.testing.assert_allclose(o["step"][0], loss, rtol=1e-6)
        nu, ni = u_new.shape[0] // 4, i_new.shape[0] // 4
        np.testing.assert_allclose(o["step"][1], u_new[j * nu:(j + 1) * nu],
                                   rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(o["step"][2], i_new[j * ni:(j + 1) * ni],
                                   rtol=1e-5, atol=1e-6)
