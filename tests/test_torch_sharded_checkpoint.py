"""Port parity, per-rank checkpoints (`parallel/checkpoint.py`) in the JAX
package's on-disk format (tests/test_sharded_checkpoint.py): save under
one mesh layout and restore under another, bit for bit; a checkpoint
written by the JAX package restores in the port and one written by the
port restores in the JAX package, each into another layout; a replicated
leaf is written once; optimistic partial restore and the missing-key
error; `max_to_keep` pruning; a grown table falls back to the template.

The port's ranks are one launch of 8 gloo processes (`python -c WORKER`,
which never imports JAX); the JAX side runs on its 8 CPU devices.
"""

import json
import os
import pickle

import jax
import numpy as np
import pytest
from jax.sharding import PartitionSpec as P

from openrec_tpu.parallel import checkpoint as jpck
from openrec_tpu.parallel.mesh import make_mesh, match_partition_rules
from openrec_tpu_torch.parallel.launch import spawn_local

pytestmark = pytest.mark.skipif(len(jax.devices()) < 8,
                                reason="needs 8 virtual devices")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JRULES = ((r"item_embed|item_bias", P("model", None)),
          (r"user_embed", P("data", None)))

WORKER = r'''
import os, pickle
import numpy as np
import torch
torch.set_num_threads(1)
import torch.distributed as dist
from openrec_tpu_torch import parallel as par
from openrec_tpu_torch.parallel import checkpoint as pck

inp = pickle.load(open(os.environ["CASES_IN"], "rb"))
root = os.environ["CASES_OUT"]
RULES = ((r"item_embed|item_bias", ("model", None)),
         (r"user_embed", ("data", None)))
out = {}


def place(params, mesh):
    local, sh = par.shard_params({k: torch.as_tensor(v)
                                  for k, v in params.items()}, mesh, RULES)
    return local, sh


def np_of(tree):
    return {k: v.numpy().copy() for k, v in tree.items()}


mesh_a = par.make_mesh(2, 4, device="cpu")
mesh_b = par.make_mesh(4, 2, device="cpu")
mesh_r = par.make_mesh(8, 1, device="cpu")
rank = dist.get_rank()

# save under 2 x 4, restore under 4 x 2
params = inp["params"]
local_a, sh_a = place(params, mesh_a)
pck.save_sharded(os.path.join(root, "port"), 7, local_a, sh_a)
out["latest"] = pck.latest_step(os.path.join(root, "port"))
zeros = {k: np.zeros_like(v) for k, v in params.items()}
tmpl_b, sh_b = place(zeros, mesh_b)
out["restored_b"] = np_of(pck.restore_sharded(
    os.path.join(root, "port", "ckpt-7"), tmpl_b, sh_b))
out["block_b"] = {k: [[s.start, s.stop] for s in sh_b[k].block(
    sh_b[k].global_shape(tuple(tmpl_b[k].shape)))] for k in tmpl_b}

# the JAX package's checkpoint into the port, under 4 x 2 and 1 x 8
out["from_jax_b"] = np_of(pck.restore_sharded(inp["jax_dir"], tmpl_b, sh_b))
mesh_c = par.make_mesh(1, 8, device="cpu")
tmpl_c, sh_c = place(zeros, mesh_c)
out["from_jax_c"] = np_of(pck.restore_sharded(inp["jax_dir"], tmpl_c, sh_c))

# a replicated leaf is written once
local_r, sh_r = place(params, mesh_r)
pck.save_sharded(os.path.join(root, "repl"), 1, local_r, sh_r)
out["restored_r"] = np_of(pck.restore_sharded(
    os.path.join(root, "repl", "ckpt-1"), local_r, sh_r))

# optimistic restore and the missing key
saved = {k: v for k, v in local_a.items() if k != "user_embed"}
pck.save_sharded(os.path.join(root, "opt"), 3, saved,
                 {k: sh_a[k] for k in saved})
tmpl = dict(local_a, user_embed=torch.full_like(local_a["user_embed"], 9.0))
try:
    pck.restore_sharded(os.path.join(root, "opt", "ckpt-3"), tmpl, sh_a)
    out["missing_raises"] = False
except KeyError:
    out["missing_raises"] = True
out["optimistic"] = np_of(pck.restore_sharded(
    os.path.join(root, "opt", "ckpt-3"), tmpl, sh_a, optimistic=True))

# max_to_keep prunes step directories
for step in range(5):
    pck.save_sharded(os.path.join(root, "prune"), step, local_r, sh_r,
                     max_to_keep=2)
out["pruned"] = pck.sorted_steps(os.path.join(root, "prune"))

# a grown catalog keeps the template's table under optimistic
bigger, sh_big = place(inp["bigger"], mesh_a)
out["grown"] = np_of(pck.restore_sharded(
    os.path.join(root, "port", "ckpt-7"), bigger, sh_big, optimistic=True))
out["grown_template"] = np_of(bigger)

pickle.dump(out, open(os.path.join(root, f"out-{rank}.pkl"), "wb"))
'''


def _params(num_items=40, num_users=24, d=8, seed=0):
    rng = np.random.default_rng(seed)
    return {
        "item_embed": rng.normal(size=(num_items, d)).astype(np.float32),
        "item_bias": rng.normal(size=(num_items, 1)).astype(np.float32),
        "user_embed": rng.normal(size=(num_users, d)).astype(np.float32),
        "step_scale": np.float32(0.5),
    }


def _jplace(params, mesh):
    shardings = match_partition_rules(JRULES, params, mesh)
    return jax.tree_util.tree_map(jax.device_put, params, shardings)


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("ckpt")
    params = _params()
    jax_dir = jpck.save_sharded(str(tmp / "jax"), 5,
                                _jplace(params, make_mesh(data=2, model=4)))
    inp = dict(params=params, jax_dir=jax_dir,
               bigger=_params(num_items=72, seed=1))
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
    return tmp, params, outs


def _block(full, block):
    return full[tuple(slice(a, b) for a, b in block)]


def test_save_restore_different_mesh(run):
    _, params, outs = run
    for o in outs:
        assert o["latest"] == 7
        for k, v in o["restored_b"].items():
            np.testing.assert_array_equal(
                v, _block(np.asarray(params[k]), o["block_b"][k]))


def test_jax_checkpoint_restores_in_port(run):
    _, params, outs = run
    for o in outs:
        for k, v in o["from_jax_b"].items():
            np.testing.assert_array_equal(
                v, _block(np.asarray(params[k]), o["block_b"][k]))
    # 1 x 8: items split 8 ways, users whole
    for r, o in enumerate(outs):
        got = o["from_jax_c"]
        np.testing.assert_array_equal(got["item_embed"],
                                      params["item_embed"][r * 5:r * 5 + 5])
        np.testing.assert_array_equal(got["user_embed"],
                                      params["user_embed"])


def test_port_checkpoint_restores_in_jax(run):
    tmp, params, _ = run
    step_dir = str(tmp / "port" / "ckpt-7")
    with open(os.path.join(step_dir, "manifest.json")) as f:
        manifest = json.load(f)
    assert manifest["process_count"] == 8
    mesh = make_mesh(data=4, model=2)
    template = jax.tree_util.tree_map(np.asarray, params)
    shardings = match_partition_rules(JRULES, template, mesh)
    restored = jpck.restore_sharded(step_dir, template, shardings)
    for k in params:
        np.testing.assert_array_equal(np.asarray(restored[k]),
                                      np.asarray(params[k]))
        assert restored[k].sharding.mesh.shape == dict(mesh.shape)


def test_replicated_leaf_written_once(run):
    tmp, params, outs = run
    pieces = []
    for r in range(8):
        with np.load(tmp / "repl" / "ckpt-1" / f"shard-{r}.npz") as npz:
            pieces += json.loads(bytes(npz["__pieces__"]).decode())
    assert sum(p["key"] == "step_scale" for p in pieces) == 1
    assert sum(p["key"] == "item_embed" for p in pieces) == 1
    assert sum(p["key"] == "user_embed" for p in pieces) == 8
    for o in outs:
        assert float(o["restored_r"]["step_scale"]) == 0.5


def test_optimistic_restore_and_missing_key(run):
    _, params, outs = run
    for r, o in enumerate(outs):
        assert o["missing_raises"]
        np.testing.assert_array_equal(o["optimistic"]["user_embed"], 9.0)
        j = r % 4
        np.testing.assert_array_equal(o["optimistic"]["item_embed"],
                                      params["item_embed"][j * 10:j * 10 + 10])


def test_max_to_keep_prunes(run):
    _, _, outs = run
    assert all(o["pruned"] == [3, 4] for o in outs)


def test_grown_catalog_keeps_template(run):
    _, params, outs = run
    for r, o in enumerate(outs):
        np.testing.assert_array_equal(o["grown"]["item_embed"],
                                      o["grown_template"]["item_embed"])
        i = r // 4                      # user_embed splits over 'data'
        np.testing.assert_array_equal(o["grown"]["user_embed"],
                                      params["user_embed"][i * 12:i * 12 + 12])
