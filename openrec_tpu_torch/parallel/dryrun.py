"""Multi-rank dry run: one full DLRM training step over an n-rank mesh.

Counterpart of `__graft_entry__.dryrun_multichip` (`__graft_entry__.py:
37-100`): a (n/2 x 2) mesh (n x 1 for odd n) with the batch split over
'data' and every embedding table row-sharded over 'model'; it asserts
that each rank's tables, batch slice and optimizer moments hold exactly
1/axis-size of the rows before and after the step, then drives the
explicit exchange (`sharded_lookup`, `sharded_scores`, `sharded_topk`)
on a BPR-shaped table when 'model' has more than one rank.

  python -m openrec_tpu_torch.parallel.dryrun 8 --device cpu   # 8 gloo ranks
  torchrun --nproc-per-node 8 -m openrec_tpu_torch.parallel.dryrun 8
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch
import torch.distributed as dist

from openrec_tpu_torch.models import DLRM
from openrec_tpu_torch.parallel.embedding import (pad_rows, sharded_lookup,
                                                  sharded_scores,
                                                  sharded_topk)
from openrec_tpu_torch.parallel.launch import spawn_local
from openrec_tpu_torch.parallel.mesh import (DATA_AXIS, MODEL_AXIS,
                                             axis_index, axis_size,
                                             make_mesh, mesh_device)
from openrec_tpu_torch.parallel.train import (data_slice,
                                              make_parallel_train_step)
from openrec_tpu_torch.training.optim import lazy_adam


def _assert_split(local_rows: int, global_rows: int, n: int, what: str):
    """Fail unless this rank holds exactly global/n rows (per-rank work
    scales 1/n, nothing is replicated by mistake)."""
    assert local_rows * n == global_rows, \
        f"{what}: holds {local_rows} rows, want {global_rows}//{n}"


def _rank_body(n_devices: int, device) -> None:
    model_axis = 2 if n_devices % 2 == 0 else 1
    mesh = make_mesh(n_devices // model_axis, model_axis, device=device)
    d, m = axis_size(mesh, DATA_AXIS), axis_size(mesh, MODEL_AXIS)
    dev = mesh_device(mesh)
    ln_emb = (64,) * 4 + (256,) * 2
    model = DLRM(m_spa=8, ln_emb=ln_emb, ln_bot=(16, 8), ln_top=(32, 1),
                 dim_dense=4, loss_func="bce", device=dev,
                 generator=torch.Generator(device=dev).manual_seed(0))
    step_fn, init_fn = make_parallel_train_step(model, lazy_adam(1e-3), mesh)
    params, opt_state, _ = init_fn()
    B = 8 * n_devices
    rng = np.random.default_rng(0)        # the same global batch everywhere
    batch = {k: torch.as_tensor(v, device=dev) for k, v in {
        "dense_features": rng.normal(size=(B, 4)).astype(np.float32),
        "sparse_features": rng.integers(0, 64, size=(B, 6)).astype(np.int32),
        "label": rng.integers(0, 2, size=(B,)).astype(np.float32)}.items()}
    _assert_split(data_slice(batch, mesh)["dense_features"].shape[0], B, d,
                  "batch")
    for i, rows in enumerate(ln_emb):
        _assert_split(params[f"embed_tables/{i}"].shape[0], rows, m,
                      f"embed_tables[{i}]")
        for part in ("mu", "nu"):
            _assert_split(getattr(opt_state, part)[f"embed_tables/{i}"]
                          .shape[0], rows, m, f"{part} embed_tables[{i}]")
    opt_state, loss, _ = step_fn(opt_state, batch)
    assert torch.isfinite(loss), float(loss)
    for i, rows in enumerate(ln_emb):
        _assert_split(model.params()[f"embed_tables/{i}"].shape[0], rows, m,
                      f"updated embed_tables[{i}]")
    if m > 1:
        I, D = pad_rows(1000, m), 16
        table = torch.as_tensor(rng.normal(size=(I, D)).astype(np.float32))
        j = axis_index(mesh, MODEL_AXIS)
        shard = table[j * I // m:(j + 1) * I // m].to(dev)
        _assert_split(shard.shape[0], I, m, "retrieval table")
        ids = torch.as_tensor(rng.integers(0, 1000, B), device=dev)
        rows = sharded_lookup(shard, ids, mesh)
        assert torch.equal(rows.cpu(), table[ids.cpu()])
        users = torch.as_tensor(rng.normal(size=(B, D)).astype(np.float32),
                                device=dev)
        vals, idx = sharded_topk(sharded_scores(users, shard, None, mesh),
                                 10, mesh)
        assert vals.shape == (B, 10) and idx.shape == (B, 10)
    print(f"rank {dist.get_rank()}: {d}x{m} mesh, loss {float(loss):.6f}; "
          "dryrun ok", flush=True)


def dryrun_multichip(n_devices: int, device=None, timeout: float = 300.0):
    """Run the dry run on n ranks: inside a job of n ranks, this rank's
    part; otherwise n local processes (`spawn_local`), whose outputs it
    returns. Raises without CUDA unless device="cpu"."""
    if dist.is_initialized():
        _rank_body(n_devices, device)
        return None
    code = ("from openrec_tpu_torch.parallel.dryrun import _rank_body; "
            f"_rank_body({int(n_devices)}, {device!r})")
    return spawn_local(code, n_devices, timeout=timeout)


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("n", type=int)
    ap.add_argument("--device", default=None)
    args = ap.parse_args()
    if "RANK" in os.environ:
        _rank_body(args.n, args.device)
    else:
        print("".join(dryrun_multichip(args.n, args.device)), end="")
