"""ParallelTrainer: the Trainer harness over a ('data', 'model') mesh.

Counterpart of `openrec_tpu/training/parallel_trainer.py`. One instance
per rank: every rank draws the same seeded batch stream, passes the
GLOBAL batch and steps on its data slice of it (`parallel/train.py`);
embedding tables row-shard over 'model' (`DEFAULT_RULES`), so each rank's
model holds its rows; checkpoints write per-rank pieces with a manifest
(`parallel/checkpoint.py`) and restore into any mesh layout, the JAX
package's included. The iteration loop, interval eval / save, K-step
calls and on-device sampling are the Trainer's.

The loss draws from `self.generator`, seeded `seed` alike on every rank
(JAX's r_loss): inside the step a draw takes the global batch's shape and
each rank keeps its rows (`modules/global_batch.py`), so the masks and
sampled candidates are those of one program over the global batch.
`train_steps_device` draws each data rank's slice from
`self.rank_generator`, seeded `fold_in(seed, data rank)`
(`rank_generator`, JAX's r_sample folded with the shard index), which
only samples.

`tables()` gives the model's views of its row-sharded tables
(`parallel.table_views`): `train(update_interval=)` hands them to
ItrMLP's `update_embeddings` by default, and a rank serves its shard
with `model.serving_tables(trainer.tables())`.

Differences from the JAX package's, by design of the one-process-per-rank
layout: `evaluate` and `evaluate_temporal` run the whole eval stream on
every rank, with the row-sharded leaves all_gathered for the duration,
pad rows cut off (`full_params`); console and JSONL lines come from rank
0 only.
"""

from __future__ import annotations

import os
from typing import Optional

import torch
import torch.distributed as dist

from openrec_tpu_torch.convert import flatten_tree
from openrec_tpu_torch.parallel import checkpoint as pc
from openrec_tpu_torch.parallel.mesh import (DEFAULT_RULES, mesh_device,
                                             replicated)
from openrec_tpu_torch.parallel.train import (
    full_params, gather_batch, make_parallel_sparse_train_step,
    make_parallel_train_step, rank_generator, shared_generator, table_views)
from openrec_tpu_torch.training.optim import lazy_adam
from openrec_tpu_torch.training.trainer import Trainer


def _path_repr(name: str) -> str:
    """'embed_tables/3' -> "('embed_tables', 3)": how a sparse state's
    tuple key appears in a flattened path."""
    return repr(tuple(int(p) if p.isdigit() else p
                      for p in name.split("/")))


class ParallelTrainer(Trainer):

    def __init__(self, model, mesh, optimizer=None, lr: float = 1e-3,
                 seed: int = 0, save_model_dir: Optional[str] = None,
                 init_model_dir: Optional[str] = None,
                 max_to_keep: int = 10, log_file: Optional[str] = None,
                 sparse_tables=None, rules=None):
        """model: a Recommender whose (full) parameters lie on the mesh's
        device; this trainer shards them in place. mesh: `make_mesh(...)`.
        The other arguments are the Trainer's; `rules` the placement rules
        (default DEFAULT_RULES, () replicates everything)."""
        self.device = mesh_device(mesh)
        for name, p in model.named_parameters():
            if p.device != self.device:
                raise ValueError(f"parameter '{name}' lies on {p.device}, "
                                 f"the mesh runs on {self.device}")
        self.model = model
        self.mesh = mesh
        self.rules = DEFAULT_RULES if rules is None else rules
        self.lr = lr
        self.tx = optimizer if optimizer is not None else lazy_adam(lr)
        # the loss's draws (alike on every rank) / this rank's sampling
        self.generator = shared_generator(seed, mesh)
        self.rank_generator = rank_generator(seed, mesh)
        self.save_model_dir = save_model_dir
        self.max_to_keep = max_to_keep
        self.log_file = log_file
        self.sparse_tables = sparse_tables
        if sparse_tables is not None:
            self._step, init_fn = make_parallel_sparse_train_step(
                model, sparse_tables, mesh, rules=self.rules,
                learning_rate=lr, dense_tx=optimizer)
        else:
            self._step, init_fn = make_parallel_train_step(
                model, self.tx, mesh, rules=self.rules)
        _, self.opt_state, self.shardings = init_fn()
        if init_model_dir is not None:
            self._warm_start(init_model_dir)
        self.global_step = 0

    @property
    def rank(self) -> int:
        return dist.get_rank()

    def tables(self) -> dict:
        """{name: ShardedTable} of the model's row-sharded tables on this
        rank (empty at one model rank)."""
        return table_views(self.model, self.shardings, self.mesh)

    # ------------------------------------------------------------------ #

    def _step_body(self, batch: dict):
        """One step on the GLOBAL batch (device tensors): this rank takes
        its slice; loss and aux are the global batch's."""
        if self.sparse_tables is not None:
            self.opt_state, loss = self._step(self.opt_state, batch,
                                              self.generator)
            return loss, {"loss": loss}
        self.opt_state, loss, aux = self._step(self.opt_state, batch,
                                               self.generator)
        return loss, aux

    def train_steps_device(self, sampler, k: int, fused: bool = True):
        """K steps with on-device sampling: each data rank draws its slice
        of every step's batch (sampler.batch_size examples) from its own
        generator, so the global batch is batch_size * d; the loss draws
        from the shared one. `fused` exists for the Trainer's signature;
        every step samples its own batch."""
        del fused
        losses = []
        for _ in range(k):
            local = sampler.sample(self.rank_generator)
            out = self._step.local_step(self.opt_state, local,
                                        gather_batch(local, self.mesh),
                                        self.generator)
            self.opt_state, loss = out[0], out[1]
            losses.append(loss)
        self.global_step += k
        return torch.stack(losses)

    # ------------------------------------------------------------------ #

    def evaluate(self, eval_sampler, *args, **kwargs) -> dict:
        """The Trainer's evaluate over the whole eval stream on every rank,
        the row-sharded leaves all_gathered for its duration."""
        with full_params(self.model, self.shardings, self.mesh):
            return super().evaluate(eval_sampler, *args, **kwargs)

    def evaluate_temporal(self, eval_sampler, *args, **kwargs) -> dict:
        """The Trainer's next-item evaluation, as `evaluate`."""
        with full_params(self.model, self.shardings, self.mesh):
            return super().evaluate_temporal(eval_sampler, *args, **kwargs)

    def _log(self, msg, color=None):
        if self.rank == 0:
            super()._log(msg, color)

    def _log_jsonl(self, record: dict):
        if self.rank == 0:
            super()._log_jsonl(record)

    # ------------------------------------------------------------------ #

    def _tree_shardings(self, tree) -> dict:
        """{flat key: Sharding}: a parameter's, for the parameter and for
        the optimizer leaves that follow it (same name, same shape); the
        rest replicate."""
        params = self.params
        out = {}
        for key, leaf in flatten_tree(tree).items():
            out[key] = replicated(self.mesh, tuple(leaf.shape))
            for name, sh in self.shardings.items():
                if (key.endswith("/" + name)
                        or key.endswith("/" + _path_repr(name))) \
                        and tuple(leaf.shape) == tuple(params[name].shape):
                    out[key] = sh
                    break
        return out

    def _state_tree(self):
        return {"params": {k: v.detach() for k, v in self.params.items()},
                "opt_state": self.opt_state}

    def _warm_start(self, init_model_dir):
        step = pc.latest_step(init_model_dir)
        if step is None:
            return
        step_dir = os.path.join(init_model_dir, f"ckpt-{step}")
        tree = {"params": self._state_tree()["params"]}
        tree = pc.restore_sharded(step_dir, tree, self._tree_shardings(tree),
                                  optimistic=True)
        self.model.load_params(tree["params"])
        self._log(f"warm-started from {step_dir}")

    def save(self, step: Optional[int] = None):
        if not self.save_model_dir:
            raise ValueError("save_model_dir not set")
        tree = self._state_tree()
        return pc.save_sharded(
            self.save_model_dir,
            step if step is not None else self.global_step, tree,
            self._tree_shardings(tree), max_to_keep=self.max_to_keep)

    def restore(self, path: Optional[str] = None, optimistic: bool = False):
        """Load params and optimizer state from a step directory (default:
        the latest in save_model_dir), written by either package under any
        mesh layout."""
        if path is None:
            step = pc.latest_step(self.save_model_dir)
            if step is None:
                raise FileNotFoundError(
                    f"no checkpoint found in {self.save_model_dir!r}")
            path = os.path.join(self.save_model_dir, f"ckpt-{step}")
        tree = self._state_tree()
        tree = pc.restore_sharded(path, tree, self._tree_shardings(tree),
                                  optimistic=optimistic)
        self.model.load_params(tree["params"])
        self.opt_state = tree["opt_state"]
        return path

