"""Distributed train / eval step builders over a ('data', 'model') mesh.

Counterpart of `openrec_tpu/parallel/train.py`. The JAX step is one GSPMD
program over the GLOBAL batch; here every rank runs the same step on its
data slice of it, and computes what that program computes:

  - every leaf a rule shards over 'model' (`DEFAULT_RULES`: the tables)
    holds this rank's rows (`mesh.shard_model`), padded with zero rows
    where the table does not split evenly, and the model reaches it
    through a `ShardedTable` view (`table_views`) that knows the table's
    real rows: in its loss (`model.loss(batch, tables=...)`: lookups, the
    sequence models' vocabulary-parallel or sampled softmax), in its
    `post_step` (censoring touches the ids in this rank's rows) and in
    ItrMLP's `update_embeddings` (its batch norm over the real rows of
    the whole table); dense towers stay whole on every rank;
  - the loss runs inside a data-parallel context (`modules/global_batch`,
    entered at more than one data rank): a random draw inside it (a
    dropout or corruption mask) is this slice's rows of the draw over the
    global batch, and a batch norm takes the global batch's mean and
    variance through a differentiable sum over 'data';
  - the loss of the slice is scaled so that its gradients, summed over
    'data', are the global batch's (`data_parallel_objective`: the terms
    the model sums over its examples by 1, its batch means and its terms
    independent of the batch by B_local / B, as `Recommender.batch_sums`
    splits them; a model that declares no `loss_reduction` is refused at
    more than one data rank); the gradients are summed over 'data' in one
    all_reduce, and `grad_transform` sees the global batch;
  - optimizer moments are made from the local leaves, so they follow
    their parameter's rows;
  - the sparse step dedups the ids of the GLOBAL batch, so that each row
    takes one Adam step on the whole batch's gradient as in the GSPMD
    program; each rank writes back only the rows it holds
    (`MeshRowLayout`);
  - the device-sampled builders draw each data rank's slice from its own
    generator, seeded by `fold_in(seed, data rank)` (JAX's r_sample
    folded with the shard index), and pass the loss a generator that
    every rank seeds alike (`shared_generator`, JAX's r_loss), so that
    the loss's draws, the sampled softmax's candidates included, are
    those of one program over the global batch.

Every builder returns the loss of the global batch, the same on every
rank. `post_step` reads the global batch, so every model rank does the
same on the rows it holds. At one model rank no view is made: every
table is whole and the model reads its parameters.
"""
from __future__ import annotations

from contextlib import contextmanager

import torch

from openrec_tpu_torch.metrics.ranking import ranking_metrics
from openrec_tpu_torch.models.base import Recommender
from openrec_tpu_torch.modules.global_batch import data_parallel
from openrec_tpu_torch.parallel import collectives as col
from openrec_tpu_torch.parallel.embedding import ShardedTable
from openrec_tpu_torch.parallel.mesh import (DATA_AXIS, DEFAULT_RULES,
                                             MODEL_AXIS, axis_group,
                                             axis_index, axis_size,
                                             mesh_device, shard_model)
from openrec_tpu_torch.training.optim import apply_updates
from openrec_tpu_torch.training.sparse import (RowLayout,
                                               make_sparse_train_step,
                                               post_step)


def fold_in(seed: int, index: int) -> int:
    """A seed for stream `index` of `seed` (jax.random.fold_in's role):
    a splitmix64 mix, so that streams of nearby seeds and indices share
    nothing."""
    z = (int(seed) * 0x9E3779B97F4A7C15 + int(index) + 1) % 2 ** 64
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) % 2 ** 64
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) % 2 ** 64
    return (z ^ (z >> 31)) % 2 ** 63


def rank_generator(seed: int, mesh, device=None) -> torch.Generator:
    """This data rank's sampling generator: seeded fold_in(seed, rank) on
    the mesh's device; the ranks of one 'data' row share it."""
    dev = mesh_device(mesh) if device is None else torch.device(device)
    return torch.Generator(device=dev).manual_seed(
        fold_in(seed, axis_index(mesh, DATA_AXIS)))


def shared_generator(seed: int, mesh, device=None) -> torch.Generator:
    """The generator a data-parallel loss draws from (JAX's r_loss):
    seeded `seed` on the mesh's device, alike on every rank."""
    dev = mesh_device(mesh) if device is None else torch.device(device)
    return torch.Generator(device=dev).manual_seed(int(seed))


@contextmanager
def global_batch_of(mesh, batch: dict):
    """Inside: the loss's draws and batch norms take the global `batch`
    (`modules/global_batch.py`), of which this rank holds its data slice.
    At one data rank nothing changes."""
    d = axis_size(mesh, DATA_AXIS)
    if d == 1:
        yield
        return
    group = axis_group(mesh, DATA_AXIS)
    rows = next(iter(batch.values())).shape[0]
    with data_parallel(
            d, axis_index(mesh, DATA_AXIS), rows,
            lambda x: col.data_sum(x, group)):
        yield


def data_slice(batch: dict, mesh) -> dict:
    """This rank's contiguous slice of a global batch's leading dim."""
    d, i = axis_size(mesh, DATA_AXIS), axis_index(mesh, DATA_AXIS)
    out = {}
    for k, v in batch.items():
        n = v.shape[0]
        if n % d:
            raise ValueError(f"batch '{k}' of {n} does not split over "
                             f"{d} data ranks")
        out[k] = v[i * (n // d):(i + 1) * (n // d)]
    return out


def gather_batch(batch: dict, mesh) -> dict:
    """The global batch from every data rank's slice (concatenated in data
    order, as JAX's P('data') sampling lays it out)."""
    group = axis_group(mesh, DATA_AXIS)
    return {k: col.all_gather(v, group) for k, v in batch.items()}


def _slice_part(value, summed, frac: float):
    """This slice's share of a term of the global batch's loss: its sum
    part whole, the rest by `frac`."""
    if summed is value:
        return value
    return value * frac if summed is None else \
        value * frac + summed * (1.0 - frac)


def data_parallel_objective(model, total, aux, frac: float):
    """The part of the global batch's loss this data slice owns, so that
    the slices' gradients add up to the global batch's: the part of the
    loss that sums over examples (`model.batch_sums`) whole, the batch
    means and the terms independent of the batch by `frac`, this slice's
    share of the batch. At frac 1 the loss itself."""
    if frac == 1.0:
        return total
    return _slice_part(total, model.batch_sums(total, aux).get("total"),
                       frac)


def _sharded_names(shardings: dict) -> list:
    return [n for n, sh in shardings.items()
            if sh.spec and sh.spec[0] == MODEL_AXIS]


def _check_model(model, mesh):
    if axis_size(mesh, DATA_AXIS) > 1 and model.loss_reduction is None \
            and type(model).batch_sums is Recommender.batch_sums:
        raise NotImplementedError(
            f"{type(model).__name__} declares no loss_reduction, so its loss "
            "does not split over data ranks; use a mesh of one data rank")


def table_views(model, shardings: dict, mesh) -> dict:
    """{name: ShardedTable} of the model's leaves sharded over 'model':
    this rank's rows, with the table's real row count. Empty at one model
    rank, where every leaf is whole."""
    if axis_size(mesh, MODEL_AXIS) == 1:
        return {}
    params = model.params()
    return {n: ShardedTable(params[n], mesh, shardings[n].shape[0])
            for n in _sharded_names(shardings)}


@contextmanager
def full_params(model, shardings: dict, mesh):
    """Inside: the model's row-sharded leaves are whole (all_gathered over
    'model', the pad rows cut off); after: its shards again. For scoring
    with `model.score`."""
    group = axis_group(mesh, MODEL_AXIS)
    swapped = {}
    params = model.params()
    with torch.no_grad():
        for name in _sharded_names(shardings):
            p = params[name]
            swapped[name] = p.data
            p.data = col.all_gather(p.data, group)[:shardings[name].shape[0]]
    try:
        yield model
    finally:
        for name, data in swapped.items():
            params[name].data = data


def _reduce_data(grads: list, mesh) -> list:
    return col.all_reduce_sum(grads, axis_group(mesh, DATA_AXIS))


class MeshRowLayout(RowLayout):
    """The sparse step's rows on a mesh: a table sharded over 'model' holds
    rows [shard * n, (shard + 1) * n) here; gathers are masked and summed
    over 'model', gradients summed over 'data'."""

    def __init__(self, mesh, shardings: dict):
        self.mesh = mesh
        self.shardings = shardings
        self.sharded_names = set(_sharded_names(shardings))
        self.frac = 1.0 / axis_size(mesh, DATA_AXIS)
        self.shard = axis_index(mesh, MODEL_AXIS)

    def sharded(self, name):
        return name in self.sharded_names

    def shard_range(self, name, table):
        n = table.shape[0]
        return (self.shard * n if self.sharded(name) else 0), n

    def gather(self, name, table, uids, masked=False):
        rows = super().gather(name, table, uids, masked)
        if not self.sharded(name):
            return rows
        return col.all_reduce_sum([rows],
                                  axis_group(self.mesh, MODEL_AXIS))[0]

    def reduce(self, grads):
        return _reduce_data(grads, self.mesh)

    def views(self, model):
        return table_views(model, self.shardings, self.mesh)

    def objective(self, model, total, aux):
        return data_parallel_objective(model, total, aux, self.frac)


def _dense_step(model, tx, mesh, shardings, opt_state, generator, local,
                global_batch):
    """One data-parallel step on this rank's slice; returns the new state
    and the global batch's loss and aux (detached, the same on every
    rank)."""
    frac = 1.0 / axis_size(mesh, DATA_AXIS)
    params = model.params()
    names = list(params)
    views = table_views(model, shardings, mesh)
    with global_batch_of(mesh, global_batch):
        total, aux = model.loss(local, tables=views or None,
                                generator=generator)
    # (before the update: a term such as GMF's MLP L2 reads the weights)
    sums = {} if frac == 1.0 else model.batch_sums(total, aux)
    objective = _slice_part(total, sums.get("total"), frac)
    grads = torch.autograd.grad(objective, [params[n] for n in names],
                                allow_unused=True)
    grads = _reduce_data([torch.zeros_like(params[n]) if g is None else g
                          for n, g in zip(names, grads)], mesh)
    grads = model.grad_transform(dict(zip(names, grads)), global_batch)
    with torch.no_grad():
        updates, opt_state = tx.update(grads, opt_state, params)
        apply_updates(params, updates)
        post_step(model, global_batch, views)
    parts = _reduce_data(
        [objective.detach()] + [_slice_part(v, sums.get(k), frac).detach()
                                for k, v in aux.items()], mesh)
    return opt_state, parts[0], dict(zip(aux, parts[1:]))


def make_parallel_train_step(model, tx, mesh, rules=DEFAULT_RULES):
    """Returns (step_fn, init_fn).

    init_fn() -> (params, opt_state, shardings): shards the model's own
    parameters in place (`shard_model`) and makes tx's state from them.
    step_fn(opt_state, batch, generator=None) -> (opt_state, loss, aux):
    `batch` is the GLOBAL batch (every rank passes the same); this rank
    steps on its data slice. loss and aux are the global batch's.
    `generator` feeds the loss's draws; every rank seeds it alike."""
    shardings = {}

    def init_fn():
        shardings.update(shard_model(model, mesh, rules))
        _check_model(model, mesh)
        return model.params(), tx.init(model.params()), dict(shardings)

    def local_step(opt_state, local: dict, global_batch: dict, generator):
        return _dense_step(model, tx, mesh, shardings, opt_state, generator,
                           local, global_batch)

    def step_fn(opt_state, batch: dict, generator=None):
        batch = {k: torch.as_tensor(v, device=mesh_device(mesh))
                 for k, v in batch.items()}
        return local_step(opt_state, data_slice(batch, mesh), batch,
                          generator)

    # (opt_state, this rank's slice, the global batch, the loss's shared
    # generator): make_parallel_device_train_step and ParallelTrainer feed
    # it directly
    step_fn.local_step = local_step
    return step_fn, init_fn


def make_parallel_device_train_step(model, tx, mesh, sampler,
                                    steps_per_call: int = 1,
                                    rules=DEFAULT_RULES):
    """Data parallelism with ON-DEVICE sampling: each data rank draws its
    own slice from its own generator (`rank_generator`), so the global
    batch is batch_size * d and no batch crosses the host.

    Returns (step_fn, init_fn): init_fn as `make_parallel_train_step`'s;
    step_fn(opt_state, generator, loss_generator=None) -> (opt_state,
    losses[k]): `generator` this rank's (`rank_generator(seed, mesh)`),
    for sampling only; `loss_generator` the loss's, seeded alike on every
    rank (`shared_generator(seed, mesh)`). Without it the loss draws
    nothing, as the host-fed step's without a generator."""
    step, init_fn = make_parallel_train_step(model, tx, mesh, rules)

    def step_fn(opt_state, generator: torch.Generator,
                loss_generator: torch.Generator | None = None):
        losses = []
        for _ in range(steps_per_call):
            local = sampler.sample(generator)
            opt_state, loss, _ = step.local_step(
                opt_state, local, gather_batch(local, mesh), loss_generator)
            losses.append(loss)
        return opt_state, torch.stack(losses)

    return step_fn, init_fn


def make_parallel_sparse_train_step(model, table_specs, mesh,
                                    rules=DEFAULT_RULES, **hyper):
    """Distributed O(batch) sparse step: tables (and their Adam moments)
    row-shard over 'model', batches split over 'data'; the ids of the
    global batch are deduped on every rank, rows gathered across 'model',
    gradients summed across 'data', and each rank writes back the rows it
    holds. hyper: `make_sparse_train_step`'s (learning_rate, dense_tx,
    id_cap, ...).

    Returns (step_fn, init_fn): init_fn() -> (params, state, shardings);
    step_fn(state, batch, generator=None) -> (state, loss), `batch` the
    GLOBAL batch."""
    shardings = {}
    inner = {}

    def init_fn():
        shardings.update(shard_model(model, mesh, rules))
        _check_model(model, mesh)
        init, inner["step"] = make_sparse_train_step(
            model, table_specs, layout=MeshRowLayout(mesh, shardings),
            **hyper)
        return model.params(), init(model.params()), dict(shardings)

    def local_step(state: dict, local: dict, global_batch: dict, generator):
        with global_batch_of(mesh, global_batch):
            state, loss = inner["step"](state, local, generator,
                                        ids_batch=global_batch)
        return state, _reduce_data([loss], mesh)[0]

    def step_fn(state: dict, batch: dict, generator=None):
        batch = {k: torch.as_tensor(v, device=mesh_device(mesh))
                 for k, v in batch.items()}
        return local_step(state, data_slice(batch, mesh), batch, generator)

    step_fn.local_step = local_step
    return step_fn, init_fn


def make_parallel_device_sparse_train_step(model, table_specs, mesh,
                                           sampler, steps_per_call: int = 1,
                                           rules=DEFAULT_RULES, **hyper):
    """The sparse step fed by ON-DEVICE sampling: each data rank draws its
    slice from its generator, the slices' ids are all_gathered over
    'data' for the global dedup.

    Returns (step_fn, init_fn): init_fn as `make_parallel_sparse_train_
    step`'s; step_fn(state, generator, loss_generator=None) -> (state,
    losses[k]), the generators as `make_parallel_device_train_step`'s."""
    step, init_fn = make_parallel_sparse_train_step(model, table_specs, mesh,
                                                    rules=rules, **hyper)

    def step_fn(state: dict, generator: torch.Generator,
                loss_generator: torch.Generator | None = None):
        losses = []
        for _ in range(steps_per_call):
            local = sampler.sample(generator)
            state, loss = step.local_step(
                state, local, gather_batch(local, mesh), loss_generator)
            losses.append(loss)
        return state, torch.stack(losses)

    return step_fn, init_fn


def make_parallel_eval_step(model, mesh, at=(50, 100), shardings=None):
    """Eval step with users split over 'data': each rank scores its slice
    of the users against the whole catalog (row-sharded leaves are
    all_gathered for it, `full_params`) and the per-user metrics are
    all_gathered over 'data'. eval_step(user_id, pos_mask, excl_mask) ->
    {"AUC": [B], "Recall" / "NDCG" / "Precision": [B, K]}."""
    at = tuple(at)
    shardings = shardings or {}

    @torch.no_grad()
    def eval_step(user_id, pos_mask, excl_mask):
        dev = mesh_device(mesh)
        local = data_slice({"u": torch.as_tensor(user_id, device=dev),
                            "p": torch.as_tensor(pos_mask, device=dev),
                            "e": torch.as_tensor(excl_mask, device=dev)},
                           mesh)
        with full_params(model, shardings, mesh):
            pred = model.score({"user_id": local["u"]})
        out = ranking_metrics(local["p"], pred, local["e"], at=at)
        group = axis_group(mesh, DATA_AXIS)
        return {k: col.all_gather(v, group) for k, v in out.items()}

    return eval_step

