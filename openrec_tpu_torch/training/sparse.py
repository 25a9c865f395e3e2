"""O(batch) sparse embedding training: gather -> step -> scatter.

Counterpart of the flat mode of `openrec_tpu/training/sparse.py`. Lazy
Adam over a whole table (`optim.lazy_adam`) still reads and writes every
row of it each step; at Criteo-Kaggle width (33.8 M rows) that is
gigabytes a step. Here a step costs O(batch):

  1. the batch's ids of each table are made unique and padded to a fixed
     cap (`unique_padded`: one sort, a first-occurrence mask, a cumsum and
     a scatter; no `torch.unique`, whose data-dependent length would sync
     the host);
  2. those rows are gathered into a fresh leaf tensor [cap, D];
  3. the model's loss runs with the table replaced by a `SubTable` view of
     the gathered rows (`model.loss(batch, tables={name: view})`), so
     autograd never allocates a gradient of the table's size;
  4. Adam (the keras form, as `lazy_adam`) runs on the gathered rows and
     their gathered moments;
  5. the deltas of rows, mu and nu are added back IN PLACE with
     `index_add_`, each pad's delta multiplied by zero.

The dense parameters (the MLPs) take `dense_tx`, by default optax's Adam
(`optim.adam`) with the same hyperparameters, as in the JAX package.
The `'columns'`, `'mixed'` and `'hash*'` dedup modes are not ported yet
(ROADMAP.md, queue 1).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from openrec_tpu_torch.training.optim import (_adam_alpha, adam,
                                              apply_updates)


class SubTable:
    """A gathered view of an embedding table.

    Duck-types the table for `embedding_lookup`: an original id resolves
    inside the gathered rows by a binary search over the sorted unique ids
    (left side: the FIRST match, never a pad that aliases it). Ids not in
    the view clamp to some row, as a lookup's clip mode does."""

    def __init__(self, uids_sorted: torch.Tensor, rows: torch.Tensor):
        self.uids_sorted = uids_sorted    # [K] int32, sorted (with pads)
        self.rows = rows                  # [K, D]

    def lookup(self, ids) -> torch.Tensor:
        ids = torch.as_tensor(ids, device=self.rows.device)
        pos = torch.searchsorted(
            self.uids_sorted,
            ids.to(self.uids_sorted.dtype).contiguous().reshape(-1))
        pos = pos.clamp(0, self.rows.shape[0] - 1)
        return self.rows.index_select(0, pos).reshape(
            *ids.shape, *self.rows.shape[1:])

    @property
    def T(self):
        raise TypeError(
            "full-table ops are not available on a SubTable view; score() "
            "must use the full table (run it outside the sparse step)")


def _compact_sorted(sorted_ids: torch.Tensor, cap: int):
    """(uids, valid) from PRE-SORTED ids: the first occurrences are
    scattered to the front of a [cap] buffer filled with the max id (the
    last unique), so pads alias a real id and the result stays sorted.
    Entries that are not first, and uniques past cap, go to an extra slot
    [cap] that is cut off (torch has no scatter mode "drop")."""
    is_first = torch.ones_like(sorted_ids, dtype=torch.bool)
    is_first[1:] = sorted_ids[1:] != sorted_ids[:-1]
    k = torch.clamp(is_first.sum(), max=cap)
    pos = torch.where(is_first, torch.cumsum(is_first, 0) - 1, cap)
    uids = sorted_ids[-1:].repeat(cap + 1)
    uids.scatter_(0, pos.clamp(max=cap), sorted_ids)
    valid = torch.arange(cap, device=sorted_ids.device) < k
    return uids[:cap], valid


def unique_padded(ids, cap: int):
    """(uids, valid): the sorted unique ids padded to length cap by
    repeating the last unique id, and a mask of the real (non-pad)
    entries. Lookups resolve to the first match, so a pad never receives
    a gradient; a scatter must mask its contributions with `valid`, since
    a pad aliases a real id."""
    return _compact_sorted(torch.sort(ids.reshape(-1)).values, cap)


class SparseAdamState(NamedTuple):
    count: torch.Tensor     # int32 scalar
    mu: dict                # {path tuple: [rows, D] tensor}
    nu: dict


def _path_of(key) -> tuple:
    return key if isinstance(key, tuple) else (key,)


def _name_of(path: tuple) -> str:
    """("embed_tables", 3) -> "embed_tables/3", the parameter's name."""
    return "/".join(str(p) for p in path)


def _extractor(spec):
    if callable(spec):
        return spec
    keys = list(spec)
    return lambda batch: torch.cat(
        [torch.as_tensor(batch[k]).reshape(-1) for k in keys])


def dlrm_table_specs(num_tables: int):
    """Specs for DLRM's separate tables: table i is indexed by
    batch['sparse_features'][:, i]."""
    return {("embed_tables", i):
            (lambda batch, i=i: batch["sparse_features"][:, i])
            for i in range(num_tables)}


def dlrm_fused_table_spec(model, mode: str | None = None):
    """Spec for DLRM(fused_tables=True): one table, offset ids, deduped by
    one flat sort of the batch's B*T ids (mode None or 'flat')."""
    if mode not in (None, "flat"):
        raise NotImplementedError(
            f"dedup mode {mode!r} is not ported yet; the port has the flat "
            "mode (ROADMAP.md, queue 1: 'columns' / 'mixed' / 'hash')")
    return {"embed_fused":
            lambda batch: model.flat_sparse_ids(
                batch["sparse_features"]).reshape(-1)}


def make_sparse_train_step(model, table_specs, learning_rate=1e-3, b1=0.9,
                           b2=0.999, eps=1e-7, dense_tx=None,
                           id_cap: int | None = None):
    """(init_fn, step_fn) with O(batch) updates of the given tables.

    table_specs: {parameter path (str or tuple): id spec}, where an id spec
    is a list of batch keys or a callable(batch) -> ids, e.g.
      {"user_embed": ["user_id"],
       "item_embed": ["p_item_id", "n_item_id"],
       ("embed_tables", 3): lambda b: b["sparse_features"][:, 3]}
    The other parameters of `model` take `dense_tx` (default optax-form
    `adam` with the same hyperparameters). `id_cap` caps the unique ids
    per table and step (default: the number of ids; uniques past it are
    dropped from the step).

    init_fn(params) -> state: {"sparse": SparseAdamState, "dense": ...}.
    step_fn(state, batch, generator=None) -> (state, loss): updates the
    model's parameters and the state's moments in place; `generator`
    reaches `model.loss` (dropout draws from it). The JAX package's third
    return value, the un-jitted step, is step_fn itself here.
    """
    if dense_tx is None:
        dense_tx = adam(learning_rate, b1=b1, b2=b2, eps=eps)
    specs = {_path_of(k): _extractor(v) for k, v in table_specs.items()}
    names = {path: _name_of(path) for path in specs}
    table_names = set(names.values())
    containers = {path[0] for path in specs if len(path) > 1}

    def _split_dense(params: dict) -> dict:
        dense = {}
        for name, p in params.items():
            if name in table_names:
                continue
            if name.split("/")[0] in containers:
                # a container of tables (embed_tables): every entry must be
                # a table, mixed containers are not supported
                raise ValueError(f"container of '{name}' mixes sparse and "
                                 "dense entries")
            dense[name] = p
        return dense

    def init_fn(params: dict):
        mu = {path: torch.zeros_like(params[names[path]].detach())
              for path in specs}
        nu = {path: torch.zeros_like(params[names[path]].detach())
              for path in specs}
        dev = params[names[next(iter(specs))]].device
        count = torch.zeros([], dtype=torch.int32, device=dev)
        dense = _split_dense(params)
        # every parameter may be a table (BPR): the state's count still
        # lives beside them
        return {"sparse": SparseAdamState(count, mu, nu),
                "dense": dense_tx.init(dense, device=dev)}

    def step_fn(state: dict, batch: dict,
                generator: torch.Generator | None = None):
        sparse_state: SparseAdamState = state["sparse"]
        params = model.params()
        # 1) unique ids per table, at a cap fixed by the batch's shape
        uids, valid = {}, {}
        for path, extract in specs.items():
            all_ids = torch.as_tensor(
                extract(batch),
                device=params[names[path]].device).reshape(-1)
            cap = min(id_cap or all_ids.shape[0], all_ids.shape[0])
            uids[path], valid[path] = unique_padded(all_ids, cap)
        idx = {path: u.long() for path, u in uids.items()}
        # 2) gathered rows: fresh leaves, the tables stay out of the graph
        rows = {path: params[names[path]].detach().index_select(
                    0, idx[path]).requires_grad_()
                for path in specs}
        dense = _split_dense(params)
        # 3) the loss over SubTable views and the dense parameters
        views = {names[path]: SubTable(uids[path], rows[path])
                 for path in specs}
        loss, _aux = model.loss(batch, tables=views, generator=generator)
        leaves = list(rows.values()) + list(dense.values())
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        grads = [torch.zeros_like(x) if g is None else g
                 for x, g in zip(leaves, grads)]
        row_grads = dict(zip(rows, grads[:len(rows)]))
        dense_grads = dict(zip(dense, grads[len(rows):]))
        with torch.no_grad():
            # 4) keras-form Adam on the gathered rows
            count = sparse_state.count + 1
            alpha = _adam_alpha(count, learning_rate, b1, b2)
            for path in specs:
                g = row_grads[path]
                v = valid[path][:, None].to(g.dtype)
                mu, nu = sparse_state.mu[path], sparse_state.nu[path]
                mu_old = mu.index_select(0, idx[path])
                nu_old = nu.index_select(0, idx[path])
                mu_rows = b1 * mu_old + (1 - b1) * g
                nu_rows = b2 * nu_old + (1 - b2) * g * g
                step = -alpha * mu_rows / (torch.sqrt(nu_rows) + eps)
                # 5) deltas added back in place; pads add zero
                params[names[path]].index_add_(0, idx[path], step * v)
                mu.index_add_(0, idx[path], (mu_rows - mu_old) * v)
                nu.index_add_(0, idx[path], (nu_rows - nu_old) * v)
            updates, dense_state = dense_tx.update(dense_grads,
                                                   state["dense"], dense)
            apply_updates(dense, updates)
            model.post_step(batch)
        return ({"sparse": SparseAdamState(count, sparse_state.mu,
                                           sparse_state.nu),
                 "dense": dense_state}, loss.detach())

    return init_fn, step_fn


def make_sparse_device_loop(model, table_specs, sampler, k: int, **hyper):
    """K sparse steps, each on a batch drawn on the device: the host sends
    no batch, and each step touches only the gathered rows.

    Returns (init_fn, loop_fn): loop_fn(state, generator) -> (state,
    losses[k]) on the device; `sampler` is a Device*Sampler drawing from
    `generator`."""
    init_fn, step_fn = make_sparse_train_step(model, table_specs, **hyper)

    def loop_fn(state, generator: torch.Generator):
        losses = []
        for _ in range(k):
            state, loss = step_fn(state, sampler.sample(generator),
                                  generator)
            losses.append(loss)
        return state, torch.stack(losses)

    return init_fn, loop_fn
