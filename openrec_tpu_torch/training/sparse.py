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
  4. Adam (the keras form, as `lazy_adam`) updates each table's live rows
     and their moments IN PLACE (`ops.sparse_adam`: on the card one CUDA
     kernel that reads and writes the live rows alone; a pad writes
     nothing).

The dense parameters (the MLPs) take `dense_tx`, by default optax's Adam
(`optim.adam`) with the same hyperparameters, as in the JAX package.

Step 1 has four modes, all of the JAX package's (`dlrm_fused_table_spec`):
the flat sort above; `Columns`, one sort per column of a [B, T] id matrix;
`ColumnIds`, a small table's whole static row range with a touched mask;
and `Hashed`, a sort-free slot table filled by parallel `scatter_reduce_`
("amin") insertion, whose lookups re-probe it (`HashSubTable`). Every mode
trains the same trajectory, bit for bit; the hash mode asks the host once
a step whether every id has landed (`trace.host_sync`). A
`RowLayout` says which rows this process holds; the distribution layer
(`parallel/train.py`) passes one for a row-sharded table.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from openrec_tpu_torch import trace
from openrec_tpu_torch.ops.sparse_adam import sparse_adam_apply
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

    def positions(self, ids) -> torch.Tensor:
        """Each id's row in the view, flattened."""
        ids = torch.as_tensor(ids, device=self.rows.device)
        pos = torch.searchsorted(
            self.uids_sorted,
            ids.to(self.uids_sorted.dtype).contiguous().reshape(-1))
        return pos.clamp(0, self.rows.shape[0] - 1)

    def lookup(self, ids) -> torch.Tensor:
        ids = torch.as_tensor(ids, device=self.rows.device)
        return self.rows.index_select(0, self.positions(ids)).reshape(
            *ids.shape, *self.rows.shape[1:])

    @property
    def T(self):
        raise TypeError(
            "full-table ops are not available on a SubTable view; score() "
            "must use the full table (run it outside the sparse step)")


def _compact_sorted(sorted_ids: torch.Tensor, cap: int):
    """(uids, valid) from ids PRE-SORTED along the last dim: the first
    occurrences are scattered to the front of a [..., cap] buffer filled
    with the max id (the last unique), so pads alias a real id and the
    result stays sorted. Entries that are not first, and uniques past cap,
    go to an extra slot [cap] that is cut off (torch has no scatter mode
    "drop"). Rows of a 2-D input are compacted independently."""
    is_first = torch.ones_like(sorted_ids, dtype=torch.bool)
    is_first[..., 1:] = sorted_ids[..., 1:] != sorted_ids[..., :-1]
    k = torch.clamp(is_first.sum(-1, keepdim=True), max=cap)
    pos = torch.where(is_first, torch.cumsum(is_first, -1) - 1, cap)
    uids = sorted_ids[..., -1:].repeat(
        *([1] * (sorted_ids.dim() - 1)), cap + 1)
    uids.scatter_(-1, pos.clamp(max=cap), sorted_ids)
    valid = torch.arange(cap, device=sorted_ids.device) < k
    return uids[..., :cap], valid


def unique_padded(ids, cap: int):
    """(uids, valid): the sorted unique ids padded to length cap by
    repeating the last unique id, and a mask of the real (non-pad)
    entries. Lookups resolve to the first match, so a pad never receives
    a gradient; a scatter must mask its contributions with `valid`, since
    a pad aliases a real id."""
    return _compact_sorted(torch.sort(ids.reshape(-1)).values, cap)


class Columns:
    """Opt-in wrapper for the per-column dedup: a [B, T] id matrix whose
    columns index DISJOINT, increasing id ranges (`unique_padded_columns`).
    A bare 2-D array goes through the flat dedup: a user's [B, 2] stacked
    pos/neg ids (one id range in both columns) would break the global
    order `SubTable`'s binary search needs."""

    def __init__(self, ids_bt):
        self.ids_bt = ids_bt


def unique_padded_columns(ids_bt: torch.Tensor):
    """(uids [T*B], valid [T*B]) of [B, T] ids whose columns index
    disjoint, increasing id ranges: T batched sorts of B ids, each
    column's uniques compacted (cap B, pads alias that column's max id)
    and concatenated in column order, which the contract makes globally
    sorted."""
    cols = ids_bt.T                               # [T, B]
    uids, valid = _compact_sorted(torch.sort(cols, dim=1).values,
                                  cols.shape[1])
    return uids.reshape(-1), valid.reshape(-1)


class ColumnIds:
    """[B, T] offset ids plus the static per-table (counts, offsets): opts
    the sparse step into the MIXED static/dedup scheme
    (`unique_padded_mixed`). Columns cover disjoint, increasing ranges."""

    def __init__(self, ids_bt, counts, offsets):
        self.ids_bt = ids_bt
        self.counts = tuple(int(c) for c in counts)
        self.offsets = tuple(int(o) for o in offsets)


def unique_padded_mixed(col_ids: ColumnIds):
    """(uids, valid) for ColumnIds. A table of count <= B rows never has
    more uniques than rows, so its segment is its whole static row range
    [offset, offset + count) with `valid` the touched-this-batch mask (one
    scatter, no sort); untouched rows then add zero to params and moments,
    exactly as they are absent from the flat dedup. Larger tables dedup
    per column. Segments concatenate in offset order, globally sorted."""
    ids_bt = col_ids.ids_bt
    B = ids_bt.shape[0]
    segs_u, segs_v = [], []
    for t, (c, o) in enumerate(zip(col_ids.counts, col_ids.offsets)):
        if c <= B:
            segs_u.append(torch.arange(o, o + c, dtype=ids_bt.dtype,
                                       device=ids_bt.device))
            # ids outside [o, o + c) go to the cut-off slot c (the JAX
            # package's mode="drop", with its clamp of ids below o)
            idx = ids_bt[:, t].long() - o
            idx = torch.where((idx >= 0) & (idx < c), idx, c)
            touched = torch.zeros(c + 1, dtype=torch.bool,
                                  device=ids_bt.device)
            touched.scatter_(0, idx, True)
            segs_v.append(touched[:c])
        else:
            u, v = unique_padded(ids_bt[:, t], B)
            segs_u.append(u)
            segs_v.append(v)
    return torch.cat(segs_u), torch.cat(segs_v)


_HASH_EMPTY = 2 ** 31 - 1
_KNUTH, _STRIDE_MUL = 2654435761, 2246822519


class Hashed:
    """Opt-in wrapper for the SORT-FREE dedup: the flat ids are inserted in
    parallel into a power-of-two slot table of at least twice their count
    (`unique_hashed`, double-hash probes), and lookups re-probe it
    (`HashSubTable`). Ids are non-negative int32 below 2**31 - 1, the
    empty sentinel; like the JAX package, nothing checks that.

    rounds: probe rounds run before the one host check of whether every
    id has landed (`unique_hashed`); a perf knob, not a correctness one.
    lookup_unroll: the JAX package's lookup probes before a host check;
    kept for its signature, the sparse step ignores it (its lookups run
    exactly the rounds the insertion ran and never ask the host)."""

    def __init__(self, ids, rounds: int = 8, lookup_unroll: int = 8):
        self.ids = ids
        self.rounds = int(rounds)
        self.lookup_unroll = int(lookup_unroll)


def _mul32(u: torch.Tensor, m: int) -> torch.Tensor:
    """(u * m) mod 2**32 for int64 u in [0, 2**32): the uint32 product of
    the JAX package, in two 16-bit halves of m so that int64 never
    overflows."""
    lo = u * (m & 0xFFFF)
    hi = ((u * (m >> 16)) & 0xFFFF) << 16
    return (lo + hi) & 0xFFFFFFFF


def _hash_probe(ids: torch.Tensor, S: int):
    """(h0, stride), int64, for double hashing into S = 2**k slots: two
    multiplicative (Knuth) hashes of the id's uint32 bits; stride is odd,
    so (h0 + r*stride) mod S visits every slot once over r < S."""
    shift = 32 - (int(S).bit_length() - 1)
    u = ids.to(torch.int64) & 0xFFFFFFFF
    h0 = _mul32(u, _KNUTH) >> shift
    stride = (_mul32(u, _STRIDE_MUL) >> shift) | 1
    return h0, stride


def unique_hashed(ids, rounds: int = 8):
    """(slots [S], valid [S]) by parallel hash-slot insertion, no sort
    (`_insert_hashed`, which also says how many rounds ran)."""
    slots, valid, _ = _insert_hashed(ids, rounds)
    return slots, valid


def _insert_hashed(ids, rounds: int = 8):
    """(slots [S], valid [S], rounds_run) by parallel hash-slot insertion,
    no sort. S is the smallest power of two >= 2 * len(ids). Each round,
    every id not yet landed scatter-mins itself into its next probe slot
    if that slot was empty at the round's start; settled ids are never
    evicted, so every id lands within S rounds.

    `rounds` rounds run without looking at the host; then one host check
    of `landed.all()` (counted in `openrec.host_syncs`) and, only
    if some id has not landed, one round and one check at a time (the
    JAX package's `lax.while_loop`). `rounds_run` tells `hash_positions`
    how many probes reach every id. Slots hold the ids in SLOT ORDER;
    empty slots hold 2**31 - 1, so gather them as absent rows and drop
    their scatters. Duplicates resolve to one slot, so gradients sum in
    the same order as in the sorted modes."""
    flat = ids.reshape(-1).to(torch.int32)
    n = int(flat.shape[0])
    S = 1 << (2 * n - 1).bit_length()
    h0, stride = _hash_probe(flat, S)
    mask = S - 1
    slots = torch.full((S,), _HASH_EMPTY, dtype=torch.int32,
                       device=flat.device)
    landed = torch.zeros(n, dtype=torch.bool, device=flat.device)

    def round_fn(r, landed):
        pos = (h0 + r * stride) & mask
        cur = slots.index_select(0, pos)
        landed = landed | (cur == flat)
        cand = torch.where(~landed & (cur == _HASH_EMPTY), flat,
                           _HASH_EMPTY)
        slots.scatter_reduce_(0, pos, cand, "amin")
        return landed | (slots.index_select(0, pos) == flat)

    r = 0
    for r in range(min(max(rounds, 0), S)):
        landed = round_fn(r, landed)
    r = min(max(rounds, 0), S)
    while r < S:
        done = landed.all()
        with trace.host_sync():
            done = bool(done)
        if done:
            break
        landed = round_fn(r, landed)
        r += 1
    return slots, slots != _HASH_EMPTY, max(r, 1)


def hash_positions(slot_ids, ids, unroll: int = 8, rounds: int | None = None):
    """Slot of each id in a `unique_hashed` table, by retracing its probe
    sequence. With `rounds` (the table's `rounds_run`) exactly that many
    probes run and the host is not asked: every id present has landed by
    then. Without it, `unroll` probes run, then one host check (counted
    in `openrec.host_syncs`) per further probe. An id absent from
    the table gets some slot, its last probe (the JAX package's gets its
    S-th)."""
    S = int(slot_ids.shape[0])
    idsi = torch.as_tensor(ids, device=slot_ids.device).to(torch.int32)
    h0, stride = _hash_probe(idsi, S)
    mask = S - 1
    pos = h0 & mask
    found = slot_ids.index_select(0, pos.reshape(-1)).reshape(
        idsi.shape) == idsi

    def probe(r, pos, found):
        cand = (h0 + r * stride) & mask
        pos = torch.where(found, pos, cand)
        return pos, found | (slot_ids.index_select(0, pos.reshape(-1))
                             .reshape(idsi.shape) == idsi)

    n_probe = min(max(rounds if rounds is not None else unroll, 1), S)
    for r in range(1, n_probe):
        pos, found = probe(r, pos, found)
    r = n_probe
    while rounds is None and r < S:
        done = found.all()
        with trace.host_sync():
            done = bool(done)
        if done:
            break
        pos, found = probe(r, pos, found)
        r += 1
    return pos


class HashSubTable:
    """A gathered view keyed by a `unique_hashed` slot table (the sort-free
    sibling of `SubTable`): a lookup re-probes the slot table."""

    def __init__(self, slot_ids: torch.Tensor, rows: torch.Tensor,
                 unroll: int = 8, rounds: int | None = None):
        self.slot_ids = slot_ids          # [S] int32, empties 2**31 - 1
        self.rows = rows                  # [S, D]
        self.unroll = int(unroll)
        self.rounds = rounds

    def positions(self, ids) -> torch.Tensor:
        """Each id's row in the view, flattened."""
        ids = torch.as_tensor(ids, device=self.rows.device)
        return hash_positions(self.slot_ids, ids, unroll=self.unroll,
                              rounds=self.rounds).reshape(-1)

    def lookup(self, ids) -> torch.Tensor:
        ids = torch.as_tensor(ids, device=self.rows.device)
        return self.rows.index_select(0, self.positions(ids)).reshape(
            *ids.shape, *self.rows.shape[1:])

    @property
    def T(self):
        raise TypeError(
            "full-table ops are not available on a HashSubTable view; "
            "score() must use the full table (run it outside the sparse "
            "step)")


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


def dlrm_fused_table_spec(model, columnwise: bool = False,
                          mode: str | None = None):
    """Spec for DLRM(fused_tables=True): one table, offset ids.

    mode (or columnwise=True for 'columns'):
      None / 'flat' - one flat sort of the batch's B*T ids (default);
      'columns'     - `Columns`: T batched B-id sorts, one per column;
      'mixed'       - `ColumnIds`: a table of count <= B contributes its
                      static row range with a touched mask, larger tables
                      dedup per column;
      'hash'        - `Hashed`: sort-free slot-table insertion; 'hashR'
                      (e.g. 'hash4') sets both probe-round knobs to R.
    Every mode trains the same trajectory, bit for bit. The per-table
    offset ranges are disjoint and increasing, as 'columns' and 'mixed'
    require; a multi-hot model (`DLRM(multi_hot=...)`, several columns
    a table) breaks that, and those two modes refuse it. 'flat' and
    'hash' take its ids as they are."""
    mode = "columns" if columnwise and mode is None else (mode or "flat")
    if mode in ("columns", "mixed") and any(
            s > 1 for s in (model.multi_hot or ())):
        raise ValueError(
            f"dedup mode {mode!r} needs one id column a table (disjoint, "
            "increasing column ranges); a multi-hot DLRM's columns share "
            "their table's range: use 'flat' or 'hash'")
    if mode.startswith("hash"):
        r = int(mode[4:]) if len(mode) > 4 else 8
        return {"embed_fused":
                lambda batch: Hashed(model.flat_sparse_ids(
                    batch["sparse_features"]).reshape(-1),
                    rounds=r, lookup_unroll=r)}
    if mode == "mixed":
        counts = tuple(model.ln_emb)
        offsets = tuple(int(o) for o in model.table_offsets[:-1])
        return {"embed_fused":
                lambda batch: ColumnIds(
                    model.flat_sparse_ids(batch["sparse_features"]),
                    counts, offsets)}
    if mode == "columns":
        return {"embed_fused":
                lambda batch: Columns(model.flat_sparse_ids(
                    batch["sparse_features"]))}
    if mode != "flat":
        raise ValueError(f"unknown dedup mode {mode!r}")
    return {"embed_fused":
            lambda batch: model.flat_sparse_ids(
                batch["sparse_features"]).reshape(-1)}


class RowLayout:
    """Where a sparse step's rows live, and what joins the ranks: on one
    device every table is whole and nothing is joined. The distribution
    layer (`parallel/train.py`) subclasses it for a row-sharded table on
    a data x model mesh."""

    def sharded(self, name: str) -> bool:
        """Whether this rank holds only a block of table `name`'s rows."""
        return False

    def shard_range(self, name: str, table: torch.Tensor):
        """(first global row of this rank's block of table `name`, rows
        in it)."""
        return 0, table.shape[0]

    def gather(self, name: str, table: torch.Tensor, uids: torch.Tensor,
               masked: bool = False):
        """Rows `uids` of table `name`. Where the table is sharded, or
        `masked` (a hash table's empty slots), ids this rank does not hold
        give zero rows; else every id is a row here."""
        if masked or self.sharded(name):
            return masked_gather(table, uids,
                                 self.shard_range(name, table)[0])
        return table.index_select(0, uids)

    def reduce(self, grads: list) -> list:
        """Gradients summed over the data ranks."""
        return grads

    def views(self, model) -> dict:
        """{name: view} of the model's row-sharded tables, for its loss
        (those the step does not gather) and its `post_step`: none on
        one device."""
        return {}

    def objective(self, model, total, aux):
        """The loss whose gradients, summed over the data ranks, are the
        global batch's."""
        return total


def post_step(model, batch: dict, views: dict) -> None:
    """`model.post_step(batch)`, handed the views of its row-sharded
    tables where there are any."""
    if views:
        model.post_step(batch, tables=views)
    else:
        model.post_step(batch)


def masked_gather(table: torch.Tensor, ids, lo: int) -> torch.Tensor:
    """Rows ids - lo of `table` for ids of any shape, a zero row where that
    falls outside it (where a lookup's clip would pick an edge row): a
    table's block of global rows [lo, lo + len), or a gathered row set
    with an absent id."""
    ids = torch.as_tensor(ids, device=table.device)
    local = ids.long().reshape(-1) - lo
    inside = (local >= 0) & (local < table.shape[0])
    rows = table.index_select(0, torch.where(inside, local, 0))
    mask = inside.reshape(-1, *([1] * (rows.dim() - 1))).to(rows.dtype)
    return (rows * mask).reshape(*ids.shape, *table.shape[1:])


def _dedup(raw, device, id_cap):
    """(uids, valid, hash rounds run or None) of one table's extracted
    ids."""
    if isinstance(raw, Hashed):
        slots, valid, rounds = _insert_hashed(
            torch.as_tensor(raw.ids, device=device), rounds=raw.rounds)
        return slots, valid, rounds
    if isinstance(raw, ColumnIds):
        return (*unique_padded_mixed(ColumnIds(
            torch.as_tensor(raw.ids_bt, device=device), raw.counts,
            raw.offsets)), None)
    if isinstance(raw, Columns):
        return (*unique_padded_columns(
            torch.as_tensor(raw.ids_bt, device=device)), None)
    all_ids = torch.as_tensor(raw, device=device).reshape(-1)
    cap = min(id_cap or all_ids.shape[0], all_ids.shape[0])
    return (*unique_padded(all_ids, cap), None)


def make_sparse_train_step(model, table_specs, learning_rate=1e-3, b1=0.9,
                           b2=0.999, eps=1e-7, dense_tx=None,
                           id_cap: int | None = None,
                           layout: RowLayout | None = None):
    """(init_fn, step_fn) with O(batch) updates of the given tables.

    table_specs: {parameter path (str or tuple): id spec}, where an id spec
    is a list of batch keys or a callable(batch) -> ids, e.g.
      {"user_embed": ["user_id"],
       "item_embed": ["p_item_id", "n_item_id"],
       ("embed_tables", 3): lambda b: b["sparse_features"][:, 3]}
    A callable may wrap its ids in `Columns`, `ColumnIds` or `Hashed` to
    choose a dedup mode (`dlrm_fused_table_spec`). The other parameters of
    `model` take `dense_tx` (default optax-form `adam` with the same
    hyperparameters). `id_cap` caps the unique ids per table and step of
    the flat mode (default: the number of ids; uniques past it are
    dropped from the step). `layout` places the tables' rows
    (`RowLayout`; the distribution layer passes its own).

    init_fn(params) -> state: {"sparse": SparseAdamState, "dense": ...}.
    step_fn(state, batch, generator=None, ids_batch=None) -> (state,
    loss): updates the model's parameters and the state's moments in
    place; `generator` reaches `model.loss` (dropout draws from it).
    `ids_batch` (default `batch`) is the batch whose ids are deduped: the
    distribution layer passes the global batch there and this rank's
    slice as `batch`. The JAX package's third return value, the un-jitted
    step, is step_fn itself here.
    """
    if dense_tx is None:
        dense_tx = adam(learning_rate, b1=b1, b2=b2, eps=eps)
    if layout is None:
        layout = RowLayout()
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
                generator: torch.Generator | None = None,
                ids_batch: dict | None = None):
        sparse_state: SparseAdamState = state["sparse"]
        params = model.params()
        # 1) unique ids per table, at a size fixed by the batch's shape
        with trace.span("openrec.train.dedup"):
            uids, valid, hashed = {}, {}, {}
            for path, extract in specs.items():
                uids[path], valid[path], hashed[path] = _dedup(
                    extract(batch if ids_batch is None else ids_batch),
                    params[names[path]].device, id_cap)
                trace.count("openrec.train.id_slots", valid[path].numel())
                trace.count_device("openrec.train.unique_rows", valid[path])
        # 2) gathered rows: fresh leaves, the tables stay out of the graph
        # (tables where some ids have no row here: a hash table's empty
        # slots, a sharded table's rows on other ranks)
        partial = {path: hashed[path] is not None
                   or layout.sharded(names[path]) for path in specs}
        with trace.span("openrec.train.gather"):
            rows = {path: layout.gather(names[path],
                                        params[names[path]].detach(),
                                        uids[path],
                                        masked=partial[path])
                    .requires_grad_() for path in specs}
        dense = _split_dense(params)
        # 3) the loss over the gathered views and the dense parameters
        sharded = layout.views(model)
        views = {**sharded, **{names[path]: (
            SubTable(uids[path], rows[path]) if hashed[path] is None
            else HashSubTable(uids[path], rows[path], rounds=hashed[path]))
            for path in specs}}
        with trace.span("openrec.train.forward"):
            total, aux = model.loss(batch, tables=views, generator=generator)
            loss = layout.objective(model, total, aux)
        leaves = list(rows.values()) + list(dense.values())
        with trace.span("openrec.train.backward"):
            grads = torch.autograd.grad(loss, leaves, allow_unused=True)
            grads = layout.reduce([torch.zeros_like(x) if g is None else g
                                   for x, g in zip(leaves, grads)])
        row_grads = dict(zip(rows, grads[:len(rows)]))
        dense_grads = dict(zip(dense, grads[len(rows):]))
        with torch.no_grad():
            # the dense Adam, and the step size of the tables' Adam
            with trace.span("openrec.train.adam"):
                count = sparse_state.count + 1
                alpha = _adam_alpha(count, learning_rate, b1, b2)
                updates, dense_state = dense_tx.update(dense_grads,
                                                       state["dense"], dense)
                apply_updates(dense, updates)
            # 4) keras-form Adam on each table's live rows, in place; a
            # pad, a row this rank does not hold and an empty hash slot
            # write nothing
            with trace.span("openrec.train.scatter"):
                for path in specs:
                    table = params[names[path]]
                    at, write = uids[path], valid[path]
                    if partial[path]:
                        lo, n_rows = layout.shard_range(names[path], table)
                        at = at.long() - lo
                        write = write & (at >= 0) & (at < n_rows)
                    sparse_adam_apply(table, sparse_state.mu[path],
                                      sparse_state.nu[path], at, write,
                                      row_grads[path], alpha, b1, b2, eps)
            post_step(model, batch if ids_batch is None else ids_batch,
                      sharded)
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
