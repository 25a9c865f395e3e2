"""The gradient of the sparse step's gathered-view lookups and bags
(`ops.view_grad`) on the CPU: the plain path every CPU tensor takes.

Bars, all exact (torch.equal): the Functions' gradients against autograd
through `index_select` and `F.embedding_bag` on views made by every dedup
mode, an `id_cap` that drops ids and clamps their lookups included; whole
sparse DLRM and DLRM-DCNv2 steps against the same steps with the view's
lookups and bags left to autograd; every dedup mode's step taking its
view gradient from `view_grad`, once a step, the flat one with its
dedup's order (`unique_padded_order`'s permutation stable, its uids and
valid those of `unique_padded`; `DLRM` looking up the view's own ids);
the kernel's summation order (`view_grad_model.chunked_sum`) against a
loop over rows. The card's kernel is held against both in
`test_torch_view_grad_card.py`. Imports nothing of the JAX package.
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import view_grad_model
from openrec_tpu_torch import trace
from openrec_tpu_torch.models import DLRM
from openrec_tpu_torch.modules.interactions import second_order_interaction
from openrec_tpu_torch.ops import view_grad as vg
from openrec_tpu_torch.training import sparse as tsparse

torch.set_num_threads(1)

LN_EMB = (50, 3, 400, 7, 120)
MODES = ("flat", "columns", "mixed", "hash")
DCN = dict(m_spa=8, ln_emb=(300, 3, 450, 60), multi_hot=(3, 1, 12, 2),
           ln_bot=(16, 8), ln_top=(16, 1), dim_dense=5, dcn_layers=2,
           dcn_rank=4)


def _dlrm(dim=6, seed=0):
    gen = torch.Generator().manual_seed(seed)
    return DLRM(m_spa=dim, ln_emb=LN_EMB, ln_bot=(8, dim), ln_top=(8, 1),
                dim_dense=4, loss_func="bce", fused_tables=True,
                device="cpu", generator=gen)


def _dcn(seed=0):
    gen = torch.Generator().manual_seed(seed)
    return DLRM(**DCN, arch_interaction_op="dcn", loss_func="bce",
                fused_tables=True, device="cpu", generator=gen)


def _batches(counts, sizes, n=3, B=96, dim_dense=4, seed=1):
    """Skewed ids (squared uniforms), so rows repeat and the small tables'
    every row is hit many times."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        cols = [(rng.random((B, s)) ** 2 * c).astype(np.int64)
                for c, s in zip(counts, sizes)]
        out.append({
            "dense_features": torch.from_numpy(
                rng.normal(size=(B, dim_dense)).astype(np.float32)),
            "sparse_features": torch.from_numpy(
                np.concatenate(cols, 1).astype(np.int32)),
            "label": torch.from_numpy(
                (rng.random(B) < 0.3).astype(np.float32))})
    return out


def _view(model, mode, batch, dim, id_cap=None, seed=2):
    """The view the sparse step builds for `batch` in `mode`, over fresh
    random rows, and the ids the forward looks up."""
    spec = tsparse.dlrm_fused_table_spec(model, mode=mode)["embed_fused"]
    uids, _, rounds, srt = tsparse._dedup(spec(batch), "cpu", id_cap)
    gen = torch.Generator().manual_seed(seed)
    rows = torch.randn(uids.shape[0], dim, generator=gen)
    view = (tsparse.SubTable(uids, rows, *(srt or ())) if rounds is None
            else tsparse.HashSubTable(uids, rows, rounds=rounds))
    return view, model._fused_ids(batch["sparse_features"], view)


def _grad_of(fn, rows, seed=3):
    rows = rows.detach().clone().requires_grad_()
    out = fn(rows)
    gen = torch.Generator().manual_seed(seed)
    out.backward(torch.randn(out.shape, generator=gen) * 10)
    return out.detach(), rows.grad


@pytest.mark.parametrize("mode,id_cap", [(m, None) for m in MODES]
                         + [("flat", 40), ("flat", 1)],
                         ids=list(MODES) + ["flat-cap40", "flat-cap1"])
def test_lookup_gradient_is_index_select_autograd(mode, id_cap):
    model = _dlrm()
    batch = _batches(LN_EMB, (1,) * len(LN_EMB), n=1)[0]
    view, ids = _view(model, mode, batch, 6, id_cap)
    pos = view.positions(ids)
    if id_cap is not None:
        # the cap drops ids: their lookups clamp onto kept rows
        assert int(torch.unique(ids).numel()) > id_cap
    got = _grad_of(lambda r: _with_rows(view, r).lookup(ids), view.rows)
    want = _grad_of(lambda r: r.index_select(0, pos).reshape(
        *ids.shape, -1), view.rows)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def _with_rows(view, rows):
    view.rows = rows
    return view


@pytest.mark.parametrize("mode,id_cap", [("flat", None), ("hash", None),
                                         ("flat", 300), ("flat", 1)],
                         ids=["flat", "hash", "flat-cap300", "flat-cap1"])
def test_bags_gradient_is_embedding_bag_autograd(mode, id_cap):
    model = _dcn()
    batch = _batches(DCN["ln_emb"], DCN["multi_hot"], n=1)[0]
    view, ids = _view(model, mode, batch, DCN["m_spa"], id_cap)
    ids = ids.reshape(-1)
    C = sum(DCN["multi_hot"])
    starts = np.concatenate([[0], np.cumsum(DCN["multi_hot"])[:-1]])
    offsets = (torch.arange(ids.shape[0] // C)[:, None] * C
               + torch.from_numpy(starts)[None, :]).reshape(-1)
    pos = view.positions(ids)
    got = _grad_of(lambda r: _with_rows(view, r).bags(ids, offsets),
                   view.rows)
    want = _grad_of(lambda r: F.embedding_bag(pos, r, offsets, mode="sum"),
                    view.rows)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def _autograd_views(monkeypatch):
    """The views' lookups and bags as before `ops.view_grad`: autograd's
    own backward of `index_select` and `embedding_bag`."""
    monkeypatch.setattr(tsparse, "view_lookup",
                        lambda rows, pos, order=None:
                        rows.index_select(0, pos))
    monkeypatch.setattr(tsparse, "view_bags",
                        lambda rows, pos, offsets, order=None:
                        F.embedding_bag(pos, rows, offsets, mode="sum"))


def _train(model, mode, batches, id_cap=None):
    init, step = tsparse.make_sparse_train_step(
        model, tsparse.dlrm_fused_table_spec(model, mode=mode),
        learning_rate=0.01, id_cap=id_cap)
    state = init(model.params())
    losses = []
    for b in batches:
        state, loss = step(state, b)
        losses.append(loss)
    return ({n: p.detach().clone() for n, p in model.params().items()}
            | {f"mu/{k}": v for k, v in state["sparse"].mu.items()}
            | {f"nu/{k}": v for k, v in state["sparse"].nu.items()},
            torch.stack(losses))


@pytest.mark.parametrize("model,mode,id_cap",
                         [("dlrm", m, None) for m in MODES]
                         + [("dlrm", "flat", 40), ("dcn", "flat", None),
                            ("dcn", "hash", None), ("dcn", "flat", 300)],
                         ids=[f"dlrm-{m}" for m in MODES]
                         + ["dlrm-flat-cap40", "dcn-flat", "dcn-hash",
                            "dcn-flat-cap300"])
def test_sparse_steps_keep_their_bits(model, mode, id_cap, monkeypatch):
    """Three sparse steps with the views' gradients from `ops.view_grad`
    give the parameters, moments and losses of the same steps through
    autograd's own backward, to the bit."""
    make, counts, sizes = ((_dlrm, LN_EMB, (1,) * len(LN_EMB))
                           if model == "dlrm"
                           else (_dcn, DCN["ln_emb"], DCN["multi_hot"]))
    batches = _batches(counts, sizes,
                       dim_dense=4 if model == "dlrm" else 5)
    got, got_loss = _train(make(), mode, batches, id_cap)
    _autograd_views(monkeypatch)
    want, want_loss = _train(make(), mode, batches, id_cap)
    assert torch.equal(got_loss, want_loss)
    for k in want:
        assert torch.equal(got[k], want[k]), k


@pytest.mark.parametrize("model,mode", [("dlrm", m) for m in MODES]
                         + [("dcn", "flat"), ("dcn", "hash")])
def test_every_mode_takes_its_gradient_from_view_grad(model, mode,
                                                      monkeypatch):
    """Each sparse step takes its one table's view gradient from
    `view_grad`, once a step, in every dedup mode: no view reaches
    autograd's own `index_select` or `embedding_bag` backward."""
    calls = []
    real = vg.view_grad

    def spy(grad, positions, cap, order=None, bag=None):
        calls.append(bag is not None)
        return real(grad, positions, cap, order, bag)

    monkeypatch.setattr(vg, "view_grad", spy)
    make, counts, sizes = ((_dlrm, LN_EMB, (1,) * len(LN_EMB))
                           if model == "dlrm"
                           else (_dcn, DCN["ln_emb"], DCN["multi_hot"]))
    _train(make(), mode, _batches(counts, sizes, n=2,
                                  dim_dense=4 if model == "dlrm" else 5))
    assert calls == [model == "dcn"] * 2


@pytest.mark.parametrize("bags", [False, True])
def test_int32_and_int64_positions_give_one_gradient(bags):
    gen = torch.Generator().manual_seed(5)
    cap, n, D = 30, 400, 4
    pos = (torch.rand(n, generator=gen) ** 3 * cap).long()
    bag = (torch.sort(torch.randint(0, 50, (n,), generator=gen)).values
           if bags else None)
    grad = torch.randn(50 if bags else n, D, generator=gen)
    want = vg.view_grad(grad, pos, cap, bag=bag)
    got = vg.view_grad(grad, pos.int(), cap, bag=bag)
    assert got.dtype == torch.float32 and torch.equal(got, want)


@pytest.mark.parametrize("model,mode,handed", [("dlrm", "flat", True),
                                               ("dcn", "flat", True),
                                               ("dlrm", "columns", False),
                                               ("dcn", "hash", False)])
def test_the_flat_step_hands_its_sort_to_the_gradient(model, mode, handed,
                                                      monkeypatch):
    """In the flat mode the forward looks up the very ids the dedup
    sorted (`DLRM._fused_ids` takes the view's own tensor), so the lookup
    or the bags get the dedup's order and the backward sorts nothing; the
    other modes leave the grouping to `view_grad`."""
    seen = []
    for name in ("view_lookup", "view_bags"):
        real = getattr(tsparse, name)

        def spy(*args, real=real):
            seen.append(args[-1] is not None)
            return real(*args)

        monkeypatch.setattr(tsparse, name, spy)
    make, counts, sizes = ((_dlrm, LN_EMB, (1,) * len(LN_EMB))
                           if model == "dlrm"
                           else (_dcn, DCN["ln_emb"], DCN["multi_hot"]))
    _train(make(), mode, _batches(counts, sizes, n=2,
                                  dim_dense=4 if model == "dlrm" else 5))
    assert seen == [handed] * 2


@pytest.mark.parametrize("seed,n,hi,cap", [(0, 500, 40, 500),
                                           (1, 300, 1000, 300),
                                           (2, 1000, 100, 30),
                                           (3, 64, 5, 64)])
def test_unique_padded_order_is_stable_and_keeps_uids(seed, n, hi, cap):
    rng = np.random.default_rng(seed)
    ids = torch.from_numpy((rng.random(n) ** 3 * hi).astype(np.int32))
    uids, valid, order = tsparse.unique_padded_order(ids, cap)
    want = tsparse._compact_sorted(torch.sort(ids).values, cap)
    assert torch.equal(uids, want[0]) and torch.equal(valid, want[1])
    u2, v2 = tsparse.unique_padded(ids, cap)
    assert torch.equal(uids, u2) and torch.equal(valid, v2)
    assert order.dtype == torch.int64
    assert torch.equal(torch.sort(order).values, torch.arange(n))
    s = ids[order]
    assert bool((s[1:] >= s[:-1]).all())
    tie = s[1:] == s[:-1]
    assert bool((order[1:][tie] > order[:-1][tie]).all())


def test_subtable_hands_its_order_to_a_lookup_of_its_ids_only():
    ids = torch.tensor([[5, 1], [9, 1], [5, 5]], dtype=torch.int32)
    flat = ids.reshape(-1)
    uids, _, order = tsparse.unique_padded_order(flat, 6)
    view = tsparse.SubTable(uids, torch.zeros(6, 2), flat, order)
    assert view._order(ids) is order           # the same memory, reshaped
    assert view._order(flat) is order
    assert view._order(ids.clone()) is None    # equal values, other memory
    assert view._order(flat[:4]) is None
    assert tsparse.SubTable(uids, torch.zeros(6, 2))._order(flat) is None
    ids.add_(0)                                # written since the dedup
    assert view._order(ids) is None


@pytest.mark.parametrize("case", ["same", "other-shape", "other-values"])
def test_dlrm_looks_up_a_views_own_ids(case):
    """`DLRM._fused_ids` takes a view's own ids tensor where it holds this
    batch's fused ids, its own flat ids where the view's are of another
    shape (another rank's batch), and stops where the shapes agree and
    the values do not."""
    model = _dlrm()
    sparse = torch.as_tensor(
        _batches(LN_EMB, (1,) * len(LN_EMB), n=1)[0]["sparse_features"])
    flat = model.flat_sparse_ids(sparse).reshape(-1)
    ids = {"same": flat.clone(), "other-shape": flat[:-5].clone(),
           "other-values": flat.flip(0)}[case]
    uids, _, order = tsparse.unique_padded_order(ids, ids.shape[0])
    view = tsparse.SubTable(uids, torch.zeros(uids.shape[0], 2), ids, order)
    if case == "other-values":
        with pytest.raises(RuntimeError):
            model._fused_ids(sparse, view)
        return
    got = model._fused_ids(sparse, view)
    assert (got is ids) == (case == "same") and torch.equal(got, flat)
    assert (view._order(got) is order) == (case == "same")


@pytest.mark.parametrize("chunk", [2, 3, 8, 128])
@pytest.mark.parametrize("bags", [False, True])
def test_chunked_sum_is_the_kernels_order(chunk, bags):
    """`view_grad_model.chunked_sum`, which the card tests hold the kernel
    to bit for bit, against its definition written as a loop over rows:
    rows of no lookup, of at most a chunk, of several full chunks and a
    tail, and of full chunks alone."""
    gen = torch.Generator().manual_seed(chunk)
    cap, n, D = 40, 700, 3
    pos = (torch.rand(n, generator=gen) ** 4 * (cap - 5)).long()
    pos[:chunk * 4] = cap - 2                       # a row of full chunks
    if bags:
        bag = torch.sort(torch.randint(0, 60, (n,), generator=gen)).values
        grad = torch.randn(60, D, generator=gen)
    else:
        bag, grad = None, torch.randn(n, D, generator=gen)
    got = view_grad_model.chunked_sum(grad, pos, cap, bag, chunk)
    src = grad if bag is None else grad[bag]
    want = torch.zeros(cap, D)
    for r in range(cap):
        xs = src[pos == r]
        full = len(xs) // chunk if len(xs) > chunk else 0
        acc = torch.zeros(D)
        for k in range(full):
            part = torch.zeros(D)
            for x in xs[k * chunk:(k + 1) * chunk]:
                part = part + x
            acc = acc + part
        for x in xs[full * chunk:]:
            acc = acc + x
        want[r] = acc
    assert torch.equal(got, want)
    assert bool((got[cap - 5:cap - 2] == 0).all())


@pytest.mark.parametrize("offsets,n,want", [
    ([0, 2, 2, 5], 7, [0, 0, 2, 2, 2, 3, 3]),
    ([0], 3, [0, 0, 0]),
    ([0, 0, 1], 1, [1])])
def test_bag_of_each_lookup(offsets, n, want):
    got = vg.bag_of(torch.tensor(offsets), n)
    assert got.dtype == torch.int64 and got.tolist() == want


def test_plain_version_is_autograds_order_on_the_cpu():
    """`view_grad_plain` alone: lookups summed in their order (the CPU
    `index_add_`), bags in the order of a sort of the positions, as
    ATen's CPU `embedding_bag` backward; pads and rows no lookup reads
    come out zero."""
    gen = torch.Generator().manual_seed(0)
    n, cap, D = 20_000, 60, 16
    pos = (torch.rand(n, generator=gen) ** 3 * (cap - 10)).long()
    g = torch.randn(n, D, generator=gen) * 10
    want = torch.zeros(cap, D).index_add_(0, pos, g)
    assert torch.equal(vg.view_grad_plain(g, pos, cap), want)
    assert torch.equal(vg.view_grad(g, pos, cap), want)
    offsets = torch.sort(torch.randint(0, n, (900,), generator=gen)).values
    offsets[0] = 0
    _, want_b = _grad_of(lambda r: F.embedding_bag(pos, r, offsets,
                                                   mode="sum"),
                         torch.randn(cap, D, generator=gen))
    _, got_b = _grad_of(lambda r: vg.view_bags(r, pos, offsets),
                        torch.randn(cap, D, generator=gen))
    assert torch.equal(got_b, want_b)
    assert not want[cap - 10:].any() and not got_b[cap - 10:].any()


@pytest.mark.parametrize("case", ["grad-float64", "grad-1d", "order-int32",
                                  "positions-float", "bag-short",
                                  "rows-mismatch", "cap-0"])
def test_launch_checks_its_arguments(case):
    """The card wrapper's checks, which run before anything reaches the
    card: each bad argument raises, and nothing is counted."""
    n, D, cap = 10, 4, 6
    args = dict(grad=torch.zeros(n, D),
                positions=torch.zeros(n, dtype=torch.long), cap=cap, order=torch.arange(n), bag=None)
    err = TypeError
    if case == "grad-float64":
        args["grad"] = args["grad"].double()
    elif case == "grad-1d":
        args["grad"] = torch.zeros(n * D)
    elif case == "order-int32":
        args["order"] = args["order"].int()
    elif case == "positions-float":
        args["positions"] = args["positions"].float()
    elif case == "bag-short":
        args["bag"] = torch.zeros(n - 1, dtype=torch.long)
    elif case == "rows-mismatch":
        args["grad"], err = torch.zeros(n + 1, D), ValueError
    else:
        args["cap"], err = 0, ValueError
    before = trace.counter(vg.LAUNCHES)
    with pytest.raises(err):
        vg._launch(**args)
    assert trace.counter(vg.LAUNCHES) == before


@pytest.mark.parametrize("self_interaction", [False, True])
def test_dot_interaction_gradient_is_advanced_indexings(self_interaction):
    """The dot interaction's pairs, taken by one `index_select` over the
    flattened Gram matrix, give the values and the gradient of indexing
    by the two triangle index tensors, to the bit."""
    gen = torch.Generator().manual_seed(5)
    feats = torch.randn(300, 27, 16, generator=gen)
    w = torch.randn(300, 27 * 26 // 2 + 27 * self_interaction,
                    generator=gen)

    def indexed(x):
        gram = torch.bmm(x, x.transpose(1, 2))
        iu = torch.triu_indices(27, 27, offset=0 if self_interaction else 1)
        return gram[:, iu[0], iu[1]]

    got = _grad_of(lambda x: second_order_interaction(
        x, self_interaction=self_interaction) * w, feats)
    want = _grad_of(lambda x: indexed(x) * w, feats)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
