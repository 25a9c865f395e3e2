"""The view-gradient kernel (`csrc/view_grad.cu`, `ops.view_grad`) on the
card.

Bars:
- torch.equal to `view_grad_model.chunked_sum`, the kernel's summation
  order written in plain PyTorch on the CPU, at D 16, 20, 50 (the scalar
  route) and 128, with int32 and int64 positions;
- against the plain version (`view_grad_plain`, one lookup after another
  on the CPU), within the bound of two fp32 summation orders, every row
  no lookup reads exactly zero (`kernel_cases.check_view_grad`);
- a row holding half the lookups (many chunks), pads and empty hash
  slots, fewer lookups than one chunk and none, bags of 1-100 ids as in
  dlrm-dcnv2.train-multihot;
- at both training cells' shapes, one batch of each cell's ids through
  the flat dedup, with its order, as the sparse step hands them
  (`kernel_cases.VIEW_GRAD`: train-zipf's 1,703,936 Zipf(1.05) lookups
  into a [1,703,936, 16] view; train-multihot's 1,753,088 lookups in
  212,992 bags into a [1,753,088, 128] view): `kernel_cases.
  hold_view_grad`, two calls torch.equal, within the two orders' bound of
  the plain version and of ATen's autograd backward (`index_select`'s,
  `embedding_bag`'s) on the card, one launch a call;
- two runs torch.equal; the flat, columns, mixed and hash modes give
  torch.equal gradients to every row over one DLRM step; one launch a
  table and step in `openrec.view_grad.launches`; a gradient that is not
  float32 raises;
- the dot interaction's pairs (`second_order_interaction`, one
  `index_select`) give the gradient of indexing by the triangle's two
  index tensors, torch.equal, at dlrm-kaggle's 27 features.

The kernel has no CPU version, so every test needs a CUDA card and skips
without one. On a machine with a card, from the repository's root:

    python -m pytest --noconftest -p no:cacheprovider -m card \\
        tests/test_torch_view_grad_card.py

(`--noconftest`: the suite's conftest.py sets JAX up for the CPU tests,
and this file imports neither JAX nor the JAX package.)
"""

import pytest
import torch

import view_grad_model
from kernel_cases import (VIEW_GRAD, check_view_grad, hold_view_grad,
                          view_grad_inputs)
from openrec_tpu_torch import trace
from openrec_tpu_torch.models import DLRM
from openrec_tpu_torch.modules.interactions import second_order_interaction
from openrec_tpu_torch.ops import view_grad as vg
from openrec_tpu_torch.training import Trainer
from openrec_tpu_torch.training import sparse as tsparse

pytestmark = pytest.mark.card

LN_EMB = (500, 800, 300, 40)
MODES = ("flat", "columns", "mixed", "hash")


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the view-gradient kernel has no CPU "
                    "version")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", 0)


def _held(grad, pos, cap, bag=None):
    """The kernel's gradient, checked against the model (equal) and the
    plain version (within two summation orders' bound); returns it."""
    before = trace.counter(vg.LAUNCHES)
    order = torch.sort(pos, stable=True).indices
    got = vg.view_grad(grad, pos, cap, order=order, bag=bag)
    torch.cuda.synchronize()
    assert trace.counter(vg.LAUNCHES) == before + 1
    assert got.shape == (cap, grad.shape[1]) and got.dtype == torch.float32
    cpu = [None if t is None else t.cpu() for t in (grad, pos, bag)]
    got_cpu = got.cpu()
    assert torch.equal(got_cpu, view_grad_model.chunked_sum(
        *cpu[:2], cap, cpu[2], vg.CHUNK))
    check_view_grad(torch, vg, got_cpu, *cpu[:2], cap, cpu[2],
                    {"plain": vg.view_grad_plain(cpu[0], cpu[1], cap,
                                                 cpu[2])}, "view_grad")
    return got


def _zipf_positions(gen, n, cap, dev, dtype, live=None):
    """Positions of n lookups, skewed as rank ** -1.05 over `live` rows
    (default cap) spread over the view through a seeded permutation."""
    live = live or cap
    w = torch.arange(1, live + 1, dtype=torch.float64) ** -1.05
    ranks = torch.multinomial(w, n, replacement=True, generator=gen)
    rows = torch.randperm(cap, generator=gen)[:live]
    return rows[ranks].to(dtype).to(dev)


@pytest.mark.parametrize("index", (torch.int32, torch.int64))
@pytest.mark.parametrize("dim", (16, 20, 50, 128))
def test_kernel_equals_model_and_plain(cuda, dim, index):
    gen = torch.Generator().manual_seed(dim)
    n, cap = 100_000, 60_000
    pos = _zipf_positions(gen, n, cap, cuda, index, live=20_000)
    grad = (torch.randn(n, dim, generator=gen) * 3).to(cuda)
    got = _held(grad, pos, cap)
    hit = torch.zeros(cap, dtype=torch.bool, device=cuda)
    hit[pos.long()] = True
    assert bool((got[~hit] == 0).all()) and bool(got[hit].any(1).all())


def test_unaligned_gradient_takes_the_scalar_route(cuda):
    gen = torch.Generator().manual_seed(0)
    n, cap, dim = 30_000, 5_000, 16
    buf = torch.randn(n * dim + 1, generator=gen).to(cuda)
    pos = _zipf_positions(gen, n, cap, cuda, torch.int64)
    _held(buf[1:].view(n, dim), pos, cap)


@pytest.mark.parametrize("dim", (16, 128))
def test_one_row_holds_half_the_lookups(cuda, dim):
    """A Zipf-hot row far longer than a chunk: its chunks spread over many
    groups and its partials are summed in order."""
    gen = torch.Generator().manual_seed(1)
    n, cap = 200_000, 10_000
    pos = torch.randint(0, cap, (n,), generator=gen)
    pos[torch.rand(n, generator=gen) < 0.5] = 7
    assert int((pos == 7).sum()) > 300 * vg.CHUNK
    _held(torch.randn(n, dim, generator=gen).to(cuda), pos.to(cuda), cap)


def test_pads_and_empty_hash_slots_are_exact_zeros(cuda):
    """The flat dedup's layout (live rows first, pads after) and a hash
    table's (live slots scattered among empty ones)."""
    gen = torch.Generator().manual_seed(2)
    n, live, dim = 50_000, 4_000, 16
    flat = _zipf_positions(gen, n, live, cuda, torch.int64)
    got = _held(torch.randn(n, dim, generator=gen).to(cuda), flat, n)
    assert bool((got[live:] == 0).all())
    slots = torch.randperm(1 << 17, generator=gen)[:live].to(cuda)
    hashed = slots[flat]
    got = _held(torch.randn(n, dim, generator=gen).to(cuda), hashed,
                1 << 17)
    empty = torch.ones(1 << 17, dtype=torch.bool, device=cuda)
    empty[slots] = False
    assert bool((got[empty] == 0).all())


@pytest.mark.parametrize("n", (0, 1, 5, vg.CHUNK - 1, vg.CHUNK,
                               vg.CHUNK + 1))
def test_fewer_lookups_than_a_chunk(cuda, n):
    gen = torch.Generator().manual_seed(n)
    cap, dim = 37, 20
    # from a chunk on, one row: a row of exactly a chunk and one more
    pos = (torch.rand(n, generator=gen) ** 2 * 3).long() if n < vg.CHUNK \
        else torch.full((n,), 5)
    got = _held(torch.randn(n, dim, generator=gen).to(cuda), pos.to(cuda),
                cap)
    if n == 0:
        assert not got.any()


@pytest.mark.parametrize("index", (torch.int32, torch.int64))
def test_bags_of_1_to_100_ids(cuda, index):
    """dlrm-dcnv2.train-multihot's bags (MLPerf's 26 sizes, 1 to 100) over
    2,048 examples at D 128, the first id of a bag Zipf-skewed and the
    others following it, as its traffic draws them."""
    sizes = (3, 2, 1, 2, 6, 1, 1, 1, 1, 7, 3, 8, 1, 6, 9, 5, 1, 1, 1, 12,
             100, 27, 10, 3, 1, 1)
    gen = torch.Generator().manual_seed(3)
    B, C, cap, dim = 2_048, sum(sizes), 150_000, 128
    first = _zipf_positions(gen, B, cap, "cpu", torch.int64, live=30_000)
    salt = torch.randint(0, cap, (C,), generator=gen)
    pos = (first[:, None] * 7919 + salt[None, :]) % cap
    pos[:, 0] = first
    pos = pos.reshape(-1)
    starts = torch.cumsum(torch.tensor((0,) + sizes[:-1]), 0)
    offsets = (torch.arange(B)[:, None] * C + starts[None, :]).reshape(-1)
    bag = vg.bag_of(offsets.to(cuda), pos.shape[0])
    grad = torch.randn(offsets.shape[0], dim, generator=gen).to(cuda)
    _held(grad, pos.to(index).to(cuda), cap, bag)
    rows = torch.randn(cap, dim, generator=gen).to(cuda).requires_grad_()
    pooled = vg.view_bags(rows, pos.to(cuda), offsets.to(cuda))
    pooled.backward(grad)
    assert torch.equal(rows.grad, vg.view_grad(
        grad, pos.to(cuda), cap, bag=bag))


@pytest.mark.parametrize("cell", tuple(VIEW_GRAD))
def test_the_cells_shapes(cuda, cell):
    hold_view_grad(torch, vg, view_grad_inputs(torch, cuda, 0, cell), cell)


def test_two_runs_are_equal(cuda):
    gen = torch.Generator().manual_seed(4)
    n, cap, dim = 300_000, 100_000, 16
    pos = _zipf_positions(gen, n, cap, cuda, torch.int64)
    grad = torch.randn(n, dim, generator=gen).to(cuda)
    a = vg.view_grad(grad, pos, cap)
    b = vg.view_grad(grad, pos, cap)
    assert torch.equal(a, b)


def _dlrm(dev, dim):
    gen = torch.Generator(device=dev).manual_seed(0)
    return DLRM(m_spa=dim, ln_emb=LN_EMB, ln_bot=(32, dim),
                ln_top=(64, 1), dim_dense=5, loss_func="bce",
                fused_tables=True, device=dev, generator=gen)


def _batch(dev, B=4_096, seed=1):
    gen = torch.Generator(device=dev).manual_seed(seed)
    # squared uniforms: the 40-row table's first row takes ~650 lookups
    sparse = torch.stack(
        [(torch.rand(B, device=dev, generator=gen) ** 2 * c).long()
         for c in LN_EMB], dim=1).to(torch.int32)
    return {"dense_features": torch.randn(B, 5, device=dev, generator=gen),
            "sparse_features": sparse,
            "label": (torch.rand(B, device=dev, generator=gen) < 0.3)
            .float()}


@pytest.mark.parametrize("dim", (16, 20))
def test_every_mode_gives_the_same_gradient(cuda, dim, monkeypatch):
    """One DLRM step in each dedup mode from the same weights: the table
    gradient each live row receives (as the tables' Adam is handed it),
    torch.equal across modes, though each mode lays the rows out in its
    own order and so cuts the sorted stream elsewhere."""
    grads = {}

    def apply(table, mu, nu, at, write, g, alpha, b1, b2, eps):
        full = torch.zeros_like(table)
        full[at[write].long()] = g[write]
        grads[mode] = full

    monkeypatch.setattr(tsparse, "sparse_adam_apply", apply)
    batch = _batch(cuda)
    for mode in MODES:
        model = _dlrm(cuda, dim)
        init, step = tsparse.make_sparse_train_step(
            model, tsparse.dlrm_fused_table_spec(model, mode=mode),
            learning_rate=0.01)
        before = trace.counter(vg.LAUNCHES)
        step(init(model.params()), batch)
        torch.cuda.synchronize(cuda)
        assert trace.counter(vg.LAUNCHES) == before + 1
    touched = grads["flat"].any(1)
    assert int(touched.sum()) > 100
    for mode in MODES[1:]:
        assert torch.equal(grads[mode], grads["flat"]), mode


def test_one_launch_a_table_and_step(cuda):
    gen = torch.Generator(device=cuda).manual_seed(0)
    model = DLRM(m_spa=16, ln_emb=LN_EMB, ln_bot=(32, 16), ln_top=(64, 1),
                 dim_dense=5, loss_func="bce", device=cuda, generator=gen)
    init, step = tsparse.make_sparse_train_step(
        model, tsparse.dlrm_table_specs(len(LN_EMB)), learning_rate=0.01)
    state = init(model.params())
    before = trace.counter(vg.LAUNCHES)
    for seed in range(3):
        state, _ = step(state, _batch(cuda, B=256, seed=seed))
    assert trace.counter(vg.LAUNCHES) - before == 3 * len(LN_EMB)
    model = _dlrm(cuda, 16)
    trainer = Trainer(model, lr=0.01, device=cuda,
                      sparse_tables=tsparse.dlrm_fused_table_spec(model))
    before = trace.counter(vg.LAUNCHES)
    for seed in range(2):
        trainer.train_step(_batch(cuda, B=256, seed=seed))
    assert trace.counter(vg.LAUNCHES) - before == 2


@pytest.mark.parametrize("dtype", (torch.float64, torch.bfloat16))
def test_kernel_refuses_a_gradient_not_float32(cuda, dtype):
    grad = torch.ones(4, 8, device=cuda, dtype=dtype)
    pos = torch.tensor([0, 2, 2, 1], device=cuda)
    before = trace.counter(vg.LAUNCHES)
    with pytest.raises(TypeError, match="float32"):
        vg.view_grad(grad, pos, 3)
    assert trace.counter(vg.LAUNCHES) == before



def test_dot_interaction_gradient_on_the_card(cuda):
    """Each pair's gradient lands on its own Gram entry, so the atomic
    `index_add_` behind `index_select`'s backward adds once into zero:
    torch.equal to indexing's sorted accumulation, run after run."""
    gen = torch.Generator().manual_seed(6)
    feats = torch.randn(8_192, 27, 16, generator=gen).to(cuda)
    w = torch.randn(8_192, 351, generator=gen).to(cuda)
    iu = torch.triu_indices(27, 27, offset=1, device=cuda)

    def grad_of(take):
        x = feats.clone().requires_grad_()
        out = take(x)
        (out * w).sum().backward()
        return out.detach(), x.grad

    want = grad_of(lambda x: torch.bmm(x, x.transpose(1, 2))[:, iu[0],
                                                              iu[1]])
    got = grad_of(second_order_interaction)
    again = grad_of(second_order_interaction)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert torch.equal(again[1], got[1])
