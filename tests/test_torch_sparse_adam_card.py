"""The sparse-Adam write-back kernel (`csrc/sparse_adam.cu`) against its
plain version (`ops.sparse_adam.sparse_adam_plain`), on the card.

Bars, all `torch.equal` of table, mu and nu: every call of 5 sparse DLRM
steps in each dedup mode at D = 16, 20, 50, 64, 100 and 128 (the kernel's
float4 route where D % 4 == 0, its scalar route at 50), on either block
of a row-sharded layout, and direct calls with int32 and int64 rows, an
unaligned gradient and one row that every pad repeats; direct calls at
the training cells' shapes (`kernel_cases.SPARSE_ADAM`: train-zipf's
33,762,577 x 16 table, 210,127 live of 1,703,936 slots, in the flat
dedup's layout and the partial path's; `SPARSE_ADAM_DCN`: dlrm-dcnv2's
26,500,127 x 128 table in the flat layout), held by
`kernel_cases.hold_sparse_adam` (live rows `torch.equal`, every other row
unchanged by an exact checksum, since two whole dlrm-dcnv2 states do not
fit on the card), where at least half the live rows must move; one
launch is counted a call, and a table and step; a card table that is
not float32 raises.

The kernel has no CPU version, so every test needs a CUDA card and skips
without one. On a machine with a card, from the repository's root:

    python -m pytest --noconftest -p no:cacheprovider -m card \\
        tests/test_torch_sparse_adam_card.py

(`--noconftest`: the suite's conftest.py sets JAX up for the CPU tests,
and this file imports neither JAX nor the JAX package.)
"""

import pytest
import torch

from kernel_cases import (SPARSE_ADAM, SPARSE_ADAM_DCN, hold_sparse_adam,
                          sparse_adam_hyper, sparse_adam_inputs)
from openrec_tpu_torch import trace
from openrec_tpu_torch.models import DLRM
from openrec_tpu_torch.ops import sparse_adam as sa
from openrec_tpu_torch.training import Trainer
from openrec_tpu_torch.training import sparse as tsparse

pytestmark = pytest.mark.card

LN_EMB = (500, 800, 300, 40)
MODES = ("flat", "columns", "mixed", "hash")
DIMS = (16, 20, 50, 64, 100, 128)
LAUNCHES = "openrec.sparse_adam.launches"


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the sparse-Adam kernel has no CPU "
                    "version")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", 0)


def _dlrm(dev, dim, fused=True, seed=0):
    gen = torch.Generator(device=dev).manual_seed(seed)
    return DLRM(m_spa=dim, ln_emb=LN_EMB, ln_bot=(32, dim),
                ln_top=(64, 1), dim_dense=5, loss_func="bce",
                fused_tables=fused, device=dev, generator=gen)


def _batches(dev, n=5, B=256, seed=1):
    gen = torch.Generator(device=dev).manual_seed(seed)
    out = []
    for _ in range(n):
        # squared uniforms: skewed ids, so each batch has pads
        sparse = torch.stack(
            [(torch.rand(B, device=dev, generator=gen) ** 2 * c).long()
             for c in LN_EMB], dim=1).to(torch.int32)
        out.append({
            "dense_features": torch.randn(B, 5, device=dev, generator=gen),
            "sparse_features": sparse,
            "label": (torch.rand(B, device=dev, generator=gen) < 0.3)
            .float()})
    return out


class _RowBlock(tsparse.RowLayout):
    """Block `block` of two equal row blocks of every table, as one rank of
    a two-way model mesh holds it, with nothing joined."""

    def __init__(self, block: int):
        self.block = block

    def sharded(self, name):
        return True

    def shard_range(self, name, table):
        return self.block * table.shape[0], table.shape[0]


def _held_against_plain(monkeypatch):
    """Make the step's every call run the plain version on copies before
    the kernel runs on the step's own tensors, and compare; returns the
    list of calls' dead-slot counts."""
    real = tsparse.sparse_adam_apply
    calls = []

    def apply(table, mu, nu, at, write, g, alpha, b1, b2, eps):
        want = [t.clone() for t in (table, mu, nu)]
        sa.sparse_adam_plain(*want, at, write, g, alpha, b1, b2, eps)
        before = trace.counter(LAUNCHES)
        real(table, mu, nu, at, write, g, alpha, b1, b2, eps)
        assert trace.counter(LAUNCHES) == before + 1
        for name, got, w in zip(("table", "mu", "nu"), (table, mu, nu),
                                want):
            assert torch.equal(got, w), name
        calls.append(int((~write).sum()))

    monkeypatch.setattr(tsparse, "sparse_adam_apply", apply)
    return calls


def _steps(model, specs, dev, layout=None, n=5):
    init, step = tsparse.make_sparse_train_step(model, specs,
                                                learning_rate=0.01,
                                                layout=layout)
    state = init(model.params())
    for b in _batches(dev, n=n):
        state, _ = step(state, b)
    torch.cuda.synchronize(dev)
    return state


@pytest.mark.parametrize("dim", DIMS)
@pytest.mark.parametrize("mode", MODES)
def test_kernel_equals_plain_in_every_mode(cuda, monkeypatch, mode, dim):
    calls = _held_against_plain(monkeypatch)
    model = _dlrm(cuda, dim)
    _steps(model, tsparse.dlrm_fused_table_spec(model, mode=mode), cuda)
    assert len(calls) == 5 and sum(calls) > 0


@pytest.mark.parametrize("dim", (16, 50))
@pytest.mark.parametrize("block", (0, 1))
def test_kernel_equals_plain_on_a_row_block(cuda, monkeypatch, block, dim):
    calls = _held_against_plain(monkeypatch)
    model = _dlrm(cuda, dim)
    n = sum(LN_EMB) // 2
    model.embed_fused = torch.nn.Parameter(
        model.embed_fused.detach()[block * n:(block + 1) * n].clone())
    _steps(model, tsparse.dlrm_fused_table_spec(model), cuda,
           layout=_RowBlock(block))
    assert len(calls) == 5 and sum(calls) > 0


def test_one_launch_a_table_and_step(cuda):
    model = _dlrm(cuda, 16, fused=False)
    before = trace.counter(LAUNCHES)
    _steps(model, tsparse.dlrm_table_specs(len(LN_EMB)), cuda, n=3)
    assert trace.counter(LAUNCHES) - before == 3 * len(LN_EMB)
    model = _dlrm(cuda, 16)
    trainer = Trainer(model, lr=0.01, device=cuda,
                      sparse_tables=tsparse.dlrm_fused_table_spec(model))
    before = trace.counter(LAUNCHES)
    for b in _batches(cuda, n=2):
        trainer.train_step(b)
    assert trace.counter(LAUNCHES) - before == 2


@pytest.mark.parametrize("index", (torch.int32, torch.int64))
@pytest.mark.parametrize("dim,offset", [(16, 0), (16, 1), (20, 0), (1, 0),
                                        (100, 0)],
                         ids=["16", "16-unaligned", "20", "1", "100"])
def test_kernel_equals_plain_direct(cuda, index, dim, offset):
    """100,000 slots on 50,000 rows, a tenth of them live on distinct
    rows, the rest repeating one of them; moments of mixed scales."""
    gen = torch.Generator(device=cuda).manual_seed(dim)
    rows, cap = 50_000, 100_000
    table = torch.randn(rows, dim, device=cuda, generator=gen)
    mu = torch.randn(rows, dim, device=cuda, generator=gen) * 1e-2
    nu = torch.rand(rows, dim, device=cuda, generator=gen) ** 4
    live = torch.randperm(rows, device=cuda, generator=gen)[:cap // 10]
    at = torch.full((cap,), int(live[-1]), device=cuda)
    at[:live.numel()] = live
    write = torch.zeros(cap, dtype=torch.bool, device=cuda)
    write[:live.numel()] = True
    buf = torch.randn(cap * dim + offset, device=cuda, generator=gen) * 3
    g = buf[offset:].view(cap, dim)
    alpha = torch.tensor(1e-3, device=cuda) * 0.97
    want = [t.clone() for t in (table, mu, nu)]
    sa.sparse_adam_plain(*want, at.to(index), write, g, alpha, 0.9, 0.999,
                         1e-7)
    sa.sparse_adam_apply(table, mu, nu, at.to(index), write, g, alpha, 0.9,
                         0.999, 1e-7)
    torch.cuda.synchronize(cuda)
    for got, w in zip((table, mu, nu), want):
        assert torch.equal(got, w)


@pytest.mark.parametrize("cfg,layout", [(SPARSE_ADAM, "flat"),
                                        (SPARSE_ADAM, "partial"),
                                        (SPARSE_ADAM_DCN, "flat")],
                         ids=["train-zipf-flat", "train-zipf-partial",
                              "dlrm-dcnv2-flat"])
def test_kernel_equals_plain_at_the_cells_shapes(cuda, cfg, layout):
    torch.cuda.empty_cache()
    gen = torch.Generator(device=cuda).manual_seed(0)
    args = sparse_adam_inputs(torch, gen, cuda, layout, cfg)
    hold_sparse_adam(torch, sa, (*args, *sparse_adam_hyper(cfg)), layout)


@pytest.mark.parametrize("dtype", (torch.float64, torch.bfloat16))
def test_kernel_refuses_a_table_not_float32(cuda, dtype):
    """A card tensor always takes the kernel, which updates float32 tables
    alone: any other table raises, and nothing is counted or written."""
    table = torch.ones(8, 4, device=cuda, dtype=dtype)
    mu, nu = torch.zeros_like(table), torch.zeros_like(table)
    g = torch.ones(2, 4, device=cuda, dtype=dtype)
    before = trace.counter(LAUNCHES)
    with pytest.raises(TypeError, match="float32"):
        sa.sparse_adam_apply(table, mu, nu, torch.tensor([1, 3], device=cuda),
                             torch.tensor([True, True], device=cuda), g,
                             torch.tensor(1e-3, device=cuda), 0.9, 0.999,
                             1e-7)
    assert trace.counter(LAUNCHES) == before
    assert bool((table == 1).all()) and not mu.any()
