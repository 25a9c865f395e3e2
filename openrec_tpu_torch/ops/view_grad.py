"""The gradient of a gathered view's lookups and bags: the CUDA kernel, its
plain PyTorch version, and the two autograd Functions that reach them.

The sparse step (`training/sparse.py`) looks a table up through a gathered
view (`SubTable`, `HashSubTable`) of rows [cap, D]: lookup i reads row
`positions[i]`, alone (`view_lookup`) or summed into a bag (`view_bags`,
the multi-hot DLRM's pooling, `F.embedding_bag(mode="sum")`). The view's
gradient row r is the sum, over the lookups i at r, of the gradient of
lookup i's output, or of its bag's. The forward is PyTorch's own
(`index_select`, `embedding_bag`); the backward is `view_grad`.

On a CUDA tensor `view_grad` launches `csrc/view_grad.cu` (built at first
use) and counts the launch in `openrec.view_grad.launches` (`trace.py`).
The kernel takes the lookups' grouping by row as `order`, a permutation
that sorts them by position, stable, so each row's lookups keep the
batch's order: the flat dedup's sort of the same ids where the view
hands it (`training.sparse.SubTable`), else one stable sort of the
positions here, counted in `openrec.view_grad.sorts`. It sums each row
in chunks of `CHUNK` of its lookups counted from its first, with no
atomics, and writes every row of the float32 [cap, D] gradient once
(zeros where no lookup reads it). A row's sum depends on its own
lookups, in order, alone: the same in every dedup mode and in every
run. The kernel takes float32 gradients and raises on any other dtype.

On a CPU tensor `view_grad_plain` runs: each row's lookups summed one
after another from zero (`index_add_`), in the order autograd's own CPU
backward took them, so the CPU path gives the bits it gave before the
kernel. The card tests hold the kernel against it within the error of
two summation orders (fp32 sums in another order).
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from openrec_tpu_torch import trace

LAUNCHES = "openrec.view_grad.launches"
# the backward's own sorts, where a view hands no order (card only)
SORTS = "openrec.view_grad.sorts"
# a row's lookups are summed in chunks of this many (csrc/view_grad.cu's
# kChunk, which sizes the scratch; the wrapper checks that they agree)
CHUNK = 128


def view_grad_plain(grad, positions, cap: int, bag=None):
    """The kernel's function in plain PyTorch: row r of the [cap, D]
    result is the sum, from zero and one lookup after another
    (`index_add_`), of grad[i] over the lookups i at r (grad[bag[i]] for
    bags). Lookups are summed in their own order, as the CPU backward of
    `index_select` sums them; bags in the order of a sort of the
    positions, as ATen's CPU backward of `embedding_bag` does."""
    src = grad
    if bag is not None:
        order = torch.sort(positions).indices
        positions = positions.index_select(0, order)
        src = grad.index_select(0, bag.index_select(0, order))
    return torch.zeros(cap, grad.shape[1], dtype=grad.dtype,
                       device=grad.device).index_add_(0, positions, src)


def bag_of(offsets: torch.Tensor, n: int) -> torch.Tensor:
    """[n] int64: the bag of each of n lookups, bag j holding lookups
    offsets[j] : offsets[j + 1] (the last to n), offsets[0] == 0 as
    `embedding_bag` asks; no host read."""
    ends = torch.cat([offsets[1:], offsets.new_full((1,), n)])
    return torch.repeat_interleave(
        torch.arange(offsets.shape[0], device=offsets.device),
        ends - offsets, output_size=n)


def _kernel_fn():
    from openrec_tpu_torch.ops import _build
    lib = _build.load("view_grad")
    fn = lib.openrec_view_grad
    if fn.argtypes is None:
        if lib.openrec_view_grad_chunk() != CHUNK:
            raise RuntimeError("csrc/view_grad.cu's chunk differs from "
                               f"CHUNK = {CHUNK}")
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        fn.argtypes = [p, p, i, p, p, ll, ll, i, i, p, p, p, p]
        fn.restype = ctypes.c_int
    return fn


def _launch(grad, positions, cap: int, order, bag) -> torch.Tensor:
    dev = grad.device
    if grad.dtype != torch.float32 or grad.dim() != 2:
        raise TypeError(f"grad must be 2-D float32, not {grad.dtype} "
                        f"{tuple(grad.shape)}")
    if positions.dim() != 1 or positions.dtype not in (torch.int32,
                                                       torch.int64):
        raise TypeError("positions must be 1-D int32 or int64, not "
                        f"{positions.dtype} {tuple(positions.shape)}")
    n = positions.shape[0]
    if tuple(order.shape) != (n,) or order.dtype != torch.int64:
        raise TypeError(f"order must be int64 [{n}], not {order.dtype} "
                        f"{tuple(order.shape)}")
    if bag is None and grad.shape[0] != n:
        raise ValueError(f"grad has {grad.shape[0]} rows for {n} lookups")
    if bag is not None and (tuple(bag.shape) != (n,)
                            or bag.dtype != torch.int64):
        raise TypeError(f"bag must be int64 [{n}]")
    if not 0 < cap < 2 ** 31 or n >= 2 ** 31 or grad.shape[0] >= 2 ** 31:
        raise ValueError(f"cap {cap}, {n} lookups and {grad.shape[0]} "
                         "gradient rows must fit int32 (cap at least 1)")
    if any(t is not None and t.device != dev for t in (positions, order,
                                                       bag)):
        raise ValueError("every tensor must lie on the gradient's device")
    D = grad.shape[1]
    grad, positions, order = (grad.contiguous(), positions.contiguous(),
                              order.contiguous())
    bag = None if bag is None else bag.contiguous()
    work = torch.empty(2 * n + 2 * cap, dtype=torch.int32, device=dev)
    partials = torch.empty(-(-n // CHUNK), D, dtype=torch.float32,
                           device=dev)
    out = torch.empty(cap, D, dtype=torch.float32, device=dev)
    vec4 = D % 4 == 0 and grad.data_ptr() % 16 == 0
    with torch.cuda.device(dev):
        err = _kernel_fn()(
            grad.data_ptr(), positions.data_ptr(),
            int(positions.dtype == torch.int64), order.data_ptr(),
            None if bag is None else bag.data_ptr(), n, cap, D, int(vec4),
            work.data_ptr(), partials.data_ptr(), out.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"view_grad kernel launch failed: CUDA error "
                           f"{err}")
    return out


def view_grad(grad, positions, cap: int, order=None, bag=None):
    """The [cap, D] gradient of a view's rows from the gradient `grad` of
    its lookups at `positions` [n] ([n, D]), or of its bags ([bags, D],
    with `bag` [n] each lookup's bag, int64). `order` [n] int64: a
    permutation sorting the lookups by position, stable; None sorts them
    here (counted in `SORTS`). On the CPU the plain version, which needs
    no order."""
    if grad.device.type != "cuda":
        return view_grad_plain(grad, positions, cap, bag)
    if order is None:
        order = torch.sort(positions, stable=True).indices
        trace.count(SORTS)
    out = _launch(grad, positions, cap, order, bag)
    trace.count(LAUNCHES)
    return out


class _Lookup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, rows, positions, order):
        ctx.save_for_backward(positions, order)
        ctx.cap = rows.shape[0]
        return rows.index_select(0, positions)

    @staticmethod
    def backward(ctx, grad):
        positions, order = ctx.saved_tensors
        return view_grad(grad, positions, ctx.cap, order), None, None


class _Bags(torch.autograd.Function):
    @staticmethod
    def forward(ctx, rows, positions, offsets, order):
        ctx.save_for_backward(positions, offsets, order)
        ctx.cap = rows.shape[0]
        return F.embedding_bag(positions, rows, offsets, mode="sum")

    @staticmethod
    def backward(ctx, grad):
        positions, offsets, order = ctx.saved_tensors
        bag = bag_of(offsets, positions.shape[0])
        return (view_grad(grad, positions, ctx.cap, order, bag), None, None,
                None)


def view_lookup(rows, positions, order=None) -> torch.Tensor:
    """rows[positions] [n, D], whose backward is `view_grad`. positions:
    [n] int32/int64 in [0, rows); order: as `view_grad` takes it."""
    return _Lookup.apply(rows, positions, order)


def view_bags(rows, positions, offsets, order=None) -> torch.Tensor:
    """`F.embedding_bag(positions, rows, offsets, mode="sum")` [bags, D],
    whose backward is `view_grad`. offsets: [bags] int64, offsets[0] ==
    0."""
    return _Bags.apply(rows, positions, offsets, order)
