"""The view-gradient kernel's summation order, in plain PyTorch on the CPU,
for the tests (`test_torch_view_grad.py` holds it against a loop over
rows; `test_torch_view_grad_card.py` holds the kernel against it with
torch.equal). Imports nothing of the JAX package.

Row r's lookups, in the order they come (the batch's), are cut from the
first into chunks of `chunk`; where there are more than `chunk` of them,
each full chunk is summed from zero one lookup after another, and the row
is the sum from zero of its full chunks' sums in order, then of the
remaining lookups one after another; a row of at most `chunk` lookups is
their sum from zero one after another; a row of none is zero.
"""

import torch


def chunked_sum(grad, positions, cap: int, bag=None, chunk: int = 128):
    """[cap, D] float32: the view's gradient summed in the kernel's order
    (`csrc/view_grad.cu`), computed by `index_add_`, which adds in index
    order on the CPU."""
    grad, pos = grad.detach().cpu(), positions.detach().cpu().long()
    src = grad if bag is None else grad.index_select(0, bag.cpu())
    n = pos.shape[0]
    order = torch.sort(pos, stable=True).indices
    rows, vals = pos[order], src.index_select(0, order)
    first = torch.ones(n, dtype=torch.bool)
    first[1:] = rows[1:] != rows[:-1]
    run = torch.cumsum(first, 0) - 1                  # each lookup's run
    starts = torch.nonzero(first).reshape(-1)
    lengths = torch.diff(starts, append=torch.tensor([n]))
    rank = torch.arange(n) - starts[run]
    length = lengths[run]
    full = torch.where(length > chunk, length // chunk, 0)
    chunked = rank < full * chunk
    head = starts[run] + rank // chunk * chunk        # a chunk's first
    partial = torch.zeros(n, grad.shape[1], dtype=grad.dtype).index_add_(
        0, head[chunked], vals[chunked])
    heads = torch.nonzero(chunked & (rank % chunk == 0)).reshape(-1)
    out = torch.zeros(cap, grad.shape[1], dtype=grad.dtype)
    out.index_add_(0, rows[heads], partial.index_select(0, heads))
    return out.index_add_(0, rows[~chunked], vals[~chunked])
