"""Keras-form Adam on a sparse step's live rows, written back in place: the
CUDA kernel and its plain PyTorch version.

`sparse_adam_apply` is the tables' Adam of the O(batch) sparse step
(`training/sparse.py`, its step 4) for one table: for every slot s
whose `write[s]` is set, one Adam step (the keras form of
`optim.lazy_adam`, the bias correction folded into `alpha`) on row
`at[s]` of the table and of both moments, from the slot's gradient
`g[s]`. Live slots name distinct rows; a slot whose `write` is false
changes nothing, and its `at` may be any value.

On a CUDA table it launches `csrc/sparse_adam.cu` (built at first use),
which reads and writes the live rows alone, and counts the launch in
`openrec.sparse_adam.launches` (`trace.py`); the kernel takes float32
tables, moments and gradients, as the sparse step keeps them, and
raises on any other dtype. On a CPU tensor it runs the plain version
(`sparse_adam_plain`), which the CPU tests hold against the step's own
arithmetic and the card tests hold the kernel against, bit for bit.
"""

from __future__ import annotations

import ctypes

import torch

from openrec_tpu_torch import trace


def sparse_adam_plain(table, mu, nu, at, write, g, alpha, b1, b2, eps):
    """The kernel's function in plain PyTorch: both moments gathered at
    every slot, Adam, and the deltas added back with `index_add_`. A slot
    that writes nothing adds -0.0, which leaves every value as it was, to
    a row spread by its position (no hot row)."""
    spread = torch.arange(at.shape[0], device=at.device) % table.shape[0]
    at = torch.where(write, at, spread)
    skip = ~write.reshape(-1, *([1] * (g.dim() - 1)))

    def delta(x):
        return x.masked_fill(skip, -0.0)

    mu_old = mu.index_select(0, at)
    nu_old = nu.index_select(0, at)
    mu_rows = b1 * mu_old + (1 - b1) * g
    nu_rows = b2 * nu_old + (1 - b2) * g * g
    step = -alpha * mu_rows / (torch.sqrt(nu_rows) + eps)
    table.index_add_(0, at, delta(step))
    mu.index_add_(0, at, delta(mu_rows - mu_old))
    nu.index_add_(0, at, delta(nu_rows - nu_old))


def _kernel_fn():
    from openrec_tpu_torch.ops import _build
    fn = _build.load("sparse_adam").openrec_sparse_adam
    if fn.argtypes is None:
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        fn.argtypes = [p, p, p, p, p, i, p, p, ctypes.c_longlong, i, i,
                       f, f, f, f, f, p]
        fn.restype = ctypes.c_int
    return fn


def _launch(table, mu, nu, at, write, g, alpha, b1, b2, eps):
    rows, D = table.shape
    cap = at.shape[0]
    dev = table.device
    if table.dtype != torch.float32:
        raise TypeError(f"the table must be float32, not {table.dtype}")
    for name, t in (("mu", mu), ("nu", nu)):
        if t.shape != table.shape or t.dtype != torch.float32:
            raise ValueError(f"{name} must be float32 of the table's shape "
                             f"{tuple(table.shape)}")
    if tuple(g.shape) != (cap, D) or g.dtype != torch.float32:
        raise ValueError(f"g must be float32 [{cap}, {D}], not {g.dtype} "
                         f"{tuple(g.shape)}")
    if at.dim() != 1 or at.dtype not in (torch.int32, torch.int64):
        raise TypeError(f"at must be 1-D int32 or int64, not {at.dtype}")
    if tuple(write.shape) != (cap,) or write.dtype != torch.bool:
        raise TypeError(f"write must be bool [{cap}]")
    if alpha.numel() != 1 or alpha.dtype != torch.float32:
        raise TypeError("alpha must be one float32")
    if any(t.device != dev for t in (mu, nu, at, write, g, alpha)):
        raise ValueError("every tensor must lie on the table's device")
    for name, t in (("table", table), ("mu", mu), ("nu", nu)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    g, at, write = g.contiguous(), at.contiguous(), write.contiguous()
    vec4 = D % 4 == 0 and all(t.data_ptr() % 16 == 0
                              for t in (table, mu, nu, g))
    with torch.cuda.device(dev):
        err = _kernel_fn()(
            table.data_ptr(), mu.data_ptr(), nu.data_ptr(), g.data_ptr(),
            at.data_ptr(), int(at.dtype == torch.int64), write.data_ptr(),
            alpha.data_ptr(), cap, D, int(vec4), b1, b2, eps, 1 - b1,
            1 - b2, torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"sparse_adam kernel launch failed: CUDA error "
                           f"{err}")


def sparse_adam_apply(table, mu, nu, at, write, g, alpha, b1: float,
                      b2: float, eps: float) -> None:
    """One keras-form Adam step on rows `at[write]` of `table` [rows, D]
    and its moments `mu`, `nu`, in place, from the slots' gradients
    `g` [cap, D]. at: [cap] int32/int64; write: [cap] bool; alpha: the
    step's bias-corrected step size, a float32 tensor on the device
    (`optim._adam_alpha`); b1, b2, eps: Python floats."""
    if table.device.type != "cuda":
        sparse_adam_plain(table, mu, nu, at, write, g, alpha, b1, b2, eps)
        return
    _launch(table, mu, nu, at, write, g, alpha, b1, b2, eps)
    trace.count("openrec.sparse_adam.launches")
