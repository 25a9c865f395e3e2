"""Device resolution for the port's entry points.

Every entry point takes `device=None` and runs on CUDA unless the caller
asks for the CPU explicitly. With no GPU and no explicit CPU request it
raises: nothing falls back to the CPU quietly.
"""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """`None` -> `cuda`; raises RuntimeError if CUDA is asked for (or
    implied) and absent."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "openrec_tpu_torch runs on CUDA by default and no CUDA device "
            "is available; pass device='cpu' to run on the CPU")
    return dev
