"""Build and load the port's CUDA kernels.

Each `openrec_tpu_torch/csrc/<name>.cu` is compiled at first use by `nvcc`
for Hopper (`sm_90a`) into its own shared library with a plain C
interface, and loaded with `ctypes`. The library lands in
`openrec_tpu_torch/build/` (listed in .gitignore) under a name keyed by a
hash of the sources and flags, so an edited source is rebuilt and an
unchanged one is reused. `build_all()` starts one `nvcc` per source, all
at once, and waits for them.

Nothing here runs at import: the CPU tests import every module, and this
machine-side build happens only where a kernel is launched.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

CSRC_DIR = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_LOADED: dict = {}     # name -> ctypes.CDLL, one load per process


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    nvcc = shutil.which("nvcc") or os.path.join(cuda_home, "bin", "nvcc")
    if not os.path.exists(nvcc):
        raise RuntimeError(f"nvcc not found (looked on PATH and at {nvcc}); "
                           "the CUDA kernels are built on a machine with "
                           "the CUDA toolkit")
    return nvcc


def sources() -> list:
    return sorted(p.stem for p in CSRC_DIR.glob("*.cu"))


def library_path(name: str) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in [CSRC_DIR / f"{name}.cu", *sorted(CSRC_DIR.glob("*.cuh"))]:
        h.update(path.name.encode())
        h.update(path.read_bytes())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def build_all(names=None) -> dict:
    """Compile every source (or `names`) not yet built, one nvcc each, in
    parallel. Returns {name: compiler output} (ptxas register and
    shared-memory lines) for the ones built now; raises on any failure."""
    names = sources() if names is None else list(names)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    jobs = {}
    for name in names:
        out = library_path(name)
        if out.exists():
            continue
        tmp = out.with_suffix(f".tmp{os.getpid()}.so")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
               str(CSRC_DIR / f"{name}.cu")]
        jobs[name] = (out, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True))
    logs, failed = {}, []
    for name, (out, tmp, proc) in jobs.items():
        text = proc.communicate()[0]
        logs[name] = text
        if proc.returncode != 0:
            failed.append(f"{name}.cu:\n{text}")
            continue
        os.replace(tmp, out)
        out.with_suffix(".log").write_text(text)
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    return logs


def load(name: str) -> ctypes.CDLL:
    """The loaded library of `csrc/<name>.cu`, built first if needed."""
    lib = _LOADED.get(name)
    if lib is None:
        build_all([name])
        lib = _LOADED[name] = ctypes.CDLL(str(library_path(name)))
    return lib
