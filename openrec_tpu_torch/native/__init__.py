"""ctypes bindings for the native host-sampling library.

Counterpart of `openrec_tpu/native/__init__.py`: the entry points the
port's `PairwiseSampler` and `StratifiedPointwiseSampler` call
(`build_hash_table`, `shuffle_pairs`, `pairwise_negatives_seq`,
`pairwise_batch_hash` and `stratified_pointwise_batch_hash`), the
binary-search ones over the sorted u*I+i keys (`sample_negatives`,
`is_positive`, `pairwise_batch`), and `available()`.
The library is the port's own `sampler.cpp`, built with g++ at first use
(`-O3 -shared -fPIC -std=c++17`, `-march=native` with a retry without
it) into `openrec_tpu_torch/build/` under a name keyed by a hash of the
source; the build writes a temporary file and renames it into place, so
processes that build at once do not see each other's half-written
output. `OPENREC_TPU_NO_NATIVE=1` (read once, at the first load) turns
the library off, and `OPENREC_TPU_SAMPLER_THREADS` sets the threads of
one call, as in the JAX package, so both packages choose the same path
and draw the same stream.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path

import numpy as np

_SRC = Path(__file__).resolve().parent / "sampler.cpp"
_BUILD_DIR = Path(__file__).resolve().parent.parent / "build"
_lock = threading.Lock()
_lib = None
_tried = False


def library_path() -> Path:
    digest = hashlib.sha256(_SRC.read_bytes()).hexdigest()[:16]
    return _BUILD_DIR / f"libopenrec_sampler-{digest}.so"


def _build(out: Path):
    _BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".tmp{os.getpid()}.{threading.get_ident()}.so")
    base = ["g++", "-O3", "-shared", "-fPIC", "-std=c++17", str(_SRC), "-o",
            str(tmp)]
    try:
        try:
            subprocess.run(base[:2] + ["-march=native"] + base[2:],
                           check=True, capture_output=True)
        except subprocess.CalledProcessError:
            subprocess.run(base, check=True, capture_output=True)
        os.replace(tmp, out)
    finally:
        tmp.unlink(missing_ok=True)


def load():
    """The ctypes library, or None when it is turned off or cannot be
    built (decided once per process)."""
    global _lib, _tried
    if _lib is not None or _tried:
        return _lib
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        if os.environ.get("OPENREC_TPU_NO_NATIVE") == "1":
            return None
        try:
            path = library_path()
            if not path.exists():
                _build(path)
            lib = ctypes.CDLL(str(path))
        except (OSError, subprocess.CalledProcessError):
            return None

        i64p = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
        i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
        u8p = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
        i32, i64, u64 = ctypes.c_int32, ctypes.c_int64, ctypes.c_uint64
        lib.is_positive_batch.argtypes = [i64p, i64, i64p, i64p, i64, i64,
                                          u8p]
        lib.sample_negatives.argtypes = [i64p, i64, i64p, i64, i64, u64,
                                         i32, i32p]
        lib.pairwise_join_and_negatives.argtypes = [
            i64p, i64, i32p, i32p, i64p, i64, i64, u64, i32, i32p, i32p,
            i32p]
        lib.build_hash_table.argtypes = [i64p, i64, i64p, i64]
        lib.pairwise_join_and_negatives_hash_mt.argtypes = [
            i64p, i64, i32p, i32p, i64p, i64, i64, u64, i32, i32,
            i32p, i32p, i32p]
        lib.shuffle_pairs.argtypes = [i32p, i32p, i64, u64]
        lib.pairwise_negatives_seq.argtypes = [
            i64p, i64, i32p, i64, i64, u64, i32, i32, i32p]
        lib.stratified_pointwise_hash.argtypes = [
            i64p, i64, i32p, i32p, i64p, i64, i64, i64, i64, u64, i32,
            i32p, i32p, np.ctypeslib.ndpointer(np.float32,
                                               flags="C_CONTIGUOUS")]
        _lib = lib
        return _lib


def available() -> bool:
    return load() is not None


def _lib_or_raise():
    lib = load()
    if lib is None:
        raise RuntimeError("the native sampler library is not available "
                           "(OPENREC_TPU_NO_NATIVE=1, or g++ failed to "
                           f"build {_SRC})")
    return lib


def _threads(threads):
    if threads is None:
        return int(os.environ.get("OPENREC_TPU_SAMPLER_THREADS", "1"))
    return int(threads)


def build_hash_table(pos_keys: np.ndarray) -> np.ndarray:
    """Open-addressing table (int64, EMPTY = -1, capacity the next power of
    two >= 2n) for O(1) membership of the sorted u*I+i keys."""
    lib = _lib_or_raise()
    n = len(pos_keys)
    capacity = 1
    while capacity < max(2 * n, 8):
        capacity <<= 1
    table = np.full(capacity, -1, dtype=np.int64)
    lib.build_hash_table(np.ascontiguousarray(pos_keys, np.int64), n,
                         table, capacity)
    return table


def sample_negatives(pos_keys: np.ndarray, users: np.ndarray,
                     total_items: int, seed: int,
                     max_rounds: int = 64) -> np.ndarray:
    """One uniform item per user, redrawn (up to max_rounds times) while
    it is a positive of the sorted u*I+i `pos_keys`; int32."""
    lib = _lib_or_raise()
    pos_keys = np.ascontiguousarray(pos_keys, dtype=np.int64)
    users = np.ascontiguousarray(users, dtype=np.int64)
    out = np.empty(len(users), dtype=np.int32)
    lib.sample_negatives(pos_keys, len(pos_keys), users, len(users),
                         total_items, seed & (2 ** 64 - 1), max_rounds,
                         out)
    return out


def is_positive(pos_keys: np.ndarray, users: np.ndarray,
                items: np.ndarray, total_items: int) -> np.ndarray:
    """bool [n]: is (users[i], items[i]) a positive of `pos_keys`."""
    lib = _lib_or_raise()
    pos_keys = np.ascontiguousarray(pos_keys, dtype=np.int64)
    users = np.ascontiguousarray(users, dtype=np.int64)
    items = np.ascontiguousarray(items, dtype=np.int64)
    out = np.empty(len(users), dtype=np.uint8)
    lib.is_positive_batch(pos_keys, len(pos_keys), users, items,
                          len(users), total_items, out)
    return out.astype(bool)


def pairwise_batch(pos_keys: np.ndarray, rec_users: np.ndarray,
                   rec_items: np.ndarray, record_idx: np.ndarray,
                   total_items: int, seed: int, max_rounds: int = 64):
    """(users, positives, negatives) int32 of the records `record_idx`,
    one negative each as `sample_negatives` draws it, in one stream."""
    lib = _lib_or_raise()
    pos_keys = np.ascontiguousarray(pos_keys, dtype=np.int64)
    b = len(record_idx)
    record_idx = np.ascontiguousarray(record_idx, dtype=np.int64)
    out_u = np.empty(b, dtype=np.int32)
    out_p = np.empty(b, dtype=np.int32)
    out_n = np.empty(b, dtype=np.int32)
    lib.pairwise_join_and_negatives(
        pos_keys, len(pos_keys), rec_users, rec_items, record_idx, b,
        total_items, seed & (2 ** 64 - 1), max_rounds, out_u, out_p, out_n)
    return out_u, out_p, out_n


def shuffle_pairs(users: np.ndarray, items: np.ndarray, seed: int):
    """In-place Fisher-Yates co-shuffle of aligned int32 arrays (the epoch
    permutation, applied to the records themselves so batch windows read
    sequentially)."""
    lib = _lib_or_raise()
    if not (users.flags.c_contiguous and items.flags.c_contiguous):
        raise ValueError("shuffle_pairs needs C-contiguous arrays")
    lib.shuffle_pairs(users, items, len(users), seed & (2 ** 64 - 1))


def pairwise_negatives_seq(hash_table: np.ndarray, users: np.ndarray,
                           total_items: int, seed: int,
                           max_rounds: int = 64,
                           threads: int | None = None) -> np.ndarray:
    """One rejected uniform negative per user of a sequential window (the
    block-prefetched path, sampler.cpp `negatives_seq_range`). threads
    None: OPENREC_TPU_SAMPLER_THREADS, default 1."""
    threads = _threads(threads)
    lib = _lib_or_raise()
    users = np.ascontiguousarray(users, dtype=np.int32)
    out = np.empty(len(users), dtype=np.int32)
    lib.pairwise_negatives_seq(hash_table, len(hash_table), users,
                               len(users), total_items,
                               seed & (2 ** 64 - 1), max_rounds, threads,
                               out)
    return out


def pairwise_batch_hash(hash_table: np.ndarray, rec_users: np.ndarray,
                        rec_items: np.ndarray, record_idx: np.ndarray,
                        total_items: int, seed: int,
                        max_rounds: int = 64, threads: int | None = None):
    """(users, positives, negatives) int32 of the records `record_idx`,
    one rejected uniform negative each. threads None:
    OPENREC_TPU_SAMPLER_THREADS, default 1."""
    threads = _threads(threads)
    lib = _lib_or_raise()
    b = len(record_idx)
    record_idx = np.ascontiguousarray(record_idx, dtype=np.int64)
    out_u = np.empty(b, dtype=np.int32)
    out_p = np.empty(b, dtype=np.int32)
    out_n = np.empty(b, dtype=np.int32)
    lib.pairwise_join_and_negatives_hash_mt(
        hash_table, len(hash_table), rec_users, rec_items, record_idx, b,
        total_items, seed & (2 ** 64 - 1), max_rounds, threads,
        out_u, out_p, out_n)
    return out_u, out_p, out_n


def stratified_pointwise_batch_hash(
        hash_table: np.ndarray, rec_users: np.ndarray,
        rec_items: np.ndarray, record_idx: np.ndarray, n_neg: int,
        total_users: int, total_items: int, seed: int,
        max_rounds: int = 64):
    """One pass of a stratified pointwise batch: the len(record_idx)
    records `record_idx` (label 1), then n_neg uniform (user, item) pairs
    rejected against the positives (label 0). (users i32, items i32,
    labels f32)."""
    lib = _lib_or_raise()
    n_pos = len(record_idx)
    b = n_pos + int(n_neg)
    record_idx = np.ascontiguousarray(record_idx, dtype=np.int64)
    out_u = np.empty(b, dtype=np.int32)
    out_i = np.empty(b, dtype=np.int32)
    out_l = np.empty(b, dtype=np.float32)
    lib.stratified_pointwise_hash(
        hash_table, len(hash_table), rec_users, rec_items, record_idx,
        n_pos, int(n_neg), total_users, total_items, seed & (2 ** 64 - 1),
        max_rounds, out_u, out_i, out_l)
    return out_u, out_i, out_l
