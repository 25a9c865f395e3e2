"""Rules of the PyTorch port: it imports neither JAX nor the JAX package,
it runs on CUDA unless asked for the CPU, and on CPU tensors its kernel
wrappers run their plain versions without counting a launch."""

import ast
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "jaxlib", "openrec_tpu")


def _port_files():
    return sorted((ROOT / "openrec_tpu_torch").rglob("*.py")) \
        + [ROOT / "chip_smoke.py"]


def _imported_modules(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (alias.name for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


@pytest.mark.parametrize("path", _port_files(),
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_port_source_imports_no_jax(path):
    bad = [m for m in _imported_modules(path)
           if m.split(".")[0] in FORBIDDEN]
    assert not bad, f"{path.name} imports {bad}"


def test_importing_port_loads_no_jax():
    code = (
        "import sys\n"
        "before = set(sys.modules)\n"
        "import openrec_tpu_torch, openrec_tpu_torch.ops._build\n"
        "new = set(sys.modules) - before\n"
        "bad = sorted(m for m in new if m.split('.')[0] in "
        "('jax', 'jaxlib', 'openrec_tpu'))\n"
        "print('BAD', bad)\n"
        "sys.exit(1 if bad else 0)\n")
    env = {**os.environ, "PYTHONPATH": str(ROOT)}
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "BAD []" in proc.stdout


def test_entry_points_need_cuda_or_explicit_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid")
    from openrec_tpu_torch import (BPR, CachedDotProductScorer, Trainer,
                                   convert, resolve_device)
    from openrec_tpu_torch.data import (DevicePairwiseSampler,
                                        InteractionStore, device_iterator,
                                        to_device)
    from openrec_tpu_torch.modules.embedding import embedding_init
    from openrec_tpu_torch.ops import fused_score_topk
    from openrec_tpu_torch.training import keras_adam, lazy_adagrad, lazy_adam
    with pytest.raises(RuntimeError, match="CUDA"):
        BPR(4, 4, 2, 2)
    with pytest.raises(RuntimeError, match="CUDA"):
        CachedDotProductScorer(None, 4, 4, lambda p, i: p, lambda p, i: p)
    with pytest.raises(RuntimeError, match="CUDA"):
        convert.params_from_jax({"w": np.zeros(2)})
    with pytest.raises(RuntimeError, match="CUDA"):
        embedding_init(3, 2)
    cpu_model = BPR(4, 4, 2, 2, device="cpu")
    with pytest.raises(RuntimeError, match="CUDA"):
        Trainer(cpu_model)
    store = InteractionStore(np.array([(0, 1), (1, 2)], dtype=[
        ("user_id", np.int32), ("item_id", np.int32)]), 4, 4)
    with pytest.raises(RuntimeError, match="CUDA"):
        DevicePairwiseSampler(store, 8)
    with pytest.raises(RuntimeError, match="CUDA"):
        to_device({"a": np.zeros(2)})
    with pytest.raises(RuntimeError, match="CUDA"):
        next(device_iterator(iter([{"a": np.zeros(2)}])))
    # the optimizers keep their state beside the parameters: CUDA-default
    # parameters cannot be made, and an empty tree asks for the default
    for tx in (lazy_adam(), keras_adam()):
        with pytest.raises(RuntimeError, match="CUDA"):
            tx.init(BPR(4, 4, 2, 2).params())
        with pytest.raises(RuntimeError, match="CUDA"):
            tx.init({})
        assert tx.init(cpu_model.params()).count.device.type == "cpu"
    assert lazy_adagrad().init(cpu_model.params())["user_embed"].device \
        == torch.device("cpu")
    # a kernel wrapper follows its tensors: the default device's tensors
    # cannot be made either
    with pytest.raises(RuntimeError, match="CUDA"):
        fused_score_topk(embedding_init(3, 2), embedding_init(5, 2), None, 2)
    assert resolve_device("cpu") == torch.device("cpu")


def test_cpu_tensors_count_no_kernel_launch():
    from openrec_tpu_torch.ops import bucketed_topk as bt
    from openrec_tpu_torch.ops import fused_score_topk
    before = (bt.bucket_max_scores.launches, bt.bucket_max2_scores.launches,
              fused_score_topk.launches)
    rng = np.random.default_rng(0)
    u = torch.from_numpy(rng.normal(size=(3, 8)).astype(np.float32))
    v = torch.from_numpy(rng.normal(size=(500, 8)).astype(np.float32))
    bt.bucket_max_scores(u, v, None, bucket=2)
    bt.bucket_max2_scores(u, v, None, bucket=2)
    bt.bucket_score_topk(u, v, None, 10, recall_target=0.99, per_bucket=2)
    fused_score_topk(u, v, None, 10)
    assert (bt.bucket_max_scores.launches, bt.bucket_max2_scores.launches,
            fused_score_topk.launches) == before == (0, 0, 0)
