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
    """The port, the scripts that run it on the card, and the card tests
    with the modules they and `chip_smoke.py` import."""
    return sorted((ROOT / "openrec_tpu_torch").rglob("*.py")) \
        + [ROOT / "chip_smoke.py", ROOT / "nccl_probe.py",
           ROOT / "tests" / "kernel_cases.py",
           ROOT / "tests" / "view_grad_model.py"] \
        + sorted((ROOT / "tests").glob("test_torch_*_card.py"))


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
    # the DLRM slice: the model, its MLP, optax-form adam and the sparse
    # step, whose state lives beside the model's tables
    from openrec_tpu_torch import DLRM, MLP, adam
    from openrec_tpu_torch.training.sparse import (dlrm_fused_table_spec,
                                                   make_sparse_train_step)
    kw = dict(m_spa=2, ln_emb=(3, 4), ln_bot=(2,), ln_top=(1,),
              dim_dense=2, fused_tables=True)
    with pytest.raises(RuntimeError, match="CUDA"):
        DLRM(**kw)
    with pytest.raises(RuntimeError, match="CUDA"):
        MLP(3, [2])
    with pytest.raises(RuntimeError, match="CUDA"):
        adam().init({})
    cpu_dlrm = DLRM(**kw, device="cpu")
    assert adam().init(cpu_dlrm.params())[0].count.device.type == "cpu"
    init, _ = make_sparse_train_step(cpu_dlrm,
                                     dlrm_fused_table_spec(cpu_dlrm))
    state = init(cpu_dlrm.params())
    assert state["sparse"].count.device.type == "cpu"
    assert state["dense"][0].count.device.type == "cpu"
    with pytest.raises(RuntimeError, match="CUDA"):
        Trainer(cpu_dlrm, sparse_tables=dlrm_fused_table_spec(cpu_dlrm))


def test_cpu_tensors_count_no_kernel_launch():
    from openrec_tpu_torch import trace
    from openrec_tpu_torch.ops import bucketed_topk as bt
    from openrec_tpu_torch.ops import fused_score_topk
    from openrec_tpu_torch.ops.sparse_adam import sparse_adam_apply
    from openrec_tpu_torch.ops.view_grad import view_grad, view_lookup

    def launches():
        return tuple(trace.counter(f"openrec.{k}.launches")
                     for k in ("k1", "k2", "k3", "sparse_adam",
                               "view_grad")) + (
            trace.counter(bt.TMA_LAUNCHES),)
    before = launches()
    rng = np.random.default_rng(0)
    u = torch.from_numpy(rng.normal(size=(3, 8)).astype(np.float32))
    v = torch.from_numpy(rng.normal(size=(500, 8)).astype(np.float32))
    bt.bucket_max_scores(u, v, None, bucket=2)
    bt.bucket_max2_scores(u, v, None, bucket=2)
    # bf16 at D = 8: the TMA route's tables on a card
    bt.bucket_max_scores(u.bfloat16(), v.bfloat16(), None, bucket=2)
    bt.bucket_score_topk(u, v, None, 10, recall_target=0.99, per_bucket=2)
    fused_score_topk(u, v, None, 10)
    mu, nu = torch.zeros_like(v), torch.zeros_like(v)
    sparse_adam_apply(v, mu, nu, torch.tensor([4, 9, 0]),
                      torch.tensor([True, True, False]), u,
                      torch.tensor(1e-3), 0.9, 0.999, 1e-7)
    assert mu[[4, 9]].any() and not mu[0].any()
    pos = torch.tensor([4, 9, 4])
    assert view_grad(u, pos, 12, order=torch.tensor([0, 2, 1]))[4].any()
    rows = v[:12].clone().requires_grad_()
    view_lookup(rows, pos).sum().backward()
    assert rows.grad[[4, 9]].any() and not rows.grad[0].any()
    assert launches() == before == (0, 0, 0, 0, 0, 0)


@pytest.mark.parametrize("name", ["PMF", "WRMF", "GMF", "UCML",
                                  "DevicePointwiseSampler"])
def test_zoo_entry_points_need_cuda_or_explicit_cpu(name):
    """The zoo's models and the on-device pointwise sampler default to
    CUDA like every other entry point, and run on the CPU when asked."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid")
    import openrec_tpu_torch as port
    from openrec_tpu_torch.data import InteractionStore
    if name == "DevicePointwiseSampler":
        store = InteractionStore(np.array([(0, 1), (1, 2)], dtype=[
            ("user_id", np.int32), ("item_id", np.int32)]), 4, 4)
        args = (store, 8)
    else:
        args = (4, 5, 2, 2)
    with pytest.raises(RuntimeError, match="CUDA"):
        getattr(port, name)(*args)
    made = getattr(port, name)(*args, device="cpu")
    tensors = (list(made.parameters()) if isinstance(made, torch.nn.Module)
               else [made._rec_users])
    assert all(t.device.type == "cpu" for t in tensors)


@pytest.mark.parametrize("name", ["RNNRec", "VanillaYouTubeRec",
                                  "YouTubeRec", "DeviceTemporalSampler"])
def test_sequence_entry_points_need_cuda_or_explicit_cpu(name):
    """The sequence models and the on-device temporal sampler default to
    CUDA like every other entry point, and run on the CPU when asked."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid")
    import openrec_tpu_torch as port
    from openrec_tpu_torch.data import InteractionStore
    if name == "DeviceTemporalSampler":
        store = InteractionStore(np.array([(0, 1, 1), (0, 2, 2)], dtype=[
            ("user_id", np.int32), ("item_id", np.int32),
            ("ts", np.int64)]), 4, 4, sortby="ts")
        args, kw = (store, 8, 3), {}
    elif name == "RNNRec":
        args, kw = (5, 4, 3, 2), {"softmax_samples": 2}
    else:
        args, kw = (5, 4, 3), {}
    with pytest.raises(RuntimeError, match="CUDA"):
        getattr(port, name)(*args, **kw)
    made = getattr(port, name)(*args, **kw, device="cpu")
    tensors = (list(made.parameters()) if isinstance(made, torch.nn.Module)
               else [made._items])
    assert all(t.device.type == "cpu" for t in tensors)


def test_itr_mlp_needs_cuda_or_explicit_cpu():
    """ItrMLP defaults to CUDA like every other entry point, and runs on
    the CPU when asked, its pretraining inputs drawn there too."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid")
    import openrec_tpu_torch as port
    with pytest.raises(RuntimeError, match="CUDA"):
        port.ItrMLP(5, 4, 3)
    with pytest.raises(RuntimeError, match="CUDA"):
        port.ItrMLP(5, 4, 3, pretrained_user_embeddings=np.zeros((5, 3)))
    made = port.ItrMLP(5, 4, 3, device="cpu")
    assert all(t.device.type == "cpu" for t in made.parameters())
    made.pretrain_identity(torch.Generator().manual_seed(0), steps=2,
                           batch=4)
    made.update_embeddings()
    assert made.serving_tables()[0].device.type == "cpu"


def test_distribution_entry_points_need_cuda_or_explicit_cpu():
    """make_mesh / initialize_multihost raise without CUDA unless asked for
    the CPU; with device="cpu" a one-rank gloo mesh serves ParallelTrainer,
    whose model must lie on the mesh's device. Run in a fresh process, so
    that no process group outlives the check."""
    code = r'''
import torch
from openrec_tpu_torch import ParallelTrainer
from openrec_tpu_torch.models import BPR
from openrec_tpu_torch.parallel import initialize_multihost, make_mesh
assert not torch.cuda.is_available()
for fn in (make_mesh, initialize_multihost):
    try:
        fn()
    except RuntimeError as e:
        assert "device='cpu'" in str(e), e
    else:
        raise AssertionError(f"{fn.__name__} ran without CUDA")
mesh = make_mesh(device="cpu")
assert mesh.device_type == "cpu" and tuple(mesh.mesh.shape) == (1, 1)
tr = ParallelTrainer(BPR(8, 16, 4, 4, device="cpu"), mesh)
assert tr.device == torch.device("cpu")
print("OK")
'''
    env = {**os.environ, "PYTHONPATH": str(ROOT), "CUDA_VISIBLE_DEVICES": ""}
    for k in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT"):
        env.pop(k, None)
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "OK" in proc.stdout


def _public_names(module):
    """Names a JAX module defines (a package: re-exports) without a leading
    underscore: its functions and classes, its submodules, and the
    constants it holds (axis names, rules)."""
    import types
    package = module.__name__.count(".") == 1 or \
        module.__file__.endswith("__init__.py")
    out = set()
    for name, obj in vars(module).items():
        if name.startswith("_"):
            continue
        if isinstance(obj, types.ModuleType):
            if package and obj.__name__.startswith(module.__name__ + "."):
                out.add(name)         # e.g. parallel.sharded_checkpoint
        elif isinstance(obj, (str, int, float, tuple)):
            out.add(name)
        elif callable(obj):
            home = getattr(obj, "__module__", "") or ""
            if home == module.__name__ or (
                    package and home.startswith("openrec_tpu.")):
                out.add(name)
    return out


def _jax_modules():
    """Every module of the JAX package but the native sampler's shared
    object, which `walk_packages` lists beside the package's modules."""
    import pkgutil

    import openrec_tpu
    return ["openrec_tpu"] + sorted(
        m.name for m in pkgutil.walk_packages(openrec_tpu.__path__,
                                              "openrec_tpu.")
        if m.name.rsplit(".", 1)[-1] != "libopenrec_sampler")


# the one public name the port gives another name: K1 / K2's entry point
# runs a CUDA kernel there, not a Pallas one
RENAMED = {"pallas_score_topk": "bucket_score_topk"}


@pytest.mark.parametrize("jax_module", _jax_modules())
def test_every_public_name_has_a_counterpart(jax_module):
    """The port has a counterpart of every public name of every module of
    the JAX package, under the same module path with `_torch` after the
    package's name (or its name in RENAMED)."""
    import importlib
    jmod = importlib.import_module(jax_module)
    tmod = importlib.import_module(
        jax_module.replace("openrec_tpu", "openrec_tpu_torch", 1))
    names = _public_names(jmod)
    assert names
    missing = sorted(n for n in names
                     if not hasattr(tmod, RENAMED.get(n, n)))
    assert not missing, f"{tmod.__name__} lacks {missing}"
