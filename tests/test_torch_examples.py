"""Smoke-run every example script of the port on the CPU, at the reduced
size of OPENREC_EXAMPLE_SMALL and ~30 iterations, in the manner of
tests/test_examples.py. Each runs in a subprocess with
OPENREC_EXAMPLE_DEVICE=cpu (without it the examples run on CUDA), the
multi-rank ones as 2 gloo ranks under torchrun; the training ones must
reach their step-30 evaluation."""

import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EXAMPLES_DIR = os.path.join(REPO, "openrec_tpu_torch", "examples")
EXAMPLES = sorted(f[:-3] for f in os.listdir(EXAMPLES_DIR)
                  if f.endswith(".py") and f != "__init__.py")
# the JAX package's examples that the port carries so far
PORTED = ["bpr_citeulike", "bpr_device_sampled", "dlrm_criteo",
          "dlrm_criteo_multichip", "fairness_analysis", "itr_mlp",
          "multichip_trainer", "pmf_citeulike", "rnn_rec_lastfm",
          "serving_retrieval", "tutorial_basics", "tutorial_extending",
          "ucml_citeulike", "vanilla_youtube_rec_lastfm", "vbpr_tradesy",
          "youtube_rec_lastfm"]
# run as 2 gloo ranks under torchrun
MULTI_RANK = ("dlrm_criteo_multichip", "multichip_trainer")


def test_every_example_is_covered():
    assert EXAMPLES == PORTED
    for name in EXAMPLES:      # each mirrors a JAX example of its name
        assert os.path.isfile(os.path.join(REPO, "examples", name + ".py"))


@pytest.mark.parametrize("name", EXAMPLES)
def test_example_smoke(name, tmp_path):
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    env.update(OPENREC_EXAMPLE_DEVICE="cpu", OPENREC_EXAMPLE_ITERS="31",
               OPENREC_EXAMPLE_EVAL_INTERVAL="30", OPENREC_EXAMPLE_SMALL="1",
               OPENREC_CKPT_DIR=str(tmp_path / "ckpt"), OMP_NUM_THREADS="2")
    launcher = [sys.executable, "-m", "torch.distributed.run", "--standalone",
                "--nproc-per-node", "2"] if name in MULTI_RANK \
        else [sys.executable]
    proc = subprocess.run(
        launcher + ["-m", f"openrec_tpu_torch.examples.{name}"],
        cwd=tmp_path, env=env, timeout=300,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    assert proc.returncode == 0, f"{name} failed:\n{proc.stdout[-4000:]}"
    if name == "serving_retrieval":
        assert proc.stdout.count("top-3 of user") == 3
    elif name == "vbpr_tradesy" or name.endswith("_lastfm"):
        # its own loop prints one line an eval, as the JAX script does
        assert "Iter 30  loss " in proc.stdout and "AUC=" in proc.stdout
    elif name == "itr_mlp":
        # the per-record regression eval after the identity pretraining
        assert "Iter 30 " in proc.stdout and "[val] MSE=" in proc.stdout
    elif name == "dlrm_criteo":
        assert "Iter 30  loss " in proc.stdout and "val AUC" in proc.stdout
    elif name == "dlrm_criteo_multichip":
        assert "mesh: data 1 x model 2" in proc.stdout
        assert "Iter 0  loss " in proc.stdout and "done" in proc.stdout
    elif name == "fairness_analysis":
        assert "high-activity" in proc.stdout
    elif name == "tutorial_basics":
        assert "Part 2: per-gender accuracy" in proc.stdout
        assert "tail-item share of top-10" in proc.stdout
    elif name == "tutorial_extending":
        assert proc.stdout.count("[test] AUC=") == 3
        assert "max item-embedding norm after censoring" in proc.stdout
    else:
        assert "Iter 30 " in proc.stdout and "[val] AUC=" in proc.stdout
    if name in ("bpr_citeulike", "pmf_citeulike"):
        assert (tmp_path / "ckpt" / "ckpt-30.npz").is_file()
