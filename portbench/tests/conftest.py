"""Shared fixtures of the benchmark's tests.

    python -m pytest portbench/tests -q

runs them on the CPU (the `card` tests skip there); on a machine with a
CUDA card the same command runs the `card` tests too.
"""

import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

# small tables for CPU runs of the drivers; the widths stay the cells'
TINY_LN_EMB = [50, 7, 3000, 2000, 5, 4, 300, 60, 3, 900, 50, 2500, 30, 27,
               150, 1500, 10, 50, 20, 4, 1800, 18, 15, 280, 105, 140]


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs a CUDA card; skips on a machine without one")


@pytest.fixture
def card():
    """The card, or a skip: decided when the test runs, never at import."""
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


def tiny_cell(name: str) -> dict:
    """Cell `name` of BENCHMARK.json with its catalog or tables cut to a
    CPU test's size; widths, k, routes and limits are the cell's."""
    from portbench import harness
    cell = harness.load_cell(name)
    cfg, tr = cell["config"], cell["traffic"]
    if tr["driver"] == "serve":
        cfg.update(total_users=3000, total_items=20000)
        tr.update(pool_requests=16, warmup_requests=1, trace_requests=3,
                  sample_requests=4)
        if tr["batch"] > 256:
            tr["batch"] = 512
    else:
        cfg["ln_emb"] = list(TINY_LN_EMB)
        tr.update(batch=512, pool_batches=4, warmup_steps=1, trace_steps=2)
    return cell


@pytest.fixture
def tiny():
    return tiny_cell
