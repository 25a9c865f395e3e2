"""The data-parallel driver on the CPU: its four ranks as gloo processes
over small tables (every width the four-card cell's), a whole run judged
by the one-process reference, a fault of one rank that its `correct`
must catch, and the probe of its state after the window."""

import json
import time

import pytest
import torch

from portbench import dp_probe, harness
from portbench import control

CPU = torch.device("cpu")
SEED = 2 ** 33 + 5


def _tiny():
    from conftest import TINY_LN_EMB
    cell = dp_probe.dp4_cell()
    cell["config"]["ln_emb"] = list(TINY_LN_EMB)
    cell["traffic"].update(batch=512, pool_batches=4, warmup_steps=1,
                           trace_steps=2)
    return cell


def run(cell, trace=False, seconds=1.0):
    return harness.run_cell(cell, SEED, seconds, trace, CPU,
                            time.perf_counter())


def test_the_cell_has_its_files_and_no_entry():
    bench = json.loads((harness.ROOT / "BENCHMARK.json").read_text())
    assert dp_probe.CELL not in [w["name"] for w in bench["workloads"]]
    cell = dp_probe.dp4_cell()
    assert cell["traffic"]["driver"] == "train_dp"
    assert cell["traffic"]["batch"] % cell["chips"] == 0
    assert [m["name"] for m in cell["end_to_end"]] == \
        ["setup_s", "train_examples_per_s"]
    harness.reader("dp.allreduce_ms")


@pytest.mark.parametrize("trace", [False, True])
def test_a_whole_run_of_four_ranks_on_the_cpu(trace):
    out = run(_tiny(), trace)
    assert out["correct"] is True, out["checks"]
    assert out["attempted"] > 0
    assert out["device"]["count"] == 4


def test_one_rank_on_half_its_slice_fails(monkeypatch):
    """Rank 0's loss over half its slice: the summed gradients are no
    longer the global batch's."""
    from portbench.drivers import train_dp
    build = train_dp.build

    def patched(*a, **kw):
        model, trainer, w = build(*a, **kw)
        control._half_batch(model)
        return model, trainer, w
    monkeypatch.setattr(train_dp, "build", patched)
    out = run(_tiny())
    assert out["correct"] is False


def test_the_probe_finds_equal_replicas_and_the_right_batch():
    out = dp_probe.probe(_tiny(), SEED, 1.0, CPU)
    assert out["replicas_equal"] and out["replicas"] is None
    shift = out["batch_shift"]
    assert abs(shift[0]) < 1e-5
    assert min(abs(v) for d, v in shift.items() if d) > abs(shift[0])
    gaps = out["one_process"]["leaf_gaps"]
    assert "embed_fused" in gaps
    assert max(g["rel_norm"] for g in gaps.values()) < 1e-3
    loss = out["one_process"]["steady_loss"]
    assert loss["dp_state"] == pytest.approx(loss["one_process"], abs=1e-4)
