"""The harness: cells found by name, whole runs on the CPU at a small
size, and runs with the timed path broken underneath."""

import json
import re
import shutil
import subprocess
import sys
import time

import pytest
import torch

from portbench import control, harness

CPU = torch.device("cpu")
CELLS = ["bpr-amazon.serve-k1", "dlrm-kaggle.train-zipf",
         "bpr-amazon.serve-exact", "bpr-amazon.batch-k10"]
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


def test_benchmark_json_keeps_to_its_form():
    bench = json.loads((harness.ROOT / "BENCHMARK.json").read_text())
    assert set(bench) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert [w["name"] for w in bench["workloads"]] == CELLS
    names = [m["name"] for m in bench["end_to_end"] + bench["per_layer"]]
    names += [w["name"] for w in bench["workloads"]]
    names += [c["name"] for c in bench["configs"]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)
    e2e = {m["name"] for m in bench["end_to_end"]}
    for m in bench["per_layer"]:
        assert m["moves"] in e2e
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
    for m in bench["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    for w in bench["workloads"]:
        assert w["chips"] == 1 and len(w["why"]) <= 200


@pytest.mark.parametrize("name", CELLS)
def test_every_cell_resolves(name):
    cell = harness.load_cell(name)
    e2e = [m["name"] for m in cell["end_to_end"]]
    assert e2e[0] == "setup_s" and len(e2e) >= 2
    assert cell["per_layer"]
    for m in cell["per_layer"]:
        assert m["moves"] in e2e


def test_a_new_cell_is_a_new_file(tmp_path):
    """A cell, its traffic and a metric added as files (and entries) are
    found and checked without an edit to any file that was there."""
    shutil.copytree(harness.PKG, tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench = json.loads((harness.ROOT / "BENCHMARK.json").read_text())
    bench["workloads"].append({
        "name": "bpr-amazon.dummy", "config": "bpr-amazon",
        "traffic": "dummy", "chips": 1, "why": "a test's cell"})
    bench["per_layer"].append({
        "name": "dummy.users", "unit": "users", "better": "higher",
        "source": "host_clock", "layer": "serving", "moves":
        "serve_users_per_s", "workloads": ["bpr-amazon.dummy"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    pkg = tmp_path / "portbench"
    traffic = json.loads((pkg / "traffic" / "serve-k1.json").read_text())
    (pkg / "traffic" / "dummy.json").write_text(
        json.dumps({**traffic, "batch": 128}))
    (pkg / "metrics" / "dummy.users.py").write_text(
        "def read(ctx):\n    return ctx.get('users_done')\n")
    with pytest.raises(FileNotFoundError):
        harness.load_cell("bpr-amazon.dummy", root=tmp_path)
    (pkg / "workloads" / "bpr-amazon.dummy.json").write_text(json.dumps(
        {"config": "bpr-amazon", "traffic": "dummy",
         "limits": {"score_err": 1e-5}}))
    cell = harness.load_cell("bpr-amazon.dummy", root=tmp_path)
    assert cell["traffic"]["batch"] == 128
    assert [m["name"] for m in cell["per_layer"]][-1] == "dummy.users"
    assert "serve_p95_ms" not in [m["name"] for m in cell["end_to_end"]]
    (pkg / "workloads" / "bpr-amazon.dummy.json").write_text(json.dumps(
        {"config": "dlrm-kaggle", "traffic": "dummy", "limits": {}}))
    with pytest.raises(ValueError):
        harness.load_cell("bpr-amazon.dummy", root=tmp_path)


def run(cell, trace=False, seconds=0.5):
    return harness.run_cell(cell, 2 ** 31 + 77, seconds, trace, CPU,
                            time.perf_counter())


@pytest.mark.parametrize("name", CELLS)
@pytest.mark.parametrize("trace", [False, True])
def test_a_whole_run_on_the_cpu(tiny, name, trace):
    cell = tiny(name)
    out = run(cell, trace)
    assert out["correct"] is True
    assert out["attempted"] > 0 and out["failed"] == 0
    assert list(out)[-1] == "checks"
    assert set(out["checks"]) == set(cell["limits"])
    want = cell["per_layer"] if trace else cell["end_to_end"]
    if not trace:
        assert set(out["metrics"]) == {m["name"] for m in want}
    else:
        # no device on the CPU: only the host spans read anything
        assert set(out["metrics"]) <= {m["name"] for m in want}
        assert out["metrics"]
        assert "breakdown" in out


def _patch_topk(monkeypatch, change):
    from openrec_tpu_torch.serving import scorer as scorer_mod
    orig = scorer_mod.CachedDotProductScorer.topk

    def broken(self, *a, **kw):
        vals, ids = orig(self, *a, **kw)
        return change(vals.clone(), ids.clone())
    monkeypatch.setattr(scorer_mod.CachedDotProductScorer, "topk", broken)


@pytest.mark.parametrize("name", ["bpr-amazon.serve-k1",
                                  "bpr-amazon.serve-exact",
                                  "bpr-amazon.batch-k10"])
def test_an_altered_answer_fails(tiny, monkeypatch, name):
    def alter(vals, ids):
        ids[0, 0] = (ids[0, 0] + 1) % 20000
        return vals, ids
    _patch_topk(monkeypatch, alter)
    assert run(tiny(name))["correct"] is False


@pytest.mark.parametrize("name", ["bpr-amazon.serve-k1",
                                  "bpr-amazon.serve-exact",
                                  "bpr-amazon.batch-k10"])
def test_half_the_users_left_out_fails(tiny, monkeypatch, name):
    def half(vals, ids):
        n = ids.shape[0] // 2
        vals[n:2 * n], ids[n:2 * n] = vals[:n], ids[:n]
        return vals, ids
    _patch_topk(monkeypatch, half)
    assert run(tiny(name))["correct"] is False


def test_a_step_that_leaves_the_state_unchanged_fails(tiny, monkeypatch):
    from openrec_tpu_torch.training import trainer as trainer_mod

    def no_update(self, batch):
        total, aux = self.model.loss(batch)
        return total.detach(), aux
    monkeypatch.setattr(trainer_mod.Trainer, "_step_body", no_update)
    out = run(tiny("dlrm-kaggle.train-zipf"))
    assert out["correct"] is False
    assert out["checks"]["change_gap"]["value"] == pytest.approx(1.0)


def test_half_the_batch_left_out_fails(tiny, monkeypatch):
    from portbench.drivers import train
    build = train.build

    def patched(*a, **kw):
        model, trainer, w = build(*a, **kw)
        control._half_batch(model)
        return model, trainer, w
    monkeypatch.setattr(train, "build", patched)
    out = run(tiny("dlrm-kaggle.train-zipf"))
    assert out["correct"] is False
    assert out["checks"]["loss_gap"]["value"] > \
        out["checks"]["loss_gap"]["limit"]


def _steady_fault(trainer_mod, monkeypatch, after, fault):
    """From the trainer's call `after` on, `fault(self, batch, first)`
    takes the step's place (`first`: the batch of call `after`)."""
    orig = trainer_mod.Trainer.train_step
    seen = []

    def broken(self, batch):
        seen.append(batch)
        if len(seen) <= after:
            return orig(self, batch)
        return fault(self, batch, seen[after], orig)
    monkeypatch.setattr(trainer_mod.Trainer, "train_step", broken)


def _stale_batch(self, batch, first, orig):
    return orig(self, first)


def _unchanged_state(self, batch, first, orig):
    total, aux = self.model.loss(batch)
    return total.detach(), aux


@pytest.mark.parametrize("fault", [_stale_batch, _unchanged_state])
def test_a_fault_of_the_steady_state_fails(tiny, monkeypatch, fault):
    """A fault that starts after the first check steps and the warm-up
    (as a replayed graph would) fails the check that follows the window,
    while the first steps' numbers stay within their limits."""
    from openrec_tpu_torch.training import trainer as trainer_mod
    cell = tiny("dlrm-kaggle.train-zipf")
    tr = cell["traffic"]
    _steady_fault(trainer_mod, monkeypatch,
                  tr["check_steps"] + tr["warmup_steps"] + 1, fault)
    out = run(cell)
    assert out["correct"] is False
    checks = out["checks"]
    for key in ("loss_gap", "grad_gap", "change_gap", "rows_gap"):
        assert checks[key]["value"] <= checks[key]["limit"]
    assert any(checks[key]["value"] > checks[key]["limit"]
               for key in checks if key.startswith("steady_"))


def test_main_refuses_a_machine_without_a_card(capsys):
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    rc = harness.main(["--workload", "bpr-amazon.serve-k1", "--seed", "1",
                       "--seconds", "1"], time.perf_counter())
    assert rc != 0
    assert capsys.readouterr().out == ""


def test_a_checkout_without_the_program_fails(tmp_path):
    shutil.copytree(harness.PKG, tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(harness.ROOT / "BENCHMARK.json", tmp_path)
    p = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload",
         "bpr-amazon.serve-k1", "--seed", "3", "--seconds", "1",
         "--trace", "0"], cwd=tmp_path, capture_output=True, text=True,
        timeout=300)
    assert p.returncode != 0
    assert p.stdout.strip() == ""
