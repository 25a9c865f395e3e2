"""The multi-hot DLRM-DCNv2 cell on the CPU at a small size (its tables
cut, every width the cell's): whole runs, the program's spans read by the
new metrics, and faults of the timed path that its `correct` must
catch."""

import time

import pytest
import torch

from portbench import control, harness, roofline_dcn

CPU = torch.device("cpu")
CELL = "dlrm-dcnv2.train-multihot"
DCN = ("dcn.pool_ms", "dcn.pool_roofline", "dcn.cross_ms",
       "dcn.cross_roofline", "dcn.backward_ms", "dcn.mfu",
       "dcn.idle_share")


def _tiny(tiny):
    cell = tiny(CELL)
    cell["traffic"].update(batch=256, check_steps=2)
    return cell


def run(cell, trace=False, seconds=1.0):
    return harness.run_cell(cell, 2 ** 31 + 91, seconds, trace, CPU,
                            time.perf_counter())


def test_the_cell_resolves_with_its_metrics():
    cell = harness.load_cell(CELL)
    assert cell["chips"] == 1
    assert [m["name"] for m in cell["end_to_end"]] == \
        ["setup_s", "train_examples_per_s"]
    assert [m["name"] for m in cell["per_layer"]] == list(DCN)
    cfg = cell["config"]
    assert sum(cfg["multi_hot"]) == 214 and sum(cfg["ln_emb"]) == 26500127
    assert roofline_dcn.dcn_train_flops_per_example(cfg) == 96182784
    assert roofline_dcn.cross_forward_flops(cfg, 8192) == 173946175488


def test_the_pool_bound_reads_each_distinct_row_once():
    """1,753,088 ids a step of which 714,574 distinct (the cell's F1
    counters): ids, distinct rows and pooled vectors."""
    cfg = harness.load_cell(CELL)["config"]
    assert roofline_dcn.pool_bytes(cfg, 8192, 1753088, 714574) == \
        1753088 * 4 + 714574 * 128 * 4 + 8192 * 26 * 128 * 4


@pytest.mark.parametrize("unique", [714574 * 20, None])
def test_the_pool_share_falls_back_to_every_id(unique):
    read = harness.reader("dcn.pool_roofline")
    cell = harness.load_cell(CELL)
    counters = {"openrec.dlrm.bag_ids": 1753088 * 20}
    if unique:
        counters["openrec.train.unique_rows"] = unique
    ctx = {"cell": cell, "slice": {"steps": 20}, "counters": counters,
           "program_slice": {"span_device_s": {"openrec.dlrm.pool": 0.02}}}
    rows = (unique or 1753088 * 20) / 20
    least = roofline_dcn.pool_least_seconds(cell["config"], 8192, 1753088,
                                            rows)
    assert read(ctx) == pytest.approx(100.0 * least / 1e-3)


@pytest.mark.parametrize("trace", [False, True])
def test_a_whole_run_on_the_cpu(tiny, trace):
    cell = _tiny(tiny)
    out = run(cell, trace)
    assert out["correct"] is True, out["checks"]
    assert set(out["checks"]) == set(cell["limits"])
    if not trace:
        assert set(out["metrics"]) == {"setup_s", "train_examples_per_s"}
        return
    # the CPU trace has no device operations, so only the host-side
    # reductions exist; the spans were recorded
    assert "breakdown" in out


def test_the_slice_holds_the_program_spans_and_counter(tiny, monkeypatch):
    from portbench.drivers import train_multihot
    got = {}
    orig = train_multihot.run

    def keep(*a, **kw):
        r = orig(*a, **kw)
        got.update(r)
        return r
    monkeypatch.setattr(train_multihot, "run", keep)
    cell = _tiny(tiny)
    run(cell, trace=True)
    n = cell["traffic"]["trace_steps"]
    assert got["counters"]["openrec.dlrm.bag_ids"] == \
        n * cell["traffic"]["batch"] * 214
    assert 0 < got["counters"]["openrec.train.unique_rows"] <= \
        got["counters"]["openrec.dlrm.bag_ids"]
    calls = got["program_slice"]["span_calls"]
    for span in ("openrec.dlrm.pool", "openrec.dlrm.cross",
                 "openrec.train.backward"):
        assert calls[span] == n


def test_half_the_batch_left_out_fails(tiny, monkeypatch):
    from portbench.drivers import train_multihot
    build = train_multihot.build

    def patched(*a, **kw):
        model, trainer, w = build(*a, **kw)
        control._half_batch(model)
        return model, trainer, w
    monkeypatch.setattr(train_multihot, "build", patched)
    out = run(_tiny(tiny))
    assert out["correct"] is False
    assert out["checks"]["loss_gap"]["value"] > \
        out["checks"]["loss_gap"]["limit"]


def test_a_bag_that_drops_its_last_id_fails(tiny, monkeypatch):
    from openrec_tpu_torch.models import dlrm
    orig = dlrm.DLRM.pooled

    def short(self, sparse, tables=None):
        out = orig(self, sparse, tables)
        extra = self.pooled_last(sparse, tables)
        return out - extra

    def pooled_last(self, sparse, tables=None):
        # the 100-id bag's last id, looked up alone
        col = sum(self.multi_hot[:21]) - 1
        ids = self.flat_sparse_ids(sparse)[:, col]
        rows = self.table("embed_fused", tables).lookup(ids)
        pad = torch.zeros(sparse.shape[0], len(self.ln_emb), self.m_spa)
        pad[:, 20] = rows
        return pad
    monkeypatch.setattr(dlrm.DLRM, "pooled", short)
    monkeypatch.setattr(dlrm.DLRM, "pooled_last", pooled_last,
                        raising=False)
    out = run(_tiny(tiny))
    assert out["correct"] is False


def test_a_step_that_leaves_the_state_unchanged_fails(tiny, monkeypatch):
    from openrec_tpu_torch.training import trainer as trainer_mod

    def no_update(self, batch):
        total, aux = self.model.loss(batch)
        return total.detach(), aux
    monkeypatch.setattr(trainer_mod.Trainer, "_step_body", no_update)
    out = run(_tiny(tiny))
    assert out["correct"] is False
    assert out["checks"]["change_gap"]["value"] == pytest.approx(1.0)
