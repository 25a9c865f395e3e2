"""The port's tracing module (`openrec_tpu_torch/trace.py`) and the spans
and counters placed in the serving, sparse-training and feed paths.

Nesting is read back from `torch.profiler`'s Chrome trace on the CPU: a
span's parent is the innermost program span whose interval holds it.
"""

import json

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from openrec_tpu_torch import trace
from openrec_tpu_torch.data.pipeline import device_iterator
from openrec_tpu_torch.models import BPR, DLRM
from openrec_tpu_torch.modules.embedding import embedding_lookup
from openrec_tpu_torch.ops.ordered_topk import SHORT_ROW
from openrec_tpu_torch.serving import CachedDotProductScorer
from openrec_tpu_torch.training import Trainer
from openrec_tpu_torch.training.sparse import dlrm_fused_table_spec

torch.set_num_threads(1)

TRAIN_SPANS = ["openrec.train.dedup", "openrec.train.gather",
               "openrec.train.forward", "openrec.train.backward",
               "openrec.train.adam", "openrec.train.scatter"]
LN_EMB = (50, 80, 30)


@pytest.fixture(autouse=True)
def fresh_tracer():
    trace.enable(False)
    trace.reset()
    yield
    trace.enable(False)
    trace.reset()


def _profiled(fn, path):
    """Run fn() under the CPU profiler; the program spans of its Chrome
    trace as [(name, parent name or None)] in start order."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        fn()
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())["traceEvents"]
    spans = sorted(((float(e["ts"]), float(e["ts"]) + float(e["dur"]),
                     e["name"]) for e in events
                    if e.get("ph") == "X" and e.get("cat") == "user_annotation"
                    and e["name"].startswith("openrec.")),
                   key=lambda s: (s[0], -s[1]))
    out = []
    for i, (s, t, name) in enumerate(spans):
        holders = [h for h in spans[:i] if h[0] <= s and t <= h[1]]
        out.append((name, max(holders)[2] if holders else None))
    return out


def test_off_records_no_span_and_enters_no_annotation(monkeypatch, tmp_path):
    def refuse(name):
        raise AssertionError(f"record_function({name!r}) entered")
    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    assert not trace.enabled()

    def body():
        with trace.span("openrec.a"):
            with trace.host_sync():
                trace.count("openrec.n", 3)
        trace.count_device("openrec.d", torch.ones(4))

    body()
    with profile(activities=[ProfilerActivity.CPU]):
        body()
    snap = trace.snapshot()
    assert snap["spans"] == {}
    assert snap["counters"] == {"openrec.n": 6, trace.HOST_SYNCS: 2}
    # off, a span is one shared object
    assert trace.span("openrec.a") is trace.span("openrec.b")


def test_on_spans_total_calls_and_time_and_reset_clears():
    trace.enable(True)
    for _ in range(3):
        with trace.span("openrec.a"):
            pass
    trace.count("openrec.n")
    snap = trace.snapshot()
    assert snap["spans"]["openrec.a"]["calls"] == 3
    assert snap["spans"]["openrec.a"]["host_s"] > 0
    assert snap["counters"] == {"openrec.n": 1}
    assert trace.enable(False) is True
    trace.reset()
    assert trace.snapshot() == {"spans": {}, "counters": {}}


def test_profiled_spans_nest_as_called(tmp_path):
    trace.enable(True)

    def body():
        with trace.span("openrec.outer"):
            with trace.span("openrec.first"):
                torch.ones(3).sum()
            with trace.span("openrec.second"):
                with trace.span("openrec.inner"):
                    torch.ones(3).sum()

    got = _profiled(body, tmp_path / "t.json")
    assert got == [("openrec.outer", None),
                   ("openrec.first", "openrec.outer"),
                   ("openrec.second", "openrec.outer"),
                   ("openrec.inner", "openrec.second")]


def test_device_counter_reads_the_host_only_at_snapshot(monkeypatch):
    trace.enable(True)
    values = [torch.tensor([True, False, True]), torch.tensor([1, 1, 0])]

    def refuse(*_):
        raise AssertionError("host read before snapshot")
    with monkeypatch.context() as m:
        for attr in ("item", "tolist", "__bool__", "__int__", "__float__",
                     "cpu", "numpy"):
            m.setattr(torch.Tensor, attr, refuse)
        for v in values:
            trace.count_device("openrec.d", v)
    assert trace.snapshot()["counters"] == {"openrec.d": 4}
    trace.enable(False)
    trace.count_device("openrec.d", values[0])
    assert trace.snapshot()["counters"] == {"openrec.d": 4}


def _scorer(items, dim=4, users=40):
    model = BPR(users, items, dim, dim, device="cpu")
    scorer = CachedDotProductScorer(
        model, users, items,
        extract_user_vecs=lambda p, i: embedding_lookup(p["user_embed"], i),
        extract_item_vecs=lambda p, i: embedding_lookup(p["item_embed"], i),
        extract_item_bias=lambda p, i: embedding_lookup(p["item_bias"], i),
        device="cpu")
    params = model.params()
    scorer.cache(params)
    return scorer, params


@pytest.mark.parametrize("method,items,syncs", [
    ("exact", SHORT_ROW + 1000, 1),
    ("exact", 2000, 0),
    ("pallas", SHORT_ROW + 1000, 0),
    ("pallas2", 3000, 0)])
def test_topk_spans(tmp_path, method, items, syncs):
    scorer, params = _scorer(items)
    trace.enable(True)
    users = torch.arange(8)
    got = _profiled(lambda: scorer.topk(params, users, k=10, method=method),
                    tmp_path / "t.json")
    want = [("openrec.serve.topk", None),
            ("openrec.serve.score", "openrec.serve.topk"),
            ("openrec.serve.select", "openrec.serve.topk")]
    want += [("openrec.host_sync", "openrec.serve.select")] * syncs
    assert got == want
    assert trace.counter(trace.HOST_SYNCS) == syncs
    assert trace.snapshot()["spans"]["openrec.serve.topk"]["calls"] == 1


def _dlrm_batch(rng, B=24):
    return {"dense_features": rng.normal(size=(B, 3)).astype(np.float32),
            "sparse_features": np.stack([rng.integers(0, c, B)
                                         for c in LN_EMB],
                                        axis=1).astype(np.int32),
            "label": rng.integers(0, 2, B).astype(np.float32)}


def _dlrm_trainer():
    model = DLRM(m_spa=4, ln_emb=LN_EMB, ln_bot=(8, 4), ln_top=(16, 1),
                 dim_dense=3, loss_func="bce", fused_tables=True,
                 device="cpu")
    return model, Trainer(model, device="cpu",
                          sparse_tables=dlrm_fused_table_spec(model))


def test_sparse_step_spans_in_order_and_unique_rows(tmp_path):
    model, trainer = _dlrm_trainer()
    rng = np.random.default_rng(5)
    batches = [_dlrm_batch(rng) for _ in range(2)]
    trace.enable(True)
    got = _profiled(lambda: trainer.train_step(batches[0]),
                    tmp_path / "t.json")
    assert got == [("openrec.train.step", None)] + [
        (name, "openrec.train.step") for name in TRAIN_SPANS]
    trainer.train_step(batches[1])
    offsets = np.concatenate([[0], np.cumsum(LN_EMB)[:-1]])
    distinct = sum(len(np.unique(b["sparse_features"] + offsets))
                   for b in batches)
    counters = trace.snapshot()["counters"]
    assert counters["openrec.train.unique_rows"] == distinct
    assert counters["openrec.train.id_slots"] == 2 * 24 * len(LN_EMB)


def test_dense_step_spans():
    model = BPR(30, 40, 4, 4, device="cpu")
    trainer = Trainer(model, device="cpu")
    rng = np.random.default_rng(1)
    batch = {"user_id": rng.integers(0, 30, 16),
             "p_item_id": rng.integers(0, 40, 16),
             "n_item_id": rng.integers(0, 40, 16)}
    trace.enable(True)
    trainer.train_step(batch)
    spans = trace.snapshot()["spans"]
    assert set(spans) == {"openrec.train.step", "openrec.train.forward",
                          "openrec.train.backward", "openrec.train.adam"}
    assert all(s["calls"] == 1 for s in spans.values())


def test_feed_span_holds_each_batch_taken():
    batches = [{"x": np.full(4, i, np.float32)} for i in range(5)]
    trace.enable(True)
    got = [int(b["x"][0]) for b in device_iterator(batches, "cpu",
                                                   prefetch=2)]
    assert got == list(range(5))
    # a span for each batch but the last, which was already in flight,
    # and one that finds the source empty
    assert trace.snapshot()["spans"]["openrec.feed.next"]["calls"] == 5


# DLRM-DCNv2 at MLPerf's bags (26 tables, 214 ids an example) over small
# tables: the pooling and cross spans, and the pooled-ids counter
MULTI_HOT = (3, 2, 1, 2, 6, 1, 1, 1, 1, 7, 3, 8, 1, 6, 9, 5, 1, 1, 1, 12,
             100, 27, 10, 3, 1, 1)
DCN_LN_EMB = tuple(40 + 7 * t for t in range(26))


def _dcn_trainer():
    model = DLRM(m_spa=4, ln_emb=DCN_LN_EMB, ln_bot=(8, 4), ln_top=(16, 1),
                 dim_dense=3, arch_interaction_op="dcn", dcn_layers=2,
                 dcn_rank=3, multi_hot=MULTI_HOT, loss_func="bce",
                 fused_tables=True, device="cpu")
    return model, Trainer(model, device="cpu",
                          sparse_tables=dlrm_fused_table_spec(model))


def _dcn_batch(rng, B=16):
    cols = [rng.integers(0, c, (B, n)) for c, n in zip(DCN_LN_EMB, MULTI_HOT)]
    return {"dense_features": rng.normal(size=(B, 3)).astype(np.float32),
            "sparse_features": np.concatenate(cols, 1).astype(np.int32),
            "label": rng.integers(0, 2, B).astype(np.float32)}


def test_dcn_spans_sit_in_the_forward_and_count_bag_ids(tmp_path):
    model, trainer = _dcn_trainer()
    batch = _dcn_batch(np.random.default_rng(2))
    trace.enable(True)
    got = _profiled(lambda: trainer.train_step(batch), tmp_path / "t.json")
    assert ("openrec.dlrm.pool", "openrec.train.forward") in got
    assert ("openrec.dlrm.cross", "openrec.train.forward") in got
    names = [n for n, _ in got]
    assert names.index("openrec.dlrm.pool") \
        < names.index("openrec.dlrm.cross") \
        < names.index("openrec.train.backward")
    snap = trace.snapshot()
    assert snap["spans"]["openrec.dlrm.pool"]["calls"] == 1
    assert snap["spans"]["openrec.dlrm.cross"]["calls"] == 1
    assert sum(MULTI_HOT) == 214
    assert snap["counters"]["openrec.dlrm.bag_ids"] == 214 * 16


def test_dcn_tracer_off_records_no_span_and_still_counts(monkeypatch):
    """Off, the pooling and cross spans enter no annotation and keep no
    total; the host counter counts as it does on, and the step's
    results are the same bits."""
    batch = _dcn_batch(np.random.default_rng(3))
    results = {}
    for on in (True, False):
        torch.manual_seed(0)
        model, trainer = _dcn_trainer()
        trace.enable(on)
        with monkeypatch.context() as m:
            if not on:
                def refuse(name):
                    raise AssertionError(f"record_function({name!r})")
                m.setattr(torch.profiler, "record_function", refuse)
            with profile(activities=[ProfilerActivity.CPU]):
                loss, _ = trainer.train_step(batch)
        snap = trace.snapshot()
        trace.enable(False)
        trace.reset()
        results[on] = (loss, model.params(), snap)
    spans_off = results[False][2]["spans"]
    assert spans_off == {}
    assert results[False][2]["counters"]["openrec.dlrm.bag_ids"] == 214 * 16
    assert "openrec.dlrm.pool" in results[True][2]["spans"]
    assert torch.equal(results[True][0], results[False][0])
    for n, v in results[True][1].items():
        assert torch.equal(v, results[False][1][n]), n
