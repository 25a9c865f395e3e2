"""The plain references against the port on small tables on the CPU."""

import pytest
import torch

from portbench import traffic, weights
from portbench.drivers import serve, train
from portbench.reference import dlrm as ref_dlrm, topk as ref_topk

CPU = torch.device("cpu")


def test_topk_reference_agrees_with_the_port(tiny):
    cell = tiny("bpr-amazon.serve-k1")
    cfg, k = cell["config"], cell["traffic"]["k"]
    _, scorer, params = serve.build(cfg, 11, CPU)
    users = torch.arange(0, 300, 3)
    sample = []
    for method in ("exact", "pallas"):
        vals, ids = scorer.topk(params, users, k=k, method=method,
                                recall_target=0.99)
        sample.append((users.numpy(), vals.numpy(), ids.numpy()))
    U, V, b = ref_topk.tables(cfg, 11, CPU)
    exact = ref_topk.compare(U, V, b, sample[:1], k)
    assert exact["users"] == 100
    assert exact["score_err"] < 1e-6
    assert exact["miss_share"] == 0.0
    assert exact["order_errors"] == 0
    approx = ref_topk.compare(U, V, b, sample[1:], k)
    assert approx["score_err"] < 1e-6
    assert 0.0 < approx["miss_share"] < 0.05
    assert approx["order_errors"] == 0


def test_topk_reference_catches_a_wrong_answer(tiny):
    cell = tiny("bpr-amazon.serve-exact")
    cfg, k = cell["config"], cell["traffic"]["k"]
    U, V, b = ref_topk.tables(cfg, 3, CPU)
    users = torch.arange(8)
    vals, ids = ref_topk.exact_topk(U, V, b, users, k)
    good = (users.numpy(), vals.float().numpy(), ids.numpy())
    assert ref_topk.compare(U, V, b, [good], k)["score_err"] < 1e-6
    bad_ids = ids.clone()
    bad_ids[:, 0] = bad_ids[:, -1]
    r = ref_topk.compare(U, V, b, [(good[0], good[1], bad_ids.numpy())], k)
    assert r["order_errors"] == 8 and r["score_err"] > 1e-3


def test_dlrm_reference_follows_the_port(tiny):
    cell = tiny("dlrm-kaggle.train-zipf")
    cfg, tr = cell["config"], cell["traffic"]
    model, trainer, w0 = train.build(cfg, 5, CPU)
    pool = traffic.train_pool(tr, cfg, 5, CPU, pin=False)
    losses = []
    for step, batch in enumerate(pool[:3]):
        loss, _ = trainer.train_step(batch)
        losses.append(float(loss))
        if step == 0:
            grads = train.state_grads(trainer, cfg)
    params = {n: p.detach() for n, p in trainer.params.items()}
    program = {
        "losses": losses, "grads": grads,
        "change": {n: float((p - w0[n]).norm()) for n, p in params.items()},
        "changed_rows": int((params["embed_fused"] != w0["embed_fused"])
                            .any(1).sum())}
    ref = ref_dlrm.train_steps(cfg, weights.dlrm_weights(cfg, 5, CPU),
                               pool[:3], CPU)
    assert set(ref["grads"]) == set(grads)
    r = ref_dlrm.compare(program, ref)
    assert r["loss_gap"] < 1e-6
    assert r["grad_gap"] < 1e-5
    assert r["change_gap"] < 1e-5
    assert r["rows_gap"] == 0.0
    assert r["nonfinite"] == 0
    uniq = torch.unique(torch.cat([
        (p["sparse_features"].long()
         + torch.tensor([0, *cfg["ln_emb"][:-1]]).cumsum(0)).reshape(-1)
        for p in pool[:3]]))
    assert ref["changed_rows"] == len(uniq)


def test_dlrm_reference_follows_the_port_from_a_copy_of_its_state(tiny):
    cell = tiny("dlrm-kaggle.train-zipf")
    cfg, tr = cell["config"], cell["traffic"]
    model, trainer, _ = train.build(cfg, 6, CPU)
    pool = traffic.train_pool(tr, cfg, 6, CPU, pin=False)
    for batch in pool[:3]:
        trainer.train_step(batch)
    start, again = train.snapshot(trainer), train.snapshot(trainer)
    later = pool[3:] + pool[:1]
    program = train.follow(trainer, iter(later), cfg, len(later), start,
                           train.table_rows(cfg, later[0], CPU))
    ref = ref_dlrm.train_steps(cfg, start["params"], later, CPU, start, 3)
    r = ref_dlrm.compare(program, ref)
    assert r["loss_gap"] < 1e-6
    assert r["grad_gap"] < 1e-5
    assert r["change_gap"] < 1e-5
    assert r["rows_gap"] == 0.0
    # from the same copy at a wrong step count, Adam's bias correction
    # moves every leaf differently
    wrong = ref_dlrm.train_steps(cfg, again["params"], later, CPU, again, 0)
    assert ref_dlrm.compare(program, wrong)["change_gap"] > 1e-2


def test_dlrm_reference_refuses_another_model(tiny):
    cfg = dict(tiny("dlrm-kaggle.train-zipf")["config"], interaction="cat")
    with pytest.raises(ValueError):
        ref_dlrm.train_steps(cfg, {}, [], CPU)
