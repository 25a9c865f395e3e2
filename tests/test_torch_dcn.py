"""DLRM-DCNv2 in the port (`DLRM(arch_interaction_op="dcn",
multi_hot=...)`) against the plain reference `plain_dlrm_dcnv2.py` on
seeded random weights at a small size: the forward pass, the loss and
every gradient, three sparse-Adam steps through `Trainer`, the dedup
modes on multi-hot ids; and the one-hot dot DLRM held bit for bit to the
formulas it had before multi-hot bags and the cross network existed.

Tolerances, with their reasons:
- probabilities, logits and the cross network's output: rtol 1e-5,
  atol 1e-6, fp32 sums taken in another order (`embedding_bag` against
  a sum over the gathered rows; GEMMs blocked otherwise) stay near 1e-7;
- loss: 1e-6 relative, the same sums;
- gradients: each leaf's gap in norm, over its plain norm, at most 1e-5;
- three Adam steps: parameters rtol 1e-4, atol 1e-7 (Adam divides a
  gradient by its own root, so a rounding gap of a small component
  grows to a relative one), losses 1e-6 relative, and the set of table
  rows that changed exactly.
The plain side computing the cross layers in TF32 (operands rounded to
10 mantissa bits) or in bf16 fails at least one of them
(`test_lower_precision_cross_fails`).
"""

import numpy as np
import pytest
import torch

import plain_dlrm_dcnv2 as plain
from openrec_tpu_torch import trace
from openrec_tpu_torch.models import DLRM
from openrec_tpu_torch.modules.embedding import (embedding_bags,
                                                 embedding_lookup)
from openrec_tpu_torch.modules.interactions import second_order_interaction
from openrec_tpu_torch.modules.losses import bce_loss
from openrec_tpu_torch.training import Trainer
from openrec_tpu_torch.training.sparse import (SubTable,
                                               dlrm_fused_table_spec,
                                               unique_padded)

torch.set_num_threads(1)

RTOL, ATOL = 1e-5, 1e-6
LOSS_RTOL = 1e-6
GRAD_GAP = 1e-5
STEP_RTOL, STEP_ATOL = 1e-4, 1e-7

# tables of a few hundred rows, bags of 1-5 ids and one of 12, m 8, two
# cross layers of rank 4, batch 64
CFG = {"m_spa": 8, "ln_emb": [300, 120, 450, 60, 200, 90],
       "multi_hot": [3, 1, 12, 2, 5, 1], "ln_bot": [16, 8],
       "ln_top": [32, 16, 1], "dim_dense": 5, "dcn_layers": 2,
       "dcn_rank": 4}
B = 64


def _model(cfg=CFG, fused=True, seed=0):
    gen = torch.Generator().manual_seed(seed)
    return DLRM(m_spa=cfg["m_spa"], ln_emb=cfg["ln_emb"],
                ln_bot=cfg["ln_bot"], ln_top=cfg["ln_top"],
                dim_dense=cfg["dim_dense"], arch_interaction_op="dcn",
                dcn_layers=cfg["dcn_layers"], dcn_rank=cfg["dcn_rank"],
                multi_hot=cfg["multi_hot"], loss_func="bce",
                fused_tables=fused, device="cpu", generator=gen)


def _batch(seed=0, cfg=CFG, b=B):
    rng = np.random.default_rng(seed)
    cols = [rng.integers(0, c, (b, n))
            for c, n in zip(cfg["ln_emb"], cfg["multi_hot"])]
    return {"dense_features": rng.normal(size=(b, cfg["dim_dense"]))
            .astype(np.float32),
            "sparse_features": np.concatenate(cols, 1).astype(np.int32),
            "label": rng.integers(0, 2, b).astype(np.float32)}


def _fused_params(model) -> dict:
    """The model's parameters by name (plain tensors, cloned)."""
    return {n: v.detach().clone() for n, v in model.params().items()}


def _rel(a, b) -> float:
    return float((a - b).norm() / b.norm().clamp(min=1e-30))


def _gaps(model, batch, cross_precision="fp32") -> dict:
    """The port against the plain reference on one batch: whether each
    quantity is within its tolerance."""
    p = _fused_params(model)
    logit, prob = plain.forward(CFG, p, batch, cross_precision)
    pred = model.predict(batch["dense_features"], batch["sparse_features"])
    port_logit = torch.logit(pred.detach().double()).float()
    ref_loss, ref_g = plain.loss_and_grads(CFG, p, batch, cross_precision)
    loss, _ = model.loss(batch)
    leaves = model.params()
    g = torch.autograd.grad(loss, list(leaves.values()))
    g = dict(zip(leaves, g))
    return {
        "prob": torch.allclose(pred.detach(), prob, rtol=RTOL, atol=ATOL),
        "logit": torch.allclose(port_logit, logit, rtol=RTOL, atol=ATOL),
        "loss": abs(float(loss.detach()) - float(ref_loss))
        <= LOSS_RTOL * abs(float(ref_loss)),
        "grads": {n: _rel(g[n], ref_g[n]) <= GRAD_GAP for n in ref_g},
    }


def test_forward_loss_and_every_gradient_match_plain():
    model = _model()
    got = _gaps(model, _batch(1))
    assert got["prob"] and got["logit"] and got["loss"]
    assert got["grads"] and all(got["grads"].values()), got["grads"]
    assert len(got["grads"]) == 1 + 2 * 2 + 2 * 3 + 3 * 2


@pytest.mark.parametrize("precision", ["tf32", "bf16"])
def test_lower_precision_cross_fails(precision):
    """The control: the same comparison with the plain side's cross
    layers one precision lower fails at least one tolerance."""
    got = _gaps(_model(), _batch(1), cross_precision=precision)
    ok = got["prob"] and got["logit"] and got["loss"] \
        and all(got["grads"].values())
    assert not ok


def test_cross_network_matches_plain():
    model = _model()
    p = _fused_params(model)
    x0 = torch.randn(B, (len(CFG["ln_emb"]) + 1) * CFG["m_spa"],
                     generator=torch.Generator().manual_seed(3))
    got = model.cross(x0)
    want = plain._cross(x0, p, CFG["dcn_layers"], "fp32")
    torch.testing.assert_close(got, want, rtol=RTOL, atol=ATOL)
    tf32 = plain._cross(x0, p, CFG["dcn_layers"], "tf32")
    assert not torch.allclose(got, tf32, rtol=RTOL, atol=ATOL)


def test_pooling_is_the_sum_of_each_bag():
    model = _model()
    batch = _batch(2)
    sparse = torch.as_tensor(batch["sparse_features"])
    got = model.pooled(sparse)
    want = plain.pooled(CFG, model.embed_fused.detach(), sparse)
    torch.testing.assert_close(got, want, rtol=RTOL, atol=ATOL)
    assert got.shape == (B, len(CFG["ln_emb"]), CFG["m_spa"])


def test_subtable_bags_pool_first_matches():
    """A gathered view's bags: the same sums as the full table's, and the
    gradient lands on the first match of each id, never on a pad."""
    table = torch.randn(40, 4, generator=torch.Generator().manual_seed(0))
    ids = torch.tensor([3, 7, 7, 12, 3, 30, 12, 12], dtype=torch.int32)
    offsets = torch.tensor([0, 3, 4, 6])
    uids, valid = unique_padded(ids, 8)
    rows = table[uids.long()].clone().requires_grad_()
    got = embedding_bags(SubTable(uids, rows), ids, offsets)
    torch.testing.assert_close(got, embedding_bags(table, ids, offsets))
    rows_of = embedding_lookup(table, ids)
    want = torch.stack([rows_of[0:3].sum(0), rows_of[3:4].sum(0),
                        rows_of[4:6].sum(0), rows_of[6:].sum(0)])
    torch.testing.assert_close(got, want)
    got.sum().backward()
    assert torch.all(rows.grad[~valid] == 0)
    counts = torch.bincount(ids.long(), minlength=40).float()
    torch.testing.assert_close(rows.grad[valid][:, 0],
                               counts[uids[valid].long()])


def _changed(before, after) -> torch.Tensor:
    return torch.nonzero((before != after).any(1)).reshape(-1)


@pytest.mark.parametrize("mode", ["flat", "hash"])
def test_three_sparse_adam_steps_match_plain(mode):
    model = _model(seed=4)
    p = _fused_params(model)
    start = p["embed_fused"].clone()
    batches = [_batch(10 + i) for i in range(3)]
    trainer = Trainer(model, lr=1e-3, device="cpu",
                      sparse_tables=dlrm_fused_table_spec(model, mode=mode))
    losses = [float(trainer.train_step(b)[0]) for b in batches]
    want = plain.adam_steps(CFG, p, batches)
    np.testing.assert_allclose(losses, want, rtol=LOSS_RTOL)
    for n, v in model.params().items():
        torch.testing.assert_close(v.detach(), p[n], rtol=STEP_RTOL,
                                   atol=STEP_ATOL, msg=n)
    assert torch.equal(_changed(start, model.embed_fused.detach()),
                       _changed(start, p["embed_fused"]))
    touched = torch.zeros(start.shape[0], dtype=torch.bool)
    for b in batches:
        touched |= plain.touched_rows(CFG, b)
    assert torch.equal(_changed(start, p["embed_fused"]),
                       torch.nonzero(touched).reshape(-1))


def test_hash_mode_trains_as_flat():
    """The sort-free dedup on multi-hot ids: its slots hold the rows in
    another order, so a row's gradients add up in another order; the
    trajectories agree to fp32 rounding (rtol 1e-6, atol 1e-8)."""
    batches = [_batch(20 + i) for i in range(3)]
    out = {}
    for mode in ("flat", "hash"):
        model = _model(seed=5)
        trainer = Trainer(model, lr=1e-3, device="cpu",
                          sparse_tables=dlrm_fused_table_spec(model,
                                                              mode=mode))
        losses = [trainer.train_step(b)[0] for b in batches]
        out[mode] = (torch.stack(losses), model.params())
    torch.testing.assert_close(out["flat"][0], out["hash"][0], rtol=1e-6,
                               atol=0)
    for n, v in out["flat"][1].items():
        torch.testing.assert_close(v, out["hash"][1][n], rtol=1e-6,
                                   atol=1e-8, msg=n)


def test_flat_spec_takes_multi_hot_ids_as_they_are():
    model = _model()
    batch = _batch(6)
    ids = dlrm_fused_table_spec(model)["embed_fused"](batch)
    offsets = np.concatenate([[0], np.cumsum(CFG["ln_emb"])[:-1]])
    cols = np.repeat(offsets, CFG["multi_hot"])
    want = (batch["sparse_features"] + cols).reshape(-1)
    np.testing.assert_array_equal(ids.numpy(), want)
    uids, valid = unique_padded(ids, ids.shape[0])
    np.testing.assert_array_equal(uids[valid].numpy(), np.unique(want))


@pytest.mark.parametrize("kw", [{"mode": "columns"}, {"mode": "mixed"},
                                {"columnwise": True}])
def test_columns_and_mixed_refuse_multi_hot(kw):
    with pytest.raises(ValueError, match="multi-hot"):
        dlrm_fused_table_spec(_model(), **kw)


def test_one_hot_multi_hot_of_ones_takes_columns():
    cfg = {**CFG, "multi_hot": [1] * len(CFG["ln_emb"])}
    spec = dlrm_fused_table_spec(_model(cfg), mode="columns")
    assert "embed_fused" in spec


def test_dcn_names_shapes_and_checks():
    model = _model()
    d = (len(CFG["ln_emb"]) + 1) * CFG["m_spa"]
    shapes = {n: tuple(v.shape) for n, v in model.params().items()}
    for i in range(CFG["dcn_layers"]):
        assert shapes[f"cross/{i}/v"] == (d, CFG["dcn_rank"])
        assert shapes[f"cross/{i}/w"] == (CFG["dcn_rank"], d)
        assert shapes[f"cross/{i}/b"] == (d,)
    assert shapes["mlp_top/0/w"] == (d, CFG["ln_top"][0])
    assert torch.all(model.cross[0].b == 0)
    with pytest.raises(ValueError, match="dcn_layers"):
        _model(cfg={**CFG, "dcn_layers": 0})
    with pytest.raises(ValueError, match="multi_hot"):
        _model(cfg={**CFG, "multi_hot": [1, 2]})
    with pytest.raises(ValueError, match="ln_bot"):
        _model(cfg={**CFG, "ln_bot": [16, 4]})
    with pytest.raises(ValueError, match="fused_tables"):
        _model(fused=False)
    batch = _batch(0)
    with pytest.raises(ValueError, match="columns"):
        model.predict(batch["dense_features"],
                      batch["sparse_features"][:, :-1])


def test_bf16_compute_stays_near_fp32():
    """compute_dtype="bfloat16" runs the MLPs and the cross layers in
    bf16 (parameters fp32): within 2e-2 of the fp32 prediction, as the
    dot DLRM's bf16 test allows."""
    batch = _batch(9)
    fp32 = _model().predict(batch["dense_features"],
                            batch["sparse_features"])
    gen = torch.Generator().manual_seed(0)
    bf16 = DLRM(m_spa=CFG["m_spa"], ln_emb=CFG["ln_emb"],
                ln_bot=CFG["ln_bot"], ln_top=CFG["ln_top"],
                dim_dense=CFG["dim_dense"], arch_interaction_op="dcn",
                dcn_layers=CFG["dcn_layers"], dcn_rank=CFG["dcn_rank"],
                multi_hot=CFG["multi_hot"], loss_func="bce",
                fused_tables=True, compute_dtype="bfloat16", device="cpu",
                generator=gen)
    got = bf16.predict(batch["dense_features"], batch["sparse_features"])
    assert got.dtype == torch.float32
    torch.testing.assert_close(got, fp32, rtol=0, atol=2e-2)
    assert not torch.equal(got, fp32)


# the one-hot dot DLRM: train-zipf's model (fused tables, dot, BCE, flat
# dedup) at a small size, held to the formulas of the model and the
# gathered view as they were before bags and the cross network


KAGGLE = dict(m_spa=4, ln_emb=(50, 7, 300, 200, 5), ln_bot=(16, 8, 4),
              ln_top=(16, 8, 1), dim_dense=13, arch_interaction_op="dot",
              loss_func="bce", fused_tables=True)


def _parent_lookup(table, ids):
    if isinstance(table, SubTable):
        pos = torch.searchsorted(
            table.uids_sorted,
            ids.to(table.uids_sorted.dtype).contiguous().reshape(-1))
        pos = pos.clamp(0, table.rows.shape[0] - 1)
        return table.rows.index_select(0, pos).reshape(
            *ids.shape, *table.rows.shape[1:])
    safe = ids.long().clamp(0, table.shape[0] - 1)
    return table.index_select(0, safe.reshape(-1)).reshape(
        *ids.shape, *table.shape[1:])


def _parent_predict(model, dense_features, sparse_features, tables=None):
    dense = torch.as_tensor(dense_features)
    sparse = torch.as_tensor(sparse_features)
    B_, T = sparse.shape
    offsets = torch.as_tensor(model.table_offsets[:-1], dtype=torch.int32)
    ids = sparse + offsets[None, :]
    rows = _parent_lookup(model.table("embed_fused", tables),
                          ids.reshape(-1))
    sparse_vecs = rows.reshape(B_, T, model.m_spa)
    dense_vec = model.mlp_bot(dense)
    inter = second_order_interaction(
        torch.cat([sparse_vecs, dense_vec[:, None, :]], dim=1))
    top_in = torch.cat([dense_vec, inter], dim=1)
    return model.mlp_top(top_in).to(torch.float32).reshape(-1)


def _kaggle_batch(seed, b=32):
    rng = np.random.default_rng(seed)
    return {"dense_features": rng.normal(size=(b, 13)).astype(np.float32),
            "sparse_features": np.stack(
                [rng.integers(0, c, b) for c in KAGGLE["ln_emb"]], 1)
            .astype(np.int32),
            "label": rng.integers(0, 2, b).astype(np.float32)}


def test_one_hot_dot_dlrm_is_unchanged_bit_for_bit():
    batches = [_kaggle_batch(30 + i) for i in range(3)]
    runs = {}
    for formula in ("now", "parent"):
        model = DLRM(**KAGGLE, device="cpu",
                     generator=torch.Generator().manual_seed(9))
        assert model.multi_hot is None and not hasattr(model, "cross")
        np.testing.assert_array_equal(model._offsets.numpy(),
                                      model.table_offsets[:-1])
        if formula == "parent":
            def predict(dense, sparse, tables=None, model=model):
                return _parent_predict(model, dense, sparse, tables)
            model.predict = predict
            model.loss = lambda batch, tables=None, generator=None, \
                model=model: (bce_loss(torch.as_tensor(batch["label"]),
                                       model.predict(
                                           batch["dense_features"],
                                           batch["sparse_features"],
                                           tables)), {})
        first = model.predict(batches[0]["dense_features"],
                              batches[0]["sparse_features"]).detach()
        trainer = Trainer(model, lr=1e-3, device="cpu",
                          sparse_tables=dlrm_fused_table_spec(model))
        losses = torch.stack([trainer.train_step(b)[0] for b in batches])
        runs[formula] = (first, losses, model.params())
    assert torch.equal(runs["now"][0], runs["parent"][0])
    assert torch.equal(runs["now"][1], runs["parent"][1])
    for n, v in runs["now"][2].items():
        assert torch.equal(v, runs["parent"][2][n]), n


def test_tracer_off_and_on_give_the_same_bits():
    batch = _batch(8)
    preds = []
    for on in (False, True):
        trace.enable(on)
        try:
            preds.append(_model().predict(batch["dense_features"],
                                          batch["sparse_features"]))
        finally:
            trace.enable(False)
            trace.reset()
    assert torch.equal(preds[0], preds[1])
