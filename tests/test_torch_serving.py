"""Port parity: CachedDotProductScorer (serve, topk for every method,
eval_metrics, re-cache after mark_dirty) and the metrics beneath it,
against the JAX package on the same BPR parameters.

Tolerances: values rtol=atol=1e-5; ids exact except where the two picks
score within 1e-5 of each other (a different summation order may flip
them); metrics rtol=1e-5, atol=1e-6, as the JAX package's own
catalog-scale eval tests hold them.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from openrec_tpu.metrics import AUC as jAUC, NDCG as jNDCG, \
    Precision as jPrecision, Recall as jRecall
from openrec_tpu.metrics.ranking import ids_to_masks as j_ids_to_masks
from openrec_tpu.models import BPR as JBPR
from openrec_tpu.modules.embedding import embedding_lookup as j_lookup
from openrec_tpu.serving import CachedDotProductScorer as JScorer
from openrec_tpu_torch import convert
from openrec_tpu_torch.metrics import (AUC, NDCG, Precision, Recall,
                                       chunked_dot_eval_metrics)
from openrec_tpu_torch.metrics.ranking import (ids_to_masks,
                                               ranking_metrics)
from openrec_tpu_torch.models import BPR
from openrec_tpu_torch.modules.embedding import embedding_lookup
from openrec_tpu_torch.serving import CachedDotProductScorer

torch.set_num_threads(1)

USERS, ITEMS, DIM = 40, 3000, 16
TOL = 1e-5
AT = (5, 20)


def _jax_params(seed=0):
    params = JBPR(total_users=USERS, total_items=ITEMS, dim_user_embed=DIM,
                  dim_item_embed=DIM).init(jax.random.PRNGKey(seed))
    params = jax.tree.map(np.asarray, params)
    # a nonzero bias, so the bias path is held too
    params["item_bias"] = np.random.default_rng(seed).normal(
        scale=0.05, size=(ITEMS, 1)).astype(np.float32)
    return params


def _scorers(np_params, serve_dtype):
    jdt = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}
    js = JScorer(
        None, USERS, ITEMS,
        extract_user_vecs=lambda p, i: j_lookup(p["user_embed"], i),
        extract_item_vecs=lambda p, i: j_lookup(p["item_embed"], i),
        extract_item_bias=lambda p, i: j_lookup(p["item_bias"], i),
        extract_batch_size=1024, serve_dtype=jdt[serve_dtype])
    model = BPR(USERS, ITEMS, DIM, DIM, device="cpu")
    model.load_params(convert.params_from_jax(np_params, device="cpu"))
    ts = CachedDotProductScorer(
        model, USERS, ITEMS,
        extract_user_vecs=lambda p, i: embedding_lookup(p["user_embed"], i),
        extract_item_vecs=lambda p, i: embedding_lookup(p["item_embed"], i),
        extract_item_bias=lambda p, i: embedding_lookup(p["item_bias"], i),
        extract_batch_size=1024, serve_dtype=serve_dtype, device="cpu")
    jparams = jax.tree.map(jnp.asarray, np_params)
    return js, jparams, ts, model


def _assert_ids(got, want, full):
    got, want = np.asarray(got, np.int64), np.asarray(want, np.int64)
    diff = got != want
    if diff.any():
        np.testing.assert_allclose(
            np.take_along_axis(full, got, 1)[diff],
            np.take_along_axis(full, want, 1)[diff], rtol=0, atol=TOL)


USER_IDS = np.arange(0, USERS, 3, dtype=np.int32)


@pytest.mark.parametrize("serve_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("method", ["exact", "approx", "pallas", "pallas2"])
def test_topk_matches_jax(method, serve_dtype):
    np_params = _jax_params()
    js, jparams, ts, model = _scorers(np_params, serve_dtype)
    k, target = 30, 0.995 if method == "pallas2" else 0.99
    want_v, want_i = js.topk(jparams, USER_IDS, k=k, method=method,
                             recall_target=target)
    got_v, got_i = ts.topk(model.params(), USER_IDS, k=k, method=method,
                           recall_target=target)
    np.testing.assert_allclose(got_v.numpy(), np.asarray(want_v),
                               rtol=TOL, atol=TOL)
    full = ts.serve(model.params(), USER_IDS).double().numpy()
    _assert_ids(got_i.numpy(), np.asarray(want_i), full)
    # every returned score is the fp32 score at its id
    np.testing.assert_allclose(np.take_along_axis(full, got_i.numpy(), 1),
                               got_v.numpy(), rtol=TOL, atol=TOL)


@pytest.mark.parametrize("serve_dtype", [torch.float32, torch.bfloat16])
def test_serve_matches_jax(serve_dtype):
    np_params = _jax_params()
    js, jparams, ts, model = _scorers(np_params, serve_dtype)
    want = np.asarray(js.serve(jparams, USER_IDS))
    got = ts.serve(model.params(), USER_IDS)
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=TOL, atol=TOL)


def _eval_ids(seed, B, P=6, E=5, items=ITEMS):
    rng = np.random.default_rng(seed)
    pos = np.full((B, P), -1, np.int32)
    excl = np.full((B, E), -1, np.int32)
    for r in range(B):
        n_pos, n_excl = rng.integers(1, P + 1), rng.integers(0, E + 1)
        picks = rng.choice(items, size=n_pos + n_excl, replace=False)
        pos[r, :n_pos], excl[r, :n_excl] = picks[:n_pos], picks[n_pos:]
    excl[0, -1] = pos[0, 0]           # a positive that is also excluded
    return pos, excl


@pytest.mark.parametrize("serve_dtype", [torch.float32, torch.bfloat16])
def test_eval_metrics_matches_jax(serve_dtype):
    np_params = _jax_params()
    js, jparams, ts, model = _scorers(np_params, serve_dtype)
    pos, excl = _eval_ids(3, len(USER_IDS))
    want = js.eval_metrics(jparams, USER_IDS, pos, excl, at=AT, chunk=700)
    got = ts.eval_metrics(model.params(), USER_IDS, pos, excl, at=AT,
                          chunk=700)
    for key in want:
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]),
                                   rtol=1e-5, atol=1e-6, err_msg=key)


def test_mark_dirty_recaches_like_jax():
    np_params = _jax_params()
    js, jparams, ts, model = _scorers(np_params, torch.bfloat16)
    pos, excl = _eval_ids(4, len(USER_IDS))
    js.topk(jparams, USER_IDS, k=5)
    ts.topk(model.params(), USER_IDS, k=5)
    js.eval_metrics(jparams, USER_IDS, pos, excl, at=AT, chunk=1000)
    ts.eval_metrics(model.params(), USER_IDS, pos, excl, at=AT, chunk=1000)
    # "train": new params; without mark_dirty the caches stay stale
    new = _jax_params(seed=1)
    jnew = jax.tree.map(jnp.asarray, new)
    model.load_params(convert.params_from_jax(new, device="cpu"))
    stale = ts.serve(model.params(), USER_IDS)
    np.testing.assert_allclose(stale.numpy(),
                               np.asarray(js.serve(jnew, USER_IDS)),
                               rtol=TOL, atol=TOL)
    js.mark_dirty()
    ts.mark_dirty()
    np.testing.assert_allclose(ts.serve(model.params(), USER_IDS).numpy(),
                               np.asarray(js.serve(jnew, USER_IDS)),
                               rtol=TOL, atol=TOL)
    assert not np.allclose(stale.numpy(),
                           ts.serve(model.params(), USER_IDS).numpy())
    want = js.eval_metrics(jnew, USER_IDS, pos, excl, at=AT, chunk=1000)
    got = ts.eval_metrics(model.params(), USER_IDS, pos, excl, at=AT,
                          chunk=1000)
    for key in want:
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]),
                                   rtol=1e-5, atol=1e-6, err_msg=key)


def test_dense_metrics_match_jax_with_ties():
    """The dense metrics with planted score ties: AUC counts <=, rank_above
    is strict > after exp*not(excl)."""
    rng = np.random.default_rng(8)
    B, I = 6, 200
    pred = rng.integers(-3, 4, size=(B, I)).astype(np.float32)  # many ties
    pos, excl = _eval_ids(9, B, items=I)
    pos[:, -1] = -1
    jpos, jexcl = j_ids_to_masks(jnp.asarray(pos), jnp.asarray(excl), I)
    tpos, texcl = ids_to_masks(torch.from_numpy(pos),
                               torch.from_numpy(excl), I)
    np.testing.assert_array_equal(tpos.numpy(), np.asarray(jpos))
    np.testing.assert_array_equal(texcl.numpy(), np.asarray(jexcl))
    jp, tp = jnp.asarray(pred), torch.from_numpy(pred)
    np.testing.assert_allclose(AUC(tpos, tp, texcl).numpy(),
                               np.asarray(jAUC(jpos, jp, jexcl)), rtol=1e-6)
    for tf, jf in [(Recall, jRecall), (NDCG, jNDCG),
                   (Precision, jPrecision)]:
        np.testing.assert_allclose(
            tf(tpos, tp, texcl, at=AT).numpy(),
            np.asarray(jf(jpos, jp, jexcl, at=AT)), rtol=1e-6,
            err_msg=tf.__name__)


@pytest.mark.parametrize("ties", [False, True])
def test_ranking_metrics_equals_the_four_metrics(ties):
    """`ranking_metrics` (one rank pass, what Trainer.evaluate calls) gives
    exactly AUC, Recall, NDCG and Precision called one by one, and JAX's."""
    rng = np.random.default_rng(10)
    B, I = 6, 200
    pred = (rng.integers(-3, 4, size=(B, I)) if ties
            else rng.normal(size=(B, I))).astype(np.float32)
    pos, excl = _eval_ids(11, B, items=I)
    tpos, texcl = ids_to_masks(torch.from_numpy(pos),
                               torch.from_numpy(excl), I)
    jpos, jexcl = j_ids_to_masks(jnp.asarray(pos), jnp.asarray(excl), I)
    tp, jp = torch.from_numpy(pred), jnp.asarray(pred)
    got = ranking_metrics(tpos, tp, texcl, at=AT)
    assert set(got) == {"AUC", "Recall", "NDCG", "Precision"}
    assert torch.equal(got["AUC"], AUC(tpos, tp, texcl))
    np.testing.assert_allclose(got["AUC"].numpy(),
                               np.asarray(jAUC(jpos, jp, jexcl)), rtol=1e-6)
    for tf, jf in [(Recall, jRecall), (NDCG, jNDCG),
                   (Precision, jPrecision)]:
        name = tf.__name__
        assert torch.equal(got[name], tf(tpos, tp, texcl, at=AT)), name
        np.testing.assert_allclose(
            got[name].numpy(), np.asarray(jf(jpos, jp, jexcl, at=AT)),
            rtol=1e-6, err_msg=name)


def test_chunked_metrics_match_dense_padded_table():
    """Chunks not dividing the catalog, and a table with junk rows past
    total_items. Held against the JAX package's DENSE metrics: on these
    inputs its chunked path lets a positive outrank itself (its gathered
    positive score rounds differently from the matmul's), while the port
    reads each positive's score out of the block it is ranked in."""
    rng = np.random.default_rng(2)
    B, I, D = 7, 233, 8
    U = rng.normal(size=(B, D)).astype(np.float32)
    V = rng.normal(size=(I + 23, D)).astype(np.float32)
    b = rng.normal(size=(I + 23,)).astype(np.float32)
    V[I:], b[I:] = 999.0, 999.0
    pos, excl = _eval_ids(5, B, items=I)
    pred = jnp.asarray(U @ V[:I].T + b[None, :I])
    jpos, jexcl = j_ids_to_masks(jnp.asarray(pos), jnp.asarray(excl), I)
    want = {"AUC": jAUC(jpos, pred, jexcl),
            "Recall": jRecall(jpos, pred, jexcl, at=AT),
            "NDCG": jNDCG(jpos, pred, jexcl, at=AT),
            "Precision": jPrecision(jpos, pred, jexcl, at=AT)}
    got = chunked_dot_eval_metrics(torch.from_numpy(U), torch.from_numpy(V),
                                   torch.from_numpy(b), pos, excl,
                                   total_items=I, chunk=64, at=AT)
    for key in want:
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]),
                                   rtol=1e-5, atol=1e-6, err_msg=key)


def _tied_params():
    """BPR parameters whose scores tie exactly: item rows repeat in runs
    of four and one item in five is all zeros with a zero bias, so many
    picks share a score (all-zero rows give +0.0 or -0.0)."""
    p = _jax_params(seed=3)
    base = p["item_embed"][::4].copy()
    p["item_embed"] = np.repeat(base, 4, axis=0)[:ITEMS]
    p["item_bias"] = np.repeat(p["item_bias"][::4], 4, axis=0)[:ITEMS]
    p["item_embed"][::5] = 0.0
    p["item_bias"][::5] = 0.0
    return p


@pytest.mark.parametrize("route", ["key", "float"])
@pytest.mark.parametrize("method", ["exact", "approx", "pallas", "pallas2",
                                    "topk_xla", "topk_approx"])
def test_topk_ties_ordered_as_jax(method, route, monkeypatch):
    """Exact score ties come back lower id first, as lax.top_k orders
    them: the ids equal JAX's one for one, not only up to ties; on both
    routes of `topk_ordered` (the int64 key, the float path)."""
    from openrec_tpu.ops.topk import topk_approx as j_approx, \
        topk_xla as j_xla
    from openrec_tpu_torch.ops import ordered_topk, topk_approx, topk_xla
    if route == "float":
        monkeypatch.setattr(ordered_topk, "SHORT_ROW", 0)
    np_params = _tied_params()
    js, jparams, ts, model = _scorers(np_params, torch.float32)
    k = 60
    users = np.concatenate([USER_IDS, USER_IDS[:4]])
    if method.startswith("topk_"):
        u = np_params["user_embed"][users]
        u[-4:] = 0.0                   # every score ties at zero
        args = (u, np_params["item_embed"], np_params["item_bias"], k)
        jfn, tfn = (j_xla, topk_xla) if method == "topk_xla" \
            else (j_approx, topk_approx)
        want_v, want_i = jfn(*(jnp.asarray(a) for a in args[:3]), k)
        got_v, got_i = tfn(*(torch.as_tensor(a) for a in args[:3]), k)
    else:
        want_v, want_i = js.topk(jparams, users, k=k, method=method,
                                 recall_target=0.99)
        got_v, got_i = ts.topk(model.params(), users, k=k, method=method,
                               recall_target=0.99)
    np.testing.assert_array_equal(got_v.numpy(), np.asarray(want_v))
    np.testing.assert_array_equal(got_i.numpy().astype(np.int64),
                                  np.asarray(want_i).astype(np.int64))


@pytest.mark.parametrize("route", ["key", "float"])
def test_topk_ordered_equals_lax_top_k(route, monkeypatch):
    """Rows with ties inside the top k, ties across the k-th place, +0.0
    against -0.0, NaN and +-inf: values and positions equal
    `lax.top_k`'s bit for bit on both routes."""
    from openrec_tpu_torch.ops import ordered_topk
    if route == "float":
        monkeypatch.setattr(ordered_topk, "SHORT_ROW", 0)
    rng = np.random.default_rng(11)
    n, k = 300, 20
    x = rng.normal(size=(8, n)).astype(np.float32)
    x[1] = np.round(x[1])                    # ties everywhere
    x[2, :] = 0.0
    x[2, ::3] = -0.0                         # zeros of both signs
    x[3, 50] = np.nan
    x[4, [7, 90]] = np.inf
    x[4, 5] = -np.inf
    top = np.sort(x[5])[-k]                  # a tie across the k-th place
    x[5, [3, 250, 299]] = top
    x[6] = np.float32(1.5)                   # every entry equal
    x[7, :40] = np.repeat(x[7, :10], 4)      # runs inside the top k
    want_v, want_i = jax.lax.top_k(jnp.asarray(x), k)
    got_v, got_i = ordered_topk.topk_ordered(torch.as_tensor(x), k)
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
    np.testing.assert_array_equal(got_v.numpy().view(np.int32),
                                  np.asarray(want_v).view(np.int32))
