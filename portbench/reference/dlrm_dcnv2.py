"""Plain reference of DLRM-DCNv2 training, and the comparison that decides
the multi-hot cell's `correct`.

It trains the configuration's model in plain PyTorch, fp32 with TF32 off,
and imports nothing of the program:
- the 26 tables stacked at their offsets; example b's bag of table t is
  its columns of that table (grouped by table in table order), each id
  offset by the table's first row; a batch's distinct rows are gathered
  as a leaf and each bag's rows summed;
- the dense arch (ReLU on every layer); x0 = [dense vector, the 26 pooled
  vectors], 27 * 128 wide; the low-rank cross network (DCN-V2,
  arXiv:2008.13535, section 3; TorchRec's LowRankCrossNet):
  x_{l+1} = x0 * ((x_l @ v_l) @ w_l + b_l) + x_l;
- the over arch (ReLU between, then a sigmoid) and the binary
  cross-entropy on probabilities clipped to [1e-7, 1 - 1e-7];
- autograd; Adam in the keras form on the batch's distinct rows (bias
  correction folded into the step, eps outside the square root) and in
  the optax form on every other leaf.

Departures from the MLPerf reference (mlcommons/training,
recommendation_v2/torchrec_dlrm), which the program shares: Adam where it
trains with Adagrad; a sigmoid and a clipped BCE where it uses
BCE-with-logits; the port's initialisation; weights stored [in, out].

The table is 13.57 GB, so the reference holds only the rows the followed
steps touch: from the seed's weights it makes the whole table once,
takes the rows of the check batches and frees the rest; after the window
`drivers/train_multihot.py` hands it the same rows of the program's
state, with their moments. Rows no batch touches cannot change in the
reference; the program's side counts its changed rows over the whole
table. The numbers
compared are `reference/dlrm.py`'s (`compare`): loss_gap, grad_gap,
change_gap, rows_gap and nonfinite, each again as `steady_`.
"""

from __future__ import annotations

import torch

from portbench import weights_dcn
from portbench.reference.dlrm import compare


def supported(cfg: dict) -> None:
    for key, want in (("interaction", "dcn"), ("loss", "bce"),
                      ("dtype", "float32")):
        if cfg[key] != want:
            raise ValueError(f"the reference trains {key} {want!r}, the "
                             f"configuration states {cfg[key]!r}")


def column_offsets(cfg: dict, device) -> torch.Tensor:
    """Each id column's table offset: [sum(multi_hot)] int64."""
    counts = torch.tensor([0, *cfg["ln_emb"][:-1]], dtype=torch.int64,
                          device=device).cumsum(0)
    sizes = torch.tensor(cfg["multi_hot"], device=device)
    return counts.repeat_interleave(sizes)


def batch_rows(cfg: dict, batches: list, device) -> torch.Tensor:
    """The sorted distinct table rows that (host) `batches` look up."""
    cols = column_offsets(cfg, device)
    ids = [(b["sparse_features"].to(device).long() + cols).reshape(-1)
           for b in batches]
    return torch.unique(torch.cat(ids))


def forward(cfg: dict, p: dict, rows, inv, batch: dict):
    """The loss of `batch` whose lookups read `rows[inv]`."""
    B, C = batch["sparse_features"].shape
    m = cfg["m_spa"]
    emb = rows[inv].reshape(B, C, m)
    pooled, start = [], 0
    for n in cfg["multi_hot"]:
        pooled.append(emb[:, start:start + n].sum(dim=1))
        start += n
    x = batch["dense_features"]
    for i in range(len(cfg["ln_bot"])):
        x = torch.relu(x @ p[f"mlp_bot/{i}/w"] + p[f"mlp_bot/{i}/b"])
    x0 = torch.cat([x, *pooled], dim=1)
    z = x0
    for i in range(cfg["dcn_layers"]):
        z = x0 * ((z @ p[f"cross/{i}/v"]) @ p[f"cross/{i}/w"]
                  + p[f"cross/{i}/b"]) + z
    n_top = len(cfg["ln_top"])
    for i in range(n_top):
        z = z @ p[f"mlp_top/{i}/w"] + p[f"mlp_top/{i}/b"]
        z = torch.sigmoid(z) if i == n_top - 1 else torch.relu(z)
    prob = z.reshape(-1).clamp(1e-7, 1.0 - 1e-7)
    y = batch["label"]
    return -torch.mean(y * torch.log(prob) + (1.0 - y) * torch.log(1.0 - prob))


def train_steps(cfg: dict, state: dict, batches: list, device,
                count: int = 0) -> dict:
    """Train from `state` = {"rows" (sorted distinct table rows, which
    hold every id of `batches`), "params" (by leaf; "embed_fused" holds
    those rows only), "mu", "nu" (likewise; None: zero)}, modified in
    place, on `batches` (host tensors) after `count` steps: {"losses",
    "grads" (first step, by leaf), "change" (by leaf), "changed_rows"}."""
    supported(cfg)
    prev = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        return _train_steps(cfg, state, batches, device, count)
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = prev


def _train_steps(cfg, state, batches, device, count):
    opt = cfg["optimizer"]
    lr, b1, b2 = opt["lr"], opt["b1"], opt["b2"]
    w = state["params"]
    if state.get("mu") is None:
        state["mu"] = {n: torch.zeros_like(v) for n, v in w.items()}
        state["nu"] = {n: torch.zeros_like(v) for n, v in w.items()}
    mu, nu = state["mu"], state["nu"]
    table = w["embed_fused"]
    dense = [n for n in w if n != "embed_fused"]
    start = {n: v.clone() for n, v in w.items()}
    cols = column_offsets(cfg, device)
    losses, grads = [], None
    for t, hb in enumerate(batches, start=1):
        batch = {k: v.to(device) for k, v in hb.items()}
        ids = (batch["sparse_features"].long() + cols).reshape(-1)
        local = torch.searchsorted(state["rows"], ids)
        uniq, inv = torch.unique(local, return_inverse=True)
        rows = table[uniq].requires_grad_()
        leaves = {n: w[n].detach().requires_grad_() for n in dense}
        loss = forward(cfg, leaves, rows, inv, batch)
        g = torch.autograd.grad(loss, [rows, *leaves.values()])
        g_rows, g_dense = g[0], dict(zip(leaves, g[1:]))
        losses.append(float(loss.detach()))
        if t == 1:
            grads = {"embed_fused": float(g_rows.norm())}
            grads.update({n: float(v.norm()) for n, v in g_dense.items()})
        with torch.no_grad():
            c = torch.tensor(float(count + t), device=device)
            alpha = lr * torch.sqrt(1.0 - b2 ** c) / (1.0 - b1 ** c)
            m_rows = b1 * mu["embed_fused"][uniq] + (1.0 - b1) * g_rows
            v_rows = b2 * nu["embed_fused"][uniq] \
                + (1.0 - b2) * g_rows * g_rows
            table[uniq] += -alpha * m_rows / (torch.sqrt(v_rows) + opt["eps"])
            mu["embed_fused"][uniq], nu["embed_fused"][uniq] = m_rows, v_rows
            c1, c2 = 1.0 - b1 ** c, 1.0 - b2 ** c
            for n, gd in g_dense.items():
                mu[n] = (1.0 - b1) * gd + b1 * mu[n]
                nu[n] = (1.0 - b2) * gd * gd + b2 * nu[n]
                w[n] -= lr * ((mu[n] / c1)
                              / (torch.sqrt(nu[n] / c2) + opt["eps"]))
    with torch.no_grad():
        change = {n: float((w[n] - start[n]).norm()) for n in w}
        changed = int((table != start["embed_fused"]).any(1).sum())
    return {"losses": losses, "grads": grads, "change": change,
            "changed_rows": changed}


def seed_state(cfg: dict, seed: int, batches: list, device) -> dict:
    """The seed's weights, the table cut to the rows `batches` look up."""
    w = weights_dcn.dcn_weights(cfg, seed, device)
    rows = batch_rows(cfg, batches, device)
    w["embed_fused"] = w["embed_fused"][rows]
    return {"rows": rows, "params": w, "mu": None, "nu": None}


def check(cell: dict, seed: int, run: dict, device) -> dict:
    """The readings of a training run: its first steps, and the steps
    that followed the copy of its state after the window."""
    cfg = cell["config"]
    state = seed_state(cfg, seed, run["check_batches"], device)
    ref = train_steps(cfg, state, run["check_batches"], device)
    del state
    out = compare(run["program"], ref)
    ref = train_steps(cfg, run["steady_start"], run["steady_batches"],
                      device, run["steady_count"])
    steady = compare(run["steady"], ref)
    out["nonfinite"] += steady.pop("nonfinite")
    out.update({f"steady_{k}": v for k, v in steady.items()})
    return out
