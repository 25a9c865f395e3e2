"""Plain reference of DLRM training, and the comparison that decides a
training run's `correct`.

It trains the configuration's model (dot interaction, binary
cross-entropy, fp32) in plain PyTorch with TF32 off: the 26 tables stacked
at their offsets; a batch's unique rows gathered as a leaf; the bottom MLP
(ReLU throughout), the dot interaction over the sparse vectors followed by
the dense one (the upper triangle of their Gram matrix, row-major, without
the diagonal), the top MLP (ReLU, then a sigmoid) and the binary
cross-entropy on probabilities clipped to [1e-7, 1 - 1e-7]; autograd; Adam
in the keras form on the unique rows (bias correction folded into the
step, eps outside the square root) and in the optax form on the MLPs. It
imports nothing of the program.

It follows the run twice: from the seed's weights over the run's first
batches, and from the copy of the program's state taken after the window
(parameters and both Adams' moments, at the step count the harness
counted) over the batches that came next. The numbers compared, each
against the run's readings of the program (`steady_` for the second):

- loss_gap: the largest relative gap of a step's loss;
- grad_gap: over the leaves, the largest gap between the norms of the
  first step's gradient, over the larger of that leaf's reference norm
  and the median leaf's;
- change_gap: the same for each leaf's change over the steps, among the
  leaves whose reference gradient is at least a thousandth of the median
  leaf's (a leaf below that moves by round-off alone);
- rows_gap: the relative gap in the number of table rows that changed;
- nonfinite: losses of the program that are not finite.
"""

from __future__ import annotations

import math
import statistics

import torch

from portbench import weights

QUIET = 1e-3      # a leaf whose gradient is under this share of the median


def forward(cfg: dict, p: dict, rows, inv, batch: dict):
    """The loss of `batch` with the table rows `rows[inv]`."""
    B, T = batch["sparse_features"].shape
    emb = rows[inv].reshape(B, T, cfg["m_spa"])
    x = batch["dense_features"]
    for i in range(len(cfg["ln_bot"])):
        x = torch.relu(x @ p[f"mlp_bot/{i}/w"] + p[f"mlp_bot/{i}/b"])
    feats = torch.cat([emb, x[:, None, :]], dim=1)
    F = feats.shape[1]
    gram = feats @ feats.transpose(1, 2)
    iu = torch.triu_indices(F, F, offset=1, device=gram.device)
    z = torch.cat([x, gram[:, iu[0], iu[1]]], dim=1)
    n_top = len(cfg["ln_top"])
    for i in range(n_top):
        z = z @ p[f"mlp_top/{i}/w"] + p[f"mlp_top/{i}/b"]
        z = torch.sigmoid(z) if i == n_top - 1 else torch.relu(z)
    prob = z.reshape(-1).clamp(1e-7, 1.0 - 1e-7)
    y = batch["label"]
    return -torch.mean(y * torch.log(prob) + (1.0 - y) * torch.log(1.0 - prob))


def supported(cfg: dict) -> None:
    """Raises unless the configuration is the model this reference
    trains."""
    for key, want in (("interaction", "dot"), ("loss", "bce"),
                      ("dtype", "float32")):
        if cfg[key] != want:
            raise ValueError(f"the reference trains {key} {want!r}, the "
                             f"configuration states {cfg[key]!r}")


def train_steps(cfg: dict, w: dict, batches: list, device,
                moments: dict | None = None, count: int = 0) -> dict:
    """Train from weights `w` (modified in place) on `batches` (host
    tensors), from Adam's `moments` ({"mu", "nu"} by leaf, modified in
    place; None: zero) after `count` steps: {"losses", "grads" (first
    step, by leaf), "change" (by leaf, after the last step),
    "changed_rows"}."""
    supported(cfg)
    prev = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        return _train_steps(cfg, w, batches, device, moments, count)
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = prev


def _train_steps(cfg, w, batches, device, moments, count):
    opt = cfg["optimizer"]
    lr, b1, b2 = opt["lr"], opt["b1"], opt["b2"]
    table = w["embed_fused"]
    dense = {n: v for n, v in w.items() if n != "embed_fused"}
    start = {n: v.clone() for n, v in w.items()}
    if moments is None:
        moments = {key: {n: torch.zeros_like(v) for n, v in w.items()}
                   for key in ("mu", "nu")}
    t_mu, t_nu = moments["mu"]["embed_fused"], moments["nu"]["embed_fused"]
    d_mu = {n: moments["mu"][n] for n in dense}
    d_nu = {n: moments["nu"][n] for n in dense}
    offsets = torch.tensor([0, *cfg["ln_emb"][:-1]], device=device) \
        .cumsum(0)
    losses, grads = [], None
    for t, hb in enumerate(batches, start=1):
        batch = {k: v.to(device) for k, v in hb.items()}
        ids = (batch["sparse_features"].long() + offsets).reshape(-1)
        uniq, inv = torch.unique(ids, return_inverse=True)
        rows = table[uniq].requires_grad_()
        leaves = {n: v.detach().requires_grad_() for n, v in dense.items()}
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
            mu = b1 * t_mu[uniq] + (1.0 - b1) * g_rows
            nu = b2 * t_nu[uniq] + (1.0 - b2) * g_rows * g_rows
            table[uniq] += -alpha * mu / (torch.sqrt(nu) + opt["eps"])
            t_mu[uniq], t_nu[uniq] = mu, nu
            c1, c2 = 1.0 - b1 ** c, 1.0 - b2 ** c
            for n, gd in g_dense.items():
                d_mu[n] = (1.0 - b1) * gd + b1 * d_mu[n]
                d_nu[n] = (1.0 - b2) * gd * gd + b2 * d_nu[n]
                dense[n] -= lr * ((d_mu[n] / c1)
                                  / (torch.sqrt(d_nu[n] / c2) + opt["eps"]))
    with torch.no_grad():
        change = {n: float((w[n] - start[n]).norm()) for n in w}
        changed = int((table != start["embed_fused"]).any(1).sum())
    return {"losses": losses, "grads": grads, "change": change,
            "changed_rows": changed}


def _leaf_gap(prog: dict, ref: dict, floor: float, leaves) -> float:
    worst = 0.0
    for n in leaves:
        gap = abs(prog[n] - ref[n]) / max(ref[n], floor)
        worst = max(worst, gap if math.isfinite(gap) else math.inf)
    return worst


def compare(program: dict, ref: dict) -> dict:
    """The numbers above: `program` is the driver's readings of the port,
    `ref` what `train_steps` returns."""
    losses = program["losses"] + [program.get("last_loss", 0.0)]
    med = statistics.median(ref["grads"].values())
    moving = [n for n, v in ref["grads"].items() if v >= QUIET * med]
    gaps = [abs(a - b) / abs(b) for a, b in
            zip(program["losses"], ref["losses"])]
    loss_gap = max(gaps) if all(map(math.isfinite, gaps)) else math.inf
    change_med = statistics.median(ref["change"][n] for n in moving)
    return {
        "loss_gap": loss_gap,
        "grad_gap": _leaf_gap(program["grads"], ref["grads"], med,
                              ref["grads"]),
        "change_gap": _leaf_gap(program["change"], ref["change"],
                                change_med, moving),
        "rows_gap": abs(program["changed_rows"] - ref["changed_rows"])
        / ref["changed_rows"],
        "nonfinite": sum(not math.isfinite(v) for v in losses),
        "loss_gap_by_step": gaps,
        "quiet_leaves": sorted(set(ref["grads"]) - set(moving)),
    }


def check(cell: dict, seed: int, run: dict, device) -> dict:
    """The readings of a training run: its first steps, and the steps
    that followed the copy of its state after the window."""
    cfg = cell["config"]
    w = weights.dlrm_weights(cfg, seed, device)
    ref = train_steps(cfg, w, run["check_batches"], device)
    del w
    out = compare(run["program"], ref)
    start = run["steady_start"]
    ref = train_steps(cfg, start["params"], run["steady_batches"], device,
                      start, run["steady_count"])
    del start
    steady = compare(run["steady"], ref)
    out["nonfinite"] += steady.pop("nonfinite")
    out.update({f"steady_{k}": v for k, v in steady.items()})
    return out
