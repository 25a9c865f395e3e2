"""Plain reference of full-catalog top-k retrieval, and the comparison that
decides a serving run's `correct`.

From the seed's fp32 weights it makes the serve cache again (the tables
rounded to the configuration's serve dtype, the bias kept in fp32),
scores every item for each sampled user in float64 and takes the exact
top k. A served answer is then judged by:

- score_err: the largest gap between a served score and the reference's
  score of the served id, over the largest top-1 score of the sample;
- miss_share: the share of the reference's top-k ids that the answer
  lacks;
- order_errors: rows whose scores are not in descending order, or that
  repeat an id or name one outside the catalog.

Plain PyTorch; it imports nothing of the program.
"""

from __future__ import annotations

import math

import torch

from portbench import weights

BLOCK = 256           # users scored at once: [BLOCK, I] float64


def cast(x: torch.Tensor, dtype: str) -> torch.Tensor:
    """x rounded to `dtype` and back to float32. `float8_e4m3fn` scales
    the tensor so that its largest magnitude is the format's largest
    (448) first, as an fp8 serving path would."""
    if dtype == "float8_e4m3fn":
        scale = x.abs().max().clamp(min=1e-30) / 448.0
        return (x / scale).to(torch.float8_e4m3fn).float() * scale
    return x.to(getattr(torch, dtype)).float()


def tables(cfg: dict, seed: int, device, dtype: str | None = None):
    """(U, V, b): the seed's weights with U and V rounded to `dtype`
    (default: the configuration's serve dtype), all float32."""
    w = weights.bpr_weights(cfg, seed, device)
    dt = dtype or cfg["serve_dtype"]
    return (cast(w["user_embed"], dt), cast(w["item_embed"], dt),
            w["item_bias"].float())


def exact_topk(U, V, b, users, k: int):
    """(scores float64 [B, k], ids [B, k]) of the exact top-k of
    u.V^T + b for rows `users` of U, scored in float64."""
    V64, b64 = V.double(), b.double()
    vals, ids = [], []
    for lo in range(0, len(users), BLOCK):
        u = U[users[lo:lo + BLOCK]].double()
        top = torch.topk(u @ V64.T + b64, k, dim=1)
        vals.append(top.values)
        ids.append(top.indices)
    return torch.cat(vals), torch.cat(ids)


def compare(U, V, b, sample: list, k: int) -> dict:
    """The numbers above over `sample`, a list of (user ids [B], served
    scores [B, k], served ids [B, k]) as numpy arrays."""
    dev = U.device
    I = V.shape[0]
    V64, b64 = V.double(), b.double()
    err = scale = 0.0
    misses = order = users_seen = 0
    for users, vals, ids in sample:
        users = torch.as_tensor(users, device=dev).long()
        vals = torch.as_tensor(vals, device=dev).double()
        ids = torch.as_tensor(ids, device=dev).long()
        for lo in range(0, len(users), BLOCK):
            u = U[users[lo:lo + BLOCK]].double()
            s = u @ V64.T + b64
            ref_v, ref_i = torch.topk(s, k, dim=1)
            got_i = ids[lo:lo + BLOCK]
            got_v = vals[lo:lo + BLOCK]
            inside = (got_i >= 0) & (got_i < I)
            at = s.gather(1, got_i.clamp(0, I - 1))
            gap = float(((got_v - at).abs() * inside).max())
            err = max(err, gap if math.isfinite(gap) else math.inf)
            scale = max(scale, float(ref_v[:, 0].abs().max()))
            hit = (ref_i[:, :, None] == got_i[:, None, :]).any(-1)
            misses += int((~hit).sum())
            srt = got_i.sort(1).values
            bad = ~inside.all(1) | (got_v[:, 1:] > got_v[:, :-1]).any(1) \
                | (srt[:, 1:] == srt[:, :-1]).any(1)
            order += int(bad.sum())
            users_seen += len(u)
    if users_seen == 0:
        return {"users": 0}
    return {"users": users_seen,
            "score_err": err / max(scale, 1e-30),
            "miss_share": misses / (users_seen * k),
            "order_errors": order}


def check(cell: dict, seed: int, run: dict, device) -> dict:
    """The readings of a serving run's sampled answers."""
    cfg, traffic = cell["config"], cell["traffic"]
    U, V, b = tables(cfg, seed, device)
    return compare(U, V, b, run["sample"], int(traffic["k"]))


def control(cell: dict, seed: int, sample: list, device,
            dtype: str = "float8_e4m3fn") -> dict:
    """The control: the reference's exact top-k computed from tables
    rounded to `dtype`, put in the program's place for the same sampled
    requests, judged by `compare` against the configuration's dtype."""
    cfg, k = cell["config"], int(cell["traffic"]["k"])
    U, V, b = tables(cfg, seed, device, dtype)
    served = []
    for users, _, _ in sample:
        users_t = torch.as_tensor(users, device=device).long()
        vals, ids = exact_topk(U, V, b, users_t, k)
        served.append((users, vals.float().cpu().numpy(),
                       ids.cpu().numpy()))
    del U, V, b
    U, V, b = tables(cfg, seed, device)
    return compare(U, V, b, served, k)
