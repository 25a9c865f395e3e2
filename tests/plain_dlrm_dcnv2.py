"""Plain reference of DLRM-DCNv2, the model of MLPerf Training's
recommendation benchmark (mlcommons/training, recommendation_v2/
torchrec_dlrm, `dlrm_main.py` with `--interaction_type dcn`), for the
port's tests. Plain `torch` operations in float32 with TF32 off; it
imports nothing of the port and keeps no cache and no dedup.

The model, over parameters named as the port names them:
- the T tables stacked at their offsets in `embed_fused`; example b's
  bag of table t is its columns of that table (columns grouped by table in
  table order), each id offset by the table's first row, and the bag's
  rows are summed;
- the dense arch `mlp_bot/{i}` (x @ w + b, ReLU on every layer);
- x0 = [dense vector, the T pooled vectors], (T + 1) * m wide, and the
  low-rank cross network (DCN-V2, arXiv:2008.13535, section 3; TorchRec's
  `LowRankCrossNet`): x_{l+1} = x0 * ((x_l @ v_l) @ w_l + b_l) + x_l;
- the over arch `mlp_top/{i}` (ReLU between, the last layer a logit);
- a sigmoid, then the binary cross-entropy of the batch mean on the
  probability clipped to [1e-7, 1 - 1e-7];
- autograd gradients; Adam in the keras form on the table rows the batch
  touches (bias correction folded into the step size, eps outside the
  square root, the other rows and their moments untouched) and in the
  optax form on every other leaf.

Departures from the MLPerf reference, which the port shares:
- Adam (lr 1e-3, b1 0.9, b2 0.999, eps 1e-7), where the reference
  trains with Adagrad;
- a sigmoid and a clipped BCE on probabilities, where the reference uses
  BCE-with-logits;
- the port's initialisation (uniform(-0.05, 0.05) tables,
  glorot-uniform kernels, zero biases), where TorchRec draws its own;
  the tests load seeded random weights into both sides anyway;
- weights stored [in, out] (x @ w), TorchRec's nn.Linear [out, in]
  transposed; the function is the same.

`cross_precision` ('fp32', 'tf32' or 'bf16') computes the cross layers
one precision lower for the tests' controls: 'tf32' rounds both operands
of each product to TF32's 10-bit mantissa and adds in fp32, as the
card's TF32 tensor cores do; 'bf16' runs the layers in bfloat16.
"""

from __future__ import annotations

import torch


def _tf32(x: torch.Tensor) -> torch.Tensor:
    """x rounded to 10 mantissa bits, ties to even (TF32's operands); the
    gradient passes through as it is."""
    bits = x.detach().contiguous().view(torch.int32)
    keep = (bits >> 13) & 1
    rounded = ((bits + 0x0FFF + keep) & ~0x1FFF).view(torch.float32)
    return x + (rounded - x.detach())


def _cross(x0, p, layers, precision):
    if precision == "bf16":
        x0 = x0.to(torch.bfloat16)
    x = x0
    for i in range(layers):
        v, w, b = (p[f"cross/{i}/{k}"] for k in "vwb")
        if precision == "bf16":
            v, w, b = (t.to(torch.bfloat16) for t in (v, w, b))
            h = (x @ v) @ w
        elif precision == "tf32":
            h = _tf32(_tf32(x) @ _tf32(v)) @ _tf32(w)
        else:
            h = (x @ v) @ w
        x = x0 * (h + b) + x
    return x.to(torch.float32)


def pooled(cfg: dict, table: torch.Tensor, sparse: torch.Tensor):
    """[B, T, m]: each table's bag of rows summed."""
    offsets = [0]
    for c in cfg["ln_emb"][:-1]:
        offsets.append(offsets[-1] + int(c))
    out, start = [], 0
    for t, n in enumerate(cfg["multi_hot"]):
        ids = sparse[:, start:start + n].long() + offsets[t]
        out.append(table[ids].sum(dim=1))
        start += n
    return torch.stack(out, dim=1)


def forward(cfg: dict, p: dict, batch: dict, cross_precision="fp32"):
    """(logits [B], probabilities [B]) of `batch`."""
    sparse = torch.as_tensor(batch["sparse_features"])
    x = torch.as_tensor(batch["dense_features"], dtype=torch.float32)
    for i in range(len(cfg["ln_bot"])):
        x = torch.relu(x @ p[f"mlp_bot/{i}/w"] + p[f"mlp_bot/{i}/b"])
    emb = pooled(cfg, p["embed_fused"], sparse)
    x0 = torch.cat([x, emb.reshape(emb.shape[0], -1)], dim=1)
    z = _cross(x0, p, cfg["dcn_layers"], cross_precision)
    n_top = len(cfg["ln_top"])
    for i in range(n_top):
        z = z @ p[f"mlp_top/{i}/w"] + p[f"mlp_top/{i}/b"]
        if i < n_top - 1:
            z = torch.relu(z)
    logit = z.reshape(-1)
    return logit, torch.sigmoid(logit)


def loss(cfg: dict, p: dict, batch: dict, cross_precision="fp32"):
    prob = forward(cfg, p, batch, cross_precision)[1]
    prob = prob.clamp(1e-7, 1.0 - 1e-7)
    y = torch.as_tensor(batch["label"], dtype=torch.float32)
    return -torch.mean(y * torch.log(prob) + (1.0 - y) * torch.log(1.0 - prob))


def _no_tf32():
    prev = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return prev


def _restore(prev):
    (torch.backends.cuda.matmul.allow_tf32,
     torch.backends.cudnn.allow_tf32) = prev


def loss_and_grads(cfg: dict, p: dict, batch: dict, cross_precision="fp32"):
    """(loss, {leaf: gradient}) by autograd, the table's gradient whole."""
    prev = _no_tf32()
    try:
        leaves = {n: v.detach().clone().requires_grad_()
                  for n, v in p.items()}
        value = loss(cfg, leaves, batch, cross_precision)
        g = torch.autograd.grad(value, list(leaves.values()))
        return value.detach(), dict(zip(leaves, g))
    finally:
        _restore(prev)


def touched_rows(cfg: dict, batch: dict) -> torch.Tensor:
    """[rows] bool: the table rows the batch looks up."""
    sparse = torch.as_tensor(batch["sparse_features"]).long()
    offsets, start, cols = [0], 0, []
    for c in cfg["ln_emb"][:-1]:
        offsets.append(offsets[-1] + int(c))
    for t, n in enumerate(cfg["multi_hot"]):
        cols += [offsets[t]] * n
    ids = (sparse + torch.tensor(cols)).reshape(-1)
    out = torch.zeros(sum(int(c) for c in cfg["ln_emb"]), dtype=torch.bool)
    out[ids] = True
    return out


def adam_steps(cfg: dict, p: dict, batches: list, lr=1e-3, b1=0.9,
               b2=0.999, eps=1e-7) -> list:
    """Train `p` (modified in place) on `batches` from zero moments: the
    losses."""
    mu = {n: torch.zeros_like(v) for n, v in p.items()}
    nu = {n: torch.zeros_like(v) for n, v in p.items()}
    losses = []
    for t, batch in enumerate(batches, start=1):
        value, g = loss_and_grads(cfg, p, batch)
        losses.append(float(value))
        c1, c2 = 1.0 - b1 ** t, 1.0 - b2 ** t
        with torch.no_grad():
            rows = touched_rows(cfg, batch)
            alpha = lr * torch.sqrt(torch.tensor(c2)) / c1
            gt = g["embed_fused"][rows]
            m = b1 * mu["embed_fused"][rows] + (1.0 - b1) * gt
            v = b2 * nu["embed_fused"][rows] + (1.0 - b2) * gt * gt
            p["embed_fused"][rows] += -alpha * m / (torch.sqrt(v) + eps)
            mu["embed_fused"][rows], nu["embed_fused"][rows] = m, v
            for n, gd in g.items():
                if n == "embed_fused":
                    continue
                mu[n] = (1.0 - b1) * gd + b1 * mu[n]
                nu[n] = (1.0 - b2) * gd * gd + b2 * nu[n]
                p[n] -= lr * ((mu[n] / c1) / (torch.sqrt(nu[n] / c2) + eps))
    return losses
