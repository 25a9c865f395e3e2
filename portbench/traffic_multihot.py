"""Training batches of multi-hot bags from a traffic file's parameters
and the seed, for `drivers/train_multihot.py`.

A pool of `pool_batches` batches of `batch` records, made on the device
and kept in pinned host memory, which a run cycles through. Table t's bag
holds `multi_hot[t]` ids, its columns grouped by table in table order.
A bag's first id follows `traffic.zipf_ids` (Zipf of `zipf_exponent`
over the table's rows through a seeded permutation); each other id is a
fixed function of (table, position, first id): a hash of the first id
with a seeded salt of the (table, position), spread uniformly over the
table's rows. Dense features and labels follow `synthetic_criteo`'s law,
as `traffic.train_pool` draws them.
"""

from __future__ import annotations

import torch

from portbench.traffic import zipf_ids
from portbench.weights import TRAFFIC, generator


def spread(first: torch.Tensor, salt: int, count: int) -> torch.Tensor:
    """ids in [0, count): a 32-bit mix of first + salt (int64 arithmetic,
    every product under 2**63), scaled to the table."""
    x = (first + salt) & 0x7FFFFFFF
    x = (x * 0x5BD1E995) & 0xFFFFFFFF
    x = x ^ (x >> 15)
    x = (x * 0x27D4EB2D) & 0xFFFFFFFF
    x = x ^ (x >> 13)
    return (x * count) >> 32


def multihot_ids(cfg: dict, n: int, exponent: float, gen, device):
    """[n, sum(multi_hot)] int32 ids, per-table (not offset)."""
    cols = []
    for count, size in zip(cfg["ln_emb"], cfg["multi_hot"]):
        count = int(count)
        first = zipf_ids(count, n, exponent, gen, device)
        salts = torch.randint(0, 2 ** 31 - 1, (size - 1,), generator=gen,
                              device=device).tolist()
        cols.append(first)
        cols += [spread(first, s, count) for s in salts]
    return torch.stack(cols, 1).to(torch.int32)


def train_pool(traffic: dict, cfg: dict, seed: int, device,
               pin: bool) -> list:
    """`pool_batches` batches {"dense_features" [B, 13] f32,
    "sparse_features" [B, sum(multi_hot)] int32, "label" [B] f32} as host
    tensors (pinned where `pin`), made on `device` from the seed."""
    gen = generator(seed, TRAFFIC, device)
    P, B = int(traffic["pool_batches"]), int(traffic["batch"])
    n = P * B
    sparse = multihot_ids(cfg, n, float(traffic["zipf_exponent"]), gen,
                          device)
    u = 1.0 - torch.rand((n, cfg["dim_dense"]), device=device,
                         generator=gen)
    dense = torch.log((u.pow(-0.5) - 1.0) * 100.0 + 1.0)
    logits = dense[:, 0] - dense[:, 1] \
        + (sparse[:, 0] % 7 < 3).to(torch.float32)
    label = (torch.rand(n, device=device, generator=gen)
             < torch.sigmoid(logits - 1.5)).to(torch.float32)
    host = {}
    for key, v in (("dense_features", dense), ("sparse_features", sparse),
                   ("label", label)):
        v = v.cpu()
        host[key] = v.pin_memory() if pin else v
    return [{key: v[p * B:(p + 1) * B] for key, v in host.items()}
            for p in range(P)]
