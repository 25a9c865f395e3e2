"""The general traffic generator: requests and training batches from a
traffic file's parameters and the seed.

Serving traffic (`driver: serve`) is a stream of requests of `batch` user
ids: `order: uniform` draws a pool of `pool_requests` requests uniformly
over the users and cycles through it; `order: sweep` walks the user table
in runs of `batch` consecutive ids from a seeded start, wrapping at the
end, so that every user is served once a pass. Training traffic
(`driver: train`) is a pool of `pool_batches` batches of `batch` records,
made on the device and kept in pinned host memory, which a run cycles
through. Ids of every table follow a Zipf law of `zipf_exponent` (rank r
drawn with probability proportional to r**-exponent, mapped through a
seeded permutation of the table's rows; exponent 0 draws uniform ids);
dense features and labels follow `synthetic_criteo`'s law.
"""

from __future__ import annotations

import torch

from portbench.weights import TRAFFIC, generator


def _pin(t: torch.Tensor, pin: bool) -> torch.Tensor:
    return t.pin_memory() if pin else t


class RequestStream:
    """Request j's user ids as an int64 host tensor of `batch` ids (pinned
    where `pin`): `ids(j)`. A sweep writes into a ring of `ring` buffers,
    so a caller keeps at most `ring - 1` requests in flight."""

    def __init__(self, traffic: dict, cfg: dict, seed: int, pin: bool,
                 ring: int = 4):
        self.batch = B = int(traffic["batch"])
        self.users = U = int(cfg["total_users"])
        self.order = traffic["order"]
        gen = generator(seed, TRAFFIC, "cpu")
        if self.order == "uniform":
            R = int(traffic["pool_requests"])
            self.pool = _pin(torch.randint(0, U, (R, B), generator=gen,
                                           dtype=torch.int64), pin)
        elif self.order == "sweep":
            self.start = int(torch.randint(0, U, (1,), generator=gen))
            self.ring = [_pin(torch.empty(B, dtype=torch.int64), pin)
                         for _ in range(ring)]
            self._offsets = torch.arange(B, dtype=torch.int64)
        else:
            raise ValueError(f"unknown request order {self.order!r}")

    def ids(self, j: int) -> torch.Tensor:
        if self.order == "uniform":
            return self.pool[j % self.pool.shape[0]]
        out = self.ring[j % len(self.ring)]
        base = (self.start + j * self.batch) % self.users
        torch.remainder(self._offsets + base, self.users, out=out)
        return out


def zipf_ids(count: int, n: int, exponent: float, gen: torch.Generator,
             device) -> torch.Tensor:
    """n ids in [0, count): rank r (0-based) with probability proportional
    to (r + 1)**-exponent, by inverse transform over the exact CDF, mapped
    through a seeded permutation of the rows."""
    ranks = torch.arange(1, count + 1, dtype=torch.float64, device=device)
    cdf = torch.cumsum(ranks.pow_(-exponent), 0)
    cdf /= cdf[-1].clone()
    u = torch.rand(n, dtype=torch.float64, device=device, generator=gen)
    r = torch.searchsorted(cdf, u).clamp_(max=count - 1)
    del cdf, u
    perm = torch.randperm(count, device=device, generator=gen)
    return perm[r]


def train_pool(traffic: dict, cfg: dict, seed: int, device,
               pin: bool) -> list:
    """`pool_batches` batches {"dense_features" [B, 13] f32,
    "sparse_features" [B, T] int32 (per-table ids), "label" [B] f32} as
    host tensors (pinned where `pin`), made on `device` from the seed.

    Dense features are log(x + 1) of Pareto(2) counts x 100, labels a
    Bernoulli of sigmoid(dense0 - dense1 + [id0 % 7 < 3] - 1.5): the law of
    `synthetic_criteo` (openrec_tpu_torch/data/loaders.py)."""
    gen = generator(seed, TRAFFIC, device)
    P, B = int(traffic["pool_batches"]), int(traffic["batch"])
    n = P * B
    exponent = float(traffic["zipf_exponent"])
    cols = [zipf_ids(int(c), n, exponent, gen, device)
            for c in cfg["ln_emb"]]
    sparse = torch.stack(cols, 1).to(torch.int32)
    del cols
    u = 1.0 - torch.rand((n, cfg["dim_dense"]), device=device,
                         generator=gen)
    dense = torch.log((u.pow(-0.5) - 1.0) * 100.0 + 1.0)
    logits = dense[:, 0] - dense[:, 1] \
        + (sparse[:, 0] % 7 < 3).to(torch.float32)
    label = (torch.rand(n, device=device, generator=gen)
             < torch.sigmoid(logits - 1.5)).to(torch.float32)
    host = {"dense_features": _pin(dense.cpu(), pin),
            "sparse_features": _pin(sparse.cpu(), pin),
            "label": _pin(label.cpu(), pin)}
    return [{key: v[p * B:(p + 1) * B] for key, v in host.items()}
            for p in range(P)]
