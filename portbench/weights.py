"""Weights made from the seed, on the device, in a few large calls.

Both sides take them from here: the program has them copied into its
model, and the reference makes them again from the same seed once the
program's state is freed. The names are the configuration's parameters
("/"-paths). Nothing here imports the program.
"""

from __future__ import annotations

import math

import numpy as np
import torch

WEIGHTS, TRAFFIC, SAMPLE = 0, 1, 2      # independent streams of one seed


def stream_seed(seed: int, stream: int) -> int:
    """A 63-bit seed for one stream of a run's `--seed` (any integer)."""
    state = np.random.SeedSequence([int(seed) % 2 ** 64, stream]) \
        .generate_state(2, np.uint32)
    return (int(state[0]) << 31) ^ int(state[1])


def generator(seed: int, stream: int, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(
        stream_seed(seed, stream))


def bpr_weights(cfg: dict, seed: int, device) -> dict:
    """{"user_embed" [U, D], "item_embed" [I, D], "item_bias" [I]}, fp32:
    uniform(-embed_scale, embed_scale) tables and a uniform(-bias_scale,
    bias_scale) bias."""
    gen = generator(seed, WEIGHTS, device)
    w = cfg["weights"]
    U, I, D = cfg["total_users"], cfg["total_items"], cfg["dim"]
    out = {}
    for name, shape, scale in (("user_embed", (U, D), w["embed_scale"]),
                               ("item_embed", (I, D), w["embed_scale"]),
                               ("item_bias", (I,), w["bias_scale"])):
        out[name] = torch.empty(shape, device=device).uniform_(
            -scale, scale, generator=gen)
    return out


def dlrm_weights(cfg: dict, seed: int, device) -> dict:
    """{"embed_fused" [sum(ln_emb), m_spa], "mlp_bot/{i}/w" [in, out],
    "mlp_bot/{i}/b", "mlp_top/{i}/w", "mlp_top/{i}/b"}, fp32: one uniform
    call for all 26 stacked tables, a glorot-uniform call per kernel, zero
    biases."""
    gen = generator(seed, WEIGHTS, device)
    rows = int(sum(cfg["ln_emb"]))
    s = cfg["weights"]["embed_scale"]
    out = {"embed_fused": torch.empty(
        (rows, cfg["m_spa"]), device=device).uniform_(-s, s, generator=gen)}
    F = len(cfg["ln_emb"]) + 1
    top_in = cfg["ln_bot"][-1] + F * (F - 1) // 2
    for name, dims in (("mlp_bot", [cfg["dim_dense"], *cfg["ln_bot"]]),
                       ("mlp_top", [top_in, *cfg["ln_top"]])):
        for i, (a, b) in enumerate(zip(dims[:-1], dims[1:])):
            lim = math.sqrt(6.0 / (a + b))
            out[f"{name}/{i}/w"] = torch.empty(
                (a, b), device=device).uniform_(-lim, lim, generator=gen)
            out[f"{name}/{i}/b"] = torch.zeros(b, device=device)
    return out

