"""Weights of the DLRM-DCNv2 configuration, made from the seed on the
device in a few large calls (`weights.py`'s streams and laws).

Both sides take them from here: the program has them copied into its
model, and the reference makes them again from the same seed once the
program's state is freed. Nothing here imports the program.
"""

from __future__ import annotations

import math

import torch

from portbench.weights import WEIGHTS, generator


def glorot(shape, gen, device) -> torch.Tensor:
    lim = math.sqrt(6.0 / (shape[0] + shape[1]))
    return torch.empty(shape, device=device).uniform_(-lim, lim,
                                                      generator=gen)


def dcn_weights(cfg: dict, seed: int, device) -> dict:
    """{"embed_fused" [sum(ln_emb), m_spa], "mlp_bot/{i}/w" [in, out],
    "mlp_bot/{i}/b", "mlp_top/{i}/w", "mlp_top/{i}/b", "cross/{l}/v"
    [d, r], "cross/{l}/w" [r, d], "cross/{l}/b" [d]}, fp32: one uniform
    call for the 26 stacked tables, a glorot-uniform call per kernel,
    zero biases; d = (tables + 1) * m_spa."""
    gen = generator(seed, WEIGHTS, device)
    m = cfg["m_spa"]
    s = cfg["weights"]["embed_scale"]
    out = {"embed_fused": torch.empty(
        (int(sum(cfg["ln_emb"])), m), device=device).uniform_(
            -s, s, generator=gen)}
    d = (len(cfg["ln_emb"]) + 1) * m
    for name, dims in (("mlp_bot", [cfg["dim_dense"], *cfg["ln_bot"]]),
                       ("mlp_top", [d, *cfg["ln_top"]])):
        for i, (a, b) in enumerate(zip(dims[:-1], dims[1:])):
            out[f"{name}/{i}/w"] = glorot((a, b), gen, device)
            out[f"{name}/{i}/b"] = torch.zeros(b, device=device)
    r = cfg["dcn_rank"]
    for i in range(cfg["dcn_layers"]):
        out[f"cross/{i}/v"] = glorot((d, r), gen, device)
        out[f"cross/{i}/w"] = glorot((r, d), gen, device)
        out[f"cross/{i}/b"] = torch.zeros(d, device=device)
    return out
