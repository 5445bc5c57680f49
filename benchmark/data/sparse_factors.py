"""Bulk expression data from sparse nonnegative factors, with noise at the
model's default uncertainty.

    mu = A P^T,  D = max(mu + max(0.1 mu, 0.1) N(0, 1), 0)

A (genes x k) and P (samples x k) hold Gamma(2, 1) entries, each kept
with probability `a_density` / `p_density` and 0 otherwise; A is scaled
so that the mean of mu is `data_mean`. The noise's standard deviation is
the dense model's default uncertainty S = max(0.1 D, 0.1) taken at mu,
so the truth's chi^2 is about one an entry. Drawn on the device in a few
large calls; Gamma(2, 1) is the sum of two Exp(1) draws, -log(u1 u2)."""

from __future__ import annotations

import numpy as np
import torch


def gamma2(gen: torch.Generator, shape, device) -> torch.Tensor:
    u = torch.rand((2,) + tuple(shape), generator=gen, device=device,
                   dtype=torch.float64)
    # 1 - u lies in (0, 1]: log never sees 0
    return -torch.log1p(-u).sum(dim=0)


def kept(gen: torch.Generator, shape, density: float, device):
    return (torch.rand(tuple(shape), generator=gen, device=device,
                       dtype=torch.float64) < density).to(torch.float64)


def generate(config: dict, seed: int, device) -> np.ndarray:
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    G, S, k = config["n_genes"], config["n_samples"], config["n_patterns"]
    a_d, p_d = config["a_density"], config["p_density"]
    A = gamma2(gen, (G, k), device) * kept(gen, (G, k), a_d, device)
    P = gamma2(gen, (S, k), device) * kept(gen, (S, k), p_d, device)
    # E[mu] = k (2 a_d)(2 p_d) before the scale
    A *= config["data_mean"] / (4.0 * k * a_d * p_d)
    mu = A @ P.T
    sd = torch.clamp(0.1 * mu, min=0.1)
    noise = torch.randn((G, S), generator=gen, device=device,
                        dtype=torch.float64) * sd
    D = torch.clamp(mu + noise, min=0.0).to(torch.float32)
    return D.cpu().numpy()
