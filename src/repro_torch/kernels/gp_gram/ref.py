"""Plain-torch Matérn-5/2: the oracle of the CUDA kernel and the GP's
differentiable path (mirrors ``gp.matern52`` of the JAX reference)."""

from __future__ import annotations

import math

import torch

SQRT5 = math.sqrt(5.0)


def sqdist(xa, xb, inv_ls):
    """Scaled squared distance: xa [n,d], xb [m,d], inv_ls [d] -> [n,m]."""
    a = xa * inv_ls
    b = xb * inv_ls
    a2 = torch.sum(a * a, dim=1)[:, None]
    b2 = torch.sum(b * b, dim=1)[None, :]
    return torch.clamp_min(a2 + b2 - 2.0 * (a @ b.T), 0.0)


def matern52(xa, xb, lengthscale, signal_var):
    """Matérn-5/2 with the double-``where`` sqrt guard: d/dr sqrt(r)|₀ is
    ∞, and zero distances (diagonal) would otherwise poison the
    marginal-likelihood gradients with NaN."""
    d2 = sqdist(xa, xb, 1.0 / lengthscale)
    pos = d2 > 1e-12
    safe = torch.where(pos, d2, torch.ones_like(d2))
    r = torch.where(pos, torch.sqrt(safe), torch.zeros_like(d2))
    s = SQRT5 * r
    return signal_var * (1.0 + s + s * s / 3.0) * torch.exp(-s)


def matern52_gram_ref(x, lengthscale, signal_var):
    return matern52(x, x, lengthscale, signal_var)


def matern52_cross_ref(xa, xb, lengthscale, signal_var):
    return matern52(xa, xb, lengthscale, signal_var)
