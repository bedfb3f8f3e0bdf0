"""Plain-torch Matérn-5/2 and its backward: the oracles of the CUDA
kernels, and the GP's differentiable path on the host (``matern52`` is
``gp.matern52`` of the JAX reference).

Up to ``EXPANDED_MAX_D`` features r² is the reference's expansion
|a|² + |b|² − 2a·b.  Beyond it r² is summed over direct differences, as
the CUDA kernels sum it there (``kExpandedMaxD``): the expansion's float32
cancellation grows with the norms, and at the tuning daemon's 327
features (norms ~1200 at lengthscale 0.3) it is ~1e-3 of r² near r = 0,
between duplicated rows and between a config and its one-knob
neighbours."""

from __future__ import annotations

import math

import torch

SQRT5 = math.sqrt(5.0)
EXPANDED_MAX_D = 64     # widest d whose r² is the reference's expansion
_DIFF_ELEMS = 1 << 25   # differences [rows, m, d] formed at once


def sqdist(xa, xb, inv_ls):
    """Scaled squared distance: xa [n,d], xb [m,d], inv_ls [d] -> [n,m]:
    expanded up to ``EXPANDED_MAX_D`` features, else summed over direct
    differences (exact 0 between equal rows) a block of rows at a time."""
    a = xa * inv_ls
    b = xb * inv_ls
    n, m, d = a.shape[0], b.shape[0], a.shape[1]
    if d <= EXPANDED_MAX_D:
        a2 = torch.sum(a * a, dim=1)[:, None]
        b2 = torch.sum(b * b, dim=1)[None, :]
        return torch.clamp_min(a2 + b2 - 2.0 * (a @ b.T), 0.0)
    rows = max(1, _DIFF_ELEMS // max(1, m * d))
    parts = [torch.sum((a[i:i + rows, None, :] - b[None, :, :]) ** 2, dim=2)
             for i in range(0, n, rows)]
    return torch.cat(parts) if parts else a.new_zeros((0, m))


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


_BWD_ROWS = 256   # rows of i whose differences [rows, n, d] are summed at once


def matern52_gram_bwd(x, lengthscale, signal_var, g):
    """(dL/dlengthscale [d], dL/dsignal_var []) of L = sum_ij g_ij K_ij with
    K = matern52(x, x, lengthscale, signal_var), g [n, n] not assumed
    symmetric: the formula of the CUDA backward kernel, in plain torch.

    With s = sqrt(5) r, w_ij = g_ij (5/3) sv e^{-s} (1 + s) where
    r² > 1e-12 (else 0, as the double-``where`` of :func:`matern52`
    zeroes it), dL/dls_k = sum_ij w_ij (x_ik - x_jk)² / ls_k³ from direct
    differences, and dL/dsv = sum_ij g_ij (1 + s + s²/3) e^{-s}."""
    d2 = sqdist(x, x, 1.0 / lengthscale)
    pos = d2 > 1e-12
    s = SQRT5 * torch.where(pos, torch.sqrt(torch.where(pos, d2, 1.0)), 0.0)
    e = torch.exp(-s)
    w = torch.where(pos, g * (5.0 / 3.0) * signal_var * e * (1.0 + s), 0.0)
    acc = torch.zeros_like(lengthscale)
    for i0 in range(0, x.shape[0], _BWD_ROWS):
        diff = x[i0:i0 + _BWD_ROWS, None, :] - x[None, :, :]
        acc = acc + torch.einsum("ij,ijk->k", w[i0:i0 + _BWD_ROWS],
                                 diff * diff)
    dsv = torch.sum(g * (1.0 + s + s * s / 3.0) * e)
    return acc / lengthscale ** 3, dsv
