"""Lasso regression in torch (paper §3.3).

* ``lasso_fit``   — cyclic coordinate descent for one λ (soft-thresholding);
  warm-startable.
* ``lasso_path``  — geometric λ grid from λ_max (all-zero solution) down,
  warm-started FISTA on the Gram matrix — the ranking stage's solver.
* ``ridge_fit``   — closed-form L2 baseline (ridge cannot zero out
  coefficients, so it cannot *select*).

Features are standardized internally (zero mean / unit variance); returned
coefficients are on the standardized scale, which is what the importance
ranking wants.  Every solve runs in float32 on ``device``.  The JAX
reference runs each λ's iterations in one compiled ``while_loop``; here
the loop is Python and reads the stopping test back to the host once per
iteration, so the solver stops at the same iteration as the reference.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np
import torch

from repro_torch.device import resolve_device


class Standardized(NamedTuple):
    x: torch.Tensor       # [n, d] standardized features
    y: torch.Tensor       # [n] centered target
    x_mean: torch.Tensor
    x_std: torch.Tensor
    y_mean: torch.Tensor


def standardize(x, y, device="cuda") -> Standardized:
    dev = resolve_device(device)
    x = torch.as_tensor(np.asarray(x), dtype=torch.float32, device=dev)
    y = torch.as_tensor(np.asarray(y), dtype=torch.float32, device=dev)
    xm = x.mean(dim=0)
    xs = x.std(dim=0, correction=0)
    xs = torch.where(xs < 1e-12, torch.ones_like(xs), xs)  # constant cols
    ym = y.mean()
    return Standardized((x - xm) / xs, y - ym, xm, xs, ym)


def lambda_max(std: Standardized) -> float:
    """Smallest λ with all-zero solution: max |xᵀy| / n."""
    n = std.x.shape[0]
    return float(torch.max(torch.abs(std.x.T @ std.y)) / n)


def _soft(u, t):
    return torch.sign(u) * torch.clamp_min(torch.abs(u) - t, 0.0)


def _cd(x, y, lam: float, beta0, max_iter: int = 500, tol: float = 1e-6):
    """Cyclic coordinate descent.  x standardized [n,d], y centered [n]."""
    n, d = x.shape
    col_sq = torch.sum(x * x, dim=0) / n           # ~1 after standardization
    tol32 = float(np.float32(tol))

    def one_sweep(beta):
        beta = beta.clone()
        r = y - x @ beta
        for j in range(d):
            bj = beta[j].clone()
            xj = x[:, j]
            rho = (xj @ r) / n + col_sq[j] * bj
            bj_new = _soft(rho, lam) / torch.clamp_min(col_sq[j], 1e-12)
            r = r + xj * (bj - bj_new)
            beta[j] = bj_new
        return beta

    beta_prev, beta, it = beta0, one_sweep(beta0), 1
    while it < max_iter and float(torch.max(torch.abs(beta - beta_prev))) \
            > tol32:
        beta_prev, beta, it = beta, one_sweep(beta), it + 1
    return beta


def _fista_path(x, y, lams, max_iter: int, tol: float = 1e-7):
    """Warm-started FISTA over the whole λ grid on the [d,d] Gram matrix;
    β carries down the grid (the standard pathwise warm start).  Each λ
    stops when ``max|β − β_prev| ≤ tol`` or after ``max_iter`` steps,
    checked every iteration as the reference's ``while_loop`` does."""
    n, d = x.shape
    g = x.T @ x / n                                  # [d, d] gram
    b = x.T @ y / n                                  # [d]
    # Lipschitz constant: the exact top eigenvalue (an underestimate
    # would make the gradient step overshoot and the path diverge)
    lip = torch.clamp_min(torch.linalg.eigvalsh(g)[-1], 1e-6) * 1.01
    tol32 = float(np.float32(tol))
    one = np.float32(1.0)

    beta = torch.zeros((d,), dtype=torch.float32, device=x.device)
    betas = []
    for lam in lams:
        thr = lam / lip

        def step(beta, z, t):
            beta_new = _soft(z - (g @ z - b) / lip, thr)
            # the momentum schedule depends on the step count only: float32
            # scalars on the host, as the reference computes it in float32
            t_new = np.float32(0.5) * (one + np.sqrt(one + np.float32(4.0)
                                                     * t * t))
            z = beta_new + float((t - one) / t_new) * (beta_new - beta)
            return beta_new, z, t_new

        prev = beta
        beta, z, t = step(beta, beta, one)
        it = 1
        while it < max_iter and float(torch.max(torch.abs(beta - prev))) \
                > tol32:
            prev = beta
            beta, z, t = step(beta, z, t)
            it += 1
        betas.append(beta)
    return torch.stack(betas)


def lasso_fit(x, y, lam: float, beta0=None, max_iter: int = 500,
              device="cuda") -> np.ndarray:
    """Fit one λ; returns standardized-scale coefficients [d]."""
    std = standardize(x, y, device)
    d = std.x.shape[1]
    if beta0 is None:
        beta0 = torch.zeros((d,), dtype=torch.float32, device=std.x.device)
    else:
        beta0 = torch.as_tensor(np.asarray(beta0), dtype=torch.float32,
                                device=std.x.device)
    beta = _cd(std.x, std.y, float(np.float32(lam)), beta0,
               max_iter=max_iter)
    return beta.cpu().numpy()


def lasso_path(x, y, n_lambdas: int = 50, eps: float = 1e-3,
               max_iter: int = 300, device="cuda"
               ) -> Tuple[np.ndarray, np.ndarray]:
    """Pathwise FISTA over a geometric λ grid (warm starts).

    Returns (lambdas [L] descending, betas [L, d] standardized scale).
    """
    std = standardize(x, y, device)
    lmax = max(lambda_max(std), 1e-12)
    lams = np.geomspace(lmax, lmax * eps, n_lambdas)
    lams_t = torch.as_tensor(lams, dtype=torch.float32, device=std.x.device)
    betas = _fista_path(std.x, std.y, lams_t, max_iter=max_iter)
    return lams, betas.cpu().numpy()


def ridge_fit(x, y, lam: float, device="cuda") -> np.ndarray:
    """Closed-form ridge (comparison baseline; cannot select features)."""
    std = standardize(x, y, device)
    n, d = std.x.shape
    a = std.x.T @ std.x / n + lam * torch.eye(d, dtype=torch.float32,
                                              device=std.x.device)
    b = std.x.T @ std.y / n
    return torch.linalg.solve(a, b).cpu().numpy()


def path_importance(lams: np.ndarray, betas: np.ndarray) -> np.ndarray:
    """Per-feature importance from a lasso path: the λ-weighted area
    under |β_j(λ)|, ∫ λ·|β_j(λ)| dlogλ.  Features that enter early (at
    large λ) dominate; spurious late entrants get negligible weight."""
    logl = np.log(lams)
    w = np.abs(np.gradient(logl)) * lams   # λ·dlogλ weights
    return np.einsum("l,ld->d", w, np.abs(betas))
