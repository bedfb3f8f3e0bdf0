"""Gaussian-process regression for noisy black-box objectives (paper §3.4).

The paper's argument for BO-with-GP is noise tolerance: the GP's noise
hyperparameter lets it approximate the objective *through* noise-corrupted
observations.  Implementation, in torch on an explicit device:

* Matérn-5/2 (default) and RBF kernels over the unit cube;
* exact GP with Cholesky solves (≤ a few hundred points — the paper's
  regime, where each point costs a cluster benchmark);
* hyperparameters (lengthscale per-dim, signal var, noise var) fit by
  maximizing the log marginal likelihood with Adam on log-params;
* with ``use_kernel`` the Gram of every Adam step, the posterior Gram and
  every candidate cross-Gram go through the hand-written CUDA kernels
  (``kernels/gp_gram``): the Adam loop's gradient through the Gram is the
  backward kernel's.  The reference keeps its Adam loop on its jnp kernel,
  because its Pallas kernel defines no VJP; the gradient is the same
  function.  On CPU tensors the wrappers return the plain-torch version,
  with autograd;
* on the card one Adam step (forward, backward, update) is captured once
  in a CUDA graph per shape and replayed once per step, so the host does
  not dispatch each step's ~100 small kernels; on the host the same step
  function runs in a Python loop.

Everything is float32.  A Cholesky of a matrix that is not positive
definite yields NaNs (as ``jnp.linalg.cholesky`` does), which the Adam
loop's ``nan_to_num`` on the gradients absorbs.
"""

from __future__ import annotations

import math
import threading
from collections import Counter
from typing import NamedTuple, Optional

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.kernels.gp_gram import ops as gram_ops
from repro_torch.kernels.gp_gram.ref import matern52, sqdist

F32 = torch.float32


# ---------------------------------------------------------------------------
# kernels
# ---------------------------------------------------------------------------

def rbf(xa, xb, lengthscale, signal_var):
    return signal_var * torch.exp(-0.5 * sqdist(xa, xb, 1.0 / lengthscale))


KERNELS = {"matern52": matern52, "rbf": rbf}


def gram(kind: str, x, lengthscale, signal_var, *, use_kernel: bool = False):
    """Kernel Gram matrix; optionally via the CUDA tile kernel."""
    if use_kernel and kind == "matern52":
        return gram_ops.matern52_gram(x, lengthscale, signal_var)
    return KERNELS[kind](x, x, lengthscale, signal_var)


def cross(kind: str, xa, xb, lengthscale, signal_var, *,
          use_kernel: bool = False):
    """Cross-Gram [n, m]; optionally via the CUDA tile kernel."""
    if use_kernel and kind == "matern52":
        return gram_ops.matern52_cross(xa, xb, lengthscale, signal_var)
    return KERNELS[kind](xa, xb, lengthscale, signal_var)


# ---------------------------------------------------------------------------
# GP posterior
# ---------------------------------------------------------------------------

class GPParams(NamedTuple):
    log_lengthscale: torch.Tensor   # [d] (ARD)
    log_signal_var: torch.Tensor    # []
    log_noise_var: torch.Tensor     # []


class GPState(NamedTuple):
    params: GPParams
    x: torch.Tensor                 # [n, d] training inputs (unit cube)
    y: torch.Tensor                 # [n] standardized targets
    chol: torch.Tensor              # [n, n] cholesky of K + σ²I
    alpha: torch.Tensor             # [n] K⁻¹ y
    y_mean: torch.Tensor
    y_std: torch.Tensor


def _tensor(a, device) -> torch.Tensor:
    return torch.as_tensor(np.array(a, np.float32), device=device)


def init_params(d: int, lengthscale: float = 0.3, signal: float = 1.0,
                noise: float = 1e-2, device="cuda") -> GPParams:
    dev = resolve_device(device)
    return GPParams(
        log_lengthscale=torch.full((d,), math.log(lengthscale), dtype=F32,
                                   device=dev),
        log_signal_var=torch.tensor(math.log(signal), dtype=F32, device=dev),
        log_noise_var=torch.tensor(math.log(noise), dtype=F32, device=dev),
    )


def params_to_dict(params: GPParams) -> dict:
    """JSON-serializable snapshot of the hyperparameters (log domain, as
    fitted; a roundtrip through :func:`params_from_dict` is f32-exact).
    Same format as the JAX reference, so either package reads the other's."""
    return {
        "log_lengthscale": [float(v) for v in
                            params.log_lengthscale.detach().cpu().numpy()],
        "log_signal_var": float(params.log_signal_var),
        "log_noise_var": float(params.log_noise_var),
    }


def params_from_dict(d: dict, device="cuda") -> GPParams:
    """Inverse of :func:`params_to_dict`."""
    return params_from_numpy(d, device)


def params_from_numpy(arrays: dict, device="cuda") -> GPParams:
    """GPParams from the reference's fields as numpy arrays (or lists)."""
    dev = resolve_device(device)
    return GPParams(*(_tensor(arrays[k], dev) for k in GPParams._fields))


def state_from_numpy(params: dict, x, y, chol, alpha, y_mean, y_std,
                     device="cuda") -> GPState:
    """GPState from the reference's ``GPState`` fields as numpy arrays
    (``params`` as a dict of its three fields)."""
    dev = resolve_device(device)
    return GPState(params_from_numpy(params, dev),
                   *(_tensor(a, dev) for a in (x, y, chol, alpha, y_mean,
                                               y_std)))


PAD_NOISE = 1e6   # pseudo-point noise: pads contribute ~nothing to the fit


def _jitter(nv, sv):
    """Relative diagonal jitter: keeps the condition number f32-safe.
    Shared by the posterior build and the select_batch fantasy appends —
    the two paths must stamp identical diagonals."""
    return nv + 1e-4 * sv + 1e-6


def _cholesky(kn):
    """Lower Cholesky factor whose lower triangle is NaN where ``kn`` is
    not positive definite, as ``jnp.linalg.cholesky`` returns it (and no
    host sync, unlike ``torch.linalg.cholesky``'s raise)."""
    chol, info = torch.linalg.cholesky_ex(kn)
    bad = (info > 0) & torch.ones_like(chol, dtype=torch.bool).tril()
    return torch.where(bad, float("nan"), chol)


def _build(params: GPParams, x, y, kind: str, extra_noise=None,
           use_kernel: bool = False):
    ls = torch.exp(params.log_lengthscale)
    sv = torch.exp(params.log_signal_var)
    nv = torch.exp(params.log_noise_var)
    k = gram(kind, x, ls, sv, use_kernel=use_kernel)
    n = x.shape[0]
    diag = _jitter(nv, sv).expand(n)
    if extra_noise is not None:
        diag = diag + extra_noise
    chol = _cholesky(k + torch.diag(diag))
    alpha = torch.cholesky_solve(y[:, None], chol)[:, 0]
    return chol, alpha


def neg_log_marginal(params: GPParams, x, y, kind: str, extra_noise=None,
                     use_kernel: bool = False):
    chol, alpha = _build(params, x, y, kind, extra_noise, use_kernel)
    n = x.shape[0]
    return (0.5 * y @ alpha
            + torch.sum(torch.log(torch.diagonal(chol)))
            + 0.5 * n * math.log(2 * math.pi))


_BOXES = ((math.log(1e-2), math.log(3.0)),     # log lengthscale
          (math.log(1e-2), math.log(1e2)),     # log signal variance
          (math.log(1e-4), math.log(1.0)))     # log noise (keeps chol PD)


def _bias_table(steps: int) -> np.ndarray:
    """Adam's bias corrections [steps, 2]: row r holds 1 − 0.9ᵗ and
    1 − 0.999ᵗ at t = r + 1, in float32 scalar arithmetic (the host loop's
    rounding, kept bit for bit)."""
    table = np.zeros((steps, 2), np.float32)
    t = np.float32(0.0)
    for r in range(steps):
        t = t + np.float32(1.0)
        table[r] = (np.float32(1.0) - np.float32(0.9) ** t,
                    np.float32(1.0) - np.float32(0.999) ** t)
    return table


def _flat(params: GPParams) -> torch.Tensor:
    """The log-hyperparameters as one new vector [d + 2]: lengthscales,
    signal variance, noise variance (Adam steps all of them at once)."""
    return torch.cat([params.log_lengthscale.detach().reshape(-1),
                      params.log_signal_var.detach().reshape(1),
                      params.log_noise_var.detach().reshape(1)])


def _unflat(p: torch.Tensor) -> GPParams:
    """GPParams viewing a vector of :func:`_flat`'s layout."""
    d = p.shape[0] - 2
    return GPParams(p[:d], p[d], p[d + 1])


def _box_bounds(d: int, device) -> torch.Tensor:
    """[2, d + 2]: the lower and upper clamp of each entry of :func:`_flat`
    (``_BOXES``)."""
    (ls_lo, ls_hi), (sv_lo, sv_hi), (nv_lo, nv_hi) = _BOXES
    return torch.tensor([[ls_lo] * d + [sv_lo, nv_lo],
                         [ls_hi] * d + [sv_hi, nv_hi]], dtype=F32,
                        device=device)


def _adam_step(p, m, v, t, table, bounds, x, y, kind: str, lr: float,
               extra_noise=None, use_kernel: bool = False) -> None:
    """One Adam step on the log-hyperparameters maximizing the marginal
    likelihood, in place, with no host value in it: ``p``, ``m``, ``v``
    [d + 2] in :func:`_flat`'s layout, ``t`` [1] int64 the steps done,
    ``table`` the device copy of :func:`_bias_table`, ``bounds`` those of
    :func:`_box_bounds`.  NaN gradients are zeroed, hyperparameters
    clamped to sane boxes.  Stepping the three parameters as one vector
    gives the bits of stepping each alone (every operation is
    elementwise) in a third of the kernels."""
    leaf = p.detach().requires_grad_(True)
    loss = neg_log_marginal(_unflat(leaf), x, y, kind, extra_noise,
                            use_kernel)
    (g,) = torch.autograd.grad(loss, [leaf])
    with torch.no_grad():
        bc = table.index_select(0, t)
        g = torch.nan_to_num(g)
        m.copy_(0.9 * m + 0.1 * g)
        v.copy_(0.999 * v + 0.001 * g * g)
        step = lr * (m / bc[0, 0]) / (torch.sqrt(v / bc[0, 1]) + 1e-8)
        p.copy_(torch.clamp(leaf - step, bounds[0], bounds[1]))
        t.add_(1)


def _eager_fit(params: GPParams, x, y, kind: str, steps: int, lr: float,
               extra_noise=None, use_kernel: bool = False) -> GPParams:
    """``steps`` calls of :func:`_adam_step` from Python, on any device:
    the host's fit, and on the card the graph's reference."""
    p = _flat(params)
    m, v = torch.zeros_like(p), torch.zeros_like(p)
    t = torch.zeros((1,), dtype=torch.int64, device=x.device)
    table = torch.tensor(_bias_table(steps), device=x.device)
    bounds = _box_bounds(p.shape[0] - 2, x.device)
    for _ in range(steps):
        _adam_step(p, m, v, t, table, bounds, x, y, kind, lr, extra_noise,
                   use_kernel)
    return _unflat(p)


_GRAPH_ROWS = 256       # bias-correction rows a new graph holds (≥ steps)
_GRAPH_WARMUP = 3       # eager steps on scratch state before a capture
_GRAPHS: dict = {}      # (device, n, d, kind, kernel, extra, lr) -> graph
_GRAPH_LOCK = threading.Lock()   # one graphed fit (and capture) at a time
graph_captures = 0      # captures made; a cached graph is replayed


class _FitGraph:
    """One :func:`_adam_step` captured in a CUDA graph over static
    buffers, replayed once per step.  A fit loads its inputs and initial
    parameters into the buffers, so one capture serves every fit at its
    key.  The warm-up before the capture (cuSOLVER / cuBLAS handles, the
    autograd engine) runs on scratch copies of the state: it does not
    advance the fit."""

    def __init__(self, x, y, extra_noise, params: GPParams, kind: str,
                 lr: float, use_kernel: bool, rows: int):
        self.x, self.y = torch.empty_like(x), torch.empty_like(y)
        self.extra = (None if extra_noise is None
                      else torch.empty_like(extra_noise))
        self.p = _flat(params)
        self.m, self.v = torch.zeros_like(self.p), torch.zeros_like(self.p)
        self.t = torch.zeros((1,), dtype=torch.int64, device=x.device)
        self.table = torch.zeros((rows, 2), dtype=F32, device=x.device)
        self.bounds = _box_bounds(self.p.shape[0] - 2, x.device)
        self.kind, self.lr, self.use_kernel = kind, lr, use_kernel
        self.graph = None
        self.launches = Counter()   # kernel launches one replay makes

    def _step(self, p, m, v, t):
        _adam_step(p, m, v, t, self.table, self.bounds, self.x, self.y,
                   self.kind, self.lr, self.extra, self.use_kernel)

    def _capture(self):
        global graph_captures
        dev = self.x.device
        stream = torch.cuda.Stream(device=dev)
        stream.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(stream):
            scratch = [b.clone() for b in (self.p, self.m, self.v)]
            t = self.t.clone()
            for _ in range(_GRAPH_WARMUP):
                self._step(*scratch, t)
        torch.cuda.current_stream(dev).wait_stream(stream)
        del scratch, t
        graph = torch.cuda.CUDAGraph()
        # thread_local: a capture on a refit_async executor thread must
        # not fail the other threads' CUDA calls
        with torch.cuda.graph(graph, stream=stream,
                              capture_error_mode="thread_local"):
            self._step(self.p, self.m, self.v, self.t)
        self.launches = gram_ops.take_captured_launches(stream)
        self.graph = graph
        graph_captures += 1

    def run(self, params: GPParams, x, y, extra_noise,
            steps: int) -> GPParams:
        self.x.copy_(x)
        self.y.copy_(y)
        if self.extra is not None:
            self.extra.copy_(extra_noise)
        self.p.copy_(_flat(params))
        for buf in (self.m, self.v, self.t):
            buf.zero_()
        self.table[:steps].copy_(torch.tensor(_bias_table(steps)))
        if self.graph is None:
            self._capture()
        for _ in range(steps):
            self.graph.replay()
        gram_ops.add_launches(self.launches, steps)
        return _unflat(self.p.clone())


def _graphed_fit(params: GPParams, x, y, kind: str, steps: int, lr: float,
                 extra_noise=None, use_kernel: bool = False) -> GPParams:
    """:func:`_eager_fit` on the card, as ``steps`` replays of the cached
    graph of one step; a failed capture or replay raises."""
    use_kernel = use_kernel and kind == "matern52"
    key = (x.device, tuple(x.shape), kind, use_kernel,
           extra_noise is not None, lr)
    with _GRAPH_LOCK, torch.cuda.device(x.device):
        g = _GRAPHS.get(key)
        if g is None or g.table.shape[0] < steps:
            g = _GRAPHS[key] = _FitGraph(x, y, extra_noise, params, kind, lr,
                                         use_kernel, max(steps, _GRAPH_ROWS))
        return g.run(params, x, y, extra_noise, steps)


def _fit(params: GPParams, x, y, kind: str, steps: int = 200,
         lr: float = 0.05, extra_noise=None,
         use_kernel: bool = False) -> GPParams:
    """Adam on log-hyperparameters maximizing the marginal likelihood:
    replayed from a CUDA graph on the card, a Python loop on the host
    (the same step function, :func:`_adam_step`)."""
    fit_fn = _graphed_fit if x.device.type == "cuda" else _eager_fit
    return fit_fn(params, x, y, kind, steps, lr, extra_noise, use_kernel)


def _bucket(n: int) -> int:
    """Pad count: next multiple of 16.  Padded shapes are part of the
    numbers (``PAD_NOISE`` rows), so they match the reference's."""
    return ((n + 15) // 16) * 16


def _prepare(x: np.ndarray, y: np.ndarray, pad: bool, device,
             pad_to: Optional[int] = None,
             obs_var: Optional[np.ndarray] = None):
    """Standardize y and append huge-noise pseudo-points up to the target
    shape (``pad_to`` or the next bucket).  ``obs_var`` [n] is the
    per-observation measurement variance in *raw* y units; it lands on the
    extra-noise diagonal the pads use, rescaled by 1/y_std²."""
    x = np.asarray(x, np.float32)
    y_raw = np.asarray(y, np.float32)
    n, d = x.shape
    y_mean, y_std = float(y_raw.mean()), float(y_raw.std())
    if y_std < 1e-12:
        y_std = 1.0
    ys = (y_raw - y_mean) / y_std
    extra = None
    if obs_var is not None:
        extra = np.asarray(obs_var, np.float32) / (y_std * y_std)
    if pad or pad_to:
        m = max(_bucket(n), pad_to or 0)
        if m > n:
            x = np.vstack([x, np.full((m - n, d), 0.5, np.float32)])
            ys = np.concatenate([ys, np.zeros(m - n, np.float32)])
            padded = np.zeros(m, np.float32)
            if extra is not None:
                padded[:n] = extra
            padded[n:] = PAD_NOISE
            extra = padded
    ej = None if extra is None else _tensor(extra, device)
    return _tensor(x, device), _tensor(ys, device), ej, y_mean, y_std


def fit(x: np.ndarray, y: np.ndarray, kind: str = "matern52",
        steps: int = 200, params: Optional[GPParams] = None,
        pad: bool = True, pad_to: Optional[int] = None,
        use_kernel: bool = False,
        obs_var: Optional[np.ndarray] = None, device="cuda") -> GPState:
    """Standardize y, fit hyperparameters, build the posterior on
    ``device``.

    ``pad`` appends huge-noise pseudo-points up to a shape bucket (the
    pads' posterior influence is ~1/PAD_NOISE); ``pad_to`` pins the padded
    size outright.  ``params`` warm-starts the hyperparameter optimization;
    with ``steps=0`` they are used as-is.  ``obs_var`` [n] makes the GP
    heteroscedastic: per-observation measurement variance (raw y units)
    added to the noise diagonal on top of the fitted global scalar.

    ``use_kernel`` routes the Gram of every Adam step and of the
    posterior build through the CUDA kernels (matern52 only): the Adam
    loop differentiates through the backward kernel.  The reference's Adam
    loop stays on its jnp kernel, as its Pallas kernel defines no VJP; the
    gradient is the same function, computed by a kernel here.  On the
    card the Adam steps are replays of one CUDA graph per shape
    (:func:`_graphed_fit`), with or without ``use_kernel``.
    """
    dev = resolve_device(device)
    xj, yj, ej, y_mean, y_std = _prepare(x, y, pad, dev, pad_to, obs_var)
    if params is None:
        params = init_params(int(xj.shape[1]), device=dev)
    else:
        params = GPParams(*(p.detach().to(dev) for p in params))
    if steps > 0:
        params = _fit(params, xj, yj, kind, steps=steps, extra_noise=ej,
                      use_kernel=use_kernel)
    with torch.no_grad():
        chol, alpha = _build(params, xj, yj, kind, ej, use_kernel=use_kernel)
    return GPState(params, xj, yj, chol, alpha,
                   torch.tensor(y_mean, dtype=F32, device=dev),
                   torch.tensor(y_std, dtype=F32, device=dev))


def condition(params: GPParams, x: np.ndarray, y: np.ndarray,
              kind: str = "matern52", pad: bool = True,
              pad_to: Optional[int] = None,
              use_kernel: bool = False,
              obs_var: Optional[np.ndarray] = None,
              device="cuda") -> GPState:
    """Posterior for (x, y) under *fixed* hyperparameters — no
    marginal-likelihood refit (one Cholesky rebuild, no Adam)."""
    return fit(x, y, kind, steps=0, params=params, pad=pad, pad_to=pad_to,
               use_kernel=use_kernel, obs_var=obs_var, device=device)


@torch.no_grad()
def predict(state: GPState, xq, kind: str = "matern52",
            use_kernel: bool = False):
    """Posterior mean/std at query points xq [m,d] (original y scale)."""
    xq = torch.as_tensor(xq, dtype=F32, device=state.x.device).contiguous()
    ls = torch.exp(state.params.log_lengthscale)
    sv = torch.exp(state.params.log_signal_var)
    kq = cross(kind, xq, state.x, ls, sv, use_kernel=use_kernel)  # [m, n]
    mean_s = kq @ state.alpha
    v = torch.linalg.solve_triangular(state.chol, kq.T, upper=False)
    var_s = torch.clamp_min(sv - torch.sum(v * v, dim=0), 1e-12)
    mean = mean_s * state.y_std + state.y_mean
    std = torch.sqrt(var_s) * state.y_std
    return mean, std


def _ei(mean, std, best_y, xi: float):
    std = torch.clamp_min(std, 1e-9)
    imp = best_y - xi - mean
    z = imp / std
    cdf = 0.5 * (1 + torch.special.erf(z / math.sqrt(2)))
    pdf = torch.exp(-0.5 * z * z) / math.sqrt(2 * math.pi)
    return imp * cdf + std * pdf


def expected_improvement(state: GPState, xq, best_y: float,
                         kind: str = "matern52", xi: float = 0.01):
    """EI for *minimization* of y (y = step time / negative bandwidth)."""
    mean, std = predict(state, xq, kind)
    return _ei(mean, std, best_y, xi)


def ucb(state: GPState, xq, kind: str = "matern52", beta: float = 2.0):
    """Lower-confidence bound for minimization (returns negated for argmax)."""
    mean, std = predict(state, xq, kind)
    return -(mean - beta * std)


# ---------------------------------------------------------------------------
# q-batch selection on the device
# ---------------------------------------------------------------------------

def chol_append(chol, k_vec, k_ss):
    """Incremental Cholesky append (O(n²), vs the O(n³) rebuild).

    Given lower-triangular ``chol`` L with L Lᵀ = K [n, n], the cross
    column ``k_vec = K(x_new, X)`` [n] and ``k_ss = k(x_new, x_new) +
    noise``, returns ``(l, d)`` such that ``[[L, 0], [lᵀ, d]]`` is the
    Cholesky factor of ``[[K, k_vec], [k_vecᵀ, k_ss]]``.
    """
    l = torch.linalg.solve_triangular(chol, k_vec[:, None], upper=False)[:, 0]
    d = torch.sqrt(torch.clamp_min(k_ss - torch.dot(l, l), 1e-12))
    return l, d


@torch.no_grad()
def select_batch(state: GPState, cand, y_raw, n: int, best_y, q: int,
                 kind: str = "matern52", fantasy: str = "liar",
                 acquisition: str = "ei", xi: float = 0.01,
                 use_kernel: bool = False) -> torch.Tensor:
    """Fantasized q-EI batch selection, on the state's device.

    One loop over the q picks: score the candidate pool, masked argmax,
    fantasize the pick's outcome (constant liar at ``best_y`` or Kriging
    believer at the posterior mean) and append it to the posterior via
    :func:`chol_append` — O(n²) per fantasy point.  The picks stay on the
    device until the caller reads them; the loop never syncs the host.

    Layout: the fitted padded state (``state.x`` [m, d], ``state.chol``
    [m, m], pads included) occupies the leading block of a fixed
    [m+q-1]-size working set; fantasy points are appended into the
    trailing slots.  The target standardization is recomputed over the
    real + fantasy observations at every pick, as a ``condition`` rebuild
    would.

    Args:
      state: posterior from :func:`fit` (padded or not).
      cand:  [M, d] candidate pool (unit cube).
      y_raw: [m] raw targets aligned with ``state.x``; entries at index
             ≥ n (pads) are ignored.
      n:     number of real observations.
      best_y: incumbent best raw target (the EI threshold and the liar).
      q:     batch width.
      fantasy: "liar" | "believer";  acquisition: "ei" | "ucb".

    Returns ``picks`` [q] int64 — indices into ``cand``.
    """
    dev = state.x.device
    m, d_dim = state.x.shape
    cand = torch.as_tensor(cand, dtype=F32, device=dev).contiguous()
    M = cand.shape[0]
    S = q - 1                               # fantasy slots
    T = m + S
    ls = torch.exp(state.params.log_lengthscale)
    sv = torch.exp(state.params.log_signal_var)
    nv = torch.exp(state.params.log_noise_var)
    kfn = KERNELS[kind]
    y_raw = torch.as_tensor(y_raw, dtype=F32, device=dev)
    best_y = torch.as_tensor(best_y, dtype=F32, device=dev)

    # the one O(M·m·d) pass over the whole candidate pool: cross-Gram
    # against the training block — the CUDA tile kernel's natural shape
    k_cx = cross(kind, cand, state.x, ls, sv, use_kernel=use_kernel)

    # fixed-shape working set; inactive fantasy rows are identity rows of
    # L with zeroed cross entries, so prefix arithmetic is exact
    chol = torch.zeros((T, T), dtype=F32, device=dev)
    chol[:m, :m] = state.chol
    if S:
        fdiag = torch.arange(m, T, device=dev)
        chol[fdiag, fdiag] = 1.0
    real = torch.arange(m, device=dev) < n
    noise_ss = _jitter(nv, sv)

    # forward-substitution state against the fitted block, grown one row
    # per pick:  V [T, M] = L⁻¹ Kᵀ(X, cand),  a = L⁻¹ (masked raw y),
    # b = L⁻¹ (active mask);  mean_s = Vᵀ(a − μ·b)/σ reproduces kq @ K⁻¹ys
    # under the per-pick re-standardization (μ, σ over real + fantasy).
    y_masked = torch.where(real, y_raw, 0.0)
    v = torch.zeros((T, M), dtype=F32, device=dev)
    v[:m] = torch.linalg.solve_triangular(state.chol, k_cx.T, upper=False)
    ab = torch.linalg.solve_triangular(
        state.chol, torch.stack([y_masked, real.to(F32)], dim=1),
        upper=False)
    a = torch.zeros((T,), dtype=F32, device=dev)
    a[:m] = ab[:, 0]
    b = torch.zeros((T,), dtype=F32, device=dev)
    b[:m] = ab[:, 1]
    y_f = torch.zeros((S,), dtype=F32, device=dev)      # fantasy targets
    x_f = torch.zeros((S, d_dim), dtype=F32, device=dev)  # fantasy inputs
    taken = torch.zeros((M,), dtype=torch.bool, device=dev)
    slots = torch.arange(S, device=dev)

    picks = []
    for j in range(q):
        active = slots < j
        # per-pick re-standardization over real + fantasy targets
        w = torch.cat([real, active]).to(F32)
        yr = torch.cat([y_masked, torch.where(active, y_f, 0.0)])
        cnt = torch.sum(w)
        mu_y = torch.sum(yr) / cnt          # masked entries are zero
        std_y = torch.sqrt(torch.sum(w * (yr - mu_y) ** 2) / cnt)
        std_y = torch.where(std_y < 1e-12, 1.0, std_y)

        mean_s = (v.T @ (a - mu_y * b)) / std_y
        var_s = torch.clamp_min(sv - torch.sum(v * v, dim=0), 1e-12)
        mean = mean_s * std_y + mu_y
        std = torch.sqrt(var_s) * std_y

        if acquisition == "ei":
            acq = _ei(mean, std, best_y, xi)
        else:                               # ucb (minimization, negated)
            acq = -(mean - 2.0 * std)
        acq = torch.where(taken, -math.inf, acq)
        i = torch.argmax(acq)
        taken[i] = True
        picks.append(i)

        if j < S:                           # fantasy-append (not the last)
            x_new = cand[i]
            lie = mean[i] if fantasy == "believer" else best_y
            k_f_new = torch.where(active, kfn(x_new[None], x_f, ls, sv)[0],
                                  0.0)
            k_vec = torch.cat([k_cx[i], k_f_new])
            l, dg = chol_append(chol, k_vec, sv + noise_ss)
            row = m + j
            chol[row] = l
            chol[row, row] = dg
            # grow the forward-substitution state by the appended row
            col_c = kfn(cand, x_new[None], ls, sv)[:, 0]
            v[row] = (col_c - l @ v) / dg
            a[row] = (lie - l @ a) / dg
            b[row] = (1.0 - l @ b) / dg
            y_f[j] = lie
            x_f[j] = x_new
    return torch.stack(picks)
