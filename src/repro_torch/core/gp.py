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
  function runs in a Python loop.  The cache keeps the
  ``_GRAPH_CAPACITY`` most recently used graphs (a long-lived daemon
  meets many shapes);
* the multi-task (ICM) GP of the transfer layer, ``K_base ∘ B[t, t]``
  with a rank-1-plus-diagonal task covariance B, fits with the same
  Adam step over one flat vector of its parameters (a graph of its own
  key on the card); its base Gram takes the same kernel route.

Everything is float32.  A Cholesky of a matrix that is not positive
definite yields NaNs (as ``jnp.linalg.cholesky`` does), which the Adam
loop's ``nan_to_num`` on the gradients absorbs.
"""

from __future__ import annotations

import math
import threading
from collections import Counter
from functools import partial
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


class MTGPParams(NamedTuple):
    """Multi-task (ICM) hyperparameters: the base-kernel triple shared
    across tasks plus a rank-1-plus-diagonal task covariance and a
    per-task mean offset.  ``task_w``/``log_task_kappa``/``task_offset``
    are [T]; everything else matches :class:`GPParams`."""
    log_lengthscale: torch.Tensor   # [d] (ARD, shared across tasks)
    log_signal_var: torch.Tensor    # []
    log_noise_var: torch.Tensor     # []
    task_w: torch.Tensor            # [T] rank-1 factor of the task kernel
    log_task_kappa: torch.Tensor    # [T] per-task diagonal boost
    task_offset: torch.Tensor       # [T] per-task mean (standardized y)


class MTGPState(NamedTuple):
    params: MTGPParams
    x: torch.Tensor                 # [n, d] inputs (unit cube, no task col)
    tasks: torch.Tensor             # [n] int64 task indices
    y: torch.Tensor                 # [n] standardized targets
    chol: torch.Tensor              # [n, n]
    alpha: torch.Tensor             # [n] K⁻¹ (y - offset[tasks])
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


def mt_params_from_numpy(arrays: dict, device="cuda") -> MTGPParams:
    """MTGPParams from the reference's fields as numpy arrays (or lists)."""
    dev = resolve_device(device)
    return MTGPParams(*(_tensor(arrays[k], dev) for k in MTGPParams._fields))


def mt_state_from_numpy(params: dict, x, tasks, y, chol, alpha, y_mean,
                        y_std, device="cuda") -> MTGPState:
    """MTGPState from the reference's ``MTGPState`` fields as numpy arrays
    (``params`` as a dict of its six fields)."""
    dev = resolve_device(device)
    return MTGPState(mt_params_from_numpy(params, dev), _tensor(x, dev),
                     torch.as_tensor(np.asarray(tasks, np.int64),
                                     device=dev),
                     *(_tensor(a, dev) for a in (y, chol, alpha, y_mean,
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


def _adam_update(p, m, v, t, table, bounds, loss_fn, lr: float) -> None:
    """One Adam step on the flat log-hyperparameters ``p`` minimizing
    ``loss_fn(leaf)``, in place, with no host value in it: ``p``, ``m``,
    ``v`` of one layout, ``t`` [1] int64 the steps done, ``table`` the
    device copy of :func:`_bias_table`, ``bounds`` [2, len(p)] the clamp
    boxes.  NaN gradients are zeroed, parameters clamped to their boxes.
    Every operation is elementwise, so stepping the parameters as one
    vector gives the bits of stepping each alone."""
    leaf = p.detach().requires_grad_(True)
    loss = loss_fn(leaf)
    (g,) = torch.autograd.grad(loss, [leaf])
    with torch.no_grad():
        bc = table.index_select(0, t)
        g = torch.nan_to_num(g)
        m.copy_(0.9 * m + 0.1 * g)
        v.copy_(0.999 * v + 0.001 * g * g)
        step = lr * (m / bc[0, 0]) / (torch.sqrt(v / bc[0, 1]) + 1e-8)
        p.copy_(torch.clamp(leaf - step, bounds[0], bounds[1]))
        t.add_(1)


def _gp_loss(leaf, x, y, extra_noise, *, kind: str, use_kernel: bool):
    """The single-task negative log marginal at flat params ``leaf``."""
    return neg_log_marginal(_unflat(leaf), x, y, kind, extra_noise,
                            use_kernel)


def _adam_step(p, m, v, t, table, bounds, x, y, kind: str, lr: float,
               extra_noise=None, use_kernel: bool = False) -> None:
    """One Adam step on the log-hyperparameters maximizing the marginal
    likelihood (:func:`_adam_update`): ``p``, ``m``, ``v`` [d + 2] in
    :func:`_flat`'s layout, ``bounds`` those of :func:`_box_bounds`."""
    _adam_update(p, m, v, t, table, bounds,
                 lambda leaf: _gp_loss(leaf, x, y, extra_noise, kind=kind,
                                       use_kernel=use_kernel), lr)


def _run_eager(p, bounds, loss, inputs, steps: int, lr: float):
    """``steps`` calls of :func:`_adam_update` from Python on a copy of
    the flat params ``p``; ``loss(leaf, *inputs)``.  Returns the new flat
    params."""
    p = p.detach().clone()
    m, v = torch.zeros_like(p), torch.zeros_like(p)
    t = torch.zeros((1,), dtype=torch.int64, device=p.device)
    table = torch.tensor(_bias_table(steps), device=p.device)
    for _ in range(steps):
        _adam_update(p, m, v, t, table, bounds,
                     lambda leaf: loss(leaf, *inputs), lr)
    return p


def _eager_fit(params: GPParams, x, y, kind: str, steps: int, lr: float,
               extra_noise=None, use_kernel: bool = False) -> GPParams:
    """``steps`` calls of :func:`_adam_step` from Python, on any device:
    the host's fit, and on the card the graph's reference."""
    p = _flat(params)
    loss = partial(_gp_loss, kind=kind, use_kernel=use_kernel)
    return _unflat(_run_eager(p, _box_bounds(p.shape[0] - 2, x.device),
                              loss, (x, y, extra_noise), steps, lr))


_GRAPH_ROWS = 256       # bias-correction rows a new graph holds (≥ steps)
_GRAPH_WARMUP = 3       # eager steps on scratch state before a capture
_GRAPH_CAPACITY = 32    # captured graphs kept, least recently used evicted
_GRAPHS: dict = {}      # key -> _FitGraph, oldest use first
_GRAPH_LOCK = threading.Lock()   # one graphed fit (and capture) at a time
graph_captures = 0      # captures made; a cached graph is replayed
graph_evictions = 0     # graphs dropped to stay within _GRAPH_CAPACITY


class _FitGraph:
    """One :func:`_adam_update` captured in a CUDA graph over static
    buffers, replayed once per step.  A fit loads its inputs (the tensors
    ``loss`` reads after the flat params; ``None`` stays ``None``) and
    initial parameters into the buffers, so one capture serves every fit
    at its key.  The warm-up before the capture (cuSOLVER / cuBLAS
    handles, the autograd engine) runs on scratch copies of the state: it
    does not advance the fit."""

    def __init__(self, inputs, p, bounds, loss, lr: float, rows: int):
        self.inputs = tuple(None if a is None else torch.empty_like(a)
                            for a in inputs)
        self.p = p.detach().clone()
        self.m, self.v = torch.zeros_like(self.p), torch.zeros_like(self.p)
        self.t = torch.zeros((1,), dtype=torch.int64, device=p.device)
        self.table = torch.zeros((rows, 2), dtype=F32, device=p.device)
        self.bounds = bounds
        self.loss, self.lr = loss, lr
        self.graph = None
        self.launches = Counter()   # kernel launches one replay makes

    def _step(self, p, m, v, t):
        _adam_update(p, m, v, t, self.table, self.bounds,
                     lambda leaf: self.loss(leaf, *self.inputs), self.lr)

    def _capture(self):
        global graph_captures
        dev = self.p.device
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
        # thread_local: a capture on one thread (a refit_async executor, a
        # daemon's session) must not fail the other threads' CUDA calls
        with torch.cuda.graph(graph, stream=stream,
                              capture_error_mode="thread_local"):
            self._step(self.p, self.m, self.v, self.t)
        self.launches = gram_ops.take_captured_launches(stream)
        self.graph = graph
        graph_captures += 1

    def run(self, p, inputs, steps: int) -> torch.Tensor:
        for buf, a in zip(self.inputs, inputs):
            if buf is not None:
                buf.copy_(a)
        self.p.copy_(p)
        for buf in (self.m, self.v, self.t):
            buf.zero_()
        self.table[:steps].copy_(torch.tensor(_bias_table(steps)))
        if self.graph is None:
            self._capture()
        for _ in range(steps):
            self.graph.replay()
        gram_ops.add_launches(self.launches, steps)
        return self.p.clone()


def _run_graphed(key, p, bounds, loss, inputs, steps: int, lr: float):
    """:func:`_run_eager` on the card, as ``steps`` replays of the cached
    graph of one step at ``key`` (captured on first use, or again when
    its bias table is too short).  The cache keeps the
    ``_GRAPH_CAPACITY`` most recently used graphs, each with its buffers
    and its private memory pool; a failed capture or replay raises."""
    global graph_evictions
    with _GRAPH_LOCK, torch.cuda.device(p.device):
        g = _GRAPHS.pop(key, None)
        if g is None or g.table.shape[0] < steps:
            g = _FitGraph(inputs, p, bounds, loss, lr,
                          max(steps, _GRAPH_ROWS))
        _GRAPHS[key] = g                    # now the most recently used
        while len(_GRAPHS) > _GRAPH_CAPACITY:
            del _GRAPHS[next(iter(_GRAPHS))]
            graph_evictions += 1
        return g.run(p, inputs, steps)


def _graphed_fit(params: GPParams, x, y, kind: str, steps: int, lr: float,
                 extra_noise=None, use_kernel: bool = False) -> GPParams:
    """:func:`_eager_fit` on the card, as ``steps`` replays of the cached
    graph of one step per (device, shape, kind, kernel, extra noise,
    lr)."""
    use_kernel = use_kernel and kind == "matern52"
    key = (x.device, tuple(x.shape), kind, use_kernel,
           extra_noise is not None, lr)
    p = _flat(params)
    loss = partial(_gp_loss, kind=kind, use_kernel=use_kernel)
    return _unflat(_run_graphed(key, p, _box_bounds(p.shape[0] - 2,
                                                    x.device),
                                loss, (x, y, extra_noise), steps, lr))


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
        obs_var: Optional[np.ndarray] = None, device="cuda",
        tasks: Optional[np.ndarray] = None):
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

    ``tasks`` [n] switches on the multi-task (ICM) path: integer task
    indices aligned with the rows of ``x``.  With more than one distinct
    task the fit routes through :func:`fit_multitask` and returns an
    :class:`MTGPState`; with exactly one distinct task the column is
    dropped and this is *exactly* the single-task fit — the fallback the
    transfer layer relies on when a corpus collapses to one workload.
    """
    if tasks is not None:
        t = np.asarray(tasks, np.int32)
        if t.shape[0] != np.asarray(x).shape[0]:
            raise ValueError(
                f"tasks has {t.shape[0]} rows, x has "
                f"{np.asarray(x).shape[0]}")
        if t.size and int(t.max()) > 0:
            if params is not None and not isinstance(params, MTGPParams):
                raise TypeError("multi-task fit warm-start needs MTGPParams")
            return fit_multitask(x, y, t, kind=kind, steps=steps,
                                 params=params, obs_var=obs_var,
                                 use_kernel=use_kernel, device=device)
        # exact single-task fallback: one task present, column dropped
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


# ---------------------------------------------------------------------------
# multi-task GP (intrinsic coregionalization, rank-1 + diagonal)
# ---------------------------------------------------------------------------

def init_mt_params(d: int, n_tasks: int, lengthscale: float = 0.3,
                   signal: float = 1.0, noise: float = 1e-2,
                   offsets: Optional[np.ndarray] = None,
                   device="cuda") -> MTGPParams:
    """ICM init: ``task_w = 1`` (tasks fully correlated a priori) with a
    small diagonal boost, per-task offsets from the data when given."""
    dev = resolve_device(device)
    off = (torch.zeros((n_tasks,), dtype=F32, device=dev) if offsets is None
           else _tensor(offsets, dev))
    base = init_params(d, lengthscale, signal, noise, device=dev)
    return MTGPParams(
        *base,
        task_w=torch.ones((n_tasks,), dtype=F32, device=dev),
        log_task_kappa=torch.full((n_tasks,), math.log(0.1), dtype=F32,
                                  device=dev),
        task_offset=off)


def mt_params_to_dict(params: MTGPParams) -> dict:
    """JSON snapshot of the multi-task hyperparameters (log-domain values
    as fitted; the reference's format)."""
    out = params_to_dict(shared_params(params))
    for k in ("task_w", "log_task_kappa", "task_offset"):
        out[k] = [float(v) for v in getattr(params, k).detach().cpu()
                  .numpy()]
    return out


def mt_params_from_dict(d: dict, device="cuda") -> MTGPParams:
    """Inverse of :func:`mt_params_to_dict`."""
    return mt_params_from_numpy(d, device)


def shared_params(params: MTGPParams) -> GPParams:
    """Project the shared base-kernel triple out of a multi-task fit —
    the warm start a single-task GP on a *new* workload inherits."""
    return GPParams(params.log_lengthscale, params.log_signal_var,
                    params.log_noise_var)


def _task_cov(params: MTGPParams):
    """B = w wᵀ + diag(exp κ) — rank-1 plus diagonal, always PSD."""
    w = params.task_w
    return w[:, None] * w[None, :] + torch.diag(
        torch.exp(params.log_task_kappa))


def _one_hot(tasks, n_tasks: int):
    """[n, T] float32 indicator of each row's task, built by comparison
    (no host read, so a CUDA graph can hold it)."""
    return (tasks[:, None] == torch.arange(n_tasks, device=tasks.device)
            ).to(F32)


def _mt_build(params: MTGPParams, x, tasks, y, kind: str, extra_noise=None,
              use_kernel: bool = False):
    """Cholesky, K⁻¹r and residual r of the ICM Gram
    ``K_base ∘ B[t_i, t_j]``.  ``B[t_i, t_j]`` is ``E B Eᵀ`` with E the
    one-hot task matrix (exact: one nonzero product per entry), so the
    gradient reaches ``B`` through two products and the base Gram's
    through ``G ∘ B[t, t]``: with ``use_kernel`` the backward kernel."""
    ls = torch.exp(params.log_lengthscale)
    sv = torch.exp(params.log_signal_var)
    nv = torch.exp(params.log_noise_var)
    e = _one_hot(tasks, params.task_w.shape[0])
    k = gram(kind, x, ls, sv, use_kernel=use_kernel) * (
        e @ _task_cov(params) @ e.T)
    n = x.shape[0]
    diag = _jitter(nv, sv).expand(n)
    if extra_noise is not None:
        diag = diag + extra_noise
    chol = _cholesky(k + torch.diag(diag))
    r = y - e @ params.task_offset
    alpha = torch.cholesky_solve(r[:, None], chol)[:, 0]
    return chol, alpha, r


def mt_neg_log_marginal(params: MTGPParams, x, tasks, y, kind: str,
                        extra_noise=None, use_kernel: bool = False):
    chol, alpha, r = _mt_build(params, x, tasks, y, kind, extra_noise,
                               use_kernel)
    n = x.shape[0]
    return (0.5 * r @ alpha
            + torch.sum(torch.log(torch.diagonal(chol)))
            + 0.5 * n * math.log(2 * math.pi))


def _mt_flat(params: MTGPParams) -> torch.Tensor:
    """The multi-task log-hyperparameters as one new vector [d + 2 + 3T]:
    lengthscales, signal variance, noise variance, task_w,
    log_task_kappa, task_offset."""
    return torch.cat([t.detach().reshape(-1) for t in params])


def _mt_unflat(p: torch.Tensor, n_tasks: int) -> MTGPParams:
    """MTGPParams viewing a vector of :func:`_mt_flat`'s layout."""
    d = p.shape[0] - 2 - 3 * n_tasks
    w0 = d + 2
    return MTGPParams(p[:d], p[d], p[d + 1], p[w0:w0 + n_tasks],
                      p[w0 + n_tasks:w0 + 2 * n_tasks],
                      p[w0 + 2 * n_tasks:])


_MT_BOXES = ((-3.0, 3.0),                          # task_w (linear)
             (math.log(1e-4), math.log(10.0)),     # log task kappa
             (-5.0, 5.0))                          # task offset


def _mt_box_bounds(d: int, n_tasks: int, device) -> torch.Tensor:
    """[2, d + 2 + 3T]: the clamp of each entry of :func:`_mt_flat` (the
    base boxes of :func:`_box_bounds`, then ``_MT_BOXES``)."""
    base = _box_bounds(d, device).cpu()
    task = torch.tensor([[lo for lo, _ in _MT_BOXES],
                         [hi for _, hi in _MT_BOXES]], dtype=F32)
    return torch.cat([base, task.repeat_interleave(n_tasks, dim=1)],
                     dim=1).to(device)


def _mt_loss(leaf, x, tasks, y, extra_noise, *, n_tasks: int, kind: str,
             use_kernel: bool):
    """The multi-task negative log marginal at flat params ``leaf``."""
    return mt_neg_log_marginal(_mt_unflat(leaf, n_tasks), x, tasks, y, kind,
                               extra_noise, use_kernel)


def _mt_fit(params: MTGPParams, x, tasks, y, kind: str, steps: int = 200,
            lr: float = 0.05, extra_noise=None, use_kernel: bool = False,
            graphed: Optional[bool] = None) -> MTGPParams:
    """Adam on the joint (base + task) log-marginal: the step of
    :func:`_fit` on the flat layout of :func:`_mt_flat`, with the task
    blocks clamped to their own boxes.  Replayed from a CUDA graph of its
    own key on the card (each corpus size is a new graph: the reference
    does not pad the multi-task fit), a Python loop on the host;
    ``graphed=False`` runs the loop on the card too."""
    use_kernel = use_kernel and kind == "matern52"
    n_tasks = params.task_w.shape[0]
    p = _mt_flat(params)
    bounds = _mt_box_bounds(x.shape[1], n_tasks, x.device)
    loss = partial(_mt_loss, n_tasks=n_tasks, kind=kind,
                   use_kernel=use_kernel)
    inputs = (x, tasks, y, extra_noise)
    if graphed is None:
        graphed = x.device.type == "cuda"
    if graphed:
        key = ("mtgp", x.device, tuple(x.shape), n_tasks, kind, use_kernel,
               extra_noise is not None, lr)
        p = _run_graphed(key, p, bounds, loss, inputs, steps, lr)
    else:
        p = _run_eager(p, bounds, loss, inputs, steps, lr)
    return _mt_unflat(p, n_tasks)


def _mt_prepare(x: np.ndarray, y: np.ndarray, tasks: np.ndarray,
                obs_var: Optional[np.ndarray], device):
    """The multi-task fit's tensors on ``device``: x, int64 tasks, the
    globally standardized y, the extra-noise diagonal (``obs_var`` / σ²,
    or ``None``), y's mean and std, and each task's mean standardized y
    (the offsets' init)."""
    x = np.asarray(x, np.float32)
    y_raw = np.asarray(y, np.float32)
    t = np.asarray(tasks, np.int32)
    n_tasks = int(t.max()) + 1
    y_mean, y_std = float(y_raw.mean()), float(y_raw.std())
    if y_std < 1e-12:
        y_std = 1.0
    ys = (y_raw - y_mean) / y_std
    extra = None
    if obs_var is not None:
        extra = _tensor(np.asarray(obs_var, np.float32) / (y_std * y_std),
                        device)
    offsets = np.zeros(n_tasks, np.float32)
    for i in range(n_tasks):
        sel = t == i
        if sel.any():
            offsets[i] = float(ys[sel].mean())
    return (_tensor(x, device), torch.as_tensor(t.astype(np.int64),
                                                device=device),
            _tensor(ys, device), extra, y_mean, y_std, offsets)


def fit_multitask(x: np.ndarray, y: np.ndarray, tasks: np.ndarray,
                  kind: str = "matern52", steps: int = 200,
                  params: Optional[MTGPParams] = None,
                  obs_var: Optional[np.ndarray] = None,
                  use_kernel: bool = False, device="cuda") -> MTGPState:
    """Fit the ICM multi-task GP over stacked per-task observations.

    Targets are standardized *globally* (one μ/σ over every task) and the
    per-task level differences are absorbed by the learned ``task_offset``
    mean — initialized at each task's empirical standardized mean so the
    Adam loop starts from the right basin.  No shape padding, as in the
    reference.  ``use_kernel`` routes the base Gram of every Adam step
    (forward and backward) and of the posterior through the CUDA kernels;
    the reference's multi-task fit uses its jnp Matérn throughout.
    """
    dev = resolve_device(device)
    xj, tj, yj, extra, y_mean, y_std, offsets = _mt_prepare(
        x, y, tasks, obs_var, dev)
    if params is None:
        params = init_mt_params(int(xj.shape[1]), len(offsets),
                                offsets=offsets, device=dev)
    else:
        params = MTGPParams(*(p.detach().to(dev) for p in params))
    if steps > 0:
        params = _mt_fit(params, xj, tj, yj, kind, steps=steps,
                         extra_noise=extra, use_kernel=use_kernel)
    with torch.no_grad():
        chol, alpha, _ = _mt_build(params, xj, tj, yj, kind, extra,
                                   use_kernel=use_kernel)
    return MTGPState(params, xj, tj, yj, chol, alpha,
                     torch.tensor(y_mean, dtype=F32, device=dev),
                     torch.tensor(y_std, dtype=F32, device=dev))


@torch.no_grad()
def _mt_predict(state: MTGPState, xq, w_q, kappa_q, off_q, kind: str,
                use_kernel: bool):
    ls = torch.exp(state.params.log_lengthscale)
    sv = torch.exp(state.params.log_signal_var)
    kq = (cross(kind, xq, state.x, ls, sv, use_kernel=use_kernel)
          * (w_q * state.params.task_w)[state.tasks][None, :])
    mean_s = off_q + kq @ state.alpha
    v = torch.linalg.solve_triangular(state.chol, kq.T, upper=False)
    prior = (w_q * w_q + kappa_q) * sv
    var_s = torch.clamp_min(prior - torch.sum(v * v, dim=0), 1e-12)
    mean = mean_s * state.y_std + state.y_mean
    std = torch.sqrt(var_s) * state.y_std
    return mean, std


def predict_multitask(state: MTGPState, xq, task: Optional[int] = None,
                      kind: str = "matern52", use_kernel: bool = False):
    """Posterior mean/std at ``xq`` for one task (original y scale).

    ``task=None`` is the **stacked prior** for an *unseen* task: its
    rank-1 weight, diagonal and mean offset are the averages over the
    fitted tasks, so the prediction borrows exactly the structure every
    corpus workload shares and stays honestly wide where they disagree.
    ``use_kernel`` computes the cross-Gram with the CUDA kernel."""
    p = state.params
    if task is None:
        w_q = torch.mean(p.task_w)
        kappa_q = torch.mean(torch.exp(p.log_task_kappa))
        off_q = torch.mean(p.task_offset)
    else:
        w_q = p.task_w[task]
        kappa_q = torch.exp(p.log_task_kappa)[task]
        off_q = p.task_offset[task]
    xq = torch.as_tensor(xq, dtype=F32, device=state.x.device).contiguous()
    return _mt_predict(state, xq, w_q, kappa_q, off_q, kind, use_kernel)


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
