"""Ask/tell search strategies — the paper's Search Unit with control inverted.

The paper's Fig. 3 separates the *Search Unit* (which configs to try next)
from the *Experiment Unit* (how to measure them).  BestConfig (Zhu et al.,
2017) and Magpie (Zhu et al., 2022) frame tuning the same way: a pluggable
search algorithm behind a fixed experiment-driver interface.  This module
is that interface:

    strategy = make_strategy("bo", space, cfg=BOConfig(...))
    while not strategy.finished:
        probes = strategy.ask()          # never calls an objective
        values = <measure probes however you like>
        strategy.tell(probes, values)
    best_config, best_value = strategy.best()

A :class:`SearchStrategy` proposes configs (``ask``) and learns from
results (``tell``) but *never* evaluates anything — the experiment loops
(:meth:`repro_torch.core.controller.Controller.run` and the overlapped
:meth:`~repro_torch.core.controller.Controller.run_async`) own evaluation,
batching, the evaluation DB, and fidelity scheduling.  ``tell`` accepts
partial and out-of-order batches: the async controller streams results in
as workers finish, successive halving promotes only a screened subset,
and warm-start history injects observations the strategy never asked
for — injected observations extend the trace but do not consume the
search budget.  Asked-but-untold probes *do* count against the budget, so
an async driver that keeps many probes in flight cannot overshoot it.

Four strategies re-express the previous closed-loop optimizers:

* :class:`BOStrategy`     — GP-BO with constant-liar q-EI, warm-started
  hyperparameters and dynamic boundary enlargement (paper §3.4, Fig. 4);
* :class:`RandomStrategy` — LHS design (the sanity floor, and the ranking
  phase's sampler);
* :class:`AnnealingStrategy` — memoryless Metropolis walk (§3.4 critique);
* :class:`GeneticStrategy`   — population evolution (§3.4 critique).

The GP work of :class:`BOStrategy` runs in torch on ``BOConfig.device``
(the card by default); candidate pools and designs come from numpy
``Generator`` objects on the host, exactly as in the JAX reference.
"""

from __future__ import annotations

from dataclasses import dataclass, field, replace
from typing import (Callable, Dict, List, Optional, Protocol, Sequence,
                    Tuple, Union, runtime_checkable)

import numpy as np
import torch

from repro_torch.core import gp
from repro_torch.core.sampling import init_design, latin_hypercube, lhs_unit
from repro_torch.core.space import Config, Space
from repro_torch.device import resolve_device


# ---------------------------------------------------------------------------
# the evaluation trace (shared by every strategy; formerly bo.BOTrace)
# ---------------------------------------------------------------------------

@dataclass
class Trace:
    configs: List[Config] = field(default_factory=list)
    values: List[float] = field(default_factory=list)
    best_values: List[float] = field(default_factory=list)   # running min
    boundary_events: List[Tuple[int, str]] = field(default_factory=list)
    # per-observation measurement variance (variance of the reported mean,
    # from replicated measurements); 0.0 = "no empirical noise estimate" —
    # the GP then falls back to its fitted global noise scalar for the row
    variances: List[float] = field(default_factory=list)

    @property
    def best(self) -> Tuple[Config, float]:
        i = int(np.argmin(self.values))
        return self.configs[i], self.values[i]

    def extend(self, configs: Sequence[Config], values: Sequence[float],
               variances: Optional[Sequence[float]] = None):
        if variances is None:
            variances = [0.0] * len(configs)
        for c, v, var in zip(configs, values, variances):
            self.configs.append(c)
            self.values.append(float(v))
            self.variances.append(float(var))
            self.best_values.append(min(self.best_values[-1], float(v))
                                    if self.best_values else float(v))


# ---------------------------------------------------------------------------
# strategy configs
# ---------------------------------------------------------------------------

@dataclass
class BOConfig:
    n_init: int = 8                 # initial LHS design
    n_iter: int = 48                # BO evaluations after the design
    batch_size: int = 1             # q: probes per GP refit (constant-liar
                                    # q-EI); 1 = the classic sequential loop
    n_candidates: int = 2048        # acquisition candidates per iteration
    n_local: int = 256              # perturbations around the incumbent
    local_sigma: float = 0.08
    kernel: str = "matern52"
    fit_steps: int = 150
    fit_steps_warm: Optional[int] = None   # Adam steps on warm-started
                                           # rounds (None: fit_steps // 3)
    warm_start: bool = False        # reuse GP hyperparams across rounds.
                                    # Off by default so sequential callers
                                    # keep the paper's full refit-per-eval
                                    # loop; Sapphire turns it on whenever
                                    # batching is requested
    acquisition: str = "ei"         # ei | ucb
    log_objective: bool = True      # model log(y): heavy-tailed penalties
                                    # (OOM probes) otherwise flatten the GP
    fantasy: str = "liar"           # q-batch fantasy value: "liar"
                                    # (constant liar at the incumbent best
                                    # — matches the sequential optimum
                                    # within noise on every seed tried) |
                                    # "believer" (Kriging believer —
                                    # posterior mean at the pick)
    dynamic_boundary: bool = True
    boundary_tol: float = 0.05
    boundary_factor: float = 2.0
    boundary_damping: bool = True   # k knobs triggering in ONE round each
                                    # expand by factor**(1/k): a wide async
                                    # wave inflates the domain volume by at
                                    # most `boundary_factor` per round
                                    # instead of factor**k
    use_kernel: bool = True         # route Gram builds and candidate
                                    # scoring through the kernels/gp_gram
                                    # CUDA tile kernel (matern52; the
                                    # wrapper computes the plain-torch
                                    # version on CPU tensors)
    refit_async: bool = False       # marginal-likelihood refit on a
                                    # background executor over a snapshot
                                    # of the trace: ask() never blocks on
                                    # the Adam loop, selection runs against
                                    # the last *completed* posterior
    shard_candidates: Union[bool, int] = False
                                    # sharded candidate scoring is not
                                    # ported yet: any true value raises
    refit_device: Optional[int] = None
                                    # pin the refit_async background fit to
                                    # cuda:i (None: the strategy's device)
    device: str = "cuda"            # where the GP is fitted and queried
    seed: int = 0


@dataclass
class SAConfig:
    t0: float = 1.0           # initial temperature (in units of objective std)
    cooling: float = 0.93     # geometric cooling per step
    sigma: float = 0.12       # proposal stddev in unit cube
    seed: int = 0


@dataclass
class GAConfig:
    population: int = 8
    elite: int = 2
    tournament: int = 3
    crossover_p: float = 0.5
    mutation_sigma: float = 0.1
    mutation_p: float = 0.25
    seed: int = 0


# ---------------------------------------------------------------------------
# the protocol
# ---------------------------------------------------------------------------

@runtime_checkable
class SearchStrategy(Protocol):
    """What the experiment loop needs from a search algorithm."""

    space: Space                 # current domain (BO may enlarge it)
    trace: Trace                 # every observation told so far

    @property
    def finished(self) -> bool:  # search budget fully observed
        ...

    def ask(self, n: Optional[int] = None) -> List[Config]:
        """Propose up to ``n`` configs to evaluate (``None``: the
        strategy's preferred batch).  May return fewer — or ``[]`` when
        the budget is exhausted or the strategy is blocked on ``tell``."""
        ...

    def tell(self, configs: Sequence[Config], values: Sequence[float],
             variances: Optional[Sequence[float]] = None) -> None:
        """Report results.  Partial batches, out-of-order results and
        never-asked (injected) observations are all accepted.
        ``variances`` carries per-observation measurement variance from
        replicated measurements (0.0 = no estimate); strategies that
        cannot use it store it in the trace and ignore it."""
        ...

    def best(self) -> Tuple[Config, float]:
        ...


def _config_key(cfg: Config) -> Tuple:
    """Canonical hashable key with dict-equality semantics.  Numpy scalars
    hash and compare like their Python values, and knob names are unique
    within a config, so the sort never compares two values."""
    return tuple(sorted(cfg.items(), key=lambda kv: kv[0]))


def _json_cfg(cfg: Config) -> Config:
    """JSON-safe copy of a config (numpy scalars to Python values)."""
    out = {}
    for k, v in cfg.items():
        if isinstance(v, np.integer):
            v = int(v)
        elif isinstance(v, np.floating):
            v = float(v)
        elif isinstance(v, np.bool_):
            v = bool(v)
        out[k] = v
    return out


class _PendingSet:
    """Asked-but-untold probes keyed by canonical config tuple.

    The legacy bookkeeping was ``list.remove`` with dict equality —
    O(pending) dict comparisons per told probe, so a q-wide async wave
    cost O(q·n).  Keyed FIFO buckets make the whole wave O(q).  An
    optional payload rides along with each entry (the genetic strategy
    keys its population index this way)."""

    def __init__(self):
        self._buckets: Dict[Tuple, List] = {}
        self._n = 0

    def add(self, cfg: Config, payload=None) -> None:
        self._buckets.setdefault(_config_key(cfg), []).append(payload)
        self._n += 1

    def pop(self, cfg: Config) -> Tuple[bool, Optional[object]]:
        """Remove the oldest pending entry equal to ``cfg``; returns
        ``(matched, payload)`` — ``(False, None)`` when nothing matches
        (an injected observation)."""
        key = _config_key(cfg)
        bucket = self._buckets.get(key)
        if not bucket:
            return False, None
        payload = bucket.pop(0)
        if not bucket:
            del self._buckets[key]
        self._n -= 1
        return True, payload

    def __len__(self) -> int:
        return self._n

    def __bool__(self) -> bool:
        return self._n > 0


class _StrategyBase:
    """Trace + pending-probe bookkeeping shared by every strategy."""

    def __init__(self, space: Space):
        self.space = space
        self.trace = Trace()
        self._pending = _PendingSet()

    def best(self) -> Tuple[Config, float]:
        if not self.trace.values:
            raise RuntimeError(f"{type(self).__name__}: no observations yet")
        return self.trace.best

    def _match_pending(self, cfg: Config) -> bool:
        matched, _ = self._pending.pop(cfg)
        return matched


# ---------------------------------------------------------------------------
# GP-BO (paper §3.4, Fig. 4) as an ask/tell strategy
# ---------------------------------------------------------------------------

class BOStrategy(_StrategyBase):
    """GP surrogate + dynamic boundaries, inverted into ask/tell.

    ``ask`` serves the initial LHS design first, then per round: fit the
    GP to the whole trace (hyperparameters warm-started when configured),
    select a q-EI batch through :func:`repro_torch.core.gp.select_batch`
    (EI scoring, masked argmax and O(n²) incremental-Cholesky fantasy
    appends for all q picks on the device), enlarge any ``dynamic_bound``
    boundary a probe is near (paper Fig. 4, volume-damped when several
    knobs trigger at once), and return the probes.  ``cfg.n_iter`` counts evaluations after the
    design, so the experiment budget is identical for every batch width;
    asked-but-untold probes count against the budget so an async driver
    cannot overshoot it.

    With ``cfg.refit_async`` the marginal-likelihood refit runs on a
    background executor over a snapshot of the trace: ``ask`` selects
    against the last *completed* posterior and never blocks on the Adam
    loop (only the first post-design ask fits synchronously — there is no
    posterior to reuse yet).  The async experiment loop then submits new
    waves at evaluation speed regardless of ``fit_steps``.  Candidates
    are drawn in the *current* space while the posterior may predate a
    boundary expansion — the same approximation the constant liar already
    makes, traded for never idling the cluster.  When a round's own
    expansion fires, the snapshot handed to the background fit is
    re-encoded in the enlarged space first (the trace's unit-cube
    coordinates just moved).  The background fit runs on the strategy's
    device (``cfg.refit_device`` pins it to another card).  :meth:`close`
    joins the executor (the strategy stays usable afterwards).

    The GP lives on ``cfg.device``; with ``cfg.use_kernel`` its Gram
    builds and the candidate cross-Gram run the CUDA tile kernel.
    ``cfg.shard_candidates`` (sharded candidate scoring) is not ported yet
    and raises.
    """

    def __init__(self, space: Space, cfg: Optional[BOConfig] = None,
                 init_configs: Optional[List[Config]] = None):
        super().__init__(space)
        self.cfg = cfg or BOConfig()
        if self.cfg.shard_candidates:
            raise NotImplementedError(
                "BOConfig.shard_candidates: sharded candidate scoring "
                "(gp.select_batch_sharded) is not ported yet — ROADMAP "
                "queue A, item 12")
        self.rng = np.random.default_rng(self.cfg.seed)
        # the base space's numeric bounds, before any dynamic expansion —
        # the identity a state snapshot must match to be loadable here
        self._base_bounds = {k.name: (float(k.lo), float(k.hi))
                             for k in space.knobs
                             if k.kind in ("int", "float")}
        self._init_queue = init_design(space, self.cfg.n_init, self.rng,
                                       init_configs)
        self._n_init = len(self._init_queue)
        self._pending_init = _PendingSet()
        self._params = None                  # warm-start carry
        self._pad_to: Optional[int] = None   # budget-pinned padded shape
        self._evals_done = 0                 # told post-init evaluations
        # refit_async machinery (all driver-thread state except the
        # executor's own worker; the background task is a pure gp.fit)
        self._posterior = None               # (state, x, y) last completed
        self._refit_future = None
        self._refit_snapshot = None          # (x, y) the in-flight fit sees
        self._refit_len = 0                  # trace length it was given
        self._refit_pool = None
        self._space_version = 0              # bumped by boundary expansion
        self._refit_space_version = 0        # space the last fit was given

    @property
    def finished(self) -> bool:
        return (not self._init_queue and not self._pending_init
                and self._evals_done >= self.cfg.n_iter)

    # -- GP fitting (sync + background) ---------------------------------------

    def _fit_args(self):
        cfg = self.cfg
        steps = cfg.fit_steps
        warm = None
        if cfg.warm_start and self._params is not None:
            warm = self._params
            steps = (cfg.fit_steps_warm if cfg.fit_steps_warm is not None
                     else max(cfg.fit_steps // 3, 20))
        return warm, steps

    def _fit_gp(self, x: np.ndarray, y: np.ndarray,
                obs_var: Optional[np.ndarray] = None):
        warm, steps = self._fit_args()
        cfg = self.cfg
        return gp.fit(x, y, cfg.kernel, steps=steps, params=warm,
                      pad_to=self._pad_to, use_kernel=cfg.use_kernel,
                      obs_var=obs_var, device=cfg.device)

    def _refit(self, x: np.ndarray, y: np.ndarray,
               obs_var: Optional[np.ndarray] = None):
        """refit_async: harvest a landed background fit and return the
        last completed posterior *with the data it was fitted on* —
        fantasy appends must extend the matrix the Cholesky factors.
        The first post-design round fits synchronously (nothing to select
        against yet)."""
        fut = self._refit_future
        if fut is not None and fut.done():
            self._refit_future = None
            state = fut.result()            # a failed fit surfaces here
            self._posterior = (state,) + self._refit_snapshot[:2]
            self._params = state.params
        if self._posterior is None:
            state = self._fit_gp(x, y, obs_var)
            self._params = state.params
            self._posterior = (state, x, y)
            self._refit_len = len(self.trace.values)
            self._refit_space_version = self._space_version
        return self._posterior

    def _refit_device(self) -> torch.device:
        """Device the background fit runs on: ``cuda:<cfg.refit_device>``
        when set on a CUDA strategy, else the strategy's own device (the
        fit shares the card; it only thread-yields, never blocks ask)."""
        home = resolve_device(self.cfg.device)
        if self.cfg.refit_device is None or home.type != "cuda":
            return home
        return torch.device("cuda",
                            self.cfg.refit_device % torch.cuda.device_count())

    def _fit_background(self, x: np.ndarray, y: np.ndarray, steps: int,
                        warm, obs_var: Optional[np.ndarray] = None):
        """The executor task: a pure gp.fit on the refit device, with the
        finished posterior handed back to the strategy's device."""
        cfg = self.cfg
        home = resolve_device(cfg.device)
        dev = self._refit_device()
        state = gp.fit(x, y, cfg.kernel, steps=steps, params=warm,
                       pad_to=self._pad_to, use_kernel=cfg.use_kernel,
                       obs_var=obs_var, device=dev)
        if dev == home:
            return state
        return gp.GPState(gp.GPParams(*(t.to(home) for t in state.params)),
                          *(t.to(home) for t in state[1:]))

    def _refit_kick(self, x: np.ndarray, y: np.ndarray,
                    obs_var: Optional[np.ndarray] = None):
        """Kick a background refit on the (x, y) snapshot when fresh
        observations arrived — or when boundary expansion re-encoded the
        trace (same observation count, different inputs).  Called at the
        END of ask — after the selection's device work has completed — so
        on a single shared accelerator the refit's computation queues
        behind this round's selection, never in front of the next one the
        driver is about to dispatch."""
        if self._refit_future is not None:
            return
        if (len(self.trace.values) <= self._refit_len
                and self._refit_space_version == self._space_version):
            return
        warm, steps = self._fit_args()
        self._refit_len = len(self.trace.values)
        self._refit_space_version = self._space_version
        self._refit_snapshot = (x, y, obs_var)
        if self._refit_pool is None:
            from concurrent.futures import ThreadPoolExecutor
            self._refit_pool = ThreadPoolExecutor(
                max_workers=1, thread_name_prefix="gp-refit")
        self._refit_future = self._refit_pool.submit(
            self._fit_background, x, y, steps, warm, obs_var)

    def close(self):
        """Join the background refit executor (refit_async mode).  An
        in-flight fit is waited out and discarded; the strategy remains
        usable — a later ask() restarts the executor."""
        pool, self._refit_pool = self._refit_pool, None
        self._refit_future = None
        if pool is not None:
            pool.shutdown(wait=True)

    # -- dynamic boundary (paper Fig. 4) --------------------------------------

    def _expand_near(self, probes: Sequence[Config]) -> List[str]:
        """Enlarge every dynamic bound a probe is near, once over the
        whole batch.  With ``boundary_damping``, k simultaneous events
        expand each knob by ``factor**(1/k)`` — k knobs at the full
        factor would multiply the domain volume by factor**k in a single
        round, over-inflating it exactly when wide async waves coalesce."""
        cfg = self.cfg
        if not cfg.dynamic_boundary:
            return []
        near: List[str] = []
        for probe in probes:
            for name in self.space.near_boundary(probe, cfg.boundary_tol):
                if name not in near:
                    near.append(name)
        if near:
            factor = cfg.boundary_factor
            if cfg.boundary_damping and len(near) > 1:
                factor = factor ** (1.0 / len(near))
            self.space = self.space.expand_boundaries(near, factor)
            self._space_version += 1
            at = self._evals_done + len(self._pending)
            for name in near:
                self.trace.boundary_events.append((at, name))
        return near

    # -- GP training set (overridable) ----------------------------------------

    def _training_data(self) -> Tuple[List[Config], List[float],
                                      List[float]]:
        """The rows the GP is fitted on: ``(configs, values, variances)``
        in *raw* objective units.  The base strategy trains on exactly the
        trace; :class:`repro.transfer.TransferBOStrategy` overrides this
        to append prior pseudo-observations — rows the GP sees but the
        trace (and therefore :meth:`best` and the budget) never does.
        The default must stay the trace verbatim: equal lists in, equal
        posterior out is what keeps the empty-corpus transfer path
        trace-identical to plain BO."""
        return self.trace.configs, self.trace.values, self.trace.variances

    def ask(self, n: Optional[int] = None) -> List[Config]:
        # -- initial design ---------------------------------------------------
        if self._init_queue:
            k = len(self._init_queue) if n is None \
                else max(min(n, len(self._init_queue)), 1)
            chunk, self._init_queue = (self._init_queue[:k],
                                       self._init_queue[k:])
            out = [dict(c) for c in chunk]
            for c in out:
                self._pending_init.add(c)
            return out
        if not self.trace.values:
            return []                        # blocked: nothing observed yet

        # -- one BO round -----------------------------------------------------
        remaining = self.cfg.n_iter - self._evals_done - len(self._pending)
        if remaining <= 0:
            return []
        q = max(min(n if n is not None else self.cfg.batch_size,
                    remaining), 1)
        if self._pad_to is None:
            # fix the padded GP shape for the whole run (the pads are part
            # of the numbers, so this matches the reference)
            self._pad_to = gp._bucket(self._n_init + self.cfg.n_iter)
        cfg = self.cfg
        t_configs, t_values, t_vars = self._training_data()
        x = self.space.encode_batch(t_configs)
        y = np.asarray(t_values, np.float64)
        # heteroscedastic channel: replicated measurements report the
        # variance of their pooled mean; rows without an estimate stay at
        # 0.0 (global-scalar fallback).  All-zero variances pass None so
        # the homoscedastic path stays bit-identical to pre-replication
        # traces.  Under log_objective the delta method maps raw variance
        # onto the log scale: var[log y] ≈ var[y] / y².
        obs = None
        var = np.asarray(t_vars, np.float64)
        if var.size == y.size and np.any(var > 0):
            obs = var / np.maximum(y, 1e-12) ** 2 if cfg.log_objective \
                else var.copy()
        if cfg.log_objective:
            y = np.log(np.maximum(y, 1e-12))
        if cfg.refit_async:
            state, x_fit, y_fit = self._refit(x, y, obs)
        else:
            state = self._fit_gp(x, y, obs)
            self._params = state.params
            self._posterior = (state, x, y)
            x_fit, y_fit = x, y

        # candidates: global LHS + Gaussian ball + per-knob incumbent
        # mutations.  The Gaussian ball almost never crosses a bool /
        # categorical decision boundary (σ=0.08 in unit space), so EI can
        # sit in a basin forever without trying `tensor_parallel=False`;
        # the axis sweeps make every single-knob move visible.
        d = len(self.space)
        cand = lhs_unit(self.rng, cfg.n_candidates, d)
        inc = self.space.to_unit(self.trace.best[0])
        local = np.clip(inc[None] + self.rng.normal(0, cfg.local_sigma,
                                                    (cfg.n_local, d)), 0, 1)
        sweeps = []
        for j in range(d):
            for u in (0.0, 0.25, 0.5, 0.75, 1.0):
                m = inc.copy()
                m[j] = u
                sweeps.append(m)
        cand = np.vstack([cand, local, np.asarray(sweeps)])

        # q-EI on the device: EI scoring, masked argmax and
        # incremental-Cholesky fantasy appends for every pick, one host
        # read of the picks at the end.  The scan length is bucketed to a
        # multiple of batch_size as in the reference (greedy selection is
        # prefix-stable, so the first q of a longer scan ARE the q picks).
        n_fit = len(y_fit)
        best_y = float(np.min(y_fit))
        y_raw = np.zeros(int(state.x.shape[0]), np.float32)
        y_raw[:n_fit] = np.asarray(y_fit, np.float32)
        q_sel = cfg.batch_size * -(-q // cfg.batch_size)
        idx = gp.select_batch(
            state, cand.astype(np.float32), y_raw, n_fit, best_y, q_sel,
            kind=cfg.kernel, fantasy=cfg.fantasy,
            acquisition=cfg.acquisition,
            use_kernel=cfg.use_kernel).cpu().numpy()
        picks = [cand[int(i)] for i in idx[:q]]
        probes = self.space.decode_batch(np.stack(picks))
        expanded = self._expand_near(probes)
        if cfg.refit_async:
            # selection has device-synced (.cpu() above): the refit's
            # computation queues strictly after it.  Expansion runs FIRST:
            # when this round enlarged a boundary the trace encoding just
            # changed, so the snapshot is re-encoded in the new space —
            # otherwise the background fit would train on stale unit-cube
            # coordinates for the rest of the run
            if expanded:
                x = self.space.encode_batch(self.trace.configs)
            self._refit_kick(x, y, obs)
        for c in probes:
            self._pending.add(c)
        return probes

    def tell(self, configs: Sequence[Config], values: Sequence[float],
             variances: Optional[Sequence[float]] = None):
        configs = [dict(c) for c in configs]
        self.trace.extend(configs, values, variances)
        for c in configs:
            if self._pending_init.pop(c)[0]:
                continue
            if self._match_pending(c):
                self._evals_done += 1
            # else: injected observation — free information, no budget

    # -- GP-implied measurement noise (the replication racer's prior) ---------

    def measurement_variance(self, config: Config) -> Optional[float]:
        """GP-implied variance of a *single* measurement at ``config``,
        in raw objective units — the fitted observation-noise
        hyperparameter, learned from every config's residuals at once.
        This is the strength a 2-repeat probe borrows across configs:
        its own empirical variance has one degree of freedom, while the
        GP's noise scalar has the whole trace behind it
        (:class:`repro_torch.core.replication.AdaptiveRacer` pools the two).
        Under ``log_objective`` the log-scale noise is mapped back
        through the delta method at the posterior mean.  ``None`` before
        the first fit (the racer then falls back to empirical-only)."""
        post = self._posterior
        if post is None:
            return None
        state = post[0]
        nv = (float(torch.exp(state.params.log_noise_var))
              * float(state.y_std) ** 2)
        if not self.cfg.log_objective:
            return nv
        u = np.asarray(self.space.to_unit(config),
                       np.float32)[None]
        mu, _ = gp.predict(state, u, self.cfg.kernel)
        y_hat = float(np.exp(np.clip(float(mu[0]), -50.0, 50.0)))
        return nv * y_hat * y_hat

    # -- serializable hyperparameter state (warm session restarts) -----------

    STATE_VERSION = 1

    def state_dict(self) -> dict:
        """First-class serializable GP state: hyperparameters
        (lengthscales / signal / noise, log domain, f32-exact), dynamic
        boundary state, and a trace snapshot — everything a fresh
        :class:`BOStrategy` over the same base space needs to resume
        this one (:meth:`load_state`).  Asked-but-untold probes are
        deliberately NOT serialized: their results will never arrive in
        the restarted process, so the restart re-asks them (in-flight
        budget is released, told budget is kept).  The tuning service
        snapshots sessions through this."""
        return {
            "version": self.STATE_VERSION,
            "kind": "bo",
            "kernel": self.cfg.kernel,
            "params": (None if self._params is None
                       else gp.params_to_dict(self._params)),
            "knobs": sorted(self.space.names),
            "base_bounds": {n: [lo, hi]
                            for n, (lo, hi) in self._base_bounds.items()},
            "bounds": {k.name: [float(k.lo), float(k.hi)]
                       for k in self.space.knobs
                       if k.kind in ("int", "float")},
            "trace": {
                "configs": [_json_cfg(c) for c in self.trace.configs],
                "values": [float(v) for v in self.trace.values],
                "variances": [float(v) for v in self.trace.variances],
                "boundary_events": [[int(i), str(n)] for i, n
                                    in self.trace.boundary_events],
            },
            "evals_done": int(self._evals_done),
            "init_queue": [_json_cfg(c) for c in self._init_queue],
            "n_init": int(self._n_init),
            "pad_to": self._pad_to,
            "space_version": int(self._space_version),
        }

    def load_state(self, sd: dict) -> None:
        """Restore :meth:`state_dict` output into this (freshly built)
        strategy: re-expands dynamic boundaries to their serialized
        state, reinstates the fitted hyperparameters as the warm-start
        carry, and replays the trace snapshot.  The strategy must have
        been constructed over the same base space (same knob names) and
        config (kernel) the snapshot came from."""
        if sd.get("version") != self.STATE_VERSION:
            raise ValueError(f"BOStrategy.load_state: unsupported state "
                             f"version {sd.get('version')!r} "
                             f"(this build speaks {self.STATE_VERSION})")
        if sd.get("kernel", self.cfg.kernel) != self.cfg.kernel:
            raise ValueError(
                f"BOStrategy.load_state: state was fitted with kernel "
                f"{sd['kernel']!r}, this strategy uses {self.cfg.kernel!r}")
        # Space identity: a snapshot is only loadable over the space it
        # was fitted on.  Loading across workloads whose spaces merely
        # *look* alike would silently hand the GP a permuted / rescaled
        # unit cube, so every mismatch is a hard error, never a warning.
        if "knobs" in sd:
            theirs, ours = set(sd["knobs"]), set(self.space.names)
            if theirs != ours:
                missing = sorted(theirs - ours)
                extra = sorted(ours - theirs)
                raise ValueError(
                    "BOStrategy.load_state: space mismatch — state knobs "
                    f"absent here: {missing[:8]}; knobs the state lacks: "
                    f"{extra[:8]}")
        for name, (lo, hi) in sd.get("base_bounds", {}).items():
            if name not in self._base_bounds:
                raise ValueError("BOStrategy.load_state: state names a "
                                 f"knob this space lacks: {name!r}")
            mine = self._base_bounds[name]
            if (float(lo), float(hi)) != mine:
                raise ValueError(
                    f"BOStrategy.load_state: base bounds differ for "
                    f"{name!r}: state has [{lo}, {hi}], this space has "
                    f"[{mine[0]}, {mine[1]}] — refusing to load a GP "
                    f"fitted on a different unit-cube scaling")
        bounds = sd.get("bounds", {})
        unknown = set(bounds) - set(self.space.names)
        if unknown:
            raise ValueError("BOStrategy.load_state: state names knobs "
                             f"this space lacks: {sorted(unknown)}")
        space = self.space
        for name, (lo, hi) in bounds.items():
            k = space.knob(name)
            if (float(k.lo), float(k.hi)) != (float(lo), float(hi)):
                space = space.with_knob(replace(k, lo=float(lo),
                                                hi=float(hi)))
        self.space = space
        self._params = (None if sd.get("params") is None
                        else gp.params_from_dict(sd["params"],
                                                 self.cfg.device))
        tr = sd.get("trace", {})
        self.trace = Trace()
        self.trace.extend(tr.get("configs", []), tr.get("values", []),
                          tr.get("variances") or None)
        self.trace.boundary_events = [(int(i), str(n)) for i, n
                                      in tr.get("boundary_events", [])]
        self._evals_done = int(sd.get("evals_done", 0))
        self._init_queue = [dict(c) for c in sd.get("init_queue", [])]
        self._n_init = int(sd.get("n_init", self._n_init))
        self._pad_to = sd.get("pad_to")
        self._space_version = int(sd.get("space_version", 0))
        # in-flight state is process-local: pending probes are re-asked,
        # the posterior/refit machinery restarts lazily on the next ask
        self._pending = _PendingSet()
        self._pending_init = _PendingSet()
        self._posterior = None
        self._refit_future = None
        self._refit_snapshot = None
        self._refit_len = 0
        self._refit_space_version = self._space_version


# ---------------------------------------------------------------------------
# baselines (paper §3.4) as ask/tell strategies
# ---------------------------------------------------------------------------

class RandomStrategy(_StrategyBase):
    """LHS design.  With a ``budget`` the whole stratified design is fixed
    up front (identical to ``sampling.latin_hypercube``); with
    ``budget=None`` the strategy is endless — each ask draws a fresh LHS
    chunk, and the driver owns termination (successive-halving screens)."""

    def __init__(self, space: Space, budget: Optional[int] = None,
                 seed: int = 0, batch_size: Optional[int] = None):
        super().__init__(space)
        self.budget = budget
        self.batch_size = batch_size
        self.rng = np.random.default_rng(seed)
        self._queue: List[Config] = (latin_hypercube(space, budget, seed=seed)
                                     if budget else [])
        self._told = 0

    @property
    def finished(self) -> bool:
        return self.budget is not None and self._told >= self.budget

    def ask(self, n: Optional[int] = None) -> List[Config]:
        if self.budget is not None:
            if not self._queue:
                return []
            k = n if n is not None else (self.batch_size or len(self._queue))
            k = max(min(k, len(self._queue)), 1)
            chunk, self._queue = self._queue[:k], self._queue[k:]
        else:
            k = n if n is not None else (self.batch_size or 1)
            chunk = self.space.decode_batch(
                lhs_unit(self.rng, k, len(self.space)))
        out = [dict(c) for c in chunk]
        for c in out:
            self._pending.add(c)
        return out

    def tell(self, configs: Sequence[Config], values: Sequence[float],
             variances: Optional[Sequence[float]] = None):
        configs = [dict(c) for c in configs]
        self.trace.extend(configs, values, variances)
        for c in configs:
            if self._match_pending(c):
                self._told += 1


class AnnealingStrategy(_StrategyBase):
    """Metropolis walk.  The accept/reject state advances in ``tell``; the
    walk is memoryless (the paper's point about SA's unreliability under
    noise), so ``ask(n > 1)`` simply proposes n independent perturbations
    of the current state."""

    def __init__(self, space: Space, budget: int,
                 cfg: Optional[SAConfig] = None, seed: Optional[int] = None):
        super().__init__(space)
        self.cfg = cfg or SAConfig()
        if cfg is None and seed is not None:
            self.cfg = replace(self.cfg, seed=seed)
        self.budget = budget
        self.rng = np.random.default_rng(self.cfg.seed)
        self._cur: Optional[Config] = None
        self._cur_v: Optional[float] = None
        self._t = self.cfg.t0
        self._asked_start = False
        self._told = 0

    @property
    def finished(self) -> bool:
        return self._told >= self.budget

    def ask(self, n: Optional[int] = None) -> List[Config]:
        remaining = self.budget - self._told - len(self._pending)
        if remaining <= 0:
            return []
        k = min(n if n is not None else 1, remaining)
        out: List[Config] = []
        if not self._asked_start:
            self._asked_start = True
            out.append(self.space.project(self.space.default_config()))
        anchor = self._cur or self.space.project(self.space.default_config())
        d = len(self.space)
        while len(out) < k:
            u = self.space.to_unit(anchor)
            prop_u = np.clip(u + self.rng.normal(0, self.cfg.sigma, d), 0, 1)
            out.append(self.space.from_unit(prop_u))
        out = [dict(c) for c in out]
        for c in out:
            self._pending.add(c)
        return out

    def tell(self, configs: Sequence[Config], values: Sequence[float],
             variances: Optional[Sequence[float]] = None):
        configs = [dict(c) for c in configs]
        self.trace.extend(configs, values, variances)
        for c, v in zip(configs, values):
            if not self._match_pending(c):
                continue                     # injected observation
            v = float(v)
            self._told += 1
            if self._cur is None:            # the starting point
                self._cur, self._cur_v = dict(c), v
                continue
            # Metropolis accept on the *current* state only (no history)
            scale = max(float(np.std(self.trace.values)), 1e-9)
            if (v < self._cur_v
                    or self.rng.random() < np.exp(-(v - self._cur_v)
                                                  / (self._t * scale))):
                self._cur, self._cur_v = dict(c), v
            self._t *= self.cfg.cooling


class GeneticStrategy(_StrategyBase):
    """Population evolution.  ``ask`` hands out the un-scored members of
    the current generation; once the generation is fully told, the next
    one is bred (elitism + tournament + uniform crossover + Gaussian
    mutation).  The measurement cost — a whole population per generation —
    is the paper's critique, visible here as large mandatory asks."""

    def __init__(self, space: Space, budget: int,
                 cfg: Optional[GAConfig] = None, seed: Optional[int] = None):
        super().__init__(space)
        self.cfg = cfg or GAConfig()
        if cfg is None and seed is not None:
            self.cfg = replace(self.cfg, seed=seed)
        self.budget = budget
        self.rng = np.random.default_rng(self.cfg.seed)
        d = len(space)
        pop_u = lhs_unit(self.rng, self.cfg.population, d)
        self._pop: List[Config] = [space.from_unit(u) for u in pop_u]
        self._fit: List[Optional[float]] = [None] * len(self._pop)
        self._queue: List[int] = list(range(len(self._pop)))
        self._pending_idx = _PendingSet()    # payload: population index
        self._init_gen = True
        self._told = 0

    @property
    def finished(self) -> bool:
        return self._told >= self.budget

    def ask(self, n: Optional[int] = None) -> List[Config]:
        if self.finished:
            return []
        self._maybe_evolve()
        if not self._queue:
            return []                        # blocked on tells
        k = len(self._queue) if n is None else max(min(n, len(self._queue)), 1)
        if not self._init_gen:
            # the initial population is always scored in full (as the
            # legacy loop did); later generations respect the budget
            remaining = self.budget - self._told - len(self._pending_idx)
            if remaining <= 0:
                return []
            k = min(k, remaining)
        idxs, self._queue = self._queue[:k], self._queue[k:]
        out: List[Config] = []
        for i in idxs:
            c = dict(self._pop[i])
            self._pending_idx.add(c, i)
            out.append(c)
        return out

    def tell(self, configs: Sequence[Config], values: Sequence[float],
             variances: Optional[Sequence[float]] = None):
        configs = [dict(c) for c in configs]
        self.trace.extend(configs, values, variances)
        for c, v in zip(configs, values):
            matched, i = self._pending_idx.pop(c)
            if matched:
                self._fit[i] = float(v)
                self._told += 1
        self._maybe_evolve()

    def _maybe_evolve(self):
        if (self._queue or self._pending_idx
                or any(f is None for f in self._fit)
                or self._told >= self.budget):
            return
        cfg, rng, pop, fit = self.cfg, self.rng, self._pop, self._fit
        d = len(self.space)
        order = np.argsort(fit)
        new_pop: List[Config] = [pop[i] for i in order[:cfg.elite]]
        while len(new_pop) < cfg.population:
            def pick():
                idx = rng.choice(len(pop), size=cfg.tournament, replace=False)
                return pop[min(idx, key=lambda i: fit[i])]
            a, b = self.space.to_unit(pick()), self.space.to_unit(pick())
            mask = rng.random(d) < cfg.crossover_p
            child = np.where(mask, a, b)
            mut = rng.random(d) < cfg.mutation_p
            child = np.clip(child + mut * rng.normal(0, cfg.mutation_sigma, d),
                            0, 1)
            new_pop.append(self.space.from_unit(child))
        self._pop = new_pop[:cfg.population]
        self._fit = [None] * len(self._pop)
        self._queue = list(range(len(self._pop)))
        self._init_gen = False


# ---------------------------------------------------------------------------
# registry: strategies by name (what Sapphire stages and benchmarks use)
# ---------------------------------------------------------------------------

_REGISTRY: Dict[str, Callable[..., SearchStrategy]] = {}


def register_strategy(name: str):
    """Register a strategy factory ``f(space, **kwargs) -> SearchStrategy``
    under ``name``.  Factories must tolerate (ignore) the common kwargs
    ``seed``, ``budget`` and ``batch_size`` so callers can stay generic."""
    def deco(factory):
        _REGISTRY[name] = factory
        return factory
    return deco


def strategy_names() -> Tuple[str, ...]:
    return tuple(sorted(_REGISTRY))


def make_strategy(name: str, space: Space, **kwargs) -> SearchStrategy:
    try:
        factory = _REGISTRY[name]
    except KeyError:
        raise KeyError(f"unknown strategy {name!r}; "
                       f"registered: {strategy_names()}") from None
    return factory(space, **kwargs)


@register_strategy("bo")
def _make_bo(space: Space, cfg: Optional[BOConfig] = None,
             budget: Optional[int] = None, seed: Optional[int] = None,
             batch_size: Optional[int] = None,
             init_configs: Optional[List[Config]] = None, **_) -> BOStrategy:
    if cfg is None:
        cfg = BOConfig(seed=seed if seed is not None else 0)
    if budget is not None:
        # a budget below the design size shrinks the design too, so the
        # strategy never spends more evaluations than asked for
        n_init = min(cfg.n_init, budget)
        cfg = replace(cfg, n_init=n_init, n_iter=budget - n_init)
    if batch_size is not None:
        cfg = replace(cfg, batch_size=batch_size, warm_start=True)
    return BOStrategy(space, cfg, init_configs=init_configs)


@register_strategy("random")
def _make_random(space: Space, budget: Optional[int] = None, seed: int = 0,
                 batch_size: Optional[int] = None, **_) -> RandomStrategy:
    return RandomStrategy(space, budget,
                          seed=seed if seed is not None else 0,
                          batch_size=batch_size)


@register_strategy("sa")
def _make_sa(space: Space, budget: int = 48,
             cfg: Optional[SAConfig] = None,
             seed: Optional[int] = None, **_) -> AnnealingStrategy:
    return AnnealingStrategy(space, budget, cfg, seed=seed)


@register_strategy("ga")
def _make_ga(space: Space, budget: int = 48,
             cfg: Optional[GAConfig] = None,
             seed: Optional[int] = None, **_) -> GeneticStrategy:
    return GeneticStrategy(space, budget, cfg, seed=seed)
