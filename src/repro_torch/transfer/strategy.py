"""`TransferBOStrategy`: BO warm-started from a multi-task corpus prior.

The transfer mechanism has three prongs, all riding existing machinery:

* **hyperparameter warm start** — the corpus multi-task GP's shared
  base-kernel triple (:func:`repro_torch.core.gp.shared_params`) seeds the new
  workload's GP, so the first real fit starts from lengthscales learned
  across the whole workload family instead of the 0.3-isotropic default;
* **design seeding** — each corpus task's best configs go to the front
  of the initial design (:func:`repro_torch.core.sampling.init_design` places
  caller configs before the LHS fill), so the very first evaluations
  probe where sibling workloads found their optima;
* **pseudo-observations** — the stacked prior's predictions at the
  corpus-best anchors enter the GP's training set with inflated
  variance, through the same heteroscedastic ``obs_var`` channel
  replicated measurements use.  They live only in
  :meth:`~repro_torch.core.strategy.BOStrategy._training_data` — never in the
  trace — so ``best()`` and the budget see exclusively real
  measurements, and their variance grows exponentially with the real
  observation count: the prior fades exactly as evidence accumulates.

With an **empty corpus** every prong is inert: no seeds, no prior, no
pseudo rows, no extra RNG draws — the strategy is trace-identical to
plain :class:`~repro_torch.core.strategy.BOStrategy` at equal seed (asserted
by tests and the ``perf_transfer`` benchmark gate).
"""

from __future__ import annotations

import math
from dataclasses import replace
from typing import List, Optional, Tuple

import numpy as np

from repro_torch.core import gp
from repro_torch.core.space import Config, Space
from repro_torch.core.strategy import (BOConfig, BOStrategy, _config_key,
                                       register_strategy)
from repro_torch.transfer.corpus import TransferCorpus


class _CorpusPrior:
    """The fitted corpus model behind one uniform ``predict`` surface.

    Multi-workload corpora fit the ICM multi-task GP and predict through
    the stacked (unseen-task) prior; a single-workload corpus falls back
    to the exact single-task path (:func:`repro_torch.core.gp.fit` drops
    the task column itself) and predicts that task directly.  The fit and
    the predictions run on the strategy's ``cfg.device``, through the
    Gram kernels when ``cfg.use_kernel``."""

    def __init__(self, corpus: TransferCorpus, kernel: str,
                 log_objective: bool, fit_steps: int,
                 max_per_task: Optional[int], use_kernel: bool = False,
                 device="cuda"):
        x, y, var, tasks = corpus.stacked(log_objective=log_objective,
                                          max_per_task=max_per_task)
        obs = var if np.any(var > 0) else None
        self.n_tasks = corpus.n_tasks
        self.kernel = kernel
        self.use_kernel = use_kernel
        self.state = gp.fit(x, y, kernel, steps=fit_steps, obs_var=obs,
                            tasks=tasks, pad=False, use_kernel=use_kernel,
                            device=device)
        self.multitask = isinstance(self.state, gp.MTGPState)

    @property
    def shared_params(self) -> gp.GPParams:
        return (gp.shared_params(self.state.params) if self.multitask
                else self.state.params)

    def predict(self, xq: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        """Stacked-prior mean/std at unit-cube rows ``xq`` (modeling
        scale — log objective when the corpus was stacked that way)."""
        if self.multitask:
            mu, sd = gp.predict_multitask(self.state, xq, task=None,
                                          kind=self.kernel,
                                          use_kernel=self.use_kernel)
        else:
            mu, sd = gp.predict(self.state, np.asarray(xq, np.float32),
                                self.kernel, use_kernel=self.use_kernel)
        return (mu.cpu().numpy().astype(np.float64),
                sd.cpu().numpy().astype(np.float64))


class TransferBOStrategy(BOStrategy):
    """:class:`BOStrategy` + a cross-workload corpus prior.

    Parameters beyond the base strategy's:

    ``corpus``
        A :class:`~repro_torch.transfer.corpus.TransferCorpus` over this
        strategy's space (or ``None`` / empty — plain BO).
    ``n_pseudo``
        Pseudo-observation budget: stacked-prior predictions at the
        corpus tasks' best configs (deduplicated, round-robin across
        tasks best-first).
    ``pseudo_var_inflation``
        Multiplier on the prior's predictive variance for pseudo rows —
        a pseudo observation starts life as a deliberately noisy
        measurement, so one real probe at the same config immediately
        dominates it.
    ``decay_tau``
        e-folding scale (in real observations) of the pseudo variance:
        ``var(n) = var0 · exp(n / tau)``.  Default: the design size, so
        the prior carries the design phase and fades through the BO
        rounds.
    ``seed_top_k``
        How many corpus-best configs to plant in the initial design
        (default: half the design, at most one per corpus task).
    """

    def __init__(self, space: Space, cfg: Optional[BOConfig] = None,
                 corpus: Optional[TransferCorpus] = None,
                 init_configs: Optional[List[Config]] = None,
                 n_pseudo: int = 16,
                 pseudo_var_inflation: float = 4.0,
                 decay_tau: Optional[float] = None,
                 seed_top_k: Optional[int] = None,
                 corpus_fit_steps: int = 200,
                 max_per_task: Optional[int] = 64):
        cfg = cfg or BOConfig()
        self._prior: Optional[_CorpusPrior] = None
        self._pseudo_configs: List[Config] = []
        self._pseudo_values: List[float] = []
        self._pseudo_var0: List[float] = []
        seeds = list(init_configs or [])
        if corpus is not None and corpus.n_tasks > 0:
            if set(corpus.space.names) != set(space.names):
                raise ValueError(
                    "TransferBOStrategy: corpus space does not match the "
                    "strategy space (different knob sets)")
            self._prior = _CorpusPrior(corpus, cfg.kernel,
                                       cfg.log_objective, corpus_fit_steps,
                                       max_per_task, cfg.use_kernel,
                                       cfg.device)
            if seed_top_k is None:
                seed_top_k = min(corpus.n_tasks, max(cfg.n_init // 2, 1))
            for c in corpus.best_configs(per_task=1)[:seed_top_k]:
                seeds.append(space.project(c))
            self._build_pseudo(space, corpus, cfg, n_pseudo,
                               pseudo_var_inflation)
        super().__init__(space, cfg, init_configs=seeds or None)
        self._decay_tau = float(decay_tau if decay_tau is not None
                                else max(self._n_init, 4))
        if self._prior is not None:
            # the corpus-shared base kernel is the warm-start carry from
            # round one; _fit_args below keeps feeding it back even when
            # cfg.warm_start is off
            self._params = self._prior.shared_params

    # -- prior construction ---------------------------------------------------

    def _build_pseudo(self, space: Space, corpus: TransferCorpus,
                      cfg: BOConfig, n_pseudo: int,
                      inflation: float) -> None:
        if n_pseudo <= 0:
            return
        per_task = -(-n_pseudo // corpus.n_tasks)
        anchors: List[Config] = []
        seen = set()
        for c in corpus.best_configs(per_task=per_task):
            c = space.project(c)
            key = _config_key(c)
            if key in seen:
                continue
            seen.add(key)
            anchors.append(c)
            if len(anchors) >= n_pseudo:
                break
        if not anchors:
            return
        xq = space.encode_batch(anchors).astype(np.float32)
        mu, sd = self._prior.predict(xq)
        if cfg.log_objective:
            # modeling scale is log y: map the prior back to raw units,
            # variances through the inverse delta method (var_raw ≈
            # var_log · y²) so BOStrategy's forward transform lands on
            # exactly the prior's log-scale uncertainty
            y_raw = np.exp(np.clip(mu, -50.0, 50.0))
            var_raw = (sd ** 2) * inflation * y_raw ** 2
        else:
            y_raw = mu
            var_raw = (sd ** 2) * inflation
        self._pseudo_configs = anchors
        self._pseudo_values = [float(v) for v in y_raw]
        self._pseudo_var0 = [max(float(v), 1e-12) for v in var_raw]

    # -- BOStrategy hooks -----------------------------------------------------

    def _fit_args(self):
        warm, steps = super()._fit_args()
        if warm is None and self._prior is not None:
            # without cfg.warm_start the base strategy refits cold every
            # round; the transfer prior still deserves to seed the Adam
            # loop (full step count, so the data can overrule it)
            warm = self._params
        return warm, steps

    def _training_data(self):
        if not self._pseudo_configs:
            return super()._training_data()
        n_real = len(self.trace.values)
        growth = math.exp(min(n_real / self._decay_tau, 50.0))
        pseudo_var = [v * growth for v in self._pseudo_var0]
        return (list(self.trace.configs) + self._pseudo_configs,
                list(self.trace.values) + self._pseudo_values,
                list(self.trace.variances) + pseudo_var)


@register_strategy("transfer_bo")
def _make_transfer_bo(space: Space, cfg: Optional[BOConfig] = None,
                      budget: Optional[int] = None,
                      seed: Optional[int] = None,
                      batch_size: Optional[int] = None,
                      corpus: Optional[TransferCorpus] = None,
                      init_configs: Optional[List[Config]] = None,
                      n_pseudo: int = 16,
                      pseudo_var_inflation: float = 4.0,
                      decay_tau: Optional[float] = None,
                      seed_top_k: Optional[int] = None,
                      corpus_fit_steps: int = 200,
                      max_per_task: Optional[int] = 64,
                      **_) -> TransferBOStrategy:
    if cfg is None:
        cfg = BOConfig(seed=seed if seed is not None else 0)
    if budget is not None:
        n_init = min(cfg.n_init, budget)
        cfg = replace(cfg, n_init=n_init, n_iter=budget - n_init)
    if batch_size is not None:
        cfg = replace(cfg, batch_size=batch_size, warm_start=True)
    return TransferBOStrategy(
        space, cfg, corpus=corpus, init_configs=init_configs,
        n_pseudo=n_pseudo, pseudo_var_inflation=pseudo_var_inflation,
        decay_tau=decay_tau, seed_top_k=seed_top_k,
        corpus_fit_steps=corpus_fit_steps, max_per_task=max_per_task)
