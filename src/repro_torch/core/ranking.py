"""Parameter-importance ranking (paper §3.3).

Pipeline:  sample the clean domain (LHS, ~300 configs — the paper's budget)
  -> evaluate each on the test-cluster evaluator (noisy)
  -> preprocess:  categorical -> dummy variables;  numeric + target ->
     ``log1p`` (the paper's normalization: same order of magnitude,
     variance-stabilized)
  -> Lasso path -> per-feature importance (area under |β(λ)|)
  -> fold dummy groups back to their knob (max over group)
  -> rank, return the top-K sub-space.

The returned :class:`RankingResult` carries the full importance curve so
the Fig.-6 benchmark can plot the drastic drop-off.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import (TYPE_CHECKING, Callable, Dict, List, Optional, Sequence,
                    Tuple)

import numpy as np

from repro_torch.core.evaluators import evaluate_many
from repro_torch.core.lasso import lasso_path, path_importance
from repro_torch.core.sampling import latin_hypercube
from repro_torch.core.space import Config, Space

if TYPE_CHECKING:      # pragma: no cover - import cycle guard (controller
    from repro_torch.core.controller import Controller      # imports evaluators)


# ---------------------------------------------------------------------------
# preprocessing (paper §3.3: dummy encoding + log1p)
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class FeatureMap:
    """Expanded design-matrix layout: feature j -> owning knob index."""
    columns: Tuple[str, ...]
    owner: Tuple[int, ...]       # knob index per column


def encode(space: Space, configs: Sequence[Config]) -> Tuple[np.ndarray, FeatureMap]:
    cols: List[str] = []
    owner: List[int] = []
    feats: List[np.ndarray] = []
    for ki, k in enumerate(space.knobs):
        vals = [c[k.name] for c in configs]
        if k.kind == "categorical":
            # dummy variables, one per category (paper: n binary params)
            for choice in k.choices:
                cols.append(f"{k.name}={choice}")
                owner.append(ki)
                feats.append(np.array([1.0 if v == choice else 0.0
                                       for v in vals]))
        elif k.kind == "bool":
            cols.append(k.name)
            owner.append(ki)
            feats.append(np.array([1.0 if v else 0.0 for v in vals]))
        else:
            cols.append(k.name)
            owner.append(ki)
            x = np.array([float(v) for v in vals])
            # log1p on magnitudes (sign-preserving for rare negatives)
            feats.append(np.sign(x) * np.log1p(np.abs(x)))
    return np.stack(feats, axis=1), FeatureMap(tuple(cols), tuple(owner))


def encode_target(y: Sequence[float]) -> np.ndarray:
    return np.log1p(np.asarray(y, np.float64))


# ---------------------------------------------------------------------------
# ranking
# ---------------------------------------------------------------------------

@dataclass
class RankingResult:
    space: Space
    importance: np.ndarray           # [n_knobs], descending NOT sorted
    order: np.ndarray                # knob indices sorted by importance desc
    feature_importance: np.ndarray   # [n_features] raw per-column
    fmap: FeatureMap
    samples: List[Config]
    values: List[float]

    def top(self, k: int) -> List[str]:
        return [self.space.knobs[i].name for i in self.order[:k]]

    def top_space(self, k: int) -> Space:
        return self.space.subset(self.top(k))

    def table(self, k: int = 16) -> List[Dict[str, object]]:
        """Paper Table-2 style rows for the top-k knobs."""
        rows = []
        for i in self.order[:k]:
            kn = self.space.knobs[i]
            rng = (f"[{kn.lo:g}, {kn.hi:g}]" if kn.kind in ("int", "float")
                   else "|".join(str(c) for c in (kn.choices or ("True", "False"))))
            if kn.dynamic_bound:
                rng += " (dynamic)"
            rows.append({
                "knob": kn.name, "type": kn.kind, "default": kn.default,
                "range": rng, "module": kn.module,
                "importance": float(self.importance[i]),
                "description": kn.description,
            })
        return rows


def rank(space: Space, evaluate: Callable[[Config], float],
         n_samples: int = 300, seed: int = 0,
         samples: Optional[List[Config]] = None,
         values: Optional[List[float]] = None,
         stability_rounds: int = 0,
         batch_size: int = 1, device="cuda") -> RankingResult:
    """Run the §3.3 pipeline.  Pass pre-collected (samples, values) to rank
    an existing evaluation database without new experiments.

    ``batch_size > 1`` scores the LHS design as that many-config batches
    through the evaluator's ``evaluate_batch`` (one vmapped cost-model
    sweep + one DB append per chunk) instead of n_samples sequential
    calls — the test cluster can bench configs concurrently, so the 300
    ranking experiments collapse to a handful of batch rounds.

    ``device`` is where the lasso path is solved; sampling and scoring
    are host work.

    ``stability_rounds > 0`` enables **stability selection** (beyond-paper,
    Meinshausen & Bühlmann 2010): the lasso path is refit on that many
    half-subsamples and each feature's importance is multiplied by its
    selection frequency among early entrants — pure-noise features that
    only enter on lucky subsamples are suppressed.  The paper's plain
    single-fit ranking is the default (rounds = 0).
    """
    if samples is None:
        samples = latin_hypercube(space, n_samples, seed=seed)
    if values is None:
        if batch_size > 1:
            values = []
            for i in range(0, len(samples), batch_size):
                values.extend(evaluate_many(evaluate,
                                            samples[i:i + batch_size]))
        else:
            values = [float(evaluate(c)) for c in samples]

    x, fmap = encode(space, samples)
    y = encode_target(values)
    lams, betas = lasso_path(x, y, device=device)
    fimp = path_importance(lams, betas)

    if stability_rounds > 0:
        rng = np.random.default_rng(seed)
        n = x.shape[0]
        hits = np.zeros(x.shape[1])
        for _ in range(stability_rounds):
            idx = rng.choice(n, size=n // 2, replace=False)
            ls, bs = lasso_path(x[idx], y[idx], n_lambdas=30,
                                  device=device)
            early = np.abs(bs[: len(ls) // 3]).max(axis=0) > 1e-8
            hits += early
        fimp = fimp * (hits / stability_rounds)

    n_knobs = len(space)
    imp = np.zeros(n_knobs)
    for col, ki in enumerate(fmap.owner):
        imp[ki] = max(imp[ki], fimp[col])   # fold dummies to their knob
    order = np.argsort(-imp, kind="stable")
    return RankingResult(space, imp, order, fimp, fmap,
                         list(samples), list(values))


def rank_with_controller(space: Space, controller: "Controller",
                         n_samples: int = 300, seed: int = 0,
                         batch_size: Optional[int] = None,
                         strategy: str = "random",
                         stability_rounds: int = 0,
                         async_eval: bool = False,
                         max_in_flight: Optional[int] = None,
                         min_ask: int = 1,
                         device="cuda") -> RankingResult:
    """The §3.3 ranking stage as strategy + experiment loop: a design
    strategy from the registry (LHS by default) is driven through the
    controller's evaluation service — every design batch is one tagged DB
    append — and the resulting trace feeds the Lasso-path ranking.  The
    samples and values are identical to :func:`rank` under the same seed
    (the evaluator noise stream is indexed per evaluation, not per batch
    shape).  ``async_eval`` drives the design through the overlapped
    :meth:`~repro_torch.core.controller.Controller.run_async` loop — a design
    strategy never blocks on ``tell``, so the whole LHS streams through
    the service as fast as it completes (identical samples/values on the
    immediate analytic service).  Failed evaluations are *excluded* from
    the Lasso fit on the async path: the penalty values the strategy is
    told would otherwise enter the regression as huge outliers."""
    from repro_torch.core.strategy import make_strategy   # lazy: avoid cycle
    strat = make_strategy(strategy, space, budget=n_samples, seed=seed,
                          batch_size=batch_size)
    if async_eval:
        n0 = len(controller.db)
        controller.run_async(strat, batch_size=batch_size,
                             max_in_flight=max_in_flight, min_ask=min_ask)
        ok = [r for r in controller.db.records[n0:] if r.ok]
        samples = [dict(r.config) for r in ok]
        values = [r.value for r in ok]
    else:
        trace = controller.run(strat)
        samples, values = trace.configs, trace.values
    return rank(space, None, samples=samples, values=values,
                seed=seed, stability_rounds=stability_rounds, device=device)
