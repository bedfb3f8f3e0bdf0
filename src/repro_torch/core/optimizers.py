"""Black-box optimizer baselines the paper compares against BO (§3.4).

.. deprecated::
    The algorithms now live in :mod:`repro_torch.core.strategy` as ask/tell
    strategies (:class:`RandomStrategy`, :class:`AnnealingStrategy`,
    :class:`GeneticStrategy`) that never call an objective; these
    functions survive as thin synchronous drivers so existing callers
    keep working.  New code should drive a strategy through
    :meth:`repro_torch.core.controller.Controller.run`.

* random_search       — sanity floor;
* simulated_annealing — memoryless Metropolis walk; the paper's critique is
  exactly that it "does not learn from the old experience";
* genetic_algorithm   — population evolution; the paper's critique is the
  measurement cost (a whole population per generation).

All share the objective interface of ``bo.minimize`` (lower is better) and
return a compatible trace, so the Fig.-style optimizer-comparison benchmark
plots them side by side under identical evaluation budgets and noise.
"""

from __future__ import annotations

import warnings
from typing import Callable, Optional, Tuple

from repro_torch.core.space import Config, Space
from repro_torch.core.strategy import (  # noqa: F401
    AnnealingStrategy, GAConfig, GeneticStrategy, RandomStrategy, SAConfig,
    SearchStrategy, Trace)

BOTrace = Trace     # legacy name


def _drive(strategy: SearchStrategy,
           f: Callable[[Config], float]) -> Tuple[Config, float, Trace]:
    """Synchronous closed loop: ask the strategy's preferred batch, score
    each config through ``f``, tell, repeat until the budget is told."""
    warnings.warn(
        f"optimizers.* wrappers are deprecated: drive the strategy through "
        f"the experiment loop instead — Controller(evaluator, EvalDB())"
        f".run(make_strategy(..., space, budget=...)) replaces this "
        f"{type(strategy).__name__} closed loop (Controller.run_async for "
        f"the overlapped version)",
        DeprecationWarning, stacklevel=3)
    while not strategy.finished:
        cfgs = strategy.ask()
        if not cfgs:
            break
        strategy.tell(cfgs, [float(f(c)) for c in cfgs])
    best_c, best_v = strategy.best()
    return best_c, best_v, strategy.trace


def random_search(f: Callable[[Config], float], space: Space, budget: int,
                  seed: int = 0) -> Tuple[Config, float, Trace]:
    return _drive(RandomStrategy(space, budget, seed=seed), f)


def simulated_annealing(f: Callable[[Config], float], space: Space,
                        budget: int, cfg: Optional[SAConfig] = None
                        ) -> Tuple[Config, float, Trace]:
    return _drive(AnnealingStrategy(space, budget, cfg), f)


def genetic_algorithm(f: Callable[[Config], float], space: Space,
                      budget: int, cfg: Optional[GAConfig] = None
                      ) -> Tuple[Config, float, Trace]:
    return _drive(GeneticStrategy(space, budget, cfg), f)
