"""Bayesian optimization entry point (§3.4, Fig 4) — legacy wrapper.

.. deprecated::
    The GP-BO loop now lives in :class:`repro_torch.core.strategy.BOStrategy`
    (ask/tell — it never calls an objective) and the evaluation loop in
    :meth:`repro_torch.core.controller.Controller.run`.  ``minimize`` survives
    as a thin synchronous driver over the strategy so existing callers,
    tests and benchmarks keep working; new code should compose a strategy
    with a Controller instead::

        ctrl = Controller(evaluator, EvalDB())
        strategy = BOStrategy(space, BOConfig(...))
        trace = ctrl.run(strategy)

``BOConfig`` and ``BOTrace`` are re-exported from ``repro_torch.core.strategy``
(where ``BOTrace`` is now the strategy-generic ``Trace``).
"""

from __future__ import annotations

import warnings
from typing import Callable, List, Optional, Sequence, Tuple

from repro_torch.core.space import Config, Space
from repro_torch.core.strategy import (BOConfig, BOStrategy,  # noqa: F401
                                       Trace)

BOTrace = Trace     # legacy name


def minimize(f: Callable[[Config], float], space: Space,
             cfg: Optional[BOConfig] = None,
             init_configs: Optional[List[Config]] = None,
             f_batch: Optional[Callable[[Sequence[Config]],
                                        Sequence[float]]] = None,
             ) -> Tuple[Config, float, BOTrace, Space]:
    """Run GP-BO.  Returns (best config, best value, trace, final space).

    ``cfg.n_iter`` counts *evaluations* after the initial design, so the
    experiment budget is identical for every ``batch_size`` — a q-batch
    run spends the same budget in ~n_iter/q GP refits.

    The returned space reflects any dynamic-boundary enlargements — the
    recommendation report includes the final domain, as the paper's Fig. 4
    experiment does.

    Deprecated wrapper: drives a :class:`BOStrategy` synchronously —
    ``ask`` the next probe batch, score it through ``f`` (or ``f_batch``
    when batching is on), ``tell`` the results.
    """
    warnings.warn(
        "bo.minimize is deprecated: compose a strategy with the experiment "
        "loop instead — Controller(evaluator, EvalDB()).run(BOStrategy("
        "space, cfg)) (or Controller.run_async for the overlapped loop)",
        DeprecationWarning, stacklevel=2)
    cfg = cfg or BOConfig()
    use_batch = cfg.batch_size > 1 and f_batch is not None
    strat = BOStrategy(space, cfg, init_configs=init_configs)
    try:
        while not strat.finished:
            probes = strat.ask()
            if not probes:
                break
            if use_batch:
                values = f_batch(probes)
            else:
                values = [float(f(c)) for c in probes]
            strat.tell(probes, values)
    finally:
        # refit_async spawns a background executor (possibly pinned to a
        # spare device); legacy callers never see the strategy, so the
        # wrapper owns the join.
        strat.close()
    best_c, best_v = strat.best()
    return best_c, best_v, strat.trace, strat.space
