"""SAPPHIRE core, ported to torch: the paper's contribution as a library.

Public API:
    Space / Knob / constraints    (§3.2  — repro_torch.core.space,
                                   .constraints)
    lasso_path / rank             (§3.3  — repro_torch.core.lasso, .ranking)
    gp / SearchStrategy / make_strategy
                                  (§3.4  — repro_torch.core.gp, .strategy)
    EvalRequest / EvalResult / EvaluationService
                                  (Fig 3 — repro_torch.core.service)
    Controller.run / .run_async / EvalDB
                                  (Fig 3 — repro_torch.core.controller)
    Sapphire(...).tune()          (Fig 3 — repro_torch.core.tuner)
    RetryPolicy / ResilientService / CircuitBreaker / FaultPlan /
    FaultInjectingService         (repro_torch.core.resilience, .faults;
                                   the fault-tolerant evaluation layer
                                   and the seeded chaos harness that
                                   tests it)
"""

from repro_torch.core.faults import (FaultInjectingService,  # noqa: F401
                                     FaultPlan)
from repro_torch.core.resilience import (CircuitBreaker,  # noqa: F401
                                         ResilientService, RetryPolicy,
                                         TransientEvalError,
                                         classify_failure)
from repro_torch.core.service import (CallableServiceAdapter,  # noqa: F401
                                      EvalRequest, EvalResult, EvalTicket,
                                      EvaluationService, FidelityRouter,
                                      ImmediateEvaluationService,
                                      WorkerPoolEvaluationService,
                                      as_service)
from repro_torch.core.space import Config, Knob, Space  # noqa: F401
from repro_torch.core.strategy import (SearchStrategy, Trace,  # noqa: F401
                                       make_strategy, strategy_names)
from repro_torch.core.tuner import Sapphire, TuneResult  # noqa: F401
