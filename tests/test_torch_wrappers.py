"""The port's deprecated closed-loop wrappers (``core/bo.py``'s
``minimize`` and ``core/optimizers.py``'s ``random_search`` /
``simulated_annealing`` / ``genetic_algorithm``) are thin drivers: each
one's trace equals its ask/tell strategy driven by a ``Controller`` on
the same objective, bit for bit, and (for the numpy baselines) the
reference wrapper's trace.  GP-BO runs on ``device="cpu"``."""

import warnings

import pytest
import torch

from repro_torch.core import bo, optimizers
from repro_torch.core.controller import Controller, EvalDB
from repro_torch.core.space import Knob, Space
from repro_torch.core.strategy import (AnnealingStrategy, BOConfig,
                                       BOStrategy, GAConfig, GeneticStrategy,
                                       RandomStrategy, SAConfig)


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _space(K=Knob, S=Space):
    return S((K("x", "float", 0.5, lo=0.0, hi=1.0),
              K("y", "float", 0.5, lo=0.0, hi=1.0, dynamic_bound=True),
              K("k", "int", 4, lo=1, hi=16)))


def _f(c):
    return (c["x"] - 0.7) ** 2 + (c["y"] - 0.95) ** 2 + 0.01 * c["k"]


def _equal(a, b):
    assert a.configs == b.configs
    assert a.values == b.values
    assert a.best_values == b.best_values


def _quiet(fn, *a, **k):
    with pytest.warns(DeprecationWarning):
        return fn(*a, **k)


@pytest.mark.parametrize("batch_size", [1, 3])
def test_minimize_is_bo_strategy_under_a_controller(batch_size):
    cfg = BOConfig(n_init=4, n_iter=8, batch_size=batch_size,
                   n_candidates=64, fit_steps=15, seed=2, device="cpu")
    best_c, best_v, trace, space = _quiet(
        bo.minimize, _f, _space(), cfg,
        f_batch=lambda cs: [_f(c) for c in cs])
    strat = BOStrategy(_space(), cfg)
    want = Controller(_f, EvalDB()).run(strat)
    _equal(trace, want)
    assert (best_c, best_v) == strat.best()
    assert space == strat.space


BASELINES = {
    "random": (lambda: (optimizers.random_search, (20,), {"seed": 3}),
               lambda: RandomStrategy(_space(), 20, seed=3)),
    "sa": (lambda: (optimizers.simulated_annealing, (20, SAConfig(seed=3)),
                    {}),
           lambda: AnnealingStrategy(_space(), 20, SAConfig(seed=3))),
    "ga": (lambda: (optimizers.genetic_algorithm, (26, GAConfig(seed=3)),
                    {}),
           lambda: GeneticStrategy(_space(), 26, GAConfig(seed=3)))}


@pytest.mark.parametrize("name", sorted(BASELINES))
def test_optimizer_wrapper_is_its_strategy_under_a_controller(name):
    wrapper, make = BASELINES[name]
    fn, args, kw = wrapper()
    best_c, best_v, trace = _quiet(fn, _f, _space(), *args, **kw)
    strat = make()
    _equal(trace, Controller(_f, EvalDB()).run(strat))
    assert (best_c, best_v) == strat.best()


@pytest.mark.parametrize("name", ["random_search", "simulated_annealing",
                                  "genetic_algorithm"])
def test_optimizer_wrapper_trace_equals_the_reference(name):
    from repro.core import optimizers as ropt
    from repro.core.space import Knob as RKnob
    from repro.core.space import Space as RSpace
    args = {"random_search": ((20,), {"seed": 4}),
            "simulated_annealing": ((20,), {}),
            "genetic_algorithm": ((26,), {})}[name]
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        _, _, mine = getattr(optimizers, name)(_f, _space(), *args[0],
                                                **args[1])
        _, _, ref = getattr(ropt, name)(_f, _space(RKnob, RSpace), *args[0],
                                        **args[1])
    _equal(mine, ref)
