"""The port's ask/tell strategies against the JAX reference.

The baselines (random LHS, annealing, genetic) are numpy on the host in
both packages, so their traces must be identical.  For GP-BO the design
and the candidate pools are numpy too; the first BO round's picks must be
identical, and a ``state_dict`` snapshot must load across the packages in
both directions.
"""

import json

import pytest
import torch

from repro.core import strategy as rs
from repro.core.space import Knob as RKnob
from repro.core.space import Space as RSpace
from repro_torch.core import strategy as ps
from repro_torch.core.space import Knob, Space


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _spaces():
    def mk(K, S):
        return S((K("x", "float", 0.5, lo=0.0, hi=1.0),
                  K("y", "float", 0.5, lo=0.0, hi=1.0, dynamic_bound=True),
                  K("k", "int", 4, lo=1, hi=16),
                  K("c", "categorical", "a", choices=("a", "b", "c"))))
    return mk(Knob, Space), mk(RKnob, RSpace)


def _f(c):
    return ((c["x"] - 0.7) ** 2 + (c["y"] - 0.95) ** 2
            + 0.01 * c["k"] + (0.3 if c["c"] == "b" else 0.0))


def _drive(strategy, rounds=None):
    i = 0
    while not strategy.finished and (rounds is None or i < rounds):
        cfgs = strategy.ask()
        if not cfgs:
            break
        strategy.tell(cfgs, [float(_f(c)) for c in cfgs])
        i += 1
    return strategy


@pytest.mark.parametrize("name", ["random", "sa", "ga"])
def test_baseline_traces_identical(name):
    pspace, rspace = _spaces()
    p = _drive(ps.make_strategy(name, pspace, budget=24, seed=3,
                                batch_size=4))
    r = _drive(rs.make_strategy(name, rspace, budget=24, seed=3,
                                batch_size=4))
    assert p.trace.configs == r.trace.configs
    assert p.trace.values == r.trace.values


def _bo_pair(q=3, **kw):
    pspace, rspace = _spaces()
    common = dict(n_init=4, n_iter=9, batch_size=q, n_candidates=64,
                  fit_steps=20, seed=7, **kw)
    return (ps.BOStrategy(pspace, ps.BOConfig(device="cpu", **common)),
            rs.BOStrategy(rspace, rs.BOConfig(**common)))


@pytest.mark.parametrize("q", [1, 3])
def test_bo_design_and_first_round_identical(q):
    p, r = _bo_pair(q)
    _drive(p, rounds=2)                  # the design, then one BO round
    _drive(r, rounds=2)
    assert p.trace.configs == r.trace.configs
    assert p.trace.boundary_events == r.trace.boundary_events
    assert p.space.knob("y").hi == r.space.knob("y").hi


def test_state_dict_loads_across_packages():
    p, r = _bo_pair(3, warm_start=True)
    _drive(r, rounds=2)
    sd_ref = json.loads(json.dumps(r.state_dict()))
    p_new, r_new = _bo_pair(3, warm_start=True)
    p_new.load_state(sd_ref)             # reference snapshot -> port
    assert json.loads(json.dumps(p_new.state_dict())) == sd_ref
    r_new.load_state(json.loads(json.dumps(p_new.state_dict())))
    assert json.loads(json.dumps(r_new.state_dict())) == sd_ref
    # both resume from the snapshot on the same numpy design stream
    assert p_new.trace.configs == r.trace.configs
    assert p_new._params is not None
    _drive(p_new)
    assert p_new.finished and len(p_new.trace.values) == 4 + 9


def test_port_snapshot_loads_into_reference():
    p, _ = _bo_pair(3, warm_start=True)
    _drive(p, rounds=3)
    sd = json.loads(json.dumps(p.state_dict()))
    _, r_new = _bo_pair(3, warm_start=True)
    r_new.load_state(sd)
    assert json.loads(json.dumps(r_new.state_dict())) == sd
    _drive(r_new)
    assert r_new.finished


def test_refit_async_runs_on_the_strategy_device():
    p, _ = _bo_pair(3, refit_async=True)
    assert p._refit_device() == torch.device("cpu")
    _drive(p)
    p.close()
    assert p.finished and len(p.trace.values) == 4 + 9
    assert p._posterior[0].x.device == torch.device("cpu")


def test_shard_candidates_is_not_ported_yet():
    pspace, _ = _spaces()
    with pytest.raises(NotImplementedError, match="item 12"):
        ps.BOStrategy(pspace, ps.BOConfig(shard_candidates=True,
                                          device="cpu"))


def test_measurement_variance_matches_reference():
    p, r = _bo_pair(3)
    _drive(p, rounds=2)
    _drive(r, rounds=2)
    cfg = p.trace.configs[-1]
    got, want = p.measurement_variance(cfg), r.measurement_variance(cfg)
    assert got == pytest.approx(want, rel=0.05)
