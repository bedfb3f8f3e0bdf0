"""``repro_torch.core.faults`` and the resilience layer on the CPU: the
reference's fault-injection cases run through the port (seeded chaos is
bit-replayable, retries recover transient faults without inflating the
evaluation count, watchdogs unwedge hung probes, the circuit breaker
sheds load, the EvalDB self-heals crash-truncated logs), then:

* a ``FaultPlan`` makes the same decisions as the reference's for the
  same request stream (its coins are a blake2s of the request, so this
  is bit-exact), and a ``FaultInjectingService`` injects the same faults
  in the same places;
* a GP-BO run (``device="cpu"``) at 20 % transient faults has the trace
  of the fault-free run, bit for bit.

Every test runs under the reference's 120 s SIGALRM watchdog: a wedged
gather/drain fails one test instead of hanging the suite.
"""

import signal
import time
import warnings

import pytest
import torch

from repro_torch.core import faults
from repro_torch.core.controller import Controller, EvalDB, EvalRecord
from repro_torch.core.faults import FaultInjectingService, FaultPlan
from repro_torch.core.replication import ReplicationPolicy
from repro_torch.core.resilience import (CircuitBreaker, ResilientService,
                                         RetryPolicy, TransientEvalError,
                                         classify_failure)
from repro_torch.core.service import (CallableServiceAdapter, EvalRequest,
                                      EvalResult, EvalTicket)
from repro_torch.core.space import Knob, Space
from repro_torch.core.strategy import BOConfig, make_strategy

WATCHDOG_S = 120


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _watchdog():
    if not hasattr(signal, "SIGALRM"):
        yield
        return

    def _fire(signum, frame):
        raise TimeoutError(f"faults test exceeded {WATCHDOG_S}s "
                           "(deadlocked gather/poll?)")

    old = signal.signal(signal.SIGALRM, _fire)
    signal.alarm(WATCHDOG_S)
    try:
        yield
    finally:
        signal.alarm(0)
        signal.signal(signal.SIGALRM, old)


def _space():
    return Space((Knob("x", "float", 5.0, lo=0.0, hi=10.0),))


def _f(c):
    return (c["x"] - 3.0) ** 2


def _reqs(n, seed0=100):
    return [EvalRequest({"x": float(i)}, seed=seed0 + i) for i in range(n)]


FAST = RetryPolicy(max_attempts=5, backoff_s=0.0)


# ---------------------------------------------------------------------------
# failure classification
# ---------------------------------------------------------------------------

def _failed_result(exc=None, error="", error_kind=""):
    t = EvalTicket(0, EvalRequest({"x": 0.0}))
    return EvalResult(t, float("nan"), status="failed", feasible=False,
                      error=error or (repr(exc) if exc else ""),
                      exception=exc, error_kind=error_kind)


class TestClassifyFailure:
    def test_explicit_stamp_wins(self):
        r = _failed_result(exc=ValueError("boom"), error_kind="transient")
        assert classify_failure(r) == "transient"

    @pytest.mark.parametrize("exc", [
        TransientEvalError("x"), TimeoutError("x"),
        ConnectionResetError("x"), BrokenPipeError("x")])
    def test_transient_types(self, exc):
        assert classify_failure(_failed_result(exc=exc)) == "transient"

    @pytest.mark.parametrize("msg", [
        "benchmark timed out after 300s", "Connection reset by peer",
        "worker died mid-probe", "service temporarily unavailable"])
    def test_transient_patterns(self, msg):
        assert classify_failure(_failed_result(error=msg)) == "transient"

    @pytest.mark.parametrize("exc", [
        ValueError("invalid tile size"), KeyError("no backend"),
        FileNotFoundError("missing")])
    def test_permanent_default(self, exc):
        assert classify_failure(_failed_result(exc=exc)) == "permanent"


# ---------------------------------------------------------------------------
# FaultPlan determinism
# ---------------------------------------------------------------------------

class TestFaultPlan:
    def test_seeded_coins_replay(self):
        p1 = FaultPlan(transient_rate=0.3, seed=7)
        p2 = FaultPlan(transient_rate=0.3, seed=7)
        draws1 = [p1.draw(str(k), o) for k in range(50) for o in range(3)]
        draws2 = [p2.draw(str(k), o) for k in range(50) for o in range(3)]
        assert draws1 == draws2
        assert any(d == "transient" for d in draws1)
        assert any(d is None for d in draws1)

    def test_different_seed_different_stream(self):
        a = [FaultPlan(transient_rate=0.3, seed=1).draw(str(k), 0)
             for k in range(64)]
        b = [FaultPlan(transient_rate=0.3, seed=2).draw(str(k), 0)
             for k in range(64)]
        assert a != b

    def test_occurrence_folds_in(self):
        # a retried request draws a FRESH coin: the same key is not
        # deterministically re-failed on every occurrence
        p = FaultPlan(transient_rate=0.5, seed=3)
        per_key = [[p.coin("transient", str(k), o) for o in range(8)]
                   for k in range(16)]
        assert any(len(set(row)) == 2 for row in per_key)

    def test_rate_bounds_validated(self):
        with pytest.raises(ValueError):
            FaultPlan(transient_rate=1.5)

    def test_rate_extremes(self):
        assert FaultPlan().draw("k", 0) is None
        assert FaultPlan(transient_rate=1.0).draw("k", 0) == "transient"


# ---------------------------------------------------------------------------
# the chaos wrapper + retry wrapper together
# ---------------------------------------------------------------------------

class TestResilientService:
    def test_passthrough_no_faults(self):
        svc = ResilientService(CallableServiceAdapter(_f), FAST)
        rs = svc.gather(svc.submit(_reqs(4)))
        assert all(r.ok and r.attempts == 1 for r in rs)
        assert svc.retries == 0

    def test_transient_faults_recovered(self):
        chaos = FaultInjectingService(
            CallableServiceAdapter(_f), FaultPlan(transient_rate=0.5,
                                                  seed=7))
        svc = ResilientService(chaos, RetryPolicy(max_attempts=12,
                                                  backoff_s=0.0))
        rs = svc.gather(svc.submit(_reqs(20)))
        assert all(r.ok for r in rs)
        assert any(r.attempts > 1 for r in rs)
        assert svc.retries == chaos.injected["transient"] > 0
        # recovered values match the fault-free objective exactly
        for r in rs:
            assert r.value == _f(r.request.config)

    def test_worker_death_classified_and_recovered(self):
        chaos = FaultInjectingService(
            CallableServiceAdapter(_f), FaultPlan(death_rate=0.4, seed=5))
        svc = ResilientService(chaos, RetryPolicy(max_attempts=12,
                                                  backoff_s=0.0))
        rs = svc.gather(svc.submit(_reqs(16)))
        assert all(r.ok for r in rs)
        assert chaos.injected["death"] > 0

    def test_permanent_failure_not_retried(self):
        def broken(c):
            raise ValueError("config rejects itself")
        svc = ResilientService(CallableServiceAdapter(broken), FAST)
        rs = svc.gather(svc.submit(_reqs(3)))
        assert all(not r.ok and r.error_kind == "permanent"
                   and r.attempts == 1 for r in rs)
        assert svc.retries == 0

    def test_exhausted_attempts_fail_transient(self):
        always = FaultInjectingService(
            CallableServiceAdapter(_f), FaultPlan(transient_rate=1.0,
                                                  seed=1))
        svc = ResilientService(always, RetryPolicy(max_attempts=3,
                                                   backoff_s=0.0))
        rs = svc.gather(svc.submit(_reqs(2)))
        assert all(not r.ok and r.error_kind == "transient"
                   and r.attempts == 3 for r in rs)
        assert svc.exhausted == 2

    def test_retry_count_never_inflates_completions(self):
        chaos = FaultInjectingService(
            CallableServiceAdapter(_f), FaultPlan(transient_rate=0.5,
                                                  seed=9))
        svc = ResilientService(chaos, FAST)
        tickets = svc.submit(_reqs(12))
        rs = svc.drain()
        assert len(rs) == len(tickets) == 12     # one completion per request
        assert svc.in_flight == 0 and svc.ready == 0

    def test_attempt_watchdog_recovers_hangs(self):
        chaos = FaultInjectingService(
            CallableServiceAdapter(_f), FaultPlan(hang_rate=0.4, seed=9))
        svc = ResilientService(chaos, RetryPolicy(
            max_attempts=6, backoff_s=0.0, attempt_timeout_s=0.1))
        t0 = time.monotonic()
        rs = svc.gather(svc.submit(_reqs(10)))
        assert time.monotonic() - t0 < WATCHDOG_S / 2
        assert chaos.injected["hang"] > 0 and svc.timeouts > 0
        assert all(r.ok or r.error_kind == "transient" for r in rs)

    def test_attempt_watchdog_recovers_drops(self):
        chaos = FaultInjectingService(
            CallableServiceAdapter(_f), FaultPlan(drop_rate=0.4, seed=11))
        svc = ResilientService(chaos, RetryPolicy(
            max_attempts=6, backoff_s=0.0, attempt_timeout_s=0.1))
        rs = svc.gather(svc.submit(_reqs(10)))
        assert chaos.injected["drop"] > 0
        assert all(r.ok or r.error_kind == "transient" for r in rs)

    def test_duplicate_completions_dropped_exactly_once(self):
        chaos = FaultInjectingService(
            CallableServiceAdapter(_f), FaultPlan(duplicate_rate=1.0,
                                                  seed=2))
        svc = ResilientService(chaos, FAST)
        rs = svc.drain() + svc.gather(svc.submit(_reqs(8)))
        assert len(rs) == 8 and all(r.ok for r in rs)
        assert chaos.injected["duplicate"] == 8

    def test_latency_spikes_complete_out_of_order(self):
        chaos = FaultInjectingService(
            CallableServiceAdapter(_f),
            FaultPlan(latency_rate=0.5, latency_s=0.05, seed=4))
        svc = ResilientService(chaos, FAST)
        rs = svc.gather(svc.submit(_reqs(10)))
        assert all(r.ok for r in rs) and chaos.injected["latency"] > 0

    def test_deadline_bounds_total_attempts(self):
        always = FaultInjectingService(
            CallableServiceAdapter(_f), FaultPlan(transient_rate=1.0,
                                                  seed=1))
        svc = ResilientService(always, RetryPolicy(
            max_attempts=100, backoff_s=0.05, deadline_s=0.2))
        (r,) = svc.gather(svc.submit(_reqs(1)))
        assert not r.ok and r.attempts < 100

    @staticmethod
    def _seed_spy(seen):
        # request-aware callable: the built-in services pass the request
        # (and with it the measurement seed) to wants_request backends
        def spy(c, request=None):
            seen.append(request.seed)
            if len(seen) == 1:
                raise TransientEvalError("flake")
            return 0.0
        spy.wants_request = True
        return spy

    def test_reseed_attempts_folds_seed(self):
        seen = []
        svc = ResilientService(CallableServiceAdapter(self._seed_spy(seen)),
                               RetryPolicy(max_attempts=2, backoff_s=0.0,
                                           reseed_attempts=True))
        (r,) = svc.gather(svc.submit([EvalRequest({"x": 1.0}, seed=42)]))
        assert r.ok and r.attempts == 2
        assert seen[0] == 42 and seen[1] != 42       # fold-derived

    def test_default_retry_reuses_seed(self):
        seen = []
        svc = ResilientService(CallableServiceAdapter(self._seed_spy(seen)),
                               FAST)
        (r,) = svc.gather(svc.submit([EvalRequest({"x": 1.0}, seed=42)]))
        assert r.ok and seen == [42, 42]             # bit-identity path

    def test_backoff_deterministic_and_bounded(self):
        p = RetryPolicy(backoff_s=0.1, backoff_mult=2.0, max_backoff_s=0.3,
                        jitter=0.5)
        d2 = p.delay_s(7, 2)
        assert d2 == p.delay_s(7, 2)                 # deterministic
        assert 0.05 <= d2 <= 0.15                    # base 0.1 ± 50 %
        assert p.delay_s(7, 10) <= 0.3 * 1.25        # capped
        assert p.delay_s(7, 2) != p.delay_s(8, 2)    # seed-keyed jitter

    def test_requires_service_base(self):
        class NotAService:
            pass
        with pytest.raises(TypeError):
            ResilientService(NotAService())
        with pytest.raises(TypeError):
            FaultInjectingService(NotAService(), FaultPlan())

    def test_release_hung(self):
        chaos = FaultInjectingService(
            CallableServiceAdapter(_f), FaultPlan(hang_rate=1.0, seed=1))
        ts = chaos.submit(_reqs(3))
        assert chaos.hung == 3 and chaos.in_flight == 3
        assert chaos.release_hung() == 3
        rs = chaos.gather(ts)
        assert all(not r.ok for r in rs)
        assert all(classify_failure(r) == "transient" for r in rs)


# ---------------------------------------------------------------------------
# controller wiring: the chaos gate
# ---------------------------------------------------------------------------

def _run_trace(plan, seed=42, budget=24, replication=None):
    base = CallableServiceAdapter(_f)
    svc = base if plan is None else FaultInjectingService(base, plan)
    ctrl = Controller(svc, EvalDB(), tag="bo", seed=seed,
                      replication=replication,
                      resilience=RetryPolicy(max_attempts=6, backoff_s=0.0))
    strat = make_strategy("random", _space(), budget=budget, seed=seed)
    trace = ctrl.run_async(strat, batch_size=4)
    return trace, ctrl


class TestChaosGate:
    def test_trace_bit_identical_under_transient_faults(self):
        t0, c0 = _run_trace(None)
        t1, c1 = _run_trace(FaultPlan(transient_rate=0.2, seed=5))
        t2, c2 = _run_trace(FaultPlan(transient_rate=0.2, seed=5))
        assert t0.values == t1.values == t2.values
        assert [r.config for r in c0.db.records] == \
               [r.config for r in c1.db.records]

    def test_n_evaluations_never_inflated(self):
        _, ctrl = _run_trace(FaultPlan(transient_rate=0.3, seed=8))
        assert len(ctrl.db) == 24
        assert all(r.ok for r in ctrl.db.records)

    def test_with_resilience_derivative(self):
        ctrl = Controller(CallableServiceAdapter(_f), EvalDB(), seed=1)
        derived = ctrl.with_resilience(RetryPolicy(max_attempts=2))
        assert derived.resilience.max_attempts == 2
        assert ctrl.resilience is None
        assert isinstance(derived.service, ResilientService)

    def test_replication_stacks_on_resilience(self):
        def noisy(c, request=None):
            import hashlib
            h = int.from_bytes(
                hashlib.blake2s(str(request.seed).encode()).digest()[:4],
                "little")
            return _f(c) + (h / 2 ** 32 - 0.5) * 0.01
        noisy.wants_request = True

        def run(plan):
            base = CallableServiceAdapter(noisy)
            svc = base if plan is None else FaultInjectingService(base,
                                                                  plan)
            ctrl = Controller(
                svc, EvalDB(), tag="bo", seed=7,
                replication=ReplicationPolicy(n_repeats=3, seed=7),
                resilience=RetryPolicy(max_attempts=6, backoff_s=0.0))
            strat = make_strategy("random", _space(), budget=12, seed=7)
            tr = ctrl.run_async(strat, batch_size=4)
            return tr.values, [(r.repeats, round(r.variance, 12))
                               for r in ctrl.db.records]

        fault_free = run(None)
        chaotic = run(FaultPlan(transient_rate=0.25, seed=11))
        # retried repeats keep the Chan-merge invariants: pooled means,
        # variances and repeat counts all match the fault-free run
        assert fault_free == chaotic


# ---------------------------------------------------------------------------
# circuit breaker unit semantics
# ---------------------------------------------------------------------------

class TestCircuitBreaker:
    def _breaker(self, clk, threshold=3, reset_s=10.0):
        return CircuitBreaker(threshold=threshold, reset_s=reset_s,
                              clock=lambda: clk[0])

    def test_trips_after_consecutive_failures(self):
        clk = [0.0]
        b = self._breaker(clk)
        for _ in range(3):
            assert b.allow()
            b.record_failure()
        assert b.state == "open" and not b.allow() and b.trips == 1

    def test_success_resets_the_count(self):
        clk = [0.0]
        b = self._breaker(clk)
        for _ in range(5):
            b.record_failure()
            b.record_success()
        assert b.state == "closed" and b.allow()

    def test_half_open_admits_one_trial(self):
        clk = [0.0]
        b = self._breaker(clk)
        for _ in range(3):
            b.record_failure()
        clk[0] = 11.0
        assert b.state == "half_open"
        assert b.allow() and not b.allow()      # exactly one trial
        b.record_success()
        assert b.state == "closed"

    def test_failed_trial_reopens(self):
        clk = [0.0]
        b = self._breaker(clk)
        for _ in range(3):
            b.record_failure()
        clk[0] = 11.0
        assert b.allow()
        b.record_failure()
        assert b.state == "open" and not b.allow()
        clk[0] = 22.0
        assert b.state == "half_open" and b.allow()


# ---------------------------------------------------------------------------
# EvalDB crash-truncation self-heal
# ---------------------------------------------------------------------------

class TestEvalDBSelfHeal:
    def _seeded(self, path):
        db = EvalDB(str(path))
        db.append_batch([EvalRecord({"x": 1.0}, 1.0, 0.1),
                         EvalRecord({"x": 2.0}, 4.0, 0.1)])
        return db

    def test_torn_tail_quarantined_once(self, tmp_path):
        p = tmp_path / "log.jsonl"
        self._seeded(p)
        with p.open("a") as f:
            f.write('{"config": {"x": 3.0}, "val')    # killed writer
        with warnings.catch_warnings(record=True) as w:
            warnings.simplefilter("always")
            db = EvalDB(str(p))
        assert len(db) == 2
        assert any("quarantined" in str(x.message) for x in w)
        q = tmp_path / "log.jsonl.quarantine"
        assert q.exists() and '{"config": {"x": 3.0}' in q.read_text()
        # healed: the next load is warning-free, the log is appendable
        with warnings.catch_warnings(record=True) as w:
            warnings.simplefilter("always")
            db2 = EvalDB(str(p))
        assert len(db2) == 2 and not w
        db2.append(EvalRecord({"x": 5.0}, 4.0, 0.1))
        assert len(EvalDB(str(p))) == 3

    def test_missing_trailing_newline_finished_in_place(self, tmp_path):
        p = tmp_path / "log.jsonl"
        self._seeded(p)
        with p.open("rb+") as f:
            data = f.read()
            f.truncate(len(data) - 1)       # strip only the newline
        db = EvalDB(str(p))
        assert len(db) == 2                 # the record itself was whole
        assert p.read_bytes().endswith(b"\n")

    def test_hand_truncated_shard_self_heals(self, tmp_path):
        # the regression: a sharded service log whose
        # shard was truncated mid-line by a killed daemon worker
        from repro_torch.service.shardlog import ShardedEvalLog
        log = ShardedEvalLog(str(tmp_path), n_shards=2)
        ns = log.namespace("s0001")
        ns.append_batch([EvalRecord({"x": float(i)}, float(i), 0.0)
                         for i in range(4)])
        shard_path = ns.path
        whole = shard_path.read_bytes()
        shard_path.write_bytes(whole[:len(whole) - 9])   # mid-record cut
        with warnings.catch_warnings(record=True):
            warnings.simplefilter("always")
            log2 = ShardedEvalLog(str(tmp_path), n_shards=2)
        assert len(log2.namespace("s0001")) == 3
        # and the healed shard keeps accepting appends cleanly
        log2.namespace("s0001").append(
            EvalRecord({"x": 9.0}, 9.0, 0.0))
        assert len(ShardedEvalLog(str(tmp_path),
                                  n_shards=2).namespace("s0001")) == 4

    def test_empty_and_clean_files_untouched(self, tmp_path):
        p = tmp_path / "log.jsonl"
        p.write_text("")
        assert len(EvalDB(str(p))) == 0
        db = self._seeded(p)
        before = p.read_bytes()
        EvalDB(str(p))
        assert p.read_bytes() == before


# ---------------------------------------------------------------------------
# across packages, and the chaos gate on a GP-BO run
# ---------------------------------------------------------------------------

_PLANS = {
    "transient20": FaultPlan(transient_rate=0.2, seed=5),
    "every_kind": FaultPlan(transient_rate=0.1, death_rate=0.1,
                            hang_rate=0.05, drop_rate=0.05,
                            duplicate_rate=0.1, latency_rate=0.1, seed=9),
    "always": FaultPlan(transient_rate=1.0)}


def _ref_plan(plan):
    from dataclasses import asdict
    from repro.core.faults import FaultPlan as RFaultPlan
    return RFaultPlan(**asdict(plan))


def _stream():
    """Seeded requests, then unseeded ones keyed by a config digest."""
    return (_reqs(60) + [EvalRequest({"x": float(i) / 7}, workload="w")
                         for i in range(20)])


@pytest.mark.parametrize("name", sorted(_PLANS))
def test_fault_plan_decides_as_the_reference(name):
    from repro.core import faults as rfaults
    from repro.core.service import EvalRequest as REvalRequest
    plan = _PLANS[name]
    rplan = _ref_plan(plan)
    for req in _stream():
        rreq = REvalRequest(dict(req.config), req.fidelity, req.workload,
                            req.tag, seed=req.seed)
        key = faults._request_key(req)
        assert key == rfaults._request_key(rreq)
        assert [plan.draw(key, o) for o in range(4)] == \
            [rplan.draw(key, o) for o in range(4)]


def test_injecting_service_faults_the_same_requests_as_the_reference():
    """Transient, death and duplicate faults over one request stream: the
    same requests fail, the same counts are injected."""
    from repro.core.faults import FaultInjectingService as RChaos
    from repro.core.service import CallableServiceAdapter as RAdapter
    from repro.core.service import EvalRequest as REvalRequest
    plan = FaultPlan(transient_rate=0.2, death_rate=0.1,
                     duplicate_rate=0.2, seed=3)
    reqs = _stream()
    mine = FaultInjectingService(CallableServiceAdapter(_f), plan)
    ref = RChaos(RAdapter(_f), _ref_plan(plan))
    got = mine.gather(mine.submit(reqs))
    want = ref.gather(ref.submit([REvalRequest(
        dict(r.config), r.fidelity, r.workload, r.tag, seed=r.seed)
        for r in reqs]))
    assert [(r.ok, r.value if r.ok else None) for r in got] == \
        [(r.ok, r.value if r.ok else None) for r in want]
    assert mine.injected == ref.injected
    assert mine.injected["transient"] > 0 and mine.injected["death"] > 0


def _bo_trace(plan):
    space = Space((Knob("x", "float", 5.0, lo=0.0, hi=10.0),
                   Knob("y", "float", 0.5, lo=0.0, hi=1.0)))

    def f(c):
        return (c["x"] - 3.0) ** 2 + (c["y"] - 0.2) ** 2

    base = CallableServiceAdapter(f)
    svc = base if plan is None else FaultInjectingService(base, plan)
    ctrl = Controller(svc, EvalDB(), tag="bo", seed=11,
                      resilience=RetryPolicy(max_attempts=8, backoff_s=0.0))
    strat = make_strategy("bo", space, budget=16, seed=11, cfg=BOConfig(
        n_init=4, n_iter=12, n_candidates=64, fit_steps=15, seed=11,
        device="cpu"))
    trace = ctrl.run_async(strat, batch_size=4)
    return trace, svc


def test_bo_trace_bit_identical_at_20_percent_transient_faults():
    clean, _ = _bo_trace(None)
    chaotic, chaos = _bo_trace(FaultPlan(transient_rate=0.2, seed=5))
    assert chaos.injected["transient"] > 0
    assert chaotic.configs == clean.configs
    assert chaotic.values == clean.values
    assert chaotic.best_values == clean.best_values
