"""The port's tuning daemon (``repro_torch.service``) on the CPU: the
reference's tuning-service cases run through the port, then the port
against the reference package over a real localhost wire.

Through the port: session isolation, the cross-session probe cache, the
sharded namespaced log, the HTTP wire, BO state snapshots, the
replication prior, idle eviction, ``transfer_from``, journal resume,
client retries and the pool's breaker.  A server-side session's trace
is bit-identical to a local ``run_async`` at the same seed.

Across packages: either package's ``TuningClient`` drives either daemon
(the port's client sends the reference's field names; the port's daemon
takes ``use_pallas`` as the wire name of ``use_kernel`` and refuses
``device``), and a snapshot or a journal written by one daemon resumes
in the other.

Every daemon here fits on ``device="cpu"``.  Every test runs under the
reference's 120 s SIGALRM watchdog, so a deadlocked gather/poll fails
one test instead of hanging the suite.
"""

import json
import signal
import threading
from functools import partial

import numpy as np
import pytest
import torch

from repro_torch.core.controller import Controller, EvalDB, EvalRecord
from repro_torch.core.replication import (AdaptiveRacer, RepeatStats,
                                          ReplicationPolicy)
from repro_torch.core.service import (EvalRequest, EvalResult, EvalTicket,
                                      ImmediateEvaluationService)
from repro_torch.core.space import (Divides, Knob, Leq, ProductLeq, Space,
                                    SumLeq)
from repro_torch.core.strategy import BOConfig, BOStrategy, make_strategy
from repro_torch.service import (ProbeCache, SessionClosed, ShardedEvalLog,
                                 SharedEvaluationPool, TuningClient,
                                 TuningServer, TuningServiceError,
                                 WorkloadSpec, probe_key, serve_background)
from repro_torch.service.shardlog import shard_index
from repro_torch.service.wire import space_from_json, space_to_json

_bo = partial(BOConfig, device="cpu")

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
        raise TimeoutError(f"tuning-service test exceeded {WATCHDOG_S}s "
                           "(deadlocked pool/session?)")

    old = signal.signal(signal.SIGALRM, _fire)
    signal.alarm(WATCHDOG_S)
    try:
        yield
    finally:
        signal.alarm(0)
        signal.signal(signal.SIGALRM, old)


# ---------------------------------------------------------------------------
# synthetic seeded workload
# ---------------------------------------------------------------------------

class _BD:
    feasible = True


class SeededQuad:
    """Seed-deterministic synthetic benchmark: the value depends only on
    (config, seed) — the seeded-probe contract the probe cache builds on.  Call
    counting is lock-guarded (pool workers score concurrently)."""

    accepts_seeds = True

    def __init__(self, shift=0.0):
        self.shift = shift
        self.calls = 0
        self._lock = threading.Lock()

    def evaluate_batch_detailed(self, cfgs, seeds=None):
        with self._lock:
            self.calls += len(cfgs)
        vals = []
        for i, c in enumerate(cfgs):
            s = None if seeds is None else seeds[i]
            rng = np.random.default_rng(0 if s is None else s)
            vals.append((c["x"] - 0.3) ** 2 + (c["y"] - 0.7) ** 2
                        + self.shift + 0.01 * rng.standard_normal())
        return vals, [_BD()] * len(cfgs)


def _space():
    return Space((Knob("x", "float", 0.5, lo=0.0, hi=1.0),
                  Knob("y", "float", 0.5, lo=0.0, hi=1.0)))


def _server(**kw):
    kw.setdefault("max_workers", 4)
    kw.setdefault("device", "cpu")
    return TuningServer(
        {"quad": WorkloadSpec("quad", lambda: (_space(), SeededQuad())),
         "quad2": WorkloadSpec("quad2",
                               lambda: (_space(), SeededQuad(shift=1.0)))},
        **kw)


BO_KW = {"cfg": {"n_init": 4, "n_iter": 8, "fit_steps": 15}}


def _backend(server, workload):
    return server.pool.inner.backends[workload]


# ---------------------------------------------------------------------------
# probe cache
# ---------------------------------------------------------------------------

class TestProbeCache:
    def test_unseeded_requests_bypass(self):
        assert probe_key(EvalRequest({"x": 1})) is None
        cache = ProbeCache()
        verdict, res = cache.lookup(None, "w")
        assert (verdict, res) == ("uncached", None)
        assert cache.stats["uncached"] == 1 and cache.hit_rate == 0.0

    def test_key_identity(self):
        a = EvalRequest({"x": 1, "y": 2.0}, "f", "wl", "tag-a", seed=7)
        b = EvalRequest({"y": 2.0, "x": 1}, "f", "wl", "tag-b", seed=7)
        assert probe_key(a) == probe_key(b)     # order/tag-insensitive
        assert probe_key(a) != probe_key(
            EvalRequest({"x": 1, "y": 2.0}, "f", "wl", seed=8))
        assert probe_key(a) != probe_key(
            EvalRequest({"x": 1, "y": 2.0}, "g", "wl", seed=7))
        assert probe_key(a) != probe_key(
            EvalRequest({"x": 1, "y": 2.0}, "f", "other", seed=7))
        # numpy-typed configs key identically to plain ones
        c = EvalRequest({"x": np.int64(1), "y": np.float64(2.0)},
                        "f", "wl", seed=7)
        assert probe_key(c) == probe_key(a)

    def _result(self, req, value, status="ok"):
        return EvalResult(EvalTicket(0, req), value, status=status,
                          feasible=status == "ok")

    def test_completed_hit_and_lru_eviction(self):
        cache = ProbeCache(capacity=2)
        reqs = [EvalRequest({"x": i}, seed=i) for i in range(3)]
        keys = [probe_key(r) for r in reqs]
        for k, r in zip(keys, reqs):
            assert cache.lookup(k, "w")[0] == "miss"
            cache.settle(k, self._result(r, 1.0))
        # capacity 2: key 0 evicted, 1 and 2 live
        assert cache.lookup(keys[0], "w")[0] == "miss"
        assert cache.lookup(keys[1], "w")[0] == "hit"
        assert cache.lookup(keys[2], "w")[0] == "hit"
        assert cache.stats["evictions"] >= 1

    def test_inflight_waiters_and_failed_not_stored(self):
        cache = ProbeCache()
        req = EvalRequest({"x": 1}, seed=3)
        key = probe_key(req)
        assert cache.lookup(key, "owner")[0] == "miss"
        assert cache.lookup(key, "w1")[0] == "wait"
        assert cache.lookup(key, "w2")[0] == "wait"
        waiters = cache.settle(key, self._result(req, 0.0, status="failed"))
        assert waiters == ["w1", "w2"]
        # failed results are delivered but not cached: next lookup re-owns
        assert cache.lookup(key, "owner")[0] == "miss"
        ok = cache.settle(key, self._result(req, 2.5))
        assert ok == []
        verdict, res = cache.lookup(key, "w3")
        assert verdict == "hit" and res.value == 2.5


# ---------------------------------------------------------------------------
# shared pool + ordered views
# ---------------------------------------------------------------------------

class TestSharedPool:
    def test_view_releases_in_submission_order(self):
        """Workers complete out of order (earlier uids sleep longer);
        an ordered view must still release uid 0, 1, 2, ..."""
        import time as _time

        class Slow:
            accepts_seeds = True

            def evaluate_batch_detailed(self, cfgs, seeds=None):
                _time.sleep(0.02 * float(cfgs[0]["d"]))
                return [float(cfgs[0]["d"])], [_BD()]

        pool = SharedEvaluationPool({"wl": Slow()}, max_workers=4)
        view = pool.view(ordered=True)
        n = 6
        # delay decreases with index: last submitted completes first
        tickets = view.submit([
            EvalRequest({"d": n - i, "i": i}, workload="wl", seed=i)
            for i in range(n)])
        got = []
        while len(got) < n:
            got += view.poll(timeout=None)
        assert [r.ticket.uid for r in got] == [t.uid for t in tickets]
        assert [r.request.config["i"] for r in got] == list(range(n))
        pool.close()

    def test_cross_view_inflight_dedup(self):
        """Two views racing the same seeded probe: one backend call,
        both views get the measurement, re-ticketed per view."""
        import time as _time

        class SlowCounting(SeededQuad):
            def evaluate_batch_detailed(self, cfgs, seeds=None):
                _time.sleep(0.05)
                return super().evaluate_batch_detailed(cfgs, seeds)

        backend = SlowCounting()
        pool = SharedEvaluationPool({"wl": backend}, max_workers=4)
        v1, v2 = pool.view(), pool.view()
        req = EvalRequest({"x": 0.2, "y": 0.9}, workload="wl", seed=11)
        (t1,) = v1.submit([req])
        (t2,) = v2.submit([req])
        (r1,) = v1.gather([t1])
        (r2,) = v2.gather([t2])
        assert r1.value == r2.value and r1.ok and r2.ok
        assert r1.ticket.uid == t1.uid and r2.ticket.uid == t2.uid
        assert backend.calls == 1
        assert pool.cache.stats["hits_inflight"] == 1
        pool.close()

    def test_unknown_workload_fails_result_not_exception(self):
        pool = SharedEvaluationPool({"wl": SeededQuad()}, max_workers=2)
        view = pool.view()
        (t,) = view.submit([EvalRequest({"x": 0.1, "y": 0.1},
                                        workload="nope", seed=1)])
        (r,) = view.gather([t])
        assert not r.ok and "no backend for workload" in r.error
        pool.close()


# ---------------------------------------------------------------------------
# session isolation + cross-session sharing (the tentpole contract)
# ---------------------------------------------------------------------------

class TestSessionIsolation:
    def test_shared_probes_bit_exact_disjoint_state(self):
        with _server() as srv:
            s1 = srv.create_session("quad", budget=8, seed=5,
                                    strategy_kwargs=BO_KW)
            s2 = srv.create_session("quad", budget=8, seed=5,
                                    strategy_kwargs=BO_KW)
            t1 = s1.run()
            t2 = s2.run()
            # bit-exact sharing: the cached probe IS the measurement
            assert t1.values == t2.values
            assert t1.configs == t2.configs
            # disjoint strategy state and EvalDB namespaces
            assert s1.strategy is not s2.strategy
            assert s1.db.ns != s2.db.ns
            recs1, recs2 = s1.db.records, s2.db.records
            assert len(recs1) == len(recs2) == 8
            assert {r.ns for r in recs1} == {s1.db.ns}
            assert {r.ns for r in recs2} == {s2.db.ns}
            # the second session re-evaluated nothing
            assert _backend(srv, "quad").calls == 8
            assert srv.pool.cache.stats["hits"] == 8

    def test_server_trace_bit_identical_to_local_run(self):
        """Acceptance: a single server-side session over the shared
        worker pool produces the trace a local ``run_async`` on an
        immediate service produces, same seed — same barrier cadence,
        same seeds, same values, bit for bit."""
        budget, seed = 10, 7
        with _server() as srv:
            sess = srv.create_session("quad", budget=budget, seed=seed,
                                      strategy_kwargs=BO_KW)
            server_trace = sess.run()
        strat = make_strategy("bo", _space(), budget=budget, seed=seed,
                              cfg=_bo(**BO_KW["cfg"]))
        local = Controller(ImmediateEvaluationService(SeededQuad()),
                           db=EvalDB(), tag="bo", workload="quad",
                           seed=seed)
        local_trace = local.run_async(strat, budget=budget,
                                      max_in_flight=1, min_ask=1)
        assert server_trace.values == local_trace.values
        assert server_trace.configs == local_trace.configs
        assert server_trace.best_values == local_trace.best_values

    def test_threaded_stress_shared_workloads(self):
        """8 concurrent clients, 2 workloads, 4 clients each sharing a
        seed: every probe is evaluated once per workload, the cache
        serves the rest, and no session's namespace leaks."""
        budget = 6
        kw = {"cfg": {"n_init": 3, "n_iter": 3, "fit_steps": 10}}
        with _server(max_workers=4) as srv:
            sessions, errors = [], []
            lock = threading.Lock()

            def client(workload):
                try:
                    s = srv.create_session(workload, budget=budget,
                                           seed=3, strategy_kwargs=kw)
                    with lock:
                        sessions.append(s)
                    s.run()
                except Exception as e:          # pragma: no cover
                    errors.append(e)

            threads = [threading.Thread(
                target=client, args=("quad" if i % 2 else "quad2",))
                for i in range(8)]
            for t in threads:
                t.start()
            for t in threads:
                t.join()
            assert not errors
            assert len(sessions) == 8
            namespaces = {s.db.ns for s in sessions}
            assert len(namespaces) == 8
            for s in sessions:
                assert len(s.db.records) == budget
                assert {r.ns for r in s.db.records} == {s.db.ns}
            # one evaluation per distinct probe per workload
            calls = (_backend(srv, "quad").calls
                     + _backend(srv, "quad2").calls)
            assert calls == 2 * budget
            stats = srv.pool.cache.snapshot()
            assert stats["hits"] == 8 * budget - 2 * budget
            assert stats["hit_rate"] >= 0.4

    def test_sharded_log_roundtrip_on_disk(self, tmp_path):
        root = str(tmp_path / "log")
        with _server(db_root=root, n_shards=3) as srv:
            s1 = srv.create_session("quad", budget=5, seed=1,
                                    strategy_kwargs=BO_KW)
            s2 = srv.create_session("quad2", budget=5, seed=2,
                                    strategy_kwargs=BO_KW)
            s1.run()
            s2.run()
            ns1, ns2 = s1.db.ns, s2.db.ns
        reloaded = ShardedEvalLog(root, n_shards=3)
        assert set(reloaded.namespaces()) == {ns1, ns2}
        assert reloaded.counts() == {ns1: 5, ns2: 5}
        view = reloaded.namespace(ns1)
        assert len(view) == 5
        assert all(r.workload == "quad" for r in view.records)
        cfgs, vals = view.pairs()
        assert len(cfgs) == len(vals) == 5

    def test_closed_session_rejects_everything(self):
        with _server() as srv:
            s = srv.create_session("quad", budget=4, seed=0,
                                   strategy_kwargs=BO_KW)
            sid = s.session_id
            srv.close_session(sid)
            with pytest.raises(SessionClosed):
                s.ask()
            with pytest.raises(KeyError):
                srv.session(sid)


# ---------------------------------------------------------------------------
# sharded log unit behavior
# ---------------------------------------------------------------------------

class TestShardLog:
    def test_stable_shard_routing(self):
        assert shard_index("s0001", 4) == shard_index("s0001", 4)
        log = ShardedEvalLog(None, n_shards=4)
        db = log.namespace("abc")
        assert db.shard is log.shards[shard_index("abc", 4)]
        with pytest.raises(ValueError):
            log.namespace("")

    def test_namespace_filtering(self):
        log = ShardedEvalLog(None, n_shards=1)     # force shard collision
        a, b = log.namespace("a"), log.namespace("b")
        a.append(EvalRecord({"x": 1}, 1.0, 0.0, "t"))
        b.append_batch([EvalRecord({"x": 2}, 2.0, 0.0, "t")])
        assert len(a) == 1 and len(b) == 1 and len(log) == 2
        assert a.records[0].value == 1.0 and a.records[0].ns == "a"
        assert b.records[0].value == 2.0 and b.records[0].ns == "b"


# ---------------------------------------------------------------------------
# EvalDB concurrent writers (advisory file lock)
# ---------------------------------------------------------------------------

class TestEvalDBFileLock:
    def test_two_objects_one_path_no_torn_lines(self, tmp_path):
        """Two EvalDB objects (distinct in-process locks!) hammering one
        path: the flock serializes batches, so every reloaded line
        parses and nothing interleaves."""
        path = str(tmp_path / "shared.jsonl")
        dbs = [EvalDB(path, shared_path=True) for _ in range(2)]
        n, batch = 40, 5

        def writer(db, tag):
            for i in range(n // batch):
                db.append_batch([
                    EvalRecord({"k" * 30: i * batch + j}, float(j), 0.0,
                               tag, "w" * 40)
                    for j in range(batch)])

        threads = [threading.Thread(target=writer, args=(db, f"t{i}"))
                   for i, db in enumerate(dbs)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        lines = [ln for ln in open(path).read().splitlines() if ln.strip()]
        assert len(lines) == 2 * n
        for ln in lines:                 # every line is whole JSON
            json.loads(ln)
        reloaded = EvalDB(path)
        assert len(reloaded) == 2 * n
        assert {r.tag for r in reloaded.records} == {"t0", "t1"}

    def test_shared_path_fails_loudly_without_fcntl(self, tmp_path,
                                                    monkeypatch):
        import repro_torch.core.controller as ctl
        db = EvalDB(str(tmp_path / "x.jsonl"), shared_path=True)
        monkeypatch.setattr(ctl, "fcntl", None)
        with pytest.raises(RuntimeError, match="advisory"):
            db.append(EvalRecord({"a": 1}, 1.0, 0.0))
        # unshared paths keep working (single-writer legacy contract)
        solo = EvalDB(str(tmp_path / "y.jsonl"))
        solo.append(EvalRecord({"a": 1}, 1.0, 0.0))
        assert len(EvalDB(str(tmp_path / "y.jsonl"))) == 1


# ---------------------------------------------------------------------------
# HTTP wire
# ---------------------------------------------------------------------------

class TestWire:
    @pytest.fixture()
    def service(self):
        srv = _server()
        httpd, _ = serve_background(srv)
        host, port = httpd.server_address[:2]
        try:
            yield TuningClient(f"http://{host}:{port}"), srv
        finally:
            httpd.shutdown()
            srv.close()

    def test_lifecycle_ask_tell_best_history_close(self, service):
        client, srv = service
        assert client.health()["ok"]
        assert {w["name"] for w in client.workloads()} == {"quad", "quad2"}
        sess = client.create_session("quad", strategy="random", budget=6,
                                     seed=1)
        assert [k.name for k in sess.space.knobs] == ["x", "y"]
        cfgs = sess.ask(3)
        assert len(cfgs) == 3 and all("x" in c for c in cfgs)
        assert sess.tell(cfgs, [3.0, 1.0, 2.0],
                         variances=[0.1, 0.1, 0.1]) == 3
        cfg, val = sess.best()
        assert val == 1.0 and cfg == cfgs[1]
        recs = sess.history()
        assert len(recs) == 3
        assert all(r["fidelity"] == "client" for r in recs)
        assert sess.history(limit=2)[-1]["value"] == 2.0
        sess.close()
        with pytest.raises(TuningServiceError) as ei:
            sess.ask()
        assert ei.value.status == 404            # closed = gone
        assert client.stats()["sessions_open"] == 0

    def test_server_side_run_and_state(self, service):
        client, srv = service
        sess = client.create_session("quad", budget=8, seed=4,
                                     strategy_kwargs=BO_KW)
        out = sess.run()
        assert out["n_evaluations"] == 8
        assert out["best_value"] == min(out["trace"]["values"])
        assert len(out["trace"]["configs"]) == 8
        state = sess.state()
        assert state["kind"] == "bo" and state["version"] == 1
        # warm restart: a new session resumes from the snapshot
        warm = client.create_session("quad", budget=16, seed=9,
                                     strategy_kwargs=BO_KW, state=state)
        assert len(warm.ask(2)) == 2
        # in-process equivalence: the wire adds serialization, nothing else
        twin = srv.create_session("quad", budget=8, seed=4,
                                  strategy_kwargs=BO_KW)
        assert twin.run().values == out["trace"]["values"]

    def test_error_codes(self, service):
        client, _ = service
        with pytest.raises(TuningServiceError) as ei:
            client.create_session("no-such-workload")
        assert ei.value.status == 404
        with pytest.raises(TuningServiceError) as ei:
            client.create_session("quad", strategy="zzz")
        assert ei.value.status == 404 or ei.value.status == 400
        with pytest.raises(TuningServiceError) as ei:
            client._call("POST", "/v1/sessions", {"workload": "quad",
                                                  "bogus_field": 1})
        assert ei.value.status == 400
        sess = client.create_session("quad", strategy="random", budget=4)
        with pytest.raises(TuningServiceError) as ei:
            sess.best()
        assert ei.value.status == 409            # no observations yet
        with pytest.raises(TuningServiceError) as ei:
            client._call("GET", "/v1/nope")
        assert ei.value.status == 404

    def test_space_codec_roundtrip(self):
        space = Space(
            (Knob("i", "int", 4, lo=1, hi=64, align=2, log_scale=True,
                  dynamic_bound=True, module="m", description="d"),
             Knob("f", "float", 0.5, lo=0.0, hi=1.0,
                  restart_required=False),
             Knob("b", "bool", True, inert=True),
             Knob("c", "categorical", "a", choices=("a", "b", "c"),
                  gated_by=("b", (True,)), configurable=False)),
            (SumLeq(("i", "f"), limit=32.0), Leq(("f", "i")),
             Divides(("i",), target=64),
             ProductLeq(("i", "i"), limit=4096.0)))
        decoded = space_from_json(json.loads(json.dumps(
            space_to_json(space))))
        assert decoded == space


# ---------------------------------------------------------------------------
# satellite: BOStrategy state_dict / load_state
# ---------------------------------------------------------------------------

class TestBOStateDict:
    def _run_one(self, budget=8, seed=3):
        cfg = _bo(n_init=4, n_iter=12, fit_steps=15, seed=seed)
        strat = BOStrategy(_space(), cfg)
        ctrl = Controller(ImmediateEvaluationService(SeededQuad()),
                          db=EvalDB(), seed=seed)
        ctrl.run_async(strat, budget=budget, max_in_flight=1, min_ask=1)
        return strat

    def test_roundtrip_restores_trace_params_and_budget(self):
        a = self._run_one()
        sd = json.loads(json.dumps(a.state_dict()))   # wire-safe
        b = BOStrategy(_space(), _bo(n_init=4, n_iter=12,
                                          fit_steps=15, seed=3))
        b.load_state(sd)
        assert b.trace.values == a.trace.values
        assert b.trace.configs == a.trace.configs
        assert b._evals_done == a._evals_done
        assert not b.finished
        np.testing.assert_array_equal(
            np.asarray(b._params.log_lengthscale),
            np.asarray(a._params.log_lengthscale))
        assert float(b._params.log_noise_var) == float(
            a._params.log_noise_var)
        # the restored strategy resumes asking within the restored space
        nxt = b.ask(2)
        assert len(nxt) == 2
        for c in nxt:
            assert set(c) == {"x", "y"}

    def test_boundary_state_survives(self):
        space = Space((Knob("x", "float", 0.5, lo=0.0, hi=1.0,
                            dynamic_bound=True),
                       Knob("y", "float", 0.5, lo=0.0, hi=1.0)))
        cfg = _bo(n_init=3, n_iter=9, fit_steps=10,
                       boundary_tol=0.45, seed=0)
        strat = BOStrategy(space, cfg)
        ctrl = Controller(ImmediateEvaluationService(SeededQuad()),
                          db=EvalDB(), seed=0)
        ctrl.run_async(strat, budget=9, max_in_flight=1, min_ask=1)
        sd = strat.state_dict()
        fresh = BOStrategy(space, cfg)
        fresh.load_state(sd)
        assert (float(fresh.space.knob("x").lo),
                float(fresh.space.knob("x").hi)) == tuple(sd["bounds"]["x"])
        assert fresh.trace.boundary_events == strat.trace.boundary_events
        assert fresh._space_version == strat._space_version

    def test_load_state_validates(self):
        a = self._run_one(budget=5)
        sd = a.state_dict()
        b = BOStrategy(_space(), _bo(n_init=4, n_iter=12))
        with pytest.raises(ValueError, match="version"):
            b.load_state({**sd, "version": 99})
        with pytest.raises(ValueError, match="kernel"):
            b.load_state({**sd, "kernel": "rbf"})
        with pytest.raises(ValueError, match="knobs"):
            b.load_state({**sd, "bounds": {"zz": [0.0, 1.0]}})

    def test_other_strategies_refuse_state(self):
        with _server() as srv:
            with pytest.raises(TypeError, match="load_state"):
                srv.create_session("quad", strategy="random", budget=4,
                                   state={"kind": "random"})


# ---------------------------------------------------------------------------
# satellite: GP-prior racing intervals + variance-widened promotion
# ---------------------------------------------------------------------------

class TestGPPriorRacing:
    def _group(self, values, asked=None):
        return {"stats": RepeatStats.from_values(values),
                "asked": asked or {"x": 0.5}, "prepared": {"x": 0.5},
                "result": None, "measured": len(values), "extras": 0}

    def test_mean_var_pools_toward_prior(self):
        pol = ReplicationPolicy(n_repeats=2, adaptive=True)
        svc = ImmediateEvaluationService(SeededQuad())
        empirical = AdaptiveRacer(pol, svc)
        g = self._group([1.0, 1.2])              # s^2 = 0.02, k = 2
        assert empirical._mean_var(g) == pytest.approx(0.01)
        # prior-aware: nu=1, w=2 -> pooled = (0.02 + 2*v0)/3, /k
        prior = AdaptiveRacer(pol, svc, noise_prior=lambda c: 0.08)
        assert prior._mean_var(g) == pytest.approx(
            ((1 * 0.02 + 2 * 0.08) / 3) / 2)
        # a strategy with no posterior yet falls back to empirical
        lazy = AdaptiveRacer(pol, svc, noise_prior=lambda c: None)
        assert lazy._mean_var(g) == empirical._mean_var(g)

    def test_prior_widens_deceptively_tight_repeats(self):
        """Two repeats that landed close together look settled to the
        empirical interval; the GP noise prior (trained on every config)
        knows the benchmark is noisier than that and keeps racing."""
        pol = ReplicationPolicy(n_repeats=2, adaptive=True, z=2.0)
        svc = ImmediateEvaluationService(SeededQuad())
        g = self._group([1.0, 1.001])
        empirical = AdaptiveRacer(pol, svc)
        prior = AdaptiveRacer(pol, svc, noise_prior=lambda c: 0.5)
        assert prior._mean_var(g) > 10 * empirical._mean_var(g)

    def test_bo_measurement_variance_exposed(self):
        strat = self._fit_bo()
        v = strat.measurement_variance({"x": 0.4, "y": 0.6})
        assert v is not None and v > 0.0
        fresh = BOStrategy(_space(), _bo())
        assert fresh.measurement_variance({"x": 0.4, "y": 0.6}) is None

    def _fit_bo(self):
        cfg = _bo(n_init=4, n_iter=8, fit_steps=15, seed=1)
        strat = BOStrategy(_space(), cfg)
        ctrl = Controller(ImmediateEvaluationService(SeededQuad()),
                          db=EvalDB(), seed=1)
        ctrl.run_async(strat, budget=6, max_in_flight=1, min_ask=1)
        return strat

    def test_adaptive_run_uses_gp_prior_by_default(self):
        pol = ReplicationPolicy(n_repeats=2, adaptive=True, max_repeats=4)
        strat = BOStrategy(_space(), _bo(n_init=3, n_iter=5,
                                              fit_steps=10, seed=2))
        ctrl = Controller(ImmediateEvaluationService(SeededQuad()),
                          db=EvalDB(), seed=2, replication=pol)
        trace = ctrl.run_async(strat, budget=8)
        assert len(trace.values) == 8
        # gp_prior=False keeps the legacy empirical-only racer working
        pol_off = ReplicationPolicy(n_repeats=2, adaptive=True,
                                    max_repeats=4, gp_prior=False)
        strat2 = BOStrategy(_space(), _bo(n_init=3, n_iter=5,
                                               fit_steps=10, seed=2))
        ctrl2 = Controller(ImmediateEvaluationService(SeededQuad()),
                           db=EvalDB(), seed=2, replication=pol_off)
        assert len(ctrl2.run_async(strat2, budget=8).values) == 8


class TestVarianceWidenedPromotion:
    class _ListStrategy:
        """Asks a scripted candidate list once; records what it's told."""

        def __init__(self, cands):
            self.cands = list(cands)
            self.told = []
            self.asked = False
            from repro_torch.core.strategy import Trace
            self.trace = Trace()

        @property
        def finished(self):
            return self.asked

        def ask(self, n=None):
            self.asked = True
            return [dict(c) for c in self.cands]

        def tell(self, configs, values, variances=None):
            self.told.append((list(values), list(variances or [])))
            self.trace.extend(configs, values, variances)

        def best(self):
            return self.trace.best

    class _PresetService:
        """Immediate service returning scripted (value, variance) per
        config key; promotion fidelity returns value + 10."""

        def __init__(self, table):
            from repro_torch.core.service import _ServiceBase
            self.table = table
            base = _ServiceBase()
            self._base = base

        def submit(self, requests):
            from repro_torch.core.service import EvalResult
            tickets = self._base._issue(requests)
            for t in tickets:
                v, var = self.table[t.request.config["name"]]
                if t.request.fidelity == "promote":
                    v, var = v + 10.0, 0.0
                self._base._complete(EvalResult(t, v, variance=var))
            return tickets

        def poll(self, timeout=0.0, min_results=1):
            return self._base.poll(timeout, min_results)

        def gather(self, tickets):
            return self._base.gather(tickets)

        def drain(self):
            return self._base.drain()

        def close(self):
            pass

    def _run(self, promote_z):
        # A: best raw mean but huge screen variance; B: slightly worse
        # mean, measured precisely
        table = {"A": (1.0, 0.09), "B": (1.05, 0.0)}
        cands = [{"name": "A"}, {"name": "B"}]
        strat = self._ListStrategy(cands)
        ctrl = Controller(self._PresetService(table), db=EvalDB())
        best_c, best_v, sched = ctrl.run_successive_halving(
            strat, rounds=1, screen=2, promote=1, promote_z=promote_z)
        return strat, sched

    def test_promote_z_zero_ranks_on_raw_mean(self):
        strat, sched = self._run(promote_z=0.0)
        assert sched[0]["promoted_configs"] == [{"name": "A"}]

    def test_promote_z_widens_noisy_screens(self):
        # widened(A) = 1.0 + 2*0.3 = 1.6 > widened(B) = 1.05
        strat, sched = self._run(promote_z=2.0)
        assert sched[0]["promoted_configs"] == [{"name": "B"}]
        # the strategy is told un-widened means, with variances
        values, variances = strat.told[0]
        assert values[0] == 1.0 and variances[0] == 0.09
        assert values[1] == 11.05 and variances[1] == 0.0


# ---------------------------------------------------------------------------
# projected probe keys (ROADMAP service rung (d))
# ---------------------------------------------------------------------------

def _decoy_space():
    return Space((Knob("x", "float", 0.5, lo=0.0, hi=1.0),
                  Knob("y", "float", 0.5, lo=0.0, hi=1.0),
                  Knob("decoy", "int", 0, lo=0, hi=8, inert=True),
                  Knob("mode", "categorical", "off",
                       choices=("off", "on")),
                  Knob("depth", "int", 2, lo=1, hi=4,
                       gated_by=("mode", ("on",)))))


class TestProjectedProbeKeys:
    def test_inert_and_gated_off_knobs_dropped(self):
        sp = _decoy_space()
        base = {"x": 0.25, "y": 0.5, "mode": "off", "depth": 3}
        a = EvalRequest({**base, "decoy": 1}, workload="w", seed=7)
        b = EvalRequest({**base, "decoy": 6, "depth": 1},
                        workload="w", seed=7)
        assert probe_key(a) != probe_key(b)          # raw keys differ
        assert probe_key(a, sp) == probe_key(b, sp)  # projected collide
        # gate open: depth is live again and must key
        on3 = EvalRequest({**base, "decoy": 0, "mode": "on", "depth": 3},
                          workload="w", seed=7)
        on4 = EvalRequest({**base, "decoy": 0, "mode": "on", "depth": 4},
                          workload="w", seed=7)
        assert probe_key(on3, sp) != probe_key(on4, sp)
        assert probe_key(on3, sp) != probe_key(a, sp)
        # unseeded probes stay uncacheable, space or not
        assert probe_key(EvalRequest({**base, "decoy": 1},
                                     workload="w"), sp) is None

    def test_pool_cache_hit_across_inert_variants(self):
        """The regression: two sessions probing configs that differ only
        in an inert decoy knob must share one measurement once the
        workload's space is registered."""
        backend = SeededQuad()
        pool = SharedEvaluationPool({"wl": backend}, max_workers=2)
        pool.register_space("wl", _decoy_space())
        v1, v2 = pool.view(), pool.view()
        cfg = {"x": 0.2, "y": 0.9, "mode": "off", "depth": 3}
        (t1,) = v1.submit([EvalRequest({**cfg, "decoy": 1},
                                       workload="wl", seed=11)])
        (r1,) = v1.gather([t1])
        (t2,) = v2.submit([EvalRequest({**cfg, "decoy": 7, "depth": 1},
                                       workload="wl", seed=11)])
        (r2,) = v2.gather([t2])
        assert r1.ok and r2.ok and r1.value == r2.value
        assert backend.calls == 1
        assert pool.cache.stats["hits_completed"] == 1
        pool.close()

    def test_without_space_variants_remeasure(self):
        backend = SeededQuad()
        pool = SharedEvaluationPool({"wl": backend}, max_workers=2)
        v = pool.view()
        cfg = {"x": 0.2, "y": 0.9, "mode": "off", "depth": 3}
        for decoy in (1, 7):
            (t,) = v.submit([EvalRequest({**cfg, "decoy": decoy},
                                         workload="wl", seed=11)])
            v.gather([t])
        assert backend.calls == 2
        pool.close()

    def test_server_registers_space_on_resolve(self):
        with _server() as srv:
            srv.create_session("quad", strategy="random", budget=4)
            assert "quad" in srv.pool.spaces


# ---------------------------------------------------------------------------
# idle-session eviction + snapshot/resume
# ---------------------------------------------------------------------------

class TestSessionEviction:
    def test_no_ttl_never_evicts(self):
        import time as _time
        with _server() as srv:
            srv.create_session("quad", strategy="random", budget=4)
            assert srv.evict_idle(now=_time.time() + 1e9) == []
            assert srv.stats()["sessions_open"] == 1

    def test_idle_eviction_snapshots_and_resumes(self, tmp_path):
        import time as _time
        with _server(db_root=str(tmp_path), session_ttl=60.0) as srv:
            sess = srv.create_session("quad", budget=8, seed=2,
                                      strategy_kwargs=BO_KW)
            sid = sess.session_id
            cfgs = sess.ask(2)
            sess.tell(cfgs, [1.0, 2.0])
            best = sess.best()
            assert srv.evict_idle(now=_time.time() + 3600) == [sid]
            assert sess.closed
            with pytest.raises(KeyError, match=sid):
                srv.session(sid)
            stats = srv.stats()
            assert stats["sessions_evicted"] == 1
            assert stats["sessions_open"] == 0
            assert (tmp_path / "sessions" / f"{sid}.json").exists()
            resumed = srv.create_session("quad", budget=8, seed=2,
                                         strategy_kwargs=BO_KW,
                                         resume=sid)
            assert resumed.session_id != sid
            assert resumed.best() == best
            assert len(resumed.strategy.trace.values) == 2

    def test_entrypoint_sweep_is_lazy(self):
        with _server(session_ttl=60.0) as srv:
            sess = srv.create_session("quad", strategy="random", budget=4)
            sid = sess.session_id
            assert srv.list_sessions()          # fresh: survives the sweep
            sess.last_used -= 3600              # backdate: now idle
            with pytest.raises(KeyError):
                srv.session(sid)                # the lookup itself sweeps
            assert srv.list_sessions() == []

    def test_activity_resets_the_idle_clock(self):
        import time as _time
        with _server(session_ttl=60.0) as srv:
            sess = srv.create_session("quad", strategy="random", budget=8)
            sess.last_used -= 50                # idle, but under the ttl
            cfgs = sess.ask(1)                  # activity touches
            sess.tell(cfgs, [1.0])
            assert _time.time() - sess.last_used < 5
            assert srv.evict_idle() == []

    def test_resume_guards(self, tmp_path):
        import time as _time
        with _server(db_root=str(tmp_path), session_ttl=60.0) as srv:
            sess = srv.create_session("quad", budget=8, seed=2,
                                      strategy_kwargs=BO_KW)
            sid = sess.session_id
            sess.tell([{"x": 0.1, "y": 0.2}], [1.0])
            srv.evict_idle(now=_time.time() + 3600)
            with pytest.raises(KeyError, match="no session snapshot"):
                srv.create_session("quad", resume="s9999")
            with pytest.raises(ValueError, match="not both"):
                srv.create_session("quad", strategy_kwargs=BO_KW,
                                   resume=sid, state={"version": 1})
            with pytest.raises(ValueError, match="belongs to workload"):
                srv.create_session("quad2", strategy_kwargs=BO_KW,
                                   resume=sid)

    def test_resume_from_disk_across_restarts(self, tmp_path):
        import time as _time
        with _server(db_root=str(tmp_path), session_ttl=60.0) as srv:
            sess = srv.create_session("quad", budget=8, seed=2,
                                      strategy_kwargs=BO_KW)
            sid = sess.session_id
            sess.tell([{"x": 0.1, "y": 0.2}], [3.5])
            srv.evict_idle(now=_time.time() + 3600)
        # a brand-new daemon over the same log root: memory snapshots
        # are gone, the file one is found
        with _server(db_root=str(tmp_path)) as srv2:
            resumed = srv2.create_session("quad", budget=8, seed=2,
                                          strategy_kwargs=BO_KW,
                                          resume=sid)
            assert resumed.best() == ({"x": 0.1, "y": 0.2}, 3.5)


# ---------------------------------------------------------------------------
# transfer_from: warm starts mined from the daemon's own log
# ---------------------------------------------------------------------------

class TestTransferFrom:
    def test_mines_sibling_workload_logs(self):
        from repro_torch.transfer import TransferBOStrategy
        with _server() as srv:
            donor = srv.create_session("quad", budget=6, seed=3,
                                       strategy_kwargs=BO_KW)
            donor.run()
            sess = srv.create_session("quad2", strategy="transfer_bo",
                                      budget=6, seed=3,
                                      strategy_kwargs=BO_KW,
                                      transfer_from=True)
            strat = sess.strategy
            assert isinstance(strat, TransferBOStrategy)
            assert strat._prior is not None       # quad's 6 rows fed it
            trace = sess.run()
            assert len(trace.values) == 6

    def test_own_workload_always_excluded(self):
        with _server() as srv:
            donor = srv.create_session("quad", budget=6, seed=3,
                                       strategy_kwargs=BO_KW)
            donor.run()
            sess = srv.create_session("quad", strategy="transfer_bo",
                                      budget=6, seed=4,
                                      strategy_kwargs=BO_KW,
                                      transfer_from=True)
            assert sess.strategy._prior is None   # only donor was itself

    def test_empty_log_degrades_to_plain_bo(self):
        with _server() as srv:
            sess = srv.create_session("quad", strategy="transfer_bo",
                                      budget=6, seed=3,
                                      strategy_kwargs=BO_KW,
                                      transfer_from=True)
            assert sess.strategy._prior is None
            assert len(sess.run().values) == 6

    def test_unknown_spec_field_rejected(self):
        with _server() as srv:
            with pytest.raises(ValueError, match="unknown fields"):
                srv.create_session("quad", strategy="transfer_bo",
                                   strategy_kwargs=BO_KW,
                                   transfer_from={"nope": 1})

    def test_workload_narrowing(self):
        with _server() as srv:
            for wl in ("quad", "quad2"):
                srv.create_session(wl, budget=6, seed=3,
                                   strategy_kwargs=BO_KW).run()
            sess = srv.create_session(
                "quad", strategy="transfer_bo", budget=6, seed=4,
                strategy_kwargs=BO_KW,
                transfer_from={"workloads": ["quad"]})
            assert sess.strategy._prior is None   # narrowed to self only
            sess2 = srv.create_session(
                "quad", strategy="transfer_bo", budget=6, seed=4,
                strategy_kwargs=BO_KW,
                transfer_from={"workloads": ["quad2"]})
            assert sess2.strategy._prior is not None

    def test_wire_transfer_and_resume(self):
        import time as _time
        srv = _server(session_ttl=600.0)
        httpd, _ = serve_background(srv)
        host, port = httpd.server_address[:2]
        client = TuningClient(f"http://{host}:{port}")
        try:
            client.create_session("quad", budget=6, seed=3,
                                  strategy_kwargs=BO_KW).run()
            sess = client.create_session("quad2", strategy="transfer_bo",
                                         budget=6, seed=3,
                                         strategy_kwargs=BO_KW,
                                         transfer_from=True)
            out = sess.run()
            assert out["n_evaluations"] == 6
            sid = sess.session_id
            srv.evict_idle(now=_time.time() + 3600)
            with pytest.raises(TuningServiceError) as ei:
                sess.best()
            assert ei.value.status == 404        # evicted = gone
            resumed = client.create_session("quad2",
                                            strategy="transfer_bo",
                                            budget=6, seed=3,
                                            strategy_kwargs=BO_KW,
                                            resume=sid)
            _, val = resumed.best()
            assert val == out["best_value"]
            with pytest.raises(TuningServiceError) as ei:
                client.create_session("quad", strategy="transfer_bo",
                                      strategy_kwargs=BO_KW,
                                      transfer_from={"nope": 1})
            assert ei.value.status == 400
        finally:
            httpd.shutdown()
            srv.close()


# ---------------------------------------------------------------------------
# crash-safe sessions: journal manifests + same-sid resume
# ---------------------------------------------------------------------------

class TestJournalResume:
    def test_daemon_killed_mid_run_resumes_with_zero_lost_tells(
            self, tmp_path):
        # no evict_idle, no snapshot: the daemon just dies.  Every tell
        # was journaled before the strategy ack'd, so a fresh daemon
        # rebuilds the SAME session id from manifest + journal replay.
        with _server(db_root=str(tmp_path)) as srv:
            sess = srv.create_session("quad", budget=8, seed=2,
                                      strategy_kwargs=BO_KW)
            sid = sess.session_id
            cfgs = sess.ask(3)
            sess.tell(cfgs, [4.0, 2.0, 3.0])
        with _server(db_root=str(tmp_path)) as srv2:
            resumed = srv2.create_session("quad", budget=8, seed=2,
                                          strategy_kwargs=BO_KW,
                                          resume=sid)
            assert resumed.session_id == sid        # same namespace
            assert len(resumed.strategy.trace.values) == 3
            assert resumed.best()[1] == 2.0
            # and the session keeps appending to the same journal
            more = resumed.ask(1)
            resumed.tell(more, [1.5])
            assert len(srv2.log.namespace(sid).records) == 4
            assert resumed.best()[1] == 1.5

    def test_snapshot_still_preferred_over_journal(self, tmp_path):
        import time as _time
        # an evicted session has a snapshot; resume must keep using it
        # (new sid) rather than the crash path (same sid)
        with _server(db_root=str(tmp_path), session_ttl=60.0) as srv:
            sess = srv.create_session("quad", budget=8, seed=2,
                                      strategy_kwargs=BO_KW)
            sid = sess.session_id
            sess.tell([{"x": 0.1, "y": 0.2}], [1.0])
            srv.evict_idle(now=_time.time() + 3600)
            resumed = srv.create_session("quad", budget=8, seed=2,
                                         strategy_kwargs=BO_KW, resume=sid)
            assert resumed.session_id != sid

    def test_journal_resume_guards(self, tmp_path):
        with _server(db_root=str(tmp_path)) as srv:
            sess = srv.create_session("quad", budget=8, seed=2,
                                      strategy_kwargs=BO_KW)
            sid = sess.session_id
            sess.tell([{"x": 0.1, "y": 0.2}], [1.0])
            # still open on this daemon: refuse a second driver
            with pytest.raises(ValueError, match="still open"):
                srv.create_session("quad", resume=sid)
        with _server(db_root=str(tmp_path)) as srv2:
            # wrong workload: the manifest knows whose journal this is
            with pytest.raises(ValueError, match="belongs to workload"):
                srv2.create_session("quad2", resume=sid)
            # no snapshot AND no manifest: same KeyError as before
            with pytest.raises(KeyError, match="no session snapshot"):
                srv2.create_session("quad", resume="s9999")

    def test_restarted_daemon_never_reuses_session_ids(self, tmp_path):
        with _server(db_root=str(tmp_path)) as srv:
            s1 = srv.create_session("quad", strategy="random", budget=4)
            s1.tell([{"x": 0.1, "y": 0.2}], [1.0])
            old = s1.session_id
        with _server(db_root=str(tmp_path)) as srv2:
            s2 = srv2.create_session("quad", strategy="random", budget=4)
            assert s2.session_id != old
            assert int(s2.session_id[1:]) > int(old[1:])

    def test_run_after_journal_resume_continues_budget(self, tmp_path):
        with _server(db_root=str(tmp_path)) as srv:
            sess = srv.create_session("quad", strategy="random", budget=6,
                                      seed=3)
            sid = sess.session_id
            cfgs = sess.ask(2)
            sess.tell(cfgs, [2.0, 3.0])
        with _server(db_root=str(tmp_path)) as srv2:
            resumed = srv2.create_session("quad", strategy="random",
                                          budget=6, seed=3, resume=sid)
            # the 2 replayed tells count: spend only the remaining 4
            trace = resumed.run(budget=4)
            assert len(resumed.strategy.trace.values) == 6
            assert min(trace.values) <= 3.0


# ---------------------------------------------------------------------------
# client transport retries
# ---------------------------------------------------------------------------

class _FlakyTransport:
    """Counts urlopen calls; fails the first ``fail`` with the given
    exception, then returns a canned JSON body."""

    def __init__(self, fail, exc, body=b'{"ok": true}'):
        self.fail = fail
        self.exc = exc
        self.body = body
        self.calls = 0

    def __call__(self, req, timeout=None):
        self.calls += 1
        if self.calls <= self.fail:
            raise self.exc
        import io

        class _Resp(io.BytesIO):
            def __enter__(self):
                return self

            def __exit__(self, *a):
                pass

        return _Resp(self.body)


class TestClientRetries:
    def test_idempotent_table(self):
        from repro_torch.service.client import _idempotent
        assert _idempotent("GET", "/v1/health")
        assert _idempotent("GET", "/v1/sessions/s0001/state")
        assert _idempotent("POST", "/v1/sessions/s0001/ask")
        assert not _idempotent("POST", "/v1/sessions/s0001/tell")
        assert not _idempotent("POST", "/v1/sessions")
        assert not _idempotent("POST", "/v1/sessions/s0001/run")
        assert not _idempotent("POST", "/v1/sessions/s0001/close")

    @pytest.mark.parametrize("fail,exc,retries,ok", [
        (2, ConnectionResetError("reset by peer"), 3, True),
        (99, TimeoutError("timed out"), 2, False)])
    def test_get_retries_transport_flakes_then_gives_up(
            self, monkeypatch, fail, exc, retries, ok):
        """A GET is resent through transport flakes; past ``retries`` it
        raises with status 0 after 1 + retries attempts."""
        import urllib.request
        flaky = _FlakyTransport(fail, exc)
        monkeypatch.setattr(urllib.request, "urlopen", flaky)
        c = TuningClient("http://127.0.0.1:1", retries=retries,
                         retry_backoff_s=0.0)
        if ok:
            assert c.health() == {"ok": True}
        else:
            with pytest.raises(TuningServiceError) as ei:
                c.health()
            assert ei.value.status == 0
        assert flaky.calls == min(fail, retries) + 1

    def test_tell_never_resent_on_transport_failure(self, monkeypatch):
        import urllib.request
        flaky = _FlakyTransport(99, ConnectionRefusedError("refused"))
        monkeypatch.setattr(urllib.request, "urlopen", flaky)
        c = TuningClient("http://127.0.0.1:1", retries=5,
                         retry_backoff_s=0.0)
        with pytest.raises(TuningServiceError) as ei:
            c._call("POST", "/v1/sessions/s0001/tell",
                    {"configs": [], "values": []})
        assert ei.value.status == 0
        assert "may or may not" in ei.value.message
        assert flaky.calls == 1                  # exactly one attempt
        with pytest.raises(TuningServiceError) as ei:
            c.create_session("quad")
        assert ei.value.status == 0 and flaky.calls == 2

    def test_server_errors_never_retried(self, monkeypatch):
        import urllib.error
        import urllib.request
        calls = [0]

        def boom(req, timeout=None):
            calls[0] += 1
            raise urllib.error.HTTPError(
                req.full_url, 404, "nope", {}, None)

        monkeypatch.setattr(urllib.request, "urlopen", boom)
        c = TuningClient("http://127.0.0.1:1", retries=5,
                         retry_backoff_s=0.0)
        with pytest.raises(TuningServiceError) as ei:
            c.health()
        assert ei.value.status == 404 and calls[0] == 1

    def test_retry_enabled_client_over_a_real_wire(self):
        # a retry-enabled client against a live daemon behaves exactly
        # like the plain one on the happy path (no spurious resends)
        srv = _server()
        httpd, _ = serve_background(srv)
        try:
            url = f"http://127.0.0.1:{httpd.server_port}"
            c = TuningClient(url, retries=2, retry_backoff_s=0.05)
            assert c.health()["ok"] is True
            with c.create_session("quad", strategy="random",
                                  budget=4, seed=1) as sess:
                cfgs = sess.ask(2)
                assert sess.tell(cfgs, [1.0, 2.0]) == 2
                assert sess.best()[1] == 1.0
        finally:
            httpd.shutdown()
            srv.close()


# ---------------------------------------------------------------------------
# breaker + watchdog stats through the daemon
# ---------------------------------------------------------------------------

class TestPoolResilienceStats:
    def test_breaker_sheds_load_and_surfaces_in_stats(self):
        clk = [0.0]
        dead_calls = [0]

        def dead_backend(cfg):
            dead_calls[0] += 1
            raise TimeoutError("benchmark timed out")

        pool = SharedEvaluationPool({"dead": dead_backend}, max_workers=2,
                                    breaker_threshold=3, breaker_reset_s=5.0,
                                    breaker_clock=lambda: clk[0])
        with pool:
            view = pool.view()
            # distinct configs so the probe cache never answers for us
            reqs = [EvalRequest({"x": float(i)}, workload="dead", seed=i)
                    for i in range(8)]
            # serial submits: let the breaker see each outcome
            results = []
            for r in reqs:
                results += view.gather(view.submit([r]))
            assert all(not r.ok for r in results)
            stats = pool.stats()
            assert stats["breakers"]["dead"] == "open"
            assert stats["shed"] == 8 - dead_calls[0] > 0
            shed = [r for r in results if "circuit breaker open" in r.error]
            assert len(shed) == stats["shed"]
            # recovery: clock past reset -> half-open trial; a healed
            # backend closes the breaker again
            pool.inner.backends["dead"] = lambda cfg: 1.0
            clk[0] += 10.0
            assert pool.stats()["breakers"]["dead"] == "half_open"
            (ok,) = view.gather(view.submit(
                [EvalRequest({"x": 99.0}, workload="dead", seed=99)]))
            assert ok.ok
            assert pool.stats()["breakers"]["dead"] == "closed"

    def test_permanent_failures_never_trip_the_breaker(self):
        def picky(cfg):
            raise ValueError("config infeasible")

        pool = SharedEvaluationPool({"picky": picky}, max_workers=2,
                                    breaker_threshold=2)
        with pool:
            view = pool.view()
            for i in range(6):
                (r,) = view.gather(view.submit(
                    [EvalRequest({"x": float(i)}, workload="picky",
                                 seed=i)]))
                assert not r.ok
            stats = pool.stats()
            assert stats["breakers"]["picky"] == "closed"
            assert stats["shed"] == 0

    def test_server_stats_surface_pool_resilience(self):
        with _server() as srv:
            pool_stats = srv.stats()["pool"]
            assert pool_stats["timed_out"] == 0
            assert pool_stats["shed"] == 0
            assert pool_stats["breakers"] == {}


# ---------------------------------------------------------------------------
# the daemon's device
# ---------------------------------------------------------------------------

class TestDevice:
    def test_every_bo_config_gets_the_daemons_device(self):
        with _server() as srv:
            sessions = [
                srv.create_session("quad", budget=6, seed=2),
                srv.create_session("quad", budget=6, strategy_kwargs=BO_KW),
                srv.create_session("quad", budget=6, strategy_kwargs={
                    "cfg": BOConfig(n_init=3, fit_steps=5)}),
                srv.create_session("quad", strategy="transfer_bo",
                                   budget=6, strategy_kwargs=BO_KW,
                                   transfer_from=True)]
            assert [s.strategy.cfg.device for s in sessions] == ["cpu"] * 4
            # with no cfg the registry's own config, seed included
            assert sessions[0].strategy.cfg.seed == 2
            assert len(sessions[1].run().values) == 6

    def test_cuda_daemon_raises_without_a_card(self):
        if torch.cuda.is_available():
            pytest.skip("a card is present")
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            TuningServer({}, device="cuda")
        from repro_torch.service.__main__ import main
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            main(["--port", "0"])           # --device defaults to cuda


# ---------------------------------------------------------------------------
# across packages: wire names, clients x daemons, snapshots, journals
# ---------------------------------------------------------------------------

def _ref_server(**kw):
    """The reference package's daemon over the same two workloads."""
    from repro.core.space import Knob as RKnob
    from repro.core.space import Space as RSpace
    from repro.service import TuningServer as RServer
    from repro.service import WorkloadSpec as RSpec

    def rspace():
        return RSpace((RKnob("x", "float", 0.5, lo=0.0, hi=1.0),
                       RKnob("y", "float", 0.5, lo=0.0, hi=1.0)))

    kw.setdefault("max_workers", 4)
    return RServer(
        {"quad": RSpec("quad", lambda: (rspace(), SeededQuad())),
         "quad2": RSpec("quad2", lambda: (rspace(), SeededQuad(shift=1.0)))},
        **kw)


def _daemon(package, **kw):
    return _server(**kw) if package == "port" else _ref_server(**kw)


def _client(package, httpd):
    url = f"http://127.0.0.1:{httpd.server_port}"
    if package == "port":
        return TuningClient(url)
    from repro.service import TuningClient as RClient
    return RClient(url)


class TestWireNames:
    @pytest.fixture()
    def wire(self):
        srv = _server()
        httpd, _ = serve_background(srv)
        try:
            yield TuningClient(f"http://127.0.0.1:{httpd.server_port}"), srv
        finally:
            httpd.shutdown()
            srv.close()

    @pytest.mark.parametrize("use_pallas", [False, True])
    def test_use_pallas_is_the_wire_name_of_use_kernel(self, wire,
                                                       use_pallas):
        client, srv = wire
        out = client._call("POST", "/v1/sessions", {
            "workload": "quad", "budget": 6, "strategy_kwargs": {
                "cfg": {**BO_KW["cfg"], "use_pallas": use_pallas}}})
        cfg = srv.session(out["session"]).strategy.cfg
        assert cfg.use_kernel is use_pallas and cfg.device == "cpu"

    @pytest.mark.parametrize("cfg,match", [
        ({"device": "cpu"}, "not a session field"),
        ({"use_pallas": True, "use_kernel": False}, "they differ")])
    def test_refused_cfg_fields(self, wire, cfg, match):
        client, _ = wire
        with pytest.raises(TuningServiceError, match=match) as ei:
            client._call("POST", "/v1/sessions", {
                "workload": "quad", "strategy_kwargs": {"cfg": cfg}})
        assert ei.value.status == 400

    def test_port_client_sends_reference_names(self):
        srv = _ref_server()
        httpd, _ = serve_background(srv)
        try:
            client = _client("port", httpd)
            sess = client.create_session("quad", budget=6, strategy_kwargs={
                "cfg": {**BO_KW["cfg"], "use_kernel": False}})
            assert srv.session(sess.session_id).strategy.cfg.use_pallas \
                is False
            with pytest.raises(ValueError, match="not a session field"):
                client.create_session("quad", strategy_kwargs={
                    "cfg": {"device": "cuda"}})
        finally:
            httpd.shutdown()
            srv.close()


@pytest.mark.parametrize("client_pkg,daemon_pkg", [("ref", "port"),
                                                   ("port", "ref")])
def test_client_drives_the_other_packages_daemon(client_pkg, daemon_pkg):
    """A whole session each way: ask/tell, a server-side BO run, and a
    random run whose trace equals the same run on the client's own
    package's daemon (both numpy, same seeds)."""
    traces = {}
    for pkg in (daemon_pkg, client_pkg):
        srv = _daemon(pkg)
        httpd, _ = serve_background(srv)
        try:
            client = _client(client_pkg, httpd)
            assert client.health()["ok"]
            with client.create_session("quad", strategy="random", budget=6,
                                       seed=4) as sess:
                traces[pkg] = sess.run()["trace"]
            if pkg != daemon_pkg:
                continue
            sess = client.create_session("quad", budget=8, seed=3,
                                         strategy_kwargs=BO_KW)
            cfgs = sess.ask(2)
            assert sess.tell(cfgs, [2.0, 1.0]) == 2
            out = sess.run(budget=6)        # the trace holds the tells
            assert out["n_evaluations"] == 8
            assert out["trace"]["values"][:2] == [2.0, 1.0]
            assert out["best_value"] == min(out["trace"]["values"])
            assert sess.best()[1] == out["best_value"]
            assert len(sess.history()) == 8
        finally:
            httpd.shutdown()
            srv.close()
    assert traces[daemon_pkg] == traces[client_pkg]


@pytest.mark.parametrize("writer,reader", [("port", "ref"), ("ref", "port")])
def test_snapshot_resumes_in_the_other_package(tmp_path, writer, reader):
    import time as _time
    with _daemon(writer, db_root=str(tmp_path), session_ttl=60.0) as srv:
        sess = srv.create_session("quad", budget=8, seed=2,
                                  strategy_kwargs=BO_KW)
        sid = sess.session_id
        cfgs = sess.ask(3)
        sess.tell(cfgs, [3.0, 1.5, 2.0])
        best = sess.best()
        assert srv.evict_idle(now=_time.time() + 3600) == [sid]
    with _daemon(reader, db_root=str(tmp_path)) as srv2:
        resumed = srv2.create_session("quad", budget=8, seed=2,
                                      strategy_kwargs=BO_KW, resume=sid)
        assert resumed.session_id != sid
        assert resumed.best() == best
        assert resumed.strategy.trace.configs == [dict(c) for c in cfgs]
        assert len(resumed.ask(1)) == 1


@pytest.mark.parametrize("writer,reader", [("port", "ref"), ("ref", "port")])
def test_journal_resumes_in_the_other_package(tmp_path, writer, reader):
    """No snapshot: the writer's daemon just stops.  The reader rebuilds
    the same session id from the manifest and the journal; a port
    writer's manifest names the kernel switch as the reference does."""
    cfg = dict(BO_KW["cfg"])
    if writer == "port":
        cfg["use_kernel"] = False
    with _daemon(writer, db_root=str(tmp_path)) as srv:
        sess = srv.create_session("quad", budget=8, seed=2,
                                  strategy_kwargs={"cfg": cfg})
        sid = sess.session_id
        sess.tell(sess.ask(3), [4.0, 2.0, 3.0])
    manifest = json.loads(
        (tmp_path / "sessions" / f"{sid}.meta.json").read_text())
    assert "use_kernel" not in manifest["strategy_kwargs"]["cfg"]
    with _daemon(reader, db_root=str(tmp_path)) as srv2:
        resumed = srv2.create_session("quad", budget=8, seed=2,
                                      strategy_kwargs=BO_KW, resume=sid)
        assert resumed.session_id == sid
        assert len(resumed.strategy.trace.values) == 3
        assert resumed.best()[1] == 2.0
        resumed.tell(resumed.ask(1), [1.5])
        assert len(srv2.log.namespace(sid).records) == 4
