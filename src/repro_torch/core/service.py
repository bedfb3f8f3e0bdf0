"""Evaluation services — the Experiment Unit as an asynchronous job queue.

The paper's Experiment Unit runs benchmarks on a test cluster where the
*evaluation* latency, not the optimizer, dominates wall-clock; BestConfig's
parallelized sampling rounds and Magpie's decoupled tuning agent both exploit
that by keeping many measurements in flight.  The bare-float evaluator
contract (``__call__``/``evaluate_batch``) cannot express in-flight work,
fidelities, workloads or failures, so this module replaces it with a
first-class API:

* :class:`EvalRequest`  — what to measure: a config plus its *fidelity*
  (which cluster / cost tier scores it), *workload* (the arch×shape cell
  the measurement belongs to), a free-form *tag* and an optional *seed*;
* :class:`EvalTicket`   — the handle ``submit`` returns for each request;
* :class:`EvalResult`   — value + feasibility/breakdown + ``ok | failed``
  status + per-evaluation wall time.  A worker that raises produces a
  *failed* result, never an exception out of the service;
* :class:`EvaluationService` — the protocol: ``submit`` returns tickets
  immediately, ``poll`` hands back whatever has completed (optionally
  blocking for the first completion), ``gather`` blocks for specific
  tickets, ``drain`` blocks until nothing is in flight.

Three concrete services cover the repo's backends:

* :class:`ImmediateEvaluationService` — the analytic test cluster: every
  request completes *at submit time* through the backend's batched path
  (``evaluate_batch_detailed``/``evaluate_batch`` when present), so the
  vmapped per-row-key noise stream is bit-compatible with the legacy
  evaluator calls.  Accepts one backend or a ``{fidelity: backend}`` dict —
  fidelity is a request field, not a choice of evaluator object.
* :class:`WorkerPoolEvaluationService` — the compiled product cluster: a
  persistent thread pool that streams completions *out of order* as
  compiles finish.
* :class:`CallableServiceAdapter` — keeps any legacy
  ``Callable[[Config], float]`` working (and serves every fidelity with it).

:class:`FidelityRouter` composes per-fidelity services (e.g. an immediate
analytic screen + a pooled compiled promotion) behind one service, and
:func:`as_service` normalizes "service or evaluator or bare callable" at
the Controller boundary.
"""

from __future__ import annotations

import hashlib
import threading
import time
from dataclasses import dataclass, replace
from typing import (Any, Callable, Dict, List, Mapping, Optional, Protocol,
                    Sequence, Tuple, Union, runtime_checkable)

from repro_torch.core.space import Config

DEFAULT_FIDELITY = "test"


def fold_seed(seed: int, i: int) -> int:
    """Derive sub-stream ``i`` of ``seed`` (``jax.random.fold_in``-style
    splitting, host-side): deterministic, stable across processes, and
    collision-resistant, so a replicated request fans into repeats whose
    noise streams are independent yet bit-reproducible.  Stays in the
    63-bit range the analytic evaluator's key builder expects."""
    h = hashlib.blake2s(f"fold|{seed}|{i}".encode()).digest()[:8]
    return int.from_bytes(h, "little") >> 1


# ---------------------------------------------------------------------------
# the request / ticket / result triple
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class EvalRequest:
    """One measurement to run.

    ``fidelity`` names the cluster / cost tier that scores the config (the
    service routes on it); ``workload`` names the cell the measurement
    belongs to (e.g. ``"yi-6b:train_4k"``) so a shared evaluation database
    can be sliced per workload; ``tag`` is the experiment phase (``rank``,
    ``bo``, ``screen``…).  ``seed`` pins the measurement's noise stream:
    the built-in services pass it to seed-aware backends
    (``accepts_seeds`` / ``wants_request``), making any (config,
    fidelity, seed) probe bit-reproducible — the replication contract.
    ``n_repeats`` lets a single request override a
    :class:`~repro_torch.core.replication.ReplicatingService`'s default repeat
    count (the adaptive re-measurement path submits 1-repeat top-ups);
    services that do not replicate ignore it.
    """
    config: Config
    fidelity: str = DEFAULT_FIDELITY
    workload: str = ""
    tag: str = ""
    seed: Optional[int] = None
    n_repeats: Optional[int] = None


@dataclass(frozen=True)
class EvalTicket:
    """Handle for an in-flight request (``uid`` is unique per service)."""
    uid: int
    request: EvalRequest


@dataclass(frozen=True)
class EvalResult:
    """Outcome of one request.  ``status`` is ``"ok"`` or ``"failed"``;
    failed results carry ``value = nan``, the worker's error string, and
    the original exception object (for ``raise ... from`` chains) — the
    *caller* decides the penalty (the async controller records them as
    infeasible instead of killing the run)."""
    ticket: EvalTicket
    value: float
    status: str = "ok"
    feasible: bool = True
    breakdown: Optional[Any] = None     # backend-specific (CostBreakdown)
    error: str = ""
    wall_s: float = 0.0
    exception: Optional[BaseException] = None
    # replication fields (ReplicatingService aggregates): ``value`` is the
    # empirical mean over ``repeats`` successful measurements, ``variance``
    # the variance OF THAT MEAN (failure-widened: failed repeats shrink
    # the effective sample without touching the mean), ``failures`` how
    # many repeats failed.  Single measurements keep the defaults —
    # variance 0.0 means "no empirical noise estimate", and downstream
    # consumers (the heteroscedastic GP) fall back to the global scalar.
    variance: float = 0.0
    repeats: int = 1
    failures: int = 0
    # failure classification (repro_torch.core.resilience): ``"transient"`` —
    # the measurement infrastructure flaked (worker death, timeout,
    # connection reset; retrying the same probe may succeed) vs
    # ``"permanent"`` — the config itself is broken (an infeasible row).
    # ``""`` means unclassified: raw backend failures leave it empty and
    # the resilience layer stamps it after classifying.  Ok results keep
    # the default.
    error_kind: str = ""
    # how many attempts a ResilientService spent on this request (1 =
    # first try succeeded / no resilience layer in the path)
    attempts: int = 1

    @property
    def ok(self) -> bool:
        return self.status == "ok"

    @property
    def request(self) -> EvalRequest:
        return self.ticket.request

    @property
    def config(self) -> Config:
        return self.ticket.request.config


@runtime_checkable
class EvaluationService(Protocol):
    """What the experiment loop needs from an Experiment Unit."""

    def submit(self, requests: Sequence[EvalRequest]) -> List[EvalTicket]:
        """Enqueue requests; returns one ticket per request immediately."""
        ...

    def poll(self, timeout: Optional[float] = 0.0) -> List[EvalResult]:
        """Claim completed-but-unclaimed results, in completion order.
        ``timeout=0`` never blocks; a positive timeout waits up to that
        long for the first completion; ``timeout=None`` blocks until at
        least one result is available or nothing is in flight."""
        ...

    def gather(self, tickets: Sequence[EvalTicket]) -> List[EvalResult]:
        """Block until the given tickets complete; results in ticket order."""
        ...

    def drain(self) -> List[EvalResult]:
        """Block until nothing is in flight; claim everything unclaimed."""
        ...


# ---------------------------------------------------------------------------
# shared ticket / completion bookkeeping
# ---------------------------------------------------------------------------

class _ServiceBase:
    """Thread-safe ticket issue + completion store behind the protocol.

    Subclasses implement :meth:`submit` by calling :meth:`_issue` for the
    tickets and delivering one :meth:`_complete` per ticket (from any
    thread).  Every code path must complete its ticket — exceptions are
    wrapped into failed results — so ``gather``/``drain`` cannot deadlock.
    """

    def __init__(self):
        self._cv = threading.Condition()
        self._uid = 0
        self._inflight: set = set()
        self._done: Dict[int, EvalResult] = {}
        self._order: List[int] = []          # completion order of _done
        self._sink: Optional[Callable[[EvalResult], None]] = None

    # -- subclass side ------------------------------------------------------

    def _issue(self, requests: Sequence[EvalRequest]) -> List[EvalTicket]:
        with self._cv:
            tickets = []
            for r in requests:
                tickets.append(EvalTicket(self._uid, r))
                self._inflight.add(self._uid)
                self._uid += 1
            return tickets

    def _complete(self, result: EvalResult):
        with self._cv:
            uid = result.ticket.uid
            if uid not in self._inflight:
                # late or duplicate completion: the ticket already settled
                # (a hung-probe watchdog fired first, a chaos harness
                # injected a duplicate) — exactly-once delivery is this
                # store's contract, so the straggler is dropped here
                return
            self._inflight.discard(uid)
            sink = self._sink
            if sink is None:
                self._done[uid] = result
                self._order.append(uid)
            self._cv.notify_all()
        if sink is not None:
            sink(result)                    # routed (FidelityRouter)

    # -- protocol side ------------------------------------------------------

    @property
    def in_flight(self) -> int:
        with self._cv:
            return len(self._inflight)

    @property
    def ready(self) -> int:
        """Completed-but-unclaimed results (what ``poll(0)`` would return)."""
        with self._cv:
            return len(self._order)

    def _claim_all(self) -> List[EvalResult]:
        out = [self._done.pop(uid) for uid in self._order]
        self._order.clear()
        return out

    def poll(self, timeout: Optional[float] = 0.0,
             min_results: int = 1) -> List[EvalResult]:
        """Claim completed-but-unclaimed results.  A blocking poll
        (``timeout != 0``) waits for at least ``min_results`` completions
        — or for everything in flight to land, whichever comes first.
        Drivers that coalesce tell waves (``Controller.run_async`` with
        ``min_ask > 1``) use this to wake once per wave instead of once
        per straggler; the default reproduces the one-completion wakeup
        of the base protocol."""
        with self._cv:
            if timeout != 0.0:
                self._cv.wait_for(
                    lambda: len(self._order) >= min_results
                    or not self._inflight, timeout)
            return self._claim_all()

    def gather(self, tickets: Sequence[EvalTicket]) -> List[EvalResult]:
        uids = [t.uid for t in tickets]
        with self._cv:
            unknown = [u for u in uids
                       if u not in self._inflight and u not in self._done]
            if unknown:
                raise KeyError(f"gather: tickets {unknown} are not in flight "
                               "(never submitted here, or already claimed)")
            self._cv.wait_for(lambda: all(u in self._done for u in uids))
            out = [self._done.pop(u) for u in uids]
            claimed = set(uids)
            self._order = [u for u in self._order if u not in claimed]
            return out

    def drain(self) -> List[EvalResult]:
        with self._cv:
            self._cv.wait_for(lambda: not self._inflight)
            return self._claim_all()

    def close(self):                        # overridden by pooled services
        pass

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


# ---------------------------------------------------------------------------
# scoring helpers shared by the concrete services
# ---------------------------------------------------------------------------

_Scored = Tuple[float, bool, Optional[Any], str, str,
                Optional[BaseException]]    # value, feasible, breakdown,
                                            # status, error, exception


def _failed(e: BaseException) -> _Scored:
    return float("nan"), False, None, "failed", repr(e), e


def _seeds_of(requests: Optional[Sequence[Optional[EvalRequest]]],
              n: int) -> List[Optional[int]]:
    if requests is None:
        return [None] * n
    return [r.seed if r is not None else None for r in requests]


def _score_one(backend, cfg: Config,
               request: Optional[EvalRequest] = None) -> _Scored:
    seed = request.seed if request is not None else None
    try:
        detailed = getattr(backend, "evaluate_batch_detailed", None)
        if detailed is not None:
            if seed is not None and getattr(backend, "accepts_seeds", False):
                (v,), (bd,) = detailed([cfg], seeds=[seed])
            else:
                (v,), (bd,) = detailed([cfg])
            return float(v), bool(bd.feasible), bd, "ok", "", None
        if request is not None and getattr(backend, "wants_request", False):
            # request-aware backends (e.g. kernels.autotune.KernelEvaluator)
            # see the fidelity/tag/seed of the measurement they run
            return float(backend(cfg, request=request)), True, None, \
                "ok", "", None
        return float(backend(cfg)), True, None, "ok", "", None
    except Exception as e:                  # a failed benchmark, not a crash
        return _failed(e)


def _score_batch(backend, cfgs: Sequence[Config],
                 requests: Optional[Sequence[EvalRequest]] = None,
                 ) -> List[_Scored]:
    """Batched scoring with per-config failure isolation: the backend's
    batch path is tried first (bit-compatible with the legacy evaluator
    noise stream); if it raises — or returns the wrong number of values,
    which would otherwise orphan tickets and deadlock gather/drain — each
    config is retried alone so one bad config fails one result, not the
    whole batch.  Request seeds ride the batch path on seed-aware
    backends (``accepts_seeds``) so a seeded probe draws the same noise
    whether it is scored batched, alone, or by a worker thread."""
    seeds = _seeds_of(requests, len(cfgs))
    try:
        detailed = getattr(backend, "evaluate_batch_detailed", None)
        if detailed is not None:
            if (any(s is not None for s in seeds)
                    and getattr(backend, "accepts_seeds", False)):
                vals, bds = detailed(cfgs, seeds=seeds)
            else:
                vals, bds = detailed(cfgs)
            out = [(float(v), bool(bd.feasible), bd, "ok", "", None)
                   for v, bd in zip(vals, bds)]
            if len(out) == len(cfgs):
                return out
        else:
            batch = getattr(backend, "evaluate_batch", None)
            if batch is not None:
                out = [(float(v), True, None, "ok", "", None)
                       for v in batch(cfgs)]
                if len(out) == len(cfgs):
                    return out
    except Exception:
        pass                                # isolate the failure per config
    if requests is None:
        requests = [None] * len(cfgs)
    return [_score_one(backend, c, r) for c, r in zip(cfgs, requests)]


def _result(ticket: EvalTicket, scored: _Scored, wall_s: float) -> EvalResult:
    v, feasible, bd, status, err, exc = scored
    return EvalResult(ticket, v, status, feasible, bd, err, wall_s, exc)


Backend = Union[Callable[[Config], float], Any]
Backends = Union[Backend, Mapping[str, Backend]]


class _BackendService(_ServiceBase):
    """Backend table shared by the immediate and pooled services: either a
    single backend serving *every* fidelity, or ``{fidelity: backend}``.
    ``submit`` splits into issue + dispatch so :class:`FidelityRouter` can
    register its ticket map between the two."""

    def __init__(self, backends: Backends,
                 default_fidelity: str = DEFAULT_FIDELITY):
        super().__init__()
        self.default_fidelity = default_fidelity
        if isinstance(backends, Mapping):
            self._any: Optional[Backend] = None
            self.backends: Dict[str, Backend] = dict(backends)
        else:
            self._any = backends
            self.backends = {default_fidelity: backends}

    @property
    def fidelities(self) -> Tuple[str, ...]:
        return tuple(sorted(self.backends))

    def _backend(self, fidelity: str) -> Backend:
        if self._any is not None:
            return self._any
        try:
            return self.backends[fidelity]
        except KeyError:
            raise KeyError(f"no backend for fidelity {fidelity!r}; "
                           f"this service hosts {self.fidelities}") from None

    def submit(self, requests: Sequence[EvalRequest]) -> List[EvalTicket]:
        tickets = self._issue(requests)
        self._dispatch(tickets)
        return tickets

    def _dispatch(self, tickets: Sequence[EvalTicket]) -> None:
        raise NotImplementedError


class ImmediateEvaluationService(_BackendService):
    """The analytic test cluster as a service: every request completes at
    submit time.  Requests are grouped per fidelity and scored through the
    backend's batched path, so an :class:`~repro_torch.core.evaluators.
    AnalyticEvaluator` backend keeps its vmapped per-row-key noise stream —
    a submit of n requests is bit-compatible with the legacy
    ``evaluate_batch`` call (and with n sequential ``__call__``\\ s)."""

    def _dispatch(self, tickets: Sequence[EvalTicket]) -> None:
        groups: Dict[str, List[EvalTicket]] = {}
        for t in tickets:
            groups.setdefault(t.request.fidelity, []).append(t)
        for fidelity, group in groups.items():
            cfgs = [t.request.config for t in group]
            t0 = time.monotonic()
            try:
                backend = self._backend(fidelity)
            except KeyError as e:
                scored = [_failed(e)] * len(cfgs)
            else:
                scored = _score_batch(backend, cfgs,
                                      [t.request for t in group])
            wall = (time.monotonic() - t0) / max(len(cfgs), 1)
            for t, s in zip(group, scored):
                self._complete(_result(t, s, wall))


class CallableServiceAdapter(ImmediateEvaluationService):
    """Legacy shim: any ``Callable[[Config], float]`` (or batch-capable
    evaluator object) as an :class:`EvaluationService`.  The one callable
    serves every fidelity — legacy objective functions know nothing of
    fidelity, so the field passes through to the result untouched."""

    def __init__(self, fn: Backend, default_fidelity: str = DEFAULT_FIDELITY):
        super().__init__(fn, default_fidelity)


class WorkerPoolEvaluationService(_BackendService):
    """The compiled product cluster as a service: a persistent worker pool
    scores one request per worker thread and streams completions *out of
    order* as they finish.  The compile path releases the GIL inside XLA,
    so distinct configs genuinely overlap; a worker that raises delivers a
    failed result, never an exception.  ``close()`` (or use as a context
    manager) shuts the pool down.

    ``deadline_s`` arms the hung-probe watchdog: a ticket whose worker has
    not completed within that many seconds is completed *by the watchdog*
    as a failed-transient result (``error_kind="transient"``) so
    ``gather``/``drain`` terminate instead of wedging behind one stuck
    benchmark.  The worker thread itself cannot be killed (Python threads
    are uninterruptible) — when it eventually finishes, its late result is
    dropped by the completion store's exactly-once guard — so a hung
    backend still occupies a pool slot until it returns; the watchdog
    bounds the *driver's* wait, not the worker's."""

    def __init__(self, backends: Backends, max_workers: int = 4,
                 default_fidelity: str = DEFAULT_FIDELITY,
                 deadline_s: Optional[float] = None):
        super().__init__(backends, default_fidelity)
        self.max_workers = max_workers
        self.deadline_s = deadline_s
        self.timed_out = 0              # watchdog-expired tickets (stats)
        self._pool = None
        self._pool_lock = threading.Lock()
        self._watchdogs: Dict[int, threading.Timer] = {}

    def _ensure_pool(self):
        from concurrent.futures import ThreadPoolExecutor
        with self._pool_lock:
            if self._pool is None:
                self._pool = ThreadPoolExecutor(
                    self.max_workers, thread_name_prefix="evalsvc")
            return self._pool

    def _dispatch(self, tickets: Sequence[EvalTicket]) -> None:
        for t in tickets:
            if self.deadline_s is not None:
                timer = threading.Timer(self.deadline_s, self._expire, (t,))
                timer.daemon = True
                with self._pool_lock:
                    self._watchdogs[t.uid] = timer
                timer.start()
            try:
                self._ensure_pool().submit(self._work, t)
            except RuntimeError as e:
                # racing close(): a ticket is never orphaned — gather/
                # drain on it must terminate, so it completes as failed
                self._cancel_watchdog(t.uid)
                self._complete(_result(t, _failed(e), 0.0))

    def _cancel_watchdog(self, uid: int) -> None:
        with self._pool_lock:
            timer = self._watchdogs.pop(uid, None)
        if timer is not None:
            timer.cancel()

    def _expire(self, ticket: EvalTicket):
        """Watchdog fired: the worker exceeded its deadline.  Complete
        the ticket as failed-transient (a hang is an infrastructure
        fault, not evidence the config is bad) — unless the worker beat
        the timer, in which case ``_complete`` drops this as a dup."""
        with self._pool_lock:
            self._watchdogs.pop(ticket.uid, None)
        with self._cv:
            live = ticket.uid in self._inflight
        if not live:
            return
        self.timed_out += 1
        err = TimeoutError(
            f"probe exceeded its {self.deadline_s}s deadline "
            "(hung worker?)")
        self._complete(replace(
            _result(ticket, _failed(err), float(self.deadline_s or 0.0)),
            error_kind="transient"))

    def _work(self, ticket: EvalTicket):
        t0 = time.monotonic()
        try:
            backend = self._backend(ticket.request.fidelity)
            scored = _score_one(backend, ticket.request.config,
                                ticket.request)
        except Exception as e:              # _backend KeyError and the like
            scored = _failed(e)
        self._cancel_watchdog(ticket.uid)
        self._complete(_result(ticket, scored, time.monotonic() - t0))

    def close(self):
        with self._pool_lock:
            pool, self._pool = self._pool, None
            watchdogs = list(self._watchdogs.values())
            self._watchdogs.clear()
        for timer in watchdogs:
            timer.cancel()
        if pool is not None:
            pool.shutdown(wait=True)


# ---------------------------------------------------------------------------
# composition: many services behind one, routed on the fidelity field
# ---------------------------------------------------------------------------

class FidelityRouter(_ServiceBase):
    """One service facade over per-fidelity services — e.g. an immediate
    analytic ``"screen"`` plus a worker-pooled compiled ``"promote"``.
    Each request is routed by its ``fidelity`` field; completions from
    every route stream back through this router's queue (a route delivers
    into the router, so a routed service should not be polled directly
    while attached).  ``close()`` detaches the routes (and leaves closing
    the underlying services to their owners)."""

    def __init__(self, routes: Mapping[str, _BackendService]):
        super().__init__()
        self.routes: Dict[str, _BackendService] = dict(routes)
        self._map: Dict[Tuple[int, int], EvalTicket] = {}
        self._map_lock = threading.Lock()
        self._sinks: Dict[int, Callable[[EvalResult], None]] = {}
        for svc in self.routes.values():
            sink = (lambda res, sid=id(svc): self._on_result(sid, res))
            self._sinks[id(svc)] = sink
            svc._sink = sink

    def submit(self, requests: Sequence[EvalRequest]) -> List[EvalTicket]:
        tickets = self._issue(requests)
        # issue on the route first, register the uid map, *then* dispatch:
        # an immediate route completes inside its dispatch call.  A
        # request with no route completes as a *failed* result — the
        # service contract (a bad request is a result, never an exception
        # or an orphaned ticket) — so gather/drain cannot deadlock on it.
        by_route: Dict[int, Tuple[_BackendService, List[int]]] = {}
        for i, r in enumerate(requests):
            svc = self.routes.get(r.fidelity)
            if svc is None:
                err = (f"no route for fidelity {r.fidelity!r}; "
                       f"routed: {tuple(sorted(self.routes))}")
                self._complete(EvalResult(tickets[i], float("nan"),
                                          "failed", False, None, err))
            else:
                by_route.setdefault(id(svc), (svc, []))[1].append(i)
        for svc, idxs in by_route.values():
            sub = svc._issue([requests[i] for i in idxs])
            with self._map_lock:
                for i, st in zip(idxs, sub):
                    self._map[(id(svc), st.uid)] = tickets[i]
            svc._dispatch(sub)
        return tickets

    def _on_result(self, sid: int, result: EvalResult):
        with self._map_lock:
            mine = self._map.pop((sid, result.ticket.uid), None)
        if mine is not None:
            self._complete(replace(result, ticket=mine))

    def close(self):
        for svc in self.routes.values():
            if svc._sink is self._sinks.get(id(svc)):
                svc._sink = None


# ---------------------------------------------------------------------------
# normalization at the Controller boundary
# ---------------------------------------------------------------------------

def as_service(obj) -> EvaluationService:
    """Normalize anything evaluator-shaped into an
    :class:`EvaluationService`: a service passes through; a backend that
    declares ``service_kind = "pool"`` (the compiled evaluator — seconds
    per call, GIL released inside XLA) gets a persistent worker pool; any
    other callable — the analytic evaluator, a bare objective function —
    completes immediately through :class:`CallableServiceAdapter`."""
    if isinstance(obj, EvaluationService):
        return obj
    if getattr(obj, "service_kind", "immediate") == "pool":
        deadline = getattr(obj, "deadline_s", None)
        return WorkerPoolEvaluationService(
            obj, max_workers=int(getattr(obj, "max_workers", 4)),
            deadline_s=None if deadline is None else float(deadline))
    if not callable(obj) and not hasattr(obj, "evaluate_batch"):
        raise TypeError(f"cannot adapt {type(obj).__name__} into an "
                        "EvaluationService (not callable, no evaluate_batch, "
                        "no submit/poll/gather/drain)")
    return CallableServiceAdapter(obj)
