"""The process-wide evaluation pool every tuning session shares.

The dCache Sapphire deployment splits an always-on driver from background
benchmark workers; here the split is :class:`SharedEvaluationPool` (one
per daemon) fanning requests from any number of per-session
:class:`PoolView` facades into one
:class:`~repro_torch.core.service.WorkerPoolEvaluationService`.  Three layers:

* :class:`WorkloadPool` — the worker pool, with the backend resolved per
  request by its *workload* field (the core pool routes on fidelity only;
  a daemon hosts many workloads behind one thread pool).
* :class:`PoolView` — what a session's Controller sees: a full
  :class:`~repro_torch.core.service.EvaluationService` whose completions are
  released in **submission order** (a reorder buffer over the pool's
  out-of-order workers).  In-order release is what makes a server-side
  session's trace bit-identical to a local run on an immediate service:
  same tell order, same GP posterior, same next ask.
* :class:`SharedEvaluationPool` — the multiplexer: routes every view
  submission through the cross-session :class:`~repro_torch.service.cache.
  ProbeCache` (completed hits answer inline, in-flight hits attach as
  waiters, misses go to the workers) and re-tickets shared results onto
  each waiting view's own request.
"""

from __future__ import annotations

import threading
import time
from dataclasses import replace
from typing import Dict, List, Optional, Sequence, Tuple

from repro_torch.core.resilience import (CircuitBreaker, TransientEvalError,
                                         classify_failure)
from repro_torch.core.service import (EvalRequest, EvalResult, EvalTicket,
                                      WorkerPoolEvaluationService, _failed,
                                      _result, _score_one, _ServiceBase)
from repro_torch.service.cache import ProbeCache, probe_key


class WorkloadPool(WorkerPoolEvaluationService):
    """Worker pool whose backend table is keyed by *workload*, not
    fidelity: one daemon thread pool serves every hosted workload, and a
    request for an unregistered workload completes as a failed result
    (the service contract — never an exception, never an orphan)."""

    def _work(self, ticket: EvalTicket):
        t0 = time.monotonic()
        try:
            backend = self._workload_backend(ticket.request)
            scored = _score_one(backend, ticket.request.config,
                                ticket.request)
        except Exception as e:
            scored = _failed(e)
        self._complete(_result(ticket, scored, time.monotonic() - t0))

    def _workload_backend(self, request: EvalRequest):
        if self._any is not None:
            return self._any
        try:
            return self.backends[request.workload]
        except KeyError:
            raise KeyError(
                f"no backend for workload {request.workload!r}; "
                f"hosted: {tuple(sorted(self.backends))}") from None

    def add_backend(self, workload: str, backend) -> None:
        self.backends[workload] = backend


class PoolView(_ServiceBase):
    """A session's private window onto the shared pool.

    ``submit`` hands the tickets to the pool; the pool delivers each
    result back through :meth:`_deliver` (from a worker thread, from
    another session's completion, or inline on a cache hit), re-ticketed
    onto this view's own request.  With ``ordered=True`` (the default) a
    result is *released* — made visible to poll/gather — only once every
    earlier submission of this view has been released, so the session's
    driver observes the completion order an immediate service would have
    produced, regardless of worker scheduling or which session's probe
    satisfied the cache."""

    def __init__(self, pool: "SharedEvaluationPool", ordered: bool = True):
        super().__init__()
        self._pool = pool
        self.ordered = ordered
        self._tickets: Dict[int, EvalTicket] = {}
        self._held: Dict[int, EvalResult] = {}
        self._next_release = 0

    def submit(self, requests: Sequence[EvalRequest]) -> List[EvalTicket]:
        tickets = self._issue(requests)
        with self._cv:
            for t in tickets:
                self._tickets[t.uid] = t
        self._pool.dispatch(self, tickets)
        return tickets

    def _deliver(self, uid: int, result: EvalResult) -> None:
        # _cv is an RLock-backed Condition: _complete (and a sink that
        # re-enters submit -> dispatch -> an inline cache hit back into
        # _deliver) may re-acquire it on this thread.  The lock must span
        # the release loop so two workers' deliveries cannot interleave
        # their in-order releases.
        with self._cv:
            mine = self._tickets.pop(uid, None)
            if mine is None:
                return          # duplicate delivery: this uid settled once
            res = replace(result, ticket=mine)
            if not self.ordered:
                self._complete(res)
                return
            self._held[uid] = res
            while self._next_release in self._held:
                nxt = self._next_release
                self._next_release += 1
                self._complete(self._held.pop(nxt))

    def close(self):                # the pool outlives its views
        pass


class SharedEvaluationPool:
    """Multiplexes many :class:`PoolView` consumers over one
    :class:`WorkloadPool` behind one :class:`ProbeCache`.

    The pool owns the only sink on the inner service, so the inner pool
    must not be polled directly while attached.  Completions are mapped
    back to the consumers that asked: the cache-registered owner plus
    every waiter that piled onto the same probe key while it ran."""

    def __init__(self, backends=None, max_workers: int = 4,
                 cache_capacity: int = 4096,
                 deadline_s: Optional[float] = None,
                 breaker_threshold: int = 5, breaker_reset_s: float = 30.0,
                 breaker_clock=time.monotonic):
        self.inner = WorkloadPool(dict(backends or {}),
                                  max_workers=max_workers,
                                  deadline_s=deadline_s)
        self.cache = ProbeCache(cache_capacity)
        # per-workload circuit breakers: a backend tripping
        # breaker_threshold CONSECUTIVE transient failures (worker
        # deaths, probe timeouts — permanent failures are config
        # verdicts and don't count) sheds subsequent load as inline
        # failed-transient completions instead of burning workers and
        # budget against a downed backend; it half-opens after
        # breaker_reset_s and one successful trial closes it again.
        # breaker_threshold <= 0 disables breaking entirely.
        self.breaker_threshold = breaker_threshold
        self.breaker_reset_s = breaker_reset_s
        self._breaker_clock = breaker_clock
        self._breakers: Dict[str, CircuitBreaker] = {}
        self.shed = 0                   # requests refused by open breakers
        # workload -> Space: when registered, probe keys are *projected*
        # (inert/gated knobs dropped) so near-identical probes dedupe
        self.spaces: Dict[str, object] = {}
        self._lock = threading.Lock()
        # inner uid -> (key-or-None, owner view, owner view-uid)
        self._meta: Dict[int, Tuple[Optional[Tuple], PoolView, int]] = {}
        self.inner._sink = self._on_result
        self._views = 0

    # -- consumer side ------------------------------------------------------

    def view(self, ordered: bool = True) -> PoolView:
        with self._lock:
            self._views += 1
        return PoolView(self, ordered=ordered)

    def add_backend(self, workload: str, backend) -> None:
        self.inner.add_backend(workload, backend)

    def register_space(self, workload: str, space) -> None:
        """Declare a workload's search space: from now on its probe keys
        are projected through it (:func:`~repro_torch.service.cache.probe_key`
        with ``space``), so probes differing only in inert or gated-off
        knobs share one cache entry."""
        with self._lock:
            self.spaces[workload] = space

    @property
    def workloads(self) -> Tuple[str, ...]:
        return tuple(sorted(self.inner.backends))

    def dispatch(self, view: PoolView,
                 tickets: Sequence[EvalTicket]) -> None:
        """Route one view's submissions: cache hits answer inline,
        in-flight hits attach as waiters, everything else goes to the
        workers under this pool's own tickets."""
        hits: List[Tuple[int, EvalResult]] = []
        to_submit: List[Tuple[EvalRequest, Optional[Tuple], int]] = []
        for t in tickets:
            # breaker check BEFORE the cache lookup: a refused probe must
            # never register as the cache's in-flight owner (waiters piling
            # onto a probe nobody will run would wedge until eviction)
            if not self._admit(t.request.workload):
                with self._lock:
                    self.shed += 1
                err = TransientEvalError(
                    f"circuit breaker open for workload "
                    f"{t.request.workload!r}: backend shedding load after "
                    "consecutive transient failures")
                hits.append((t.uid, replace(
                    _result(t, _failed(err), 0.0), error_kind="transient")))
                continue
            key = probe_key(t.request, self.spaces.get(t.request.workload))
            verdict, res = self.cache.lookup(key, (view, t.uid))
            if verdict == "hit":
                hits.append((t.uid, res))
            elif verdict == "wait":
                pass                        # delivered at settle time
            else:                           # miss | uncached: we evaluate
                to_submit.append((t.request, key, t.uid))
        if to_submit:
            inner_tickets = self.inner._issue([r for r, _, _ in to_submit])
            with self._lock:
                for it, (_, key, vuid) in zip(inner_tickets, to_submit):
                    self._meta[it.uid] = (key, view, vuid)
            self.inner._dispatch(inner_tickets)
        for vuid, res in hits:
            view._deliver(vuid, res)

    # -- circuit breaking ---------------------------------------------------

    def _breaker(self, workload: str) -> CircuitBreaker:
        b = self._breakers.get(workload)
        if b is None:
            b = self._breakers[workload] = CircuitBreaker(
                threshold=self.breaker_threshold,
                reset_s=self.breaker_reset_s, clock=self._breaker_clock)
        return b

    def _admit(self, workload: str) -> bool:
        if self.breaker_threshold <= 0:
            return True
        with self._lock:
            return self._breaker(workload).allow()

    def _record_outcome(self, result: EvalResult) -> None:
        if self.breaker_threshold <= 0:
            return
        workload = result.request.workload
        with self._lock:
            b = self._breaker(workload)
            if result.ok or classify_failure(result) != "transient":
                # ok — or a permanent failure, which is a verdict on the
                # config, not evidence the backend is down
                b.record_success()
            else:
                b.record_failure()

    # -- inner-pool sink ----------------------------------------------------

    def _on_result(self, result: EvalResult) -> None:
        with self._lock:
            meta = self._meta.pop(result.ticket.uid, None)
        if meta is None:                    # racing close(); drop
            return
        self._record_outcome(result)
        key, owner, owner_uid = meta
        deliveries: List[Tuple[PoolView, int]] = [(owner, owner_uid)]
        if key is not None:
            deliveries += self.cache.settle(key, result)
        # outside every pool/cache lock: delivery may re-enter submit
        for v, uid in deliveries:
            v._deliver(uid, result)

    # -- lifecycle ----------------------------------------------------------

    def stats(self) -> Dict[str, object]:
        with self._lock:
            breakers = {wl: b.state for wl, b in self._breakers.items()}
            shed = self.shed
        return {"cache": self.cache.snapshot(),
                "workloads": list(self.workloads),
                "backend_calls": sum(
                    int(getattr(b, "calls", 0))
                    for b in self.inner.backends.values()),
                "inner_in_flight": self.inner.in_flight,
                "max_workers": self.inner.max_workers,
                "timed_out": self.inner.timed_out,
                "breakers": breakers,
                "shed": shed,
                "views": self._views}

    def close(self):
        self.inner.close()
        self.inner._sink = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
