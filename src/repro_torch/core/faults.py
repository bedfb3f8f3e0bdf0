"""Deterministic fault injection for the evaluation stack.

A resilience layer you cannot test is a liability, and real-cluster
flakiness is not reproducible on demand — so this module makes it so:
:class:`FaultInjectingService` wraps any ticket-store evaluation service
and injects *seeded* faults per request.  The fault stream is derived
from ``EvalRequest.seed`` (falling back to a config digest), so a chaos
run is bit-replayable: same plan, same seeds, same faults, in the same
places.

Fault kinds (rates set independently by :class:`FaultPlan`):

* **transient** — the probe fails immediately with a
  :class:`~repro_torch.core.resilience.TransientEvalError`, *without* touching
  the backend.  The backend's seeded noise stream therefore stays
  aligned with a fault-free run — the retry (which does reach the
  backend) measures exactly what the fault-free run measured, which is
  what makes the chaos-gate trace bit-identity property testable.
* **death** — same shape, but a ``ConnectionError`` styled as a worker
  death (exercises string/type classification rather than the explicit
  marker).
* **latency** — the dispatch to the backend is delayed by
  ``latency_s`` (stragglers; exercises out-of-order completion paths).
* **hang** — the request is swallowed: never dispatched, never
  completed.  Only a watchdog above (``RetryPolicy.attempt_timeout_s``
  or the worker-pool ``deadline_s``) unwedges it; :meth:`release_hung`
  lets tests settle them manually.
* **drop** — the request reaches the backend but its completion is
  discarded (a lost message; again recovered only by a watchdog).
* **duplicate** — the completion is delivered twice (exercises the
  ticket store's exactly-once guard).

Each (kind, request-key) coin also folds in an *occurrence counter*, so
a retried request draws a fresh coin: a 20%-transient plan fails a
probe's first attempt with p=0.2 and its retry with an independent
p=0.2, instead of deterministically re-failing the same seed forever.
"""

from __future__ import annotations

import hashlib
import threading
from dataclasses import dataclass, replace
from typing import Dict, List, Optional, Sequence, Tuple

from repro_torch.core.resilience import TransientEvalError
from repro_torch.core.service import (EvalRequest, EvalResult, EvalTicket,
                                      _ServiceBase, _failed, _result)

__all__ = ["FaultPlan", "FaultInjectingService"]

# draw order: at most one fault per dispatch, first trip wins — ordered
# most-disruptive-first so e.g. a plan with both hang_rate and
# duplicate_rate set hangs p_hang of requests outright
_KINDS = ("transient", "death", "hang", "drop", "duplicate", "latency")


@dataclass(frozen=True)
class FaultPlan:
    """Per-request fault rates (independent coins, first trip wins, in
    the order transient > death > hang > drop > duplicate > latency).
    ``seed`` namespaces the whole fault stream — two services with equal
    plans inject identical faults on identical request streams."""
    transient_rate: float = 0.0
    death_rate: float = 0.0
    hang_rate: float = 0.0
    drop_rate: float = 0.0
    duplicate_rate: float = 0.0
    latency_rate: float = 0.0
    latency_s: float = 0.05
    seed: int = 0

    def __post_init__(self):
        for kind in _KINDS:
            rate = getattr(self, f"{kind}_rate")
            if not 0.0 <= rate <= 1.0:
                raise ValueError(f"{kind}_rate must be in [0, 1], "
                                 f"got {rate}")

    def rate(self, kind: str) -> float:
        return getattr(self, f"{kind}_rate")

    @property
    def active(self) -> bool:
        return any(self.rate(k) > 0.0 for k in _KINDS)

    def coin(self, kind: str, key: str, occurrence: int) -> bool:
        """Deterministic Bernoulli draw for one fault kind on one
        request occurrence."""
        rate = self.rate(kind)
        if rate <= 0.0:
            return False
        h = hashlib.blake2s(
            f"fault|{self.seed}|{kind}|{key}|{occurrence}".encode()
        ).digest()[:8]
        return int.from_bytes(h, "little") / 2.0 ** 64 < rate

    def draw(self, key: str, occurrence: int) -> Optional[str]:
        """The fault (if any) injected on this occurrence of ``key``."""
        for kind in _KINDS:
            if self.coin(kind, key, occurrence):
                return kind
        return None


def _request_key(req: EvalRequest) -> str:
    """Stable identity of a request for the fault stream: the seed when
    present (the replication/retry machinery folds seeds per repeat, so
    distinct probes get distinct streams), else a digest of what the
    backend would see."""
    if req.seed is not None:
        return str(req.seed)
    items = sorted(req.config.items()) if hasattr(req.config, "items") \
        else repr(req.config)
    return hashlib.blake2s(
        f"{items}|{req.fidelity}|{req.workload}".encode()).hexdigest()[:16]


class FaultInjectingService(_ServiceBase):
    """Chaos wrapper: forwards requests to ``inner`` unless the plan's
    seeded coins say otherwise.  Exposes the ``_issue``/``_dispatch``
    split, so it slots anywhere in the service stack — typically
    *between* the :class:`~repro_torch.core.resilience.ResilientService` and
    the real backend, so the resilience layer is what gets exercised.

    ``injected`` counts faults by kind; ``release_hung()`` completes any
    currently-hung tickets as failed-transient (for tests that want to
    settle the world without a watchdog)."""

    def __init__(self, inner: _ServiceBase, plan: FaultPlan):
        if not isinstance(inner, _ServiceBase):
            raise TypeError(
                f"FaultInjectingService needs the _issue/_dispatch split "
                f"of a _ServiceBase; got {type(inner).__name__}")
        super().__init__()
        self.inner = inner
        self.plan = plan
        self.injected: Dict[str, int] = {k: 0 for k in _KINDS}
        # inner uid -> (outer ticket, mode); mode in {"ok","drop","dup"}
        self._routes: Dict[int, Tuple[EvalTicket, str]] = {}
        self._occurrence: Dict[str, int] = {}
        self._hung: List[EvalTicket] = []
        self._latency_timers: List[threading.Timer] = []
        inner._sink = self._on_inner

    # -- submission ---------------------------------------------------------

    def submit(self, requests: Sequence[EvalRequest]) -> List[EvalTicket]:
        tickets = self._issue(requests)
        self._dispatch(tickets)
        return tickets

    def _dispatch(self, tickets: Sequence[EvalTicket]) -> None:
        for t in tickets:
            key = _request_key(t.request)
            with self._cv:
                occ = self._occurrence.get(key, 0)
                self._occurrence[key] = occ + 1
            kind = self.plan.draw(key, occ)
            if kind is not None:
                with self._cv:
                    self.injected[kind] += 1
            self._apply(t, kind)

    def _apply(self, ticket: EvalTicket, kind: Optional[str]) -> None:
        if kind == "transient":
            err = TransientEvalError("injected transient backend fault")
            self._complete(_result(ticket, _failed(err), 0.0))
        elif kind == "death":
            err = ConnectionError(
                "injected worker death: connection reset by peer")
            self._complete(_result(ticket, _failed(err), 0.0))
        elif kind == "hang":
            with self._cv:
                self._hung.append(ticket)
        elif kind == "latency":
            timer = threading.Timer(self.plan.latency_s,
                                    self._forward, (ticket, "ok"))
            timer.daemon = True
            with self._cv:
                self._latency_timers.append(timer)
            timer.start()
        elif kind == "drop":
            self._forward(ticket, "drop")
        elif kind == "duplicate":
            self._forward(ticket, "dup")
        else:
            self._forward(ticket, "ok")

    def _forward(self, outer: EvalTicket, mode: str) -> None:
        inner_tickets = self.inner._issue([outer.request])
        with self._cv:
            self._routes[inner_tickets[0].uid] = (outer, mode)
        self.inner._dispatch(inner_tickets)

    # -- completion routing -------------------------------------------------

    def _on_inner(self, result: EvalResult) -> None:
        with self._cv:
            route = self._routes.pop(result.ticket.uid, None)
        if route is None:
            return
        outer, mode = route
        if mode == "drop":
            return                      # completion lost in the mail
        settled = replace(result, ticket=outer)
        self._complete(settled)
        if mode == "dup":
            self._complete(settled)     # exactly-once guard drops this

    # -- test hooks ---------------------------------------------------------

    @property
    def hung(self) -> int:
        with self._cv:
            return len(self._hung)

    def release_hung(self) -> int:
        """Complete all currently-hung tickets as failed-transient;
        returns how many were released."""
        with self._cv:
            hung, self._hung = self._hung, []
        for t in hung:
            err = TransientEvalError("injected hang released by harness")
            self._complete(_result(t, _failed(err), 0.0))
        return len(hung)

    def close(self):
        with self._cv:
            timers, self._latency_timers = self._latency_timers, []
        for timer in timers:
            timer.cancel()
        self.release_hung()
        self.inner.close()

    def __exit__(self, *exc):
        self.close()
