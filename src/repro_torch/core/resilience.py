"""Resilient evaluation: retries, deadlines, and circuit breaking.

Real test clusters flake — benchmark runs hang, workers die, connections
reset — and a tuner that cannot tell a *transient* infrastructure fault
from a *permanently* broken config either wastes budget on penalty rows
for configs that were fine, or wedges behind a probe that will never
return.  This module is the resilience layer between the experiment loop
and any :class:`~repro_torch.core.service.EvaluationService`:

* :func:`classify_failure` splits failed results into ``"transient"``
  (retrying the same probe may succeed) vs ``"permanent"`` (the config
  itself is broken — an infeasible row, as before).
* :class:`RetryPolicy` — how hard to try: max attempts, exponential
  backoff with *deterministic* jitter (derived from the request seed, so
  a chaos run is bit-replayable), an optional per-attempt timeout and a
  per-request deadline across all attempts.
* :class:`ResilientService` — a wrapper that resubmits
  transiently-failed probes and stamps every outcome with
  ``error_kind`` / ``attempts``.  One outer ticket per request, however
  many inner attempts it took: drivers that count completions (the
  async controller's ``n_evaluations``) are never inflated by retries.
* :class:`CircuitBreaker` — per-backend consecutive-transient-failure
  trip wire used by the shared evaluation pool to shed load instead of
  burning budget against a downed backend, half-opening on a timer.

Retried attempts reuse the *original* measurement seed by default, so a
probe that eventually succeeds reports exactly the measurement the
fault-free run would have — the chaos-gate bit-identity property.  Set
``RetryPolicy(reseed_attempts=True)`` to fold the attempt index into the
seed instead (independent noise per attempt, e.g. when the fault *is*
seed-correlated).
"""

from __future__ import annotations

import hashlib
import threading
import time
from dataclasses import dataclass, field, replace
from typing import Dict, List, Optional, Sequence, Tuple

from repro_torch.core.service import (EvalRequest, EvalResult, EvalTicket,
                                _ServiceBase, fold_seed)

__all__ = [
    "TransientEvalError", "classify_failure", "RetryPolicy",
    "ResilientService", "CircuitBreaker",
]

# seed-fold namespace for reseeded retry attempts — disjoint from the
# replication sub-repeat folds (0..k) and the adaptive racer's top-up
# namespace (1_000_000+), so attempt streams never collide with either
_ATTEMPT_NS = 2_000_000


class TransientEvalError(RuntimeError):
    """An infrastructure fault, not a verdict on the config: raising (or
    wrapping a failure in) this marks the probe as retryable.  The
    hung-probe watchdog, the fault-injection harness and backend shims
    use it to classify unambiguously."""


# exception types that are transient by construction — infrastructure
# hiccups, never evidence about the config under test.  (OSError at
# large is deliberately absent: FileNotFoundError etc. are permanent.)
_TRANSIENT_TYPES = (TransientEvalError, TimeoutError, ConnectionError,
                    BrokenPipeError, InterruptedError)

# message fragments that mark a stringly-typed failure as transient —
# matched case-insensitively against ``EvalResult.error``
_TRANSIENT_PATTERNS = (
    "timeout", "timed out", "deadline", "transient", "temporarily",
    "unavailable", "connection", "reset by peer", "broken pipe",
    "worker died", "worker death", "hung worker", "try again",
)


def classify_failure(result: EvalResult) -> str:
    """``"transient"`` or ``"permanent"`` for a failed result.

    Precedence: an explicit ``error_kind`` stamp (the watchdog and the
    chaos harness know what they injected) > the exception type > error-
    string patterns > ``"permanent"``.  Defaulting to permanent is the
    safe side: a misclassified transient costs one penalty row (exactly
    the pre-resilience behaviour), a misclassified permanent would burn
    retry budget on a config that can never pass.
    """
    if result.error_kind:
        return result.error_kind
    exc = result.exception
    if exc is not None and isinstance(exc, _TRANSIENT_TYPES):
        return "transient"
    msg = result.error.lower()
    if any(p in msg for p in _TRANSIENT_PATTERNS):
        return "transient"
    return "permanent"


@dataclass(frozen=True)
class RetryPolicy:
    """How a :class:`ResilientService` spends attempts on one request.

    ``max_attempts`` counts the first try (3 = one probe + two retries).
    Backoff for retry *i* (1-based) is ``backoff_s * backoff_mult**(i-1)``
    capped at ``max_backoff_s``, scaled by a deterministic jitter factor
    in ``[1 - jitter/2, 1 + jitter/2)`` derived from the request seed —
    no wall-clock or global RNG, so two chaos runs at equal seeds sleep
    identically.  ``attempt_timeout_s`` arms a per-attempt watchdog (an
    attempt that neither completes nor fails within it is treated as a
    transient failure — the recovery path for hung probes and dropped
    completions); ``deadline_s`` bounds the total wall-clock spent across
    all attempts of one request.  ``reseed_attempts`` folds the attempt
    index into the measurement seed on retries (see module docstring for
    why the default reuses the original seed).
    """
    max_attempts: int = 3
    backoff_s: float = 0.05
    backoff_mult: float = 2.0
    max_backoff_s: float = 2.0
    jitter: float = 0.5
    attempt_timeout_s: Optional[float] = None
    deadline_s: Optional[float] = None
    reseed_attempts: bool = False

    def __post_init__(self):
        if self.max_attempts < 1:
            raise ValueError(f"max_attempts must be >= 1, got "
                             f"{self.max_attempts}")

    @property
    def active(self) -> bool:
        """Whether wrapping a service in this policy changes anything."""
        return (self.max_attempts > 1 or self.attempt_timeout_s is not None
                or self.deadline_s is not None)

    def delay_s(self, seed: Optional[int], attempt: int) -> float:
        """Backoff before retry attempt ``attempt`` (2-based: the delay
        preceding the i-th attempt), deterministically jittered."""
        base = min(self.backoff_s * self.backoff_mult ** max(attempt - 2, 0),
                   self.max_backoff_s)
        if base <= 0.0 or self.jitter <= 0.0:
            return max(base, 0.0)
        h = hashlib.blake2s(
            f"retry|{seed}|{attempt}".encode()).digest()[:8]
        u = int.from_bytes(h, "little") / 2.0 ** 64        # [0, 1)
        return base * (1.0 + self.jitter * (u - 0.5))

    def attempt_seed(self, seed: Optional[int], attempt: int) -> Optional[int]:
        """Measurement seed for attempt ``attempt`` (1-based)."""
        if seed is None or attempt == 1 or not self.reseed_attempts:
            return seed
        return fold_seed(seed, _ATTEMPT_NS + attempt)


class ResilientService(_ServiceBase):
    """Retry wrapper over any ticket-store service.

    Issues one *outer* ticket per request and drives up to
    ``policy.max_attempts`` *inner* attempts against the wrapped service.
    Ok results pass through (stamped with ``attempts``); failures are
    classified — permanent ones complete the outer ticket immediately as
    today's infeasible rows, transient ones are resubmitted after a
    deterministic backoff until attempts or the deadline run out, at
    which point the outer ticket completes failed with
    ``error_kind="transient"`` and the full attempt count.

    The wrapped service must expose the ``_issue``/``_dispatch`` split
    (every built-in service does) so attempt registration can precede
    dispatch — immediate services complete *inside* dispatch, and the
    completion must already know which outer ticket it belongs to.  This
    wrapper exposes the same split, so a
    :class:`~repro_torch.core.replication.ReplicatingService` can stack on top:
    each sub-repeat then retries independently, and the Chan merge only
    ever sees one settled result per repeat.
    """

    def __init__(self, inner: _ServiceBase, policy: RetryPolicy = None):
        if not isinstance(inner, _ServiceBase):
            raise TypeError(
                f"ResilientService needs the _issue/_dispatch split of a "
                f"_ServiceBase; got {type(inner).__name__}.  (Wrap the "
                "backend, not an arbitrary protocol object.)")
        super().__init__()
        self.inner = inner
        self.policy = policy if policy is not None else RetryPolicy()
        # stats — mutated under self._cv
        self.retries = 0          # resubmitted attempts
        self.exhausted = 0        # requests that ran out of attempts/deadline
        self.timeouts = 0         # attempts reaped by the attempt watchdog
        # inner uid -> (outer ticket, attempt#); guarded by self._cv
        self._attempts: Dict[int, Tuple[EvalTicket, int]] = {}
        self._started: Dict[int, float] = {}      # outer uid -> t0
        self._timers: Dict[int, threading.Timer] = {}   # keyed by inner uid
        self._retry_timers: Dict[int, threading.Timer] = {}  # by outer uid
        self._closed = False
        inner._sink = self._on_inner

    # -- submission ---------------------------------------------------------

    def submit(self, requests: Sequence[EvalRequest]) -> List[EvalTicket]:
        tickets = self._issue(requests)
        self._dispatch(tickets)
        return tickets

    def _dispatch(self, tickets: Sequence[EvalTicket]) -> None:
        now = time.monotonic()
        with self._cv:
            for t in tickets:
                self._started[t.uid] = now
        for t in tickets:
            self._launch(t, 1)

    def _launch(self, outer: EvalTicket, attempt: int) -> None:
        req = outer.request
        seed = self.policy.attempt_seed(req.seed, attempt)
        if seed != req.seed:
            req = replace(req, seed=seed)
        inner_tickets = self.inner._issue([req])
        it = inner_tickets[0]
        with self._cv:
            self._retry_timers.pop(outer.uid, None)
            if self._closed or outer.uid not in self._inflight:
                # closed (or watchdog settled the outer ticket) while the
                # retry timer was pending: the inner ticket must still
                # complete so the inner store stays consistent
                self._attempts[it.uid] = (outer, -attempt)
            else:
                self._attempts[it.uid] = (outer, attempt)
                if self.policy.attempt_timeout_s is not None:
                    timer = threading.Timer(self.policy.attempt_timeout_s,
                                            self._reap_attempt, (it,))
                    timer.daemon = True
                    self._timers[it.uid] = timer
                    timer.start()
        self.inner._dispatch(inner_tickets)

    # -- completion / retry -------------------------------------------------

    def _reap_attempt(self, inner_ticket: EvalTicket) -> None:
        """Attempt watchdog: the inner service neither completed nor
        failed this attempt in time — synthesize a transient failure so
        the retry machinery (and ultimately ``gather``/``drain``) make
        progress.  A late real completion is ignored (its attempt entry
        is gone)."""
        with self._cv:
            if inner_ticket.uid not in self._attempts:
                return                          # real completion won
            self.timeouts += 1
        err = TransientEvalError(
            f"attempt exceeded its "
            f"{self.policy.attempt_timeout_s}s timeout (hung probe or "
            "dropped completion)")
        self._on_inner(EvalResult(
            ticket=inner_ticket, value=float("nan"), status="failed",
            feasible=False, error=repr(err), exception=err,
            error_kind="transient"))

    def _on_inner(self, result: EvalResult) -> None:
        with self._cv:
            entry = self._attempts.pop(result.ticket.uid, None)
            timer = self._timers.pop(result.ticket.uid, None)
        if timer is not None:
            timer.cancel()
        if entry is None:
            return                  # late completion after the watchdog won
        outer, attempt = entry
        if attempt < 0:
            return                  # orphaned attempt (service closed)

        if result.ok:
            self._complete(replace(result, ticket=outer, attempts=attempt))
            return

        kind = classify_failure(result)
        if kind == "transient" and self._can_retry(outer, attempt):
            with self._cv:
                self.retries += 1
            delay = self.policy.delay_s(outer.request.seed, attempt + 1)
            if delay <= 0.0:
                self._launch(outer, attempt + 1)
                return
            timer = threading.Timer(delay, self._launch,
                                    (outer, attempt + 1))
            timer.daemon = True
            with self._cv:
                if self._closed:
                    delay = None
                else:
                    self._retry_timers[outer.uid] = timer
            if delay is None:
                self._give_up(outer, attempt, result, kind)
            else:
                timer.start()
            return

        if kind == "transient":
            with self._cv:
                self.exhausted += 1
        self._give_up(outer, attempt, result, kind)

    def _can_retry(self, outer: EvalTicket, attempt: int) -> bool:
        if attempt >= self.policy.max_attempts:
            return False
        if self.policy.deadline_s is not None:
            with self._cv:
                t0 = self._started.get(outer.uid)
            if t0 is not None and (time.monotonic() - t0
                                   >= self.policy.deadline_s):
                return False
        return True

    def _give_up(self, outer: EvalTicket, attempt: int,
                 result: EvalResult, kind: str) -> None:
        with self._cv:
            self._started.pop(outer.uid, None)
        self._complete(replace(result, ticket=outer, error_kind=kind,
                               attempts=attempt))

    def _complete(self, result: EvalResult):
        with self._cv:
            self._started.pop(result.ticket.uid, None)
        super()._complete(result)

    # -- protocol plumbing --------------------------------------------------

    def close(self):
        with self._cv:
            self._closed = True
            timers = (list(self._timers.values())
                      + list(self._retry_timers.values()))
            self._timers.clear()
            self._retry_timers.clear()
        for t in timers:
            t.cancel()
        self.inner.close()

    def __exit__(self, *exc):
        self.close()


# ---------------------------------------------------------------------------
# circuit breaker (used per-backend by the shared evaluation pool)
# ---------------------------------------------------------------------------

@dataclass
class CircuitBreaker:
    """Consecutive-transient-failure trip wire.

    ``closed`` (normal): requests flow; each transient failure increments
    a consecutive counter, any success (or permanent failure — those are
    verdicts on configs, not the backend) resets it.  At ``threshold``
    consecutive transient failures the breaker *opens*: :meth:`allow`
    refuses until ``reset_s`` has elapsed, at which point it *half-opens*
    and admits exactly one trial request — success closes the breaker,
    failure re-opens it for another ``reset_s``.

    ``clock`` is injectable for tests (defaults to ``time.monotonic``).
    Not thread-safe by itself — callers (the pool) serialize access under
    their own lock.
    """
    threshold: int = 5
    reset_s: float = 30.0
    clock: object = field(default=time.monotonic, repr=False)

    _failures: int = field(default=0, init=False)
    _state: str = field(default="closed", init=False)
    _opened_at: float = field(default=0.0, init=False)
    _trial_pending: bool = field(default=False, init=False)
    trips: int = field(default=0, init=False)   # times the breaker opened

    @property
    def state(self) -> str:
        if (self._state == "open"
                and self.clock() - self._opened_at >= self.reset_s):
            return "half_open"
        return self._state

    def allow(self) -> bool:
        """Whether a new request may be sent to this backend now."""
        if self._state == "closed":
            return True
        if self.state == "half_open":
            if self._trial_pending:
                return False            # one trial at a time
            self._state = "half_open"
            self._trial_pending = True
            return True
        return False

    def record_success(self) -> None:
        self._failures = 0
        self._trial_pending = False
        self._state = "closed"

    def record_failure(self) -> None:
        """Record a *transient* failure (permanent failures are config
        verdicts — report those as successes of the backend)."""
        self._trial_pending = False
        if self._state in ("open", "half_open"):
            self._state = "open"        # failed trial: re-open the window
            self._opened_at = self.clock()
            return
        self._failures += 1
        if self._failures >= self.threshold:
            self._state = "open"
            self._opened_at = self.clock()
            self.trips += 1
