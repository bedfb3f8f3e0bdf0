"""Replicated measurements — the paper's answer to benchmark noise.

Sapphire's Experiment Unit averages several runs per configuration to tame
storage-system noise (the "averaging dilemma": too few repeats and the
tuner chases noise, too many and the budget evaporates).  This module is
that replication layer for the evaluation-service stack:

* :class:`RepeatStats` — streaming mean/variance over repeat observations
  (Chan et al. parallel merge), the one place pooled statistics are
  computed so aggregation is invariant to how repeats are grouped;
* :class:`ReplicationPolicy` — how the Controller replicates: fixed-k
  repeats per probe, optionally *adaptive* re-measurement of only the
  configs whose credible interval straddles the incumbent;
* :class:`ReplicatingService` — wraps any built-in evaluation service and
  fans each request into ``n_repeats`` seed-derived sub-probes, returning
  ONE aggregated :class:`~repro_torch.core.service.EvalResult` per request
  (empirical mean, failure-widened variance of the mean, repeat count);
* :class:`AdaptiveRacer` — the re-measurement loop
  :meth:`~repro_torch.core.controller.Controller.run_async` drives: completed
  probes whose interval straddles the current best are topped up with
  extra repeats through the same in-flight machinery instead of being
  told to the strategy at a noisy value.

Seed contract: every sub-probe's seed is derived from the request seed via
:func:`~repro_torch.core.service.fold_seed` (``jax.random.fold_in``-style
splitting), so a replicated measurement is bit-reproducible end to end —
same (config, fidelity, seed) in, same aggregated result out, regardless
of which service ran it or in what order repeats completed.  Requests
without a seed get one derived from the service seed and ticket uid, so a
fresh service replays a fresh run deterministically.
"""

from __future__ import annotations

import math
import threading
from dataclasses import dataclass, field, replace
from typing import Dict, List, Optional, Sequence, Tuple

from repro_torch.core.service import (EvalRequest, EvalResult, EvalTicket,
                                _ServiceBase, fold_seed)


# ---------------------------------------------------------------------------
# pooled repeat statistics
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class RepeatStats:
    """Streaming statistics over the successful repeats of one config.

    ``count`` successful observations with empirical ``mean`` and ``m2``
    (sum of squared deviations — Chan et al.'s merge state, so groups of
    repeats pool to the same statistics however they are split);
    ``failures`` counts repeats that failed.  A failed repeat never
    enters the mean — it *widens* the variance instead, by shrinking the
    effective sample behind :attr:`mean_var`.
    """

    count: int = 0
    mean: float = 0.0
    m2: float = 0.0
    failures: int = 0

    @classmethod
    def from_values(cls, values: Sequence[float],
                    failures: int = 0) -> "RepeatStats":
        st = cls(failures=failures)
        for v in values:
            st = st.push(float(v))
        return st

    def push(self, value: float) -> "RepeatStats":
        """Welford single-observation update."""
        n = self.count + 1
        delta = value - self.mean
        mean = self.mean + delta / n
        return RepeatStats(n, mean, self.m2 + delta * (value - mean),
                           self.failures)

    def merge(self, other: "RepeatStats") -> "RepeatStats":
        """Chan parallel merge: pooled mean/m2 of the two groups."""
        if other.count == 0:
            return replace(self, failures=self.failures + other.failures)
        if self.count == 0:
            return replace(other, failures=self.failures + other.failures)
        n = self.count + other.count
        delta = other.mean - self.mean
        mean = self.mean + delta * other.count / n
        m2 = (self.m2 + other.m2
              + delta * delta * self.count * other.count / n)
        return RepeatStats(n, mean, m2, self.failures + other.failures)

    @property
    def obs_var(self) -> float:
        """Unbiased variance of a single observation (0 when unknowable)."""
        return self.m2 / (self.count - 1) if self.count > 1 else 0.0

    @property
    def mean_var(self) -> float:
        """Failure-widened variance of the reported mean.

        The clean estimator is ``s²/k``; each failed repeat inflates it
        by ``(k + f)/k`` — the measurement spent ``k + f`` runs to get
        ``k`` usable ones, so the reported mean deserves proportionally
        less trust.  This is the per-observation noise the
        heteroscedastic GP consumes.
        """
        if self.count < 2:
            return 0.0
        widen = (self.count + self.failures) / self.count
        return (self.obs_var / self.count) * widen

    @classmethod
    def from_result(cls, result: EvalResult) -> "RepeatStats":
        """Reconstruct merge state from an aggregated result (exact
        inverse of :attr:`mean_var` for ``repeats >= 2``; a single
        measurement contributes its value with unknown spread)."""
        k, f = int(result.repeats), int(result.failures)
        if not result.ok or k <= 0:
            return cls(failures=max(f, 1))
        if k == 1:
            return cls(1, float(result.value), 0.0, f)
        obs_var = float(result.variance) * k * k / (k + f)
        return cls(k, float(result.value), obs_var * (k - 1), f)


# ---------------------------------------------------------------------------
# policy
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class ReplicationPolicy:
    """How the Controller replicates measurements.

    ``n_repeats`` is the fixed-k policy: every probe is measured that
    many times and told to the strategy as one pooled observation.  With
    ``adaptive=True`` the initial count is ``max(n_repeats, 2)`` (a
    variance estimate needs two points) and
    :meth:`~repro_torch.core.controller.Controller.run_async` then re-measures
    — ``increment`` repeats at a time, up to ``max_repeats`` total — only
    the configs whose ``±z``-sd credible interval still straddles the
    incumbent best: exactly the probes whose ranking the noise leaves
    undecided.  Everything else is told at its initial pooled value, so
    the repeat budget concentrates where it changes decisions (the
    paper's fixed-k averaging spends it uniformly).
    """

    n_repeats: int = 1
    adaptive: bool = False
    max_repeats: int = 8
    increment: int = 1
    z: float = 1.0
    seed: int = 0
    gp_prior: bool = True     # adaptive racing intervals borrow the
                              # strategy's GP-implied measurement noise
                              # (when the strategy exposes one) instead
                              # of trusting a 2-repeat empirical variance

    @property
    def initial_repeats(self) -> int:
        k = max(int(self.n_repeats), 1)
        return max(k, 2) if self.adaptive else k

    @property
    def active(self) -> bool:
        return self.adaptive or self.initial_repeats > 1


# ---------------------------------------------------------------------------
# the replicating service wrapper
# ---------------------------------------------------------------------------

class _Group:
    __slots__ = ("ticket", "results", "remaining")

    def __init__(self, ticket: EvalTicket, k: int):
        self.ticket = ticket
        self.results: List[Optional[EvalResult]] = [None] * k
        self.remaining = k


def aggregate_repeats(ticket: EvalTicket,
                      results: Sequence[EvalResult]) -> EvalResult:
    """Pool the repeats of one request into a single result.

    The mean is over *successful* repeats only, computed in slot (seed)
    order so the aggregate is bit-identical regardless of completion
    order; a failed repeat widens :class:`RepeatStats.mean_var` instead
    of poisoning the mean.  All-repeats-failed aggregates to a failed
    result carrying the first error.  ``wall_s`` is the summed
    measurement cost of every repeat, failed ones included.
    """
    ok = [r for r in results if r.ok]
    wall = float(sum(r.wall_s for r in results))
    if not ok:
        first = next(r for r in results if not r.ok)
        return replace(first, ticket=ticket, wall_s=wall,
                       repeats=0, failures=len(results))
    stats = RepeatStats.from_values([r.value for r in ok],
                                    failures=len(results) - len(ok))
    return EvalResult(
        ticket, stats.mean, "ok",
        all(r.feasible for r in ok),
        ok[0].breakdown, "", wall, None,
        variance=stats.mean_var, repeats=stats.count,
        failures=stats.failures)


class ReplicatingService(_ServiceBase):
    """Fan each request into ``n_repeats`` seed-derived sub-probes on the
    wrapped service and aggregate them into one result per request.

    Sub-probe ``i`` of a request carries seed ``fold_seed(base, i)``
    where ``base`` is the request's own seed (or, unseeded, a seed
    derived from this service's ``seed`` and the ticket uid — a fresh
    wrapper therefore replays a fresh run bit for bit).  Repeat ``i`` is
    thus the same measurement whether the request asked for 1 repeat or
    8, and whether the inner service completes in order (immediate) or
    out of order (worker pool).  A request's ``n_repeats`` field
    overrides the wrapper default (the adaptive racer submits 1-repeat
    top-ups this way).

    Completions stream back through the inner service's result sink
    (the :class:`~repro_torch.core.service.FidelityRouter` mechanism), so the
    wrapped service must not be polled directly while attached.
    ``close()`` detaches the sink; closing the inner service stays with
    its owner.  ``measurements`` counts every sub-probe issued — the
    replication budget the benchmarks meter.
    """

    def __init__(self, inner: _ServiceBase, n_repeats: int = 3,
                 seed: int = 0):
        if not isinstance(inner, _ServiceBase):
            raise TypeError(
                "ReplicatingService wraps the built-in service base "
                f"(sink-capable); got {type(inner).__name__}")
        super().__init__()
        self.inner = inner
        self.n_repeats = max(int(n_repeats), 1)
        self.seed = int(seed)
        self.measurements = 0
        self._groups: Dict[int, _Group] = {}
        self._sub: Dict[int, Tuple[int, int]] = {}   # inner uid -> (uid, slot)
        self._rep_lock = threading.Lock()
        inner._sink = self._on_sub

    def submit(self, requests: Sequence[EvalRequest]) -> List[EvalTicket]:
        tickets = self._issue(requests)
        subs: List[EvalRequest] = []
        meta: List[Tuple[int, int]] = []
        for t in tickets:
            r = t.request
            k = max(int(r.n_repeats), 1) if r.n_repeats else self.n_repeats
            base = (r.seed if r.seed is not None
                    else fold_seed(self.seed, t.uid))
            with self._rep_lock:
                self._groups[t.uid] = _Group(t, k)
            for i in range(k):
                subs.append(replace(r, seed=fold_seed(base, i),
                                    n_repeats=None))
                meta.append((t.uid, i))
        # issue on the inner service, register the uid map, THEN dispatch
        # (an immediate inner completes inside its dispatch call — the
        # map must already be in place, and no lock may be held)
        sub_tickets = self.inner._issue(subs)
        with self._rep_lock:
            for st, m in zip(sub_tickets, meta):
                self._sub[st.uid] = m
            self.measurements += len(subs)
        self.inner._dispatch(sub_tickets)
        return tickets

    def _on_sub(self, result: EvalResult):
        with self._rep_lock:
            m = self._sub.pop(result.ticket.uid, None)
            if m is None:
                return
            uid, slot = m
            g = self._groups[uid]
            g.results[slot] = result
            g.remaining -= 1
            if g.remaining:
                return
            del self._groups[uid]
        self._complete(aggregate_repeats(g.ticket, g.results))

    def close(self):
        if self.inner._sink is not None:
            self.inner._sink = None


# ---------------------------------------------------------------------------
# adaptive re-measurement (driven by Controller.run_async)
# ---------------------------------------------------------------------------

class AdaptiveRacer:
    """Decide, per completed probe, whether the measurement is settled.

    A probe's pooled mean carries a ``±z·sd`` credible interval
    (:attr:`RepeatStats.mean_var`).  While that interval straddles the
    incumbent best mean, the probe's rank against the incumbent is
    noise-undecided, so the racer submits ``increment`` more repeats
    through the evaluation service (same config, a fresh fold of the
    seed) instead of releasing the result — the racing principle:
    re-measure only what the noise leaves ambiguous, up to
    ``max_repeats`` total runs per probe.  Single-threaded by design:
    ``run_async`` feeds it from the driver thread only.

    ``noise_prior`` lets the credible interval come from the GP
    posterior, not only the empirical repeat variance: a callable
    ``config -> variance-of-one-measurement`` (raw objective units, or
    ``None`` when no posterior exists yet — e.g.
    :meth:`repro_torch.core.strategy.BOStrategy.measurement_variance`).  A
    2-repeat probe's own variance estimate has a single degree of
    freedom; the GP's fitted noise scalar is pooled over every config
    told so far, so the racer blends the two as a
    ``prior_weight``-pseudo-repeat inverse-chi-square style shrinkage:
    ``(ν·s² + w·σ²_GP) / (ν + w)`` with ``ν = k−1``.  Without a prior
    (the default) the decision rule is exactly the empirical one.
    """

    def __init__(self, policy: ReplicationPolicy, service,
                 noise_prior=None, prior_weight: float = 2.0):
        self.policy = policy
        self.service = service
        self.noise_prior = noise_prior
        self.prior_weight = float(prior_weight)
        self.incumbent = math.inf
        self._groups: Dict[int, dict] = {}       # outer uid -> group state
        self._follow: Dict[int, int] = {}        # follow-up uid -> outer uid

    @property
    def busy(self) -> int:
        """Probes currently held back awaiting top-up repeats."""
        return len(self._groups)

    def offer(self, uid: int, result: EvalResult, asked, prepared):
        """First completion of a probe: release it, or start racing it.
        Returns the ``(result, asked, prepared)`` wave entry when the
        probe is settled, ``None`` when it was held for re-measurement."""
        if not result.ok:
            return result, asked, prepared       # penalty path owns failures
        g = {"stats": RepeatStats.from_result(result),
             "result": result, "asked": asked, "prepared": prepared,
             "measured": int(result.repeats) + int(result.failures),
             "extras": 0}
        return self._decide(uid, g)

    def absorb(self, result: EvalResult):
        """A top-up repeat landed: merge and re-decide.  Returns a wave
        entry when settled, ``None`` when still racing or not ours."""
        uid = self._follow.pop(result.ticket.uid, None)
        if uid is None:
            return None
        g = self._groups.pop(uid)
        g["stats"] = g["stats"].merge(RepeatStats.from_result(result))
        g["measured"] += max(int(result.repeats), 0) + int(result.failures)
        return self._decide(uid, g)

    def _mean_var(self, g: dict) -> float:
        """Variance of the probe's pooled mean for the racing decision:
        empirical by default; with a ``noise_prior``, the per-observation
        variance is shrunk toward the GP's pooled noise estimate
        (``prior_weight`` pseudo-repeats) before dividing by the repeat
        count — small-k probes then race on an interval the whole trace
        informs, not on a 1-dof variance draw."""
        st: RepeatStats = g["stats"]
        if self.noise_prior is None:
            return st.mean_var
        v0 = self.noise_prior(g["asked"])
        if v0 is None or not v0 > 0.0:
            return st.mean_var
        nu = st.count - 1
        pooled = ((nu * st.obs_var + self.prior_weight * v0)
                  / (nu + self.prior_weight))
        widen = (st.count + st.failures) / st.count
        return (pooled / st.count) * widen

    def _decide(self, uid: int, g: dict):
        st: RepeatStats = g["stats"]
        room = self.policy.max_repeats - g["measured"]
        if st.count >= 2 and room > 0:
            sd = math.sqrt(self._mean_var(g))
            lo, hi = st.mean - self.policy.z * sd, st.mean + self.policy.z * sd
            if sd > 0.0 and lo <= self.incumbent <= hi:
                self._remeasure(uid, g, min(self.policy.increment, room))
                return None
        return self._release(g)

    def _remeasure(self, uid: int, g: dict, k: int):
        req: EvalRequest = g["result"].request
        seed = None
        if req.seed is not None:
            # continue the request's own seed stream so explicit-seed
            # replays stay bit-deterministic (unseeded requests let the
            # service derive a fresh base from the new ticket uid)
            g["extras"] += 1
            seed = fold_seed(req.seed, 1_000_000 + g["extras"])
        (t,) = self.service.submit([replace(req, seed=seed, n_repeats=k)])
        self._follow[t.uid] = uid
        self._groups[uid] = g

    def _release(self, g: dict):
        st: RepeatStats = g["stats"]
        self.incumbent = min(self.incumbent, st.mean)
        out = replace(g["result"], value=st.mean, variance=st.mean_var,
                      repeats=st.count, failures=st.failures)
        return out, g["asked"], g["prepared"]
