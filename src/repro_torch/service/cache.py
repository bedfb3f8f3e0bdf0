"""Cross-session probe cache — BestConfig's shared-service payoff.

When many tuning sessions probe the same workload, popular measurements
repeat: every client's initial design covers the same region, and clients
created from the same recipe (same strategy, same seed — the "recommended
run" a service hands out) ask for *identical* probes.  The seeded-probe
contract makes those repeats cacheable bit-exactly: a ``(config, fidelity,
seed, workload)`` quadruple fully determines the measurement's noise draw,
so handing one client another client's result is indistinguishable from
re-running the benchmark.

:class:`ProbeCache` deduplicates both *completed* probes (an LRU of
results) and *in-flight* ones (a waiter list per key: the second request
for a probe that is still running attaches to the first instead of
submitting again).  Unseeded requests bypass the cache entirely — without
a pinned noise stream two "identical" probes are different draws and
sharing one would silently halve the evidence.

The cache stores :class:`~repro_torch.core.service.EvalResult` objects from the
*pool's* tickets; the pool re-tickets them per consumer on delivery, so a
cached hit carries the requesting session's own request (its tag, its
uid), only the measurement payload is shared.
"""

from __future__ import annotations

import threading
from collections import OrderedDict
from typing import Any, Dict, List, Optional, Tuple

from repro_torch.core.service import EvalRequest, EvalResult

Waiter = Any                        # opaque consumer token owned by the pool


def _norm(v):
    """Normalize config values for keying: numpy scalars hash/compare
    equal to their Python counterparts, but keys should not depend on
    which side produced the config."""
    item = getattr(v, "item", None)
    return item() if item is not None else v


def probe_key(request: EvalRequest, space=None) -> Optional[Tuple]:
    """Identity of a measurement, or ``None`` when it has no identity.

    A probe without a seed is a fresh noise draw every time — never
    cacheable.  ``n_repeats`` participates because a replicating service
    fans a request into that many sub-measurements (a 2-repeat pooled
    mean is not a 1-repeat value).

    With the workload's ``space``, the config is keyed *projected*:
    :meth:`~repro_torch.core.space.Space.project` normalizes it (clipping,
    gating pins, constraint repair), then knobs that cannot affect the
    measurement — ``inert`` decoys, and knobs whose gate selector holds
    them at an ignored default — are dropped from the key.  Two sessions
    probing configs that differ only in a telemetry knob then share one
    measurement.  The shared result is *semantically* identical, not
    bit-identical: a seeded backend that hashes the full config into its
    noise stream would have drawn differently for each variant — but
    both draws come from the same distribution, which is exactly the
    equivalence the cache trades on (ROADMAP service rung (d))."""
    if request.seed is None:
        return None
    cfg = request.config
    if space is not None:
        cfg = space.project(cfg)
        drop = set()
        for k in space.knobs:
            if k.inert:
                drop.add(k.name)
            elif k.gated_by is not None:
                sel, enabling = k.gated_by
                if cfg.get(sel) not in enabling:
                    drop.add(k.name)     # pinned to default by project()
        items = ((n, v) for n, v in cfg.items() if n not in drop)
    else:
        items = cfg.items()
    return (request.workload, request.fidelity, int(request.seed),
            request.n_repeats,
            tuple(sorted((k, _norm(v)) for k, v in items)))


class ProbeCache:
    """Thread-safe completed-LRU + in-flight waiter registry.

    The lookup/settle pair is atomic per key: a concurrent lookup either
    sees the completed result, or joins the in-flight waiter list, or
    becomes the one registered owner that must actually evaluate — there
    is no window where two owners race the same key.
    """

    def __init__(self, capacity: int = 4096):
        self.capacity = int(capacity)
        self._lock = threading.Lock()
        self._completed: "OrderedDict[Tuple, EvalResult]" = OrderedDict()
        self._inflight: Dict[Tuple, List[Waiter]] = {}
        self.stats: Dict[str, int] = {
            "requests": 0, "hits": 0, "hits_completed": 0,
            "hits_inflight": 0, "misses": 0, "uncached": 0,
            "evictions": 0}

    def lookup(self, key: Optional[Tuple],
               waiter: Waiter) -> Tuple[str, Optional[EvalResult]]:
        """One atomic cache decision for one request.

        Returns ``("hit", result)`` — serve the stored result now;
        ``("wait", None)`` — *waiter* was attached to the in-flight probe
        and will be delivered at :meth:`settle`; ``("miss", None)`` — the
        caller owns the key and must evaluate, then settle;
        ``("uncached", None)`` — unseeded request, evaluate privately.
        """
        with self._lock:
            self.stats["requests"] += 1
            if key is None:
                self.stats["uncached"] += 1
                return "uncached", None
            res = self._completed.get(key)
            if res is not None:
                self._completed.move_to_end(key)
                self.stats["hits"] += 1
                self.stats["hits_completed"] += 1
                return "hit", res
            waiters = self._inflight.get(key)
            if waiters is not None:
                waiters.append(waiter)
                self.stats["hits"] += 1
                self.stats["hits_inflight"] += 1
                return "wait", None
            self._inflight[key] = []
            self.stats["misses"] += 1
            return "miss", None

    def settle(self, key: Tuple, result: EvalResult) -> List[Waiter]:
        """The owner's evaluation landed: release the key's waiters.

        Only *ok* results are stored for future lookups — a failed probe
        is delivered to whoever already waits on it (they asked for this
        measurement and this is its outcome), but the next request for
        the same key re-evaluates rather than replaying an error that may
        have been transient (pool shutdown races, resource pressure).
        """
        with self._lock:
            waiters = self._inflight.pop(key, [])
            if result.ok:
                self._completed[key] = result
                while len(self._completed) > self.capacity:
                    self._completed.popitem(last=False)
                    self.stats["evictions"] += 1
            return waiters

    def forget(self, key: Tuple) -> List[Waiter]:
        """Drop an in-flight registration without storing anything (the
        owner's submit failed before reaching the pool)."""
        with self._lock:
            return self._inflight.pop(key, [])

    @property
    def hit_rate(self) -> float:
        with self._lock:
            return self.stats["hits"] / max(self.stats["requests"], 1)

    def snapshot(self) -> Dict[str, Any]:
        with self._lock:
            return {**self.stats,
                    "completed": len(self._completed),
                    "inflight": len(self._inflight),
                    "hit_rate": (self.stats["hits"]
                                 / max(self.stats["requests"], 1))}

    def __len__(self) -> int:
        with self._lock:
            return len(self._completed)
