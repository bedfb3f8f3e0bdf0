"""One tuning session: a Controller + strategy pair owned by the daemon.

A :class:`TuningSession` is the unit a client rents from the server —
the Sapphire recommendation workflow as a stateful conversation.  It
wraps one registry :class:`~repro_torch.core.strategy.SearchStrategy` and one
:class:`~repro_torch.core.controller.Controller` whose evaluation service is a
:class:`~repro_torch.service.pool.PoolView` onto the daemon's shared pool and
whose EvalDB is this session's namespace of the shared sharded log.

Two usage modes share the same strategy state:

* **ask/tell** — the client runs its own benchmarks: ``ask`` proposes
  probe configs, ``tell`` feeds measured values back (recorded into the
  session's namespace with the ``"client"`` fidelity so server-side and
  client-side measurements stay distinguishable in the log);
* **run** — the server drives :meth:`~repro_torch.core.controller.Controller.
  run_async` to completion against the shared pool.  With
  ``deterministic=True`` (the default) the loop runs at the synchronous
  barrier cadence (``max_in_flight = min_ask =`` the strategy's batch
  width) over the view's in-order completions, which makes the trace
  bit-identical to a local ``run_async`` with the same seed — the
  property that lets a cache hit from another session stand in for a
  private evaluation.

All entry points serialize on one reentrant lock: a session is a single
conversation, not a parallel object (concurrency lives across sessions,
in the pool)."""

from __future__ import annotations

import threading
import time
from typing import Dict, List, Optional, Sequence

from repro_torch.core.controller import Controller, EvalRecord, _batch_width
from repro_torch.core.strategy import SearchStrategy, Trace, _json_cfg


class SessionClosed(RuntimeError):
    pass


class TuningSession:
    def __init__(self, session_id: str, workload: str,
                 strategy_name: str, strategy: SearchStrategy,
                 controller: Controller, deterministic: bool = True,
                 budget: Optional[int] = None,
                 batch_size: Optional[int] = None):
        self.session_id = session_id
        self.workload = workload
        self.strategy_name = strategy_name
        self.strategy = strategy
        self.controller = controller
        self.deterministic = deterministic
        self.budget = budget
        self.batch_size = batch_size
        self.created_at = time.time()
        self.last_used = self.created_at
        self.closed = False
        self.runs = 0
        self._lock = threading.RLock()

    def touch(self) -> None:
        """Stamp client activity — the idle clock the server's
        ``session_ttl`` eviction sweep reads."""
        self.last_used = time.time()

    @property
    def db(self):
        return self.controller.db

    def _check_open(self):
        if self.closed:
            raise SessionClosed(f"session {self.session_id} is closed")

    # -- ask/tell (client-side evaluation) ----------------------------------

    def ask(self, n: Optional[int] = None) -> List[Dict]:
        with self._lock:
            self._check_open()
            self.touch()
            return [_json_cfg(c) for c in self.strategy.ask(n)]

    def tell(self, configs: Sequence[Dict], values: Sequence[float],
             variances: Optional[Sequence[float]] = None) -> int:
        if len(configs) != len(values):
            raise ValueError(f"tell: {len(configs)} configs vs "
                             f"{len(values)} values")
        if variances is not None and len(variances) != len(values):
            raise ValueError(f"tell: {len(variances)} variances vs "
                             f"{len(values)} values")
        with self._lock:
            self._check_open()
            self.touch()
            cfgs = [dict(c) for c in configs]
            vals = [float(v) for v in values]
            vrs = ([float(v) for v in variances] if variances is not None
                   else [0.0] * len(vals))
            self.db.append_batch([
                EvalRecord(c, v, 0.0, self.controller.tag, self.workload,
                           "client", "ok", 1, s)
                for c, v, s in zip(cfgs, vals, vrs)])
            Controller._teller(self.strategy)(cfgs, vals, vrs)
            return len(cfgs)

    # -- server-side drive ---------------------------------------------------

    def run(self, budget: Optional[int] = None,
            batch_size: Optional[int] = None,
            fidelity: Optional[str] = None) -> Trace:
        """Drive the strategy to completion on the shared pool.  The
        deterministic barrier cadence submits exactly one strategy-width
        wave at a time and tells it whole — the replayable schedule;
        ``deterministic=False`` sessions run the default overlapped loop
        (faster on a busy pool, order-dependent trace)."""
        with self._lock:
            self._check_open()
            self.touch()
            budget = budget if budget is not None else self.budget
            batch_size = (batch_size if batch_size is not None
                          else self.batch_size)
            kwargs = {}
            if self.deterministic:
                width = _batch_width(self.strategy, batch_size)
                kwargs = {"max_in_flight": width, "min_ask": width}
            if fidelity is not None:
                kwargs["fidelity"] = fidelity
            trace = self.controller.run_async(
                self.strategy, budget=budget, batch_size=batch_size,
                **kwargs)
            self.runs += 1
            self.touch()         # a long run is activity up to its end
            return trace

    # -- introspection -------------------------------------------------------

    def best(self):
        with self._lock:
            self._check_open()
            self.touch()
            cfg, val = self.strategy.best()
            return _json_cfg(cfg), float(val)

    def history(self, limit: Optional[int] = None) -> List[EvalRecord]:
        with self._lock:
            recs = self.db.records
            return recs[-limit:] if limit else recs

    def state(self) -> dict:
        with self._lock:
            self._check_open()
            fn = getattr(self.strategy, "state_dict", None)
            if fn is None:
                raise TypeError(
                    f"strategy {self.strategy_name!r} has no serializable "
                    "state (state_dict unsupported)")
            return fn()

    def describe(self) -> dict:
        trace = getattr(self.strategy, "trace", None)
        return {"session": self.session_id, "workload": self.workload,
                "strategy": self.strategy_name, "budget": self.budget,
                "deterministic": self.deterministic, "closed": self.closed,
                "runs": self.runs, "evaluations": len(self.db),
                "observations": len(trace.values) if trace else 0,
                "created_at": self.created_at,
                "last_used": self.last_used}

    def close(self):
        with self._lock:
            if self.closed:
                return
            self.closed = True
            fn = getattr(self.strategy, "close", None)
            if fn is not None:
                fn()
