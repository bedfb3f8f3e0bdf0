"""The SAPPHIRE Controller (paper Fig. 3) — the experiment loop.

Owns the **evaluation database** (append-only JSONL, the paper's store of
"all the system measurement results") and drives any ask/tell
:class:`~repro_torch.core.strategy.SearchStrategy` against any evaluator:

    ctrl = Controller(evaluator, EvalDB("evals.jsonl"), tag="bo")
    trace = ctrl.run(make_strategy("bo", space, cfg=BOConfig(...)))

:meth:`Controller.run` is the single synchronous loop every strategy goes
through — probes are scored as whole batches through the evaluation
*service* (:mod:`repro_torch.core.service`), every batch is one tagged DB
append, and an ``on_round`` hook fires after each round.
:meth:`Controller.run_async` is the overlapped loop the ROADMAP named:
the next ``ask`` batch is submitted while prior results are still in
flight, the strategy is told partial/out-of-order completions as they
stream in, every completion wave is appended to the DB under its writer
lock, and a failed evaluation becomes an infeasible record instead of a
crashed run.  :meth:`Controller.run_successive_halving` adds the
two-fidelity schedule: each round screens a wide candidate batch at the
cheap fidelity and promotes only the top scorers to the high fidelity —
fidelity is a *request field* on the wire, not a choice of evaluator
object.

On a real fleet the controller additionally injects runtime-settable knobs
without restart (``Knob.restart_required=False``) and schedules
recompile/redeploy for the rest — recorded per evaluation so the
recommendation report can state the application cost of the final config.
"""

from __future__ import annotations

import inspect
import json
import threading
import time
import warnings
from dataclasses import dataclass, field
from pathlib import Path
from typing import Callable, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np

try:                      # POSIX advisory file lock for cross-process writers
    import fcntl
except ImportError:       # pragma: no cover - non-POSIX hosts
    fcntl = None

from repro_torch.core.replication import AdaptiveRacer, ReplicationPolicy, \
    ReplicatingService
from repro_torch.core.resilience import ResilientService, RetryPolicy
from repro_torch.core.service import (DEFAULT_FIDELITY, EvalRequest, EvalResult,
                                EvaluationService, as_service, fold_seed)
from repro_torch.core.space import Config, Space
from repro_torch.core.strategy import SearchStrategy, Trace

# default in-flight cap: this many strategy batch widths may be pending
# before run_async stops submitting (see _batch_width)
_IN_FLIGHT_WIDTH_FACTOR = 4


def _batch_width(strategy: SearchStrategy,
                 batch_size: Optional[int]) -> int:
    """The strategy's preferred probes-per-ask, for run_async's default
    in-flight cap: the driver's explicit ``batch_size``, else the
    strategy's own width (``RandomStrategy.batch_size``,
    ``BOConfig.batch_size``, the GA population), else 1."""
    if batch_size:
        return int(batch_size)
    w = getattr(strategy, "batch_size", None)
    if w:
        return int(w)
    cfg = getattr(strategy, "cfg", None)
    if cfg is not None:
        for name in ("batch_size", "population"):
            w = getattr(cfg, name, None)
            if w:
                return int(w)
    return 1


@dataclass
class EvalRecord:
    config: Config
    value: float
    wall_s: float
    tag: str = ""
    workload: str = ""
    fidelity: str = ""
    status: str = "ok"            # "ok" | "failed" (recorded as infeasible)
    repeats: int = 1              # successful repeats pooled into `value`
    variance: float = 0.0         # variance of that pooled mean (0.0 =
                                  # single measurement / no estimate)
    ns: str = ""                  # owning namespace (tuning-service session)
                                  # behind a shared/sharded append log; ""
                                  # = unnamespaced (every legacy record)

    @property
    def ok(self) -> bool:
        return self.status == "ok"


class EvalDB:
    """Append-only evaluation log; reloadable for warm-started ranking.

    Writes are guarded by a lock and flushed per record: concurrent
    worker completions (the async controller streams appends from many
    threads' results) can neither interleave two half-written JSONL lines
    nor leave a torn line behind a crash mid-batch.  Writers that do NOT
    share this object (a second EvalDB on the same path — daemon workers,
    other processes) are serialized by a POSIX advisory file lock per
    append batch.  The corrupt-line skip on reload stays as the last
    line of defense.
    """

    def __init__(self, path: Optional[str] = None,
                 shared_path: bool = False):
        self.path = Path(path) if path else None
        # shared_path declares that OTHER writers (threads holding their
        # own EvalDB, daemon workers, other processes) may append to this
        # file concurrently: without advisory file locks that cannot be
        # made safe, so the append fails loudly instead
        self.shared_path = shared_path
        self.records: List[EvalRecord] = []
        self._lock = threading.Lock()
        if self.path and self.path.exists():
            self._heal_tail()
        if self.path and self.path.exists():
            for i, line in enumerate(self.path.read_text().splitlines()):
                if not line.strip():
                    continue
                try:
                    d = json.loads(line)
                    rec = EvalRecord(
                        {k: _json_safe(v) for k, v in d["config"].items()},
                        float("nan") if d["value"] is None
                        else float(d["value"]), float(d.get("wall_s", 0.0)),
                        str(d.get("tag", "")), str(d.get("workload", "")),
                        str(d.get("fidelity", "")),
                        str(d.get("status", "ok")),
                        int(d.get("repeats", 1)),
                        float(d.get("variance", 0.0)),
                        str(d.get("ns", "")))
                except (json.JSONDecodeError, KeyError, TypeError,
                        ValueError):
                    # a crashed writer leaves a truncated trailing line;
                    # the rest of the log is still good history
                    warnings.warn(f"EvalDB: skipping corrupt line {i + 1} "
                                  f"of {self.path}")
                    continue
                self.records.append(rec)

    def _heal_tail(self):
        """Crash-truncation self-heal: a writer killed mid-append leaves a
        partial trailing JSONL line, which used to be "corrupt, skipped
        with warning" on *every* subsequent load, forever.  On load,
        inspect the tail under the same advisory file lock appends take:
        a parseable final line merely missing its newline gets one
        appended; an unparseable fragment is moved to ``<path>.quarantine``
        (preserved for forensics, never silently discarded) and the log
        truncated back to its last complete line — so a shared log
        self-heals once instead of warning forever, and the next append
        starts on a clean line boundary instead of extending the torn
        one into a second corrupt record."""
        with self.path.open("r+b") as f:
            if fcntl is not None:
                fcntl.flock(f.fileno(), fcntl.LOCK_EX)
            data = f.read()
            if not data or data.endswith(b"\n"):
                return
            cut = data.rfind(b"\n") + 1          # 0 if no newline at all
            tail = data[cut:]
            try:
                json.loads(tail.decode("utf-8"))
                # complete record, torn newline (killed between write and
                # flush of the terminator): finish the line in place
                f.write(b"\n")
                return
            except (json.JSONDecodeError, UnicodeDecodeError):
                pass
            quarantine = self.path.with_name(self.path.name + ".quarantine")
            with quarantine.open("ab") as q:
                q.write(tail + b"\n")
            f.truncate(cut)
            warnings.warn(
                f"EvalDB: quarantined {len(tail)}-byte torn tail of "
                f"{self.path} (crashed writer) to {quarantine}")

    @staticmethod
    def _sanitize(rec: EvalRecord) -> EvalRecord:
        """Normalize numpy scalars at append time so in-memory records,
        the JSONL on disk, and reloaded records all compare equal."""
        return EvalRecord({k: _json_safe(v) for k, v in rec.config.items()},
                          float(_json_safe(rec.value)), rec.wall_s, rec.tag,
                          rec.workload, rec.fidelity, rec.status,
                          int(rec.repeats), float(rec.variance), rec.ns)

    @staticmethod
    def _line(rec: EvalRecord) -> str:
        # a non-finite value (a failed evaluation recorded before the
        # raise) serializes as null, keeping every line strict JSON
        d = {"config": rec.config,
             "value": rec.value if np.isfinite(rec.value) else None,
             "wall_s": rec.wall_s, "tag": rec.tag}
        # only write the async-era fields when informative: the common
        # synchronous line stays short and byte-stable for existing
        # tooling (the default fidelity reloads as "", meaning
        # unspecified — same as legacy lines)
        if rec.workload:
            d["workload"] = rec.workload
        if rec.fidelity and rec.fidelity != DEFAULT_FIDELITY:
            d["fidelity"] = rec.fidelity
        if rec.status != "ok":
            d["status"] = rec.status
        # replication fields only when an aggregate was recorded: legacy
        # single-measurement lines stay byte-stable, and legacy logs
        # reload with the defaults (repeats=1, variance=0.0)
        if rec.repeats != 1:
            d["repeats"] = rec.repeats
        if rec.variance:
            d["variance"] = rec.variance
        if rec.ns:
            d["ns"] = rec.ns
        return json.dumps(d) + "\n"

    def append(self, rec: EvalRecord):
        self.append_batch([rec])

    def append_batch(self, recs: Sequence[EvalRecord]):
        """Record a whole evaluation batch under the writer lock, flushing
        line by line — a batched experiment is the unit of work, and a
        crash can truncate at most the line being written.

        The in-process ``threading.Lock`` only serializes writers sharing
        THIS EvalDB object; two daemon workers (or two processes) each
        holding their own EvalDB on the same path would interleave lines
        through it.  Every append therefore additionally takes a POSIX
        advisory lock (``flock``) on the open file — an exclusive lock
        per batch, released when the file closes — so concurrent writers
        anywhere on the host serialize whole batches instead of
        interleaving half-written JSONL lines.  On hosts without
        ``fcntl`` the append fails loudly rather than risking silent
        corruption when a second writer is plausible (the tuning daemon
        sets ``shared_path=True`` on its shard logs)."""
        recs = [self._sanitize(r) for r in recs]
        if not recs:
            return
        with self._lock:
            self.records.extend(recs)
            if self.path:
                self.path.parent.mkdir(parents=True, exist_ok=True)
                if fcntl is None and getattr(self, "shared_path", False):
                    raise RuntimeError(
                        f"EvalDB({self.path}): marked as shared between "
                        "writers but this host has no fcntl advisory "
                        "locks — concurrent appends could interleave "
                        "corrupt JSONL lines")
                with self.path.open("a") as f:
                    if fcntl is not None:
                        fcntl.flock(f.fileno(), fcntl.LOCK_EX)
                    for r in recs:
                        f.write(self._line(r))
                        f.flush()

    def pairs(self, tag: Optional[str] = None,
              workload: Optional[str] = None,
              include_failed: bool = False,
              ) -> Tuple[List[Config], List[float]]:
        rs = [r for r in self.records
              if (tag is None or r.tag == tag)
              and (workload is None or r.workload == workload)
              and (include_failed or r.ok)]
        return [r.config for r in rs], [r.value for r in rs]

    def __len__(self):
        return len(self.records)


def _json_safe(v):
    if isinstance(v, (np.integer,)):
        return int(v)
    if isinstance(v, (np.floating,)):
        return float(v)
    if isinstance(v, (np.bool_,)):
        return bool(v)
    return v


@dataclass
class Controller:
    """Experiment Unit driver: evaluates configs through an evaluation
    *service*, logs to the DB, and runs the ask/tell loop for any search
    strategy.

    ``evaluate`` may be anything :func:`repro_torch.core.service.as_service`
    accepts — an :class:`~repro_torch.core.service.EvaluationService`, an
    evaluator object, or a bare ``Callable[[Config], float]``; the
    resolved service is cached and shared across ``with_tag``/
    ``with_prepare``/``with_workload`` derivatives (one worker pool, not
    one per tag).

    ``prepare`` (optional) maps a strategy-side config to the full config
    the evaluator runs — e.g. expanding a top-K sub-config over pinned
    defaults.  The *prepared* config is what the DB records, so the log
    always holds runnable configurations.  ``workload`` names the cell
    (e.g. ``"yi-6b:train_4k"``) every request/record is stamped with.

    ``replication`` (a :class:`~repro_torch.core.replication.ReplicationPolicy`)
    turns on replicated measurements: the resolved service is wrapped in a
    :class:`~repro_torch.core.replication.ReplicatingService` that fans every
    probe into ``initial_repeats`` seed-derived sub-measurements and
    returns one pooled result (mean + variance-of-mean + repeat count);
    with ``adaptive=True``, :meth:`run_async` additionally re-measures —
    through the same in-flight machinery — only the probes whose credible
    interval still straddles the incumbent best.  ``seed`` pins the whole
    run's measurement streams: every request is stamped with a
    deterministic per-submission seed (``fold_seed(seed, counter)``), so
    a replayed run on a fresh controller + fresh service reproduces every
    noise draw bit for bit — even through an out-of-order worker pool.
    """

    evaluate: Union[Callable[[Config], float], EvaluationService]
    db: EvalDB = field(default_factory=EvalDB)
    tag: str = ""
    prepare: Optional[Callable[[Config], Config]] = None
    workload: str = ""
    replication: Optional[ReplicationPolicy] = None
    seed: Optional[int] = None
    resilience: Optional[RetryPolicy] = None

    @property
    def service(self) -> EvaluationService:
        svc = getattr(self, "_service", None)
        if svc is None:
            svc = as_service(self.evaluate)
            if self.resilience is not None and self.resilience.active:
                # retries live BELOW replication: each sub-repeat retries
                # independently, the Chan merge only ever sees settled
                # repeats, and a retried probe completes its one outer
                # ticket exactly once — so n_evaluations (and the budget
                # the strategy was told) never inflate under faults
                svc = ResilientService(svc, self.resilience)
            if self.replication is not None and self.replication.active:
                svc = ReplicatingService(
                    svc, n_repeats=self.replication.initial_repeats,
                    seed=self.replication.seed)
            self._service = svc
        return svc

    def _derive(self, **changes) -> "Controller":
        kw = {"evaluate": self.evaluate, "db": self.db, "tag": self.tag,
              "prepare": self.prepare, "workload": self.workload,
              "replication": self.replication, "seed": self.seed,
              "resilience": self.resilience}
        kw.update(changes)
        c = Controller(**kw)
        # resolve eagerly so every derivative shares THIS controller's
        # service (one worker pool total, not one per tag) — resolution
        # is cheap: pooled services spawn threads on first submit only
        c._service = self.service
        return c

    def with_tag(self, tag: str) -> "Controller":
        return self._derive(tag=tag)

    def with_prepare(self, prepare: Callable[[Config], Config]) -> "Controller":
        return self._derive(prepare=prepare)

    def with_workload(self, workload: str) -> "Controller":
        return self._derive(workload=workload)

    def with_replication(self, policy: ReplicationPolicy) -> "Controller":
        """Derivative with replicated measurements.  Unlike the other
        ``with_*`` helpers the service is NOT shared: the policy decides
        how the service wraps, so the derivative resolves its own (the
        underlying backend object is still the same one)."""
        kw = {"evaluate": self.evaluate, "db": self.db, "tag": self.tag,
              "prepare": self.prepare, "workload": self.workload,
              "replication": policy, "seed": self.seed,
              "resilience": self.resilience}
        return Controller(**kw)

    def with_resilience(self, policy: RetryPolicy) -> "Controller":
        """Derivative with retried evaluation.  Like
        :meth:`with_replication`, the service is NOT shared: the policy
        decides how the backend wraps, so the derivative resolves its
        own stack (same backend object underneath)."""
        kw = {"evaluate": self.evaluate, "db": self.db, "tag": self.tag,
              "prepare": self.prepare, "workload": self.workload,
              "replication": self.replication, "seed": self.seed,
              "resilience": policy}
        return Controller(**kw)

    # ---- synchronous evaluation ---------------------------------------------

    def __call__(self, cfg: Config) -> float:
        return self.evaluate_batch([cfg])[0]

    def _requests(self, cfgs: Sequence[Config],
                  fidelity: str) -> Tuple[List[Config], List[EvalRequest]]:
        cfgs = [dict(c) for c in cfgs]
        if self.prepare:
            cfgs = [self.prepare(c) for c in cfgs]
        seeds: List[Optional[int]] = [None] * len(cfgs)
        if self.seed is not None:
            # per-submission seed stream: request i of a seeded run is the
            # same measurement on every replay (fresh controller + fresh
            # service), regardless of service completion order
            base = getattr(self, "_seed_count", 0)
            self._seed_count = base + len(cfgs)
            seeds = [fold_seed(self.seed, base + i)
                     for i in range(len(cfgs))]
        return cfgs, [EvalRequest(c, fidelity, self.workload, self.tag, s)
                      for c, s in zip(cfgs, seeds)]

    def _record(self, result: EvalResult, cfg: Config, value: float,
                wall_s: Optional[float] = None) -> EvalRecord:
        return EvalRecord(cfg, value,
                          result.wall_s if wall_s is None else wall_s,
                          self.tag, self.workload, result.request.fidelity,
                          result.status, int(result.repeats),
                          float(result.variance))

    @staticmethod
    def _teller(strategy: SearchStrategy):
        """Variance-aware tell, feature-detected (the same pattern as the
        poll ``min_results`` probe): strategies whose ``tell`` accepts a
        ``variances`` argument get the per-observation measurement
        variance alongside the values; legacy two-argument strategies are
        told exactly as before."""
        try:
            wants = ("variances"
                     in inspect.signature(strategy.tell).parameters)
        except (TypeError, ValueError):
            wants = False
        if wants:
            return strategy.tell
        return lambda cfgs, vals, variances=None: strategy.tell(cfgs, vals)

    def _evaluate_sync(self, cfgs: Sequence[Config],
                       fidelity: str) -> List[EvalResult]:
        svc = self.service
        cfgs, reqs = self._requests(cfgs, fidelity)
        t0 = time.monotonic()
        results = svc.gather(svc.submit(reqs))
        wall = (time.monotonic() - t0) / max(len(cfgs), 1)
        self.db.append_batch([self._record(r, c, float(r.value), wall)
                              for c, r in zip(cfgs, results)])
        failed = [r for r in results if not r.ok]
        if failed:
            raise RuntimeError(
                f"{len(failed)}/{len(results)} evaluations failed; "
                f"first: {failed[0].error}") from failed[0].exception
        return results

    def evaluate_batch(self, cfgs: Sequence[Config],
                       fidelity: str = DEFAULT_FIDELITY) -> List[float]:
        """Submit a whole batch and block for it (the synchronous
        contract): one tagged DB append, each record's ``wall_s`` the
        batch wall-clock amortized per config.  A failed evaluation is
        recorded (status ``failed``) and then raised — synchronous callers
        treat a broken benchmark as an error; the async loop is the path
        that survives failures."""
        return [float(r.value)
                for r in self._evaluate_sync(cfgs, fidelity)]

    # ---- the experiment loop ------------------------------------------------

    def run(self, strategy: SearchStrategy, budget: Optional[int] = None,
            batch_size: Optional[int] = None,
            fidelity: str = DEFAULT_FIDELITY,
            on_round: Optional[Callable[[int, List[Config], List[float]],
                                        None]] = None) -> Trace:
        """Drive ``strategy`` to completion: ask a probe batch, score it,
        tell the results, repeat until the strategy's budget is told (or
        ``budget`` evaluations have been spent here, when given).

        ``on_round(round_index, configs, values)`` fires after each tell.
        This is the synchronous barrier loop; :meth:`run_async` is the
        overlapped one.
        """
        spent = 0
        rnd = 0
        tell = self._teller(strategy)
        while not strategy.finished:
            n = batch_size
            remaining = None
            if budget is not None:
                remaining = budget - spent
                if remaining <= 0:
                    break
                if n is not None:
                    n = min(n, remaining)
            cfgs = strategy.ask(n)
            if not cfgs:
                break
            if remaining is not None and len(cfgs) > remaining:
                # cap the spend without distorting the strategy's batch
                # width: the final round is truncated, not re-asked
                cfgs = cfgs[:remaining]
            results = self._evaluate_sync(cfgs, fidelity)
            vals = [float(r.value) for r in results]
            tell(cfgs, vals, [float(r.variance) for r in results])
            spent += len(cfgs)
            if on_round is not None:
                on_round(rnd, cfgs, vals)
            rnd += 1
        return strategy.trace

    def run_async(self, strategy: SearchStrategy,
                  budget: Optional[int] = None,
                  batch_size: Optional[int] = None,
                  max_in_flight: Optional[int] = None,
                  min_ask: int = 1,
                  fidelity: str = DEFAULT_FIDELITY,
                  failure_value: Optional[float] = None,
                  on_round: Optional[Callable[[int, List[Config],
                                               List[float]], None]] = None,
                  on_ask: Optional[Callable[[int, float], None]] = None,
                  ) -> Trace:
        """The overlapped experiment loop (ROADMAP's async follow-on).

        Keeps the evaluation service saturated: the next ``ask`` batch is
        submitted while prior probes are still in flight, and the strategy
        is ``tell``-ed each completion *wave* — partial and out of order —
        as results stream back (the seam the ask/tell protocol guarantees:
        in-flight probes already count against the strategy's budget, so
        the GP refit no longer gates probe submission).  Every wave is one
        tagged DB append under the writer lock.

        A failed evaluation does not kill the run: it is recorded with
        status ``failed`` (excluded from ``pairs()`` by default) and told
        to the strategy at a penalty value — ``failure_value`` if given,
        otherwise strictly past the worst value observed so far (a finite
        "this region is bad" signal; ``inf``/``nan`` would flatten the
        GP, and anything not clearly worse than the incumbent could make
        a broken config look attractive).  A failure landing before *any*
        success is held back and priced once the first real value fixes
        the objective's scale — a guessed absolute penalty could
        accidentally beat genuine values; only if the whole run fails is
        the fallback ``1e6`` used (no best exists to corrupt then).

        ``max_in_flight`` caps concurrent submissions.  The default
        (``None``) caps at ``4 ×`` the strategy's batch width
        (:func:`_batch_width`): a slow service can no longer absorb the
        whole remaining budget against one stale posterior — submission
        pauses until results land and the surrogate catches up.  The
        automatic cap only *gates* further asks, it never shapes an
        ask's width (an explicit ``max_in_flight`` does both, via
        ``room`` below), so on an immediate service — where results land
        before the next ask and nothing ever accumulates — traces are
        unchanged.  Pass ``max_in_flight <= 0`` for the old unbounded
        behavior;
        ``min_ask > 1`` coalesces completion waves — with probes still in
        flight, the loop waits until that many slots are free before the
        next ``ask``, so an expensive proposer (a GP refit per ask) is
        amortized over a q-batch instead of re-running for every single
        straggler (set it to about half the worker count; ``min_ask =
        max_in_flight`` degenerates to the synchronous barrier).  On
        services whose ``poll`` supports ``min_results`` (all built-in
        ones) the blocking poll coalesces too: the driver wakes once per
        min_ask-wide wave — one tell, one DB append — instead of once
        per completed probe.
        ``on_round(round_index, configs, values)`` fires per completion
        wave.  Submission yields to completed results — the loop tells
        what has landed before asking for more — so on an immediate
        (analytic) service this reproduces :meth:`run` exactly: same
        noise stream, same trace.

        ``on_ask(n_asked, wall_s)`` fires after every ``strategy.ask``
        that returned probes, with the batch width and the ask's
        wall-clock — the submission-latency probe (empty asks from a
        blocked or exhausted strategy are not latencies worth recording).
        The proposer is the only part of
        this loop that can stall submission; with a strategy that fits
        its surrogate in the background (``BOConfig.refit_async``) these
        latencies stay at evaluation-dispatch scale regardless of
        ``fit_steps``, which is exactly what the hook exists to verify
        (see ``benchmarks/perf_gp_ask.py``).
        """
        svc = self.service
        # adaptive replication: completed probes whose credible interval
        # straddles the incumbent are held back and re-measured through
        # the same service before being told (racing, not fixed-k).  A
        # strategy exposing a GP-implied measurement_variance lends the
        # racer its posterior: 2-repeat probes then race on intervals
        # pooled across configs, not 1-dof empirical variance draws
        racer = None
        if self.replication is not None and self.replication.adaptive:
            prior = (getattr(strategy, "measurement_variance", None)
                     if getattr(self.replication, "gp_prior", True) else None)
            racer = AdaptiveRacer(self.replication, svc, noise_prior=prior)
        tell = self._teller(strategy)
        auto_cap = auto_width = None
        if max_in_flight is None:
            auto_width = _batch_width(strategy, batch_size)
            auto_cap = _IN_FLIGHT_WIDTH_FACTOR * auto_width
        elif max_in_flight <= 0:
            max_in_flight = None                         # explicit unbounded
        pending: Dict[int, Tuple[Config, Config]] = {}   # uid -> (asked,
        spent = 0                                        #         prepared)
        rnd = 0
        worst = float("-inf")
        # wave-coalescing poll: services whose poll supports min_results
        # (every _ServiceBase subclass) let the driver sleep through a
        # whole min_ask-wide wave instead of waking per straggler; other
        # protocol implementations keep the one-completion wakeup
        try:
            poll_coalesces = ("min_results"
                              in inspect.signature(svc.poll).parameters)
        except (TypeError, ValueError):
            poll_coalesces = False

        def submit_more():
            nonlocal spent
            while not strategy.finished:
                if getattr(svc, "ready", 0) > 0:
                    return          # landed results first: fresher asks
                if budget is not None and spent >= budget:
                    return
                if (auto_cap is not None and pending
                        and len(pending) + auto_width > auto_cap):
                    return      # bounded staleness: the next ask-wide
                    #             wave would push in-flight past the cap
                room = None
                if max_in_flight is not None:
                    room = max_in_flight - len(pending)
                    if room <= 0:
                        return
                    if pending and room < min(
                            min_ask,
                            budget - spent if budget is not None
                            else min_ask):
                        return      # coalesce: amortize the next ask
                n = batch_size
                if budget is not None and n is not None:
                    # a budget never overrides ask(None) — the strategy's
                    # preferred batch is truncated below, exactly as in
                    # run(), so the two loops stay trace-identical
                    n = min(n, budget - spent)
                if room is not None:
                    n = room if n is None else min(n, room)
                t_ask = time.monotonic()
                asked = strategy.ask(n)
                if not asked:
                    return
                if on_ask is not None:
                    on_ask(len(asked), time.monotonic() - t_ask)
                if budget is not None and len(asked) > budget - spent:
                    # cap the spend without distorting the strategy's
                    # batch width: the final round is truncated
                    asked = asked[:budget - spent]
                asked = [dict(c) for c in asked]
                prepared, reqs = self._requests(asked, fidelity)
                for t, a, p in zip(svc.submit(reqs), asked, prepared):
                    pending[t.uid] = (a, p)
                spent += len(asked)

        deferred: List[Tuple[EvalResult, Config, Config]] = []

        def tell_wave(wave):
            nonlocal rnd
            if failure_value is not None:
                penalty = failure_value
            elif np.isfinite(worst):
                penalty = worst + max(abs(worst), 1.0)
            else:
                penalty = 1e6       # the whole run failed: scale unknowable
            asked_cfgs: List[Config] = []
            values: List[float] = []
            variances: List[float] = []
            records: List[EvalRecord] = []
            for r, asked_c, prepared_c in wave:
                v = float(r.value) if r.ok else penalty
                records.append(self._record(r, prepared_c, v))
                asked_cfgs.append(asked_c)
                values.append(v)
                variances.append(float(r.variance) if r.ok else 0.0)
            if records:
                self.db.append_batch(records)
                tell(asked_cfgs, values, variances)
                if on_round is not None:
                    on_round(rnd, asked_cfgs, values)
                rnd += 1

        while True:
            submit_more()
            if not pending and (racer is None or not racer.busy):
                if deferred:
                    # nothing in flight and nothing succeeded yet: price
                    # the held failures at the fallback so a blocked
                    # strategy is told and the run can continue
                    tell_wave(deferred)
                    deferred = []
                    continue
                break
            if poll_coalesces and min_ask > 1:
                # block for a whole wave: min_ask results (or everything
                # in flight), matching the coalesced ask cadence — but at
                # the budget tail never hold more slots than the run can
                # still submit, or the last probes idle behind the wave
                want = max(min(min_ask, len(pending)), 1)
                if budget is not None and 0 < budget - spent < want:
                    want = budget - spent
                results = svc.poll(timeout=None, min_results=want)
            else:
                results = svc.poll(timeout=None)    # first completion
            if not results:
                # the protocol: poll(None) returns empty only when nothing
                # is in flight — any pending entries left are orphaned
                # (claimed elsewhere or lost) and nothing more will come.
                # (the racer cannot be busy here: every racing group has a
                # follow-up in flight, so an empty drain settles them too)
                break
            if racer is None:
                wave = [(r, *e) for r in results
                        if (e := pending.pop(r.ticket.uid, None)) is not None]
            else:
                # route completions through the racer: first completions
                # (pending) may be held for re-measurement, follow-up
                # completions re-decide their group; only settled probes
                # enter the tell wave
                wave = []
                for r in results:
                    e = pending.pop(r.ticket.uid, None)
                    settled = (racer.offer(r.ticket.uid, r, *e)
                               if e is not None else racer.absorb(r))
                    if settled is not None:
                        wave.append(settled)
            # two passes: every ok value in the wave raises the penalty
            # floor *before* any failure is priced, so an early failure
            # can't be told a deceptively good value
            for r, _, _ in wave:
                if r.ok:
                    worst = max(worst, float(r.value))
            if failure_value is None and not np.isfinite(worst):
                # no success yet: hold every failure back until the first
                # real value fixes the objective's scale
                deferred += wave
                continue
            if deferred:
                wave = deferred + wave
                deferred = []
            tell_wave(wave)
        if deferred:
            tell_wave(deferred)     # nothing ever succeeded (or orphaned
        return strategy.trace       # tail): price at the fallback

    def run_successive_halving(
            self, strategy: SearchStrategy,
            high: Union["Controller", Callable[[Config], float], None] = None,
            rounds: int = 4, screen: int = 16, promote: int = 2,
            screen_tag: str = "screen", promote_tag: str = "promote",
            promote_z: float = 1.0,
            on_round: Optional[Callable[[int, Dict], None]] = None,
    ) -> Tuple[Config, float, List[Dict]]:
        """Two-fidelity successive halving: per round, ask ``screen``
        candidates, score them all at the cheap screen fidelity (the
        analytic test cluster), promote the ``promote`` best to the high
        fidelity (the compiled product cluster), and tell the strategy
        every candidate — promoted ones at their high-fidelity value, the
        rest at their screen value (a cheap multi-fidelity prior for the
        surrogate).

        Under replicated measurements the screen values carry an
        empirical variance of their pooled mean; promotion then ranks on
        the *variance-widened* mean ``value + promote_z·sd`` instead of
        the raw mean, so a lucky noisy draw cannot crowd a genuinely
        good config out of the promotion slots.  Unreplicated screens
        report zero variance, making the widened ranking bit-identical
        to the plain one (``promote_z`` is inert then); the strategy is
        always told the un-widened means, with their variances when it
        accepts them.

        Fidelity is a *request field*: every screen request is stamped
        ``fidelity=screen_tag`` and every promotion ``fidelity=
        promote_tag``.  With ``high=None`` both fidelities are served by
        *this* controller's service — e.g. an
        :class:`~repro_torch.core.service.ImmediateEvaluationService` hosting
        ``{screen_tag: analytic, promote_tag: compiled}`` backends or a
        :class:`~repro_torch.core.service.FidelityRouter` — so the schedule
        needs no second evaluator object.  Passing a ``high`` controller/
        evaluator keeps the legacy two-object form working.

        Returns ``(best_config, best_value, schedule)`` where best is over
        *high-fidelity* measurements only and ``schedule`` records, per
        round, what was screened and what was promoted.
        """
        if high is None:
            high_ctrl = self.with_tag(promote_tag)
        elif isinstance(high, Controller):
            high_ctrl = high if high.tag else high.with_tag(promote_tag)
        else:
            # a bare evaluator inherits this controller's prepare hook —
            # both fidelities must score the same completed config
            high_ctrl = Controller(high, self.db, promote_tag, self.prepare,
                                   self.workload)
        screen_ctrl = self.with_tag(screen_tag)
        tell = self._teller(strategy)
        best_c: Optional[Config] = None
        best_v = float("inf")
        schedule: List[Dict] = []
        for rnd in range(rounds):
            if strategy.finished:
                break
            cands = strategy.ask(screen)
            if not cands:
                break
            screen_res = screen_ctrl._evaluate_sync(cands,
                                                    fidelity=screen_tag)
            screen_vals = [float(r.value) for r in screen_res]
            screen_vars = [float(r.variance) for r in screen_res]
            # promotion ranks on the variance-widened mean: a 2-repeat
            # screen's ±sd uncertainty counts against it, so promotion
            # slots go to configs whose screen value is good *beyond*
            # its noise (zero-variance screens reduce to the raw mean)
            widened = [v + promote_z * float(np.sqrt(max(s, 0.0)))
                       for v, s in zip(screen_vals, screen_vars)]
            order = np.argsort(widened, kind="stable")
            keep = [int(i) for i in order[:max(min(promote, len(cands)), 1)]]
            promoted = [cands[i] for i in keep]
            high_res = high_ctrl._evaluate_sync(promoted,
                                                fidelity=promote_tag)
            high_vals = [float(r.value) for r in high_res]
            vals = list(screen_vals)
            variances = list(screen_vars)
            for i, hr in zip(keep, high_res):
                vals[i] = float(hr.value)
                variances[i] = float(hr.variance)
            tell(cands, vals, variances)
            for c, hv in zip(promoted, high_vals):
                if float(hv) < best_v:
                    best_c, best_v = dict(c), float(hv)
            entry = {"round": rnd, "screened": len(cands),
                     "promoted": len(promoted),
                     "screen_values": [float(v) for v in screen_vals],
                     "promoted_configs": [dict(c) for c in promoted],
                     "high_values": [float(v) for v in high_vals]}
            schedule.append(entry)
            if on_round is not None:
                on_round(rnd, entry)
        if best_c is None:
            raise RuntimeError("successive halving promoted nothing "
                               "(strategy returned no candidates)")
        return best_c, best_v, schedule

    def restart_cost(self, space: Space, old: Config, new: Config) -> int:
        """How many changed knobs force a restart/recompile (fleet cost)."""
        n = 0
        for k in space.knobs:
            if old.get(k.name) != new.get(k.name) and k.restart_required:
                n += 1
        return n
