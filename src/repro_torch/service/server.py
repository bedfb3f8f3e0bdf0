"""The tuning daemon: many sessions, one evaluation pool, one log.

:class:`TuningServer` is the Sapphire workflow as a persistent service
(the ROADMAP's "millions of users" direction, BestConfig's shared
deployment): clients create :class:`~repro_torch.service.session.
TuningSession`\\ s against named *workloads* from the server's registry,
and every session's probes multiplex through one process-wide
:class:`~repro_torch.service.pool.SharedEvaluationPool` — so concurrent users
of a popular workload share a worker pool, a probe cache, and (behind
per-session namespaces) one sharded evaluation log.

The server itself is transport-free; :mod:`repro_torch.service.wire` puts the
HTTP/JSON surface on top and ``python -m repro_torch.service`` runs the
daemon.  The default workload catalog exposes the repo's analytic
test-cluster cells (smoke-sized model configs — CPU-fast, seeded, and
exactly what the benchmarks drive); real deployments register their own
``(space, backend)`` pairs via :meth:`TuningServer.register_workload`.

Every BO and ``transfer_bo`` session fits and queries its GP on the
daemon's ``device`` (the card unless the daemon is started with
``device="cpu"``); the wire never carries a device.  A wire ``cfg`` may
name the Gram-kernel switch by the reference's field name,
``use_pallas``, so clients of either package drive either daemon.
"""

from __future__ import annotations

import json
import threading
import time
from dataclasses import dataclass, field, replace
from typing import Callable, Dict, List, Optional, Tuple, Union

from repro_torch.core.controller import Controller
from repro_torch.core.replication import ReplicationPolicy
from repro_torch.core.space import Space
from repro_torch.core.strategy import (BOConfig, GAConfig, SAConfig,
                                       make_strategy, strategy_names)
from repro_torch.device import resolve_device
from repro_torch.service.pool import SharedEvaluationPool
from repro_torch.service.session import TuningSession
from repro_torch.service.shardlog import ShardedEvalLog
from repro_torch.transfer import build_corpus   # registers "transfer_bo" too


@dataclass
class WorkloadSpec:
    """A hosted workload: a name plus a lazy ``(space, backend)`` build
    (lazy so the default catalog's cost models only materialize for the
    workloads clients actually tune)."""
    name: str
    build: Callable[[], Tuple[Space, object]]
    description: str = ""
    _cached: Optional[Tuple[Space, object]] = field(default=None,
                                                    repr=False)

    def materialize(self) -> Tuple[Space, object]:
        if self._cached is None:
            self._cached = self.build()
        return self._cached


def _analytic_spec(arch: str, shape: str,
                   noise_sigma: float = 0.025) -> WorkloadSpec:
    name = f"{arch}:{shape}"

    def build():
        from repro_torch.configs import get_smoke_config
        from repro_torch.core.costmodel import SINGLE_POD
        from repro_torch.core.evaluators import AnalyticEvaluator
        from repro_torch.core.knobs import clean_space
        from repro_torch.models.config import SHAPES_BY_NAME
        cfg = get_smoke_config(arch)
        cell = SHAPES_BY_NAME[shape]
        space, _, _ = clean_space(cfg, cell, SINGLE_POD)
        ev = AnalyticEvaluator(cfg, cell, SINGLE_POD,
                               noise_sigma=noise_sigma, history_cap=256)
        return space, ev

    return WorkloadSpec(name, build,
                        f"analytic test cluster, {arch} @ {shape}")


def default_catalog() -> Dict[str, WorkloadSpec]:
    specs = [_analytic_spec(arch, shape)
             for arch in ("yi-6b", "qwen1.5-4b", "xlstm-1.3b")
             for shape in ("train_4k", "decode_32k")]
    return {s.name: s for s in specs}


_STRATEGY_CFG = {"bo": BOConfig, "sa": SAConfig, "ga": GAConfig,
                 "transfer_bo": BOConfig}


def cfg_from_wire(cfg: dict) -> dict:
    """A wire ``cfg`` dict in this package's field names: ``use_pallas``
    (the reference's name) is ``use_kernel``; ``device`` is refused — it
    is the daemon's, never a session's."""
    cfg = dict(cfg)
    if "device" in cfg:
        raise ValueError("cfg.device is not a session field: the daemon "
                         "fits every session on its own --device")
    if "use_pallas" in cfg:
        use = cfg.pop("use_pallas")
        if cfg.setdefault("use_kernel", use) != use:
            raise ValueError("cfg gives both 'use_pallas' and "
                             "'use_kernel', and they differ")
    return cfg


def cfg_to_wire(cfg: dict) -> dict:
    """Inverse of :func:`cfg_from_wire`: the reference's field names."""
    cfg = dict(cfg)
    if "use_kernel" in cfg:
        cfg["use_pallas"] = cfg.pop("use_kernel")
    return cfg


def _strategy_kwargs(name: str, kwargs: Optional[dict]) -> dict:
    """Wire-side strategies arrive with a plain-dict ``cfg``; rebuild the
    registry's dataclass so unknown fields fail loudly here, not deep in
    the strategy."""
    kwargs = dict(kwargs or {})
    cfg = kwargs.get("cfg")
    if isinstance(cfg, dict):
        cls = _STRATEGY_CFG.get(name)
        if cls is None:
            raise ValueError(f"strategy {name!r} takes no cfg dict")
        kwargs["cfg"] = cls(**(cfg_from_wire(cfg) if cls is BOConfig
                               else cfg))
    return kwargs


class TuningServer:
    """The daemon object: workload registry + session table + shared
    pool + sharded log.  Thread-safe — the HTTP layer serves each request
    on its own thread, and the in-process benchmark drives it from N
    client threads directly."""

    def __init__(self, workloads: Optional[Dict[str, WorkloadSpec]] = None,
                 db_root: Optional[str] = None, n_shards: int = 4,
                 max_workers: int = 4, cache_capacity: int = 4096,
                 session_ttl: Optional[float] = None, device="cuda"):
        # where every BO / transfer_bo session's GP runs; raises when the
        # card is asked for and absent
        self.device = str(resolve_device(device))
        self.registry: Dict[str, WorkloadSpec] = (
            dict(workloads) if workloads is not None else default_catalog())
        self.pool = SharedEvaluationPool(max_workers=max_workers,
                                         cache_capacity=cache_capacity)
        self.log = ShardedEvalLog(db_root, n_shards=n_shards)
        self.sessions: Dict[str, TuningSession] = {}
        # idle-session eviction: sessions untouched for longer than
        # session_ttl seconds are snapshotted (state_dict to the log
        # root) and closed by the lazy sweep — no background thread, the
        # sweep runs on the server's own entry points
        self.session_ttl = session_ttl
        self._snapshots: Dict[str, dict] = {}
        self._lock = threading.RLock()
        # a restarted daemon must not reuse a crashed predecessor's
        # session ids: a fresh counter would hand out "s0001" again,
        # colliding with the old s0001's journal namespace (and silently
        # cross-contaminating its history).  Seed the counter past every
        # session id visible in the log's namespaces and the sessions
        # dir (snapshots + manifests).
        self._counter = self._max_existing_sid()
        self.created_total = 0
        self.evicted_total = 0

    def _max_existing_sid(self) -> int:
        import re
        top = 0
        pat = re.compile(r"^s(\d+)$")
        for ns in self.log.namespaces():
            m = pat.match(ns)
            if m:
                top = max(top, int(m.group(1)))
        d = (self.log.root / "sessions") if self.log.root is not None \
            else None
        if d is not None and d.is_dir():
            for p in d.iterdir():
                m = pat.match(p.name.split(".", 1)[0])
                if m:
                    top = max(top, int(m.group(1)))
        return top

    # -- workloads -----------------------------------------------------------

    def register_workload(self, name: str, space: Space, backend,
                          description: str = "") -> None:
        with self._lock:
            self.registry[name] = WorkloadSpec(
                name, lambda: (space, backend), description,
                _cached=(space, backend))

    def workloads(self) -> List[dict]:
        with self._lock:
            return [{"name": s.name, "description": s.description}
                    for s in self.registry.values()]

    def _on_device(self, name: str, kwargs: dict,
                   seed: Optional[int]) -> dict:
        """``kwargs`` with the BO config of a BO / transfer_bo strategy
        set to the daemon's device (the config the registry would build
        when none is given, otherwise the given one)."""
        if _STRATEGY_CFG.get(name) is not BOConfig:
            return kwargs
        cfg = kwargs.get("cfg")
        if cfg is None:
            cfg = BOConfig(seed=seed if seed is not None else 0)
        return {**kwargs, "cfg": replace(cfg, device=self.device)}

    def _resolve_workload(self, name: str) -> Tuple[Space, object]:
        with self._lock:
            try:
                spec = self.registry[name]
            except KeyError:
                raise KeyError(
                    f"unknown workload {name!r}; hosted: "
                    f"{tuple(sorted(self.registry))}") from None
            space, backend = spec.materialize()
            if name not in self.pool.inner.backends:
                self.pool.add_backend(name, backend)
                # projected probe keys: the cache dedupes probes that
                # differ only in inert / gated-off knobs of this space
                self.pool.register_space(name, space)
            return space, backend

    # -- sessions ------------------------------------------------------------

    def create_session(self, workload: str, strategy: str = "bo",
                       budget: Optional[int] = None, seed: int = 0,
                       batch_size: Optional[int] = None,
                       strategy_kwargs: Optional[dict] = None,
                       replication: Optional[dict] = None,
                       deterministic: bool = True,
                       tag: str = "",
                       state: Optional[dict] = None,
                       transfer_from: Union[None, bool, dict] = None,
                       resume: Optional[str] = None) -> TuningSession:
        self.evict_idle()
        if strategy not in strategy_names():
            raise KeyError(f"unknown strategy {strategy!r}; "
                           f"registered: {strategy_names()}")
        space, _ = self._resolve_workload(workload)
        kwargs = self._on_device(
            strategy, _strategy_kwargs(strategy, strategy_kwargs), seed)
        if resume is not None:
            if state is not None:
                raise ValueError("create-session: pass either 'state' or "
                                 "'resume', not both")
            try:
                snap = self._load_snapshot(resume)
            except KeyError:
                # no snapshot — the daemon (or its predecessor process)
                # never evicted this session: crash-recovery path.  The
                # journal + manifest rebuild it with zero lost tells.
                return self._resume_from_journal(resume, workload, space)
            if snap["workload"] != workload:
                raise ValueError(
                    f"resume {resume!r}: snapshot belongs to workload "
                    f"{snap['workload']!r}, not {workload!r}")
            state = snap["state"]
        if transfer_from:
            kwargs["corpus"] = self._build_transfer_corpus(
                workload, space, transfer_from)
        strat = make_strategy(strategy, space, budget=budget, seed=seed,
                              batch_size=batch_size, **kwargs)
        if state is not None:
            load = getattr(strat, "load_state", None)
            if load is None:
                raise TypeError(f"strategy {strategy!r} cannot load_state")
            load(state)
        policy = None
        if replication:
            policy = ReplicationPolicy(**replication)
        with self._lock:
            self._counter += 1
            self.created_total += 1
            sid = f"s{self._counter:04d}"
            view = self.pool.view(ordered=deterministic)
            ctrl = Controller(view, db=self.log.namespace(sid),
                              tag=tag or strategy, workload=workload,
                              replication=policy, seed=seed)
            sess = TuningSession(sid, workload, strategy, strat, ctrl,
                                 deterministic=deterministic, budget=budget,
                                 batch_size=batch_size)
            self.sessions[sid] = sess
            self._write_manifest(sess, seed, strategy_kwargs, replication)
            return sess

    def _write_manifest(self, sess: TuningSession, seed: int,
                        strategy_kwargs: Optional[dict],
                        replication: Optional[dict]) -> None:
        """Journal the session's *recipe* next to the snapshots.  The
        sharded log already journals every tell (the session appends to
        its namespace before the strategy is told — journal-before-ack);
        the manifest is the missing half for crash recovery: what
        strategy, seed and budget to rebuild so the journaled rows can
        be replayed into a fresh strategy after a daemon killed mid-run
        (eviction snapshots never happened for it)."""
        d = self._snapshot_dir()
        if d is None:
            return
        man = {"session": sess.session_id, "workload": sess.workload,
               "strategy": sess.strategy_name, "budget": sess.budget,
               "seed": seed, "batch_size": sess.batch_size,
               "deterministic": sess.deterministic,
               "tag": sess.controller.tag,
               "replication": replication,
               "created_at": sess.created_at}
        if strategy_kwargs:
            try:
                json.dumps(strategy_kwargs)
                cfg = strategy_kwargs.get("cfg")
                man["strategy_kwargs"] = (
                    {**strategy_kwargs, "cfg": cfg_to_wire(cfg)}
                    if isinstance(cfg, dict) else strategy_kwargs)
            except TypeError:
                pass    # in-process-only kwargs (live objects): the wire
                #         path is always JSON-safe, so nothing is lost
        (d / f"{sess.session_id}.meta.json").write_text(json.dumps(man))

    def _resume_from_journal(self, sid: str, workload: str,
                             space: Space) -> TuningSession:
        """Crash-recovery resume: rebuild the session from its manifest
        and replay every journaled tell from its log namespace.  Unlike
        a snapshot resume (which copies strategy state into a *new*
        session id), this continues the *same* session id and namespace
        — the journal is the ground truth, and subsequent tells keep
        appending to it."""
        d = self._snapshot_dir()
        p = (d / f"{sid}.meta.json") if d is not None else None
        if p is None or not p.exists():
            raise KeyError(
                f"no session snapshot {sid!r} (and no journal manifest "
                "to rebuild it from)")
        man = json.loads(p.read_text())
        if man.get("workload") != workload:
            raise ValueError(
                f"resume {sid!r}: journal belongs to workload "
                f"{man.get('workload')!r}, not {workload!r}")
        with self._lock:
            if sid in self.sessions:
                raise ValueError(f"resume {sid!r}: session is still open "
                                 "on this daemon")
        strategy = man.get("strategy", "bo")
        seed = int(man.get("seed", 0))
        kwargs = self._on_device(
            strategy, _strategy_kwargs(strategy, man.get("strategy_kwargs")),
            seed)
        strat = make_strategy(strategy, space, budget=man.get("budget"),
                              seed=seed, batch_size=man.get("batch_size"),
                              **kwargs)
        ndb = self.log.namespace(sid)
        rows = [r for r in ndb.records
                if r.ok and r.value == r.value
                and r.value not in (float("inf"), float("-inf"))]
        if rows:
            Controller._teller(strat)(
                [dict(r.config) for r in rows],
                [float(r.value) for r in rows],
                [float(r.variance) for r in rows])
        policy = (ReplicationPolicy(**man["replication"])
                  if man.get("replication") else None)
        deterministic = bool(man.get("deterministic", True))
        with self._lock:
            self.created_total += 1
            view = self.pool.view(ordered=deterministic)
            ctrl = Controller(view, db=ndb,
                              tag=man.get("tag") or strategy,
                              workload=workload, replication=policy,
                              seed=seed)
            sess = TuningSession(sid, workload, strategy, strat, ctrl,
                                 deterministic=deterministic,
                                 budget=man.get("budget"),
                                 batch_size=man.get("batch_size"))
            self.sessions[sid] = sess
            return sess

    def _build_transfer_corpus(self, workload: str, space: Space,
                               spec: Union[bool, dict]):
        """``transfer_from`` corpus over the daemon's own sharded log.

        The spec (``True`` for all defaults) may narrow the donor set
        (``workloads``), extend the exclusion list (``exclude`` — the
        target workload is always excluded), and tune corpus assembly
        (``min_points``).  Donor workloads hosted in the registry get
        their spaces materialized so signature mismatches are detected
        up front rather than row by row."""
        spec = {} if spec is True else dict(spec)
        unknown = set(spec) - {"workloads", "exclude", "min_points"}
        if unknown:
            raise ValueError(f"transfer_from: unknown fields "
                             f"{sorted(unknown)}")
        exclude = set(spec.get("exclude", ())) | {workload}
        only = spec.get("workloads")
        records = self.log.records
        if only is not None:
            only = set(only)
            records = [r for r in records if r.workload in only]
        spaces: Dict[str, Space] = {}
        for wl in {r.workload for r in records if r.workload}:
            if wl in exclude or wl not in self.registry:
                continue
            try:
                spaces[wl] = self.registry[wl].materialize()[0]
            except Exception:
                pass          # undeclared: corpus falls back to row checks
        return build_corpus(space, [records], spaces=spaces,
                            exclude=sorted(exclude),
                            min_points=int(spec.get("min_points", 2)))

    # -- idle eviction + snapshots -------------------------------------------

    def _snapshot_dir(self):
        if self.log.root is None:
            return None
        d = self.log.root / "sessions"
        d.mkdir(parents=True, exist_ok=True)
        return d

    def _snapshot(self, sess: TuningSession) -> Optional[dict]:
        fn = getattr(sess.strategy, "state_dict", None)
        if fn is None:
            return None
        snap = {"session": sess.session_id, "workload": sess.workload,
                "strategy": sess.strategy_name, "state": fn(),
                "evicted_at": time.time()}
        self._snapshots[sess.session_id] = snap
        d = self._snapshot_dir()
        if d is not None:
            (d / f"{sess.session_id}.json").write_text(json.dumps(snap))
        return snap

    def _load_snapshot(self, name: str) -> dict:
        with self._lock:
            snap = self._snapshots.get(name)
        if snap is None:
            d = self._snapshot_dir()
            p = d / f"{name}.json" if d is not None else None
            if p is None or not p.exists():
                raise KeyError(f"no session snapshot {name!r}")
            snap = json.loads(p.read_text())
        return snap

    def evict_idle(self, now: Optional[float] = None) -> List[str]:
        """Close sessions idle past ``session_ttl``, each snapshotted
        first (``state_dict`` to the log root, when the strategy has
        one) so ``create_session(resume=<id>)`` can continue it.  Runs
        lazily from the server's own entry points — a daemon with no
        traffic evicts nothing, and needs to evict nothing."""
        if self.session_ttl is None:
            return []
        now = time.time() if now is None else now
        with self._lock:
            idle = [s for s in self.sessions.values()
                    if now - s.last_used > self.session_ttl]
            for s in idle:
                del self.sessions[s.session_id]
                self._snapshot(s)
                self.evicted_total += 1
        for s in idle:
            s.close()
        return [s.session_id for s in idle]

    def session(self, session_id: str) -> TuningSession:
        self.evict_idle()
        with self._lock:
            try:
                return self.sessions[session_id]
            except KeyError:
                raise KeyError(f"no session {session_id!r}") from None

    def close_session(self, session_id: str) -> None:
        with self._lock:
            sess = self.session(session_id)
            del self.sessions[session_id]
        sess.close()

    def list_sessions(self) -> List[dict]:
        self.evict_idle()
        with self._lock:
            return [s.describe() for s in self.sessions.values()]

    # -- daemon-level introspection / lifecycle ------------------------------

    def stats(self) -> dict:
        self.evict_idle()
        with self._lock:
            open_sessions = len(self.sessions)
        return {"sessions_open": open_sessions,
                "sessions_created": self.created_total,
                "sessions_evicted": self.evicted_total,
                "evaluations_logged": len(self.log),
                "pool": self.pool.stats()}

    def close(self):
        with self._lock:
            sessions = list(self.sessions.values())
            self.sessions.clear()
        for s in sessions:
            s.close()
        self.pool.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
