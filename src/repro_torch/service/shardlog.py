"""One append log for every session: sharded JSONL + namespace views.

A daemon hosting hundreds of sessions cannot give each its own EvalDB
file (fd exhaustion, a directory of thousands of one-line logs) nor share
one file for everything (a single writer lock serializing every session's
completion wave).  The middle ground: ``n_shards`` JSONL files, each a
normal :class:`~repro_torch.core.controller.EvalDB` opened ``shared_path=True``
(advisory file locks — a second daemon on the same root fails safe
instead of interleaving lines), with a session's namespace mapped to a
shard by stable hash.  Each record carries its owning namespace in the
``ns`` field, so a shard's file remains a valid EvalDB log (legacy
tooling reads it; ``ns`` rides along) and a warm-restarted daemon
reloads every session's history by filtering its shard.

:class:`SessionDB` is the per-session facade a Controller writes
through: it stamps ``ns`` on append and filters on read — the
EvalDB-shaped surface (``append_batch`` / ``records`` / ``pairs`` /
``len``) the rest of the repo already speaks.
"""

from __future__ import annotations

import hashlib
from dataclasses import replace
from pathlib import Path
from typing import Dict, List, Optional, Tuple

from repro_torch.core.controller import EvalDB, EvalRecord


def shard_index(ns: str, n_shards: int) -> int:
    """Stable across processes and restarts (not ``hash()``: that is
    salted per interpreter, and a restarted daemon must find the same
    shard its sessions wrote before)."""
    h = hashlib.blake2s(ns.encode()).digest()[:4]
    return int.from_bytes(h, "little") % max(n_shards, 1)


class SessionDB:
    """A namespace window over one shard: EvalDB-shaped, ns-stamped."""

    def __init__(self, shard: EvalDB, ns: str):
        self.shard = shard
        self.ns = ns

    @property
    def path(self):
        return self.shard.path

    def _stamp(self, rec: EvalRecord) -> EvalRecord:
        return rec if rec.ns == self.ns else replace(rec, ns=self.ns)

    def append(self, rec: EvalRecord):
        self.shard.append(self._stamp(rec))

    def append_batch(self, recs) -> None:
        self.shard.append_batch([self._stamp(r) for r in recs])

    @property
    def records(self) -> List[EvalRecord]:
        return [r for r in self.shard.records if r.ns == self.ns]

    def pairs(self, tag: Optional[str] = None,
              workload: Optional[str] = None,
              include_failed: bool = False):
        rs = [r for r in self.records
              if (tag is None or r.tag == tag)
              and (workload is None or r.workload == workload)
              and (include_failed or r.ok)]
        return [r.config for r in rs], [r.value for r in rs]

    def __len__(self):
        return len(self.records)


class ShardedEvalLog:
    """``n_shards`` EvalDBs under one root (or in-memory when rootless).

    ``namespace(ns)`` hands out the :class:`SessionDB` for a session;
    existing shard files reload on construction, so the namespaces of a
    previous daemon run are immediately queryable (warm restart)."""

    def __init__(self, root: Optional[str] = None, n_shards: int = 4):
        self.root = Path(root) if root else None
        self.n_shards = max(int(n_shards), 1)
        if self.root is not None:
            self.root.mkdir(parents=True, exist_ok=True)
        self.shards: List[EvalDB] = [
            EvalDB(str(self.root / f"shard-{i:02d}.jsonl")
                   if self.root else None,
                   shared_path=self.root is not None)
            for i in range(self.n_shards)]

    def shard_for(self, ns: str) -> EvalDB:
        return self.shards[shard_index(ns, self.n_shards)]

    def namespace(self, ns: str) -> SessionDB:
        if not ns:
            raise ValueError("ShardedEvalLog namespaces must be non-empty")
        return SessionDB(self.shard_for(ns), ns)

    def namespaces(self) -> Tuple[str, ...]:
        seen = {r.ns for s in self.shards for r in s.records if r.ns}
        return tuple(sorted(seen))

    @property
    def records(self) -> List[EvalRecord]:
        return [r for s in self.shards for r in s.records]

    def counts(self) -> Dict[str, int]:
        out: Dict[str, int] = {}
        for r in self.records:
            out[r.ns] = out.get(r.ns, 0) + 1
        return out

    def __len__(self):
        return sum(len(s.records) for s in self.shards)
