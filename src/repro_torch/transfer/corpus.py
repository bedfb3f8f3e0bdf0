"""The transfer corpus: per-workload datasets mined from evaluation logs.

Sapphire's amortization argument (and BestConfig's / Magpie's open
problem) is that tuning evidence should outlive the run that produced
it.  Every run in this repo already logs :class:`~repro_torch.core.controller.
EvalRecord` rows with a ``workload`` stamp — plain EvalDB JSONL files,
or the daemon's :class:`~repro_torch.service.shardlog.ShardedEvalLog` root.
This module sweeps those logs into a :class:`TransferCorpus`: one
:class:`TaskData` per workload, every row keyed on a single shared
:class:`~repro_torch.core.space.Space` so the multi-task GP can stack them
into one training matrix.

Space compatibility is decided by the service's wire codec
(:func:`space_signature` — canonical JSON over every knob field and
constraint): a source whose declared space does not match the target's
signature is **skipped loudly** (a :class:`CorpusMismatch` warning, never
silence), and sources without a declared space are validated record by
record against the target space — wrong knob set or out-of-bounds values
(a donor run whose dynamic boundaries expanded past ours) drop the row,
again with a warning that counts what was lost.
"""

from __future__ import annotations

import json
import warnings
from dataclasses import dataclass
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np

from repro_torch.core.controller import EvalDB, EvalRecord
from repro_torch.core.space import Config, Space


class CorpusMismatch(UserWarning):
    """A corpus source (or part of one) was skipped: incompatible space,
    unknown knobs, or out-of-bounds values.  Always warned, never silent —
    a transfer prior quietly missing half its corpus is worse than none."""


def space_signature(space: Space) -> str:
    """Canonical identity of a search space: the wire codec's JSON with
    sorted keys.  Two spaces transfer-compatible ⇔ equal signatures —
    same knobs, kinds, bounds, choices, gating and constraints, so the
    unit-cube encoding of any config is identical under either."""
    from repro_torch.service.wire import space_to_json
    return json.dumps(space_to_json(space), sort_keys=True)


@dataclass
class TaskData:
    """One workload's observations, already projected onto the shared
    space: raw objective values (minimization) + per-row measurement
    variances (0.0 = no replicated estimate)."""
    workload: str
    configs: List[Config]
    values: np.ndarray        # [n] raw objective
    variances: np.ndarray     # [n] variance of each reported mean

    def __len__(self) -> int:
        return len(self.configs)

    @property
    def best(self) -> Tuple[Config, float]:
        i = int(np.argmin(self.values))
        return self.configs[i], float(self.values[i])

    def top(self, k: int) -> List[Config]:
        order = np.argsort(self.values)[:k]
        return [self.configs[int(i)] for i in order]


@dataclass
class TransferCorpus:
    """Per-workload datasets over one shared :class:`Space` — the input
    to the multi-task prior fit and the warm-start seeds."""
    space: Space
    tasks: List[TaskData]

    @property
    def n_tasks(self) -> int:
        return len(self.tasks)

    @property
    def workloads(self) -> Tuple[str, ...]:
        return tuple(t.workload for t in self.tasks)

    def __len__(self) -> int:
        return sum(len(t) for t in self.tasks)

    def __bool__(self) -> bool:
        return self.n_tasks > 0

    def best_configs(self, per_task: int = 1) -> List[Config]:
        """Each task's best ``per_task`` configs, interleaved best-first
        across tasks (task order by its own best value) — the natural
        seeds for a new workload's initial design."""
        ranked = sorted(self.tasks, key=lambda t: t.best[1])
        out: List[Config] = []
        for j in range(per_task):
            for t in ranked:
                if j < len(t):
                    out.append(t.top(j + 1)[j])
        return out

    def stacked(self, log_objective: bool = True,
                max_per_task: Optional[int] = None,
                seed: int = 0) -> Tuple[np.ndarray, np.ndarray,
                                        np.ndarray, np.ndarray]:
        """The multi-task training matrix: ``(x, y, var, task)`` with
        ``x`` [n, d] unit-cube rows, ``task`` [n] int32 indices into
        :attr:`tasks`.  ``log_objective`` matches BO's modeling transform
        (y → log y, variances through the delta method var/y²).
        ``max_per_task`` caps each task's rows — every task keeps its
        best rows plus a seeded random sample of the rest, so a huge
        donor log cannot make the O(n³) prior fit unpayable."""
        rng = np.random.default_rng(seed)
        xs, ys, vs, ts = [], [], [], []
        for ti, task in enumerate(self.tasks):
            idx = np.arange(len(task))
            if max_per_task is not None and len(task) > max_per_task:
                order = np.argsort(task.values)
                keep_best = order[:max(max_per_task // 4, 1)]
                rest = np.setdiff1d(idx, keep_best)
                fill = rng.choice(rest, max_per_task - len(keep_best),
                                  replace=False)
                idx = np.sort(np.concatenate([keep_best, fill]))
            cfgs = [task.configs[int(i)] for i in idx]
            y = task.values[idx].astype(np.float64)
            var = task.variances[idx].astype(np.float64)
            if log_objective:
                var = var / np.maximum(y, 1e-12) ** 2
                y = np.log(np.maximum(y, 1e-12))
            xs.append(self.space.encode_batch(cfgs))
            ys.append(y)
            vs.append(var)
            ts.append(np.full(len(idx), ti, np.int32))
        if not xs:
            d = len(self.space)
            return (np.zeros((0, d)), np.zeros(0), np.zeros(0),
                    np.zeros(0, np.int32))
        return (np.vstack(xs), np.concatenate(ys), np.concatenate(vs),
                np.concatenate(ts))


# ---------------------------------------------------------------------------
# building a corpus from logs
# ---------------------------------------------------------------------------

Source = Union[str, Path, Sequence[EvalRecord]]


def _records_from(source: Source) -> List[EvalRecord]:
    """Records of one source: a JSONL file (EvalDB reload), a directory
    (every ``*.jsonl`` under it — a ShardedEvalLog root, or a folder of
    per-run EvalDBs), or an in-memory record sequence."""
    if isinstance(source, (str, Path)):
        p = Path(source)
        if p.is_dir():
            recs: List[EvalRecord] = []
            for f in sorted(p.glob("*.jsonl")):
                recs.extend(EvalDB(str(f), shared_path=True).records)
            return recs
        if p.exists():
            return EvalDB(str(p), shared_path=True).records
        warnings.warn(f"transfer corpus: source {p} does not exist; "
                      "skipping", CorpusMismatch, stacklevel=3)
        return []
    return list(source)


def build_corpus(space: Space, sources: Sequence[Source], *,
                 spaces: Optional[Dict[str, Space]] = None,
                 exclude: Sequence[str] = (),
                 min_points: int = 2) -> TransferCorpus:
    """Assemble a :class:`TransferCorpus` over ``space`` from evaluation
    logs.

    ``sources`` are swept with :func:`_records_from` and grouped by each
    record's ``workload`` stamp.  ``spaces`` optionally declares the
    space a workload's records were produced in: a declared space whose
    :func:`space_signature` differs from the target's skips that whole
    workload with a :class:`CorpusMismatch` warning.  Undeclared
    workloads are validated row by row against the target space (knob
    set equality, value bounds); rows that fail are dropped and counted
    in one warning per workload.  ``exclude`` drops workloads outright —
    the leave-one-out hold-out, and the session's own workload when a
    server warm-starts from its shared log.  Workloads ending up with
    fewer than ``min_points`` usable rows are dropped (a one-row task
    destabilizes the task-kernel fit more than it informs it).
    """
    target_sig = space_signature(space)
    names = set(space.names)
    excluded = set(exclude)
    by_workload: Dict[str, List[EvalRecord]] = {}
    for src in sources:
        for r in _records_from(src):
            if not r.workload or r.workload in excluded:
                continue
            by_workload.setdefault(r.workload, []).append(r)

    tasks: List[TaskData] = []
    for wl in sorted(by_workload):
        if spaces is not None and wl in spaces:
            sig = space_signature(spaces[wl])
            if sig != target_sig:
                warnings.warn(
                    f"transfer corpus: workload {wl!r} was tuned in an "
                    "incompatible space (signature mismatch with the "
                    "target); skipping all "
                    f"{len(by_workload[wl])} records", CorpusMismatch,
                    stacklevel=2)
                continue
        cfgs: List[Config] = []
        vals: List[float] = []
        vrs: List[float] = []
        dropped = 0
        for r in by_workload[wl]:
            if not r.ok or not np.isfinite(r.value):
                continue
            if set(r.config) != names or space.validate(r.config):
                dropped += 1
                continue
            cfgs.append(dict(r.config))
            vals.append(float(r.value))
            vrs.append(float(r.variance))
        if dropped:
            warnings.warn(
                f"transfer corpus: workload {wl!r}: dropped {dropped} "
                "record(s) whose configs do not fit the target space "
                "(unknown knobs or out-of-bounds values)", CorpusMismatch,
                stacklevel=2)
        if len(cfgs) < min_points:
            if cfgs:
                warnings.warn(
                    f"transfer corpus: workload {wl!r} has only "
                    f"{len(cfgs)} usable record(s) (< {min_points}); "
                    "dropping the task", CorpusMismatch, stacklevel=2)
            continue
        tasks.append(TaskData(wl, cfgs, np.asarray(vals, np.float64),
                              np.asarray(vrs, np.float64)))
    return TransferCorpus(space, tasks)


def corpus_from_log(space: Space, log, *, exclude: Sequence[str] = (),
                    spaces: Optional[Dict[str, Space]] = None,
                    min_points: int = 2) -> TransferCorpus:
    """Corpus straight from a live :class:`~repro_torch.service.shardlog.
    ShardedEvalLog` (or anything with ``.records``) — the server-side
    ``transfer_from`` path, where the daemon mines its own shared log."""
    return build_corpus(space, [log.records], spaces=spaces,
                        exclude=exclude, min_points=min_points)
