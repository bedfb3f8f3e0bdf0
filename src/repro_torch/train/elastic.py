"""Elasticity & straggler mitigation: the fleet-runtime control plane
(from ``repro.train.elastic``: pure Python, the same logic).

On 1000+ nodes, failures are routine: the runtime must (a) detect sick /
slow hosts, (b) compute a new mesh carve from the survivors, (c) map the
checkpointed state onto the new carve and resume from the stateless data
stream (train/data.py makes the stream a pure function of (seed, step), so
no data cursor needs rescuing).

Everything here is deterministic control-plane *logic* — exactly the part
that can and should be unit-tested off-fleet.  This module only decides
shapes and assignments; the collectives are the runtime's.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np

HEALTHY, STRAGGLER, DEAD = "healthy", "straggler", "dead"


# ---------------------------------------------------------------------------
# straggler detection
# ---------------------------------------------------------------------------

@dataclass
class StepWatchdog:
    """Flags hosts whose step times sit above k× the fleet median.

    Fed per-step host timings (on a fleet: from the heartbeat channel).
    The baseline is the *median* — a p99 baseline would be contaminated
    by the straggler's own samples.  A host is a straggler only after
    ``patience`` consecutive slow steps, so transient hiccups (GC,
    checkpoint flush) don't trigger a re-carve.
    """
    k: float = 1.5
    patience: int = 3
    window: int = 64
    _times: Dict[int, List[float]] = field(default_factory=dict)
    _slow: Dict[int, int] = field(default_factory=dict)

    def observe(self, host: int, step_s: float):
        self._times.setdefault(host, []).append(step_s)
        self._times[host] = self._times[host][-self.window:]

    def classify(self) -> Dict[int, str]:
        if not self._times:
            return {}
        all_t = np.concatenate([np.asarray(v) for v in self._times.values()])
        base = float(np.median(all_t))
        out = {}
        for host, ts in self._times.items():
            slow = ts[-1] > self.k * base
            self._slow[host] = self._slow.get(host, 0) + 1 if slow else 0
            out[host] = STRAGGLER if self._slow[host] >= self.patience \
                else HEALTHY
        return out


# ---------------------------------------------------------------------------
# mesh re-carve
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class Carve:
    pod: int
    data: int
    model: int

    @property
    def chips(self) -> int:
        return self.pod * self.data * self.model


def recarve(alive_chips: int, prefer: Carve,
            model_min: Optional[int] = None) -> Carve:
    """Largest usable carve from the survivors.

    Keeps the model axis (changing it re-shards every weight tensor; the
    data axis only re-shards the batch) unless fewer chips remain than one
    model group, then shrinks model to the largest power-of-two that fits.
    """
    model = prefer.model
    model_min = model_min or 1
    while model > model_min and alive_chips < model:
        model //= 2
    dp_total = alive_chips // model
    if dp_total == 0:
        raise ValueError("not enough chips for one model group")
    # prefer keeping pods intact
    pod = min(prefer.pod, dp_total)
    while pod > 1 and dp_total % pod != 0:
        pod -= 1
    data = dp_total // pod
    return Carve(pod, data, model)


@dataclass(frozen=True)
class ReshardPlan:
    """old shard index -> new shard owners, per logical axis size change."""
    old: Carve
    new: Carve
    batch_scale: float              # global-batch change if kept per-chip
    param_moves: Tuple[Tuple[int, int], ...]   # (old_dp_shard, new_dp_shard)

    def summary(self) -> str:
        return (f"{self.old.pod}x{self.old.data}x{self.old.model} -> "
                f"{self.new.pod}x{self.new.data}x{self.new.model} "
                f"({len(self.param_moves)} shard moves)")


def plan_reshard(old: Carve, new: Carve) -> ReshardPlan:
    """FSDP (ZeRO-3) state moves when the DP world shrinks/grows.

    Parameters are sharded over dp_total = pod·data; a world change from
    Do to Dn means new shard j gathers old shards overlapping
    [j/Dn, (j+1)/Dn) of the flat parameter space.
    """
    do, dn = old.pod * old.data, new.pod * new.data
    moves: List[Tuple[int, int]] = []
    for j in range(dn):
        lo, hi = j / dn, (j + 1) / dn
        for i in range(do):
            ilo, ihi = i / do, (i + 1) / do
            if ilo < hi and ihi > lo:           # overlap
                moves.append((i, j))
    return ReshardPlan(old, new, batch_scale=dn / do,
                       param_moves=tuple(moves))


# ---------------------------------------------------------------------------
# the restart policy
# ---------------------------------------------------------------------------

@dataclass
class ElasticPolicy:
    """checkpoint-restart policy for failures & stragglers.

    decide() returns one of:
      ("continue",)                       — all healthy
      ("evict", host, plan)               — drop straggler, re-carve
      ("restore", step, plan)             — dead host: restart from ckpt
    """
    carve: Carve
    chips_per_host: int = 4
    evict_stragglers: bool = True

    def decide(self, health: Dict[int, str], latest_ckpt: Optional[int]):
        dead = [h for h, s in health.items() if s == DEAD]
        slow = [h for h, s in health.items() if s == STRAGGLER]
        n_hosts = max(len(health), 1)
        if dead:
            alive = (n_hosts - len(dead)) * self.chips_per_host
            new = recarve(alive, self.carve)
            return ("restore", latest_ckpt, plan_reshard(self.carve, new))
        if slow and self.evict_stragglers:
            alive = (n_hosts - len(slow)) * self.chips_per_host
            new = recarve(alive, self.carve)
            return ("evict", slow[0], plan_reshard(self.carve, new))
        return ("continue",)
