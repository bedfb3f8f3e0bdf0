"""Typed configuration parameter space (paper §3.2, Table 1).

A :class:`Space` is an ordered collection of :class:`Knob` definitions plus
cross-knob :class:`Constraint` objects — the four constraint classes the
paper catalogues for Ceph:

  C1  unconfigurable knobs      -> ``Knob.configurable = False`` (washed out)
  C2  strict value boundaries   -> ``lo``/``hi`` (optionally ``dynamic``,
                                    i.e. the boundary may be enlarged by the
                                    optimizer — paper Fig. 4) and alignment
  C3  module-selector gating    -> ``gated_by = (selector_name, {values})``
  C4  inter-knob dependencies   -> Constraint objects (sum-, order-,
                                    divides-) enforced by projection

Knob values are plain Python scalars inside a *config*: ``Dict[str, value]``.
For the ML models every knob maps to a **unit interval** dimension
(log-scaled when flagged); categoricals are index-coded here and
dummy-coded by the ranking preprocessor (paper §3.3).
"""

from __future__ import annotations

import math
from dataclasses import dataclass, replace
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np

Value = Union[int, float, bool, str]
Config = Dict[str, Value]


# ---------------------------------------------------------------------------
# knobs
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class Knob:
    name: str
    kind: str                      # "int" | "float" | "bool" | "categorical"
    default: Value
    lo: Optional[float] = None     # numeric bounds (C2); None for bool/cat
    hi: Optional[float] = None
    choices: Optional[Tuple[Value, ...]] = None   # categorical candidates
    log_scale: bool = False        # optimize in log space
    dynamic_bound: bool = False    # C2: boundary may be enlarged (Fig. 4)
    align: int = 1                 # int knobs: value must be multiple of this
    configurable: bool = True      # C1: False -> washed out
    gated_by: Optional[Tuple[str, Tuple[Value, ...]]] = None  # C3
    module: str = "core"           # owning subsystem (for pruning/reports)
    restart_required: bool = True  # False: runtime-injectable (data knobs)
    inert: bool = False            # ground truth for tests: no perf effect
    description: str = ""

    def __post_init__(self):
        if self.kind in ("int", "float"):
            assert self.lo is not None and self.hi is not None, self.name
            assert self.lo <= self.hi, self.name
            if self.log_scale:
                assert self.lo > 0, f"{self.name}: log scale needs lo>0"
        elif self.kind == "bool":
            pass
        elif self.kind == "categorical":
            assert self.choices, self.name
        else:
            raise ValueError(f"{self.name}: unknown kind {self.kind}")

    # ---- value handling ----------------------------------------------------

    def clip(self, v: Value) -> Value:
        if self.kind == "int":
            v = int(round(float(v)))
            if self.align > 1:
                v = int(round(v / self.align)) * self.align
            return int(min(max(v, self.lo), self.hi))
        if self.kind == "float":
            return float(min(max(float(v), self.lo), self.hi))
        if self.kind == "bool":
            return bool(v)
        if self.kind == "categorical":
            if v in self.choices:
                # canonical choice object (256.0 == 256 passes the `in`,
                # but the stored int is what configs should carry)
                return self.choices[self.choices.index(v)]
            # numeric choice sets (tiling ladders like 64/128/256) snap to
            # the nearest choice — constraint projection (ProductLeq's
            # halving) hands clip off-ladder values and a default-bounce
            # would teleport instead of shrink.  Ties go to the smaller
            # choice (projection shrinks).  Non-numeric sets keep the
            # default fallback.
            numeric = all(isinstance(c, (int, float, np.integer, np.floating))
                          and not isinstance(c, (bool, np.bool_))
                          for c in self.choices)
            if numeric and isinstance(v, (int, float, np.integer,
                                          np.floating)) \
                    and not isinstance(v, (bool, np.bool_)):
                return min(self.choices,
                           key=lambda c: (abs(float(c) - float(v)),
                                          float(c)))
            return self.default
        raise AssertionError

    def validate(self, v: Value) -> bool:
        if self.kind == "int":
            return (isinstance(v, (int, np.integer)) and self.lo <= v <= self.hi
                    and v % self.align == 0)
        if self.kind == "float":
            return isinstance(v, (int, float, np.floating)) and self.lo <= v <= self.hi
        if self.kind == "bool":
            return isinstance(v, (bool, np.bool_))
        return v in self.choices

    # ---- unit-cube encoding (for GP / SA / GA) ------------------------------

    def n_dims(self) -> int:
        return 1

    def to_unit(self, v: Value) -> float:
        if self.kind == "bool":
            return 1.0 if v else 0.0
        if self.kind == "categorical":
            i = self.choices.index(v)
            return i / max(len(self.choices) - 1, 1)
        lo, hi = float(self.lo), float(self.hi)
        if self.log_scale:
            lo, hi, v = math.log(lo), math.log(hi), math.log(max(float(v), 1e-300))
        if hi == lo:
            return 0.0
        return float((float(v) - lo) / (hi - lo))

    def from_unit(self, u: float) -> Value:
        u = min(max(float(u), 0.0), 1.0)
        if self.kind == "bool":
            return bool(u >= 0.5)
        if self.kind == "categorical":
            i = int(round(u * (len(self.choices) - 1)))
            return self.choices[i]
        lo, hi = float(self.lo), float(self.hi)
        if self.log_scale:
            v = math.exp(math.log(lo) + u * (math.log(hi) - math.log(lo)))
        else:
            v = lo + u * (hi - lo)
        return self.clip(v)

    def expanded(self, factor: float = 2.0) -> "Knob":
        """Dynamic-boundary enlargement (paper Fig. 4): widen [lo, hi]."""
        if self.kind not in ("int", "float") or not self.dynamic_bound:
            return self
        lo, hi = float(self.lo), float(self.hi)
        if self.log_scale:
            # clamp the log-span growth: repeated expansions otherwise
            # overflow exp() after ~a dozen boundary events
            span = min(math.log(hi) - math.log(lo), 80.0)
            lo = math.exp(max(math.log(lo) - span * (factor - 1) / 2, -80.0))
            hi = math.exp(min(math.log(hi) + span * (factor - 1) / 2, 80.0))
            lo = max(lo, 1e-12)
        else:
            span = hi - lo
            lo = lo - span * (factor - 1) / 2
            hi = min(hi + span * (factor - 1) / 2, 1e18)
        if self.kind == "int":
            lo, hi = math.floor(lo), math.ceil(hi)
            lo = max(lo, self.align)
        return replace(self, lo=lo, hi=hi)


# ---------------------------------------------------------------------------
# C4 constraints (value interdependencies)
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class Constraint:
    """Base for C4 inter-knob constraints."""
    knobs: Tuple[str, ...]

    def satisfied(self, cfg: Config) -> bool:  # pragma: no cover - interface
        raise NotImplementedError

    def project(self, cfg: Config, space: "Space") -> Config:
        """Minimally adjust ``cfg`` so the constraint holds."""
        raise NotImplementedError


@dataclass(frozen=True)
class SumLeq(Constraint):
    """sum(knobs) <= limit (e.g. bluestore cache ratios; HBM fractions)."""
    limit: float = 1.0

    def satisfied(self, cfg: Config) -> bool:
        return sum(float(cfg[k]) for k in self.knobs if k in cfg) <= self.limit + 1e-9

    def project(self, cfg: Config, space: "Space") -> Config:
        present = [k for k in self.knobs if k in cfg]
        total = sum(float(cfg[k]) for k in present)
        # same tolerance as satisfied(): keeps projection idempotent
        # (a bare > would rescale ULP-level overshoot forever)
        if total <= self.limit + 1e-9 or total == 0:
            return cfg
        # shrink only the headroom above each knob's lower bound — naive
        # uniform rescaling gets clipped back UP at lo and never converges
        out = dict(cfg)
        los = {k: float(space.knob(k).lo or 0.0) for k in present}
        lo_sum = sum(los.values())
        head = {k: float(cfg[k]) - los[k] for k in present}
        head_sum = sum(head.values())
        if head_sum <= 0 or self.limit < lo_sum:
            return out                         # infeasible box; leave as-is
        alpha = (self.limit - lo_sum) / head_sum
        for k in present:
            out[k] = space.knob(k).clip(los[k] + head[k] * min(alpha, 1.0))
        return out


@dataclass(frozen=True)
class Leq(Constraint):
    """knobs[0] <= knobs[1]  (e.g. ms_async_op_threads <= max_op_threads)."""

    def satisfied(self, cfg: Config) -> bool:
        a, b = self.knobs
        if a not in cfg or b not in cfg:
            return True
        return float(cfg[a]) <= float(cfg[b]) + 1e-9

    def project(self, cfg: Config, space: "Space") -> Config:
        a, b = self.knobs
        if a not in cfg or b not in cfg or self.satisfied(cfg):
            return cfg
        out = dict(cfg)
        out[a] = space.knob(a).clip(float(cfg[b]))
        return out


@dataclass(frozen=True)
class Divides(Constraint):
    """knobs[0] divides knobs[1] (e.g. microbatch divides per-replica batch).

    knobs[1] may name a knob or be pinned via ``target`` (a fixed int from
    the workload, e.g. global batch per replica).
    """
    target: Optional[int] = None

    def _rhs(self, cfg: Config) -> Optional[int]:
        if self.target is not None:
            return int(self.target)
        if len(self.knobs) > 1 and self.knobs[1] in cfg:
            return int(cfg[self.knobs[1]])
        return None

    def satisfied(self, cfg: Config) -> bool:
        a = self.knobs[0]
        rhs = self._rhs(cfg)
        if a not in cfg or rhs is None:
            return True
        v = int(cfg[a])
        return v != 0 and rhs % v == 0

    def project(self, cfg: Config, space: "Space") -> Config:
        a = self.knobs[0]
        rhs = self._rhs(cfg)
        if a not in cfg or rhs is None or self.satisfied(cfg):
            return cfg
        v = max(int(cfg[a]), 1)
        # snap to the nearest divisor of rhs
        divisors = [d for d in range(1, rhs + 1) if rhs % d == 0]
        knob = space.knob(a)
        valid = [d for d in divisors if knob.lo <= d <= knob.hi] or divisors
        best = min(valid, key=lambda d: abs(d - v))
        out = dict(cfg)
        out[a] = int(best)
        return out


@dataclass(frozen=True)
class ProductLeq(Constraint):
    """prod(knobs) <= limit (e.g. flash block_q*block_k VMEM budget)."""
    limit: float = float("inf")

    def satisfied(self, cfg: Config) -> bool:
        p = 1.0
        for k in self.knobs:
            if k in cfg:
                p *= float(cfg[k])
        return p <= self.limit + 1e-9

    def project(self, cfg: Config, space: "Space") -> Config:
        if self.satisfied(cfg):
            return cfg
        out = dict(cfg)
        # shrink the largest factor until the budget holds
        for _ in range(64):
            p = 1.0
            for k in self.knobs:
                if k in out:
                    p *= float(out[k])
            if p <= self.limit:
                break
            big = max((k for k in self.knobs if k in out), key=lambda k: float(out[k]))
            knob = space.knob(big)
            shrunk = float(out[big]) / 2
            nxt = knob.clip(shrunk)
            if float(nxt) >= float(out[big]):  # cannot shrink further
                break
            out[big] = nxt
        return out


# ---------------------------------------------------------------------------
# the space
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class Space:
    knobs: Tuple[Knob, ...]
    constraints: Tuple[Constraint, ...] = ()

    def __post_init__(self):
        names = [k.name for k in self.knobs]
        assert len(names) == len(set(names)), "duplicate knob names"

    # ---- lookups ------------------------------------------------------------

    @property
    def names(self) -> Tuple[str, ...]:
        return tuple(k.name for k in self.knobs)

    def knob(self, name: str) -> Knob:
        for k in self.knobs:
            if k.name == name:
                return k
        raise KeyError(name)

    def __len__(self) -> int:
        return len(self.knobs)

    def subset(self, names: Sequence[str]) -> "Space":
        """Keep only ``names`` (plus constraints fully inside the subset)."""
        keep = set(names)
        knobs = tuple(k for k in self.knobs if k.name in keep)
        cons = tuple(c for c in self.constraints
                     if all(k in keep for k in c.knobs))
        return Space(knobs, cons)

    def with_knob(self, new: Knob) -> "Space":
        return Space(tuple(new if k.name == new.name else k for k in self.knobs),
                     self.constraints)

    # ---- defaults / projection ----------------------------------------------

    def default_config(self) -> Config:
        return {k.name: k.default for k in self.knobs}

    def completer(self, base: Optional[Config] = None):
        """Map a sub-space config onto this full space: start from
        ``base`` (default: this space's defaults), overlay the given
        knobs, project onto the clean domain.  The standard
        ``Controller.prepare`` hook for top-K search — non-top knobs
        stay pinned at their defaults inside every evaluation.

        Projection clips to THIS space's bounds: when the search may
        enlarge dynamic boundaries (paper Fig. 4), complete through
        ``full.overlaid(strategy.space).completer()`` instead, so enlarged
        probes reach the evaluator unclipped (see Sapphire.search_stage).
        """
        base_cfg = dict(base) if base is not None else self.default_config()

        def complete(cfg: Config) -> Config:
            full = dict(base_cfg)
            full.update(cfg)
            return self.project(full)
        return complete

    def overlaid(self, sub: "Space") -> "Space":
        """This space with matching knobs replaced by ``sub``'s versions
        — e.g. dynamic-boundary-enlarged top-K knobs, so projection
        respects the enlarged bounds."""
        sp = self
        for k in sub.knobs:
            if k.name in self.names:
                sp = sp.with_knob(k)
        return sp

    def project(self, cfg: Config) -> Config:
        """Clip to bounds, enforce gating (C3) and constraints (C4)."""
        out: Config = {}
        for k in self.knobs:
            v = cfg.get(k.name, k.default)
            out[k.name] = k.clip(v)
        # C3: gated knobs whose selector is not at an enabling value are
        # pinned to their default (they would be ignored by the system, but
        # pinning keeps the search space honest).
        for k in self.knobs:
            if k.gated_by is None:
                continue
            sel, enabling = k.gated_by
            if sel in out and out[sel] not in enabling:
                out[k.name] = k.default
        for c in self.constraints:
            out = c.project(out, self)
        return out

    def validate(self, cfg: Config) -> List[str]:
        """Return list of violation messages (empty = clean)."""
        errs = []
        for k in self.knobs:
            if k.name not in cfg:
                errs.append(f"missing {k.name}")
            elif not k.validate(cfg[k.name]):
                errs.append(f"bad value {k.name}={cfg[k.name]!r}")
        for c in self.constraints:
            if not c.satisfied(cfg):
                errs.append(f"violated {type(c).__name__}{c.knobs}")
        return errs

    def is_active(self, name: str, cfg: Config) -> bool:
        """C3: does this knob currently take effect?"""
        k = self.knob(name)
        if k.gated_by is None:
            return True
        sel, enabling = k.gated_by
        return cfg.get(sel) in enabling

    # ---- unit-cube encode/decode ---------------------------------------------

    def to_unit(self, cfg: Config) -> np.ndarray:
        return np.array([k.to_unit(cfg[k.name]) for k in self.knobs], np.float64)

    def from_unit(self, u: np.ndarray) -> Config:
        cfg = {k.name: k.from_unit(u[i]) for i, k in enumerate(self.knobs)}
        return self.project(cfg)

    # ---- batched encode/decode (vectorized across configs) --------------------

    def encode_batch(self, configs: Sequence[Config]) -> np.ndarray:
        """Vectorized :meth:`to_unit`: n configs -> ``[n, d]`` unit matrix.

        One numpy expression per knob (the batch axis is the long one);
        matches ``to_unit`` row-by-row exactly.
        """
        n = len(configs)
        u = np.zeros((n, len(self.knobs)), np.float64)
        for j, k in enumerate(self.knobs):
            vals = [c[k.name] for c in configs]
            if k.kind == "bool":
                u[:, j] = np.fromiter((1.0 if v else 0.0 for v in vals),
                                      np.float64, n)
            elif k.kind == "categorical":
                idx = {c: i for i, c in enumerate(k.choices)}
                denom = max(len(k.choices) - 1, 1)
                u[:, j] = np.fromiter((idx[v] for v in vals),
                                      np.float64, n) / denom
            else:
                x = np.asarray([float(v) for v in vals], np.float64)
                lo, hi = float(k.lo), float(k.hi)
                if k.log_scale:
                    lo, hi = math.log(lo), math.log(hi)
                    x = np.log(np.maximum(x, 1e-300))
                if hi != lo:
                    u[:, j] = (x - lo) / (hi - lo)
        return u

    def decode_batch(self, u: np.ndarray, project: bool = True) -> List[Config]:
        """Vectorized :meth:`from_unit`: ``[n, d]`` unit matrix -> n configs.

        The unit->value map runs as one numpy expression per knob; the
        C3/C4 projection (dict-shaped constraint logic) then runs per
        config.  Matches ``from_unit`` row-by-row (bit-exact except
        log-scaled floats, where vectorized exp may differ by 1 ulp).
        """
        u = np.asarray(u, np.float64)
        cols: List[list] = []
        for j, k in enumerate(self.knobs):
            c = np.clip(u[:, j], 0.0, 1.0)
            if k.kind == "bool":
                cols.append([bool(b) for b in c >= 0.5])
            elif k.kind == "categorical":
                idx = np.rint(c * (len(k.choices) - 1)).astype(int)
                cols.append([k.choices[i] for i in idx])
            else:
                lo, hi = float(k.lo), float(k.hi)
                if k.log_scale:
                    v = np.exp(math.log(lo) + c * (math.log(hi) - math.log(lo)))
                else:
                    v = lo + c * (hi - lo)
                if k.kind == "int":
                    v = np.rint(v)
                    if k.align > 1:
                        v = np.rint(v / k.align) * k.align
                    v = np.minimum(np.maximum(v, lo), hi)
                    cols.append([int(x) for x in v])
                else:
                    v = np.minimum(np.maximum(v, lo), hi)
                    cols.append([float(x) for x in v])
        names = self.names
        cfgs = [dict(zip(names, row)) for row in zip(*cols)]
        if not project:
            return cfgs
        return self.project_batch(cfgs, clip=False)   # decode already clipped

    def project_batch(self, configs: Sequence[Config],
                      clip: bool = True) -> List[Config]:
        """Batched :meth:`project`: bound-clipping vectorized per knob, then
        the per-config C3 gating and C4 constraint passes."""
        outs: List[Config]
        if clip:
            cols: List[list] = []
            for k in self.knobs:
                vals = [c.get(k.name, k.default) for c in configs]
                if k.kind == "int":
                    v = np.rint([float(x) for x in vals])
                    if k.align > 1:
                        v = np.rint(v / k.align) * k.align
                    v = np.minimum(np.maximum(v, float(k.lo)), float(k.hi))
                    cols.append([int(x) for x in v])
                elif k.kind == "float":
                    v = np.minimum(np.maximum(
                        np.asarray([float(x) for x in vals]),
                        float(k.lo)), float(k.hi))
                    cols.append([float(x) for x in v])
                elif k.kind == "bool":
                    cols.append([bool(x) for x in vals])
                else:
                    # same nearest-snap semantics as Knob.clip
                    cols.append([x if x in k.choices else k.clip(x)
                                 for x in vals])
            names = self.names
            outs = [dict(zip(names, row)) for row in zip(*cols)]
        else:
            outs = [dict(c) for c in configs]
        for out in outs:
            for k in self.knobs:
                if k.gated_by is None:
                    continue
                sel, enabling = k.gated_by
                if sel in out and out[sel] not in enabling:
                    out[k.name] = k.default
            for c in self.constraints:
                new = c.project(out, self)
                if new is not out:
                    out.update(new)
        return outs

    # ---- dynamic boundary (paper Fig. 4) --------------------------------------

    def near_boundary(self, cfg: Config, tol: float = 0.05) -> List[str]:
        """Knobs whose value sits within ``tol`` of a dynamic bound."""
        out = []
        for k in self.knobs:
            if not k.dynamic_bound or k.kind not in ("int", "float"):
                continue
            u = k.to_unit(cfg[k.name])
            if u <= tol or u >= 1 - tol:
                out.append(k.name)
        return out

    def expand_boundaries(self, names: Sequence[str], factor: float = 2.0) -> "Space":
        sp = self
        for n in names:
            sp = sp.with_knob(sp.knob(n).expanded(factor))
        return sp


# ---------------------------------------------------------------------------
# helpers
# ---------------------------------------------------------------------------

def pow2_knob(name: str, default: int, lo: int, hi: int, **kw) -> Knob:
    """A categorical knob over the power-of-two ladder [lo, hi] — the
    natural shape of kernel tiling parameters (block sizes, chunk widths,
    warp counts).  The numeric choice set means :meth:`Knob.clip` snaps
    off-ladder values (e.g. a halved ProductLeq projection) to the
    nearest rung instead of bouncing to the default."""
    assert lo > 0 and lo & (lo - 1) == 0, f"{name}: lo not a power of two"
    assert hi >= lo and hi & (hi - 1) == 0, f"{name}: hi not a power of two"
    choices = []
    v = lo
    while v <= hi:
        choices.append(v)
        v *= 2
    assert default in choices, f"{name}: default {default} off the ladder"
    return Knob(name, "categorical", default, choices=tuple(choices), **kw)
