"""Parameter-constraint resolution (paper §3.2).

Pipeline over a raw :class:`~repro_torch.core.space.Space`:

  1. **washing**  — drop C1 unconfigurable knobs (ids, addresses, paths) —
     the paper does this by static analysis of Ceph's config source; here
     the raw space carries ``configurable=False`` tags produced by the knob
     generator (knobs.py), and washing removes them.
  2. **pruning**  — C3: given the user case (which modules are exercised by
     the target workload), pin module-selector knobs whose value is forced,
     and drop knobs belonging to modules that cannot take effect.
  3. **boundary** — C2: every surviving numeric knob must have finite
     [lo, hi]; knobs without developer-documented bounds get a default box
     around the default value and are flagged ``dynamic_bound`` so the
     optimizer may enlarge it later (paper Fig. 4).

The output is the paper's "clean and complete configurable parameter
space": no misconfigurations representable, well-defined boundaries,
C4 constraints attached for projection.
"""

from __future__ import annotations

import math
from dataclasses import replace
from typing import Dict, List, Optional, Set, Tuple

from repro_torch.core.space import Config, Knob, Space


def wash(space: Space) -> Space:
    """C1: remove unconfigurable knobs entirely."""
    knobs = tuple(k for k in space.knobs if k.configurable)
    keep = {k.name for k in knobs}
    cons = tuple(c for c in space.constraints if all(n in keep for n in c.knobs))
    return Space(knobs, cons)


def prune(space: Space, pinned: Optional[Dict[str, object]] = None) -> Tuple[Space, Config]:
    """C3: pin module selectors and drop gated knobs that cannot activate.

    ``pinned`` maps selector-knob names to their forced value for this user
    case (e.g. ``{"optimizer": "adamw"}`` when the workload trains with
    AdamW, the way the paper pins ``osd_objectstore`` for a Bluestore
    deployment).  Returns the pruned space and the pin assignments (which
    become part of the recommended config verbatim).
    """
    pinned = dict(pinned or {})
    dropped: Set[str] = set()
    knobs: List[Knob] = []
    for k in space.knobs:
        if k.name in pinned:
            dropped.add(k.name)          # selector fixed -> not searched
            continue
        if k.gated_by is not None:
            sel, enabling = k.gated_by
            if sel in pinned and pinned[sel] not in enabling:
                dropped.add(k.name)      # module not in use -> prune
                continue
        knobs.append(k)
    keep = {k.name for k in knobs}
    cons = tuple(c for c in space.constraints if all(n in keep for n in c.knobs))
    return Space(tuple(knobs), cons), pinned


DEFAULT_SPAN = 8.0   # default box: [default/8, default*8] (log) when unbounded


def synthesize_boundaries(space: Space) -> Space:
    """C2: give every numeric knob a finite box.

    Knobs that already carry developer bounds are kept as-is.  Unbounded
    knobs get a box spanning ``DEFAULT_SPAN``× around the default and are
    flagged dynamic (the optimizer may enlarge it — the static-box failure
    mode of paper Fig. 4 is exactly what this avoids).
    """
    out = []
    for k in space.knobs:
        if k.kind not in ("int", "float"):
            out.append(k)
            continue
        if k.lo is not None and k.hi is not None and math.isfinite(k.lo) \
                and math.isfinite(k.hi):
            out.append(k)
            continue
        d = float(k.default) if float(k.default) != 0 else 1.0
        lo, hi = abs(d) / DEFAULT_SPAN, abs(d) * DEFAULT_SPAN
        if k.kind == "int":
            lo, hi = max(1, math.floor(lo)), max(2, math.ceil(hi))
        out.append(replace(k, lo=lo, hi=hi, log_scale=True, dynamic_bound=True))
    return Space(tuple(out), space.constraints)


def resolve(space: Space, pinned: Optional[Dict[str, object]] = None
            ) -> Tuple[Space, Config, Dict[str, int]]:
    """Full §3.2 pipeline: wash -> prune -> boundary synthesis.

    Returns (clean space, pinned assignments, stage report).
    """
    n0 = len(space)
    w = wash(space)
    n1 = len(w)
    p, pins = prune(w, pinned)
    n2 = len(p)
    b = synthesize_boundaries(p)
    report = {"raw": n0, "washed": n0 - n1, "pruned": n1 - n2, "clean": n2}
    return b, pins, report
