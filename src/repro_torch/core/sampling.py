"""Constraint-aware sampling of the clean parameter space (paper §3.3).

The ranking phase needs ~300 random configurations spread over the whole
space.  Two samplers:

* ``random_configs``  — iid uniform in the unit cube (log-aware), projected
  through the C3/C4 constraint solver so every sample is a *valid* config
  (the paper's requirement that the domain "contains no misconfigurations").
* ``latin_hypercube`` — stratified LHS for better space coverage at the
  same sample count (what we actually use for ranking; iid kept for tests
  and for the GA/SA initializers).
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np

from repro_torch.core.space import Config, Space


def random_unit(rng: np.random.Generator, n: int, d: int) -> np.ndarray:
    return rng.random((n, d))


def lhs_unit(rng: np.random.Generator, n: int, d: int) -> np.ndarray:
    """Latin hypercube in [0,1]^d: one sample per stratum per dim."""
    u = (rng.permuted(np.tile(np.arange(n), (d, 1)), axis=1).T
         + rng.random((n, d))) / n
    return u


def random_configs(space: Space, n: int, seed: int = 0) -> List[Config]:
    rng = np.random.default_rng(seed)
    u = random_unit(rng, n, len(space))
    return space.decode_batch(u)


def latin_hypercube(space: Space, n: int, seed: int = 0) -> List[Config]:
    rng = np.random.default_rng(seed)
    u = lhs_unit(rng, n, len(space))
    return space.decode_batch(u)


def init_design(space: Space, n: int, rng: np.random.Generator,
                init_configs: Optional[List[Config]] = None) -> List[Config]:
    """The optimizer initial design: caller-supplied configs first (warm
    starts, e.g. the incumbent production config), then LHS fill up to
    ``n``.  Every returned config is projected onto the clean domain."""
    init = list(init_configs or [])
    need = max(n - len(init), 0)
    if need:
        init += space.decode_batch(lhs_unit(rng, need, len(space)))
    return space.project_batch(init)
