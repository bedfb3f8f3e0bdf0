"""The reference's per-device counts of a cell on a 2 x 2 mesh, run in a
process of its own.

    python tests/torch_virtual_reference.py SPEC.json

``repro.launch.dryrun`` forces 512 host devices when it is imported (its
first lines set ``XLA_FLAGS``), so ``test_torch_virtual_mesh.py`` starts
this script as a subprocess.  ``SPEC.json`` lists the runs: each names an
architecture's smoke config (cut to the pattern positions ``keep`` when
it names them), RunConfig knobs and a cell's sequence length, global
batch and mode (``"train"`` by default; ``"prefill"`` or ``"decode"``).  Each run lowers and compiles the cell with the
reference's own ``lower_cell`` on ``jax.sharding.Mesh(devices[:4]
.reshape(2, 2), ("data", "model"))`` (the auto-axis mesh: explicit axes
refuse the embedding gather) and reads the compiled HLO with
``analyze_hlo``.  Prints one JSON object: per run, the per-device FLOPs
and collective bytes by kind.
"""

import json
import sys

from repro.launch import dryrun  # noqa: I001 -- sets XLA_FLAGS first

import jax
import numpy as np
from jax.sharding import Mesh

from repro.configs import get_smoke_config
from repro.launch.roofline import analyze_hlo
from repro.models.config import ShapeCell


def main(spec_path):
    with open(spec_path) as f:
        runs = json.load(f)
    mesh = Mesh(np.array(jax.devices()[:4]).reshape(2, 2), ("data", "model"))
    out = {}
    for r in runs:
        cfg = get_smoke_config(r["arch"])
        keep = r.get("keep")
        if keep:             # a depth cut: the pattern positions kept
            cfg = cfg.scaled(n_layers=len(keep),
                             pattern=tuple(cfg.pattern[i] for i in keep))
        cell = ShapeCell("tiny", seq_len=r["seq"], global_batch=r["batch"],
                         mode=r.get("mode", "train"))
        rc = dryrun.default_runconfig(cfg, cell, r["knobs"])
        with mesh:
            fn, args = dryrun.lower_cell(cfg, cell, rc, mesh)
            compiled = fn.lower(*args).compile()
        rep = analyze_hlo(compiled.as_text())
        out[r["name"]] = {"flops": rep.flops,
                          "coll_by_kind": rep.coll_by_kind}
    print(json.dumps(out))


if __name__ == "__main__":
    main(sys.argv[1])
