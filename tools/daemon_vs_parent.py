#!/usr/bin/env python3
"""The tuning daemon's cell and one GP round at d 327, as ``chip_smoke.py``
phase 10 runs them, on this tree's port and on an earlier tree's, in turns
(earlier, this, this, earlier), each run in a process of its own, on the
card.

    git archive <commit> | tar -x -C build/parent
    python3 tools/daemon_vs_parent.py build/parent

Every run imports this checkout's ``chip_smoke.py`` (the harness: the same
clients, traffic and profiler for both trees) and the ``repro_torch`` of
the tree it measures (``<tree>/src``, whose kernels are built under
``<tree>/build/`` before anything is timed).  A run first serves both
workloads' sessions alone (``service_local_run``, which also captures the
fits' CUDA graphs, as phase 10's local baseline does), then the daemon's
8 HTTP clients (``service_daemon``: wall, sessions/s, cache hit rate,
evaluator calls, gp_gram launches), then ``gp_round_327`` (wall, device
busy, idle share, the Gram forward's and backward's shares).  Prints the
card's name and power limit first, a JSON line per run, then each metric
for both trees; exits non-zero without a GPU or when a run fails.
Imports nothing of JAX.
"""

from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

RUN = """
import json, sys, time
sys.path[:0] = [sys.argv[1], sys.argv[2]]
import torch
import chip_smoke as cs
from repro_torch.kernels.gp_gram import ops
ops.build()
ops._LIB.load()
card = sys.argv[3]
budget = cs.SERVICE_CFG["n_init"] + cs.SERVICE_CFG["n_iter"]
for wl in cs.SERVICE_WORKLOADS:
    cs.service_local_run(wl, budget, cs.SERVICE_SEED, cs.SERVICE_CFG, "cuda")
torch.cuda.synchronize()
ops.reset_launch_counts()
srv, httpd, url, replies, wall = cs.service_daemon("cuda", cs.SERVICE_CFG)
torch.cuda.synchronize()
try:
    cache = srv.pool.cache.snapshot()
    calls = sum(srv.pool.inner.backends[wl].calls
                for wl in cs.SERVICE_WORKLOADS)
finally:
    httpd.shutdown()
    srv.close()
launches = [ops.gram_launches, ops.cross_launches, ops.gram_bwd_launches]
rnd = cs.gp_round_327(card)
print(json.dumps({"daemon_wall_s": wall,
                  "sessions_per_s": cs.SERVICE_CLIENTS / wall,
                  "hit_rate": cache["hit_rate"], "evaluator_calls": calls,
                  "launches": launches, "round327": rnd}))
"""


def main() -> None:
    import torch
    if not torch.cuda.is_available():
        sys.exit("torch.cuda.is_available() is false: this needs a GPU")
    if len(sys.argv) != 2:
        sys.exit(__doc__)
    trees = {"earlier": Path(sys.argv[1]).resolve(), "this": ROOT}
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    print(card, flush=True)
    got = {"earlier": [], "this": []}
    for key in ("earlier", "this", "this", "earlier"):
        r = subprocess.run([sys.executable, "-c", RUN,
                            str(trees[key] / "src"), str(ROOT), card],
                           capture_output=True, text=True, timeout=900,
                           cwd=ROOT)
        if r.returncode != 0:
            sys.exit(f"the {key} tree's run failed:\n{r.stderr[-3000:]}")
        out = json.loads(r.stdout.strip().splitlines()[-1])
        got[key].append(out)
        print(f"{key} tree: {json.dumps(out)}", flush=True)
    rows = [("daemon wall s", lambda o: o["daemon_wall_s"]),
            ("sessions/s", lambda o: o["sessions_per_s"]),
            ("round327 wall ms", lambda o: o["round327"]["wall_ms"]),
            ("round327 busy ms", lambda o: o["round327"]["busy_ms"]),
            ("round327 idle share", lambda o: o["round327"]["idle_share"]),
            ("round327 forward share",
             lambda o: o["round327"]["forward_share"]),
            ("round327 backward share",
             lambda o: o["round327"]["backward_share"])]
    for name, fn in rows:
        print(f"{name}: earlier {[round(fn(o), 6) for o in got['earlier']]}"
              f", this tree {[round(fn(o), 6) for o in got['this']]}",
              flush=True)


if __name__ == "__main__":
    main()
