#!/usr/bin/env python3
"""How far one config's readings spread in ``tune_kernel``'s trace at the
mLSTM bench (a host-bound call), against the same configs timed head to
head in turns.

    python3 tools/autotune_bench_spread.py    # from the root of a checkout, one GPU

Runs ``tune_kernel("mlstm_chunk")`` at its bench's default shape (budget
24, batch 2, 12 warm-up calls and the best of 12 a reading, as
``chip_smoke.py`` phase 11 does) three times.  After each, every config
the trace holds and the default launch are timed head to head as phase 11
does (one call each in turns, best of 36), and each config's readings in
the trace are printed beside its head-to-head reading, with the trace in
the order it was measured.  Prints the card's name and power limit
first; exits non-zero without a GPU.  Imports nothing of JAX.
"""

from __future__ import annotations

import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
RUNS = 3


def main() -> None:
    import torch
    if not torch.cuda.is_available():
        sys.exit("torch.cuda.is_available() is false: this needs a GPU")
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    import chip_smoke
    from repro_torch.core.strategy import _config_key
    from repro_torch.kernels import autotune
    from repro_torch.kernels.mlstm_chunk import ops

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    ops.load()
    reps = chip_smoke.AUTOTUNE_RECHECK
    for run in range(RUNS):
        res = autotune.tune_kernel(
            "mlstm_chunk", shape={}, budget=chip_smoke.AUTOTUNE_BUDGET,
            batch_size=chip_smoke.AUTOTUNE_BATCH, repeats=reps, warmup=reps)
        trace = [(r.config, float(r.value)) for r in res["db"].records
                 if r.ok]
        seen = {}
        for cfg, value in trace:
            seen.setdefault(_config_key(cfg), (cfg, []))[1].append(value)
        h2h = chip_smoke.head_to_head(
            "mlstm_chunk", {}, {"default launch": None,
                                **{k: cfg for k, (cfg, _) in seen.items()}})
        print(f"run {run}: tuned {res['best_config']} read "
              f"{res['best_value']:.5f} ms in the trace; the default launch "
              f"{h2h['default launch']:.5f} ms head to head", flush=True)
        for k, (cfg, values) in sorted(seen.items(),
                                       key=lambda kv: h2h[kv[0]]):
            print(f"  {cfg}: trace " + ", ".join(f"{v:.5f}" for v in values)
                  + f"; head to head {h2h[k]:.5f}", flush=True)
        print("  the trace in order: "
              + ", ".join(f"{v:.5f}" for _, v in trace), flush=True)


if __name__ == "__main__":
    main()
