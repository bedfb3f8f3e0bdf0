#!/usr/bin/env python3
"""Why `chip_smoke.py`'s phase 11 tunes fail evaluations: each error kept.

    python3 tools/autotune_errors.py [--runs N]   # from the root of a checkout, one GPU

Builds the kernels as ``chip_smoke.py`` does, then runs its phase 11
(``phase_autotune``) ``--runs`` times in one process.  Every exception a
``KernelEvaluator`` raises is kept; after each run the tool prints the
failures by kernel, shape (``B`` of the shape, ``None`` at the bench
default) and error (a tile with no instantiation counts as ``no-inst``),
the last lines of the first traceback that is not a refused tile, and
whether the phase's checks passed.  A failed check is reported, not
fatal.  Prints the card's name and power limit first; exits non-zero
without a GPU.  Imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import collections
import sys
import time
import traceback
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


class CheckFailed(Exception):
    pass


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--runs", type=int, default=3)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        sys.exit("needs an NVIDIA GPU")
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    import chip_smoke as cs
    from repro_torch.kernels import autotune

    def fail(msg):
        raise CheckFailed(msg)
    cs.fail = fail                       # a failed check ends the run only

    errors = []
    call = autotune.KernelEvaluator.__call__

    def kept(self, cfg, request=None):
        try:
            return call(self, cfg, request=request)
        except Exception as e:
            tb = " | ".join(traceback.format_exc().strip().splitlines()[-3:])
            errors.append((self.kernel, str((self.shape or {}).get("B")),
                           type(e).__name__, str(e)[:160], tb[-400:]))
            raise
    autotune.KernelEvaluator.__call__ = kept

    card = cs.phase_device()
    t0 = time.perf_counter()
    cs.build_all()
    print(f"built in {time.perf_counter() - t0:.1f} s", flush=True)
    for run in range(args.runs):
        errors.clear()
        ok = True
        try:
            cs.phase_autotune(card)
        except CheckFailed as e:
            ok = False
            print(f"run {run}: check failed: {e}", flush=True)
        by = collections.Counter(
            (k, b, t, "no-inst" if "no instantiation" in m
             or "no launch for" in m else m) for k, b, t, m, _ in errors)
        for key, n in sorted(by.items()):
            print(f"  {n:3d} x {key}", flush=True)
        other = [tb for _, _, _, m, tb in errors
                 if "no instantiation" not in m and "no launch for" not in m]
        if other:
            print(f"  first other traceback: {other[0]}", flush=True)
        print(f"run {run}: phase 11 {'passed' if ok else 'FAILED'}",
              flush=True)
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
