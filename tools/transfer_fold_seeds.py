#!/usr/bin/env python3
"""``benchmarks/perf_transfer.py``'s speedup gate across BO seeds.

    python3 tools/transfer_fold_seeds.py --device cuda     # the port, one GPU
    python3 tools/transfer_fold_seeds.py --device cpu      # the port, host
    PYTHONPATH=src python3 tools/transfer_fold_seeds.py --reference

The benchmark's gate (every leave-one-out fold reaches 0.99 of its
from-scratch best within 60 % of the 16-evaluation budget) is one draw at
BO seed 7.  This runs the same folds at each seed of ``--seeds`` and
prints, per seed, the evaluation at which each fold matched (``None``:
never) and whether all three made the gate: through the port on
``--device`` with the function ``chip_smoke.py`` phase 10 runs
(``transfer_folds``), or with ``--reference`` through the JAX package on
the host, as the benchmark builds its folds.  The GP-BO trajectory
follows the float rounding of its fits, so the gate's outcome at one
seed can move with the arithmetic while its rate over seeds does not.
"""

from __future__ import annotations

import argparse
import sys
import warnings
from dataclasses import replace
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def reference_folds(seed: int) -> dict:
    """The benchmark's folds through the JAX package at BO seed ``seed``
    (its full configuration; only the seed differs)."""
    sys.path.insert(0, str(ROOT))
    import benchmarks.perf_transfer as pt
    from repro.core import ranking
    from repro.core.controller import EvalRecord
    from repro.core.strategy import BOConfig, make_strategy
    from repro.transfer import build_corpus
    archs = (pt.RANK_ARCH,) + pt._folds(False)
    work = {a: pt._workload(a) for a in archs}
    sub = ranking.rank(work[pt.RANK_ARCH][0], work[pt.RANK_ARCH][1],
                       n_samples=300, seed=0,
                       stability_rounds=8).top_space(8)
    cfg = replace(pt._bo_cfg(False), seed=seed)
    tcfg = replace(cfg, n_init=3, n_iter=pt._budget(False) - 3,
                   local_sigma=0.02)
    scratch, records = {}, []
    for a in archs:
        trace = pt._drive(make_strategy("bo", sub, budget=pt._budget(False),
                                        cfg=cfg), pt._objective(*work[a]))
        scratch[a] = trace
        records += [EvalRecord(dict(c), float(v), 0.0, "scratch", a)
                    for c, v in zip(trace.configs, trace.values)]
    out = {}
    for target in pt._folds(False):
        corpus = build_corpus(sub, [records], exclude=(target,))
        trace = pt._drive(make_strategy(
            "transfer_bo", sub, budget=pt._budget(False), cfg=tcfg,
            corpus=corpus, corpus_fit_steps=100), pt._objective(*work[target]))
        out[target] = pt._evals_to(trace.best_values,
                                   min(scratch[target].values)
                                   / pt.QUALITY_RATIO)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--reference", action="store_true",
                    help="the JAX package on the host instead of the port")
    ap.add_argument("--seeds", default="0-9",
                    help="first-last, inclusive (default 0-9)")
    args = ap.parse_args(argv)
    lo, hi = (int(v) for v in args.seeds.split("-"))
    warnings.simplefilter("ignore")
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT))
    import chip_smoke
    if args.reference:
        where = "reference (JAX, host CPU)"
    else:
        import torch
        if args.device == "cuda" and not torch.cuda.is_available():
            chip_smoke.fail("--device cuda: torch.cuda.is_available() is "
                            "false")
        where = (f"port on {torch.cuda.get_device_name(0)}"
                 if args.device == "cuda" else "port on the host CPU")
        if args.device == "cuda":
            chip_smoke.phase_device()
    max_evals = int(chip_smoke.FOLD_FRACTION * chip_smoke.FOLD_BUDGET)
    passed = 0
    for seed in range(lo, hi + 1):
        if args.reference:
            matched = reference_folds(seed)
        else:
            folds, identical, _ = chip_smoke.transfer_folds(args.device,
                                                            seed=seed)
            chip_smoke.check(identical, f"seed {seed}: no-corpus identity")
            matched = {k: v["evals_to_match"] for k, v in folds.items()}
        ok = all(m is not None and m <= max_evals for m in matched.values())
        passed += ok
        print(f"{where} seed {seed}: matched at {matched} -> gate "
              f"{'held' if ok else 'missed'}", flush=True)
    print(f"{where}: gate held at {passed} of {hi - lo + 1} seeds "
          f"(<= {max_evals} of {chip_smoke.FOLD_BUDGET} evaluations)",
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
