"""The paper, end to end, on the port: recommend a configuration for a cell.

    PYTHONPATH=src python -m repro_torch [--arch yi-6b] [--shape train_4k]
        [--quick] [--batch 8] [--device cuda]

Pipeline (paper Fig. 3): raw knob space -> §3.2 constraint resolution ->
§3.3 Lasso ranking (~300 noisy test-cluster evaluations) -> §3.4 GP-BO
with dynamic boundaries over the top-16 -> report vs default & expert
manual configs.  The lasso path and the GP run on ``--device`` (the card
by default; ``cpu`` runs on the host).
"""

import argparse
import json

from repro_torch.core.strategy import BOConfig
from repro_torch.core.tuner import Sapphire


def main():
    ap = argparse.ArgumentParser(prog="python -m repro_torch")
    ap.add_argument("--arch", default="yi-6b")
    ap.add_argument("--shape", default="train_4k")
    ap.add_argument("--quick", action="store_true")
    ap.add_argument("--batch", type=int, default=8,
                    help="configs per Experiment-Unit round (q-batch BO + "
                         "chunked ranking); 1 = the paper's sequential loop")
    ap.add_argument("--device", default="cuda",
                    help="where the lasso path and the GP run: cuda | cpu")
    args = ap.parse_args()

    s = Sapphire(
        arch=args.arch, shape=args.shape,
        n_rank_samples=120 if args.quick else 300,
        batch_size=args.batch,
        bo_config=BOConfig(n_init=8, n_iter=16 if args.quick else 48,
                           n_candidates=1024, fit_steps=100),
        device=args.device)
    res = s.tune()

    print("\n=== SAPPHIRE recommendation ===")
    print(json.dumps(res.summary(), indent=1, default=str))
    print("\ntop knobs (Table-2 style):")
    for r in res.ranking.table(16):
        print(f"  {r['knob']:28s} {r['type']:11s} default={r['default']!s:>8s}"
              f" range={r['range']:20s} imp={r['importance']:.4f}")
    print("\nrecommended config (non-default knobs only):")
    defaults = res.ranking.space.default_config()
    diff = {k: v for k, v in res.best_config.items()
            if defaults.get(k) != v}
    print(json.dumps(diff, indent=1, default=str))
    print(f"\nspeedup vs default: {res.speedup_vs_default:.2f}x | "
          f"vs expert manual: {res.speedup_vs_expert:.2f}x")


if __name__ == "__main__":
    main()
