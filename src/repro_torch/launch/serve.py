"""Serving driver: continuous-batching engine on a (smoke or full) config.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch yi-6b --device cpu
    PYTHONPATH=src python -m repro_torch.launch.serve --arch yi-6b --full --device cuda

The flags are the reference launcher's (``repro.launch.serve``) plus
``--device`` (default ``cuda``; ``cpu`` runs on the host).  Weights are
random bf16, made on the device from ``--seed``.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.configs import get_config, get_smoke_config
from repro_torch.models.model import Model
from repro_torch.runconfig import runconfig_from_knobs
from repro_torch.serve.engine import Engine


def parse_knobs(pairs):
    """``["k=v", ...]`` -> knob dict, with ints, floats and booleans cast
    (the reference's ``repro.launch.train.parse_knobs``)."""
    out = {}
    for p in pairs or []:
        k, v = p.split("=", 1)
        for cast in (int, float):
            try:
                v = cast(v)
                break
            except ValueError:
                continue
        if v in ("true", "True"):
            v = True
        if v in ("false", "False"):
            v = False
        out[k] = v
    return out


def main(argv=None):
    """Serve ``--requests`` random prompts; prints and returns the run's
    counts and wall times."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="yi-6b")
    ap.add_argument("--full", action="store_true")
    ap.add_argument("--requests", type=int, default=12)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--s-max", type=int, default=128)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--knob", action="append", default=[])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch) if args.full else get_smoke_config(args.arch)
    rc = runconfig_from_knobs(parse_knobs(args.knob))
    model = Model(cfg, device=args.device)
    params = model.init(args.seed)
    eng = Engine(model, params, rc, slots=args.slots, s_max=args.s_max)

    rng = np.random.default_rng(args.seed)
    t0 = time.monotonic()
    for i in range(args.requests):
        plen = int(rng.integers(4, 24))
        prompt = rng.integers(1, cfg.vocab_size, size=plen)
        eng.submit(prompt, max_new_tokens=args.max_new)
    done = eng.run()
    if model.device.type == "cuda":
        torch.cuda.synchronize(model.device)
    dt = time.monotonic() - t0
    toks = sum(len(r.out_tokens) for r in done)
    print(f"served {len(done)} requests, {toks} tokens in {dt:.1f}s "
          f"({toks/dt:.1f} tok/s, {eng.step_count} engine steps, "
          f"{dt / max(eng.step_count, 1) * 1e3:.2f} ms/step) on "
          f"{model.device}")
    for r in done[:4]:
        print(f"  rid {r.rid}: prompt {len(r.prompt)} -> {r.out_tokens[:8]}…")
    return {"requests": len(done), "tokens": toks, "wall_s": dt,
            "steps": eng.step_count, "finished": done}


if __name__ == "__main__":
    main()
