#!/usr/bin/env python3
"""Where a MoE train step's time goes on one chip of the 16 x 16 mesh.

    python3 tools/moe_chip_profile.py [--arch grok-1-314b] [--layers 2]
        [--knob moe_impl=dropping ...]    # from the root of a checkout, one GPU

Builds the chip share's step of the arch's train_4k cell
(``launch.dryrun.lower_cell`` under the production mesh's virtual chip
(0, 0), the space's default config with the knobs over it, as
``chip_smoke.py`` phase 14 runs it), takes one warm-up step, times two
steps with CUDA events, then records one step under ``torch.profiler``
and prints the step's wall, the device's busy time and idle share, the
device time by kind (GEMMs, flash, elementwise and reductions, copies,
the rest) and the 15 kernels that took the most device time.  Prints the
card's name and power limit first; exits non-zero without a GPU.
Imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
KINDS = (("gemm", ("gemm", "cutlass", "sm90_xmma", "cublas", "nvjet")),
         ("flash", ("flash",)),
         ("copy", ("copy", "memcpy", "memset", "cat", "index")),
         ("elementwise / reduction", ("elementwise", "reduce", "softmax",
                                      "vectorized", "unrolled")))


def kind_of(name: str) -> str:
    low = name.lower()
    for kind, keys in KINDS:
        if any(k in low for k in keys):
            return kind
    return "other"


def main() -> None:
    import torch
    if not torch.cuda.is_available():
        sys.exit("needs an NVIDIA GPU")
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="grok-1-314b")
    ap.add_argument("--layers", type=int, default=2)
    ap.add_argument("--knob", action="append", default=[])
    args = ap.parse_args()
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    from repro_torch.configs import get_config
    from repro_torch.core.costmodel import SINGLE_POD
    from repro_torch.core.knobs import clean_space
    from repro_torch.kernels.flash_attention import ops
    from repro_torch.launch import dryrun
    from repro_torch.launch.serve import parse_knobs
    from repro_torch.models.config import SHAPES_BY_NAME

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    for which in ("wgmma", "fma", "bwd", "bwd_wgmma"):
        ops.build(which=which)
    ops.load()
    cfg, cell = get_config(args.arch), SHAPES_BY_NAME["train_4k"]
    space, _, _ = clean_space(cfg, cell, SINGLE_POD)
    knobs = space.project({**space.default_config(),
                           **parse_knobs(args.knob)})
    rc = dryrun.default_runconfig(cfg, cell, knobs)
    mesh = dryrun.production_chip(device="cuda")
    low = dryrun.lower_cell(cfg, cell, rc, mesh, device="cuda",
                            n_layers=args.layers)
    print(f"{args.arch} train_4k, chip {mesh.coords} of 16 x 16, "
          f"{args.layers} layers, {low.batch} x {low.seq_len} tokens, "
          f"microbatch {rc.microbatch}, remat {rc.remat_policy}, "
          f"attention {rc.attention_impl}, moe {rc.moe_impl}", flush=True)
    low.step()
    torch.cuda.synchronize()
    times = []
    for _ in range(2):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        low.step()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / 1e3)
    print(f"step (CUDA events) {times} s", flush=True)
    torch.cuda.synchronize()
    t = time.perf_counter()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        low.step()
        torch.cuda.synchronize()
    wall = time.perf_counter() - t
    by_kind, by_name = {}, {}
    for ev in prof.key_averages():
        dev = getattr(ev, "self_device_time_total", None)
        if dev is None:
            dev = ev.self_cuda_time_total
        if dev <= 0:
            continue
        by_name[ev.key] = (dev / 1e6, ev.count)
        kind = kind_of(ev.key)
        by_kind[kind] = by_kind.get(kind, 0.0) + dev / 1e6
    busy = sum(by_kind.values())
    print(f"profiled step wall {wall:.4f} s, device busy {busy:.4f} s, idle "
          f"share {1 - busy / wall:.4f}", flush=True)
    for kind, s in sorted(by_kind.items(), key=lambda kv: -kv[1]):
        print(f"  {kind}: {s:.4f} s ({s / busy:.4f} of busy)", flush=True)
    print("top kernels by device time:", flush=True)
    for name, (s, n) in sorted(by_name.items(), key=lambda kv: -kv[1][0])[:15]:
        print(f"  {s:.4f} s, {n} launches: {name[:110]}", flush=True)


if __name__ == "__main__":
    main()
