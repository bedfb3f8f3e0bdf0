#!/usr/bin/env python3
"""Where the MoE and hybrid train steps peak in the card's memory, stage by
stage, and what fresh host allocations cost the host's optimizer run.

    python3 tools/train_memory_stages.py [--layers N]   # from the root of a checkout, one GPU

Runs ``chip_smoke.train_family`` for qwen2-moe-a2.7b (at ``--layers`` if
given, else at the depth ``launch.dryrun.fit_depth`` picks) and for the
jamba cut, with the allocator's peak read and reset around every
``loss_and_grads`` call (one microbatch's forward and backward), before
every ``opt_update`` (the accumulation, the division into a second float32
copy and the norm) and after it (the update's temporaries).  Prints each
stage's peak and the bytes allocated after it (GiB), beside the
``estimate_bytes`` of the cell (``launch.dryrun``).  Then, on the host,
two elementwise passes over 201M float32 into fresh outputs and into
preallocated ones, and the same passes under ``chip_smoke.reused_host_heap``.

The checks of ``train_family`` are reported, not fatal.  Prints the card's
name and power limit first; exits non-zero without a GPU.  Imports nothing
of JAX.
"""

from __future__ import annotations

import argparse
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def host_passes(torch) -> tuple:
    """(fresh s, preallocated s): two elementwise passes over 201M float32."""
    x = torch.randn(201_326_592)
    t = time.perf_counter()
    y = x * 1.5
    z = y + x
    fresh = time.perf_counter() - t
    del y, z
    o1, o2 = torch.zeros_like(x), torch.zeros_like(x)
    t = time.perf_counter()
    torch.mul(x, 1.5, out=o1)
    torch.add(o1, x, out=o2)
    return fresh, time.perf_counter() - t


def main() -> None:
    import torch
    if not torch.cuda.is_available():
        sys.exit("needs an NVIDIA GPU")
    ap = argparse.ArgumentParser()
    ap.add_argument("--layers", type=int, default=None,
                    help="qwen2-moe depth (default: fit_depth's)")
    args = ap.parse_args()
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    import chip_smoke as cs
    from repro_torch.kernels.flash_attention import ops
    from repro_torch.launch import dryrun
    from repro_torch.train import optimizer as topt
    from repro_torch.train import train_loop as ttl
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    print(card, flush=True)
    with ThreadPoolExecutor(4) as pool:
        list(pool.map(lambda w: ops.build(which=w),
                      ("wgmma", "fma", "bwd", "bwd_wgmma")))
    ops.load()
    failed = []

    def report(ok, msg):
        if not ok:
            failed.append(msg)
            print(f"  (check failed: {msg})", flush=True)
    cs.check = report
    if args.layers is not None:
        cut = cs.family_train_cut

        def at_depth(arch):
            cfg, rc, reduced = cut(arch)
            if arch == cs.MOE_TRAIN_ARCH:
                cfg = cfg.scaled(n_layers=args.layers)
                reduced = [f"depth 24 -> {args.layers} (--layers)"]
            return cfg, rc, reduced
        cs.family_train_cut = at_depth

    gib = 2**30
    stages = []
    real_lag, real_upd = ttl.loss_and_grads, topt.opt_update

    def mark(name):
        torch.cuda.synchronize()
        stages.append((name, torch.cuda.max_memory_allocated() / gib,
                       torch.cuda.memory_allocated() / gib))
        torch.cuda.reset_peak_memory_stats()

    def lag(*a, **k):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        out = real_lag(*a, **k)
        mark("loss_and_grads")
        return out

    def upd(*a, **k):
        mark("accumulate, divide, norm")
        out = real_upd(*a, **k)
        mark("opt_update")
        return out
    ttl.loss_and_grads, topt.opt_update = lag, upd
    for arch in (cs.MOE_TRAIN_ARCH, cs.JAMBA_TRAIN_ARCH):
        stages.clear()
        cfg, rc, _ = cs.family_train_cut(arch)
        est = dryrun.estimate_bytes(cfg, rc, "train", cs.TRAIN_B, cs.TRAIN_S)
        out = cs.train_family(card, arch)
        print(f"{arch}, {cfg.n_layers} layers: estimate_bytes "
              f"{est / 1e9:.2f} GB ({est / gib:.2f} GiB), peak "
              f"{out['peak_gib']:.2f} GiB; by stage (the two step-1 gradient "
              f"runs first, then each step):", flush=True)
        for name, peak, alloc in stages:
            print(f"    {name}: peak {peak:.2f} GiB, allocated after "
                  f"{alloc:.2f} GiB", flush=True)
        torch.cuda.empty_cache()
    ttl.loss_and_grads, topt.opt_update = real_lag, real_upd
    for _ in range(2):
        fresh, pre = host_passes(torch)
        with cs.reused_host_heap():
            heap = host_passes(torch)[0]
            heap2 = host_passes(torch)[0]
        print(f"host ({torch.get_num_threads()} threads), two elementwise "
              f"passes over 201M float32: fresh outputs {fresh:.3f} s, "
              f"preallocated {pre:.3f} s, fresh under reused_host_heap "
              f"{heap:.3f} s then {heap2:.3f} s", flush=True)
    print(f"{len(failed)} check(s) of train_family failed", flush=True)


if __name__ == "__main__":
    main()
