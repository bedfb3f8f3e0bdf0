#!/usr/bin/env python3
"""Does ``torch.profiler`` record the flash backward's device time after
each condition a long ``chip_smoke.py`` run goes through?

    python3 tools/profiler_conditions.py      # from the root of a checkout, one GPU

Each condition runs in a process of its own (the profiler's state is per
process), set up first and then three profiler sessions over three
launch sets of the backward at (1, 512, 512, 8, 2, 128) causal bf16 (the
wgmma route, ``ops.BWD_KERNELS["wgmma"]`` kernels a set):

* ``none``: nothing first;
* ``graph``: a CUDA graph captured and replayed (the GP fits' graphs);
* ``fullmem``: the caching allocator holding all but 256 MiB of the card;
* ``sessions``: 300 earlier profiler sessions;
* ``thread``: a thread launching kernels while the sessions run (the
  tuning daemon's clients).

Prints the card's name and power limit first, then per condition and
session the backward's kernels recorded (of 12) and their device µs;
exits non-zero without a GPU, or when a session missed one of them.
Imports nothing of JAX.
"""

from __future__ import annotations

import re
import subprocess
import sys
import threading
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
CONDITIONS = ("none", "graph", "fullmem", "sessions", "thread")
SHAPE = (1, 512, 8, 2, 128)           # B, S, H, Kh, D


def run_condition(condition: str) -> bool:
    """Set up ``condition``, profile the backward three times; True when
    every session recorded its kernels."""
    import torch
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    import chip_smoke
    from repro_torch.kernels.flash_attention import ops

    x = torch.randn(1024, 1024, device="cuda")
    stop, held = threading.Event(), []
    if condition == "graph":
        g = torch.cuda.CUDAGraph()
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            x @ x                                   # warm-up off the capture
        torch.cuda.current_stream().wait_stream(side)
        with torch.cuda.graph(g):
            x @ x
        for _ in range(10):
            g.replay()
    elif condition == "fullmem":
        free, _ = torch.cuda.mem_get_info()
        held.append(torch.empty(free - (256 << 20), dtype=torch.uint8,
                                device="cuda"))
    elif condition == "sessions":
        for _ in range(300):
            chip_smoke.profiled_device_us(lambda: x.sum())
    elif condition == "thread":
        def spin():
            while not stop.is_set():
                (x @ x).sum().item()
        threading.Thread(target=spin, daemon=True).start()

    B, S, H, Kh, D = SHAPE
    q, do = (torch.randn((B, S, H, D), device="cuda").bfloat16()
             for _ in range(2))
    k, v = (torch.randn((B, S, Kh, D), device="cuda").bfloat16()
            for _ in range(2))
    o, lse = ops._forward(q, k, v, True, None, None, "wgmma",
                          ops.DEFAULT_TILES["wgmma"], lse=True)

    def fn():
        return ops._backward(q, k, v, o, do, lse, True, None, None)
    fn()
    torch.cuda.synchronize()
    ok = True
    for session in range(3):
        _, by_name = chip_smoke.profiled_device_us(
            lambda: [fn() for _ in range(3)])
        bwd = {re.search(r"flash_bwd_\w+?_kernel", name).group(): (us, n)
               for name, (us, n) in by_name.items() if "flash_bwd" in name}
        n_bwd = sum(n for _, n in bwd.values())
        want = ops.BWD_KERNELS["wgmma"] * 3     # three sets
        ok &= n_bwd == want
        other = sum(t for t, _ in by_name.values()) \
            - sum(us for us, _ in bwd.values())
        print(f"{condition} session {session}: {n_bwd} of {want} backward "
              f"kernels, device us "
              + ", ".join(f"{name} {us:.1f}"
                          for name, (us, _) in sorted(bwd.items()))
              + f"; other kernels {other:.1f}", flush=True)
    stop.set()
    return ok


def main() -> None:
    import torch
    if not torch.cuda.is_available():
        sys.exit("torch.cuda.is_available() is false: this needs a GPU")
    if len(sys.argv) == 2:
        sys.exit(0 if run_condition(sys.argv[1]) else 1)
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels.flash_attention import ops

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    ops.build(which="wgmma")
    ops.build(which="bwd_wgmma")
    failed = []
    for condition in CONDITIONS:
        r = subprocess.run([sys.executable, __file__, condition],
                           timeout=300, cwd=ROOT)
        if r.returncode != 0:
            failed.append(condition)
    if failed:
        sys.exit(f"no backward device time recorded after: {failed}")


if __name__ == "__main__":
    main()
