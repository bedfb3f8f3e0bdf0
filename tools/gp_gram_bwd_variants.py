#!/usr/bin/env python3
"""Variants of the Matérn-5/2 Gram's backward kernels, timed on the card:
what the design choices of ``matern52_gram_bwd`` in ``gp_gram.cu`` buy at
the GP fit's shape (x [64, 16], G [64, 64]; the one-block kernel) and at
the tuning daemon's (x [64, 327]; the wide kernel); and, beside them, what
the forward's burst pass buys at the daemon's width (its default launch
at a session's Gram [64, 327] and the multi-task prior's [128, 327]).

    python3 tools/gp_gram_bwd_variants.py     # from the root of a checkout, one GPU

Each variant is the kernel's source with one or two text substitutions,
built as its own library under ``build/gp_gram_variants/``:

* ``base``: the source as it is (the one-block kernel: 512 threads, 8
  pairs a thread; the wide kernel: 16 x 16 pair tiles in clusters of 16);
* ``threads256`` / ``threads1024``: the one-block kernel with 256 threads
  (16 pairs a thread) or 1024 (4 pairs a thread);
* ``no_sums``: the one-block kernel without the feature sums into dL/dls
  (a wrong output: it shows what they cost);
* ``cluster8``: the wide kernel with 16 x 32 pair tiles in clusters of 8
  (the portable maximum: 8 blocks at n = 64, where the base takes 16);
* ``wide_no_sums``: the wide kernel without its feature sums (wrong, as
  ``no_sums``);
* ``wide_stage_only``: the wide kernel without r^2 and the feature sums:
  staging, weights, the cluster's reduction (wrong);
* ``fwd_no_burst``: the forward beyond 64 features walking d chunk by
  chunk, as every launch did before the burst pass;
* ``fwd_no_split``: the burst pass with one block a tile (2 x 2 blocks at
  the Gram [64, 327], where the base splits each tile's rows over 4).

Every variant that should be right is first held against the plain
version (``ref.matern52_gram_bwd``) at the shapes of ``CHECK`` (relative
L2 1e-3, two calls bit-equal), and the forward variants' default launch
bit-equal to the base's at the shapes of ``FWD_TIMED``.  Then at each
shape of ``TIMED`` (``FWD_TIMED``) the variants that change its kernel are
timed with CUDA events (ms per call, launch included, variants in turns)
and their device time per call is read with ``torch.profiler`` (every
kernel of the call).  Prints the card's name and power limit first;
exits non-zero without a GPU or when a variant that should be right is
wrong.  Imports nothing of JAX.
"""

from __future__ import annotations

import statistics
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
FIT = (64, 16)                        # the fit's Gram: 56 points padded to 64
DAEMON = (64, 327)                    # a daemon session's fit: 327 knobs
CHECK = [FIT, (300, 40), DAEMON, (65, 327), (128, 327), (300, 332)]
THREADS = "constexpr int kBwdThreads = 512;"
NARROW_SUMS = ("    // the feature sums, kC features at a time\n"
               "    for (int k0 = 0; k0 < d; k0 += kC) {")
WIDE_SUMS = "for (int item = tid; item < kWideGroups * nq; item += kWideThreads)"
WIDE_R2 = "for (int q = 0; q < nq; ++q) {"
FWD_BURST = "  if (direct && stages == 1) {            // the burst pass"
VARIANTS = {
    "base": [],
    "threads256": [(THREADS, "constexpr int kBwdThreads = 256;")],
    "threads1024": [(THREADS, "constexpr int kBwdThreads = 1024;")],
    "no_sums": [(NARROW_SUMS, NARROW_SUMS.replace("k0 < d;", "k0 < 0;"))],
    "cluster8": [("constexpr int kWideCols = 16;",
                  "constexpr int kWideCols = 32;"),
                 ("constexpr int kWideCluster = 16;",
                  "constexpr int kWideCluster = 8;")],
    "wide_no_sums": [(WIDE_SUMS, WIDE_SUMS.replace("item < kWideGroups * nq",
                                                   "item < 0"))],
    "wide_stage_only": [(WIDE_SUMS, WIDE_SUMS.replace(
        "item < kWideGroups * nq", "item < 0")), (WIDE_R2, WIDE_R2.replace(
            "q < nq", "q < 0"))],
    "fwd_no_burst": [(FWD_BURST, FWD_BURST.replace("direct && stages",
                                                   "false && stages"))],
    "fwd_no_split": [("  while (grid.z < 4 && F::kRP",
                      "  while (false && grid.z < 4 && F::kRP")],
}
WRONG = {"no_sums", "wide_no_sums", "wide_stage_only"}
# the shapes timed, and the variants that change the kernel each runs
TIMED = {FIT: ("base", "threads256", "threads1024", "no_sums"),
         DAEMON: ("base", "cluster8", "wide_no_sums", "wide_stage_only")}
FWD_TIMED = {(64, 64, 327): ("base", "fwd_no_split", "fwd_no_burst"),
             (128, 128, 327): ("base", "fwd_no_split", "fwd_no_burst")}
MAX_PARTIAL_ROWS = 16                 # the most any variant's launch takes


def main() -> None:
    import torch
    if not torch.cuda.is_available():
        sys.exit("torch.cuda.is_available() is false: this needs a GPU")
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels.build import BUILD_ROOT, NvccLibrary
    from repro_torch.kernels.gp_gram import ops, ref

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    src = ops.SOURCE.read_text()
    libs = {}
    for name, subs in VARIANTS.items():
        text = src
        for old, new in subs:
            if text.count(old) != 1:
                sys.exit(f"variant {name}: {old!r} is not in the source once")
            text = text.replace(old, new)
        csrc = BUILD_ROOT / "gp_gram_variants" / name / "csrc"
        csrc.mkdir(parents=True, exist_ok=True)
        (csrc / ops.SOURCE.name).write_text(text)
        libs[name] = NvccLibrary(f"gp_gram_variants_{name}",
                                 csrc / ops.SOURCE.name, ops._LIB.functions)
    with ThreadPoolExecutor(len(libs)) as pool:
        list(pool.map(lambda lib: lib.build(), libs.values()))
    for lib in libs.values():
        lib.load()
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(3)

    def inputs(n, d):
        x = torch.rand((n, d), generator=gen, device=dev)
        x[-8:] = 0.5                          # the fit's pad rows
        ls = 0.1 + 0.9 * torch.rand((d,), generator=gen, device=dev)
        sv = torch.full((1,), 1.7, device=dev)
        g = torch.randn((n, n), generator=gen, device=dev)
        return x, ls, sv, g

    def run(name, x, ls, sv, g):
        n, d = x.shape
        out = torch.empty((d + 1,), device=dev)
        partial = torch.empty((max(-(-n // 64), MAX_PARTIAL_ROWS), d + 1),
                              device=dev)
        err = libs[name].load().matern52_gram_bwd_launch(
            x.data_ptr(), ls.data_ptr(), sv.data_ptr(), g.data_ptr(),
            partial.data_ptr(), out.data_ptr(), n, d,
            torch.cuda.current_stream().cuda_stream)
        if err:
            sys.exit(f"variant {name}: CUDA error {err}")
        return out

    def rel(a, b):
        return float((a - b).double().norm() / b.double().norm())

    ok = True
    for n, d in CHECK:
        args = inputs(n, d)
        dls, dsv = ref.matern52_gram_bwd(*args[:2], args[2][0], args[3])
        for name in libs:
            if name in WRONG:
                continue
            out, again = run(name, *args), run(name, *args)
            torch.cuda.synchronize()
            r = max(rel(out[:d], dls), rel(out[d:], dsv.reshape(1)))
            good = r <= 1e-3 and torch.equal(out, again)
            ok &= good
            print(f"{name} n={n} d={d}: rel_l2 {r:.4e} vs plain, two calls "
                  f"bit-equal {torch.equal(out, again)}"
                  f"{'' if good else '  WRONG'}", flush=True)
    if not ok:
        sys.exit("a variant disagrees with the plain version")

    def cuda_ms(fn, reps=25, inner=10):
        for _ in range(3):
            fn()
        torch.cuda.synchronize()
        times = []
        for _ in range(reps):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(inner):
                fn()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end) / inner)
        return statistics.median(times)

    def fwd(name, xa, xb, ls, sv, out):
        n, d = xa.shape
        err = libs[name].load().matern52_launch(
            xa.data_ptr(), xb.data_ptr(), ls.data_ptr(), sv.data_ptr(),
            out.data_ptr(), n, xb.shape[0], d, *ops.DEFAULT_TILES,
            torch.cuda.current_stream().cuda_stream)
        if err:
            sys.exit(f"variant {name}: CUDA error {err}")
        return out

    fwd_args = {}
    for (n, m, d), names in FWD_TIMED.items():
        xa = torch.rand((n, d), generator=gen, device=dev)
        xb = xa[:m].clone() if n == m else torch.rand((m, d), generator=gen,
                                                      device=dev)
        ls = torch.full((d,), 0.3, device=dev)
        sv = torch.ones(1, device=dev)
        fwd_args[n, m, d] = (xa, xb, ls, sv)
        outs = [fwd(name, *fwd_args[n, m, d], torch.empty((n, m), device=dev))
                for name in names]
        torch.cuda.synchronize()
        same = all(torch.equal(o, outs[0]) for o in outs)
        ok &= same
        print(f"forward [{n},{d}]x[{m},{d}]: {', '.join(names)} bit-equal "
              f"{same}", flush=True)
    if not ok:
        sys.exit("a forward variant's bits differ from the base's")

    for shape, names in TIMED.items():
        args = inputs(*shape)
        ms = {name: [] for name in names}
        for name in names + names[::-1]:                  # in turns
            ms[name].append(cuda_ms(lambda: run(name, *args)))
        for name in names:
            run(name, *args)
            torch.cuda.synchronize()
            with torch.profiler.profile(
                    activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
                for _ in range(50):
                    run(name, *args)
                torch.cuda.synchronize()
            us = [e.device_time for e in prof.events()
                  if e.device_type == torch.autograd.DeviceType.CUDA
                  and "matern52_gram_bwd" in e.name]
            print(f"x {list(shape)} [{name}]: ms per call "
                  + ", ".join(f"{t:.5f}" for t in ms[name])
                  + f"; device us per call {sum(us) / 50:.3f} (median "
                  f"kernel {statistics.median(us) if us else 0:.3f}, "
                  f"{len(us)} kernels)", flush=True)

    for shape, names in FWD_TIMED.items():
        args = fwd_args[shape]
        out = torch.empty(shape[:2], device=dev)
        ms = {name: [] for name in names}
        for name in names + names[::-1]:                  # in turns
            ms[name].append(cuda_ms(lambda: fwd(name, *args, out)))
        for name in names:
            fwd(name, *args, out)
            torch.cuda.synchronize()
            with torch.profiler.profile(
                    activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
                for _ in range(50):
                    fwd(name, *args, out)
                torch.cuda.synchronize()
            us = [e.device_time for e in prof.events()
                  if e.device_type == torch.autograd.DeviceType.CUDA
                  and "matern52_kernel" in e.name]
            print(f"forward {list(shape)} [{name}]: ms per call "
                  + ", ".join(f"{t:.5f}" for t in ms[name])
                  + f"; device us per call {sum(us) / 50:.3f} (median "
                  f"kernel {statistics.median(us) if us else 0:.3f}, "
                  f"{len(us)} kernels)", flush=True)


if __name__ == "__main__":
    main()
