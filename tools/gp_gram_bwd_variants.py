#!/usr/bin/env python3
"""Variants of the Matérn-5/2 Gram's backward kernel, timed on the card:
what the design choices of ``matern52_gram_bwd`` in ``gp_gram.cu`` buy at
the GP fit's shape (x [64, 16], G [64, 64]).

    python3 tools/gp_gram_bwd_variants.py     # from the root of a checkout, one GPU

Each variant is the kernel's source with one text substitution, built as
its own library under ``build/gp_gram_variants/``:

* ``base``: the source as it is (512 threads, 8 pairs a thread);
* ``threads256`` / ``threads1024``: 256 threads (16 pairs a thread) or
  1024 (4 pairs a thread);
* ``no_sums``: without the feature sums into dL/dls (a wrong output: it
  shows what they cost).

Every variant but ``no_sums`` is first held against the plain version
(``ref.matern52_gram_bwd``) at the fit's shape and at a multi-tile,
two-chunk shape (relative L2 1e-3, two calls bit-equal).  Then at the
fit's shape each variant is timed with CUDA events (ms per call, launch
included, variants in turns) and its device time per launch is read with
``torch.profiler``.  Prints the card's name and power limit first; exits
non-zero without a GPU or when a variant that should be right is wrong.
Imports nothing of JAX.
"""

from __future__ import annotations

import statistics
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
FIT = (64, 16)                        # the fit's Gram: 56 points padded to 64
CHECK = [FIT, (300, 40)]
THREADS = "constexpr int kBwdThreads = 512;"
VARIANTS = {
    "base": [],
    "threads256": [(THREADS, "constexpr int kBwdThreads = 256;")],
    "threads1024": [(THREADS, "constexpr int kBwdThreads = 1024;")],
    "no_sums": [("    // the feature sums, kC features at a time\n"
                 "    for (int k0 = 0; k0 < d; k0 += kC) {",
                 "    // the feature sums, kC features at a time\n"
                 "    for (int k0 = 0; k0 < 0; k0 += kC) {")],
}
WRONG = {"no_sums"}


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
        tiles = (n + 63) // 64
        partial = torch.empty((tiles, d + 1), device=dev) if tiles > 1 \
            else None
        err = libs[name].load().matern52_gram_bwd_launch(
            x.data_ptr(), ls.data_ptr(), sv.data_ptr(), g.data_ptr(),
            None if partial is None else partial.data_ptr(),
            out.data_ptr(), n, d, torch.cuda.current_stream().cuda_stream)
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

    args = inputs(*FIT)
    ms = {name: [] for name in libs}
    for name in list(libs) + list(libs)[::-1]:            # in turns
        ms[name].append(cuda_ms(lambda: run(name, *args)))
    for name in libs:
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
        print(f"x {list(FIT)} [{name}]: ms per call "
              + ", ".join(f"{t:.5f}" for t in ms[name])
              + f"; device us per launch {statistics.mean(us):.3f} "
              f"(median {statistics.median(us):.3f}, {len(us)} launches)",
              flush=True)


if __name__ == "__main__":
    main()
