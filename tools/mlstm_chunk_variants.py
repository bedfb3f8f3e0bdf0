#!/usr/bin/env python3
"""Variants of the mLSTM tensor-core kernel, timed on the card: what each
design choice of ``mlstm_chunk_wgmma.cu`` buys, and what bounds its passes.

    python3 tools/mlstm_chunk_variants.py     # from the root of a checkout, one GPU

Each variant is the kernel's source with one text substitution, built as
its own library under ``build/mlstm_variants/``:

* ``base``: the source as it is;
* ``wait0``: the output pass waits for each item's products before it
  issues the next (``wgmma.wait_group 0`` instead of 1);
* ``out128``: two output warpgroups on 128-column tiles instead of 256;
* ``wg1``: one output warpgroup (64 rows per block) at every chunk;
* ``state4``: the state pass with a 4-stage ring (one block per SM);
* ``no_state``, ``no_qk``, ``no_qn``: the output pass without its q C_prev
  products, its q k^T phase or its q . n_prev (wrong outputs: they show
  what each piece costs).

``base`` is first held against the route's plain version at a few shapes
and at xlstm-1.3b's layer shape (rel L2 1e-3, and 1e-2 against the
float32 version).  Then at the layer shape ([2,4096,4,1024], bf16) each
variant is timed with CUDA events (ms per call, variants in turns) and
its kernels' device time is read with ``torch.profiler``.  Prints the
card's name and power limit first; exits non-zero without a GPU or when
``base`` is wrong.  Imports nothing of JAX.
"""

from __future__ import annotations

import statistics
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
LAYER = (2, 4096, 4, 1024)            # xlstm-1.3b's mLSTM layer at B=2
CHUNKS = (256, 1024)
CASES = [(1, 128, 1, 64, 128), (1, 512, 3, 64, 256), (1, 512, 3, 128, 256),
         (2, 512, 1, 256, 128), (1, 2048, 1, 1024, 1024),
         (1, 1024, 2, 512, 512), (1, 768, 2, 512, 256)]
VARIANTS = {
    "base": [],
    "wait0": [("    wgmma_commit();\n    wgmma_wait<1>();",
               "    wgmma_commit();\n    wgmma_wait<0>();")],
    "out128": [("return launch_out<256, 2>(", "return launch_out<128, 2>(")],
    "wg1": [("return C <= 256 ? 2 : 1;", "return 1;")],
    "state4": [("static constexpr int kStages = 3;",
                "static constexpr int kStages = 4;")],
    "no_state": [("      if (t > 0)\n", "      if (false)\n"),
                 ("    if (t > 0) {", "    if (false) {")],
    "no_qk": [("const int n_kb = (i0 + kBlockRows + kKeys - 1) / kKeys;",
               "const int n_kb = 0;")],
    "no_qn": [("if (ct == 0) add_qn(st, pb);", "")],
}


def main() -> None:
    import torch
    import torch.nn.functional as F
    if not torch.cuda.is_available():
        sys.exit("torch.cuda.is_available() is false: this needs a GPU")
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels.build import BUILD_ROOT, NvccLibrary
    from repro_torch.kernels.mlstm_chunk import ops, ref

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    src = ops.WGMMA_SOURCE.read_text()
    libs = {}
    for name, subs in VARIANTS.items():
        text = src
        for old, new in subs:
            if text.count(old) != 1:
                sys.exit(f"variant {name}: {old!r} is not in the source once")
            text = text.replace(old, new)
        csrc = BUILD_ROOT / "mlstm_variants" / name / "csrc"
        csrc.mkdir(parents=True, exist_ok=True)
        (csrc / ops.WGMMA_SOURCE.name).write_text(text)
        libs[name] = NvccLibrary(f"mlstm_variants_{name}",
                                 csrc / ops.WGMMA_SOURCE.name,
                                 ops._LIBS["wgmma"].functions)
    with ThreadPoolExecutor(len(libs)) as pool:
        list(pool.map(lambda lib: lib.build(), libs.values()))
    for lib in libs.values():
        lib.load()
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(5)

    def inputs(B, S, H, P):
        def n(*shape):
            return torch.randn(shape, generator=gen, device=dev)
        q, k, v = n(B, S, H, P) * 0.5, n(B, S, H, P) * 0.5 / P ** 0.5, \
            n(B, S, H, P) * 0.5
        return ([t.bfloat16() for t in (q, k, v)]
                + [n(B, S, H), -F.softplus(-n(B, S, H) * 2.0)])

    def run(name, *args):
        return ops._wgmma(*args, library=libs[name])

    def rel(a, b):
        a, b = a.float(), b.float()
        return float((a - b).norm() / b.norm())

    ok = True
    for case in CASES + [LAYER + (c,) for c in CHUNKS]:
        B, S, H, P, c = case
        args = inputs(B, S, H, P)
        out = run("base", *args, c)
        r = rel(out, ops.plain_version(*args, c))
        r32 = rel(out, ref.mlstm_chunkwise(*args, c))
        good = bool(torch.isfinite(out.float()).all()) and r <= 1e-3 \
            and r32 <= 1e-2
        ok &= good
        print(f"base {case}: rel_l2 {r:.4e} vs plain, {r32:.4e} vs float32"
              f"{'' if good else '  WRONG'}", flush=True)
    if not ok:
        sys.exit("base disagrees with its plain version")

    def cuda_ms(fn, reps=5, inner=4):
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

    args = inputs(*LAYER)
    for c in CHUNKS:
        ms = {name: [] for name in libs}
        for name in list(libs) + list(libs)[::-1]:        # in turns
            ms[name].append(cuda_ms(lambda: run(name, *args, c)))
        for name in libs:
            run(name, *args, c)
            torch.cuda.synchronize()
            with torch.profiler.profile(
                    activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
                for _ in range(5):
                    run(name, *args, c)
                torch.cuda.synchronize()
            dev_us = {}
            for e in prof.events():
                if (e.device_type == torch.autograd.DeviceType.CUDA
                        and "mlstm_chunk_" in e.name):
                    kernel = e.name.split("mlstm_chunk_")[1].split("(")[0]
                    acc = dev_us.setdefault(kernel, [0.0, 0])
                    acc[0] += e.device_time
                    acc[1] += 1
            print(f"layer {list(LAYER)} chunk {c} [{name}]: ms per call "
                  + ", ".join(f"{t:.4f}" for t in ms[name])
                  + "; device ms per launch " + ", ".join(
                      f"{k} {t / n / 1e3:.4f}" for k, (t, n)
                      in dev_us.items()), flush=True)


if __name__ == "__main__":
    main()
