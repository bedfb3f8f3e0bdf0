#!/usr/bin/env python3
"""Variants of the mLSTM tensor-core backward, timed on the card: what
bounds each of ``mlstm_chunk_bwd_wgmma.cu``'s kernels.

    python3 tools/mlstm_bwd_variants.py     # from the root of a checkout, one GPU

Each variant is the backward's source with text substitutions, built as
its own library under ``build/mlstm_bwd_variants/``:

* ``base``: the source as it is;
* ``no_carry_mma``: the carries without their products;
* ``no_lo``, ``no_hi``: the forward carry without copying its lo slab or
  its hi slab out of the staging tile;
* ``no_slabs``: neither carry writes a slab (hi, lo, G_C);
* ``rev_no_slab_loads``: the reverse carry without its TMA loads of the hi
  and lo tiles (its d decay reads whatever the stage holds).

All but ``base`` give wrong gradients: they show what each piece costs.
``base`` is first held against its plain version
(``ref.mlstm_chunkwise_grads`` with both keywords, rel L2 5e-3; 1e-2
against float32) at a few shapes and at xlstm-1.3b's layer at the train
step's microbatch ([1,4096,4,1024], chunk 256).  Then at the layer shape
each variant is timed with CUDA events (ms per call, variants in turns)
and its kernels' device time is read with ``torch.profiler``.  Prints
the card's name and power limit first; exits non-zero without a GPU or
when ``base`` is wrong.  Imports nothing of JAX.
"""

from __future__ import annotations

import statistics
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
LAYER = (1, 4096, 4, 1024, 256)       # xlstm-1.3b's layer, microbatch 1
CASES = [(1, 256, 2, 64, 128), (1, 512, 1, 128, 256), (2, 256, 1, 256, 128)]
MMA = "mma_box<TN, 1, 1>(acc, a_of(st) + wg * kBoxElems, b_of(st));"
HI = "rows_out(stg, p.hi + at);"
LO = "rows_out(stg, p.lo + at);"
GC = "rows_out(stg, p.gc + at);"
SKIP = "__syncthreads();"
VARIANTS = {
    "base": [],
    "no_carry_mma": [(MMA, "")],
    "no_lo": [(LO, SKIP)],
    "no_hi": [(HI, SKIP)],
    "no_slabs": [(HI, SKIP), (LO, SKIP), (GC, SKIP)],
    "rev_no_slab_loads": [(
        "      mbar_expect_tx(&full[st], kSlabBytes);",
        "      mbar_arrive(&full[st]);"), (
        """          tma_load_4d(a_of(st) + (y * NBX + x) * kBoxElems, map, &full[st],
                      pc0 + kBox * x, pr0 + kBox * y, slab, bh);""", ";")],
}


def main() -> None:
    import torch
    if not torch.cuda.is_available():
        sys.exit("torch.cuda.is_available() is false: this needs a GPU")
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels.build import BUILD_ROOT, NvccLibrary
    from repro_torch.kernels.mlstm_chunk import ops, ref

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    src = ops.BWD_WGMMA_SOURCE.read_text()
    libs = {}
    for name, subs in VARIANTS.items():
        text = src
        for old, new in subs:
            if text.count(old) != 1:
                sys.exit(f"variant {name}: {old!r} is not in the source once")
            text = text.replace(old, new)
        csrc = BUILD_ROOT / "mlstm_bwd_variants" / name / "csrc"
        csrc.mkdir(parents=True, exist_ok=True)
        (csrc / ops.BWD_WGMMA_SOURCE.name).write_text(text)
        libs[name] = NvccLibrary(f"mlstm_bwd_variants_{name}",
                                 csrc / ops.BWD_WGMMA_SOURCE.name,
                                 ops._LIBS["bwd_wgmma"].functions)
    with ThreadPoolExecutor(len(libs) + 1) as pool:
        list(pool.map(lambda lib: lib.build(),
                      list(libs.values()) + [ops._LIBS["wgmma"]]))
    for lib in libs.values():
        lib.load()
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(3)
    bf16 = torch.bfloat16

    def inputs(B, S, H, P, chunk):
        def n(*shape):
            return torch.randn(shape, generator=gen, device=dev)
        scale = torch.where(torch.rand((B, S, H, 1), generator=gen,
                                       device=dev) < 0.5, 0.05, 3.0)
        args = [(n(B, S, H, P) * scale).to(bf16),
                (n(B, S, H, P) * 2.0 / P ** 0.5).to(bf16),
                n(B, S, H, P).to(bf16), n(B, S, H),
                -torch.nn.functional.softplus(-(n(B, S, H) * 2.0 + 2.0))]
        h = ops.mlstm_chunk(*args, chunk=chunk)
        return args, h, n(B, S, H, P).to(bf16)

    def run(name, args, h, dh, chunk):
        return ops._backward_wgmma(*args, h, dh, chunk, library=libs[name])

    def rel(a, b):
        a, b = a.float(), b.float()
        return float((a - b).norm() / b.norm())

    ok = True
    for case in CASES + [LAYER]:
        args, h, dh = inputs(*case)
        got = run("base", args, h, dh, case[4])
        want = ref.mlstm_chunkwise_grads(*args, h, dh, case[4],
                                         operand_dtype=bf16,
                                         grad_operand_dtype=bf16)
        want32 = ref.mlstm_chunkwise_grads(*args, h, dh, case[4])
        r = max(rel(g, w) for g, w in zip(got, want))
        r32 = max(rel(g, w) for g, w in zip(got, want32))
        good = all(bool(torch.isfinite(g.float()).all()) for g in got) \
            and r <= 5e-3 and r32 <= 1e-2
        ok &= good
        print(f"base {case}: rel_l2 {r:.4e} vs the rounded plain version, "
              f"{r32:.4e} vs float32{'' if good else '  WRONG'}", flush=True)
    if not ok:
        sys.exit("base disagrees with its plain version")

    def cuda_ms(fn, reps=5, inner=5):
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

    args, h, dh = inputs(*LAYER)
    chunk = LAYER[4]
    ms = {name: [] for name in libs}
    for name in list(libs) + list(libs)[::-1]:             # in turns
        ms[name].append(cuda_ms(lambda: run(name, args, h, dh, chunk)))
    for name in libs:
        run(name, args, h, dh, chunk)
        torch.cuda.synchronize()
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            for _ in range(5):
                run(name, args, h, dh, chunk)
            torch.cuda.synchronize()
        dev_us = {}
        for e in prof.events():
            if (e.device_type == torch.autograd.DeviceType.CUDA
                    and "mlstm_bwd_wgmma_" in e.name):
                kernel = e.name.split("mlstm_bwd_wgmma_")[1].split("(")[0]
                acc = dev_us.setdefault(kernel, [0.0, 0])
                acc[0] += e.device_time
                acc[1] += 1
        total = sum(t for t, _ in dev_us.values()) / 5 / 1e3
        print(f"layer {list(LAYER)} [{name}]: ms per call "
              + ", ".join(f"{t:.4f}" for t in ms[name])
              + f"; device ms per call {total:.4f}: " + ", ".join(
                  f"{k} {t / n / 1e3:.4f}" for k, (t, n)
                  in sorted(dev_us.items(), key=lambda kv: -kv[1][0])),
              flush=True)


if __name__ == "__main__":
    main()
