#!/usr/bin/env python3
"""On-card smoke check of the PyTorch/CUDA port (``src/repro_torch``).

    python3 chip_smoke.py          # from the root of a checkout, one GPU

Phases (any failure exits non-zero before the result line):

1. device: the ``nvidia-smi`` name and power limit; CUDA must be present.
2. kernels: build ``kernels/gp_gram/csrc/gp_gram.cu`` with nvcc for sm_90a,
   hold ``matern52_gram`` / ``matern52_cross`` against their plain-torch
   versions on the card (atol 2e-4) over the reference's test shapes, the
   main path's shapes and a stress shape, and time both (CUDA events).
3. main path: ``Sapphire(arch="yi-6b", shape="train_4k").tune()`` at the
   paper's budgets with ``batch_size`` 1 and 8; the kernel launch counters
   are zeroed before each run and must have risen after it.  The rank
   stage alone on the CPU must pick the same top-16 set.
4. profile: one GP fit + q-EI selection at the main path's shapes under
   ``torch.profiler``: device busy time against wall time.

The line before the last is ``{"kernels": [...]}`` with each kernel's
launches, error, times and bound; the last line is
``{"ok": true, "device": {...}}``.  Imports nothing of JAX.
"""

from __future__ import annotations

import json
import math
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

HBM_BYTES_PER_S = 3.35e12      # H100 SXM data sheet
FP32_FLOPS_PER_S = 67e12       # H100 SXM, float32 outside the tensor cores
ATOL = 2e-4                    # the reference's gp_gram test tolerance

GRAM_SOURCE = "src/repro_torch/kernels/gp_gram/csrc/gp_gram.cu"
GRAM_REPLACES = "src/repro/kernels/gp_gram/kernel.py:45"

# (n, m, d): the reference's GRAM_CASES, its off-ladder case, one knob,
# the main path's shapes (56 observations padded to 64; 2048 LHS + 256
# local + 5·16 sweeps = 2384 candidates; top-16 knobs) and a stress shape
# whose d spans two staged chunks
CASES = [(40, 17, 5), (130, 200, 16), (8, 8, 2), (300, 1, 24),
         (128, 128, 8), (136, 77, 9), (50, 30, 1), (64, 64, 16),
         (2384, 64, 16), (3000, 1000, 40)]
MAIN_GRAM = (64, 64, 16)
MAIN_CROSS = (2384, 64, 16)


def fail(msg: str) -> None:
    print(f"chip_smoke FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def check(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


def cuda_ms(fn, reps: int = 25, inner: int = 10) -> float:
    """Median over ``reps`` CUDA-event windows of ``inner`` back-to-back
    calls, in ms per call, after a warm-up."""
    import torch
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


def device_ms(fn, calls: int = 20) -> float:
    """Mean device time per call, in ms: the summed duration of the CUDA
    kernels ``fn`` launches, from ``torch.profiler`` (host time excluded)."""
    import torch
    fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    busy_us = sum(e.device_time for e in prof.events()
                  if e.device_type == torch.autograd.DeviceType.CUDA)
    return busy_us / calls / 1e3


def gram_bound(n: int, m: int, d: int, gram: bool):
    """(bound_ms, bound_by): each input read once and the output written
    once at the HBM rate, against the float32 operations at the
    non-tensor-core peak.  Per output: 2d for the dot product and 14 for
    the epilogue; per input row: 3d for scaling and its squared norm."""
    in_rows = n if gram else n + m
    nbytes = 4 * (in_rows * d + d + 1 + n * m)
    ops = n * m * (2 * d + 14) + 3 * d * in_rows
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / FP32_FLOPS_PER_S
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def phase_device():
    import torch
    print("== phase 1: device", flush=True)
    check(torch.cuda.is_available(), "torch.cuda.is_available() is false")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr.strip()}")
    card = smi.stdout.strip().splitlines()[0]
    print("card (nvidia-smi name, power.limit):")
    print(card)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"python {sys.version.split()[0]}", flush=True)
    return card


def phase_kernels(card: str):
    import torch
    from repro_torch.device import resolve_device
    from repro_torch.kernels.gp_gram import ops, ref

    print("== phase 2: kernels vs plain torch on the card", flush=True)
    dev = resolve_device("cuda")
    t0 = time.perf_counter()
    ops.build(verbose=True)
    print(f"nvcc build of {GRAM_SOURCE}: "
          f"{time.perf_counter() - t0:.2f} s", flush=True)

    gen = torch.Generator().manual_seed(0)
    err = {"gram": 0.0, "cross": 0.0}
    timing = {}
    print(f"timings on {card}: kernel_ms/plain_ms = CUDA events, median "
          "of 25 windows of 10 back-to-back calls, ms per call (host "
          "dispatch included); device_ms = profiled kernel time per call")
    for n, m, d in CASES:
        xa = torch.rand((n, d), generator=gen).to(dev)
        xb = torch.rand((m, d), generator=gen).to(dev)
        ls = (0.1 + 0.9 * torch.rand((d,), generator=gen)).to(dev)
        sv = torch.tensor(1.7, device=dev)
        for kind in ("gram", "cross"):
            if kind == "gram":
                args = (xa, ls, sv)
                fn, plain, shape = (ops.matern52_gram,
                                    ref.matern52_gram_ref, (n, n, d))
            else:
                args = (xa, xb, ls, sv)
                fn, plain, shape = (ops.matern52_cross,
                                    ref.matern52_cross_ref, (n, m, d))
            out = fn(*args)
            want = plain(*args)
            torch.cuda.synchronize()
            check(out.shape == want.shape,
                  f"{kind} {shape}: shape {tuple(out.shape)}")
            check(bool(torch.isfinite(out).all()),
                  f"{kind} {shape}: non-finite output")
            e = float((out - want).abs().max())
            err[kind] = max(err[kind], e)
            check(e <= ATOL, f"{kind} {shape}: max |kernel - plain| = {e}")
            k_ms = cuda_ms(lambda: fn(*args))
            p_ms = cuda_ms(lambda: plain(*args))
            b_ms, b_by = gram_bound(*shape, gram=kind == "gram")
            dev_ms = {}
            if shape in (MAIN_GRAM, MAIN_CROSS):
                dev_ms = {"device_ms": device_ms(lambda: fn(*args)),
                          "plain_device_ms": device_ms(lambda: plain(*args))}
            timing[(kind, shape)] = (k_ms, p_ms, b_ms, b_by, dev_ms)
            extra = "".join(f" {k}={v:.5f}" for k, v in dev_ms.items())
            print(f"  {kind:5s} n={shape[0]:5d} m={shape[1]:5d} "
                  f"d={shape[2]:3d}: max_abs_err={e:.3e} kernel_ms={k_ms:.5f}"
                  f" plain_ms={p_ms:.5f} bound_ms={b_ms:.6f} ({b_by})"
                  f" library_ms=none{extra}", flush=True)

    # duplicated rows: r² cancels to ~0 but not exactly, in the reference
    # too; the entries must land within atol of sv
    base = torch.rand((16, 16), generator=gen).to(dev)
    x = base[torch.arange(64, device=dev) % 16].contiguous()
    ls = torch.full((16,), 0.3, device=dev)
    g = ops.matern52_gram(x, ls, torch.tensor(1.7, device=dev))
    c = ops.matern52_cross(x, base, ls, torch.tensor(1.7, device=dev))
    same = (torch.arange(64, device=dev)[:, None] % 16
            == torch.arange(64, device=dev)[None, :] % 16)
    e_dup = max(float((g[same] - 1.7).abs().max()),
                float((c[same[:, :16]] - 1.7).abs().max()))
    check(e_dup <= ATOL, f"duplicated rows: max |K - sv| = {e_dup}")
    print(f"  duplicated rows: max |K - sv| = {e_dup:.3e}", flush=True)
    return err, timing


def _timed_sapphire(**kw):
    """A ``Sapphire`` whose stage methods record their wall time in
    ``stage_s`` (each ends in a device sync); ``tune()`` is what runs."""
    import torch
    from repro_torch.core.tuner import Sapphire

    class TimedSapphire(Sapphire):
        def _timed(self, name, fn, *a, **k):
            t0 = time.perf_counter()
            out = fn(*a, **k)
            torch.cuda.synchronize()
            self.__dict__.setdefault("stage_s", {})[name] = \
                time.perf_counter() - t0
            return out

        def rank_stage(self, *a, **k):
            return self._timed("rank", super().rank_stage, *a, **k)

        def search_stage(self, *a, **k):
            return self._timed("search", super().search_stage, *a, **k)

        def validate_stage(self, *a, **k):
            return self._timed("validate", super().validate_stage, *a, **k)

    return TimedSapphire(**kw)


def phase_main_path(card: str):
    import numpy as np
    import torch
    from repro_torch.core import ranking
    from repro_torch.core.lasso import lasso_path
    from repro_torch.core.tuner import Sapphire
    from repro_torch.kernels.gp_gram import ops

    print("== phase 3: Sapphire(arch='yi-6b', shape='train_4k').tune() "
          "at the paper's budgets (300 rank samples, top-16, BOConfig "
          "defaults)", flush=True)
    launches = {"gram": 0, "cross": 0}
    results = {}
    for bs in (1, 8):
        s = _timed_sapphire(arch="yi-6b", shape="train_4k", batch_size=bs,
                           device="cuda")
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        res = s.tune()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        g, c = ops.gram_launches, ops.cross_launches
        check(g > 0 and c > 0,
              f"batch_size={bs}: kernel launches gram={g} cross={c}")
        launches["gram"] += g
        launches["cross"] += c
        check(math.isfinite(res.best_value) and res.best_value > 0,
              f"batch_size={bs}: best value {res.best_value}")
        check(res.best_value <= res.default_value,
              f"batch_size={bs}: best {res.best_value} worse than default "
              f"{res.default_value}")
        sub = {k: v for k, v in res.best_config.items()
               if k in res.final_space.names}
        errs = res.final_space.validate(sub)
        check(errs == [], f"batch_size={bs}: invalid recommendation {errs}")
        check(res.n_evaluations == 300 + 8 + 48,
              f"batch_size={bs}: {res.n_evaluations} evaluations")
        stages = " ".join(f"{k}={v:.3f}s" for k, v in s.stage_s.items())
        print(f"batch_size={bs} on {card}: tune wall={wall:.3f}s {stages}")
        print(f"  speedup_vs_default={res.speedup_vs_default:.4f} "
              f"speedup_vs_expert={res.speedup_vs_expert:.4f} "
              f"best_step_s={res.best_value:.6f} "
              f"default_step_s={res.default_value:.6f}")
        print(f"  kernel launches: matern52_gram={g} matern52_cross={c}")
        print(f"  top-16: {res.ranking.top(16)}", flush=True)
        results[bs] = res

    # the lasso path alone on the card, on the ranking's own samples: its
    # per-iteration stopping test is one host read per FISTA step
    rk = results[1].ranking
    x, _ = ranking.encode(rk.space, rk.samples)
    y = ranking.encode_target(rk.values)
    lasso_path(x, y, device="cuda")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    lasso_path(x, y, device="cuda")
    torch.cuda.synchronize()
    print(f"lasso path on {card} ({x.shape[0]} samples x {x.shape[1]} "
          f"features, 50 lambdas): {time.perf_counter() - t0:.3f}s",
          flush=True)

    # the rank stage alone on the host at the same seed: the same samples
    # and values; only the lasso's float order differs
    s_cpu = Sapphire(arch="yi-6b", shape="train_4k", device="cpu")
    *_, space, _, _, ctrl = s_cpu._setup()
    t0 = time.perf_counter()
    rk_cpu = s_cpu.rank_stage(ctrl, space)
    print(f"rank stage on the host CPU: {time.perf_counter() - t0:.3f}s")
    check(np.allclose(rk_cpu.values, rk.values, rtol=1e-6, atol=0),
          "CPU rank stage scored different values")
    print(f"  top-16 (cuda): {rk.top(16)}")
    print(f"  top-16 (cpu):  {rk_cpu.top(16)}", flush=True)
    check(set(rk_cpu.top(16)) == set(rk.top(16)),
          "CPU and CUDA rank stages picked different top-16 sets")
    return launches


def phase_profile(card: str):
    import numpy as np
    import torch
    from repro_torch.core import gp

    print("== phase 4: one GP fit (150 Adam steps) + q=8 selection at the "
          "main path's shapes under torch.profiler", flush=True)
    rng = np.random.default_rng(0)
    x = rng.random((56, 16))
    y = np.log(1.0 + x[:, 0] + (x[:, 1] - 0.4) ** 2
               + 0.05 * rng.normal(size=56))
    cand = rng.random((2384, 16)).astype(np.float32)
    y_raw = np.zeros(64, np.float32)
    y_raw[:56] = y

    def round_():
        st = gp.fit(x, y, steps=150, pad_to=64, use_kernel=True,
                    device="cuda")
        return gp.select_batch(st, cand, y_raw, 56, float(y.min()), 8,
                               use_kernel=True).cpu()

    round_()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        round_()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    events = [e for e in prof.events()
              if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_us = sum(e.device_time for e in events)
    print(f"GP round on {card}: wall={wall * 1e3:.3f}ms "
          f"device_busy={busy_us / 1e3:.3f}ms "
          f"idle_share={1 - busy_us / 1e3 / (wall * 1e3):.4f} "
          f"device_kernels={len(events)}")
    by_name = {}
    for e in events:
        t, k = by_name.get(e.name, (0.0, 0))
        by_name[e.name] = (t + e.device_time, k + 1)
    for name, (t, k) in sorted(by_name.items(), key=lambda kv: -kv[1][0])[:8]:
        print(f"  {t / 1e3:9.3f}ms {k:6d}x {name[:90]}")
    sys.stdout.flush()


def main() -> None:
    import torch
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this check needs a GPU")
    if not (SRC / "repro_torch" / "__init__.py").exists():
        fail(f"{SRC / 'repro_torch'} is missing: run from a checkout")
    sys.path.insert(0, str(SRC))

    t_all = time.perf_counter()
    card = phase_device()
    err, timing = phase_kernels(card)
    launches = phase_main_path(card)
    phase_profile(card)

    kernels = []
    for kind, shape in (("gram", MAIN_GRAM),
                        ("cross", MAIN_CROSS)):
        k_ms, p_ms, b_ms, b_by, dev_ms = timing[(kind, shape)]
        kernels.append({
            "name": f"matern52_{kind}", "route": "cuda",
            "source": GRAM_SOURCE, "replaces": GRAM_REPLACES,
            "launches": launches[kind], "max_abs_err": err[kind],
            "ms": k_ms, "plain_ms": p_ms, "bound_ms": b_ms,
            "bound_by": b_by, "library_ms": None,
            "shape": list(shape), **dev_ms,
        })
    print(f"total {time.perf_counter() - t_all:.1f}s")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
