#!/usr/bin/env python3
"""How far the tensor-core mLSTM backward's bf16 roundings move its plain
version, at xlstm-1.3b's layer at the train step's microbatch.

    PYTHONPATH=src python3 tools/mlstm_bwd_rounding.py [--device cpu|cuda] [--shape B,S,H,P,chunk] [--oracle]

Inputs as ``chip_smoke.mlstm_bwd_inputs`` makes them (q rows scaled by
0.05 or 3, k ~ 2 N / sqrt(P), v ~ N, the gates, dh ~ N; bf16 q, k, v,
dh), from a seed, on the chosen device; h is the wgmma route's plain
forward (``mlstm_chunkwise(operand_dtype=bfloat16)``).  Prints the
relative L2 of dq, dk, dv, d logi and d logf between three plain
backwards (``ref.mlstm_chunkwise_grads``): float32 (no rounding), the
forward's roundings (``operand_dtype``) and the tensor-core backward's
(both keywords), for the gates of ``chip_smoke.py`` phase 13 (1e-2 against
float32).  ``--oracle`` (small shapes) also holds each against autograd
of the sequential oracle ``ref.mlstm_sequential`` on the same bf16
numbers in float32, as the CPU tests hold them against ``jax.grad`` of
the reference's.  ~20 s on the CPU at the layer shape with 8 threads,
~3 GB.  Imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

NAMES = ("dq", "dk", "dv", "dlogi", "dlogf")


def main() -> None:
    import torch
    from repro_torch.kernels.mlstm_chunk import ref

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cpu")
    ap.add_argument("--shape", default="1,4096,4,1024,256")
    ap.add_argument("--seed", type=int, default=17)
    ap.add_argument("--threads", type=int, default=8)
    ap.add_argument("--oracle", action="store_true")
    a = ap.parse_args()
    torch.set_num_threads(a.threads)
    B, S, H, P, chunk = (int(x) for x in a.shape.split(","))
    dev = torch.device(a.device)
    gen = torch.Generator(device=dev).manual_seed(a.seed)

    def n(*shape):
        return torch.randn(shape, generator=gen, device=dev)
    scale = torch.where(torch.rand((B, S, H, 1), generator=gen, device=dev)
                        < 0.5, 0.05, 3.0)
    bf16 = torch.bfloat16
    q, k, v = ((n(B, S, H, P) * scale).to(bf16),
               (n(B, S, H, P) * 2.0 / P ** 0.5).to(bf16),
               n(B, S, H, P).to(bf16))
    logi = n(B, S, H)
    logf = -torch.nn.functional.softplus(-(n(B, S, H) * 2.0 + 2.0))
    dh = n(B, S, H, P).to(bf16)
    args = (q, k, v, logi, logf)
    t0 = time.perf_counter()
    h = ref.mlstm_chunkwise(*args, chunk, operand_dtype=bf16)
    plain = {
        "float32": ref.mlstm_chunkwise_grads(*args, h, dh, chunk),
        "forward-rounded": ref.mlstm_chunkwise_grads(
            *args, h, dh, chunk, operand_dtype=bf16),
        "tensor-core (both keywords)": ref.mlstm_chunkwise_grads(
            *args, h, dh, chunk, operand_dtype=bf16,
            grad_operand_dtype=bf16)}
    print(f"[B,S,H,P] = {[B, S, H, P]}, chunk {chunk}, seed {a.seed}, "
          f"{a.device}: three plain backwards in "
          f"{time.perf_counter() - t0:.1f} s")

    def rel(x, y):
        return float((x.double() - y.double()).norm() / y.double().norm())
    base = plain["float32"]
    for name in ("forward-rounded", "tensor-core (both keywords)"):
        print(f"  {name} vs float32: " + ", ".join(
            f"{k} {rel(g, w):.3e}" for k, g, w in zip(NAMES, plain[name],
                                                     base)))
    print("  tensor-core vs forward-rounded: " + ", ".join(
        f"{k} {rel(g, w):.3e}" for k, g, w in zip(
            NAMES, plain["tensor-core (both keywords)"],
            plain["forward-rounded"])))
    if a.oracle:
        ins = [t.float().clone().requires_grad_() for t in args]
        want = torch.autograd.grad(ref.mlstm_sequential(*ins), ins,
                                   dh.float())
        for name, got in plain.items():
            print(f"  {name} vs autograd of the sequential oracle: "
                  + ", ".join(f"{k} {rel(g, w):.3e}"
                              for k, g, w in zip(NAMES, got, want)))


if __name__ == "__main__":
    main()
