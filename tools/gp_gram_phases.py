#!/usr/bin/env python3
"""Where the time of the Matérn-5/2 Gram's kernels goes at the tuning
daemon's width, phase by phase, on the card: the forward's burst pass and
the wide backward of ``gp_gram.cu`` with ``clock64`` stamps at their phase
boundaries.

    python3 tools/gp_gram_phases.py     # from the root of a checkout, one GPU

A copy of the kernel's source gets, through text substitutions that must
match it once each (else the tool exits), a stamp of each block's thread 0
at each boundary, kept in a device array and read back through an extra
exported function; it is built as its own library under
``build/gp_gram_phases/``.  After 20 warm-up launches of each shape the
stamps of one launch are printed for the first blocks: the SM the block ran
on, its SM clock (its ``clock64`` ticks over its ``%globaltimer`` ns
from the first stamp to the last), the time of each phase in us at that
clock, and the block's end against the earliest block's start.

Forward (the burst kernel: the default launch, one stage, d > 64, a
small grid; a block's last pass): setup (1/ls), the two bulk copies, the
re-layout into padded rows, the sums, the epilogue.
Backward (n x n pairs, d > 64; a block's last tile): setup, the bulk
copies, the re-layout, the scaling, r^2 and the weights, the feature
sums, their sum over the block's row groups and the sv sum, the first
cluster barrier, the cluster's reduction, the last barrier.

Prints the card's name and power limit first; exits non-zero without a
GPU.  Imports nothing of JAX.
"""

from __future__ import annotations

import ctypes
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
FWD_SHAPES = ((64, 64, 327), (128, 128, 327))
BWD_SHAPES = ((64, 327), (128, 327))
BLOCKS_SHOWN = 4

HDR = r'''
__device__ unsigned long long g_clk[64][12];
__device__ unsigned long long g_gt[64][12];
__device__ __forceinline__ unsigned long long phase_globaltimer() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}
__device__ __forceinline__ unsigned phase_smid() {
  unsigned s;
  asm volatile("mov.u32 %0, %%smid;" : "=r"(s));
  return s;
}
#define STAMP(i) do { \
  const int _b = (blockIdx.z * gridDim.y + blockIdx.y) * gridDim.x + blockIdx.x; \
  if (threadIdx.x == 0 && _b < 64) { \
    g_clk[_b][i] = clock64(); g_gt[_b][i] = phase_globaltimer(); \
    if ((i) == 0) g_clk[_b][11] = phase_smid(); } } while (0)
extern "C" int gp_gram_phases(unsigned long long* clk, unsigned long long* gt) {
  cudaError_t e = cudaMemcpyFromSymbol(clk, g_clk, sizeof(g_clk));
  if (e != cudaSuccess) return e;
  return cudaMemcpyFromSymbol(gt, g_gt, sizeof(g_gt));
}
'''

# (text in the source, what replaces it): stamps 0-5 of the forward, 0-10
# of the wide backward
SUBS = [
    ("#include <cuda_runtime.h>\n", "#include <cuda_runtime.h>\n" + HDR),
    ("  const int dp = burst_dp(d), ld = burst_ld(d);\n",
     "  STAMP(0);\n  const int dp = burst_dp(d), ld = burst_ld(d);\n"),
    ("    // the block's rows of xa and the tile's rows of xb, each "
     "contiguous\n",
     "    STAMP(1);\n    // the block's rows of xa and the tile's rows of "
     "xb, each contiguous\n"),
    ("flat_b, bar, pass & 1);\n", "flat_b, bar, pass & 1);\n    STAMP(2);\n"),
    ("              make_float4(v.x * iv.x, v.y * iv.y, v.z * iv.z, "
     "v.w * iv.w);\n        });\n    __syncthreads();\n\n",
     "              make_float4(v.x * iv.x, v.y * iv.y, v.z * iv.z, "
     "v.w * iv.w);\n        });\n    __syncthreads();\n    STAMP(3);\n\n"),
    ("\n#pragma unroll\n    for (int i = 0; i < kRP; ++i) {\n"
     "      if (i >= nrp) break;\n      const int row",
     "\n    STAMP(4);\n#pragma unroll\n    for (int i = 0; i < kRP; ++i) {\n"
     "      if (i >= nrp) break;\n      const int row"),
    ("        const float d2 = dot[i][j];\n"
     "        const float r = d2 > 1e-12f ? sqrtf(d2) : 0.0f;\n"
     "        const float s = sqrt5 * r;\n"
     "        out[(size_t)row * m + col] =\n"
     "            s_var * (1.0f + s + s * s / 3.0f) * expf(-s);\n"
     "      }\n    }\n  }\n}\n",
     "        const float d2 = dot[i][j];\n"
     "        const float r = d2 > 1e-12f ? sqrtf(d2) : 0.0f;\n"
     "        const float s = sqrt5 * r;\n"
     "        out[(size_t)row * m + col] =\n"
     "            s_var * (1.0f + s + s * s / 3.0f) * expf(-s);\n"
     "      }\n    }\n  }\n  STAMP(5);\n}\n"),
    ("  const float five_thirds = 5.0f / 3.0f;\n\n  if (tid == 0) {\n"
     "    hopper::mbar_init(bar, 1);",
     "  const float five_thirds = 5.0f / 3.0f;\n  STAMP(0);\n\n"
     "  if (tid == 0) {\n    hopper::mbar_init(bar, 1);"),
    ("  __syncthreads();                        // inv, ls_s, tot\n",
     "  __syncthreads();                        // inv, ls_s, tot\n"
     "  STAMP(1);\n"),
    ("nj * d, flat_j, bar, parity);\n",
     "nj * d, flat_j, bar, parity);\n    STAMP(2);\n"),
    ("            reinterpret_cast<float4*>(raw + r * L.ld)[q] = v;\n"
     "          });\n    }\n    __syncthreads();\n",
     "            reinterpret_cast<float4*>(raw + r * L.ld)[q] = v;\n"
     "          });\n    }\n    __syncthreads();\n    STAMP(3);\n"),
    ("          make_float4(v.x * iv.x, v.y * iv.y, v.z * iv.z, v.w * iv.w);"
     "\n    }\n    __syncthreads();\n",
     "          make_float4(v.x * iv.x, v.y * iv.y, v.z * iv.z, v.w * iv.w);"
     "\n    }\n    __syncthreads();\n    STAMP(4);\n"),
    ("          pos ? gv[p] * five_thirds * s_var * e * (1.0f + s) : 0.0f;\n"
     "    }\n    __syncthreads();\n",
     "          pos ? gv[p] * five_thirds * s_var * e * (1.0f + s) : 0.0f;\n"
     "    }\n    __syncthreads();\n    STAMP(5);\n"),
    ("      reinterpret_cast<float4*>(part + ig * L.dp)[q] = acc;\n    }\n"
     "    __syncthreads();\n",
     "      reinterpret_cast<float4*>(part + ig * L.dp)[q] = acc;\n    }\n"
     "    __syncthreads();\n    STAMP(6);\n"),
    ("    for (int q = 0; q < kWideWarps; ++q) s += red[q];\n"
     "    tot[d] = s;\n  }\n",
     "    for (int q = 0; q < kWideWarps; ++q) s += red[q];\n"
     "    tot[d] = s;\n  }\n  STAMP(7);\n"),
    ("  cluster.sync();\n  const int rank",
     "  cluster.sync();\n  STAMP(8);\n  const int rank"),
    ("  cluster.sync();                         // no block leaves while "
     "read\n",
     "  STAMP(9);\n  cluster.sync();\n  STAMP(10);\n"),
]
FWD_PHASES = ("setup", "bulk copies", "re-layout", "sums", "epilogue")
BWD_PHASES = ("setup", "bulk copies", "re-layout", "scaling", "r^2, w",
              "feature sums", "block sums, sv sum", "cluster barrier",
              "cluster sums", "last barrier")


def main() -> None:
    import torch
    if not torch.cuda.is_available():
        sys.exit("torch.cuda.is_available() is false: this needs a GPU")
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels.build import BUILD_ROOT, NvccLibrary
    from repro_torch.kernels.gp_gram import ops

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    text = ops.SOURCE.read_text()
    for old, new in SUBS:
        if text.count(old) != 1:
            sys.exit(f"{old!r} is not in the source once")
        text = text.replace(old, new)
    csrc = BUILD_ROOT / "gp_gram_phases" / "csrc"
    csrc.mkdir(parents=True, exist_ok=True)
    (csrc / ops.SOURCE.name).write_text(text)
    lib = NvccLibrary("gp_gram_phases", csrc / ops.SOURCE.name,
                      ops._LIB.functions).load()
    dev = torch.device("cuda")
    stream = torch.cuda.current_stream().cuda_stream
    clk = (ctypes.c_ulonglong * (64 * 12))()
    gt = (ctypes.c_ulonglong * (64 * 12))()
    gen = torch.Generator(device=dev).manual_seed(0)

    def show(label, names, launch):
        for _ in range(20):
            launch()
        torch.cuda.synchronize()
        if lib.gp_gram_phases(clk, gt) != 0:
            sys.exit("reading the stamps failed")
        t0 = min(gt[b * 12] for b in range(BLOCKS_SHOWN))
        for b in range(BLOCKS_SHOWN):
            c = [clk[b * 12 + i] for i in range(len(names) + 1)]
            g = (gt[b * 12], gt[b * 12 + len(names)])
            mhz = (c[-1] - c[0]) / max(g[1] - g[0], 1) * 1e3
            print(f"{label} block {b} (SM {clk[b * 12 + 11]}, {mhz:.0f} "
                  "MHz): " + ", ".join(
                      f"{name} {(c[i + 1] - c[i]) / mhz:.2f}"
                      for i, name in enumerate(names))
                  + f" us; ends {(g[1] - t0) / 1e3:.2f} us after the first "
                  "block's start", flush=True)

    for n, m, d in FWD_SHAPES:
        xa = torch.rand((n, d), generator=gen, device=dev)
        xb = xa[:m].clone() if n == m else torch.rand((m, d), generator=gen,
                                                      device=dev)
        ls = torch.full((d,), 0.3, device=dev)
        sv = torch.ones(1, device=dev)
        out = torch.empty((n, m), device=dev)
        show(f"forward [{n},{d}]x[{m},{d}]", FWD_PHASES,
             lambda: lib.matern52_launch(
                 xa.data_ptr(), xb.data_ptr(), ls.data_ptr(), sv.data_ptr(),
                 out.data_ptr(), n, m, d, *ops.DEFAULT_TILES, stream))
    for n, d in BWD_SHAPES:
        x = torch.rand((n, d), generator=gen, device=dev)
        ls = 0.1 + 0.9 * torch.rand((d,), generator=gen, device=dev)
        sv = torch.full((1,), 1.7, device=dev)
        g = torch.randn((n, n), generator=gen, device=dev)
        out = torch.empty((d + 1,), device=dev)
        rows = ops.bwd_grid(n, d)[1]
        partial = torch.empty((max(rows, 1), d + 1), device=dev)
        show(f"backward [{n},{d}]", BWD_PHASES,
             lambda: lib.matern52_gram_bwd_launch(
                 x.data_ptr(), ls.data_ptr(), sv.data_ptr(), g.data_ptr(),
                 partial.data_ptr(), out.data_ptr(), n, d, stream))


if __name__ == "__main__":
    main()
