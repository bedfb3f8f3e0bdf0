// Matérn-5/2 Gram and cross-Gram kernel for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel
//   src/repro/kernels/gp_gram/kernel.py::matern52_gram_fwd
// and the padding done by its wrappers ops.py::matern52_gram / ::matern52_cross.
//
//   out[i, j] = sv * (1 + s + s*s/3) * exp(-s),   s = sqrt(5) * r,
//   r^2 = max(|a_i|^2 + |b_j|^2 - 2 a_i.b_j, 0),  r = 0 where r^2 <= 1e-12,
//   a = xa / ls,  b = xb / ls   (ls: ARD lengthscale [d], sv: signal variance).
//
// Beyond kExpandedMaxD = 64 features r^2 is summed over direct differences,
// sum_k (a_ik - b_jk)^2, as the plain version (ref.py) sums it there: the
// expansion's float32 cancellation grows with the norms, and at the tuning
// daemon's 327 knobs and lengthscale 0.3 (norms ~1200) it lands a config's
// one-knob neighbours (the candidates' axis sweeps) up to ~4e-4 off in K.
// Up to 64 features the kernel keeps the reference's expansion, and with
// it the reference's rounding on the tuner's main path.  Both forms give
// exactly 0 between equal rows (the expansion sums a.a, b.b and a.b in the
// same order).
//
// What bounds it on an H100: the output. At the tuner's shapes (d <= 32 knobs,
// n*m up to a few 10^5 entries) the kernel reads (n + m) * d floats and writes
// n * m floats, so the bytes are ~4 n m at 3.35 TB/s: 0.2 us for the
// [2384, 64] candidate cross-Gram. That is far below the launch latency of a
// few microseconds, so at these sizes a launch costs what it costs.
//
// What the design does about it:
//   * one launch computes the whole matrix, scaling by 1/ls on load, so no
//     scaled or padded copies of the inputs are made before it (the TPU
//     wrapper padded rows to +-1e4; here the ragged edge is masked in-kernel);
//   * ls and sv are read from device memory, so the caller never syncs the
//     host to pass them;
//   * a 32 x 32 output tile per block of 256 threads (4 outputs a thread):
//     the [2384, 64] cross-Gram gives 150 blocks, about one per SM;
//   * writes are coalesced (a warp stores 32 neighbouring columns of a row);
//   * plain fp32 FMAs, no tensor cores: at d <= 32 the work is tiny, and
//     TF32 would not hold the |a|^2+|b|^2-2a.b cancellation near the
//     diagonal to 2e-4.
// Any d is accepted: the block walks d in chunks of 32 staged in shared memory.
//
// The backward of the Gram (matern52_gram_bwd_launch, below the forward)
// gives the GP's marginal-likelihood gradient in (ls, sv), so the fit's Adam
// loop runs on these kernels. The Pallas kernel defines no VJP, and the
// reference differentiates its jnp Matérn instead.

#include <cuda_runtime.h>

namespace {

constexpr int kTile = 32;        // output rows and columns per block
constexpr int kRowsPerThread = 4;
constexpr int kThreadsY = kTile / kRowsPerThread;   // 8
constexpr int kChunk = 32;       // d columns staged per pass
constexpr int kExpandedMaxD = 64;   // widest d whose r^2 is expanded

template <bool kDirect>
__global__ void __launch_bounds__(kTile * kThreadsY)
matern52_kernel(const float* __restrict__ xa, const float* __restrict__ xb,
                const float* __restrict__ ls, const float* __restrict__ sv,
                float* __restrict__ out, int n, int m, int d) {
  // +1 column of padding: thread tx reads row tx of sb, conflict-free
  __shared__ float sa[kTile][kChunk + 1];
  __shared__ float sb[kTile][kChunk + 1];

  const int tx = threadIdx.x;             // output column within the tile
  const int ty = threadIdx.y;             // first output row within the tile
  const int tid = ty * kTile + tx;
  const int row0 = blockIdx.y * kTile;
  const int col0 = blockIdx.x * kTile;

  // a.b, or with kDirect the sum of squared differences
  float dot[kRowsPerThread] = {0.f, 0.f, 0.f, 0.f};
  float a2[kRowsPerThread] = {0.f, 0.f, 0.f, 0.f};
  float b2 = 0.f;

  for (int k0 = 0; k0 < d; k0 += kChunk) {
    // stage both tiles, scaled by 1/ls; out-of-range entries are zero
    for (int idx = tid; idx < kTile * kChunk; idx += kTile * kThreadsY) {
      const int r = idx / kChunk;
      const int c = idx % kChunk;
      const int k = k0 + c;
      float va = 0.f, vb = 0.f;
      if (k < d) {
        const float inv = 1.0f / ls[k];
        if (row0 + r < n) va = xa[(size_t)(row0 + r) * d + k] * inv;
        if (col0 + r < m) vb = xb[(size_t)(col0 + r) * d + k] * inv;
      }
      sa[r][c] = va;
      sb[r][c] = vb;
    }
    __syncthreads();
    const int kn = min(kChunk, d - k0);
    for (int c = 0; c < kn; ++c) {
      const float bv = sb[tx][c];
      if (!kDirect) b2 = fmaf(bv, bv, b2);
#pragma unroll
      for (int i = 0; i < kRowsPerThread; ++i) {
        const float av = sa[ty + i * kThreadsY][c];
        if (kDirect) {
          const float diff = av - bv;
          dot[i] = fmaf(diff, diff, dot[i]);
        } else {
          dot[i] = fmaf(av, bv, dot[i]);
          a2[i] = fmaf(av, av, a2[i]);
        }
      }
    }
    __syncthreads();
  }

  const int col = col0 + tx;
  if (col >= m) return;
  const float s_var = *sv;
  const float sqrt5 = 2.2360679774997896f;
#pragma unroll
  for (int i = 0; i < kRowsPerThread; ++i) {
    const int row = row0 + ty + i * kThreadsY;
    if (row >= n) continue;
    const float d2 =
        kDirect ? dot[i] : fmaxf(a2[i] + b2 - 2.0f * dot[i], 0.0f);
    const float r = d2 > 1e-12f ? sqrtf(d2) : 0.0f;
    const float s = sqrt5 * r;
    out[(size_t)row * m + col] = s_var * (1.0f + s + s * s / 3.0f) * expf(-s);
  }
}

}  // namespace

// xa [n, d], xb [m, d], ls [d], sv [1], out [n, m]: float32, contiguous, on
// the device. Launches on `stream` and returns cudaGetLastError().
extern "C" int matern52_launch(const float* xa, const float* xb,
                               const float* ls, const float* sv, float* out,
                               int n, int m, int d, cudaStream_t stream) {
  const dim3 block(kTile, kThreadsY);
  const dim3 grid((m + kTile - 1) / kTile, (n + kTile - 1) / kTile);
  if (d > kExpandedMaxD)
    matern52_kernel<true><<<grid, block, 0, stream>>>(xa, xb, ls, sv, out,
                                                      n, m, d);
  else
    matern52_kernel<false><<<grid, block, 0, stream>>>(xa, xb, ls, sv, out,
                                                       n, m, d);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// Backward of the Gram. Given G = dL/dK [n, n] (not assumed symmetric):
//
//   dL/dls_k = sum_ij w_ij (x_ik - x_jk)^2 / ls_k^3,
//   w_ij     = G_ij (5/3) sv exp(-s) (1 + s)  where r^2 > 1e-12, else 0,
//   dL/dsv   = sum_ij G_ij (1 + s + s^2/3) exp(-s),
//
// with r^2 and s computed exactly as the forward computes them (expanded up
// to kExpandedMaxD features, from direct differences beyond; the plain
// version's double-where zeroes the gradient where r^2 <= 1e-12). The
// feature sums take the differences directly.
//
// What bounds it on an H100: at the fit's shape (n = 64, d = 16) it reads
// 4 KB of x and 16 KB of G (~6 ns at the HBM rate) and does ~0.4 MFLOP (~6 ns
// at the fp32 peak), so latency decides: the launch, each round trip to
// device memory, each barrier. What the design does about it:
//   * at n <= 64 the whole sum is one block's work and one launch; larger n
//     takes one block per 64-row tile of i, each walking the 64-column tiles
//     of j, and a second one-block pass over the tiles' partials;
//   * one round trip to memory per tile: each thread loads its G entries
//     into registers before x is staged, and ls is staged once per block;
//   * 512 threads (16 warps) to hide the latency of shared-memory reads and
//     of the dependent FMA chains; each owns 8 fixed (i, j) pairs of a tile
//     and keeps kC + 1 partial sums (a chunk of kC features, and sv);
//   * x is staged transposed in shared memory, kC features at a time; r^2
//     needs every chunk before w is known, so with d > kC the chunks are
//     staged again for the feature sums (any d is accepted);
//   * deterministic, with no atomics: the feature partials are reduce-
//     scattered across each warp's lanes by shuffles, then summed over the
//     warps through shared memory, then over the row tiles, each in a fixed
//     order. Two calls on the same inputs give the same bits, which the
//     fit's CUDA graph relies on to equal the same steps run eagerly;
//   * plain fp32 FMAs, no tensor cores: the sums run over n^2 pairs of d
//     values each, and TF32 has no place here.

namespace {

constexpr int kBwdRows = 64;      // i rows per block
constexpr int kBwdCols = 64;      // j columns per tile
constexpr int kBwdThreads = 512;
constexpr int kBwdWarps = kBwdThreads / 32;
constexpr int kBwdPairs = kBwdRows * kBwdCols / kBwdThreads;   // per thread
constexpr int kBwdRowStep = kBwdThreads / kBwdCols;

// Stage features [k0, k0 + kC) of this block's rows and of the columns
// [c0, c0 + kBwdCols), transposed, and 1/ls of the chunk; zeros outside.
template <int kC>
__device__ __forceinline__ void bwd_stage(
    const float* __restrict__ x, const float* ls_s,
    float (*xr)[kBwdRows + 1], float (*xc)[kBwdCols + 1], float* inv_s,
    int row0, int c0, int k0, int n, int d, int tid) {
  for (int idx = tid; idx < kBwdRows * kC; idx += kBwdThreads) {
    const int r = idx / kC;
    const int c = idx % kC;
    const int k = k0 + c;
    float vr = 0.f, vc = 0.f;
    if (k < d) {
      if (row0 + r < n) vr = x[(size_t)(row0 + r) * d + k];
      if (c0 + r < n) vc = x[(size_t)(c0 + r) * d + k];
    }
    xr[c][r] = vr;
    xc[c][r] = vc;
  }
  if (tid < kC) inv_s[tid] = k0 + tid < d ? 1.0f / ls_s[k0 + tid] : 0.f;
}

template <int kC, bool kDirect>
__global__ void __launch_bounds__(kBwdThreads)
matern52_gram_bwd_kernel(const float* __restrict__ x,
                         const float* __restrict__ ls,
                         const float* __restrict__ sv,
                         const float* __restrict__ g,
                         float* __restrict__ partial,
                         float* __restrict__ out, int n, int d) {
  // +1 column of padding: the transposed stores are conflict-free
  __shared__ float xr[kC][kBwdRows + 1];
  __shared__ float xc[kC][kBwdCols + 1];
  __shared__ float inv_s[kC];
  __shared__ float red[kBwdWarps][kC];
  __shared__ float red_sv[kBwdWarps];
  extern __shared__ float dyn[];
  float* tot = dyn;                       // [d + 1]: this block's sums
  float* ls_s = dyn + d + 1;              // [d]

  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int warp = tid / 32;
  const int j = tid % kBwdCols;           // this thread's column of a tile
  const int i0 = tid / kBwdCols;          // its rows: i0 + kBwdRowStep * t
  const int row0 = blockIdx.x * kBwdRows;
  const float s_var = *sv;
  const float sqrt5 = 2.2360679774997896f;
  const float five_thirds = 5.0f / 3.0f;

  for (int k = tid; k <= d; k += kBwdThreads) {
    tot[k] = 0.f;
    if (k < d) ls_s[k] = ls[k];
  }
  float acc_sv = 0.f;

  for (int c0 = 0; c0 < n; c0 += kBwdCols) {
    // this thread's G entries, loaded before x is staged
    const int col = c0 + j;
    float gv[kBwdPairs];
#pragma unroll
    for (int t = 0; t < kBwdPairs; ++t) {
      const int row = row0 + i0 + kBwdRowStep * t;
      gv[t] = (row < n && col < n) ? g[(size_t)row * n + col] : 0.f;
    }

    // r^2 of this thread's pairs, in the forward's order of operations
    float dot[kBwdPairs], a2[kBwdPairs];
#pragma unroll
    for (int t = 0; t < kBwdPairs; ++t) dot[t] = a2[t] = 0.f;
    float b2 = 0.f;
    for (int k0 = 0; k0 < d; k0 += kC) {
      __syncthreads();                    // ls_s; the previous readers
      bwd_stage<kC>(x, ls_s, xr, xc, inv_s, row0, c0, k0, n, d, tid);
      __syncthreads();
#pragma unroll
      for (int c = 0; c < kC; ++c) {
        const float inv = inv_s[c];
        if (kDirect) {
          // the scaled values rounded before the subtract, as the forward
          // stages them: no contraction into an FMA
          const float bv = __fmul_rn(xc[c][j], inv);
#pragma unroll
          for (int t = 0; t < kBwdPairs; ++t) {
            const float diff =
                __fmul_rn(xr[c][i0 + kBwdRowStep * t], inv) - bv;
            dot[t] = fmaf(diff, diff, dot[t]);
          }
        } else {
          const float bv = xc[c][j] * inv;
          b2 = fmaf(bv, bv, b2);
#pragma unroll
          for (int t = 0; t < kBwdPairs; ++t) {
            const float av = xr[c][i0 + kBwdRowStep * t] * inv;
            dot[t] = fmaf(av, bv, dot[t]);
            a2[t] = fmaf(av, av, a2[t]);
          }
        }
      }
    }

    // the pairs' weights, and the sv sum
    float w[kBwdPairs];
#pragma unroll
    for (int t = 0; t < kBwdPairs; ++t) {
      const float d2 =
          kDirect ? dot[t] : fmaxf(a2[t] + b2 - 2.0f * dot[t], 0.0f);
      const bool pos = d2 > 1e-12f;
      const float s = sqrt5 * (pos ? sqrtf(d2) : 0.0f);
      const float e = expf(-s);
      acc_sv = fmaf(gv[t], (1.0f + s + s * s / 3.0f) * e, acc_sv);
      w[t] = pos ? gv[t] * five_thirds * s_var * e * (1.0f + s) : 0.0f;
    }

    // the feature sums, kC features at a time
    for (int k0 = 0; k0 < d; k0 += kC) {
      if (d > kC) {                       // one chunk: still staged
        __syncthreads();
        bwd_stage<kC>(x, ls_s, xr, xc, inv_s, row0, c0, k0, n, d, tid);
        __syncthreads();
      }
      float v[kC];
#pragma unroll
      for (int c = 0; c < kC; ++c) {
        const float xj = xc[c][j];
        float acc = 0.f;
#pragma unroll
        for (int t = 0; t < kBwdPairs; ++t) {
          const float diff = xr[c][i0 + kBwdRowStep * t] - xj;
          acc = fmaf(w[t] * diff, diff, acc);
        }
        v[c] = acc;
      }
      // reduce-scatter over the warp: lane L ends with feature L's sum
#pragma unroll
      for (int off = kC / 2; off >= 1; off /= 2) {
        const bool upper = (lane & off) != 0;
#pragma unroll
        for (int q = 0; q < off; ++q) {
          const float send = upper ? v[q] : v[q + off];
          const float keep = upper ? v[q + off] : v[q];
          v[q] = keep + __shfl_xor_sync(0xffffffffu, send, off);
        }
      }
#pragma unroll
      for (int off = kC; off < 32; off *= 2)
        v[0] += __shfl_xor_sync(0xffffffffu, v[0], off);
      if (lane < kC) red[warp][lane] = v[0];
      __syncthreads();
      if (tid < kC && k0 + tid < d) {
        float s = tot[k0 + tid];
#pragma unroll
        for (int q = 0; q < kBwdWarps; ++q) s += red[q][tid];
        tot[k0 + tid] = s;
      }
      __syncthreads();                    // red is reused
    }
  }

#pragma unroll
  for (int off = 16; off >= 1; off /= 2)
    acc_sv += __shfl_xor_sync(0xffffffffu, acc_sv, off);
  if (lane == 0) red_sv[warp] = acc_sv;
  __syncthreads();
  if (tid == 0) {
    float s = 0.f;
#pragma unroll
    for (int q = 0; q < kBwdWarps; ++q) s += red_sv[q];
    tot[d] = s;
  }
  __syncthreads();

  if (gridDim.x == 1) {                   // the whole sum: the result
    for (int k = tid; k < d; k += kBwdThreads) {
      const float l = ls_s[k];
      out[k] = tot[k] / (l * l * l);
    }
    if (tid == 0) out[d] = tot[d];
  } else {
    for (int k = tid; k <= d; k += kBwdThreads)
      partial[(size_t)blockIdx.x * (d + 1) + k] = tot[k];
  }
}

// The row tiles' partial sums [tiles, d + 1], added in tile order.
__global__ void __launch_bounds__(kBwdThreads)
matern52_gram_bwd_reduce_kernel(const float* __restrict__ partial,
                                const float* __restrict__ ls,
                                float* __restrict__ out, int tiles, int d) {
  for (int k = threadIdx.x; k <= d; k += kBwdThreads) {
    float s = 0.f;
    for (int t = 0; t < tiles; ++t) s += partial[(size_t)t * (d + 1) + k];
    if (k < d) {
      const float l = ls[k];
      s /= l * l * l;
    }
    out[k] = s;
  }
}

template <int kC, bool kDirect>
int bwd_launch(const float* x, const float* ls, const float* sv,
               const float* g, float* partial, float* out, int n, int d,
               cudaStream_t stream) {
  const int tiles = (n + kBwdRows - 1) / kBwdRows;
  const size_t smem = sizeof(float) * (size_t)(2 * d + 1);
  if (smem > 48 * 1024) {                 // beyond ~6k features
    const cudaError_t e = cudaFuncSetAttribute(
        matern52_gram_bwd_kernel<kC, kDirect>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  matern52_gram_bwd_kernel<kC, kDirect><<<tiles, kBwdThreads, smem,
                                          stream>>>(
      x, ls, sv, g, partial, out, n, d);
  if (tiles > 1) {
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return static_cast<int>(e);
    matern52_gram_bwd_reduce_kernel<<<1, kBwdThreads, 0, stream>>>(
        partial, ls, out, tiles, d);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x [n, d], ls [d], sv [1], g [n, n]: float32, contiguous, on the device;
// out [d + 1] receives (dL/dls, dL/dsv); partial [ceil(n / 64), d + 1] is
// scratch, read only when n > 64 (it may be null otherwise). Launches on
// `stream` (one kernel for n <= 64, two above) and returns
// cudaGetLastError(). d <= 16 takes 16-feature chunks, wider d 32; beyond
// kExpandedMaxD, r^2 from direct differences.
extern "C" int matern52_gram_bwd_launch(const float* x, const float* ls,
                                        const float* sv, const float* g,
                                        float* partial, float* out, int n,
                                        int d, cudaStream_t stream) {
  if (d <= 16)
    return bwd_launch<16, false>(x, ls, sv, g, partial, out, n, d, stream);
  if (d <= kExpandedMaxD)
    return bwd_launch<32, false>(x, ls, sv, g, partial, out, n, d, stream);
  return bwd_launch<32, true>(x, ls, sv, g, partial, out, n, d, stream);
}
