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

#include <cuda_runtime.h>

namespace {

constexpr int kTile = 32;        // output rows and columns per block
constexpr int kRowsPerThread = 4;
constexpr int kThreadsY = kTile / kRowsPerThread;   // 8
constexpr int kChunk = 32;       // d columns staged per pass

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
      b2 = fmaf(bv, bv, b2);
#pragma unroll
      for (int i = 0; i < kRowsPerThread; ++i) {
        const float av = sa[ty + i * kThreadsY][c];
        dot[i] = fmaf(av, bv, dot[i]);
        a2[i] = fmaf(av, av, a2[i]);
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
    const float d2 = fmaxf(a2[i] + b2 - 2.0f * dot[i], 0.0f);
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
  matern52_kernel<<<grid, block, 0, stream>>>(xa, xb, ls, sv, out, n, m, d);
  return static_cast<int>(cudaGetLastError());
}
