// Flash-attention backward for Hopper (sm_90a): the gradients dq, dk, dv of
// the causal / sliding-window / tanh-soft-capped grouped-query attention of
// flash_attention.cu and flash_attention_wgmma.cu.
//
// The JAX package has no backward kernel: off TPU its flash dispatch runs
// the chunked jnp path, which XLA differentiates.  The forward this
// differentiates replaces the Pallas TPU kernel
//   src/repro/kernels/flash_attention/kernel.py::flash_attention_fwd.
//
// With raw_ij = q_i . k_j / sqrt(D), s_ij = cap(raw_ij), the row's
// log-sum-exp L_i (written by the forward) and the visible mask:
//   P_ij  = exp(s_ij - L_i) where visible, else 0
//   D_i   = sum_d dO_id O_id                          (pre-pass)
//   dV_j  = sum_i P_ij dO_i                            (GQA: summed over the
//   dS_ij = P_ij (dO_i . v_j - D_i)                     q heads of k's group)
//   dR_ij = dS_ij (1 - (s_ij / cap)^2) with a soft-cap, else dS_ij
//   dQ_i  = sum_j dR_ij k_j / sqrt(D),  dK_j = sum_i dR_ij q_i / sqrt(D).
// P is recomputed in float32 from L: on the bf16 tensor-core route, whose
// forward rounds P to bf16 before P.V, this is the straight-through
// gradient of that rounding.  A row with nothing visible has P = 0, so it
// gets zero gradient (its forward output is zeros).
//
// What bounds it on an H100: operations.  At yi-6b's layer shape (B=2,
// S=4096, H=32, Kh=4, D=128, causal, bf16) the five products over the
// visible half (QK^T again, dO.V^T, P^T.dO, dS^T.Q, dS.K) are 687 GFLOP
// against ~300 MB of inputs and outputs.  This first kernel does them as
// fp32 FMAs on the CUDA cores, like the forward's FMA route; wgmma is the
// later step.
//
// Three launches, deterministic (no atomics):
//   1. flash_bwd_dot_kernel: D_i, one warp per (b, i, h) row;
//   2. flash_bwd_dkdv_kernel: one block per (KV tile of BK keys, b * Kh + kh).
//      K and V stay in shared memory; the block loops over the q heads of
//      its group and, for each, over the q tiles that can see its keys
//      (causal / window bounds), accumulating dK and dV in registers;
//   3. flash_bwd_dq_kernel: one block per (q tile, b * H + h), looping over
//      the KV tiles its rows can see (the forward's bounds), dQ in
//      registers; the heaviest q tiles are scheduled first.
// Tiles: each thread owns a 4 x BK/16 block of a score tile (rows
// ty + TY i, columns tx + 16 j, as the FMA forward) and rows ty + TY i,
// columns tx + 16 c of its [rows, D] accumulators; Q, dO, K and V tiles sit
// in shared memory in float32 with one float of row padding, and the P / dS
// tile shares one buffer.  Inputs are read in place through their strides
// ([B, S, heads, D], unit stride along D); the ragged Sq / Sk edges are
// masked here.  Head dims 16, 32, 64 and 128 use 64 x 64 tiles with 8 warps,
// 256 a 32 x 32 tile with 4 warps; float32 and bfloat16.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kSmemLimit = 232448; // a block's shared-memory limit on sm_90

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ __nv_bfloat16
from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

struct Strides {
  long long b, s, h;               // in elements; the head-dim stride is 1
};

struct Params {
  const void* q;
  const void* k;
  const void* v;
  const void* o;
  const void* dout;
  const float* lse;                // [B, H, Sq]
  float* di;                       // [B, H, Sq], written by the pre-pass
  void* dq;
  void* dk;
  void* dv;
  Strides qs, ks, vs, os, dos, dqs, dks, dvs;
  int B, H, Kh, Sq, Sk;
  int causal;
  int window;                      // <= 0: no window
  float softcap;                   // <= 0: no soft-cap
  float scale;                     // 1 / sqrt(D)
};

// BQ q rows and BK keys per tile, 32 NW threads: 16 along the score
// columns (and the accumulators' D columns), TY along the rows
template <int D, int BQ, int BK, int NW>
struct Tile {
  static constexpr int kThreads = 32 * NW;
  static constexpr int kTY = kThreads / 16;
  static constexpr int kRowsQ = BQ / kTY;  // score rows per thread
  static constexpr int kRowsK = BK / kTY;  // dK / dV rows per thread
  static constexpr int kCols = BK / 16;    // score columns per thread
  static constexpr int kOC = D / 16;       // accumulator columns per thread
  static constexpr int kPad = D + 1;
  static constexpr int kPP = BK + 1;
  // Q, dO, K, V tiles, the P / dS tile, the rows' L and D
  static constexpr int kFloats =
      2 * BQ * kPad + 2 * BK * kPad + BQ * kPP + 2 * BQ;
  static constexpr int kBytes = kFloats * (int)sizeof(float);
  static_assert(BQ % kTY == 0 && BK % kTY == 0 && BK % 16 == 0 &&
                D % 16 == 0, "tile");
};

__device__ __forceinline__ bool visible(const Params& p, int row, int key) {
  bool ok = row < p.Sq && key < p.Sk;
  if (p.causal) ok = ok && key <= row;
  if (p.window > 0) ok = ok && key > row - p.window;
  return ok;
}

// rows [r0, r0 + R) of a [B, S, heads, D] tensor's head into a padded
// float32 tile; rows at or past `n` are zeros
template <typename T, int R, int D, int NT>
__device__ __forceinline__ void load_tile(float* dst, const T* src,
                                          long long row_stride, int r0,
                                          int n) {
  for (int idx = threadIdx.x; idx < R * D; idx += NT) {
    const int r = idx / D;
    const int c = idx - r * D;
    const int row = r0 + r;
    dst[r * (D + 1) + c] =
        row < n ? to_f32(src[(long long)row * row_stride + c]) : 0.f;
  }
}

// s = Q K^T and dp = dO V^T over this thread's rows and columns
template <int D, int BQ, int BK, int NW>
__device__ __forceinline__ void scores(
    float (&s)[Tile<D, BQ, BK, NW>::kRowsQ][Tile<D, BQ, BK, NW>::kCols],
    float (&dp)[Tile<D, BQ, BK, NW>::kRowsQ][Tile<D, BQ, BK, NW>::kCols],
    const float* sQ, const float* sdO, const float* sK, const float* sV,
    int tx, int ty) {
  using L = Tile<D, BQ, BK, NW>;
#pragma unroll
  for (int i = 0; i < L::kRowsQ; ++i)
#pragma unroll
    for (int j = 0; j < L::kCols; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
  for (int d = 0; d < D; ++d) {
    float a[L::kRowsQ], g[L::kRowsQ], kk[L::kCols], vv[L::kCols];
#pragma unroll
    for (int i = 0; i < L::kRowsQ; ++i) {
      a[i] = sQ[(ty + L::kTY * i) * L::kPad + d];
      g[i] = sdO[(ty + L::kTY * i) * L::kPad + d];
    }
#pragma unroll
    for (int j = 0; j < L::kCols; ++j) {
      kk[j] = sK[(tx + 16 * j) * L::kPad + d];
      vv[j] = sV[(tx + 16 * j) * L::kPad + d];
    }
#pragma unroll
    for (int i = 0; i < L::kRowsQ; ++i)
#pragma unroll
      for (int j = 0; j < L::kCols; ++j) {
        s[i][j] = fmaf(a[i], kk[j], s[i][j]);
        dp[i][j] = fmaf(g[i], vv[j], dp[i][j]);
      }
  }
}

// s (raw products) -> P, dp -> dR (the gradient at the raw score)
template <int D, int BQ, int BK, int NW>
__device__ __forceinline__ void probs_and_grads(
    float (&s)[Tile<D, BQ, BK, NW>::kRowsQ][Tile<D, BQ, BK, NW>::kCols],
    float (&dp)[Tile<D, BQ, BK, NW>::kRowsQ][Tile<D, BQ, BK, NW>::kCols],
    const Params& p, const float* sL, const float* sD, int q0, int k0,
    int tx, int ty) {
  using L = Tile<D, BQ, BK, NW>;
#pragma unroll
  for (int i = 0; i < L::kRowsQ; ++i) {
    const int r = ty + L::kTY * i;
    const int qi = q0 + r;
    const float lse = sL[r], di = sD[r];
#pragma unroll
    for (int j = 0; j < L::kCols; ++j) {
      const int kj = k0 + tx + 16 * j;
      float x = s[i][j] * p.scale;
      if (p.softcap > 0.f) x = p.softcap * tanhf(x / p.softcap);
      const float pij = visible(p, qi, kj) ? expf(x - lse) : 0.f;
      float ds = pij * (dp[i][j] - di);
      if (p.softcap > 0.f) {
        const float t = x / p.softcap;
        ds *= 1.f - t * t;
      }
      s[i][j] = pij;
      dp[i][j] = ds;
    }
  }
}

template <typename T, int D, int BQ, int BK, int NW>
__global__ void __launch_bounds__(32 * NW, 1)
flash_bwd_dkdv_kernel(const Params p) {
  using L = Tile<D, BQ, BK, NW>;
  extern __shared__ float smem[];
  float* sQ = smem;                          // [BQ][D + 1]
  float* sdO = sQ + BQ * L::kPad;            // [BQ][D + 1]
  float* sK = sdO + BQ * L::kPad;            // [BK][D + 1]
  float* sV = sK + BK * L::kPad;             // [BK][D + 1]
  float* sP = sV + BK * L::kPad;             // [BQ][BK + 1]: P, then dS
  float* sL = sP + BQ * L::kPP;              // [BQ]
  float* sD = sL + BQ;                       // [BQ]

  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  const int k0 = blockIdx.x * BK;
  const int b = blockIdx.y / p.Kh;
  const int kh = blockIdx.y - b * p.Kh;
  const int rep = p.H / p.Kh;

  load_tile<T, BK, D, L::kThreads>(
      sK, static_cast<const T*>(p.k) + b * p.ks.b + kh * p.ks.h, p.ks.s, k0,
      p.Sk);
  load_tile<T, BK, D, L::kThreads>(
      sV, static_cast<const T*>(p.v) + b * p.vs.b + kh * p.vs.h, p.vs.s, k0,
      p.Sk);

  // the q rows that can see any key of this tile
  const int q_lo = p.causal ? k0 : 0;
  const int q_hi = p.window > 0 ? min(p.Sq, k0 + BK - 1 + p.window) : p.Sq;
  const int t_lo = q_lo / BQ;
  const int t_hi = q_hi > q_lo ? (q_hi + BQ - 1) / BQ : t_lo;

  float dk[L::kRowsK][L::kOC], dv[L::kRowsK][L::kOC];
#pragma unroll
  for (int i = 0; i < L::kRowsK; ++i)
#pragma unroll
    for (int c = 0; c < L::kOC; ++c) dk[i][c] = dv[i][c] = 0.f;

  for (int hh = 0; hh < rep; ++hh) {
    const int h = kh * rep + hh;
    const T* qb = static_cast<const T*>(p.q) + b * p.qs.b + h * p.qs.h;
    const T* gb = static_cast<const T*>(p.dout) + b * p.dos.b + h * p.dos.h;
    const float* lb = p.lse + ((long long)b * p.H + h) * p.Sq;
    const float* db = p.di + ((long long)b * p.H + h) * p.Sq;
    for (int t = t_lo; t < t_hi; ++t) {
      const int q0 = t * BQ;
      __syncthreads();             // the last tile's reads are done
      load_tile<T, BQ, D, L::kThreads>(sQ, qb, p.qs.s, q0, p.Sq);
      load_tile<T, BQ, D, L::kThreads>(sdO, gb, p.dos.s, q0, p.Sq);
      for (int r = tid; r < BQ; r += L::kThreads) {
        const bool in = q0 + r < p.Sq;
        sL[r] = in ? lb[q0 + r] : 0.f;
        sD[r] = in ? db[q0 + r] : 0.f;
      }
      __syncthreads();

      float s[L::kRowsQ][L::kCols], dp[L::kRowsQ][L::kCols];
      scores<D, BQ, BK, NW>(s, dp, sQ, sdO, sK, sV, tx, ty);
      probs_and_grads<D, BQ, BK, NW>(s, dp, p, sL, sD, q0, k0, tx, ty);

#pragma unroll
      for (int i = 0; i < L::kRowsQ; ++i)
#pragma unroll
        for (int j = 0; j < L::kCols; ++j)
          sP[(ty + L::kTY * i) * L::kPP + tx + 16 * j] = s[i][j];
      __syncthreads();
      // dV += P^T dO
#pragma unroll 4
      for (int qq = 0; qq < BQ; ++qq) {
        float pv[L::kRowsK], g[L::kOC];
#pragma unroll
        for (int i = 0; i < L::kRowsK; ++i)
          pv[i] = sP[qq * L::kPP + ty + L::kTY * i];
#pragma unroll
        for (int c = 0; c < L::kOC; ++c) g[c] = sdO[qq * L::kPad + tx + 16 * c];
#pragma unroll
        for (int i = 0; i < L::kRowsK; ++i)
#pragma unroll
          for (int c = 0; c < L::kOC; ++c) dv[i][c] = fmaf(pv[i], g[c], dv[i][c]);
      }
      __syncthreads();             // every thread has read P: dS takes its place
#pragma unroll
      for (int i = 0; i < L::kRowsQ; ++i)
#pragma unroll
        for (int j = 0; j < L::kCols; ++j)
          sP[(ty + L::kTY * i) * L::kPP + tx + 16 * j] = dp[i][j];
      __syncthreads();
      // dK += dS^T Q
#pragma unroll 4
      for (int qq = 0; qq < BQ; ++qq) {
        float ds[L::kRowsK], a[L::kOC];
#pragma unroll
        for (int i = 0; i < L::kRowsK; ++i)
          ds[i] = sP[qq * L::kPP + ty + L::kTY * i];
#pragma unroll
        for (int c = 0; c < L::kOC; ++c) a[c] = sQ[qq * L::kPad + tx + 16 * c];
#pragma unroll
        for (int i = 0; i < L::kRowsK; ++i)
#pragma unroll
          for (int c = 0; c < L::kOC; ++c) dk[i][c] = fmaf(ds[i], a[c], dk[i][c]);
      }
    }
  }

  T* dkb = static_cast<T*>(p.dk) + b * p.dks.b + kh * p.dks.h;
  T* dvb = static_cast<T*>(p.dv) + b * p.dvs.b + kh * p.dvs.h;
#pragma unroll
  for (int i = 0; i < L::kRowsK; ++i) {
    const int key = k0 + ty + L::kTY * i;
    if (key >= p.Sk) continue;
#pragma unroll
    for (int c = 0; c < L::kOC; ++c) {
      dkb[key * p.dks.s + tx + 16 * c] = from_f32<T>(dk[i][c] * p.scale);
      dvb[key * p.dvs.s + tx + 16 * c] = from_f32<T>(dv[i][c]);
    }
  }
}

template <typename T, int D, int BQ, int BK, int NW>
__global__ void __launch_bounds__(32 * NW, 1)
flash_bwd_dq_kernel(const Params p) {
  using L = Tile<D, BQ, BK, NW>;
  extern __shared__ float smem[];
  float* sQ = smem;
  float* sdO = sQ + BQ * L::kPad;
  float* sK = sdO + BQ * L::kPad;
  float* sV = sK + BK * L::kPad;
  float* sP = sV + BK * L::kPad;             // dS
  float* sL = sP + BQ * L::kPP;
  float* sD = sL + BQ;

  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  const int b = blockIdx.y / p.H;
  const int h = blockIdx.y - b * p.H;
  const int kh = h / (p.H / p.Kh);
  const int q0 = (gridDim.x - 1 - blockIdx.x) * BQ;

  load_tile<T, BQ, D, L::kThreads>(
      sQ, static_cast<const T*>(p.q) + b * p.qs.b + h * p.qs.h, p.qs.s, q0,
      p.Sq);
  load_tile<T, BQ, D, L::kThreads>(
      sdO, static_cast<const T*>(p.dout) + b * p.dos.b + h * p.dos.h,
      p.dos.s, q0, p.Sq);
  const float* lb = p.lse + ((long long)b * p.H + h) * p.Sq;
  const float* db = p.di + ((long long)b * p.H + h) * p.Sq;
  for (int r = tid; r < BQ; r += L::kThreads) {
    const bool in = q0 + r < p.Sq;
    sL[r] = in ? lb[q0 + r] : 0.f;
    sD[r] = in ? db[q0 + r] : 0.f;
  }
  const T* kb = static_cast<const T*>(p.k) + b * p.ks.b + kh * p.ks.h;
  const T* vb = static_cast<const T*>(p.v) + b * p.vs.b + kh * p.vs.h;

  // the keys any row of this tile can see (the forward's bounds)
  int kv_end = p.Sk;
  if (p.causal) kv_end = min(kv_end, min(q0 + BQ, p.Sq));
  const int kv_begin = p.window > 0 ? max(0, q0 - p.window + 1) : 0;
  const int t_begin = kv_begin / BK;
  const int t_end = (kv_end + BK - 1) / BK;

  float dq[L::kRowsQ][L::kOC];
#pragma unroll
  for (int i = 0; i < L::kRowsQ; ++i)
#pragma unroll
    for (int c = 0; c < L::kOC; ++c) dq[i][c] = 0.f;

  for (int t = t_begin; t < t_end; ++t) {
    const int k0 = t * BK;
    __syncthreads();               // the last tile's dS and K reads are done
    load_tile<T, BK, D, L::kThreads>(sK, kb, p.ks.s, k0, p.Sk);
    load_tile<T, BK, D, L::kThreads>(sV, vb, p.vs.s, k0, p.Sk);
    __syncthreads();

    float s[L::kRowsQ][L::kCols], dp[L::kRowsQ][L::kCols];
    scores<D, BQ, BK, NW>(s, dp, sQ, sdO, sK, sV, tx, ty);
    probs_and_grads<D, BQ, BK, NW>(s, dp, p, sL, sD, q0, k0, tx, ty);
#pragma unroll
    for (int i = 0; i < L::kRowsQ; ++i)
#pragma unroll
      for (int j = 0; j < L::kCols; ++j)
        sP[(ty + L::kTY * i) * L::kPP + tx + 16 * j] = dp[i][j];
    __syncthreads();
    // dQ += dS K
#pragma unroll 4
    for (int kk = 0; kk < BK; ++kk) {
      float ds[L::kRowsQ], kv[L::kOC];
#pragma unroll
      for (int i = 0; i < L::kRowsQ; ++i)
        ds[i] = sP[(ty + L::kTY * i) * L::kPP + kk];
#pragma unroll
      for (int c = 0; c < L::kOC; ++c) kv[c] = sK[kk * L::kPad + tx + 16 * c];
#pragma unroll
      for (int i = 0; i < L::kRowsQ; ++i)
#pragma unroll
        for (int c = 0; c < L::kOC; ++c) dq[i][c] = fmaf(ds[i], kv[c], dq[i][c]);
    }
  }

  T* dqb = static_cast<T*>(p.dq) + b * p.dqs.b + h * p.dqs.h;
#pragma unroll
  for (int i = 0; i < L::kRowsQ; ++i) {
    const int qi = q0 + ty + L::kTY * i;
    if (qi >= p.Sq) continue;
#pragma unroll
    for (int c = 0; c < L::kOC; ++c)
      dqb[qi * p.dqs.s + tx + 16 * c] = from_f32<T>(dq[i][c] * p.scale);
  }
}

// D_i = dO_i . O_i, one warp per (b, i, h)
template <typename T>
__global__ void __launch_bounds__(256)
flash_bwd_dot_kernel(const Params p, int D) {
  const long long row = (long long)blockIdx.x * 8 + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  const long long rows = (long long)p.B * p.Sq * p.H;
  if (row >= rows) return;
  const int h = (int)(row % p.H);
  const int i = (int)((row / p.H) % p.Sq);
  const int b = (int)(row / ((long long)p.H * p.Sq));
  const T* ob = static_cast<const T*>(p.o) + b * p.os.b + i * p.os.s +
                h * p.os.h;
  const T* gb = static_cast<const T*>(p.dout) + b * p.dos.b +
                i * p.dos.s + h * p.dos.h;
  float acc = 0.f;
  for (int d = lane; d < D; d += 32) acc = fmaf(to_f32(gb[d]), to_f32(ob[d]), acc);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0) p.di[((long long)b * p.H + h) * p.Sq + i] = acc;
}

template <typename T, int D, int BQ, int BK, int NW>
cudaError_t launch(const Params& p, cudaStream_t stream) {
  using L = Tile<D, BQ, BK, NW>;
  constexpr int bytes = L::kBytes;
  static_assert(bytes <= kSmemLimit, "shared memory");
  const long long rows = (long long)p.B * p.Sq * p.H;
  flash_bwd_dot_kernel<T><<<(unsigned)((rows + 7) / 8), 256, 0, stream>>>(
      p, D);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  auto dkdv = flash_bwd_dkdv_kernel<T, D, BQ, BK, NW>;
  err = cudaFuncSetAttribute(
      dkdv, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  dkdv<<<dim3((p.Sk + BK - 1) / BK, p.B * p.Kh), L::kThreads, bytes,
         stream>>>(p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  auto dq = flash_bwd_dq_kernel<T, D, BQ, BK, NW>;
  err = cudaFuncSetAttribute(
      dq, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  dq<<<dim3((p.Sq + BQ - 1) / BQ, p.B * p.H), L::kThreads, bytes, stream>>>(
      p);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_dim(const Params& p, int d, cudaStream_t stream) {
  switch (d) {
    case 16: return launch<T, 16, 64, 64, 8>(p, stream);
    case 32: return launch<T, 32, 64, 64, 8>(p, stream);
    case 64: return launch<T, 64, 64, 64, 8>(p, stream);
    case 128: return launch<T, 128, 64, 64, 8>(p, stream);
    case 256: return launch<T, 256, 32, 32, 4>(p, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// q/o/dout/dq [B, Sq, H, D], k/v/dk/dv [B, Sk, Kh, D] on the device, with
// element strides {b, s, h} of q, k, v, o, dout, dq, dk, dv (in that order,
// 24 values in host memory) and unit stride along D; lse (the forward's
// per-row log-sum-exp) and di (scratch) float32 [B, H, Sq].  dtype 0 is
// float32, 1 bfloat16 (every tensor but lse and di of that type).  window
// <= 0 and softcap <= 0 mean none.  Launches the three kernels on `stream`
// and returns cudaGetLastError() (cudaErrorInvalidValue for a head dim
// without an instantiation).
extern "C" int flash_attention_bwd_launch(
    const void* q, const void* k, const void* v, const void* o,
    const void* dout, const float* lse, float* di, void* dq, void* dk,
    void* dv, int dtype, int B, int H, int Kh, int Sq, int Sk, int D,
    const long long* strides, int causal, int window, float softcap,
    float scale, cudaStream_t stream) {
  Params p;
  p.q = q;
  p.k = k;
  p.v = v;
  p.o = o;
  p.dout = dout;
  p.lse = lse;
  p.di = di;
  p.dq = dq;
  p.dk = dk;
  p.dv = dv;
  Strides* all[8] = {&p.qs, &p.ks, &p.vs, &p.os, &p.dos, &p.dqs, &p.dks,
                     &p.dvs};
  for (int t = 0; t < 8; ++t)
    *all[t] = {strides[3 * t], strides[3 * t + 1], strides[3 * t + 2]};
  p.B = B;
  p.H = H;
  p.Kh = Kh;
  p.Sq = Sq;
  p.Sk = Sk;
  p.causal = causal;
  p.window = window;
  p.softcap = softcap;
  p.scale = scale;
  cudaError_t err;
  if (dtype == 0)
    err = launch_dim<float>(p, D, stream);
  else if (dtype == 1)
    err = launch_dim<__nv_bfloat16>(p, D, stream);
  else
    err = cudaErrorInvalidValue;
  return static_cast<int>(err);
}
