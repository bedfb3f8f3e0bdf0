// Chunkwise mLSTM backward for Hopper (sm_90a): dq, dk, dv, d logi and
// d logf of the stabilised chunkwise forward, in float32 FMAs.
//
// Replaces no TPU kernel: the Pallas kernel
//   src/repro/kernels/mlstm_chunk/kernel.py::mlstm_chunk_fwd
// has no backward (the JAX package trains off the TPU by autodiff of its
// chunked scan, src/repro/models/xlstm.py::mlstm_apply).  It is the
// backward of both forward kernels (mlstm_chunk.cu, mlstm_chunk_wgmma.cu):
// the gradient of the function ref.mlstm_chunkwise computes, and with
// `round` set, of the same function with the wgmma route's bf16 roundings.
// Its plain version is ref.mlstm_chunkwise_grads, whose docstring derives
// the terms; the kernels follow its order.
//
// The mathematics.  Every numerator term and the denominator carry
// exp(-m) of their row, so h does not depend on the stabilisers, which are
// constants here (computed from the gates as the forward does).  With
// v~ = [v, 1] and C~ = [C, n] (n as column P of the carry), the numerator
// and a = n_all . q are one product, and the cotangent of that product is
//   dnum~_i = [dh_i / den_i, beta_i],
//   beta_i  = -sign(a_i) (dh_i . h_i) / den_i  if |a_i| > exp(-m_comb_i),
//             else 0  (the denominator's other branch takes no gradient).
// G_t = dL/dC~ leaving chunk t runs backwards:
//   G_{t-1} = decay_t G_t + sum_{i in t} scale_in_i q_i^T dnum~_i.
// Per chunk, with W the causal decay matrix, S = q k^T, A = S o W,
// dA = dnum~ v~^T (causal), dS = dA o W, E = dA o A:
//   dq = dS k + scale_in (C~ dnum~),   dk = dS^T q + wk (G v~),
//   dv = A^T dnum + G_C^T (k o wk),
// and the gates: d cum_i = rowsum_i E - colsum_i E + scale_in_i q_i .
// (C~ dnum~_i) - F_i, d li_j = colsum_j E + F_j, F_j = wk_j k_j . (G v~_j),
// d total = sum_j F_j + decay <G_t, C~_t>, d logf the reverse cumsum of
// d cum within the chunk.  With `round`, the forward's bf16 roundings
// enter where its values do: A into A^T dnum, k o wk into the carry and
// into G_C^T (k o wk), and the carried C (not n) into C~ dnum~; every
// gradient stays float32 (the roundings pass it straight through).
//
// Ten launches on one stream, each deterministic (no atomics, every sum in
// a fixed order; two calls give the same bits):
//   1. gates (one block per chunk and b*h): cum, m_loc, total, g;
//   2. chain: m_prev, m_comb, scale_in, wk, decay (the forward's a1/a2);
//   3. carry, forward: one block per 64 x 64 tile of C~ and b*h keeps its
//      tile in registers across the chunks and stores C~ entering each
//      chunk (float32 [B*H, n, P, P+1]);
//   4. scores: S = q k^T and dh v^T on the causal 64 x 64 tiles of each
//      chunk, into float32 scratch [B*H, S, chunk];
//   5. rows (one block per chunk and b*h, a warp per row): a_i, den_i,
//      beta_i, then dS, A (rounded with `round`) and E over the row, E's
//      row and column sums;
//   6. carry, reverse: G leaving each chunk (float32 [B*H, n, P, P+1])
//      and <G_t, C~_t> per tile;
//   7-9. dq, dk, dv: one block per 64 x 64 output tile, chunk and b*h,
//      all chunks at once; dscale_in and dwk as per-tile partial sums;
//   10. gate grads: the partial sums in tile order, d logi, d logf.
// Every product is a 64 x 64 tile of float32 FMAs (256 threads, 4 x 4
// outputs each, operands staged 32 deep in shared memory): the simple
// first design.  The first chunk's C~ dnum~ (C~ is 0) and the last
// chunk's G terms (G is 0) are skipped.
//
// What bounds it on an H100: operations.  At xlstm-1.3b's layer at the
// train step's microbatch (B=1, S=4096, H=4, P=1024, chunk 256) the design
// does 5 P x P-sized products per chunk (the two carries, C~ dnum~, G v~,
// G_C^T (k o wk)) and 5 causal chunk products (S and dh v^T in both the
// scores and, as dS, in dq, dk; A^T dnum): ~183 GFLOP against ~268 MB of
// q, k, v, h, dh and the gradients, 0.185 ms at the bf16 tensor-core
// peak.  On float32 FMAs it can do no better than ~2.7 ms; a tensor-core
// redesign is later work.
//
// Scratch (the wrapper allocates it): float32 rows [B*H, 8, S], chunks
// [B*H, 3, n], the carries and G [B*H, n, P, P+1] each, the chunk
// matrices [B*H, S, chunk] three times, partial sums [B*H, 2, P/64, S]
// and [B*H, n, tiles].  P in {16, ..., 1024}; chunks 1 to 1024 that
// divide S; float32 or bfloat16 q, k, v, h, dh (read in place through
// their strides, unit stride along P); float32 gates; dq, dk, dv written
// contiguous [B, S, H, P] in the inputs' type, d logi, d logf contiguous
// [B, S, H] float32.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTile = 64;          // rows and columns of an output tile
constexpr int kK = 32;             // reduction depth staged at once
constexpr int kMaxChunk = 1024;
constexpr float kNegInf = -1e30f;  // the Pallas kernel's NEG_INF

// rows scratch: [B*H, kRowArrays, S]
enum { kCum, kMc, kSc, kWk, kDen, kBeta, kErow, kEcol, kRowArrays };
// chunks scratch: [B*H, 3, n]
enum { kDecay, kTotal, kG };

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
__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16(x));
}

struct Strides {
  long long b, s, h;               // in elements; the P stride is 1
};

struct Params {
  const void* q;
  const void* k;
  const void* v;
  const void* h;                   // the forward's output
  const void* dh;
  const float* li;                 // [B, S, H]
  const float* lf;
  void* dq;                        // [B, S, H, P], contiguous
  void* dk;
  void* dv;
  float* dli;                      // [B, S, H], contiguous
  float* dlf;
  float* rows;                     // [B*H, kRowArrays, S]
  float* chunks;                   // [B*H, 3, n]
  float* states;                   // [B*H, n, P, P+1]: C~ entering chunk t
  float* grads;                    // [B*H, n, P, P+1]: G leaving chunk t
  float* sc;                       // [B*H, S, C]: S, then A (rounded)
  float* dsc;                      // [B*H, S, C]: dh v^T, then dS
  float* ec;                       // [B*H, S, C]: E
  float* part;                     // [B*H, 2, nPT, S]: dscale_in, dwk
  float* dpart;                    // [B*H, n, tiles]: <G_t, C~_t>
  Strides qs, ks, vs, hs, dhs, is, fs;
  int H, S, P, C, n, round;
};

__host__ __device__ __forceinline__ int tiles_of(int x) {
  return (x + kTile - 1) / kTile;
}

__device__ __forceinline__ float* row_array(const Params& p, int bh,
                                            int which) {
  return p.rows + ((long long)bh * kRowArrays + which) * p.S;
}

__device__ __forceinline__ float* chunk_array(const Params& p, int bh,
                                              int which) {
  return p.chunks + ((long long)bh * 3 + which) * p.n;
}

template <typename T>
__device__ __forceinline__ const T* bhd(const void* base, const Strides& st,
                                        int bh, int H) {
  const int b = bh / H, h = bh - b * H;
  return static_cast<const T*>(base) + b * st.b + h * st.h;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

// the block's sum (max) of x, warps then warp 0's partials in order;
// every thread gets it
__device__ __forceinline__ float block_sum(float x, float* red) {
  x = warp_sum(x);
  if (threadIdx.x % 32 == 0) red[threadIdx.x / 32] = x;
  __syncthreads();
  float r = red[0];
  for (int w = 1; w < kWarps; ++w) r += red[w];
  __syncthreads();                 // red may be written again
  return r;
}

__device__ __forceinline__ float block_max(float x, float* red) {
  x = warp_max(x);
  if (threadIdx.x % 32 == 0) red[threadIdx.x / 32] = x;
  __syncthreads();
  float r = red[0];
  for (int w = 1; w < kWarps; ++w) r = fmaxf(r, red[w]);
  __syncthreads();
  return r;
}

// acc[r][c] += sum_{kk in [k_lo, k_hi)} A(ty + 16 r, kk) B(kk, tx + 16 c)
// for the thread (ty, tx) = (tid / 16, tid % 16) of a 64 x 64 tile.  The
// loaders return 0 outside their operand.  kA (kB): A's (B's) kk index is
// the one contiguous in memory, so the staging threads walk kk fastest;
// otherwise they walk the row (column).
struct Smem {
  float a[kTile * (kK + 1)];       // [row][kk]
  float b[kK * (kTile + 1)];       // [kk][col]
};

template <bool kA, bool kB, class LA, class LB>
__device__ __forceinline__ void tile_gemm(float (&acc)[4][4], int k_lo,
                                          int k_hi, LA la, LB lb, Smem& sm) {
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  for (int k0 = k_lo; k0 < k_hi; k0 += kK) {
    for (int idx = tid; idx < kTile * kK; idx += kThreads) {
      const int r = kA ? idx / kK : idx % kTile;
      const int kk = kA ? idx % kK : idx / kTile;
      sm.a[r * (kK + 1) + kk] = k0 + kk < k_hi ? la(r, k0 + kk) : 0.f;
    }
    for (int idx = tid; idx < kTile * kK; idx += kThreads) {
      const int c = kB ? idx / kK : idx % kTile;
      const int kk = kB ? idx % kK : idx / kTile;
      sm.b[kk * (kTile + 1) + c] = k0 + kk < k_hi ? lb(k0 + kk, c) : 0.f;
    }
    __syncthreads();
#pragma unroll 8
    for (int kk = 0; kk < kK; ++kk) {
      float a[4], b[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) a[r] = sm.a[(ty + 16 * r) * (kK + 1) + kk];
#pragma unroll
      for (int c = 0; c < 4; ++c) b[c] = sm.b[kk * (kTile + 1) + tx + 16 * c];
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[r][c] = fmaf(a[r], b[c], acc[r][c]);
    }
    __syncthreads();
  }
}

__device__ __forceinline__ void zero(float (&acc)[4][4]) {
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[r][c] = 0.f;
}

// ---------------------------------------------------------------------------
// 1-2. the stabilisers from the gates (mlstm_chunk_wgmma.cu's a1/a2)
// ---------------------------------------------------------------------------

// one block per (chunk, b*h): the chunk-local inclusive cumsum of logf in
// order, per row m_loc = max_{j<=i}((cum_i - cum_j) + li_j) (kept in the
// m_comb row until the chain), the chunk's total and g = max_j((total -
// cum_j) + li_j)
__global__ void __launch_bounds__(kThreads)
mlstm_bwd_gates_kernel(const Params p) {
  __shared__ float sCum[kMaxChunk], sLi[kMaxChunk], red[kWarps];
  const int C = p.C, t = blockIdx.x, bh = blockIdx.y, tid = threadIdx.x;
  const int s0 = t * C;
  const float* lib = bhd<float>(p.li, p.is, bh, p.H);
  const float* lfb = bhd<float>(p.lf, p.fs, bh, p.H);
  for (int i = tid; i < C; i += kThreads) {
    sCum[i] = lfb[(long long)(s0 + i) * p.fs.s];
    sLi[i] = lib[(long long)(s0 + i) * p.is.s];
  }
  __syncthreads();
  if (tid == 0) {
    float run = 0.f;
    for (int i = 0; i < C; ++i) {
      run += sCum[i];
      sCum[i] = run;
    }
  }
  __syncthreads();
  float* cum = row_array(p, bh, kCum);
  float* mloc = row_array(p, bh, kMc);
  const float total = sCum[C - 1];
  float gm = kNegInf;
  for (int i = tid; i < C; i += kThreads) {
    const float ci = sCum[i];
    float m = kNegInf;
    for (int j = 0; j <= i; ++j) m = fmaxf(m, (ci - sCum[j]) + sLi[j]);
    cum[s0 + i] = ci;
    mloc[s0 + i] = m;
    gm = fmaxf(gm, (total - ci) + sLi[i]);
  }
  gm = block_max(gm, red);
  if (tid == 0) {
    chunk_array(p, bh, kTotal)[t] = total;
    chunk_array(p, bh, kG)[t] = gm;
  }
}

// one block per (chunk, b*h): m_prev from the chain over the earlier
// chunks (m_new = max(total + m_prev, g)), then per row m_comb =
// max(m_loc, cum + m_prev, -1e30), scale_in and wk, and the chunk's decay
__global__ void __launch_bounds__(kThreads)
mlstm_bwd_chain_kernel(const Params p) {
  __shared__ float sm[2];          // m_prev, m_new
  const int C = p.C, t = blockIdx.x, bh = blockIdx.y, tid = threadIdx.x;
  const int s0 = t * C;
  const float* tot = chunk_array(p, bh, kTotal);
  const float* gch = chunk_array(p, bh, kG);
  if (tid == 0) {
    float m = kNegInf;
    for (int u = 0; u < t; ++u) m = fmaxf(tot[u] + m, gch[u]);
    const float m_new = fmaxf(tot[t] + m, gch[t]);
    sm[0] = m;
    sm[1] = m_new;
    chunk_array(p, bh, kDecay)[t] = expf((tot[t] + m) - m_new);
  }
  __syncthreads();
  const float m_prev = sm[0], m_new = sm[1], total = tot[t];
  const float* lib = bhd<float>(p.li, p.is, bh, p.H);
  const float* cum = row_array(p, bh, kCum);
  float* mc = row_array(p, bh, kMc);
  float* sc = row_array(p, bh, kSc);
  float* wk = row_array(p, bh, kWk);
  for (int s = s0 + tid; s < s0 + C; s += kThreads) {
    const float ci = cum[s], li = lib[(long long)s * p.is.s];
    const float m_comb = fmaxf(fmaxf(mc[s], ci + m_prev), kNegInf);
    mc[s] = m_comb;
    sc[s] = expf((ci + m_prev) - m_comb);
    wk[s] = expf(((total - ci) + li) - m_new);
  }
}

// ---------------------------------------------------------------------------
// 3, 6. the carries: one block per (64 x 64 tile of C~ or G, b*h) walks the
// chunks, its tile in registers
// ---------------------------------------------------------------------------

// forward (kReverse false): stores C~ entering chunk t, then C~ <- decay
// C~ + (k o wk)^T v~ (k o wk rounded with `round` on the C columns);
// reverse: stores G leaving chunk t and <G_t, C~_t> over the tile, then
// G <- decay G + (scale_in q)^T dnum~
template <typename T, bool kReverse>
__global__ void __launch_bounds__(kThreads)
mlstm_bwd_carry_kernel(const Params p) {
  __shared__ Smem sm;
  __shared__ float red[kWarps];
  const int P = p.P, P1 = P + 1, C = p.C, n = p.n;
  const int nct = tiles_of(P1), tile = blockIdx.x, bh = blockIdx.y;
  const int p0 = (tile / nct) * kTile, r0 = (tile % nct) * kTile;
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const bool rnd = p.round && r0 < P;    // a tile of C's columns
  const T* qb = bhd<T>(p.q, p.qs, bh, p.H);
  const T* kb = bhd<T>(p.k, p.ks, bh, p.H);
  const T* vb = bhd<T>(p.v, p.vs, bh, p.H);
  const T* dhb = bhd<T>(p.dh, p.dhs, bh, p.H);
  const float* sc = row_array(p, bh, kSc);
  const float* wk = row_array(p, bh, kWk);
  const float* den = row_array(p, bh, kDen);
  const float* beta = row_array(p, bh, kBeta);
  const float* decay = chunk_array(p, bh, kDecay);
  float acc[4][4], add[4][4];
  zero(acc);
  for (int step = 0; step < n; ++step) {
    const int t = kReverse ? n - 1 - step : step;
    const long long slab = ((long long)bh * n + t) * P * P1;
    float* dst = (kReverse ? p.grads : p.states) + slab;
    float dot = 0.f;
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int pr = p0 + ty + 16 * r;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int rc = r0 + tx + 16 * c;
        if (pr < P && rc <= P) {
          dst[(long long)pr * P1 + rc] = acc[r][c];
          if (kReverse)
            dot = fmaf(acc[r][c], p.states[slab + (long long)pr * P1 + rc],
                       dot);
        }
      }
    }
    if (kReverse) {
      dot = block_sum(dot, red);
      if (tid == 0)
        p.dpart[((long long)bh * n + t) * gridDim.x + tile] = dot;
    }
    if (kReverse ? t == 0 : t == n - 1) break;   // the last carry: unused
    const int t0 = t * C;
    zero(add);
    if (kReverse) {
      tile_gemm<false, false>(
          add, 0, C,
          [&](int r, int i) {
            const int pr = p0 + r;
            return pr < P ? sc[t0 + i]
                * to_f32(qb[(long long)(t0 + i) * p.qs.s + pr]) : 0.f;
          },
          [&](int i, int c) {
            const int rc = r0 + c;
            if (rc < P)
              return to_f32(dhb[(long long)(t0 + i) * p.dhs.s + rc])
                  / den[t0 + i];
            return rc == P ? beta[t0 + i] : 0.f;
          }, sm);
    } else {
      tile_gemm<false, false>(
          add, 0, C,
          [&](int r, int j) {
            const int pr = p0 + r;
            if (pr >= P) return 0.f;
            const float x =
                to_f32(kb[(long long)(t0 + j) * p.ks.s + pr]) * wk[t0 + j];
            return rnd ? round_bf16(x) : x;
          },
          [&](int j, int c) {
            const int rc = r0 + c;
            if (rc < P) return to_f32(vb[(long long)(t0 + j) * p.vs.s + rc]);
            return rc == P ? 1.f : 0.f;
          }, sm);
    }
    const float dcy = decay[t];
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[r][c] = acc[r][c] * dcy + add[r][c];
  }
}

// ---------------------------------------------------------------------------
// 4. the causal tiles of S = q k^T and dh v^T
// ---------------------------------------------------------------------------

template <typename T>
__global__ void __launch_bounds__(kThreads)
mlstm_bwd_scores_kernel(const Params p) {
  __shared__ Smem sm;
  const int C = p.C, P = p.P, nt = tiles_of(C), bh = blockIdx.y;
  const int t = blockIdx.x / (nt * nt), ti = (blockIdx.x / nt) % nt;
  const int tj = blockIdx.x % nt;
  if (tj > ti) return;             // above the diagonal: never read
  const int t0 = t * C, i0 = ti * kTile, j0 = tj * kTile;
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const T* qb = bhd<T>(p.q, p.qs, bh, p.H);
  const T* kb = bhd<T>(p.k, p.ks, bh, p.H);
  const T* vb = bhd<T>(p.v, p.vs, bh, p.H);
  const T* dhb = bhd<T>(p.dh, p.dhs, bh, p.H);
  float s[4][4], dv[4][4];
  zero(s);
  zero(dv);
  tile_gemm<true, true>(
      s, 0, P,
      [&](int r, int pp) {
        return i0 + r < C
            ? to_f32(qb[(long long)(t0 + i0 + r) * p.qs.s + pp]) : 0.f;
      },
      [&](int pp, int c) {
        return j0 + c < C
            ? to_f32(kb[(long long)(t0 + j0 + c) * p.ks.s + pp]) : 0.f;
      }, sm);
  tile_gemm<true, true>(
      dv, 0, P,
      [&](int r, int pp) {
        return i0 + r < C
            ? to_f32(dhb[(long long)(t0 + i0 + r) * p.dhs.s + pp]) : 0.f;
      },
      [&](int pp, int c) {
        return j0 + c < C
            ? to_f32(vb[(long long)(t0 + j0 + c) * p.vs.s + pp]) : 0.f;
      }, sm);
  const long long base = ((long long)bh * p.S + t0) * C;
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int i = i0 + ty + 16 * r;
    if (i >= C) continue;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int j = j0 + tx + 16 * c;
      if (j < C) {
        p.sc[base + (long long)i * C + j] = s[r][c];
        p.dsc[base + (long long)i * C + j] = dv[r][c];
      }
    }
  }
}

// ---------------------------------------------------------------------------
// 5. per row: a, den, beta; dS, A and E over the row; E's sums
// ---------------------------------------------------------------------------

template <typename T>
__global__ void __launch_bounds__(kThreads)
mlstm_bwd_rows_kernel(const Params p) {
  __shared__ float sCum[kMaxChunk], sLi[kMaxChunk];
  const int C = p.C, P = p.P, P1 = P + 1, t = blockIdx.x, bh = blockIdx.y;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int t0 = t * C;
  const float* lib = bhd<float>(p.li, p.is, bh, p.H);
  const float* cum = row_array(p, bh, kCum);
  for (int i = tid; i < C; i += kThreads) {
    sCum[i] = cum[t0 + i];
    sLi[i] = lib[(long long)(t0 + i) * p.is.s];
  }
  __syncthreads();
  const T* qb = bhd<T>(p.q, p.qs, bh, p.H);
  const T* hb = bhd<T>(p.h, p.hs, bh, p.H);
  const T* dhb = bhd<T>(p.dh, p.dhs, bh, p.H);
  const float* mc = row_array(p, bh, kMc);
  const float* sci = row_array(p, bh, kSc);
  // n entering the chunk: column P of C~
  const float* nst = p.states + ((long long)bh * p.n + t) * P * P1 + P;
  const long long base = ((long long)bh * p.S + t0) * C;
  for (int i = warp; i < C; i += kWarps) {
    const long long s = t0 + i;
    float qn = 0.f, dhh = 0.f;
    for (int pp = lane; pp < P; pp += 32) {
      qn = fmaf(to_f32(qb[s * p.qs.s + pp]), nst[(long long)pp * P1], qn);
      dhh = fmaf(to_f32(dhb[s * p.dhs.s + pp]),
                 to_f32(hb[s * p.hs.s + pp]), dhh);
    }
    qn = warp_sum(qn);
    dhh = warp_sum(dhh);
    const float ci = sCum[i], mci = mc[s];
    float* srow = p.sc + base + (long long)i * C;
    float* dsrow = p.dsc + base + (long long)i * C;
    float* erow = p.ec + base + (long long)i * C;
    float rs = 0.f;
    for (int j = lane; j <= i; j += 32)
      rs += srow[j] * expf(((ci - sCum[j]) + sLi[j]) - mci);
    rs = warp_sum(rs);
    const float a = rs + sci[s] * qn;
    const float floor = expf(-mci);
    const float den = fmaxf(fabsf(a), floor);
    const float beta = fabsf(a) > floor
        ? (-copysignf(1.f, a) * dhh) / den : 0.f;
    float es = 0.f;
    for (int j = lane; j <= i; j += 32) {
      const float w = expf(((ci - sCum[j]) + sLi[j]) - mci);
      const float av = srow[j] * w;
      const float da = dsrow[j] / den + beta;
      const float e = da * av;
      dsrow[j] = da * w;
      erow[j] = e;
      srow[j] = p.round ? round_bf16(av) : av;
      es += e;
    }
    es = warp_sum(es);
    if (lane == 0) {
      row_array(p, bh, kDen)[s] = den;
      row_array(p, bh, kBeta)[s] = beta;
      row_array(p, bh, kErow)[s] = es;
    }
  }
  __syncthreads();                 // E of every row written
  float* ecol = row_array(p, bh, kEcol);
  for (int j = tid; j < C; j += kThreads) {
    float sum = 0.f;
    for (int i = j; i < C; ++i) sum += p.ec[base + (long long)i * C + j];
    ecol[t0 + j] = sum;
  }
}

// ---------------------------------------------------------------------------
// 7-9. the output tiles, all chunks at once
// ---------------------------------------------------------------------------

// (row tile, P column tile, chunk) of block x
__device__ __forceinline__ void out_tile(const Params& p, int& t, int& i0,
                                         int& c0, int& pt) {
  const int nrt = tiles_of(p.C), npt = tiles_of(p.P);
  t = blockIdx.x / (nrt * npt);
  i0 = ((blockIdx.x / npt) % nrt) * kTile;
  pt = blockIdx.x % npt;
  c0 = pt * kTile;
}

// the sum over the tile's 64 columns of x[r][c] y[r][c] for each row
// (16 threads a row, in a fixed order), written by the row's tx == 0
template <class Y, class W>
__device__ __forceinline__ void row_dots(const float (&x)[4][4], Y y,
                                         W write) {
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    float d = 0.f;
#pragma unroll
    for (int c = 0; c < 4; ++c)
      d = fmaf(x[r][c], y(ty + 16 * r, tx + 16 * c), d);
#pragma unroll
    for (int off = 8; off > 0; off >>= 1)
      d += __shfl_xor_sync(0xffffffffu, d, off);
    if (tx == 0) write(ty + 16 * r, d);
  }
}

// dq = dS k + scale_in (C~ dnum~), and dscale_in's partial q . (C~ dnum~)
template <typename T>
__global__ void __launch_bounds__(kThreads)
mlstm_bwd_dq_kernel(const Params p) {
  __shared__ Smem sm;
  int t, i0, c0, pt;
  out_tile(p, t, i0, c0, pt);
  const int C = p.C, P = p.P, P1 = P + 1, bh = blockIdx.y, t0 = t * C;
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const T* qb = bhd<T>(p.q, p.qs, bh, p.H);
  const T* kb = bhd<T>(p.k, p.ks, bh, p.H);
  const T* dhb = bhd<T>(p.dh, p.dhs, bh, p.H);
  const float* sc = row_array(p, bh, kSc);
  const float* den = row_array(p, bh, kDen);
  const float* beta = row_array(p, bh, kBeta);
  const float* dsb = p.dsc + ((long long)bh * p.S + t0) * C;
  float ds[4][4], x[4][4];
  zero(ds);
  zero(x);
  tile_gemm<true, false>(
      ds, 0, min(C, i0 + kTile),
      [&](int r, int j) {
        const int i = i0 + r;
        return i < C && j <= i ? dsb[(long long)i * C + j] : 0.f;
      },
      [&](int j, int c) {
        return c0 + c < P
            ? to_f32(kb[(long long)(t0 + j) * p.ks.s + c0 + c]) : 0.f;
      }, sm);
  if (t > 0) {                     // C~ entering chunk 0 is 0
    const float* st = p.states + ((long long)bh * p.n + t) * P * P1;
    tile_gemm<true, true>(
        x, 0, P1,
        [&](int r, int rr) {
          const int i = i0 + r;
          if (i >= C) return 0.f;
          if (rr < P)
            return to_f32(dhb[(long long)(t0 + i) * p.dhs.s + rr])
                / den[t0 + i];
          return beta[t0 + i];
        },
        [&](int rr, int c) {
          if (c0 + c >= P) return 0.f;
          const float v = st[(long long)(c0 + c) * P1 + rr];
          return p.round && rr < P ? round_bf16(v) : v;
        }, sm);
  }
  T* dq = static_cast<T*>(p.dq);
  const int b = bh / p.H, h = bh - b * p.H;
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int i = i0 + ty + 16 * r;
    if (i >= C) continue;
    const float s = sc[t0 + i];
    T* row = dq + (((long long)b * p.S + t0 + i) * p.H + h) * P;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int pc = c0 + tx + 16 * c;
      if (pc < P) row[pc] = from_f32<T>(ds[r][c] + s * x[r][c]);
    }
  }
  const int npt = tiles_of(P);
  float* part = p.part + ((long long)bh * 2 * npt + pt) * p.S + t0;
  row_dots(x,
           [&](int r, int c) {
             const int i = i0 + r, pc = c0 + c;
             return i < C && pc < P
                 ? to_f32(qb[(long long)(t0 + i) * p.qs.s + pc]) : 0.f;
           },
           [&](int r, float d) { if (i0 + r < C) part[i0 + r] = d; });
}

// dk = dS^T q + wk (G v~), and dwk's partial k . (G v~)
template <typename T>
__global__ void __launch_bounds__(kThreads)
mlstm_bwd_dk_kernel(const Params p) {
  __shared__ Smem sm;
  int t, j0, c0, pt;
  out_tile(p, t, j0, c0, pt);
  const int C = p.C, P = p.P, P1 = P + 1, bh = blockIdx.y, t0 = t * C;
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const T* qb = bhd<T>(p.q, p.qs, bh, p.H);
  const T* kb = bhd<T>(p.k, p.ks, bh, p.H);
  const T* vb = bhd<T>(p.v, p.vs, bh, p.H);
  const float* wk = row_array(p, bh, kWk);
  const float* dsb = p.dsc + ((long long)bh * p.S + t0) * C;
  float dk[4][4], y[4][4];
  zero(dk);
  zero(y);
  if (j0 < C)
    tile_gemm<false, false>(
        dk, j0, C,
        [&](int r, int i) {
          const int j = j0 + r;
          return j < C && i >= j ? dsb[(long long)i * C + j] : 0.f;
        },
        [&](int i, int c) {
          return c0 + c < P
              ? to_f32(qb[(long long)(t0 + i) * p.qs.s + c0 + c]) : 0.f;
        }, sm);
  if (t < p.n - 1) {               // G leaving the last chunk is 0
    const float* g = p.grads + ((long long)bh * p.n + t) * P * P1;
    tile_gemm<true, true>(
        y, 0, P1,
        [&](int r, int rr) {
          const int j = j0 + r;
          if (j >= C) return 0.f;
          return rr < P ? to_f32(vb[(long long)(t0 + j) * p.vs.s + rr]) : 1.f;
        },
        [&](int rr, int c) {
          return c0 + c < P ? g[(long long)(c0 + c) * P1 + rr] : 0.f;
        }, sm);
  }
  T* out = static_cast<T*>(p.dk);
  const int b = bh / p.H, h = bh - b * p.H;
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int j = j0 + ty + 16 * r;
    if (j >= C) continue;
    const float w = wk[t0 + j];
    T* row = out + (((long long)b * p.S + t0 + j) * p.H + h) * P;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int pc = c0 + tx + 16 * c;
      if (pc < P) row[pc] = from_f32<T>(dk[r][c] + w * y[r][c]);
    }
  }
  const int npt = tiles_of(P);
  float* part = p.part + ((long long)(bh * 2 + 1) * npt + pt) * p.S + t0;
  row_dots(y,
           [&](int r, int c) {
             const int j = j0 + r, pc = c0 + c;
             return j < C && pc < P
                 ? to_f32(kb[(long long)(t0 + j) * p.ks.s + pc]) : 0.f;
           },
           [&](int r, float d) { if (j0 + r < C) part[j0 + r] = d; });
}

// dv = A^T dnum + G_C^T (k o wk)
template <typename T>
__global__ void __launch_bounds__(kThreads)
mlstm_bwd_dv_kernel(const Params p) {
  __shared__ Smem sm;
  int t, j0, c0, pt;
  out_tile(p, t, j0, c0, pt);
  const int C = p.C, P = p.P, P1 = P + 1, bh = blockIdx.y, t0 = t * C;
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const T* kb = bhd<T>(p.k, p.ks, bh, p.H);
  const T* dhb = bhd<T>(p.dh, p.dhs, bh, p.H);
  const float* wk = row_array(p, bh, kWk);
  const float* den = row_array(p, bh, kDen);
  const float* ab = p.sc + ((long long)bh * p.S + t0) * C;
  float acc[4][4];
  zero(acc);
  if (j0 < C)
    tile_gemm<false, false>(
        acc, j0, C,
        [&](int r, int i) {
          const int j = j0 + r;
          return j < C && i >= j ? ab[(long long)i * C + j] : 0.f;
        },
        [&](int i, int c) {
          return c0 + c < P
              ? to_f32(dhb[(long long)(t0 + i) * p.dhs.s + c0 + c])
                  / den[t0 + i] : 0.f;
        }, sm);
  if (t < p.n - 1) {
    const float* g = p.grads + ((long long)bh * p.n + t) * P * P1;
    tile_gemm<true, false>(
        acc, 0, P,
        [&](int r, int pp) {
          const int j = j0 + r;
          if (j >= C) return 0.f;
          const float x =
              to_f32(kb[(long long)(t0 + j) * p.ks.s + pp]) * wk[t0 + j];
          return p.round ? round_bf16(x) : x;
        },
        [&](int pp, int c) {
          return c0 + c < P ? g[(long long)pp * P1 + c0 + c] : 0.f;
        }, sm);
  }
  T* out = static_cast<T*>(p.dv);
  const int b = bh / p.H, h = bh - b * p.H;
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int j = j0 + ty + 16 * r;
    if (j >= C) continue;
    T* row = out + (((long long)b * p.S + t0 + j) * p.H + h) * P;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int pc = c0 + tx + 16 * c;
      if (pc < P) row[pc] = from_f32<T>(acc[r][c]);
    }
  }
}

// ---------------------------------------------------------------------------
// 10. the gates' gradients: one block per (chunk, b*h)
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(kThreads)
mlstm_bwd_gate_grads_kernel(const Params p) {
  __shared__ float sDcum[kMaxChunk], sF[kMaxChunk];
  const int C = p.C, t = blockIdx.x, bh = blockIdx.y, tid = threadIdx.x;
  const int t0 = t * C, npt = tiles_of(p.P);
  const int b = bh / p.H, h = bh - b * p.H;
  const float* sc = row_array(p, bh, kSc);
  const float* wk = row_array(p, bh, kWk);
  const float* erow = row_array(p, bh, kErow);
  const float* ecol = row_array(p, bh, kEcol);
  const float* dsp = p.part + (long long)bh * 2 * npt * p.S;
  const float* dwp = dsp + (long long)npt * p.S;
  for (int i = tid; i < C; i += kThreads) {
    const int s = t0 + i;
    float ds = 0.f, dwk = 0.f;
    for (int k = 0; k < npt; ++k) {
      ds += dsp[(long long)k * p.S + s];
      dwk += dwp[(long long)k * p.S + s];
    }
    const float f = dwk * wk[s];
    p.dli[((long long)b * p.S + s) * p.H + h] = ecol[s] + f;
    sDcum[i] = ((erow[s] - ecol[s]) + ds * sc[s]) - f;
    sF[i] = f;
  }
  __syncthreads();
  if (tid == 0) {
    const int tiles = tiles_of(p.P) * tiles_of(p.P + 1);
    const float* dd = p.dpart + ((long long)bh * p.n + t) * tiles;
    float ftot = 0.f, dcy = 0.f;
    for (int i = 0; i < C; ++i) ftot += sF[i];
    for (int k = 0; k < tiles; ++k) dcy += dd[k];
    sDcum[C - 1] += ftot + dcy * chunk_array(p, bh, kDecay)[t];
    float run = 0.f;
    for (int i = C - 1; i >= 0; --i) {
      run += sDcum[i];
      p.dlf[((long long)b * p.S + t0 + i) * p.H + h] = run;
    }
  }
}

template <typename T>
cudaError_t launch(const Params& p, int BH, cudaStream_t stream) {
  const int n = p.n, nt = tiles_of(p.C), npt = tiles_of(p.P);
  const dim3 chunks(n, BH);
  const dim3 carry(npt * tiles_of(p.P + 1), BH);
  const dim3 outs(n * nt * npt, BH);
  mlstm_bwd_gates_kernel<<<chunks, kThreads, 0, stream>>>(p);
  mlstm_bwd_chain_kernel<<<chunks, kThreads, 0, stream>>>(p);
  mlstm_bwd_carry_kernel<T, false><<<carry, kThreads, 0, stream>>>(p);
  mlstm_bwd_scores_kernel<T><<<dim3(n * nt * nt, BH), kThreads, 0,
                               stream>>>(p);
  mlstm_bwd_rows_kernel<T><<<chunks, kThreads, 0, stream>>>(p);
  mlstm_bwd_carry_kernel<T, true><<<carry, kThreads, 0, stream>>>(p);
  mlstm_bwd_dq_kernel<T><<<outs, kThreads, 0, stream>>>(p);
  mlstm_bwd_dk_kernel<T><<<outs, kThreads, 0, stream>>>(p);
  mlstm_bwd_dv_kernel<T><<<outs, kThreads, 0, stream>>>(p);
  mlstm_bwd_gate_grads_kernel<<<chunks, kThreads, 0, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace

// q/k/v/h/dh [B, S, H, P] (float32 or bfloat16: dtype 0 or 1) read through
// their strides, logi/logf [B, S, H] float32; element strides {q_b, q_s,
// q_h, k_*, v_*, h_*, dh_*, logi_*, logf_*} (21, host memory), unit
// stride along P.  dq/dk/dv contiguous [B, S, H, P] in the inputs' type,
// dli/dlf contiguous [B, S, H] float32.  The scratch as the head note
// says.  `round`: the wgmma route's roundings (P a multiple of 64).
// Launches the ten kernels on `stream` and returns the first CUDA error.
extern "C" int mlstm_chunk_bwd_launch(
    const void* q, const void* k, const void* v, const void* h,
    const void* dh, const float* logi, const float* logf, void* dq, void* dk,
    void* dv, float* dli, float* dlf, float* rows, float* chunks,
    float* states, float* grads, float* sc, float* dsc, float* ec,
    float* part, float* dpart, int dtype, int B, int S, int H, int P,
    int chunk, const long long* strides, int round, cudaStream_t stream) {
  if (chunk < 1 || chunk > kMaxChunk || S % chunk != 0 || P < 1 ||
      P > 1024 || (round && P % kTile != 0) || B * H > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  Params p;
  p.q = q;
  p.k = k;
  p.v = v;
  p.h = h;
  p.dh = dh;
  p.li = logi;
  p.lf = logf;
  p.dq = dq;
  p.dk = dk;
  p.dv = dv;
  p.dli = dli;
  p.dlf = dlf;
  p.rows = rows;
  p.chunks = chunks;
  p.states = states;
  p.grads = grads;
  p.sc = sc;
  p.dsc = dsc;
  p.ec = ec;
  p.part = part;
  p.dpart = dpart;
  p.qs = {strides[0], strides[1], strides[2]};
  p.ks = {strides[3], strides[4], strides[5]};
  p.vs = {strides[6], strides[7], strides[8]};
  p.hs = {strides[9], strides[10], strides[11]};
  p.dhs = {strides[12], strides[13], strides[14]};
  p.is = {strides[15], strides[16], strides[17]};
  p.fs = {strides[18], strides[19], strides[20]};
  p.H = H;
  p.S = S;
  p.P = P;
  p.C = chunk;
  p.n = S / chunk;
  p.round = round;
  cudaError_t err;
  if (dtype == 0)
    err = launch<float>(p, B * H, stream);
  else if (dtype == 1)
    err = launch<__nv_bfloat16>(p, B * H, stream);
  else
    err = cudaErrorInvalidValue;
  return static_cast<int>(err);
}
