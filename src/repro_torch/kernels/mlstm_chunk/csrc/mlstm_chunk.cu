// Chunkwise mLSTM forward for Hopper (sm_90a): the stabilised
// chunkwise-parallel form of xLSTM's matrix-memory recurrence.
//
// Replaces the Pallas TPU kernel
//   src/repro/kernels/mlstm_chunk/kernel.py::mlstm_chunk_fwd (body _kernel)
// and the transposes of its wrapper
//   src/repro/kernels/mlstm_chunk/ops.py::mlstm_chunk.
//
// For each (b, h) and each chunk of C rows, in order, with cum the
// chunk-local inclusive cumsum of logf and li = logi:
//   D[i,j]   = cum_i - cum_j + li_j                      (j <= i)
//   m_comb_i = max(max_j D[i,j], cum_i + m_prev, -1e30)
//   W[i,j]   = exp(D[i,j] - m_comb_i)
//   h_i      = ( sum_j (q_i.k_j) W[i,j] v_j + (q_i C_prev) exp(cum_i + m_prev - m_comb_i) )
//              / max(|n_all_i . q_i|, exp(-m_comb_i))
// and the carry C [P,P], n [P], m goes to the next chunk:
//   m_new = max(total + m_prev, max_j (total - cum_j + li_j)),  total = cum_{C-1}
//   wk_j  = exp(total - cum_j + li_j - m_new),  decay = exp(total + m_prev - m_new)
//   C     = C decay + sum_j (k_j wk_j)^T v_j,   n = n decay + sum_j k_j wk_j.
// The denominator is reassociated: n_all_i . q_i is computed as
// rowsum_j((q_i.k_j) W[i,j]) + exp(cum_i + m_prev - m_comb_i) (n_prev . q_i),
// the same sum in another order, so the Pallas kernel's W k product is not
// needed.
//
// What bounds it on an H100: operations.  At xlstm-1.3b's layer shape (B=2,
// S=4096, H=4, P=1024, chunk 256, bf16) one (chunk, head) does five
// chunk-scale products, about 1.48 GFLOP, so a layer is ~189 GFLOP against
// 268 MB of q, k, v and h: the tensor-core bound is ~0.19 ms.  This first
// kernel does every product as fp32 FMAs on the CUDA cores (the reference
// holds it at atol 5e-5; TF32 would not), so it is bound by FMA issue and
// shared-memory reads, far above that bound.  mma.sync / wgmma on bf16
// tiles is the later step.
//
// What the design does about the TPU kernel's assumptions:
//   * too few programs: the TPU grid is (B*H, chunks) with the chunk axis
//     sequential, 8 sequences at full width for 132 SMs.  Here the carry C
//     is split by column slices: a block of pass 2 owns C[:, s0:s0+NS] (NS =
//     32 columns, 128 KB of shared memory at P = 1024) and the same columns
//     of v and of h's numerator, so a head runs as P / NS blocks (256
//     blocks at full width).  n, the scalar m and the gate terms need all
//     of P; every slice block carries its own copy (P floats) and computes
//     them itself: at full width that repeats ~4 % of the arithmetic;
//   * q k^T needs all of P: pass 1, parallel over (b*h, chunk, 64 x 64
//     tile), writes the chunk's raw scores q k^T (lower-triangle tiles
//     only) to a float32 scratch [B*H, S, C]; pass 2 walks the chunks in
//     order and applies W on the fly, since W depends on the carried m;
//   * the chunk's own tiles overflow shared memory (a [256, 256] f32 tile
//     is 256 KB, q and k of one chunk 1 MiB each at P = 1024): pass 2 tiles
//     the chunk's rows and P in 256 x 32 tiles, with each thread holding an
//     (NS / 4) x 4 register tile of the output (rows ty + TR r, columns
//     tx + TC c);
//   * every chunk width the mlstm_chunk knob reaches (16 ... 2048) runs:
//     only the per-chunk gate arrays (4 C floats) grow with it;
//   * numerics: fp32 FMAs, expf (no fast math), NEG_INF = -1e30 where the
//     Pallas kernel uses it; masked entries are selected to 0, never
//     exp'd, so no inf - inf.
// P in {16, 32, 64, 128, 256, 512, 1024}; float32 and bfloat16 q, k, v;
// float32 gates.  q, k, v, h are read and written in place in the model's
// [B, S, H, P] layout through the strides the wrapper passes.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr float kNegInf = -1e30f;  // the Pallas kernel's NEG_INF

// pass 1: q k^T tiles
constexpr int kT1 = 64;            // rows and columns of a score tile
constexpr int kK1 = 32;            // P step

// pass 2: the sequential chunk walk
constexpr int kRB = 256;           // rows (of the chunk, or of P) per register tile
constexpr int kKT = 32;            // reduction step staged in shared memory
constexpr int kMaxSmem = 232448;   // a block's shared-memory limit on sm_90
static_assert(kRB == kThreads, "a thread owns one row of a row block");

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
  long long b, s, h;               // in elements; the P stride is 1
};

struct Params {
  const void* q;
  const void* k;
  const void* v;
  const float* li;                 // [B, S, H]
  const float* lf;
  void* o;
  float* qk;                       // scratch [B*H, S, C]
  Strides qs, ks, vs, is, fs, os;
  int H, S, P, C;
};

// ---------------------------------------------------------------------------
// pass 1: qk[bh, t0 + i, j] = q[t0 + i] . k[t0 + j] for the lower-triangle
// 64 x 64 tiles of each chunk (t0 = chunk * C)
// ---------------------------------------------------------------------------

template <typename T>
__global__ void __launch_bounds__(kThreads)
mlstm_qk_kernel(const Params p) {
  __shared__ float sQ[kT1][kK1 + 1];
  __shared__ float sK[kT1][kK1 + 1];
  const int ti = blockIdx.y, tj = blockIdx.z;
  if (tj > ti) return;             // above the diagonal: never read
  const int n_chunks = p.S / p.C;
  const int bh = blockIdx.x / n_chunks;
  const int chunk = blockIdx.x - bh * n_chunks;
  const int b = bh / p.H, h = bh - (bh / p.H) * p.H;
  const int t0 = chunk * p.C;
  const int i0 = ti * kT1, j0 = tj * kT1;
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;

  const T* __restrict__ qb =
      static_cast<const T*>(p.q) + b * p.qs.b + h * p.qs.h;
  const T* __restrict__ kb =
      static_cast<const T*>(p.k) + b * p.ks.b + h * p.ks.h;

  float acc[4][4];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[r][c] = 0.f;

  for (int p0 = 0; p0 < p.P; p0 += kK1) {
    for (int idx = tid; idx < kT1 * kK1; idx += kThreads) {
      const int r = idx / kK1, pp = idx - r * kK1;
      const bool okp = p0 + pp < p.P;
      const int qi = i0 + r, kj = j0 + r;
      sQ[r][pp] = okp && qi < p.C
          ? to_f32(qb[(long long)(t0 + qi) * p.qs.s + p0 + pp]) : 0.f;
      sK[r][pp] = okp && kj < p.C
          ? to_f32(kb[(long long)(t0 + kj) * p.ks.s + p0 + pp]) : 0.f;
    }
    __syncthreads();
#pragma unroll 8
    for (int pp = 0; pp < kK1; ++pp) {
      float a[4], bk[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) a[r] = sQ[ty + 16 * r][pp];
#pragma unroll
      for (int c = 0; c < 4; ++c) bk[c] = sK[tx + 16 * c][pp];
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[r][c] = fmaf(a[r], bk[c], acc[r][c]);
    }
    __syncthreads();
  }

  float* __restrict__ out = p.qk + (long long)bh * p.S * p.C;
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int i = i0 + ty + 16 * r;
    if (i >= p.C) continue;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int j = j0 + tx + 16 * c;
      if (j < p.C) out[(long long)(t0 + i) * p.C + j] = acc[r][c];
    }
  }
}

// ---------------------------------------------------------------------------
// pass 2: one block per (column slice of C, b*h) walks the chunks in order
// ---------------------------------------------------------------------------

__device__ __forceinline__ float block_max(float x, float* red) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = x;
  __syncthreads();
  float r = red[0];
#pragma unroll
  for (int w = 1; w < kThreads / 32; ++w) r = fmaxf(r, red[w]);
  __syncthreads();                 // red may be written again
  return r;
}

__host__ __device__ constexpr long long smem_floats(int P, int NS, int C) {
  // sC [P][NS], sN [P], cum/li/m_comb/scale [C] each, sDen [kRB],
  // tile A [kRB][kKT + 1], tile V [kKT][NS], red [kThreads / 32]
  return (long long)P * NS + P + 4LL * C + kRB + kRB * (kKT + 1)
      + kKT * NS + kThreads / 32;
}

template <typename T, int NS>
__global__ void __launch_bounds__(kThreads, 1)
mlstm_chunk_kernel(const Params p) {
  constexpr int TC = NS / 4;             // thread columns: tx + TC c, c < 4
  constexpr int TR = kThreads / TC;      // thread rows: ty + TR r
  constexpr int RPT = kRB / TR;          // rows per thread
  extern __shared__ float smem[];
  const int P = p.P, C = p.C;
  float* sC = smem;                      // [P][NS]: C[:, s0:s0+NS]
  float* sN = sC + P * NS;               // [P]
  float* sCum = sN + P;                  // [C]
  float* sLi = sCum + C;                 // [C]
  float* sMc = sLi + C;                  // [C] m_comb
  float* sW = sMc + C;                   // [C] scale_in, then wk
  float* sDen = sW + C;                  // [kRB]
  float* sA = sDen + kRB;                // [kRB][kKT + 1] or [kKT][kRB]
  float* sV = sA + kRB * (kKT + 1);      // [kKT][NS]
  float* sRed = sV + kKT * NS;           // [kThreads / 32]

  const int tid = threadIdx.x;
  const int tx = tid % TC, ty = tid / TC;
  const int s0 = blockIdx.x * NS;
  const int bh = blockIdx.y;
  const int b = bh / p.H, h = bh - (bh / p.H) * p.H;

  const T* __restrict__ qb =
      static_cast<const T*>(p.q) + b * p.qs.b + h * p.qs.h;
  const T* __restrict__ kb =
      static_cast<const T*>(p.k) + b * p.ks.b + h * p.ks.h;
  const T* __restrict__ vb =
      static_cast<const T*>(p.v) + b * p.vs.b + h * p.vs.h + s0;
  const float* __restrict__ lib = p.li + b * p.is.b + h * p.is.h;
  const float* __restrict__ lfb = p.lf + b * p.fs.b + h * p.fs.h;
  T* __restrict__ ob = static_cast<T*>(p.o) + b * p.os.b + h * p.os.h + s0;
  const float* __restrict__ qkb = p.qk + (long long)bh * p.S * C;

  for (int idx = tid; idx < P * NS; idx += kThreads) sC[idx] = 0.f;
  for (int idx = tid; idx < P; idx += kThreads) sN[idx] = 0.f;
  float m_prev = kNegInf;

  for (int t0 = 0; t0 < p.S; t0 += C) {
    // ---- the chunk's gate terms ---------------------------------------
    for (int i = tid; i < C; i += kThreads) {
      sLi[i] = lib[(long long)(t0 + i) * p.is.s];
      sCum[i] = lfb[(long long)(t0 + i) * p.fs.s];
    }
    __syncthreads();
    if (tid == 0) {                      // inclusive cumsum, in order
      float run = 0.f;
      for (int i = 0; i < C; ++i) {
        run += sCum[i];
        sCum[i] = run;
      }
    }
    __syncthreads();
    const float total = sCum[C - 1];
    float gmax = kNegInf;
    for (int i = tid; i < C; i += kThreads) {
      const float ci = sCum[i];
      float m_loc = kNegInf;
      for (int j = 0; j <= i; ++j)
        m_loc = fmaxf(m_loc, (ci - sCum[j]) + sLi[j]);
      const float mc = fmaxf(fmaxf(m_loc, ci + m_prev), kNegInf);
      sMc[i] = mc;
      sW[i] = expf((ci + m_prev) - mc);            // scale_in
      gmax = fmaxf(gmax, (total - ci) + sLi[i]);
    }
    gmax = block_max(gmax, sRed);                  // syncs: sMc, sW ready
    const float m_new = fmaxf(total + m_prev, gmax);
    const float decay = expf((total + m_prev) - m_new);

    // ---- outputs: rows r0 .. r0 + kRB of the chunk -------------------
    for (int r0 = 0; r0 < C; r0 += kRB) {
      float acc_in[RPT][4], acc_x[RPT][4];         // intra, inter
#pragma unroll
      for (int r = 0; r < RPT; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc_in[r][c] = acc_x[r][c] = 0.f;
      float rs = 0.f, qn = 0.f;          // row r0 + tid: rowsum(S), q . n_prev

      // inter-chunk term: q C_prev[:, slice] and q . n_prev
      for (int p0 = 0; p0 < P; p0 += kKT) {
        for (int idx = tid; idx < kRB * kKT; idx += kThreads) {
          const int r = idx / kKT, pp = idx - r * kKT;
          sA[r * (kKT + 1) + pp] = r0 + r < C && p0 + pp < P
              ? to_f32(qb[(long long)(t0 + r0 + r) * p.qs.s + p0 + pp])
              : 0.f;
        }
        __syncthreads();
        const int kt = min(kKT, P - p0);
        for (int pp = 0; pp < kt; ++pp)
          qn = fmaf(sA[tid * (kKT + 1) + pp], sN[p0 + pp], qn);
#pragma unroll 4
        for (int pp = 0; pp < kt; ++pp) {
          float a[RPT], bc[4];
#pragma unroll
          for (int r = 0; r < RPT; ++r) a[r] = sA[(ty + TR * r) * (kKT + 1) + pp];
#pragma unroll
          for (int c = 0; c < 4; ++c) bc[c] = sC[(p0 + pp) * NS + tx + TC * c];
#pragma unroll
          for (int r = 0; r < RPT; ++r)
#pragma unroll
            for (int c = 0; c < 4; ++c) acc_x[r][c] = fmaf(a[r], bc[c], acc_x[r][c]);
        }
        __syncthreads();
      }

      // intra-chunk term: ((q k^T) o W) v[:, slice], W made on the fly
      const int j_end = min(r0 + kRB, C);          // the rows' last visible key
      for (int j0 = 0; j0 < j_end; j0 += kKT) {
        for (int idx = tid; idx < kRB * kKT; idx += kThreads) {
          const int r = idx / kKT, jj = idx - r * kKT;
          const int i = r0 + r, j = j0 + jj;
          float s = 0.f;
          if (i < C && j <= i) {
            const float d = (sCum[i] - sCum[j]) + sLi[j];
            s = qkb[(long long)(t0 + i) * C + j] * expf(d - sMc[i]);
          }
          sA[r * (kKT + 1) + jj] = s;
        }
        for (int idx = tid; idx < kKT * NS; idx += kThreads) {
          const int jj = idx / NS, c = idx - jj * NS;
          sV[idx] = j0 + jj < C
              ? to_f32(vb[(long long)(t0 + j0 + jj) * p.vs.s + c]) : 0.f;
        }
        __syncthreads();
        for (int jj = 0; jj < kKT; ++jj) rs += sA[tid * (kKT + 1) + jj];
#pragma unroll 4
        for (int jj = 0; jj < kKT; ++jj) {
          float a[RPT], bc[4];
#pragma unroll
          for (int r = 0; r < RPT; ++r) a[r] = sA[(ty + TR * r) * (kKT + 1) + jj];
#pragma unroll
          for (int c = 0; c < 4; ++c) bc[c] = sV[jj * NS + tx + TC * c];
#pragma unroll
          for (int r = 0; r < RPT; ++r)
#pragma unroll
            for (int c = 0; c < 4; ++c) acc_in[r][c] = fmaf(a[r], bc[c], acc_in[r][c]);
        }
        __syncthreads();
      }

      if (r0 + tid < C) {
        const int i = r0 + tid;
        sDen[tid] = fmaxf(fabsf(rs + sW[i] * qn), expf(-sMc[i]));
      }
      __syncthreads();
#pragma unroll
      for (int r = 0; r < RPT; ++r) {
        const int i = r0 + ty + TR * r;
        if (i >= C) continue;
        const float scale = sW[i], den = sDen[ty + TR * r];
        T* orow = ob + (long long)(t0 + i) * p.os.s;
#pragma unroll
        for (int c = 0; c < 4; ++c)
          orow[tx + TC * c] = from_f32<T>((acc_in[r][c] + acc_x[r][c] * scale) / den);
      }
      __syncthreads();                   // sDen, sA free for the next rows
    }

    // ---- carry update: C[:, slice], n ------------------------------------
    for (int j = tid; j < C; j += kThreads)
      sW[j] = expf(((total - sCum[j]) + sLi[j]) - m_new);   // wk
    __syncthreads();
    for (int p0 = 0; p0 < P; p0 += kRB) {
      float acc[RPT][4];
#pragma unroll
      for (int r = 0; r < RPT; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[r][c] = 0.f;
      float nsum = 0.f;                  // P row p0 + tid
      for (int j0 = 0; j0 < C; j0 += kKT) {
        for (int idx = tid; idx < kKT * kRB; idx += kThreads) {
          const int jj = idx / kRB, pp = idx - jj * kRB;
          const int j = j0 + jj;
          sA[jj * kRB + pp] = j < C && p0 + pp < P
              ? to_f32(kb[(long long)(t0 + j) * p.ks.s + p0 + pp]) * sW[j]
              : 0.f;
        }
        for (int idx = tid; idx < kKT * NS; idx += kThreads) {
          const int jj = idx / NS, c = idx - jj * NS;
          sV[idx] = j0 + jj < C
              ? to_f32(vb[(long long)(t0 + j0 + jj) * p.vs.s + c]) : 0.f;
        }
        __syncthreads();
        const int kt = min(kKT, C - j0);
        for (int jj = 0; jj < kt; ++jj) nsum += sA[jj * kRB + tid];
#pragma unroll 4
        for (int jj = 0; jj < kt; ++jj) {
          float a[RPT], bc[4];
#pragma unroll
          for (int r = 0; r < RPT; ++r) a[r] = sA[jj * kRB + ty + TR * r];
#pragma unroll
          for (int c = 0; c < 4; ++c) bc[c] = sV[jj * NS + tx + TC * c];
#pragma unroll
          for (int r = 0; r < RPT; ++r)
#pragma unroll
            for (int c = 0; c < 4; ++c) acc[r][c] = fmaf(a[r], bc[c], acc[r][c]);
        }
        __syncthreads();
      }
#pragma unroll
      for (int r = 0; r < RPT; ++r) {
        const int pr = p0 + ty + TR * r;
        if (pr >= P) continue;
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          float* cell = sC + pr * NS + tx + TC * c;
          *cell = *cell * decay + acc[r][c];
        }
      }
      if (p0 + tid < P) sN[p0 + tid] = sN[p0 + tid] * decay + nsum;
    }
    m_prev = m_new;
    __syncthreads();                     // sC, sN, gate arrays: next chunk
  }
}

template <typename T, int NS>
cudaError_t launch(const Params& p, int batch, cudaStream_t stream) {
  const long long bytes = smem_floats(p.P, NS, p.C) * (long long)sizeof(float);
  if (bytes > kMaxSmem) return cudaErrorInvalidValue;
  const int n_chunks = p.S / p.C;
  const int tiles = (p.C + kT1 - 1) / kT1;
  const dim3 grid1(batch * p.H * n_chunks, tiles, tiles);
  mlstm_qk_kernel<T><<<grid1, kThreads, 0, stream>>>(p);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(mlstm_chunk_kernel<T, NS>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid2(p.P / NS, batch * p.H);
  mlstm_chunk_kernel<T, NS><<<grid2, kThreads, (int)bytes, stream>>>(p);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_p(const Params& p, int batch, cudaStream_t stream) {
  switch (p.P) {
    case 16: return launch<T, 16>(p, batch, stream);
    case 32: case 64: case 128: case 256: case 512: case 1024:
      return launch<T, 32>(p, batch, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// q/k/v/o [B, S, H, P] (float32 or bfloat16: dtype 0 or 1), logi/logf
// [B, S, H] float32, on the device; element strides {q_b, q_s, q_h, k_*,
// v_*, logi_*, logf_*, o_*} (18, host memory), unit stride along P.  qk is
// a float32 scratch of B*H*S*chunk elements.  S % chunk == 0.  Launches
// both passes on `stream` and returns the first CUDA error.
extern "C" int mlstm_chunk_launch(
    const void* q, const void* k, const void* v, const float* logi,
    const float* logf, void* o, float* qk, int dtype, int B, int S, int H,
    int P, int chunk, const long long* strides, cudaStream_t stream) {
  if (chunk < 1 || S % chunk != 0) return cudaErrorInvalidValue;
  Params p;
  p.q = q;
  p.k = k;
  p.v = v;
  p.li = logi;
  p.lf = logf;
  p.o = o;
  p.qk = qk;
  p.qs = {strides[0], strides[1], strides[2]};
  p.ks = {strides[3], strides[4], strides[5]};
  p.vs = {strides[6], strides[7], strides[8]};
  p.is = {strides[9], strides[10], strides[11]};
  p.fs = {strides[12], strides[13], strides[14]};
  p.os = {strides[15], strides[16], strides[17]};
  p.H = H;
  p.S = S;
  p.P = P;
  p.C = chunk;
  cudaError_t err;
  if (dtype == 0)
    err = launch_p<float>(p, B, stream);
  else if (dtype == 1)
    err = launch_p<__nv_bfloat16>(p, B, stream);
  else
    err = cudaErrorInvalidValue;
  return static_cast<int>(err);
}
