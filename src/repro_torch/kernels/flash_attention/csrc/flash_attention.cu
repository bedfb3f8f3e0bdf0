// Flash-attention forward for Hopper (sm_90a): causal / sliding-window /
// tanh-soft-capped grouped-query attention with an online softmax.
//
// Replaces the Pallas TPU kernel
//   src/repro/kernels/flash_attention/kernel.py::flash_attention_fwd
// and the padding, head flattening and transposes of its wrapper
// src/repro/kernels/flash_attention/ops.py::flash_attention.
//
//   o[b, i, h, :] = sum_j softmax_j(s_ij) v[b, j, h / (H / Kh), :],
//   s_ij = cap(q[b, i, h, :] . k[b, j, h / (H / Kh), :] / sqrt(D)),
//   cap(x) = softcap * tanh(x / softcap) (when set), applied before the mask;
//   visible: j <= i (causal, top-left aligned), j > i - window (when set);
//   a row with nothing visible is written as zeros.
//
// What bounds it on an H100: operations.  At yi-6b's prefill shape (B=2,
// S=4096, H=32, Kh=4, D=128, causal, bf16) the visible half of QK^T and PV
// is 275 GFLOP against 151 MB of q, k, v and o: ~1800 FLOP per byte, far
// above the card's ~295 bf16 FLOP per byte of HBM.  The tensor-core bound
// is 0.28 ms.  This first kernel does its arithmetic as fp32 FMAs on the
// CUDA cores (67 TFLOP/s peak, >= 4.1 ms at that shape), so the f32 path
// never runs in TF32 and both types share one exact accumulation; it is
// bound by FMA issue and shared-memory reads.  mma.sync / wgmma on bf16
// tiles is the later step.
//
// What the design does about it:
//   * one block of 256 threads per (b*H + h, 64-row q tile); the KV loop
//     runs inside the block (the TPU's sequential grid axis), with the
//     running max, sum and the [64, D] accumulator in fp32 registers;
//   * the KV head is h / (H / Kh), from the block's own index: K/V are
//     never repeated;
//   * the loop bounds skip KV tiles that are fully masked (above the
//     causal diagonal, before the window); causal blocks are scheduled
//     heaviest (last q tile) first;
//   * q, k, v and o are read and written in place in the model's
//     [B, S, heads, D] layout through the strides the wrapper passes, and
//     ragged edges are masked here: no padded, transposed or repeated copy
//     is made;
//   * each thread computes a 4 x 4 block of the 64 x 64 score tile (rows
//     ty + 16i, columns tx + 16j), so the 16 threads of a half-warp share
//     their rows and the row max and sum are 4-step xor shuffles; Q and K
//     tiles sit in shared memory with one float of row padding, so the
//     column-strided reads hit 16 distinct banks;
//   * the P tile reuses the K tile's shared memory: at D=128 a block takes
//     99 KB, two blocks per SM (dynamic shared memory above 48 KB is
//     enabled with cudaFuncSetAttribute).
// Head dims 16, 32, 64, 128 and 256 are compiled; float32 and bfloat16.
//
// The tile knobs (block_q, block_k, num_warps) pick an instantiation: a
// BQ-row q tile against BK-key KV tiles per block of 32 NW threads; a
// thread owns rows ty + TY i (TY = 2 NW rows of threads, BQ / TY rows
// each) and score columns tx + 16 j.  Every dtype and head dim has the
// default 64 x 64 tile with 8 warps; float32 at head dims 64 and 128 also
// has the tiles of kTiles below (fma_tiles() in the wrapper names them).
// The KV tiles are staged one at a time (no ring): the pipeline knob's
// only value here is 1.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <type_traits>

namespace {

constexpr float kNegInf = -1e30f;  // the reference's NEG_INF
constexpr int kSmemLimit = 232448; // a block's shared-memory limit on sm_90

// BQ q rows and BK keys per tile, 32 NW threads: 16 threads along the
// score columns, TY along the rows
template <int BQ, int BK, int NW>
struct Tile {
  static constexpr int kThreads = 32 * NW;
  static constexpr int kTY = kThreads / 16;
  static constexpr int kRows = BQ / kTY;   // q rows per thread: ty + TY i
  static constexpr int kCols = BK / 16;    // score columns: tx + 16 j
  static_assert(BQ % kTY == 0 && BK % 16 == 0, "tile");
};

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
  void* o;
  Strides qs, ks, vs, os;
  int H, Kh, Sq, Sk;
  int causal;
  int window;                      // <= 0: no window
  float softcap;                   // <= 0: no soft-cap
  float scale;                     // 1 / sqrt(D)
  float* lse;                      // [B, H, Sq] log-sum-exp, or null
};

template <int D, int BQ, int BK>
__host__ __device__ constexpr int kp_floats() {        // the K tile, later the P tile
  return BK * (D + 1) > BQ * (BK + 1) ? BK * (D + 1) : BQ * (BK + 1);
}

template <int D, int BQ, int BK>
__host__ __device__ constexpr int smem_bytes() {
  return (BQ * (D + 1) + kp_floats<D, BQ, BK>() + BK * D) * (int)sizeof(float);
}

__device__ __forceinline__ float half_warp_max(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

__device__ __forceinline__ float half_warp_sum(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

template <typename T, int D, int BQ, int BK, int NW, bool kLse>
__global__ void __launch_bounds__(32 * NW, D <= 128 ? 2 : 1)
flash_fwd_kernel(const Params p) {
  using L = Tile<BQ, BK, NW>;
  constexpr int kBQ = BQ, kBK = BK, kThreads = L::kThreads;
  constexpr int kRows = L::kRows, kCols = L::kCols, kTY = L::kTY;
  constexpr int kOC = D / 16;      // output columns per thread: tx + 16 c
  extern __shared__ float smem[];
  float* sQ = smem;                          // [kBQ][D + 1], pre-scaled
  float* sKP = sQ + kBQ * (D + 1);           // K [kBK][D + 1], then P [kBQ][kBK + 1]
  float* sV = sKP + kp_floats<D, BQ, BK>();  // [kBK][D]

  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  const int bh = blockIdx.y;
  const int b = bh / p.H;
  const int h = bh - b * p.H;
  const int kh = h / (p.H / p.Kh);
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kBQ;

  const T* __restrict__ qb =
      static_cast<const T*>(p.q) + b * p.qs.b + h * p.qs.h;
  const T* __restrict__ kb =
      static_cast<const T*>(p.k) + b * p.ks.b + kh * p.ks.h;
  const T* __restrict__ vb =
      static_cast<const T*>(p.v) + b * p.vs.b + kh * p.vs.h;
  T* __restrict__ ob = static_cast<T*>(p.o) + b * p.os.b + h * p.os.h;

  for (int idx = tid; idx < kBQ * D; idx += kThreads) {
    const int r = idx / D;
    const int c = idx - r * D;
    const int row = q0 + r;
    sQ[r * (D + 1) + c] =
        row < p.Sq ? to_f32(qb[row * p.qs.s + c]) * p.scale : 0.f;
  }

  // the keys any row of this tile can see
  int kv_end = p.Sk;
  if (p.causal) kv_end = min(kv_end, min(q0 + kBQ, p.Sq));
  const int kv_begin = p.window > 0 ? max(0, q0 - p.window + 1) : 0;
  const int t_begin = kv_begin / kBK;
  const int t_end = (kv_end + kBK - 1) / kBK;

  float m[kRows], l[kRows], acc[kRows][kOC];
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < kOC; ++c) acc[i][c] = 0.f;
  }

  for (int t = t_begin; t < t_end; ++t) {
    const int k0 = t * kBK;
    __syncthreads();               // the last tile's P and V reads are done
    for (int idx = tid; idx < kBK * D; idx += kThreads) {
      const int r = idx / D;
      const int c = idx - r * D;
      const int key = k0 + r;
      float kv = 0.f, vv = 0.f;
      if (key < p.Sk) {
        kv = to_f32(kb[key * p.ks.s + c]);
        vv = to_f32(vb[key * p.vs.s + c]);
      }
      sKP[r * (D + 1) + c] = kv;
      sV[r * D + c] = vv;
    }
    __syncthreads();

    float s[kRows][kCols];
#pragma unroll
    for (int i = 0; i < kRows; ++i)
#pragma unroll
      for (int j = 0; j < kCols; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      float a[kRows], bk[kCols];
#pragma unroll
      for (int i = 0; i < kRows; ++i) a[i] = sQ[(ty + kTY * i) * (D + 1) + d];
#pragma unroll
      for (int j = 0; j < kCols; ++j) bk[j] = sKP[(tx + 16 * j) * (D + 1) + d];
#pragma unroll
      for (int i = 0; i < kRows; ++i)
#pragma unroll
        for (int j = 0; j < kCols; ++j) s[i][j] = fmaf(a[i], bk[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const int qi = q0 + ty + kTY * i;
      bool vis[kCols];
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        const int ki = k0 + tx + 16 * j;
        float x = s[i][j];
        if (p.softcap > 0.f) x = p.softcap * tanhf(x / p.softcap);
        bool ok = qi < p.Sq && ki < p.Sk;
        if (p.causal) ok = ok && ki <= qi;
        if (p.window > 0) ok = ok && ki > qi - p.window;
        vis[j] = ok;
        s[i][j] = ok ? x : kNegInf;
        mx = fmaxf(mx, s[i][j]);
      }
      const float m_new = fmaxf(m[i], half_warp_max(mx));
      const float alpha = expf(m[i] - m_new);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        s[i][j] = vis[j] ? expf(s[i][j] - m_new) : 0.f;
        rs += s[i][j];
      }
      l[i] = l[i] * alpha + half_warp_sum(rs);
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < kOC; ++c) acc[i][c] *= alpha;
    }

    __syncthreads();               // every thread has read K: P takes its place
#pragma unroll
    for (int i = 0; i < kRows; ++i)
#pragma unroll
      for (int j = 0; j < kCols; ++j)
        sKP[(ty + kTY * i) * (kBK + 1) + tx + 16 * j] = s[i][j];
    __syncthreads();

#pragma unroll 4
    for (int kk = 0; kk < kBK; ++kk) {
      float pv[kRows], vv[kOC];
#pragma unroll
      for (int i = 0; i < kRows; ++i) pv[i] = sKP[(ty + kTY * i) * (kBK + 1) + kk];
#pragma unroll
      for (int c = 0; c < kOC; ++c) vv[c] = sV[kk * D + tx + 16 * c];
#pragma unroll
      for (int i = 0; i < kRows; ++i)
#pragma unroll
        for (int c = 0; c < kOC; ++c) acc[i][c] = fmaf(pv[i], vv[c], acc[i][c]);
    }
  }

#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int qi = q0 + ty + kTY * i;
    if (qi >= p.Sq) continue;
    // the row's log-sum-exp for the backward (-inf: nothing visible)
    if constexpr (kLse) {
      if (tx == 0)
        p.lse[(static_cast<long long>(b) * p.H + h) * p.Sq + qi] =
            m[i] + logf(l[i]);
    }
    const float denom = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int c = 0; c < kOC; ++c)
      ob[qi * p.os.s + tx + 16 * c] = from_f32<T>(acc[i][c] / denom);
  }
}

template <typename T, int D, int BQ, int BK, int NW, bool kLse = false>
cudaError_t launch(const Params& p, int batch, cudaStream_t stream) {
  constexpr int bytes = smem_bytes<D, BQ, BK>();
  if constexpr (bytes > kSmemLimit) {
    return cudaErrorInvalidValue;
  } else {
    auto kernel = flash_fwd_kernel<T, D, BQ, BK, NW, kLse>;
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return err;
    const dim3 grid((p.Sq + BQ - 1) / BQ, batch * p.H);
    kernel<<<grid, 32 * NW, bytes, stream>>>(p);
    return cudaGetLastError();
  }
}

// the tuned tiles (BQ, BK, NW) of float32 at head dims 64 and 128; the
// default 64 x 64 x 8 is compiled for every dtype and head dim
#define FLASH_FMA_TILES(X)                                              \
  X(16, 32, 2) X(16, 64, 2) X(32, 32, 4) X(32, 64, 4) X(32, 32, 8)      \
  X(32, 64, 8) X(64, 32, 4) X(64, 64, 4) X(64, 32, 8) X(128, 32, 8)     \
  X(128, 64, 8)

template <typename T, int D>
cudaError_t launch_tile(const Params& p, int batch, int bq, int bk, int nw,
                        cudaStream_t stream) {
  if (bq == 64 && bk == 64 && nw == 8)
    return p.lse != nullptr ? launch<T, D, 64, 64, 8, true>(p, batch, stream)
                            : launch<T, D, 64, 64, 8>(p, batch, stream);
  if (p.lse != nullptr) return cudaErrorInvalidValue;  // the default tile only
  if constexpr (std::is_same<T, float>::value && (D == 64 || D == 128)) {
#define FLASH_FMA_CASE(BQ, BK, NW)                                      \
    if (bq == BQ && bk == BK && nw == NW)                               \
      return launch<T, D, BQ, BK, NW>(p, batch, stream);
    FLASH_FMA_TILES(FLASH_FMA_CASE)
#undef FLASH_FMA_CASE
  }
  return cudaErrorInvalidValue;
}

template <typename T>
cudaError_t launch_dim(const Params& p, int batch, int d, int bq, int bk,
                       int nw, cudaStream_t stream) {
  switch (d) {
    case 16: return launch_tile<T, 16>(p, batch, bq, bk, nw, stream);
    case 32: return launch_tile<T, 32>(p, batch, bq, bk, nw, stream);
    case 64: return launch_tile<T, 64>(p, batch, bq, bk, nw, stream);
    case 128: return launch_tile<T, 128>(p, batch, bq, bk, nw, stream);
    case 256: return launch_tile<T, 256>(p, batch, bq, bk, nw, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// q [B, Sq, H, D], k/v [B, Sk, Kh, D], o [B, Sq, H, D] on the device, with
// element strides {q_b, q_s, q_h, k_b, k_s, k_h, v_b, v_s, v_h, o_b, o_s,
// o_h} in `strides` (host memory) and unit stride along D.  dtype 0 is
// float32, 1 bfloat16.  window <= 0 and softcap <= 0 mean none.  The tile
// is block_q x block_k with 32 num_warps threads (64, 64, 8 by default;
// cudaErrorInvalidValue for one without an instantiation).  A non-null
// `lse` (float32 [B, H, Sq]) receives each row's log-sum-exp of its scaled,
// soft-capped scores for the backward (flash_attention_bwd.cu), from an
// instantiation of its own (the default tile only); null launches the
// kernel as it was before the pointer.  Launches on `stream` and returns
// cudaGetLastError().
extern "C" int flash_attention_launch(
    const void* q, const void* k, const void* v, void* o, int dtype, int B,
    int H, int Kh, int Sq, int Sk, int D, const long long* strides,
    int causal, int window, float softcap, float scale, int block_q,
    int block_k, int num_warps, float* lse, cudaStream_t stream) {
  Params p;
  p.q = q;
  p.k = k;
  p.v = v;
  p.o = o;
  p.qs = {strides[0], strides[1], strides[2]};
  p.ks = {strides[3], strides[4], strides[5]};
  p.vs = {strides[6], strides[7], strides[8]};
  p.os = {strides[9], strides[10], strides[11]};
  p.H = H;
  p.Kh = Kh;
  p.Sq = Sq;
  p.Sk = Sk;
  p.causal = causal;
  p.window = window;
  p.softcap = softcap;
  p.scale = scale;
  p.lse = lse;
  cudaError_t err;
  if (dtype == 0)
    err = launch_dim<float>(p, B, D, block_q, block_k, num_warps, stream);
  else if (dtype == 1)
    err = launch_dim<__nv_bfloat16>(p, B, D, block_q, block_k, num_warps,
                                    stream);
  else
    err = cudaErrorInvalidValue;
  return static_cast<int>(err);
}
