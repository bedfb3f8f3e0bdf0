// Chunkwise mLSTM backward for Hopper (sm_90a) on the tensor cores: dq, dk,
// dv, d logi and d logf of the wgmma forward (mlstm_chunk_wgmma.cu), bf16
// q, k, v, float32 gates, head widths P in {64, 128, 256, 512, 1024} and
// chunks of 128, 256, 512 or 1024 rows.  float32 and the FMA forward's
// shapes take mlstm_chunk_bwd.cu.
//
// Replaces no TPU kernel: the Pallas kernel
//   src/repro/kernels/mlstm_chunk/kernel.py::mlstm_chunk_fwd
// has no backward (the JAX package trains off the TPU by autodiff of its
// chunked scan, src/repro/models/xlstm.py::mlstm_apply).  It computes what
// mlstm_chunk_bwd.cu computes (see there for the mathematics; the plain
// version ref.mlstm_chunkwise_grads derives the terms), with every P x P
// and causal chunk product on wgmma.
//
// What bounds it on an H100: operations.  At xlstm-1.3b's layer at the
// train step's microbatch (B=1, S=4096, H=4, P=1024, chunk 256) the
// products are ~183 GFLOP against ~268 MB of q, k, v, h, dh and the
// gradients: 0.185 ms at the bf16 tensor-core peak.  Only wgmma reaches it.
// Measured on an H100 (tools/mlstm_bwd_variants.py): ~0.91 ms of device
// time, ~0.2 of that bound.  dq, dk, dv run at ~280-340 TFLOP/s (one
// block an SM); the carries wait on memory, not on the tensor cores
// (without their products they take as long): the slabs they write and
// read (hi, lo, G_C: 0.38 GB at the layer shape) and their operands.
//
// The augmented column, split.  mlstm_chunk_bwd.cu carries C~ = [C, n]
// and G = [G_C, G_n] as float32 [P, P+1]: rows of 4 (P + 1) bytes, which
// no TMA box or wgmma descriptor can read.  Here C and G_C are [P, P]
// tiles for the tensor cores, and the rank-one terms leave them, carried in
// float32 beside them as the forward carries n: n (from the unrounded
// k o wk), G_n (from the unrounded scale_in q beta), the ones-column of
// v~ (G_n added to G_C v in the dk epilogue) and beta (n beta added to
// C dnum in the dq epilogue).
//
// d decay = <G_t, C~_t> dots the float32 G_C accumulator with C where both
// are live, in the reverse carry: the forward carry stores C entering each
// chunk as two bf16 slabs, hi = bf16(C) (the operand of C dnum) and lo =
// bf16(C - hi), and the dot reads hi and lo, which hold C to ~2^-17 of its
// size (the plain version dots the unrounded C): no float32 slab is kept.
//
// Both carries are scans: one block per 128 x 128 tile of C or G_C (P 64:
// 64 x 64) walks the chunks with the tile in wgmma accumulators, its
// operands streamed by TMA in 64-row boxes through a 3-stage ring, as the
// forward's state pass does (the two-pass alternative, per-chunk increments
// then a scalar-decay scan, would write and read every increment: ~0.5 GB
// more of traffic at the layer shape).  The slabs leave and return through
// a shared-memory staging tile in whole rows.
//
// Thirteen launches on one stream, each deterministic (no atomics, every
// cross-block sum in a fixed order; two calls give the same bits):
//   1-2. gates, chain (one block per chunk and b*h): cum, m_comb,
//        scale_in, wk, decay, as mlstm_chunk_wgmma.cu's a1/a2;
//   3. prep (one block per 256 columns, chunk and b*h): k o wk rounded to
//      bf16 into scratch, and the chunk's float32 n increment from the
//      unrounded values;
//   4. n scan (one block per 128 columns and b*h): n entering each chunk;
//   5. forward carry: C entering each chunk as the hi / lo slabs;
//   6. scores (one block per 128 rows x TN keys of the causal triangle):
//      S = q k^T and dh v^T over P, float32 into scratch;
//   7. rows (one block per 32 rows of a chunk and b*h, a warp per row): a,
//      den, beta; A = S o W and dS = dA o W rounded to bf16 over the row
//      (zeros above the diagonal); E's row sums and the block's column
//      sums; scale_in q and dnum = dh / den rounded to bf16; the block's
//      float32 part of the G_n increment;
//   8. G_n scan (one block per 128 columns and b*h): G_n leaving each
//      chunk (the increment's block parts summed in order) and the block's
//      part of <G_n, n> for d decay;
//   9. reverse carry: G_C leaving each chunk as a bf16 slab, and <G_C, C>
//      per tile;
//   10-12. dq, dk, dv (one block per 128 rows x TN columns, chunk and b*h,
//      all chunks at once; two consumer warpgroups and a producer warp):
//        dq = dS k + scale_in (C dnum + n beta),
//        dk = dS^T q + wk (G_C v + G_n),
//        dv = A^T dnum + G_C^T (k o wk);
//      the carry product (K = P) first, its rank-one term, dscale_in's or
//      dwk's per-tile partial and its row scale in the epilogue, then the
//      causal chunk product (K = the keys the rows see) into the same
//      accumulators;
//   13. gate grads (one block per chunk and b*h): every partial sum in
//      block or tile order, d logi, d logf.
// Every product is a wgmma with float32 accumulators on TMA-staged
// 128-byte-swizzled 64 x 64 bf16 boxes (hopper.cuh), K-major or MN-major
// (the transpose bits) as the operand lies in memory.  The row, gate and
// rank-one passes are float32 FMAs: O(S chunk) and O(S P) work.
//
// bf16 roundings, each where a product reads the operand and nowhere else
// (ref.mlstm_chunkwise_grads(..., operand_dtype=torch.bfloat16,
// grad_operand_dtype=torch.bfloat16) rounds at the same places):
//   the forward's, as mlstm_chunk_bwd.cu makes them: A = S o W in A^T
//     dnum, k o wk in the forward carry and in G_C^T (k o wk), the carried
//     C (not n) in C dnum;
//   the backward's own: dnum = dh / den in the reverse carry, in C dnum
//     and in A^T dnum; scale_in o q in the reverse carry; dS in dS k and
//     dS^T q; G_C in G_C v and G_C^T (k o wk).
// S = q k^T and dh v^T read bf16 inputs and gain no rounding.  n, G_n,
// beta, the rank-one terms, d decay (unrounded G_C), every gate term and
// every sum stay float32; dq, dk, dv are written in bf16.
//
// Scratch (one workspace, mlstm_chunk_bwd_wgmma_workspace bytes, carved
// here; 533.5 MB at the layer shape): float32 rows [B*H, 8, S], chunks
// [B*H, 3, n], vectors [B*H, 3, n, P], S and dh v^T [B*H, S, chunk] each,
// partials [B*H, 2, P/TN, S], [B*H, n, (P/TN)^2], [B*H, n, P/128], [B*H,
// n, chunk/32, chunk] and [B*H, n, chunk/32, P]; bf16 k o wk, scale_in q,
// dnum [B, S, H, P] each, A and dS [B, S, H, chunk] each, hi, lo and G_C
// [B*H, max(n - 1, 1), P, P] each.  q, k, v, dh are read by TMA in place (16-byte aligned, strides a
// multiple of 8 elements), h through its strides; dq, dk, dv are written
// contiguous [B, S, H, P] bf16, d logi, d logf contiguous [B, S, H]
// float32.

#include "hopper.cuh"  // kernels/include: shared with the forwards

namespace {

using namespace hopper;
using namespace hopper_host;

constexpr float kNegInf = -1e30f;  // the Pallas kernel's NEG_INF
constexpr int kBox = 64;           // rows and columns of every TMA box
constexpr int kBoxElems = kBox * kBox;
constexpr uint32_t kBoxBytes = kBoxElems * 2;
constexpr int kThreads = 256;      // the FMA passes
constexpr int kWarps = kThreads / 32;
constexpr int kMaxChunk = 1024;
constexpr int kSmemLimit = 232448; // a block's shared memory on sm_90
constexpr int kOutRows = 128;      // rows of an output block: 2 warpgroups
constexpr int kOutThreads = 2 * 128 + 32;
constexpr int kOutStages = 4;
constexpr int kCarryStages = 3;
constexpr int kRowsBlock = 32;     // rows of a chunk per rows-pass block

// rows [B*H, kRowArrays, S]; chunks [B*H, kChunkArrays, n]; vectors
// [B*H, kVecArrays, n, P]
enum { kCum, kLi, kMc, kSc, kWk, kDen, kBeta, kErow, kRowArrays };
enum { kDecay, kTotal, kG, kChunkArrays };
enum { kDn, kNin, kGn, kVecArrays };
// the products of the output kernel
enum { kScores, kDQ, kDK, kDV };

struct Strides {
  long long b, s, h;               // in elements; the P stride is 1
};

struct Params {
  const __nv_bfloat16* q;
  const __nv_bfloat16* k;
  const __nv_bfloat16* v;
  const __nv_bfloat16* h;          // the forward's output
  const __nv_bfloat16* dh;
  const float* li;                 // [B, S, H]
  const float* lf;
  __nv_bfloat16* dq;               // [B, S, H, P], contiguous
  __nv_bfloat16* dk;
  __nv_bfloat16* dv;
  float* dli;                      // [B, S, H], contiguous
  float* dlf;
  float* rows;
  float* chunks;
  float* vecs;
  float* sc;                       // [B*H, S, C]: S
  float* dsc;                      // [B*H, S, C]: dh v^T
  float* part;                     // [B*H, 2, P / TN, S]: dscale_in, dwk
  float* dpart;                    // [B*H, n, (P / TN)^2]: <G_C, C>
  float* ndot;                     // [B*H, n, P / 128]: <G_n, n> by block
  float* ecp;                      // [B*H, n, R, C]: E's column sums
  float* gnp;                      // [B*H, n, R, P]: G_n increments
  __nv_bfloat16* kw;               // [B, S, H, P]: k o wk
  __nv_bfloat16* sq;               //   scale_in q
  __nv_bfloat16* dn;               //   dnum
  __nv_bfloat16* amat;             // [B, S, H, C]: A = S o W
  __nv_bfloat16* dsm;              //   dS
  __nv_bfloat16* hi;               // [B*H, slabs, P, P]: C entering t + 1
  __nv_bfloat16* lo;
  __nv_bfloat16* gc;               //   G_C leaving t
  Strides qs, ks, vs, hs, dhs, is, fs;
  int H, S, P, C, n, slabs, TN, R;   // R: rows-pass blocks per chunk
};

__device__ __forceinline__ float* row_array(const Params& p, int bh,
                                            int which) {
  return p.rows + ((long long)bh * kRowArrays + which) * p.S;
}

__device__ __forceinline__ float* chunk_array(const Params& p, int bh,
                                              int which) {
  return p.chunks + ((long long)bh * kChunkArrays + which) * p.n;
}

// [n, P] of one b*h
__device__ __forceinline__ float* vec_array(const Params& p, int bh,
                                            int which) {
  return p.vecs + ((long long)bh * kVecArrays + which) * p.n * p.P;
}

template <typename T>
__device__ __forceinline__ const T* bhd(const T* base, const Strides& st,
                                        int bh, int H) {
  const int b = bh / H, h = bh - b * H;
  return base + b * st.b + h * st.h;
}

// element offset of (s, col) of one b*h in a contiguous [B, S, H, W] tensor
__device__ __forceinline__ long long dense(const Params& p, int bh, int s,
                                           int W) {
  const int b = bh / p.H, h = bh - b * p.H;
  return (((long long)b * p.S + s) * p.H + h) * W;
}

__device__ __forceinline__ float bf(__nv_bfloat16 x) {
  return __bfloat162float(x);
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

// the block's sum (max) of x, warps then the warps' partials in order;
// every thread gets it
__device__ __forceinline__ float block_sum(float x, float* red) {
  const int warps = blockDim.x / 32;
  x = warp_sum(x);
  if (threadIdx.x % 32 == 0) red[threadIdx.x / 32] = x;
  __syncthreads();
  float r = red[0];
  for (int w = 1; w < warps; ++w) r += red[w];
  __syncthreads();                 // red may be written again
  return r;
}

__device__ __forceinline__ float block_max(float x, float* red) {
  const int warps = blockDim.x / 32;
  x = warp_max(x);
  if (threadIdx.x % 32 == 0) red[threadIdx.x / 32] = x;
  __syncthreads();
  float r = red[0];
  for (int w = 1; w < warps; ++w) r = fmaxf(r, red[w]);
  __syncthreads();
  return r;
}

// acc (+)= A . B over one k16 step, N = TN
template <int TN, int TransA, int TransB>
__device__ __forceinline__ void mma_k16(float (&acc)[TN / 2], uint64_t da,
                                        uint64_t db) {
  if constexpr (TN == 128)
    wgmma_m64n128k16_ss<TransA, TransB>(acc, da, db, 1);
  else
    wgmma_m64n64k16_ss<TransA, TransB>(acc, da, db, 1);
}

// A of one warpgroup (64 rows) from the stage's A box `wg`, B from the
// stage's TN / 64 B boxes, over the four k16 steps of a 64-deep box: a
// K-major operand is a box of 64 rows x 64 K columns, an MN-major one a
// box of 64 K rows x 64 columns (the transpose bit set)
template <int TN, int TransA, int TransB>
__device__ __forceinline__ void mma_box(float (&acc)[TN / 2],
                                        const __nv_bfloat16* a,
                                        const __nv_bfloat16* b) {
#pragma unroll
  for (int kk = 0; kk < kBox / 16; ++kk) {
    const uint64_t da = TransA
        ? desc_sw128(a + kk * 16 * kBox, kBoxBytes, 1024)
        : desc_sw128(a + kk * 16, 16, 1024);
    const uint64_t db = TransB
        ? desc_sw128(b + kk * 16 * kBox, kBoxBytes, 1024)
        : desc_sw128(b + kk * 16, 16, 1024);
    mma_k16<TN, TransA, TransB>(acc, da, db);
  }
}

// ---------------------------------------------------------------------------
// 1-2. the stabilisers from the gates (mlstm_chunk_wgmma.cu's a1/a2)
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(kThreads)
mlstm_bwd_wgmma_gates_kernel(const Params p) {
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
  float* li = row_array(p, bh, kLi);
  float* mloc = row_array(p, bh, kMc);
  const float total = sCum[C - 1];
  float gm = kNegInf;
  for (int i = tid; i < C; i += kThreads) {
    const float ci = sCum[i];
    float m = kNegInf;
    for (int j = 0; j <= i; ++j) m = fmaxf(m, (ci - sCum[j]) + sLi[j]);
    cum[s0 + i] = ci;
    li[s0 + i] = sLi[i];
    mloc[s0 + i] = m;
    gm = fmaxf(gm, (total - ci) + sLi[i]);
  }
  gm = block_max(gm, red);
  if (tid == 0) {
    chunk_array(p, bh, kTotal)[t] = total;
    chunk_array(p, bh, kG)[t] = gm;
  }
}

__global__ void __launch_bounds__(kThreads)
mlstm_bwd_wgmma_chain_kernel(const Params p) {
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
  const float* cum = row_array(p, bh, kCum);
  const float* li = row_array(p, bh, kLi);
  float* mc = row_array(p, bh, kMc);
  float* sc = row_array(p, bh, kSc);
  float* wk = row_array(p, bh, kWk);
  for (int s = s0 + tid; s < s0 + C; s += kThreads) {
    const float ci = cum[s];
    const float m_comb = fmaxf(fmaxf(mc[s], ci + m_prev), kNegInf);
    mc[s] = m_comb;
    sc[s] = expf((ci + m_prev) - m_comb);
    wk[s] = expf(((total - ci) + li[s]) - m_new);
  }
}

// ---------------------------------------------------------------------------
// 3-4. k o wk, and n entering each chunk
// ---------------------------------------------------------------------------

// one block per (256 columns, chunk, b*h): a thread per 8 columns (16-byte
// loads and stores) and one of 8 row lanes; the column sums of the
// unrounded k o wk over the chunk's rows, in row order per lane, then the
// lanes in order
constexpr int kPrepLanes = kThreads / 32;
__global__ void __launch_bounds__(kThreads)
mlstm_bwd_wgmma_prep_kernel(const Params p) {
  __shared__ float red[kPrepLanes][32 * 8];
  const int tid = threadIdx.x, cg = tid % 32, rl = tid / 32;
  const int c = blockIdx.x * 256 + cg * 8, t = blockIdx.y, bh = blockIdx.z;
  const bool live = c < p.P;       // P 64, 128: idle column groups
  const __nv_bfloat16* kb = bhd(p.k, p.ks, bh, p.H);
  const float* wk = row_array(p, bh, kWk);
  float acc[8];
#pragma unroll
  for (int e = 0; e < 8; ++e) acc[e] = 0.f;
  for (int i = rl; live && i < p.C; i += kPrepLanes) {
    const int s = t * p.C + i;
    const float w = wk[s];
    uint4 raw = *reinterpret_cast<const uint4*>(kb + (long long)s * p.ks.s
                                                + c);
    uint32_t* wds = reinterpret_cast<uint32_t*>(&raw);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float2 f = __bfloat1622float2(
          *reinterpret_cast<const __nv_bfloat162*>(&wds[e]));
      const float x0 = f.x * w, x1 = f.y * w;
      acc[2 * e] += x0;
      acc[2 * e + 1] += x1;
      wds[e] = pack_bf16x2(x0, x1);
    }
    *reinterpret_cast<uint4*>(p.kw + dense(p, bh, s, p.P) + c) = raw;
  }
#pragma unroll
  for (int e = 0; e < 8; ++e) red[rl][cg * 8 + e] = acc[e];
  __syncthreads();
  if (rl == 0 && live) {
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      float sum = red[0][cg * 8 + e];
      for (int r = 1; r < kPrepLanes; ++r) sum += red[r][cg * 8 + e];
      vec_array(p, bh, kDn)[(long long)t * p.P + c + e] = sum;
    }
  }
}

// one block per (128 columns, b*h), a thread per column: forward (kRev
// false), n entering chunk t, n <- decay n + dn_t; reverse, G_n leaving
// chunk t and the block's part of <G_n, n> (its columns in order; the gate
// grads add the blocks in order), G_n <- decay G_n + dG_n (dG_n: the rows
// pass's R block partials, in order)
constexpr int kVecCols = 128;
template <bool kRev>
__global__ void __launch_bounds__(kVecCols)
mlstm_bwd_wgmma_vscan_kernel(const Params p) {
  __shared__ float red[kVecCols / 32];
  const int bh = blockIdx.y, tid = threadIdx.x, n = p.n, P = p.P;
  const int c = blockIdx.x * kVecCols + tid;
  const bool live = c < P;             // P 64: half the threads idle
  const float* decay = chunk_array(p, bh, kDecay);
  const float* inc = vec_array(p, bh, kDn);
  const float* gnp = p.gnp + (long long)bh * n * p.R * P;
  float* out = vec_array(p, bh, kRev ? kGn : kNin);
  const float* nin = vec_array(p, bh, kNin);
  float run = 0.f;
  for (int step = 0; step < n; ++step) {
    const int t = kRev ? n - 1 - step : step;
    const float dcy = decay[t];
    float dot = 0.f, add = 0.f;
    if (live) {
      out[(long long)t * P + c] = run;
      if (kRev) {
        dot = run * nin[(long long)t * P + c];
        const float* part = gnp + (long long)t * p.R * P + c;
        add = part[0];
        for (int r = 1; r < p.R; ++r) add += part[(long long)r * P];
      } else {
        add = inc[(long long)t * P + c];
      }
      run = run * dcy + add;
    }
    if (kRev) {
      dot = block_sum(dot, red);
      if (tid == 0)
        p.ndot[((long long)bh * n + t) * gridDim.x + blockIdx.x] = dot;
    }
  }
}

// ---------------------------------------------------------------------------
// 5, 9. the carries: one block per (TN x TN tile of C or G_C, b*h) walks
// the chunks, its tile in wgmma accumulators
// ---------------------------------------------------------------------------

// forward (kRev false): C <- decay C + (k o wk)^T v, A = k o wk and B = v
// both MN-major (time-major in memory); stores C entering chunk t + 1 as
// hi / lo.  reverse: G_C <- decay G_C + (scale_in q)^T dnum; stores G_C
// leaving chunk t - 1 and dots it with hi and lo of C entering chunk t - 1.
// TN / 64 warpgroups (64 rows of the tile each); thread 0 keeps the ring's
// TMA loads kCarryStages deep, refilling a stage once every warpgroup is
// done with it.  In the reverse carry each chunk's items are its product
// steps, then the hi and the lo tile of C, TMA boxes in two more stages:
// read ahead of the dot like the operands (read by the threads when the
// dot came, they held the reverse carry up).  A slab goes out through a
// consumed stage reused as a staging tile (16-byte groups XOR-swizzled by
// row: no bank conflicts), in whole 16-byte groups of rows: written
// straight from the accumulators, a thread's scattered stores cost more
// than the products.
// Two blocks an SM: the 64 tiles of a b*h at P 1024 fill the card in one
// wave at B*H = 4.
template <int TN, bool kRev>
__global__ void __launch_bounds__(TN / kBox * 128, 2)
mlstm_bwd_wgmma_carry_kernel(const __grid_constant__ CUtensorMap tm_a,
                             const __grid_constant__ CUtensorMap tm_b,
                             const __grid_constant__ CUtensorMap tm_hi,
                             const __grid_constant__ CUtensorMap tm_lo,
                             const Params p) {
  constexpr int NBX = TN / kBox;
  constexpr int ST = kCarryStages;
  constexpr uint32_t kStageBytes = 2 * NBX * kBoxBytes;
  constexpr uint32_t kSlabBytes = NBX * NBX * kBoxBytes;   // a C tile
  constexpr int IPS_EXTRA = kRev ? 2 : 0;                  // hi, lo items
  extern __shared__ unsigned char smem_raw[];
  unsigned char* base =
      smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(base + ST * kStageBytes);
  float* red = reinterpret_cast<float*>(full + ST);
  const auto a_of = [&](int st) {
    return reinterpret_cast<__nv_bfloat16*>(base + st * kStageBytes);
  };
  const auto b_of = [&](int st) { return a_of(st) + NBX * kBoxElems; };

  const int pc0 = blockIdx.x * TN;     // columns (of v, of dnum)
  const int pr0 = blockIdx.y * TN;     // rows (of k o wk, of scale_in q)
  const int bh = blockIdx.z, b = bh / p.H, h = bh - b * p.H;
  const int n = p.n, P = p.P, JB = p.C / kBox, IPS = JB + IPS_EXTRA;
  const int G = (n - 1) * IPS;         // one carry product fewer than chunks
  const int tid = threadIdx.x, wg = tid / 128, lane = tid % 32;
  const auto chunk_of = [&](int g) {
    return kRev ? n - 1 - g / IPS : g / IPS;
  };

  if (tid == 0) {
    for (int s = 0; s < ST; ++s) mbar_init(&full[s], 1);
    fence_barrier_init();
  }
  __syncthreads();
  const auto load = [&](int g) {
    const int st = g % ST, k = g % IPS, t = chunk_of(g);
    if (k < JB) {                      // a product step: A and B boxes
      const int j0 = t * p.C + k * kBox;
      mbar_expect_tx(&full[st], kStageBytes);
#pragma unroll
      for (int x = 0; x < NBX; ++x) {
        tma_load_4d(a_of(st) + x * kBoxElems, &tm_a, &full[st],
                    pr0 + kBox * x, j0, h, b);
        tma_load_4d(b_of(st) + x * kBoxElems, &tm_b, &full[st],
                    pc0 + kBox * x, j0, h, b);
      }
    } else {                           // the hi or lo tile of C entering
      // chunk t - 1 (slab t - 2; C entering chunk 0 is 0 and slab 0 is
      // read in its place, unused)
      const int slab = t >= 2 ? t - 2 : 0;
      const CUtensorMap* map = k == JB ? &tm_hi : &tm_lo;
      mbar_expect_tx(&full[st], kSlabBytes);
#pragma unroll
      for (int y = 0; y < NBX; ++y)
#pragma unroll
        for (int x = 0; x < NBX; ++x)
          tma_load_4d(a_of(st) + (y * NBX + x) * kBoxElems, map, &full[st],
                      pc0 + kBox * x, pr0 + kBox * y, slab, bh);
    }
  };
  if (tid == 0)
    for (int g = 0; g < min(ST, G); ++g) load(g);

  const float* decay = chunk_array(p, bh, kDecay);
  float acc[TN / 2];
#pragma unroll
  for (int i = 0; i < TN / 2; ++i) acc[i] = 0.f;
  // this thread's accumulator rows lrow (+ 8) and columns lcol (+ 1,
  // + 8 j) in its warpgroup's 64 x TN part of the tile; their byte offsets
  // in a staging tile (row-major, 16-byte groups swizzled by row) and in
  // the warpgroup's TMA boxes (64 x 64 each, 128-byte swizzle)
  const int lrow = (tid % 128 / 32) * 16 + lane / 4, lcol = 2 * (lane % 4);
  const int sw = lrow % 8;
  const auto stg_at = [&](int rr, int j) {
    return (uint32_t)((lrow + 8 * rr) * (TN * 2) + ((j ^ sw) << 4)
                      + lcol * 2);
  };
  const auto box_at = [&](int rr, int j) {
    return (uint32_t)((wg * NBX + j / 8) * kBoxBytes + (lrow + 8 * rr) * 128
                      + (((j % 8) ^ sw) << 4) + lcol * 2);
  };
  // the warpgroup's 64 rows of a row-major [P, P] slab from staging
  const auto rows_out = [&](unsigned char* stg, __nv_bfloat16* slab) {
    __syncthreads();
    for (int x = tid % 128; x < 64 * TN / 8; x += 128) {
      const int r = x / (TN / 8), c8 = x % (TN / 8);
      *reinterpret_cast<uint4*>(slab + (long long)(pr0 + wg * 64 + r) * P
                                + pc0 + c8 * 8) =
          *reinterpret_cast<const uint4*>(stg + r * (TN * 2)
                                          + ((c8 ^ (r % 8)) << 4));
    }
    __syncthreads();                   // staging is read
  };
  // the accumulators, rounded (lo: their remainders after hi), to staging
  const auto to_staging = [&](unsigned char* stg, bool remainder) {
#pragma unroll
    for (int rr = 0; rr < 2; ++rr)
#pragma unroll
      for (int j = 0; j < TN / 8; ++j) {
        const float x0 = acc[4 * j + 2 * rr], x1 = acc[4 * j + 2 * rr + 1];
        uint32_t v = pack_bf16x2(x0, x1);
        if (remainder) {
          const float2 hv = __bfloat1622float2(
              *reinterpret_cast<const __nv_bfloat162*>(&v));
          v = pack_bf16x2(x0 - hv.x, x1 - hv.y);
        }
        *reinterpret_cast<uint32_t*>(stg + stg_at(rr, j)) = v;
      }
  };
  float dot = 0.f;

  for (int g = 0; g < G; ++g) {
    const int st = g % ST, k = g % IPS, t = chunk_of(g);
    unsigned char* sb = reinterpret_cast<unsigned char*>(a_of(st));
    if (k == 0) {                      // a new chunk: the carry decays
      const float dcy = decay[t];
#pragma unroll
      for (int i = 0; i < TN / 2; ++i) acc[i] *= dcy;
    }
    mbar_wait(&full[st], (g / ST) & 1);
    const int slab = kRev ? t - 1 : t;
    const long long at = ((long long)bh * p.slabs + slab) * P * P;
    if (k < JB) {
      wgmma_fence();
      mma_box<TN, 1, 1>(acc, a_of(st) + wg * kBoxElems, b_of(st));
      wgmma_commit();
      wgmma_wait<0>();
      fence_operands(acc);
      __syncthreads();                 // stage st is read
      if (!kRev && k == JB - 1) {      // C entering chunk t + 1: hi, lo
        unsigned char* stg = sb + wg * 64 * TN * 2;
        to_staging(stg, false);
        rows_out(stg, p.hi + at);
        to_staging(stg, true);
        rows_out(stg, p.lo + at);
      }
    } else {                           // the dot with C's hi or lo tile
      if (slab >= 1) {
#pragma unroll
        for (int rr = 0; rr < 2; ++rr)
#pragma unroll
          for (int j = 0; j < TN / 8; ++j) {
            const float2 cv = __bfloat1622float2(
                *reinterpret_cast<const __nv_bfloat162*>(sb + box_at(rr, j)));
            dot = fmaf(acc[4 * j + 2 * rr], cv.x, dot);
            dot = fmaf(acc[4 * j + 2 * rr + 1], cv.y, dot);
          }
      }
      if (k == IPS - 1) {              // G_C leaving chunk t - 1, out
        if (slab >= 1) {
          dot = block_sum(dot, red);   // also: the tile's reads are done
          if (tid == 0)
            p.dpart[((long long)bh * n + slab) * gridDim.x * gridDim.y
                    + blockIdx.y * gridDim.x + blockIdx.x] = dot;
        }
        dot = 0.f;
        __syncthreads();
        unsigned char* stg = sb + wg * 64 * TN * 2;
        to_staging(stg, false);
        rows_out(stg, p.gc + at);
      } else {
        __syncthreads();               // stage st is read
      }
    }
    if (tid == 0 && g + ST < G) load(g + ST);
  }
}

// ---------------------------------------------------------------------------
// 7. per row: a, den, beta; A, dS, E over the row; scale_in q, dnum, and
// the G_n increment
// ---------------------------------------------------------------------------

// one block per (32 rows of a chunk, chunk, b*h), a warp per row.
// Dynamic shared memory: cum, li [C]; n entering the chunk [P]; E's column
// partials [warps][C] and the G_n partials [warps][P] of each warp, summed
// over the warps in order into the block's partials (ecp, gnp), which the
// gate grads and the G_n scan sum over the blocks in order
__host__ __device__ constexpr int rows_smem(int C, int P) {
  return (2 * C + P + kWarps * (C + P)) * 4;
}

__global__ void __launch_bounds__(kThreads)
mlstm_bwd_wgmma_rows_kernel(const Params p) {
  extern __shared__ float srow[];
  const int C = p.C, P = p.P, bh = blockIdx.y;
  const int t = blockIdx.x / p.R, rb = blockIdx.x - t * p.R;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int t0 = t * C;
  float* sCum = srow;
  float* sLi = sCum + C;
  float* sN = sLi + C;
  float* ecw = sN + P + warp * C;                    // this warp's
  float* gnw = sN + P + kWarps * C + warp * P;
  const float* cum = row_array(p, bh, kCum);
  const float* li = row_array(p, bh, kLi);
  const float* nin = vec_array(p, bh, kNin) + (long long)t * P;
  for (int i = tid; i < C; i += kThreads) {
    sCum[i] = cum[t0 + i];
    sLi[i] = li[t0 + i];
  }
  for (int c = tid; c < P; c += kThreads) sN[c] = nin[c];
  for (int i = lane; i < C; i += 32) ecw[i] = 0.f;
  for (int c = lane; c < P; c += 32) gnw[c] = 0.f;
  __syncthreads();
  const __nv_bfloat16* qb = bhd(p.q, p.qs, bh, p.H);
  const __nv_bfloat16* hb = bhd(p.h, p.hs, bh, p.H);
  const __nv_bfloat16* dhb = bhd(p.dh, p.dhs, bh, p.H);
  const float* mc = row_array(p, bh, kMc);
  const float* scr = row_array(p, bh, kSc);
  // a lane takes 8 columns of P (16-byte loads) and 4 of the chunk's keys
  // at a time
  for (int i = rb * kRowsBlock + warp; i < (rb + 1) * kRowsBlock;
       i += kWarps) {
    const int s = t0 + i;
    const __nv_bfloat16* qr = qb + (long long)s * p.qs.s;
    const __nv_bfloat16* dhr = dhb + (long long)s * p.dhs.s;
    const __nv_bfloat16* hr = hb + (long long)s * p.hs.s;
    float qn = 0.f, dhh = 0.f;
    for (int c = lane * 8; c < P; c += 256) {
      const uint4 qv = *reinterpret_cast<const uint4*>(qr + c);
      const uint4 dv = *reinterpret_cast<const uint4*>(dhr + c);
      const uint4 hv = *reinterpret_cast<const uint4*>(hr + c);
      const __nv_bfloat162* q2 = reinterpret_cast<const __nv_bfloat162*>(&qv);
      const __nv_bfloat162* d2 = reinterpret_cast<const __nv_bfloat162*>(&dv);
      const __nv_bfloat162* h2 = reinterpret_cast<const __nv_bfloat162*>(&hv);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float2 qf = __bfloat1622float2(q2[e]);
        const float2 df = __bfloat1622float2(d2[e]);
        const float2 hf = __bfloat1622float2(h2[e]);
        qn = fmaf(qf.x, sN[c + 2 * e], qn);
        qn = fmaf(qf.y, sN[c + 2 * e + 1], qn);
        dhh = fmaf(df.x, hf.x, dhh);
        dhh = fmaf(df.y, hf.y, dhh);
      }
    }
    qn = warp_sum(qn);
    dhh = warp_sum(dhh);
    const float ci = sCum[i], mci = mc[s], scs = scr[s];
    const float* sr = p.sc + ((long long)bh * p.S + s) * C;
    const float* dsr = p.dsc + ((long long)bh * p.S + s) * C;
    float rs = 0.f;
    for (int j0 = lane * 4; j0 <= i; j0 += 128) {
      const float4 sv = *reinterpret_cast<const float4*>(sr + j0);
      const float x[4] = {sv.x, sv.y, sv.z, sv.w};
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (j0 + e <= i)
          rs += x[e] * expf(((ci - sCum[j0 + e]) + sLi[j0 + e]) - mci);
    }
    rs = warp_sum(rs);
    const float a = rs + scs * qn;
    const float floor = expf(-mci);
    const float den = fmaxf(fabsf(a), floor);
    const float beta = fabsf(a) > floor
        ? (-copysignf(1.f, a) * dhh) / den : 0.f;
    __nv_bfloat16* ar = p.amat + dense(p, bh, s, C);
    __nv_bfloat16* dsw = p.dsm + dense(p, bh, s, C);
    float es = 0.f;
    for (int j0 = lane * 4; j0 < C; j0 += 128) {
      float av[4] = {0.f, 0.f, 0.f, 0.f}, ds[4] = {0.f, 0.f, 0.f, 0.f};
      if (j0 <= i) {
        const float4 sv = *reinterpret_cast<const float4*>(sr + j0);
        const float4 dv = *reinterpret_cast<const float4*>(dsr + j0);
        const float x[4] = {sv.x, sv.y, sv.z, sv.w};
        const float y[4] = {dv.x, dv.y, dv.z, dv.w};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int j = j0 + e;
          if (j <= i) {
            const float w = expf(((ci - sCum[j]) + sLi[j]) - mci);
            av[e] = x[e] * w;
            const float da = y[e] / den + beta;
            const float ee = da * av[e];
            ds[e] = da * w;
            es += ee;
            ecw[j] += ee;
          }
        }
      }
      *reinterpret_cast<uint2*>(ar + j0) =
          make_uint2(pack_bf16x2(av[0], av[1]), pack_bf16x2(av[2], av[3]));
      *reinterpret_cast<uint2*>(dsw + j0) =
          make_uint2(pack_bf16x2(ds[0], ds[1]), pack_bf16x2(ds[2], ds[3]));
    }
    es = warp_sum(es);
    const long long o = dense(p, bh, s, P);
    for (int c = lane * 8; c < P; c += 256) {
      const uint4 qv = *reinterpret_cast<const uint4*>(qr + c);
      const uint4 dv = *reinterpret_cast<const uint4*>(dhr + c);
      const __nv_bfloat162* q2 = reinterpret_cast<const __nv_bfloat162*>(&qv);
      const __nv_bfloat162* d2 = reinterpret_cast<const __nv_bfloat162*>(&dv);
      uint4 sqv, dnv;
      uint32_t* sqw = reinterpret_cast<uint32_t*>(&sqv);
      uint32_t* dnw = reinterpret_cast<uint32_t*>(&dnv);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float2 qf = __bfloat1622float2(q2[e]);
        const float2 df = __bfloat1622float2(d2[e]);
        const float x0 = scs * qf.x, x1 = scs * qf.y;
        sqw[e] = pack_bf16x2(x0, x1);
        dnw[e] = pack_bf16x2(df.x / den, df.y / den);
        gnw[c + 2 * e] = fmaf(x0, beta, gnw[c + 2 * e]);
        gnw[c + 2 * e + 1] = fmaf(x1, beta, gnw[c + 2 * e + 1]);
      }
      *reinterpret_cast<uint4*>(p.sq + o + c) = sqv;
      *reinterpret_cast<uint4*>(p.dn + o + c) = dnv;
    }
    if (lane == 0) {
      row_array(p, bh, kDen)[s] = den;
      row_array(p, bh, kBeta)[s] = beta;
      row_array(p, bh, kErow)[s] = es;
    }
  }
  __syncthreads();                 // every warp's partials written
  const long long blk = ((long long)bh * p.n + t) * p.R + rb;
  const float* ec0 = sN + P;
  for (int j = tid; j < C; j += kThreads) {
    float sum = ec0[j];
    for (int w = 1; w < kWarps; ++w) sum += ec0[w * C + j];
    p.ecp[blk * C + j] = sum;
  }
  const float* gn0 = sN + P + kWarps * C;
  for (int c = tid; c < P; c += kThreads) {
    float sum = gn0[c];
    for (int w = 1; w < kWarps; ++w) sum += gn0[w * P + c];
    p.gnp[blk * P + c] = sum;
  }
}

// ---------------------------------------------------------------------------
// 6, 10-12. the output products: one block per (128 rows, TN columns,
// chunk, b*h), two consumer warpgroups (64 rows each) and a producer warp
// whose lane 0 streams every 64-deep step's boxes by TMA through a ring
// ---------------------------------------------------------------------------

// the ring: per stage two A boxes (one per warpgroup) and TN / 64 B boxes,
// then the full and empty barriers, from a 1024-aligned base
template <int TN>
struct OutRing {
  static constexpr int kBBoxes = TN / kBox;
  static constexpr int kStageElems = (2 + kBBoxes) * kBoxElems;
  static constexpr uint32_t kStageBytes = (2 + kBBoxes) * kBoxBytes;
  static constexpr int kBytes = kOutStages * kStageBytes + 2 * kOutStages * 8;
};

// The two products of each kind, (A, B) with K the box's 64-deep steps:
//   kScores: q k^T (K = P), then dh v^T (K = P); each stored float32;
//   kDQ: dnum C^T (hi slab t - 1, K = P), then dS k (K = keys <= row);
//   kDK: v G_C^T (G slab t, K = P), then dS^T q (K = rows >= key);
//   kDV: (k o wk) G_C (K = P), then A^T dnum (K = rows >= key).
// Operands lying K-contiguous in memory are K-major boxes, the others
// MN-major: TransB of the first product for kDV; both of the second for
// kDK and kDV, B of the second for kDQ.
template <int Kind, int TN>
__global__ void __launch_bounds__(kOutThreads, 1)
mlstm_bwd_wgmma_out_kernel(const __grid_constant__ CUtensorMap tm_a1,
                     const __grid_constant__ CUtensorMap tm_b1,
                     const __grid_constant__ CUtensorMap tm_a2,
                     const __grid_constant__ CUtensorMap tm_b2,
                     const Params p) {
  using R = OutRing<TN>;
  constexpr int NB = R::kBBoxes;
  constexpr int TB1 = Kind == kDV;
  constexpr int TA2 = Kind == kDK || Kind == kDV;
  constexpr int TB2 = Kind != kScores;
  constexpr int ST = kOutStages;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* base =
      smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  __nv_bfloat16* ring = reinterpret_cast<__nv_bfloat16*>(base);
  uint64_t* full = reinterpret_cast<uint64_t*>(base + ST * R::kStageBytes);
  uint64_t* empty = full + ST;

  const int nct = (Kind == kScores ? p.C : p.P) / TN, nrb = p.C / kOutRows;
  const int rb_x = blockIdx.x / nct, ct = blockIdx.x - rb_x * nct;
  const int t = blockIdx.y, bh = blockIdx.z;
  const int b = bh / p.H, h = bh - b * p.H;
  const int n = p.n, t0 = t * p.C, PB = p.P / kBox;
  // the rows of the most keys first: the last for S and dq, the first for
  // dk and dv
  const int rb = (Kind == kScores || Kind == kDQ) ? nrb - 1 - rb_x : rb_x;
  const int r0 = rb * kOutRows, c0 = ct * TN;
  if (Kind == kScores && c0 > r0 + kOutRows - 1) return;  // above the diagonal
  const bool act1 = Kind == kScores || (Kind == kDQ ? t > 0 : t < n - 1);
  const int n1 = act1 ? PB : 0;
  const int k2lo = (Kind == kDK || Kind == kDV) ? r0 / kBox : 0;
  const int k2hi = Kind == kScores ? PB
      : Kind == kDQ ? (r0 + kOutRows) / kBox : p.C / kBox;
  const int tid = threadIdx.x;

  if (tid == 0) {
    for (int s = 0; s < ST; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 2 * 128);
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (tid >= 2 * 128) {                // the producer warp
    if (tid != 2 * 128) return;
    int g = 0;
    const auto acquire = [&]() {
      const int st = g % ST;
      mbar_wait(&empty[st], ((g / ST) & 1) ^ 1);
      mbar_expect_tx(&full[st], R::kStageBytes);
      ++g;
      return ring + st * R::kStageElems;
    };
    for (int kb = 0; kb < n1; ++kb) {
      __nv_bfloat16* a = acquire();
      __nv_bfloat16* bb = a + 2 * kBoxElems;
      uint64_t* bar = &full[(g - 1) % ST];
#pragma unroll
      for (int w = 0; w < 2; ++w)     // K-major rows of the block
        tma_load_4d(a + w * kBoxElems, &tm_a1, bar, kBox * kb,
                    t0 + r0 + kBox * w, h, b);
#pragma unroll
      for (int x = 0; x < NB; ++x) {
        __nv_bfloat16* dst = bb + x * kBoxElems;
        if (Kind == kScores)          // keys of the column tile, K-major
          tma_load_4d(dst, &tm_b1, bar, kBox * kb, t0 + c0 + kBox * x, h, b);
        else if (Kind == kDQ)         // hi[p][r], K = r: K-major
          tma_load_4d(dst, &tm_b1, bar, kBox * kb, c0 + kBox * x, t - 1, bh);
        else if (Kind == kDK)         // G_C[p][r], K = r: K-major
          tma_load_4d(dst, &tm_b1, bar, kBox * kb, c0 + kBox * x, t, bh);
        else                          // G_C[p][r], K = p: MN-major
          tma_load_4d(dst, &tm_b1, bar, c0 + kBox * x, kBox * kb, t, bh);
      }
    }
    for (int kb = k2lo; kb < k2hi; ++kb) {
      __nv_bfloat16* a = acquire();
      __nv_bfloat16* bb = a + 2 * kBoxElems;
      uint64_t* bar = &full[(g - 1) % ST];
#pragma unroll
      for (int w = 0; w < 2; ++w) {
        if (Kind == kScores || Kind == kDQ)   // dh / dS rows, K-major
          tma_load_4d(a + w * kBoxElems, &tm_a2, bar, kBox * kb,
                      t0 + r0 + kBox * w, h, b);
        else                                  // dS / A columns, MN-major
          tma_load_4d(a + w * kBoxElems, &tm_a2, bar, r0 + kBox * w,
                      t0 + kBox * kb, h, b);
      }
#pragma unroll
      for (int x = 0; x < NB; ++x) {
        __nv_bfloat16* dst = bb + x * kBoxElems;
        if (Kind == kScores)          // v rows of the column tile, K-major
          tma_load_4d(dst, &tm_b2, bar, kBox * kb, t0 + c0 + kBox * x, h, b);
        else                          // k / q / dnum rows, MN-major
          tma_load_4d(dst, &tm_b2, bar, c0 + kBox * x, t0 + kBox * kb, h, b);
      }
    }
    return;
  }

  // ---- the consumer warpgroups: warpgroup wg owns rows 64 wg .. + 64 ----
  const int wg = tid / 128, lane = tid % 32;
  const int lr = r0 + wg * 64 + (tid % 128 / 32) * 16 + lane / 4;  // + 8
  const int col0 = c0 + 2 * (lane % 4);
  int g = 0, held = -1;
  const auto take = [&]() {
    const int st = g % ST;
    mbar_wait(&full[st], (g / ST) & 1);
    ++g;
    return st;
  };
  // one step's products stay in flight while the next step's are issued
  const auto pipeline = [&](int st) {
    wgmma_commit();
    wgmma_wait<1>();
    if (held >= 0) mbar_arrive(&empty[held]);
    held = st;
  };
  const auto drain = [&]() {
    wgmma_wait<0>();
    if (held >= 0) mbar_arrive(&empty[held]);
    held = -1;
  };

  float acc[TN / 2];
#pragma unroll
  for (int i = 0; i < TN / 2; ++i) acc[i] = 0.f;
  for (int kb = 0; kb < n1; ++kb) {
    const int st = take();
    const __nv_bfloat16* a = ring + st * R::kStageElems;
    wgmma_fence();
    mma_box<TN, 0, TB1>(acc, a + wg * kBoxElems, a + 2 * kBoxElems);
    fence_operands(acc);
    pipeline(st);
  }
  drain();
  fence_operands(acc);

  // the first product's epilogue
  const auto store_f32 = [&](float* dst) {
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      float* row = dst + ((long long)bh * p.S + t0 + lr + 8 * rr) * p.C;
#pragma unroll
      for (int j = 0; j < TN / 8; ++j)
        *reinterpret_cast<float2*>(row + col0 + 8 * j) =
            make_float2(acc[4 * j + 2 * rr], acc[4 * j + 2 * rr + 1]);
    }
  };
  if (Kind == kScores) {
    store_f32(p.sc);
#pragma unroll
    for (int i = 0; i < TN / 2; ++i) acc[i] = 0.f;
  } else if (Kind == kDQ || Kind == kDK) {
    // x = C dnum + n beta (dq) or y = G_C v + G_n (dk); the row's partial
    // of q . x or k . y over the tile's columns; then scale_in x or wk y
    const float* vec = vec_array(p, bh, Kind == kDQ ? kNin : kGn)
        + (long long)t * p.P;
    const __nv_bfloat16* xb = Kind == kDQ ? bhd(p.q, p.qs, bh, p.H)
                                          : bhd(p.k, p.ks, bh, p.H);
    const long long xs = Kind == kDQ ? p.qs.s : p.ks.s;
    const float* beta = row_array(p, bh, kBeta);
    const float* scale = row_array(p, bh, Kind == kDQ ? kSc : kWk);
    float* part = p.part + (((long long)bh * 2 + (Kind == kDK)) * (p.P / TN)
                            + ct) * p.S;
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      const int s = t0 + lr + 8 * rr;
      const float bt = Kind == kDQ ? beta[s] : 1.f, sf = scale[s];
      const __nv_bfloat16* xr = xb + (long long)s * xs;
      float dot = 0.f;
#pragma unroll
      for (int j = 0; j < TN / 8; ++j) {
        const int c = col0 + 8 * j;
        const float2 xv = __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(xr + c));
        const float y0 = fmaf(vec[c], bt, acc[4 * j + 2 * rr]);
        const float y1 = fmaf(vec[c + 1], bt, acc[4 * j + 2 * rr + 1]);
        dot = fmaf(xv.x, y0, dot);
        dot = fmaf(xv.y, y1, dot);
        acc[4 * j + 2 * rr] = sf * y0;
        acc[4 * j + 2 * rr + 1] = sf * y1;
      }
      dot += __shfl_xor_sync(0xffffffffu, dot, 1);
      dot += __shfl_xor_sync(0xffffffffu, dot, 2);
      if (lane % 4 == 0) part[s] = dot;
    }
  }

  // the causal chunk product; a warpgroup skips the steps its 64 rows
  // cannot see (their operand is zero there)
  const int w0 = r0 + wg * 64;
  for (int kb = k2lo; kb < k2hi; ++kb) {
    const int st = take();
    const bool live = Kind == kScores ? true
        : Kind == kDQ ? kBox * kb <= w0 + 63 : kBox * kb + 63 >= w0;
    if (live) {
      const __nv_bfloat16* a = ring + st * R::kStageElems;
      wgmma_fence();
      mma_box<TN, TA2, TB2>(acc, a + wg * kBoxElems, a + 2 * kBoxElems);
      fence_operands(acc);
    }
    pipeline(st);
  }
  drain();
  fence_operands(acc);

  if (Kind == kScores) {
    store_f32(p.dsc);
    return;
  }
  __nv_bfloat16* out = Kind == kDQ ? p.dq : Kind == kDK ? p.dk : p.dv;
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    __nv_bfloat16* row = out + dense(p, bh, t0 + lr + 8 * rr, p.P);
#pragma unroll
    for (int j = 0; j < TN / 8; ++j)
      *reinterpret_cast<uint32_t*>(row + col0 + 8 * j) =
          pack_bf16x2(acc[4 * j + 2 * rr], acc[4 * j + 2 * rr + 1]);
  }
}

// ---------------------------------------------------------------------------
// 13. the gates' gradients: one block per (chunk, b*h)
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(kThreads)
mlstm_bwd_wgmma_gate_grads_kernel(const Params p) {
  __shared__ float sDcum[kMaxChunk], sF[kMaxChunk];
  const int C = p.C, t = blockIdx.x, bh = blockIdx.y, tid = threadIdx.x;
  const int t0 = t * C, npt = p.P / p.TN, n = p.n;
  const int b = bh / p.H, h = bh - b * p.H;
  const float* sc = row_array(p, bh, kSc);
  const float* wk = row_array(p, bh, kWk);
  const float* erow = row_array(p, bh, kErow);
  const float* ecp = p.ecp + ((long long)bh * n + t) * p.R * C;
  const float* dsp = p.part + (long long)bh * 2 * npt * p.S;
  const float* dwp = dsp + (long long)npt * p.S;
  for (int i = tid; i < C; i += kThreads) {
    const int s = t0 + i;
    float ds = 0.f, dwk = 0.f;
    for (int k = 0; k < npt; ++k) {
      ds += dsp[(long long)k * p.S + s];
      dwk += dwp[(long long)k * p.S + s];
    }
    float ecol = ecp[i];
    for (int r = 1; r < p.R; ++r) ecol += ecp[(long long)r * C + i];
    const float f = dwk * wk[s];
    p.dli[((long long)b * p.S + s) * p.H + h] = ecol + f;
    sDcum[i] = ((erow[s] - ecol) + ds * sc[s]) - f;
    sF[i] = f;
  }
  __syncthreads();
  if (tid == 0) {
    // d decay: <G_C, C> by tile in order (C entering chunk 0 and G_C
    // leaving the last are 0), then <G_n, n>
    const int tiles = npt * npt;
    const float* dd = p.dpart + ((long long)bh * n + t) * tiles;
    float ftot = 0.f, dcy = 0.f;
    for (int i = 0; i < C; ++i) ftot += sF[i];
    if (t >= 1 && t <= n - 2)
      for (int k = 0; k < tiles; ++k) dcy += dd[k];
    const int ncb = (p.P + kVecCols - 1) / kVecCols;
    for (int k = 0; k < ncb; ++k) dcy += p.ndot[((long long)bh * n + t) * ncb + k];
    sDcum[C - 1] += ftot + dcy * chunk_array(p, bh, kDecay)[t];
    float run = 0.f;
    for (int i = C - 1; i >= 0; --i) {
      run += sDcum[i];
      p.dlf[((long long)b * p.S + t0 + i) * p.H + h] = run;
    }
  }
}

// ---- host side ----------------------------------------------------------

// the workspace's pieces, each from a 1024-byte boundary
struct Workspace {
  long long rows, chunks, vecs, sc, dsc, part, dpart, ndot, ecp, gnp, kw, sq,
      dn, amat, dsm, hi, lo, gc, bytes;
  Workspace(int B, int S, int H, int P, int C) {
    const long long BH = (long long)B * H, n = S / C;
    const long long slabs = n > 1 ? n - 1 : 1, TN = P == 64 ? 64 : 128;
    const long long npt = P / TN;
    long long at = 0;
    const auto take = [&](long long nbytes) {
      const long long here = at;
      at += (nbytes + 1023) / 1024 * 1024;
      return here;
    };
    rows = take(BH * kRowArrays * S * 4);
    chunks = take(BH * kChunkArrays * n * 4);
    vecs = take(BH * kVecArrays * n * P * 4);
    sc = take(BH * S * C * 4);
    dsc = take(BH * S * C * 4);
    part = take(BH * 2 * npt * S * 4);
    dpart = take(BH * n * npt * npt * 4);
    ndot = take(BH * n * ((P + kVecCols - 1) / kVecCols) * 4);
    ecp = take(BH * S / kRowsBlock * C * 4);        // R = C / kRowsBlock
    gnp = take(BH * S / kRowsBlock * P * 4);
    kw = take(BH * S * P * 2);
    sq = take(BH * S * P * 2);
    dn = take(BH * S * P * 2);
    amat = take(BH * S * C * 2);
    dsm = take(BH * S * C * 2);
    hi = take(BH * slabs * P * P * 2);
    lo = take(BH * slabs * P * P * 2);
    gc = take(BH * slabs * P * P * 2);
    bytes = at;
  }
};

bool supported(int B, int S, int H, int P, int C) {
  return (P == 64 || (P % 128 == 0 && P <= 1024)) && C % kOutRows == 0 &&
         C <= kMaxChunk && C > 0 && S % C == 0 && B * H <= 65535 &&
         B * H > 0;
}

template <typename Kernel>
cudaError_t set_smem(Kernel kernel, int bytes) {
  if (bytes > kSmemLimit) return cudaErrorInvalidValue;
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

struct Maps {
  CUtensorMap q, k, v, dh, kw, sq, dn, amat, dsm, hi, lo, gc;
};

template <int TN>
cudaError_t launch_carry(bool rev, const CUtensorMap& a, const CUtensorMap& b,
                         const Maps& m, const Params& p, int BH,
                         cudaStream_t stream) {
  const int bytes = kCarryStages * 2 * (TN / kBox) * (int)kBoxBytes
      + kCarryStages * 8 + 32 * 4 + 1024;
  auto kernel = rev ? mlstm_bwd_wgmma_carry_kernel<TN, true>
                    : mlstm_bwd_wgmma_carry_kernel<TN, false>;
  cudaError_t err = set_smem(kernel, bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid(p.P / TN, p.P / TN, BH);
  kernel<<<grid, TN / kBox * 128, bytes, stream>>>(a, b, m.hi, m.lo, p);
  return cudaGetLastError();
}

template <int Kind, int TN>
cudaError_t launch_out(const CUtensorMap& a1, const CUtensorMap& b1,
                       const CUtensorMap& a2, const CUtensorMap& b2,
                       const Params& p, int BH, cudaStream_t stream) {
  const int bytes = OutRing<TN>::kBytes + 1024;
  auto kernel = mlstm_bwd_wgmma_out_kernel<Kind, TN>;
  cudaError_t err = set_smem(kernel, bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid((p.C / kOutRows) * ((Kind == kScores ? p.C : p.P) / TN),
                  p.n, BH);
  kernel<<<grid, kOutThreads, bytes, stream>>>(a1, b1, a2, b2, p);
  return cudaGetLastError();
}

template <int TN>
cudaError_t launch_all(const Maps& m, const Params& p, int BH,
                       cudaStream_t stream) {
  const dim3 chunks(p.n, BH);
  mlstm_bwd_wgmma_gates_kernel<<<chunks, kThreads, 0, stream>>>(p);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  mlstm_bwd_wgmma_chain_kernel<<<chunks, kThreads, 0, stream>>>(p);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  mlstm_bwd_wgmma_prep_kernel<<<dim3((p.P + 255) / 256, p.n, BH), kThreads, 0,
                          stream>>>(p);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  const dim3 vgrid((p.P + kVecCols - 1) / kVecCols, BH);
  mlstm_bwd_wgmma_vscan_kernel<false><<<vgrid, kVecCols, 0, stream>>>(p);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  if (p.n > 1 &&
      (err = launch_carry<TN>(false, m.kw, m.v, m, p, BH, stream)) != cudaSuccess)
    return err;
  if ((err = launch_out<kScores, TN>(m.q, m.k, m.dh, m.v, p, BH, stream))
      != cudaSuccess)
    return err;
  const int rbytes = rows_smem(p.C, p.P);
  if ((err = set_smem(mlstm_bwd_wgmma_rows_kernel, rbytes)) != cudaSuccess)
    return err;
  mlstm_bwd_wgmma_rows_kernel<<<dim3(p.n * p.R, BH), kThreads, rbytes, stream>>>(
      p);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  mlstm_bwd_wgmma_vscan_kernel<true><<<vgrid, kVecCols, 0, stream>>>(p);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  if (p.n > 1 &&
      (err = launch_carry<TN>(true, m.sq, m.dn, m, p, BH, stream)) != cudaSuccess)
    return err;
  if ((err = launch_out<kDQ, TN>(m.dn, m.hi, m.dsm, m.k, p, BH, stream))
      != cudaSuccess)
    return err;
  if ((err = launch_out<kDK, TN>(m.v, m.gc, m.dsm, m.q, p, BH, stream))
      != cudaSuccess)
    return err;
  if ((err = launch_out<kDV, TN>(m.kw, m.gc, m.amat, m.dn, p, BH, stream))
      != cudaSuccess)
    return err;
  mlstm_bwd_wgmma_gate_grads_kernel<<<chunks, kThreads, 0, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace

// Writes the workspace in bytes the launch needs at this shape to *bytes;
// returns 0, or cudaErrorInvalidValue for a shape the route does not take.
extern "C" int mlstm_chunk_bwd_wgmma_workspace(int B, int S, int H, int P,
                                               int chunk, long long* bytes) {
  if (!supported(B, S, H, P, chunk))
    return static_cast<int>(cudaErrorInvalidValue);
  *bytes = Workspace(B, S, H, P, chunk).bytes;
  return 0;
}

// q/k/v/h/dh [B, S, H, P] bf16 read in place through their element
// strides {q_b, q_s, q_h, k_*, v_*, h_*, dh_*, logi_*, logf_*} (21, host
// memory; q, k, v, dh 16-byte aligned with strides a multiple of 8
// elements: TMA), unit stride along P; logi/logf [B, S, H] float32.
// dq/dk/dv contiguous [B, S, H, P] bf16, dli/dlf contiguous [B, S, H]
// float32; `work` the workspace (mlstm_chunk_bwd_wgmma_workspace bytes,
// 1024-byte aligned).  P in {64, 128, 256, 512, 1024}, chunk in {128, 256,
// 512, 1024} dividing S.  Launches the kernels on `stream`; returns 0, the
// first cudaError_t, or -CUresult when a tensor map cannot be encoded
// (-1000: cuTensorMapEncodeTiled is not available).
extern "C" int mlstm_chunk_bwd_wgmma_launch(
    const void* q, const void* k, const void* v, const void* h,
    const void* dh, const float* logi, const float* logf, void* dq, void* dk,
    void* dv, float* dli, float* dlf, void* work, int B, int S, int H, int P,
    int chunk, const long long* strides, cudaStream_t stream) {
  if (!supported(B, S, H, P, chunk))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t bound = bind_device();  // autograd's thread
  if (bound != cudaSuccess) return static_cast<int>(bound);
  EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return -1000;

  const Workspace ws(B, S, H, P, chunk);
  unsigned char* w = static_cast<unsigned char*>(work);
  const int n = S / chunk, BH = B * H, slabs = n > 1 ? n - 1 : 1;
  Params p;
  p.q = static_cast<const __nv_bfloat16*>(q);
  p.k = static_cast<const __nv_bfloat16*>(k);
  p.v = static_cast<const __nv_bfloat16*>(v);
  p.h = static_cast<const __nv_bfloat16*>(h);
  p.dh = static_cast<const __nv_bfloat16*>(dh);
  p.li = logi;
  p.lf = logf;
  p.dq = static_cast<__nv_bfloat16*>(dq);
  p.dk = static_cast<__nv_bfloat16*>(dk);
  p.dv = static_cast<__nv_bfloat16*>(dv);
  p.dli = dli;
  p.dlf = dlf;
  p.rows = reinterpret_cast<float*>(w + ws.rows);
  p.chunks = reinterpret_cast<float*>(w + ws.chunks);
  p.vecs = reinterpret_cast<float*>(w + ws.vecs);
  p.sc = reinterpret_cast<float*>(w + ws.sc);
  p.dsc = reinterpret_cast<float*>(w + ws.dsc);
  p.part = reinterpret_cast<float*>(w + ws.part);
  p.dpart = reinterpret_cast<float*>(w + ws.dpart);
  p.ndot = reinterpret_cast<float*>(w + ws.ndot);
  p.ecp = reinterpret_cast<float*>(w + ws.ecp);
  p.gnp = reinterpret_cast<float*>(w + ws.gnp);
  p.kw = reinterpret_cast<__nv_bfloat16*>(w + ws.kw);
  p.sq = reinterpret_cast<__nv_bfloat16*>(w + ws.sq);
  p.dn = reinterpret_cast<__nv_bfloat16*>(w + ws.dn);
  p.amat = reinterpret_cast<__nv_bfloat16*>(w + ws.amat);
  p.dsm = reinterpret_cast<__nv_bfloat16*>(w + ws.dsm);
  p.hi = reinterpret_cast<__nv_bfloat16*>(w + ws.hi);
  p.lo = reinterpret_cast<__nv_bfloat16*>(w + ws.lo);
  p.gc = reinterpret_cast<__nv_bfloat16*>(w + ws.gc);
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
  p.n = n;
  p.slabs = slabs;
  p.TN = P == 64 ? 64 : 128;
  p.R = chunk / kRowsBlock;

  Maps m;
  const long long rowP[3] = {(long long)S * H * P, (long long)H * P, P};
  const long long rowC[3] = {(long long)S * H * chunk, (long long)H * chunk,
                             chunk};
  CUresult r = encode_bshd(fn, &m.q, q, B, S, H, P, strides, kBox);
  if (r == CUDA_SUCCESS)
    r = encode_bshd(fn, &m.k, k, B, S, H, P, strides + 3, kBox);
  if (r == CUDA_SUCCESS)
    r = encode_bshd(fn, &m.v, v, B, S, H, P, strides + 6, kBox);
  if (r == CUDA_SUCCESS)
    r = encode_bshd(fn, &m.dh, dh, B, S, H, P, strides + 12, kBox);
  if (r == CUDA_SUCCESS)
    r = encode_bshd(fn, &m.kw, p.kw, B, S, H, P, rowP, kBox);
  if (r == CUDA_SUCCESS)
    r = encode_bshd(fn, &m.sq, p.sq, B, S, H, P, rowP, kBox);
  if (r == CUDA_SUCCESS)
    r = encode_bshd(fn, &m.dn, p.dn, B, S, H, P, rowP, kBox);
  if (r == CUDA_SUCCESS)
    r = encode_bshd(fn, &m.amat, p.amat, B, S, H, chunk, rowC, kBox);
  if (r == CUDA_SUCCESS)
    r = encode_bshd(fn, &m.dsm, p.dsm, B, S, H, chunk, rowC, kBox);
  // the slabs [B*H, slabs, P rows, P columns]
  const cuuint64_t sdims[4] = {(cuuint64_t)P, (cuuint64_t)P,
                               (cuuint64_t)slabs, (cuuint64_t)BH};
  const cuuint64_t sst[3] = {(cuuint64_t)P * 2, (cuuint64_t)P * P * 2,
                             (cuuint64_t)slabs * P * P * 2};
  const cuuint32_t box[4] = {kBox, kBox, 1, 1};
  if (r == CUDA_SUCCESS)
    r = encode_bf16_sw128(fn, &m.hi, p.hi, 4, sdims, sst, box);
  if (r == CUDA_SUCCESS)
    r = encode_bf16_sw128(fn, &m.lo, p.lo, 4, sdims, sst, box);
  if (r == CUDA_SUCCESS)
    r = encode_bf16_sw128(fn, &m.gc, p.gc, 4, sdims, sst, box);
  if (r != CUDA_SUCCESS) return -static_cast<int>(r);

  const cudaError_t err = P == 64 ? launch_all<64>(m, p, BH, stream)
                                  : launch_all<128>(m, p, BH, stream);
  return static_cast<int>(err);
}
