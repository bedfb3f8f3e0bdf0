// Chunkwise mLSTM forward for Hopper (sm_90a) on the tensor cores: bf16
// q, k, v, float32 gates, head widths P in {64, 128, 256, 512, 1024} and
// chunks of 128, 256, 512 or 1024 rows.
//
// Replaces the Pallas TPU kernel
//   src/repro/kernels/mlstm_chunk/kernel.py::mlstm_chunk_fwd (body _kernel)
// and the transposes of its wrapper for bf16 inputs at those shapes;
// float32 and the other shapes take mlstm_chunk.cu.  It computes the same
// function as mlstm_chunk.cu (see there), with cum the chunk-local
// inclusive cumsum of logf, D[i,j] = cum_i - cum_j + li_j (j <= i),
// W = exp(D - m_comb), and the carry C_t = decay_t C_{t-1} + (k o wk)^T v.
//
// What bounds it on an H100: operations.  At xlstm-1.3b's layer shape
// (B=2, S=4096, H=4, P=1024, chunk 256) the function is 154.7 GFLOP
// against 268 MB of q, k, v and h (0.156 ms at the bf16 tensor-core
// peak); 89 % of it is the two P x P products, q C_prev and the carry
// k^T v.  Only wgmma reaches that peak.  The TPU kernel walks the chunks
// in order and carries C in VMEM; here that walk would leave 8 sequences
// for 132 SMs.  But the stabiliser chain
//   m_new = max(total + m_prev, max_j(total - cum_j + li_j))
// reads only the gates, so the design computes every stabiliser first and
// writes the chunk states out, which leaves one sequential product.  Four
// kernels, launched in order on one stream:
//   (a1) mlstm_chunk_gates_kernel, one block per (chunk, b*h): the
//       chunk-local inclusive cumsum of logf in order (one thread, as
//       mlstm_chunk.cu), per row m_loc = max_{j<=i}(cum_i - cum_j + li_j),
//       the chunk's total and g = max_j(total - cum_j + li_j).
//   (a2) mlstm_chunk_chain_kernel, one block per (chunk, b*h): m_prev from
//       the chain over the earlier chunks' (total, g), then per row m_comb,
//       scale_in = exp(cum + m_prev - m_comb), wk = exp(total - cum + li -
//       m_new) and the chunk's decay = exp(total + m_prev - m_new), into
//       float32 scratch.  The expressions and their order are
//       ref.mlstm_chunkwise's (ref.mlstm_gates is this pair's plain
//       version); expf throughout.  O(S chunk) work: ~8 us of the call.
//   (b) mlstm_chunk_state_kernel, one block per (TN x TN tile of C, b*h),
//       TN = min(P, 128): the tile stays in float32 wgmma accumulators
//       across the chunks; per chunk it is scaled by decay and gets
//       (k o wk)^T v added, k and v streamed by TMA in 64-row boxes
//       through a 3-stage ring (two blocks per SM).  k o wk is made in
//       place in shared memory (the rows scaled by wk, rounded to bf16;
//       then fence.proxy.async) and read as the MN-major A (transpose bit:
//       k is stored time-major); v is the MN-major B.  The state entering
//       each chunk t >= 1 is stored rounded to bf16 into states[b*h, t-1];
//       the blocks of column tile 0 also carry n in float32 from the
//       unrounded k wk.
//   (c) mlstm_chunk_out_kernel, one block per (64 WG rows of a chunk,
//       chunk, b*h), all chunks at once: WG consumer warpgroups (64 rows
//       each; two up to chunk 256, where their S o W leaves room for the
//       ring) share every tile that one producer warp's lane 0 streams by
//       TMA through a ring of up to 4 stages (full/empty mbarriers):
//       1. S = q k^T over P (wgmma, q and k K-major) for the 128-key
//          blocks the rows can see; W from scratch (a2); the row sums of
//          S o W in float32 from the unrounded values; S o W rounded to
//          bf16 into shared memory in the 128-byte swizzled K-major
//          layout (64 rows x chunk per warpgroup: 32 KiB at chunk 256);
//       2. q . n_prev in float32, from the q tiles of step 3's first
//          column tile as they pass through shared memory;
//       3. per column tile of TN (256 with two warpgroups, else min(P,
//          128)): acc = q C_prev[:, cols] (wgmma over P; skipped for the
//          first chunk, whose scale_in is 0 and which has no state), acc
//          *= scale_in, acc += (S o W) v[:, cols] (wgmma over the visible
//          keys), divided by max(|rowsum + scale_in q.n_prev|,
//          exp(-m_comb)) (the FMA kernel's reassociation) and stored as
//          bf16.  One item's products stay in flight while the next
//          item's are issued (wgmma.wait_group 1).
//   bf16 roundings, each where the plain version
//   ref.mlstm_chunkwise(..., operand_dtype=torch.bfloat16) makes them:
//   S o W before the product with v, k o wk before the carry product and
//   the stored state before q C_prev; the carries, n and every sum are
//   float32.
//   Shared-memory tiles are TMA boxes of 64 bf16 columns (128-byte rows,
//   128-byte swizzle), 1024-byte aligned, as hopper.cuh's descriptors
//   expect; the bytes an mbarrier expects come from the box constants.
//   q, k, v, h are read and written in place in the model's [B, S, H, P]
//   layout; the scratch comes from the wrapper.  Measured on an H100 at
//   the layer shape (PERF.md): the passes wait on the L2 -> shared-memory
//   supply of their tiles, not on the tensor cores.

#include "hopper.cuh"  // kernels/include: shared with flash_attention_wgmma.cu

namespace {

using namespace hopper;
using namespace hopper_host;

constexpr float kNegInf = -1e30f;  // the Pallas kernel's NEG_INF
constexpr int kBox = 64;           // columns of every TMA box (128 bytes)
constexpr int kBoxElems = kBox * kBox;
constexpr uint32_t kBoxBytes = kBoxElems * 2;  // a 64 x 64 bf16 box
constexpr int kRows = 64;          // (c): rows of a chunk per block
constexpr int kKeys = 128;         // (c): keys per q k^T block
constexpr int kJ = 64;             // (b): chunk rows per stage
constexpr int kGateThreads = 256;
constexpr int kMaxSmem = 232448;   // a block's shared-memory limit on sm_90
constexpr int kGateArrays = 5;     // scratch rows per b*h: cum li m_comb scale_in wk

struct Strides {
  long long b, s, h;               // in elements; the P stride is 1
};

// ---------------------------------------------------------------------------
// (a) the stabilisers from the gates
// ---------------------------------------------------------------------------

struct GateParams {
  const float* li;                 // [B, S, H]
  const float* lf;
  Strides is, fs;
  float* g;                        // [B*H, 5, S]: cum li m_comb scale_in wk
  float* chunks;                   // [B*H, 3, n]: decay, total, g
  int H, S, C;
};

__device__ __forceinline__ float block_max(float x, float* red) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  if (threadIdx.x % 32 == 0) red[threadIdx.x / 32] = x;
  __syncthreads();
  float r = red[0];
  for (int w = 1; w < kGateThreads / 32; ++w) r = fmaxf(r, red[w]);
  return r;
}

// (a1) one block per (chunk, b*h): the chunk-local inclusive cumsum of
// logf in order, per row m_loc = max_{j<=i}((cum_i - cum_j) + li_j) (kept
// in the m_comb row until a2), and the chunk's total and
// g = max_j((total - cum_j) + li_j)
__global__ void __launch_bounds__(kGateThreads)
mlstm_chunk_gates_kernel(const GateParams p) {
  extern __shared__ float sg[];    // cum, li: [C] each; red [warps]
  const int C = p.C, S = p.S, n = S / C;
  float* sCum = sg;
  float* sLi = sCum + C;
  float* red = sLi + C;
  const int c = blockIdx.x, bh = blockIdx.y, tid = threadIdx.x;
  const int b = bh / p.H, h = bh - b * p.H, s0 = c * C;
  const float* lib = p.li + b * p.is.b + h * p.is.h;
  const float* lfb = p.lf + b * p.fs.b + h * p.fs.h;
  float* cum = p.g + (long long)bh * kGateArrays * S;
  float* li = cum + S;
  float* mloc = li + S;

  for (int i = tid; i < C; i += kGateThreads) {
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
  const float total = sCum[C - 1];
  float gm = kNegInf;
  for (int i = tid; i < C; i += kGateThreads) {
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
    float* ch = p.chunks + (long long)bh * 3 * n;
    ch[n + c] = total;
    ch[2 * n + c] = gm;
  }
}

// (a2) one block per (chunk, b*h): m_prev from the chain over the earlier
// chunks' totals and g (m_new = max(total + m_prev, g)), then per row
// m_comb = max(m_loc, cum + m_prev, -1e30), scale_in and wk, and the
// chunk's decay
__global__ void __launch_bounds__(kGateThreads)
mlstm_chunk_chain_kernel(const GateParams p) {
  __shared__ float sm[2];          // m_prev, m_new
  const int C = p.C, S = p.S, n = S / C;
  const int c = blockIdx.x, bh = blockIdx.y, tid = threadIdx.x, s0 = c * C;
  float* ch = p.chunks + (long long)bh * 3 * n;
  const float* tot = ch + n;
  const float* gch = ch + 2 * n;
  if (tid == 0) {
    float m = kNegInf;
    for (int k = 0; k < c; ++k) m = fmaxf(tot[k] + m, gch[k]);
    const float m_new = fmaxf(tot[c] + m, gch[c]);
    sm[0] = m;
    sm[1] = m_new;
    ch[c] = expf((tot[c] + m) - m_new);          // decay
  }
  __syncthreads();
  const float m_prev = sm[0], m_new = sm[1], total = tot[c];
  float* cum = p.g + (long long)bh * kGateArrays * S;
  const float* li = cum + S;
  float* mc = cum + 2 * S;
  float* sc = cum + 3 * S;
  float* wk = cum + 4 * S;
  for (int s = s0 + tid; s < s0 + C; s += kGateThreads) {
    const float ci = cum[s];
    const float m_comb = fmaxf(fmaxf(mc[s], ci + m_prev), kNegInf);
    mc[s] = m_comb;
    sc[s] = expf((ci + m_prev) - m_comb);
    wk[s] = expf(((total - ci) + li[s]) - m_new);
  }
}

// ---------------------------------------------------------------------------
// (b) the chunk states
// ---------------------------------------------------------------------------

struct StateParams {
  const float* g;                  // [B*H, 5, S] from (a)
  const float* chunks;             // [B*H, 3, n] from (a): decay first
  __nv_bfloat16* states;           // [B*H, n-1, P, P]
  float* n_states;                 // [B*H, n-1, P]
  int H, S, P, C;
};

// A TN x TN tile of C: rows of k (one warpgroup per 64) by columns of v
// (the accumulator's N).  Three stages leave room for two blocks per SM,
// which overlap one block's scaling with the other's products (128 x 256
// tiles with one block per SM and four stages were slower).
template <int TN>
struct StateSmem {
  static constexpr int kStages = 3;
  static constexpr int kBoxes = TN / kBox;
  static constexpr int kThreads = kBoxes * 128;
  static constexpr int kGroups = TN / 8;             // 16-byte column groups of k
  static constexpr int kLanes = kThreads / kGroups;  // rows scaled at once
  static constexpr uint32_t kStageBytes = 2 * kBoxes * kBoxBytes;
  alignas(1024) __nv_bfloat16 k[kStages][kBoxes * kBoxElems];
  alignas(1024) __nv_bfloat16 v[kStages][kBoxes * kBoxElems];
  float nbuf[kLanes][TN];
  uint64_t full[kStages];
};

// acc (+)= A . B over one k16 step, N = TN
template <int TN, int TransA, int TransB>
__device__ __forceinline__ void mma_k16(float (&acc)[TN / 2], uint64_t da,
                                        uint64_t db, int scale_d) {
  if constexpr (TN == 256)
    wgmma_m64n256k16_ss<TransA, TransB>(acc, da, db, scale_d);
  else if constexpr (TN == 128)
    wgmma_m64n128k16_ss<TransA, TransB>(acc, da, db, scale_d);
  else
    wgmma_m64n64k16_ss<TransA, TransB>(acc, da, db, scale_d);
}

template <int TN>
__global__ void __launch_bounds__(StateSmem<TN>::kThreads)
mlstm_chunk_state_kernel(const __grid_constant__ CUtensorMap tm_k,
                         const __grid_constant__ CUtensorMap tm_v,
                         const StateParams p) {
  using Sm = StateSmem<TN>;
  constexpr int ST = Sm::kStages;
  extern __shared__ unsigned char smem_raw[];
  Sm& sm = *reinterpret_cast<Sm*>(
      smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023));

  const int pc0 = blockIdx.x * TN;     // columns of C (of v)
  const int pr0 = blockIdx.y * TN;     // rows of C (of k)
  const int bh = blockIdx.z;
  const int b = bh / p.H, h = bh - b * p.H;
  const int n = p.S / p.C, JB = p.C / kJ;
  const int G = (n - 1) * JB;          // the last chunk's carry is not needed
  const int tid = threadIdx.x, wg = tid / 128, lane = tid % 32;
  const float* wk = p.g + ((long long)bh * kGateArrays + 4) * p.S;

  if (tid == 0) {
#pragma unroll
    for (int s = 0; s < ST; ++s) mbar_init(&sm.full[s], 1);
    fence_barrier_init();
  }
  __syncthreads();

  const auto load = [&](int g) {
    const int st = g % ST;
    const int j0 = (g / JB) * p.C + (g % JB) * kJ;
    mbar_expect_tx(&sm.full[st], Sm::kStageBytes);
#pragma unroll
    for (int x = 0; x < Sm::kBoxes; ++x) {
      tma_load_4d(&sm.k[st][x * kBoxElems], &tm_k, &sm.full[st],
                  pr0 + kBox * x, j0, h, b);
      tma_load_4d(&sm.v[st][x * kBoxElems], &tm_v, &sm.full[st],
                  pc0 + kBox * x, j0, h, b);
    }
  };
  if (tid == 0)
    for (int g = 0; g < min(ST, G); ++g) load(g);

  float acc[TN / 2];
#pragma unroll
  for (int i = 0; i < TN / 2; ++i) acc[i] = 0.f;
  // the rows this thread scales: r = rl + kLanes i, columns of one 16-byte
  // group (box x, logical chunk lc); its partial of n over those rows
  const int cg = tid % Sm::kGroups, rl = tid / Sm::kGroups;
  const int x = cg / 8, lc = cg % 8;
  const bool carry_n = blockIdx.x == 0;
  float npart[8];
#pragma unroll
  for (int e = 0; e < 8; ++e) npart[e] = 0.f;

  for (int g = 0; g < G; ++g) {
    const int st = g % ST, t = g / JB, jb = g % JB;
    const int j0 = t * p.C + jb * kJ;
    if (jb == 0) {                     // a new chunk: C *= decay_t, n too
      const float dec = p.chunks[(long long)bh * 3 * n + t];
#pragma unroll
      for (int i = 0; i < TN / 2; ++i) acc[i] *= dec;
#pragma unroll
      for (int e = 0; e < 8; ++e) npart[e] *= dec;
    }
    float w[kJ / Sm::kLanes];          // loaded before the wait
#pragma unroll
    for (int i = 0; i < kJ / Sm::kLanes; ++i) w[i] = wk[j0 + rl + Sm::kLanes * i];
    mbar_wait(&sm.full[st], (g / ST) & 1);
    // k o wk in place: row r of every box is time j0 + r; the 128-byte
    // swizzle moves 16-byte chunks within a row only
#pragma unroll
    for (int i = 0; i < kJ / Sm::kLanes; ++i) {
      const int r = rl + Sm::kLanes * i;
      uint4* cell = reinterpret_cast<uint4*>(
          &sm.k[st][x * kBoxElems + r * kBox + ((lc ^ (r % 8)) * 8)]);
      uint4 raw = *cell;
      uint32_t* wds = reinterpret_cast<uint32_t*>(&raw);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const __nv_bfloat162 pr = *reinterpret_cast<__nv_bfloat162*>(&wds[e]);
        const float lo = __low2float(pr) * w[i], hi = __high2float(pr) * w[i];
        npart[2 * e] += lo;
        npart[2 * e + 1] += hi;
        wds[e] = pack_bf16x2(lo, hi);
      }
      *cell = raw;
    }
    fence_proxy_async();               // the stores, before wgmma reads them
    __syncthreads();
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kJ / 16; ++kk) {
      const uint64_t da = desc_sw128(&sm.k[st][wg * kBoxElems + kk * 16 * kBox],
                                     kBoxBytes, 1024);
      const uint64_t db = desc_sw128(&sm.v[st][kk * 16 * kBox], kBoxBytes, 1024);
      mma_k16<TN, 1, 1>(acc, da, db, 1);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_operands(acc);
    __syncthreads();                   // stage st is free
    if (tid == 0 && g + ST < G) load(g + ST);

    if (jb == JB - 1) {                // the state entering chunk t + 1
      const long long slab = (long long)bh * (n - 1) + t;
      __nv_bfloat16* cs = p.states + slab * p.P * p.P;
      const int row0 = pr0 + wg * 64 + (tid % 128 / 32) * 16 + lane / 4;
      const int col0 = pc0 + 2 * (lane % 4);
#pragma unroll
      for (int rr = 0; rr < 2; ++rr)
#pragma unroll
        for (int j = 0; j < TN / 8; ++j)
          *reinterpret_cast<uint32_t*>(
              cs + (long long)(row0 + 8 * rr) * p.P + col0 + 8 * j) =
              pack_bf16x2(acc[4 * j + 2 * rr], acc[4 * j + 2 * rr + 1]);
      if (carry_n) {                   // n: the lanes' partials, in order
#pragma unroll
        for (int e = 0; e < 8; ++e) sm.nbuf[rl][x * kBox + lc * 8 + e] = npart[e];
        __syncthreads();
        if (tid < TN) {
          float s = 0.f;
          for (int l = 0; l < Sm::kLanes; ++l) s += sm.nbuf[l][tid];
          p.n_states[slab * p.P + pr0 + tid] = s;
        }
        __syncthreads();
      }
    }
  }
}

// ---------------------------------------------------------------------------
// (c) the outputs
// ---------------------------------------------------------------------------

struct OutParams {
  const float* g;                  // [B*H, 5, S] from (a)
  const float* n_states;           // [B*H, n-1, P] from (b)
  const __nv_bfloat16* q;
  void* o;
  Strides qs, os;
  int H, S, P, C;
};

// dynamic shared memory of (c), from a 1024-aligned base: the ring's q
// boxes (64 WG rows) and B tiles (TN / 64 boxes of 64 x 64, at least two:
// one 128-key box), S o W (per 64 keys, one 64 x 64 box per warpgroup),
// the chunk's cum and li, the block rows' m_comb and scale_in, n_prev, the
// barriers.  As many stages as fit, up to four.
constexpr int kMaxStagesC = 4;
constexpr int kMaxP = 1024;        // the widest head the route takes
__host__ __device__ constexpr int out_b_boxes(int TN) {
  return TN / kBox > 2 ? TN / kBox : 2;
}
struct OutLayout {
  int stages, q_stage, b_stage, b, sw, cum, li, mc, sc, np, full, empty, bytes;
  __host__ __device__ OutLayout(int C, int WG, int TN) {
    q_stage = WG * kBoxBytes;
    b_stage = out_b_boxes(TN) * kBoxBytes;
    const int fixed = C * kRows * WG * 2
        + (2 * C + 2 * kRows * WG + kMaxP) * 4 + 2 * kMaxStagesC * 8;
    stages = (kMaxSmem - 1024 - fixed) / (q_stage + b_stage);
    if (stages > kMaxStagesC) stages = kMaxStagesC;
    b = stages * q_stage;
    sw = b + stages * b_stage;
    cum = sw + C * kRows * WG * 2;
    li = cum + C * 4;
    mc = li + C * 4;
    sc = mc + kRows * WG * 4;
    np = sc + kRows * WG * 4;
    full = np + kMaxP * 4;               // 8-aligned: every term above is
    empty = full + kMaxStagesC * 8;
    bytes = empty + kMaxStagesC * 8;
  }
};

// Rows of a chunk per block: 64 per consumer warpgroup.  Two warpgroups
// share every B tile (k, state, v: half the reads of one) where their
// S o W leaves room for a 3-stage ring of 256-column tiles: up to chunk 256.
__host__ __device__ constexpr int out_warpgroups(int C) {
  return C <= 256 ? 2 : 1;
}

template <int TN, int WG>
__global__ void __launch_bounds__(WG * 128 + 32)
mlstm_chunk_out_kernel(const __grid_constant__ CUtensorMap tm_q,
                       const __grid_constant__ CUtensorMap tm_k,
                       const __grid_constant__ CUtensorMap tm_v,
                       const __grid_constant__ CUtensorMap tm_st,
                       const OutParams p) {
  constexpr int kBoxes = TN / kBox;
  constexpr int kBStage = out_b_boxes(TN) * kBoxElems;
  constexpr int kBlockRows = kRows * WG;
  constexpr int kConsumers = 128 * WG;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* base =
      smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  const OutLayout L(p.C, WG, TN);
  const int ST = L.stages;
  __nv_bfloat16* sq = reinterpret_cast<__nv_bfloat16*>(base);
  __nv_bfloat16* sb = reinterpret_cast<__nv_bfloat16*>(base + L.b);
  __nv_bfloat16* sw = reinterpret_cast<__nv_bfloat16*>(base + L.sw);
  float* sCum = reinterpret_cast<float*>(base + L.cum);
  float* sLi = reinterpret_cast<float*>(base + L.li);
  float* sMc = reinterpret_cast<float*>(base + L.mc);
  float* sSc = reinterpret_cast<float*>(base + L.sc);
  float* sNp = reinterpret_cast<float*>(base + L.np);
  uint64_t* full = reinterpret_cast<uint64_t*>(base + L.full);
  uint64_t* empty = reinterpret_cast<uint64_t*>(base + L.empty);

  const int i0 = (gridDim.x - 1 - blockIdx.x) * kBlockRows;  // heaviest first
  const int t = blockIdx.y;
  const int bh = blockIdx.z;
  const int b = bh / p.H, h = bh - b * p.H;
  const int n = p.S / p.C, t0 = t * p.C;
  const int PB = p.P / kBox, CT = p.P / TN;
  const int n_kb = (i0 + kBlockRows + kKeys - 1) / kKeys;  // visible key blocks
  const int n_vb = (i0 + kBlockRows) / kBox;               // visible 64-key boxes
  const int tid = threadIdx.x;

  if (tid == 0) {
    for (int s = 0; s < ST; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kConsumers);
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (tid >= kConsumers) {             // the producer warp
    if (tid != kConsumers) return;
    const uint32_t q_bytes = kBlockRows * kBox * 2;
    int g = 0;
    const auto acquire = [&](uint32_t bytes) {
      const int st = g % ST;
      mbar_wait(&empty[st], ((g / ST) & 1) ^ 1);
      mbar_expect_tx(&full[st], bytes);
      ++g;
      return st;
    };
    for (int kb = 0; kb < n_kb; ++kb)
      for (int pb = 0; pb < PB; ++pb) {
        const int st = acquire(q_bytes + kKeys * kBox * 2);
        tma_load_4d(sq + st * WG * kBoxElems, &tm_q, &full[st], pb * kBox,
                    t0 + i0, h, b);
        tma_load_4d(sb + st * kBStage, &tm_k, &full[st], pb * kBox,
                    t0 + kb * kKeys, h, b);
      }
    for (int ct = 0; ct < CT; ++ct) {
      if (t > 0)
        for (int pb = 0; pb < PB; ++pb) {
          const int st = acquire(q_bytes + kBoxes * kBoxBytes);
          tma_load_4d(sq + st * WG * kBoxElems, &tm_q, &full[st], pb * kBox,
                      t0 + i0, h, b);
#pragma unroll
          for (int x = 0; x < kBoxes; ++x)
            tma_load_4d(sb + st * kBStage + x * kBoxElems, &tm_st, &full[st],
                        ct * TN + kBox * x, pb * kBox, t - 1, bh);
        }
      for (int vb = 0; vb < n_vb; ++vb) {
        const int st = acquire(kBoxes * kBoxBytes);
#pragma unroll
        for (int x = 0; x < kBoxes; ++x)
          tma_load_4d(sb + st * kBStage + x * kBoxElems, &tm_v, &full[st],
                      ct * TN + kBox * x, t0 + vb * kBox, h, b);
      }
    }
    return;
  }

  // ---- the consumer warpgroups: warpgroup wg owns rows 64 wg .. +64 ------
  const int wg = tid / 128, warp = tid / 32, lane = tid % 32;
  const int lr0 = warp * 16 + lane / 4;      // this thread's rows: lr0, lr0 + 8
  const int col0 = 2 * (lane % 4);
  const float* gb = p.g + (long long)bh * kGateArrays * p.S;
  for (int i = tid; i < p.C; i += kConsumers) {
    sCum[i] = gb[t0 + i];
    sLi[i] = gb[p.S + t0 + i];
  }
  for (int i = tid; i < kBlockRows; i += kConsumers) {
    sMc[i] = gb[2 * p.S + t0 + i0 + i];
    sSc[i] = gb[3 * p.S + t0 + i0 + i];
  }
  if (t > 0) {                         // n entering this chunk
    const float* np = p.n_states + ((long long)bh * (n - 1) + t - 1) * p.P;
    for (int i = tid; i < p.P; i += kConsumers) sNp[i] = np[i];
  }
  bar_sync(1, kConsumers);

  int g = 0;
  const auto take = [&]() {
    const int st = g % ST;
    mbar_wait(&full[st], (g / ST) & 1);
    ++g;
    return st;
  };
  // this warpgroup's 64 rows of the stage's q box and of S o W's boxes
  const auto q_rows = [&](int st) { return sq + (st * WG + wg) * kBoxElems; };
  const auto sw_rows = [&](int kb64) { return sw + (kb64 * WG + wg) * kBoxElems; };
  // one item's products stay in flight while the next item's are issued:
  // `held` is the stage they read, released once they are done
  int held = -1;
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

  // 1. S o W, its row sums, and S o W in bf16 into shared memory
  float rs[2] = {0.f, 0.f};
  for (int kb = 0; kb < n_kb; ++kb) {
    float s[kKeys / 2];
    for (int pb = 0; pb < PB; ++pb) {
      const int st = take();
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kBox / 16; ++kk) {
        const uint64_t da = desc_sw128(q_rows(st) + kk * 16, 16, 1024);
        const uint64_t db =
            desc_sw128(sb + st * kBStage + kk * 16, 16, 1024);
        wgmma_m64n128k16_ss(s, da, db, pb > 0 || kk > 0);
      }
      fence_operands(s);
      pipeline(st);
    }
    drain();
    fence_operands(s);
#pragma unroll
    for (int e = 0; e < kKeys / 2; e += 2) {
      const int rr = (e / 2) % 2;
      const int lr = lr0 + 8 * rr, i = i0 + lr, r64 = lr % kRows;
      const int j = kb * kKeys + 8 * (e / 4) + col0;
      float x0 = 0.f, x1 = 0.f;
      if (j <= i)
        x0 = s[e] * expf(((sCum[i] - sCum[j]) + sLi[j]) - sMc[lr]);
      if (j + 1 <= i)
        x1 = s[e + 1] * expf(((sCum[i] - sCum[j + 1]) + sLi[j + 1]) - sMc[lr]);
      rs[rr] += x0 + x1;
      const int w = j % kBox;
      *reinterpret_cast<uint32_t*>(
          sw_rows(j / kBox) + r64 * kBox + (((w / 8) ^ (r64 % 8)) * 8) + w % 8) =
          pack_bf16x2(x0, x1);
    }
  }
  fence_proxy_async();                 // S o W, before wgmma reads it
  bar_sync(2 + wg, 128);               // a warpgroup reads its own rows only
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    rs[rr] += __shfl_xor_sync(0xffffffffu, rs[rr], 1);
    rs[rr] += __shfl_xor_sync(0xffffffffu, rs[rr], 2);
  }

  // 3. per column tile: (q C_prev) scale_in + (S o W) v, normalised
  __nv_bfloat16* ob = static_cast<__nv_bfloat16*>(p.o) + b * p.os.b
      + h * p.os.h;
  // 2. q . n_prev in float32, from the q boxes of the first column tile's
  // q C_prev items: this thread's rows, its 16 columns of each box
  float qn[2] = {0.f, 0.f}, den[2];
  const auto add_qn = [&](int st, int pb) {
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      const int r64 = (lr0 + 8 * rr) % kRows;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int c8 = 2 * (lane % 4) + half;      // a 16-byte chunk of the row
        const uint4 raw = *reinterpret_cast<const uint4*>(
            q_rows(st) + r64 * kBox + ((c8 ^ (r64 % 8)) * 8));
        const __nv_bfloat162* pr = reinterpret_cast<const __nv_bfloat162*>(&raw);
        const float* nn = sNp + pb * kBox + c8 * 8;
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float2 f = __bfloat1622float2(pr[e]);
          qn[rr] = fmaf(f.x, nn[2 * e], qn[rr]);
          qn[rr] = fmaf(f.y, nn[2 * e + 1], qn[rr]);
        }
      }
    }
  };
  for (int ct = 0; ct < CT; ++ct) {
    float acc[TN / 2];
#pragma unroll
    for (int i = 0; i < TN / 2; ++i) acc[i] = 0.f;
    if (t > 0) {
      for (int pb = 0; pb < PB; ++pb) {
        const int st = take();
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < kBox / 16; ++kk) {
          const uint64_t da = desc_sw128(q_rows(st) + kk * 16, 16, 1024);
          const uint64_t db = desc_sw128(
              sb + st * kBStage + kk * 16 * kBox, kBoxBytes, 1024);
          mma_k16<TN, 0, 1>(acc, da, db, 1);
        }
        fence_operands(acc);
        if (ct == 0) add_qn(st, pb);       // before the stage is released
        pipeline(st);
      }
      drain();
      fence_operands(acc);
#pragma unroll
      for (int i = 0; i < TN / 2; ++i) acc[i] *= sSc[lr0 + 8 * ((i / 2) % 2)];
    }
    if (ct == 0) {                       // the denominators
#pragma unroll
      for (int rr = 0; rr < 2; ++rr) {
        qn[rr] += __shfl_xor_sync(0xffffffffu, qn[rr], 1);
        qn[rr] += __shfl_xor_sync(0xffffffffu, qn[rr], 2);
        const int lr = lr0 + 8 * rr;
        den[rr] = fmaxf(fabsf(rs[rr] + sSc[lr] * qn[rr]), expf(-sMc[lr]));
      }
    }
    for (int vb = 0; vb < n_vb; ++vb) {
      const int st = take();
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kBox / 16; ++kk) {
        const uint64_t da = desc_sw128(sw_rows(vb) + kk * 16, 16, 1024);
        const uint64_t db = desc_sw128(
            sb + st * kBStage + kk * 16 * kBox, kBoxBytes, 1024);
        mma_k16<TN, 0, 1>(acc, da, db, 1);
      }
      fence_operands(acc);
      pipeline(st);
    }
    drain();
    fence_operands(acc);
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      __nv_bfloat16* orow =
          ob + (long long)(t0 + i0 + lr0 + 8 * rr) * p.os.s + ct * TN + col0;
#pragma unroll
      for (int j = 0; j < TN / 8; ++j)
        *reinterpret_cast<uint32_t*>(orow + 8 * j) =
            pack_bf16x2(acc[4 * j + 2 * rr] / den[rr],
                        acc[4 * j + 2 * rr + 1] / den[rr]);
    }
  }
}

// ---- host side ----------------------------------------------------------

template <int TN, int WG>
cudaError_t launch_out(const CUtensorMap& tq, const CUtensorMap& tk128,
                       const CUtensorMap& tv64, const CUtensorMap& tst,
                       const OutParams& op, int BH, cudaStream_t stream) {
  const OutLayout L(op.C, WG, TN);
  if (L.stages < 2) return cudaErrorInvalidValue;
  const int bytes = L.bytes + 1024;    // + alignment slack
  auto kernel = mlstm_chunk_out_kernel<TN, WG>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid(op.C / (kRows * WG), op.S / op.C, BH);
  kernel<<<grid, WG * 128 + 32, bytes, stream>>>(tq, tk128, tv64, tst, op);
  return cudaGetLastError();
}

template <int TN>
cudaError_t launch_state(const CUtensorMap& tk64, const CUtensorMap& tv64,
                         const StateParams& sp, int BH, cudaStream_t stream) {
  constexpr int bytes = sizeof(StateSmem<TN>) + 1024;  // + alignment slack
  auto kernel = mlstm_chunk_state_kernel<TN>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid(sp.P / TN, sp.P / TN, BH);
  kernel<<<grid, StateSmem<TN>::kThreads, bytes, stream>>>(tk64, tv64, sp);
  return cudaGetLastError();
}

// The tiles by P: the state pass's TN x TN tile of C, TN = min(P, 128);
// the output pass's column tile, 256 wide where two warpgroups share it
cudaError_t launch_passes(const CUtensorMap& tq, const CUtensorMap& tk128,
                          const CUtensorMap& tk64, const CUtensorMap& tv64,
                          const CUtensorMap& tst, const StateParams& sp,
                          const OutParams& op, int BH, cudaStream_t stream) {
  cudaError_t err = cudaSuccess;
  if (sp.S / sp.C > 1) {
    err = sp.P == 64 ? launch_state<64>(tk64, tv64, sp, BH, stream)
                     : launch_state<128>(tk64, tv64, sp, BH, stream);
    if (err != cudaSuccess) return err;
  }
  const bool two = out_warpgroups(op.C) == 2;
  if (op.P == 64)
    return two ? launch_out<64, 2>(tq, tk128, tv64, tst, op, BH, stream)
               : launch_out<64, 1>(tq, tk128, tv64, tst, op, BH, stream);
  if (op.P == 128 || !two)
    return two ? launch_out<128, 2>(tq, tk128, tv64, tst, op, BH, stream)
               : launch_out<128, 1>(tq, tk128, tv64, tst, op, BH, stream);
  return launch_out<256, 2>(tq, tk128, tv64, tst, op, BH, stream);
}

}  // namespace

// q/k/v/o [B, S, H, P] bf16, logi/logf [B, S, H] float32, on the device;
// element strides {q_b, q_s, q_h, k_*, v_*, logi_*, logf_*, o_*} (18, host
// memory), unit stride along P; q, k, v 16-byte aligned with strides a
// multiple of 8 elements (TMA).  P in {64, 128, 256, 512, 1024}; chunk in
// {128, 256, 512, 1024} dividing S.  Scratch: gates float32 [B*H, 5, S],
// chunks float32 [B*H, 3, S / chunk], n_states float32 [B*H, max(S / chunk
// - 1, 1), P], states bf16 [B*H, max(S / chunk - 1, 1), P, P].  Launches
// the passes on `stream`; returns 0, the first cudaError_t, or -CUresult
// when a tensor map cannot be encoded (-1000: cuTensorMapEncodeTiled is
// not available).
extern "C" int mlstm_chunk_wgmma_launch(
    const void* q, const void* k, const void* v, const float* logi,
    const float* logf, void* o, float* gates, float* chunks, float* n_states,
    void* states, int B, int S, int H, int P, int chunk,
    const long long* strides, cudaStream_t stream) {
  if (!(P == 64 || (P % 128 == 0 && P <= 1024)) || chunk % kKeys != 0 ||
      chunk > 1024 || S % chunk != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int n = S / chunk, BH = B * H;
  EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return -1000;
  CUtensorMap tq, tk128, tk64, tv64, tst;
  CUresult r = encode_bshd(fn, &tq, q, B, S, H, P, strides,
                           kRows * out_warpgroups(chunk));
  if (r == CUDA_SUCCESS)
    r = encode_bshd(fn, &tk128, k, B, S, H, P, strides + 3, kKeys);
  if (r == CUDA_SUCCESS)
    r = encode_bshd(fn, &tk64, k, B, S, H, P, strides + 3, kJ);
  if (r == CUDA_SUCCESS)
    r = encode_bshd(fn, &tv64, v, B, S, H, P, strides + 6, kBox);
  if (r == CUDA_SUCCESS) {         // states [B*H, slabs, P rows, P cols]
    const int slabs = n > 1 ? n - 1 : 1;
    const cuuint64_t dims[4] = {(cuuint64_t)P, (cuuint64_t)P,
                                (cuuint64_t)slabs, (cuuint64_t)BH};
    const cuuint64_t st[3] = {(cuuint64_t)P * 2, (cuuint64_t)P * P * 2,
                              (cuuint64_t)slabs * P * P * 2};
    const cuuint32_t box[4] = {kBox, kBox, 1, 1};
    r = encode_bf16_sw128(fn, &tst, states, 4, dims, st, box);
  }
  if (r != CUDA_SUCCESS) return -static_cast<int>(r);

  GateParams gp;
  gp.li = logi;
  gp.lf = logf;
  gp.is = {strides[9], strides[10], strides[11]};
  gp.fs = {strides[12], strides[13], strides[14]};
  gp.g = gates;
  gp.chunks = chunks;
  gp.H = H;
  gp.S = S;
  gp.C = chunk;
  const int gate_bytes =
      (2 * chunk + kGateThreads / 32) * static_cast<int>(sizeof(float));
  const dim3 gate_grid(n, BH);
  mlstm_chunk_gates_kernel<<<gate_grid, kGateThreads, gate_bytes, stream>>>(gp);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  mlstm_chunk_chain_kernel<<<gate_grid, kGateThreads, 0, stream>>>(gp);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  StateParams sp;
  sp.g = gates;
  sp.chunks = chunks;
  sp.states = static_cast<__nv_bfloat16*>(states);
  sp.n_states = n_states;
  sp.H = H;
  sp.S = S;
  sp.P = P;
  sp.C = chunk;
  OutParams op;
  op.g = gates;
  op.n_states = n_states;
  op.q = static_cast<const __nv_bfloat16*>(q);
  op.o = o;
  op.qs = {strides[0], strides[1], strides[2]};
  op.os = {strides[15], strides[16], strides[17]};
  op.H = H;
  op.S = S;
  op.P = P;
  op.C = chunk;
  err = launch_passes(tq, tk128, tk64, tv64, tst, sp, op, BH, stream);
  return static_cast<int>(err);
}
