// Flash-attention forward for Hopper (sm_90a) on the tensor cores: bf16
// causal / sliding-window / tanh-soft-capped grouped-query attention with
// an online softmax, head dims 64 and 128.
//
// Replaces the Pallas TPU kernel
//   src/repro/kernels/flash_attention/kernel.py::flash_attention_fwd
// (and its wrapper's padding, head flattening and transposes) for bf16
// inputs; float32 and the other head dims take flash_attention.cu.
//
//   o[b, i, h, :] = sum_j softmax_j(s_ij) v[b, j, h / (H / Kh), :],
//   s_ij = cap(q[b, i, h, :] . k[b, j, h / (H / Kh), :] / sqrt(D)),
//   cap(x) = softcap * tanh(x / softcap) (when set), applied before the mask;
//   visible: j <= i (causal, top-left aligned), j > i - window (when set);
//   a row with nothing visible is written as zeros.
//
// What bounds it on an H100: operations.  At yi-6b's prefill shape (B=2,
// S=4096, H=32, Kh=4, D=128, causal) the visible half of QK^T and PV is
// 275 GFLOP against 151 MB of q, k, v and o (~1800 FLOP per byte, far
// above the card's ~295 bf16 FLOP per byte of HBM): 0.28 ms at the bf16
// tensor-core peak.  Only wgmma reaches that peak, so both products run
// there, and the design keeps the tensor cores fed:
//   * Q.K^T is wgmma m64n128k16 with Q and K in shared memory (both
//     K-major: D is contiguous), fp32 accumulators in registers.  The
//     scale and the soft-cap act on the fp32 scores, never on bf16 q.
//   * P.V is wgmma m64nDk16 with P taken from registers: the score
//     accumulator's fragment layout is the A-operand layout, so the
//     unnormalised exp is packed to bf16 in place and never touches
//     shared memory; V [keys, D] is the MN-major B operand (transpose
//     bit).  P is rounded to bf16 there (the Pallas kernel keeps it in
//     f32); the row sums are taken in fp32 from the unrounded values.
//   * One producer warpgroup (one thread issuing) streams K and V tiles
//     of 128 keys with TMA (cp.async.bulk.tensor) into a 2-stage ring in
//     shared memory, 128-byte swizzled so the copies and the wgmma
//     descriptors agree; full/empty mbarriers hand the stages over (K's
//     slot once Q.K^T has read it, V's after P.V).  The tensor maps are encoded on the host per call from the tensors'
//     pointers and strides (cuTensorMapEncodeTiled, reached through
//     cudaGetDriverEntryPoint: no -lcuda), so q, k, v are read in place in
//     the model's [B, S, heads, D] layout; the KV head is h / (H / Kh); the
//     ragged Sq/Sk edges are zero-filled by TMA and masked here.
//   * The online softmax stays in registers: row max and sum over a quad
//     of lanes, exp2 on the special-function unit (ex2.approx, ~2 ulp:
//     far below P's bf16 rounding) with scale * log2(e) folded in (~5 %
//     of the kernel's time against exp2f); masks only on tiles
//     that cross the causal diagonal, the window edge or the Sk edge; a
//     masked entry is selected to 0, never passed through exp; fully
//     masked KV tiles are skipped; the heaviest q tiles are scheduled
//     first.
//   * Two consumer warpgroups per block (128 q rows; the producer gives
//     its registers to them with setmaxnreg).  Each warpgroup issues tile
//     t's QK^T together with tile t-1's PV and runs tile t's softmax while
//     they execute; and the two take turns to issue (ping-pong on named
//     barriers), so one's softmax also runs under the other's products.
//
// The tile knobs pick an instantiation and its ring depth: block_q is the
// consumer warpgroups' rows (NC = 1 or 2 warpgroups of 64 rows; one
// warpgroup issues without the ping-pong), block_k the keys of a KV tile
// (BN = 64 or 128: wgmma N of Q.K^T, K of P.V), pipeline the stages of the
// K/V ring (1 to 4, as many as fit in 227 KB of shared memory), and
// num_warps the warps of a consumer warpgroup, which wgmma fixes at 4.  The
// default launch is 128 rows, 128 keys, 2 stages.  Each tile is compiled
// twice: with a 2-stage ring fixed at compile time (the default depth: its
// ring indices fold to shifts, as in the kernel before the knobs) and
// with the depth read at run time (1, 3 or 4).

#include "hopper.cuh"  // kernels/include: shared with mlstm_chunk_wgmma.cu

namespace {

using namespace hopper;
using namespace hopper_host;

constexpr int kRows = 64;          // q rows per consumer warpgroup
constexpr int kMaxStages = 4;      // the K/V ring's deepest
constexpr int kSmemLimit = 232448; // a block's shared-memory limit on sm_90
constexpr float kNegInf = -1e30f;  // the reference's NEG_INF
constexpr float kLog2e = 1.4426950408889634f;

struct Params {
  void* o;
  long long os_b, os_s, os_h;      // o's strides in elements
  int H, Kh, Sq, Sk;
  int causal;
  int window;                      // <= 0: no window
  float softcap;                   // <= 0: no soft-cap
  float cap_in;                    // scale / softcap: raw score -> tanh argument
  float fac;                       // log2(e) per unit of the softmax's score
  float* lse;                      // [B, H, Sq] log-sum-exp, or null
  float lse_fac;                   // natural-log units per unit of score
};

// Q (the block's NC * 64 rows) and a ring of `stages` K/V tiles of BN
// keys, each split into 64-column blocks of 128-byte rows as the swizzled
// TMA boxes land (every part a multiple of 1024 bytes from a 1024-aligned
// base), then the barriers.
template <int D, int NC, int BN>
struct Smem {
  static constexpr int kBM = NC * kRows;
  static constexpr int kQBytes = kBM * D * 2;
  static constexpr int kKVBytes = BN * D * 2;
  __nv_bfloat16* q;
  __nv_bfloat16* k0;
  __nv_bfloat16* v0;
  uint64_t* q_full;
  uint64_t* k_full;
  uint64_t* v_full;
  uint64_t* k_empty;               // K is released after Q.K^T, V after P.V
  uint64_t* v_empty;
  __host__ __device__ static int bytes(int stages) {
    return kQBytes + 2 * stages * kKVBytes + 8 * (1 + 4 * stages);
  }
  __device__ Smem(unsigned char* base, int stages) {
    q = reinterpret_cast<__nv_bfloat16*>(base);
    k0 = reinterpret_cast<__nv_bfloat16*>(base + kQBytes);
    v0 = reinterpret_cast<__nv_bfloat16*>(base + kQBytes + stages * kKVBytes);
    q_full = reinterpret_cast<uint64_t*>(base + kQBytes
                                         + 2 * stages * kKVBytes);
    k_full = q_full + 1;
    v_full = k_full + stages;
    k_empty = v_full + stages;
    v_empty = k_empty + stages;
  }
  __device__ __nv_bfloat16* k(int st) const { return k0 + st * BN * D; }
  __device__ __nv_bfloat16* v(int st) const { return v0 + st * BN * D; }
};

__device__ __forceinline__ bool visible(const Params& p, int row, int key) {
  bool ok = key < p.Sk;
  if (p.causal) ok = ok && key <= row;
  if (p.window > 0) ok = ok && key > row - p.window;
  return ok;
}

// whether any (row, key) of a warpgroup's 64 rows x this tile is masked
template <int BN>
__device__ __forceinline__ bool tile_needs_mask(const Params& p, int rq0,
                                                int k0) {
  return k0 + BN > p.Sk || (p.causal && k0 + BN - 1 > rq0) ||
         (p.window > 0 && k0 <= rq0 + kRows - 1 - p.window);
}

// S = Q . K^T for one warpgroup's 64 rows against the tile in `stage`
template <int D, int NC, int BN>
__device__ __forceinline__ void issue_qk(float (&s)[BN / 2],
                                         const Smem<D, NC, BN>& sm, int wg,
                                         int stage) {
  constexpr int kBM = NC * kRows;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const uint64_t da = desc_sw128(
        &sm.q[(kk / 4) * kBM * 64 + wg * kRows * 64 + (kk % 4) * 16],
        16, 1024);
    const uint64_t db = desc_sw128(
        sm.k(stage) + (kk / 4) * BN * 64 + (kk % 4) * 16, 16, 1024);
    if constexpr (BN == 128)
      wgmma_m64n128k16_ss(s, da, db, kk > 0);
    else
      wgmma_m64n64k16_ss(s, da, db, kk > 0);
  }
}

// O += P . V, P in registers (bf16x2), V the tile in `stage`
template <int D, int NC, int BN>
__device__ __forceinline__ void issue_pv(float (&o)[D / 2],
                                         const uint32_t (&pk)[BN / 4],
                                         const Smem<D, NC, BN>& sm,
                                         int stage) {
#pragma unroll
  for (int kk = 0; kk < BN / 16; ++kk) {
    const uint32_t a[4] = {pk[4 * kk], pk[4 * kk + 1], pk[4 * kk + 2],
                           pk[4 * kk + 3]};
    const uint64_t db =
        desc_sw128(sm.v(stage) + kk * 16 * 64, BN * 64 * 2, 1024);
    if constexpr (D == 128)
      wgmma_m64n128k16_rs(o, a, db, 1);
    else
      wgmma_m64n64k16_rs(o, a, db, 1);
  }
}

// One tile of the online softmax on the raw scores `s` (this thread's two
// rows row0 and row0 + 8, columns k0 + 8 j + col0 + {0, 1}): updates the
// running max m and sum l, leaves the unnormalised exp in `s` and the
// factor the accumulator must be rescaled by in `alpha`.
template <bool kMask, int BN>
__device__ __forceinline__ void softmax_tile(float (&s)[BN / 2],
                                             float (&m)[2], float (&l)[2],
                                             float (&alpha)[2],
                                             const Params& p, int row0,
                                             int k0, int col0) {
  if (p.softcap > 0.f) {
#pragma unroll
    for (int i = 0; i < BN / 2; ++i)
      s[i] = p.softcap * tanhf(s[i] * p.cap_in);
  }
  if constexpr (kMask) {
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) {
      const int row = row0 + 8 * ((i / 2) % 2);
      const int key = k0 + 8 * (i / 4) + col0 + i % 2;
      if (!visible(p, row, key)) s[i] = kNegInf;
    }
  }
  float mx[2] = {m[0], m[1]};
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) {
    const int r = (i / 2) % 2;
    mx[r] = fmaxf(mx[r], s[i]);
  }
  float neg[2], rs[2] = {0.f, 0.f};
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
    alpha[r] = exp2_approx((m[r] - mx[r]) * p.fac);
    m[r] = mx[r];
    neg[r] = -mx[r] * p.fac;
  }
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) {
    const int r = (i / 2) % 2;
    float x = exp2_approx(fmaf(s[i], p.fac, neg[r]));
    if constexpr (kMask) {
      const int key = k0 + 8 * (i / 4) + col0 + i % 2;
      if (!visible(p, row0 + 8 * r, key)) x = 0.f;
    }
    s[i] = x;
    rs[r] += x;
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) l[r] = l[r] * alpha[r] + rs[r];
}

template <int BN>
__device__ __forceinline__ void pack_p(const float (&s)[BN / 2],
                                       uint32_t (&pk)[BN / 4]) {
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
    pk[2 * j] = pack_bf16x2(s[4 * j], s[4 * j + 1]);
    pk[2 * j + 1] = pack_bf16x2(s[4 * j + 2], s[4 * j + 3]);
  }
}

template <int D>
__device__ __forceinline__ void rescale(float (&o)[D / 2],
                                        const float (&alpha)[2]) {
#pragma unroll
  for (int i = 0; i < D / 2; ++i) o[i] *= alpha[(i / 2) % 2];
}

template <int BN>
__device__ __forceinline__ void softmax_any(float (&s)[BN / 2],
                                            float (&m)[2], float (&l)[2],
                                            float (&alpha)[2],
                                            const Params& p, int rq0,
                                            int row0, int k0, int col0) {
  if (tile_needs_mask<BN>(p, rq0, k0))
    softmax_tile<true, BN>(s, m, l, alpha, p, row0, k0, col0);
  else
    softmax_tile<false, BN>(s, m, l, alpha, p, row0, k0, col0);
}

template <int D, int NC, int BN>
__device__ __forceinline__ void consume(const Smem<D, NC, BN>& sm,
                                        const Params& p, int b, int h,
                                        int q0, int t_begin, int n_tiles,
                                        int stages) {
  const int wg = threadIdx.x / 128;
  const int t = threadIdx.x % 128;
  const int lane = t % 32;
  const int rq0 = q0 + wg * kRows;              // the warpgroup's first row
  const int row0 = rq0 + (t / 32) * 16 + lane / 4;
  const int col0 = 2 * (lane % 4);

  float o[D / 2], s[BN / 2], m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
  float alpha[2];
  uint32_t pk[BN / 4];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) s[i] = 0.f;

  mbar_wait(sm.q_full, 0);
  if (n_tiles > 0) {
    // ping-pong (two warpgroups): they take turns to issue their products
    // (named barriers 1 and 2), so one's softmax runs under the other's
    // products; warpgroup 0 goes first, warpgroup 1 does not hand the
    // turn back after its last issue.  One warpgroup issues at will.
    const auto take_turn = [&]() {
      if constexpr (NC == 2) bar_sync(1 + wg, 2 * 128);
    };
    const auto pass_turn = [&](bool last) {
      if constexpr (NC == 2)
        if (!(last && wg == 1)) bar_arrive(2 - wg, 2 * 128);
    };
    if constexpr (NC == 2)
      if (wg == 1) bar_arrive(1, 2 * 128);
    mbar_wait(&sm.k_full[0], 0);
    take_turn();
    wgmma_fence();
    issue_qk(s, sm, wg, 0);
    wgmma_commit();
    pass_turn(false);
    wgmma_wait<0>();
    fence_operands(s);
    mbar_arrive(&sm.k_empty[0]);
    softmax_any<BN>(s, m, l, alpha, p, rq0, row0, t_begin * BN, col0);
    pack_p<BN>(s, pk);
    for (int i = 1; i < n_tiles; ++i) {
      const int st = i % stages, ph = (i / stages) & 1;
      const int sp = (i - 1) % stages, pph = ((i - 1) / stages) & 1;
      const int k0 = (t_begin + i) * BN;
      mbar_wait(&sm.k_full[st], ph);
      mbar_wait(&sm.v_full[sp], pph);
      take_turn();
      wgmma_fence();
      issue_qk(s, sm, wg, st);             // S_i = Q K_i^T ...
      wgmma_commit();
      issue_pv(o, pk, sm, sp);             // ... and O += P_{i-1} V_{i-1}
      wgmma_commit();
      pass_turn(false);
      wgmma_wait<1>();                     // S_i is in
      fence_operands(s);
      mbar_arrive(&sm.k_empty[st]);
      softmax_any<BN>(s, m, l, alpha, p, rq0, row0, k0, col0);
      wgmma_wait<0>();                     // O and P_{i-1} are free
      fence_operands(o);
      fence_operands(pk);
      mbar_arrive(&sm.v_empty[sp]);
      rescale<D>(o, alpha);
      pack_p<BN>(s, pk);
    }
    const int sl = (n_tiles - 1) % stages;
    mbar_wait(&sm.v_full[sl], ((n_tiles - 1) / stages) & 1);
    take_turn();
    wgmma_fence();
    issue_pv(o, pk, sm, sl);
    wgmma_commit();
    pass_turn(true);
    wgmma_wait<0>();
    fence_operands(o);
    fence_operands(pk);
    mbar_arrive(&sm.v_empty[sl]);
  }

  float inv[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    inv[r] = 1.f / fmaxf(l[r], 1e-30f);
  }
  // the rows' log-sum-exp for the backward (-inf: nothing visible)
  if (p.lse != nullptr && (lane & 3) == 0) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = row0 + 8 * r;
      if (row < p.Sq)
        p.lse[(static_cast<long long>(b) * p.H + h) * p.Sq + row] =
            m[r] * p.lse_fac + logf(l[r]);
    }
  }
  __nv_bfloat16* ob =
      static_cast<__nv_bfloat16*>(p.o) + b * p.os_b + h * p.os_h;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + 8 * r;
    if (row >= p.Sq) continue;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      *reinterpret_cast<uint32_t*>(ob + row * p.os_s + 8 * j + col0) =
          pack_bf16x2(o[4 * j + 2 * r] * inv[r],
                      o[4 * j + 2 * r + 1] * inv[r]);
  }
}

// compiled for three warpgroups' registers (168 a thread), which
// setmaxnreg moves from the producer to the consumers at run time, also
// when one consumer warpgroup runs
template <int D, int NC, int BN, int kST>
__global__ void __launch_bounds__(3 * 128, 1)
flash_wgmma_kernel(const __grid_constant__ CUtensorMap tm_q,
                   const __grid_constant__ CUtensorMap tm_k,
                   const __grid_constant__ CUtensorMap tm_v,
                   const Params p, const int stages_arg) {
  // kST > 0: the ring depth is a compile-time constant
  const int stages = kST > 0 ? kST : stages_arg;
  using S = Smem<D, NC, BN>;
  constexpr int kNC = NC, kBN = BN, kBM = S::kBM;
  extern __shared__ unsigned char smem_raw[];
  const S sm(smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023),
             stages);

  const int bh = blockIdx.x;
  const int b = bh / p.H;
  const int h = bh - b * p.H;
  const int kh = h / (p.H / p.Kh);
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kBM;

  // the keys any row of this block can see
  int kv_end = p.Sk;
  if (p.causal) kv_end = min(kv_end, min(q0 + kBM, p.Sq));
  const int kv_begin = p.window > 0 ? max(0, q0 - p.window + 1) : 0;
  const int t_begin = kv_begin / kBN;
  const int n_tiles = max(0, (kv_end + kBN - 1) / kBN - t_begin);

  if (threadIdx.x == 0) {
    mbar_init(sm.q_full, 1);
    for (int s = 0; s < stages; ++s) {
      mbar_init(&sm.k_full[s], 1);
      mbar_init(&sm.v_full[s], 1);
      mbar_init(&sm.k_empty[s], kNC * 128);
      mbar_init(&sm.v_empty[s], kNC * 128);
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (threadIdx.x >= kNC * 128) {        // the producer warpgroup
    regs_dealloc<40>();
    if (threadIdx.x == kNC * 128) {
      mbar_expect_tx(sm.q_full, S::kQBytes);
#pragma unroll
      for (int c = 0; c < D / 64; ++c)
        tma_load_4d(&sm.q[c * kBM * 64], &tm_q, sm.q_full, 64 * c,
                    q0, h, b);
      for (int i = 0; i < n_tiles; ++i) {
        const int st = i % stages, par = ((i / stages) & 1) ^ 1;
        const int k0 = (t_begin + i) * kBN;
        mbar_wait(&sm.k_empty[st], par);
        mbar_expect_tx(&sm.k_full[st], S::kKVBytes);
#pragma unroll
        for (int c = 0; c < D / 64; ++c)
          tma_load_4d(sm.k(st) + c * kBN * 64, &tm_k, &sm.k_full[st],
                      64 * c, k0, kh, b);
        mbar_wait(&sm.v_empty[st], par);
        mbar_expect_tx(&sm.v_full[st], S::kKVBytes);
#pragma unroll
        for (int c = 0; c < D / 64; ++c)
          tma_load_4d(sm.v(st) + c * kBN * 64, &tm_v, &sm.v_full[st],
                      64 * c, k0, kh, b);
      }
    }
  } else {                               // the consumer warpgroups
    regs_alloc<232>();
    consume<D, NC, BN>(sm, p, b, h, q0, t_begin, n_tiles, stages);
  }
}

// ---- host side ----------------------------------------------------------

template <int D, int NC, int BN>
cudaError_t launch(const CUtensorMap& tq, const CUtensorMap& tk,
                   const CUtensorMap& tv, const Params& p, int B,
                   int stages, cudaStream_t stream) {
  using S = Smem<D, NC, BN>;
  const int bytes = S::bytes(stages) + 1024;      // + alignment slack
  if (stages < 1 || stages > kMaxStages || bytes > kSmemLimit)
    return cudaErrorInvalidValue;
  auto kernel = stages == 2 ? flash_wgmma_kernel<D, NC, BN, 2>
                            : flash_wgmma_kernel<D, NC, BN, 0>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid(B * p.H, (p.Sq + S::kBM - 1) / S::kBM);
  kernel<<<grid, (NC + 1) * 128, bytes, stream>>>(tq, tk, tv, p, stages);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_tile(const CUtensorMap& tq, const CUtensorMap& tk,
                        const CUtensorMap& tv, const Params& p, int B,
                        int block_q, int block_k, int stages,
                        cudaStream_t stream) {
  if (block_q == 128 && block_k == 128)
    return launch<D, 2, 128>(tq, tk, tv, p, B, stages, stream);
  if (block_q == 128 && block_k == 64)
    return launch<D, 2, 64>(tq, tk, tv, p, B, stages, stream);
  if (block_q == 64 && block_k == 128)
    return launch<D, 1, 128>(tq, tk, tv, p, B, stages, stream);
  if (block_q == 64 && block_k == 64)
    return launch<D, 1, 64>(tq, tk, tv, p, B, stages, stream);
  return cudaErrorInvalidValue;
}

}  // namespace

// q [B, Sq, H, D], k/v [B, Sk, Kh, D], o [B, Sq, H, D], bf16 on the device,
// with element strides {q_b, q_s, q_h, k_b, k_s, k_h, v_b, v_s, v_h, o_b,
// o_s, o_h} in `strides` (host memory) and unit stride along D; q, k, v
// 16-byte aligned with strides a multiple of 8 elements (TMA).  D is 64 or
// 128.  window <= 0 and softcap <= 0 mean none.  The tile: block_q (64
// or 128) q rows, block_k (64 or 128) keys, a ring of `stages` (1 to 4,
// within 227 KB) K/V tiles; 128, 128, 2 by default.  A non-null `lse`
// (float32 [B, H, Sq]) receives each row's log-sum-exp of its scaled,
// soft-capped scores for the backward (flash_attention_bwd.cu); null
// writes nothing more.  Launches on `stream`;
// returns 0, a cudaError_t (cudaErrorInvalidValue for a tile outside that
// set), or -CUresult when a tensor map cannot be encoded (-1000: the
// CUDA driver has no cuTensorMapEncodeTiled).
extern "C" int flash_attention_wgmma_launch(
    const void* q, const void* k, const void* v, void* o, int B, int H,
    int Kh, int Sq, int Sk, int D, const long long* strides, int causal,
    int window, float softcap, float scale, int block_q, int block_k,
    int stages, float* lse, cudaStream_t stream) {
  if ((D != 64 && D != 128) || (block_q != 64 && block_q != 128) ||
      (block_k != 64 && block_k != 128))
    return static_cast<int>(cudaErrorInvalidValue);
  EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return -1000;
  CUtensorMap tq, tk, tv;
  CUresult r = encode_bshd(fn, &tq, q, B, Sq, H, D, strides, block_q);
  if (r == CUDA_SUCCESS)
    r = encode_bshd(fn, &tk, k, B, Sk, Kh, D, strides + 3, block_k);
  if (r == CUDA_SUCCESS)
    r = encode_bshd(fn, &tv, v, B, Sk, Kh, D, strides + 6, block_k);
  if (r != CUDA_SUCCESS) return -static_cast<int>(r);

  Params p;
  p.o = o;
  p.os_b = strides[9];
  p.os_s = strides[10];
  p.os_h = strides[11];
  p.H = H;
  p.Kh = Kh;
  p.Sq = Sq;
  p.Sk = Sk;
  p.causal = causal;
  p.window = window;
  p.softcap = softcap;
  p.cap_in = softcap > 0.f ? scale / softcap : 0.f;
  p.fac = softcap > 0.f ? kLog2e : scale * kLog2e;
  p.lse = lse;
  p.lse_fac = softcap > 0.f ? 1.f : scale;
  cudaError_t err;
  if (D == 128)
    err = launch_tile<128>(tq, tk, tv, p, B, block_q, block_k, stages,
                           stream);
  else
    err = launch_tile<64>(tq, tk, tv, p, B, block_q, block_k, stages,
                          stream);
  return static_cast<int>(err);
}
