// Flash-attention backward for Hopper (sm_90a) on the tensor cores: the
// gradients dq, dk, dv of the bf16 causal / sliding-window / tanh-soft-capped
// grouped-query attention of flash_attention_wgmma.cu, head dims 64 and 128.
// float32 and the other head dims take flash_attention_bwd.cu (fp32 FMAs).
//
// The JAX package has no backward kernel: off TPU its flash dispatch runs
// the chunked jnp path, which XLA differentiates.  The forward this
// differentiates replaces the Pallas TPU kernel
//   src/repro/kernels/flash_attention/kernel.py:103 (flash_attention_fwd).
//
// With x_ij = q_i . k_j / sqrt(D), s_ij = cap(x_ij), the row's log-sum-exp
// L_i (written by the forward) and the visible mask:
//   P_ij  = exp(s_ij - L_i) where visible, else 0
//   D_i   = sum_d dO_id O_id                           (pre-pass)
//   dS_ij = P_ij (dO_i . v_j - D_i) (1 - (s_ij / cap)^2 with a soft-cap)
//   dV_j  = sum_i bf16(P_ij) dO_i                       (GQA: summed over the
//   dK_j  = sum_i bf16(dS_ij) q_i / sqrt(D)             q heads of k's group)
//   dQ_i  = sum_j bf16(dS_ij) k_j / sqrt(D).
// The tensor cores take bf16 operands, so P and dS are rounded to bf16 where
// they enter a product, and nowhere else (ref.attention_grads with
// operand_dtype=torch.bfloat16 rounds at the same two places).  A row with
// nothing visible has P = 0, so it gets zero gradient (its forward output is
// zeros).  No atomics: two calls give the same bits.
//
// What bounds it on an H100: operations.  At yi-6b's layer at the train
// step's microbatch, (B, Sq, Sk, H, Kh, D) = (1, 4096, 4096, 32, 4, 128),
// causal, the five products of the backward (Q K^T again, dO V^T, P^T dO,
// dS^T Q, dS K) over the visible half are 343.6 GFLOP against ~100 MB of
// inputs and outputs: 0.3475 ms at the bf16 peak (989 TFLOP/s).  This
// design executes seven products, 481 GFLOP (>= 0.49 ms at the peak):
// Q K^T and dO V^T once in the dK/dV kernel and again in the dQ kernel,
// the price of determinism without atomics.  Every product is a wgmma:
//   * dK/dV kernel, one block per (KV tile of 128 keys, q head): two
//     consumer warpgroups own 64 keys each, their K and V rows held in
//     shared memory for the whole block.  A producer warp streams the q
//     tiles (64 rows of Q, dO and the rows' (L log2 e, D_i)) that can see
//     the block's keys by TMA into a 2-stage ring.  Per q tile a warpgroup
//     computes S^T = K Q^T and dP^T = V dO^T (both operands K-major: D is
//     contiguous), then P^T = exp2(S^T scale log2 e - L log2 e) on the
//     special-function unit and dS^T = P^T (dP^T - D_i) in the accumulator
//     registers (masks only on tiles that cross the diagonal, the window
//     edge or the Sq / Sk edge; fully masked tiles are skipped), packs them
//     to bf16 in place (the accumulator layout is the A-operand layout) and
//     accumulates dV += P^T dO and dK += dS^T Q from registers, dO and Q
//     MN-major (the transpose bit).
//   * Balance over the causal triangle (design (a)).  One block per (KV
//     tile, KV head) gives 128 blocks at B=1 on 132 SMs, the first walking
//     32 q tiles x 8 q heads and the last one 1 x 8: the slowest about
//     twice the mean, and a persistent grid over those units cannot split
//     them.  One block per (KV tile, q head) gives 1024 blocks, issued
//     heaviest first, each at most 64 q tiles: the card stays busy to the
//     end.  Each block writes float32 dK / dV partials [B, Sk, H, D]
//     (2 x 64 MiB at B=1, ~0.08 ms of HBM traffic), and a fixed-order pass
//     sums each group's H / Kh heads, scales dK and rounds to bf16.
//   * dQ kernel, one block per (128 q rows, q head), heaviest first: Q and
//     dO stay in shared memory, K and V tiles of 64 keys come by TMA into a
//     2-stage ring (the forward's kind); S = Q K^T and dP = dO V^T from
//     shared memory, P and dS in registers, dQ += dS K from registers (K
//     MN-major).
//   * Registers: dK and dV take 128 fp32 registers a thread at D 128 before
//     S^T and dP^T; the producer warpgroup gives its registers to the two
//     consumer warpgroups (setmaxnreg: 24 down, 240 up).
// Four launches: the D_i pre-pass (which also lays out L log2 e beside D_i,
// rows padded to 128 with zeros), dQ, dK/dV, the group sum.  q, k, v and dO
// are read in place by TMA through their strides in the model's [B, S,
// heads, D] layout (16-byte aligned pointers and strides); the ragged Sq /
// Sk edges are zero-filled by TMA and masked here.

#include "hopper.cuh"  // kernels/include: shared with the forwards

namespace {

using namespace hopper;
using namespace hopper_host;

constexpr int kRows = 64;          // rows of a consumer warpgroup's tile
constexpr int kStages = 2;         // depth of both kernels' rings
constexpr int kKeysKV = 128;       // dK/dV block: keys (2 warpgroups)
constexpr int kRowsKV = 64;        //   q rows of a streamed tile
constexpr int kRowsQ = 128;        // dQ block: q rows (2 warpgroups)
constexpr int kKeysQ = 64;         //   keys of a streamed tile
constexpr int kPadRows = 128;      // the stats rows are padded to this
constexpr int kSmemLimit = 232448; // a block's shared-memory limit on sm_90
constexpr float kLog2e = 1.4426950408889634f;

struct Strides {
  long long b, s, h;               // in elements; the head-dim stride is 1
};

struct Params {
  const __nv_bfloat16* o;
  const __nv_bfloat16* dout;
  const float* lse;                // [B, H, Sq], natural-log units
  float2* stats;                   // [B, H, Sq_pad]: (L log2 e, D_i)
  float* dk_part;                  // [B, Sk, H, D] float32 partials
  float* dv_part;
  __nv_bfloat16* dq;
  __nv_bfloat16* dk;
  __nv_bfloat16* dv;
  Strides os, dos, dqs, dks, dvs;
  int B, H, Kh, Sq, Sk, Sq_pad, D;
  int causal;
  int window;                      // <= 0: no window
  float softcap;                   // <= 0: no soft-cap
  float cap_in;                    // scale / softcap: product -> tanh's argument
  float fac;                       // scale log2 e (no soft-cap)
  float scale;                     // 1 / sqrt(D)
};

__device__ __forceinline__ bool visible(const Params& p, int row, int key) {
  bool ok = row < p.Sq && key < p.Sk;
  if (p.causal) ok = ok && key <= row;
  if (p.window > 0) ok = ok && key > row - p.window;
  return ok;
}

// rows [r0, r0 + nr) x keys [k0, k0 + nk): 0 every pair visible, 1 some
// pair masked, 2 none visible
__device__ __forceinline__ int tile_mask(const Params& p, int r0, int nr,
                                         int k0, int nk) {
  if (r0 >= p.Sq || k0 >= p.Sk) return 2;
  if (p.causal && k0 > r0 + nr - 1) return 2;
  if (p.window > 0 && k0 + nk - 1 <= r0 - p.window) return 2;
  if (r0 + nr > p.Sq || k0 + nk > p.Sk) return 1;
  if (p.causal && k0 + nk - 1 > r0) return 1;
  if (p.window > 0 && k0 <= r0 + nr - 1 - p.window) return 1;
  return 0;
}

// P and dS at one score from the raw product x, dP, the row's L log2 e and
// D_i
__device__ __forceinline__ void p_ds(const Params& p, float x, float dp,
                                     float l2, float di, float& pv,
                                     float& dsv) {
  if (p.softcap > 0.f) {
    const float t = tanhf(x * p.cap_in);
    pv = exp2_approx(fmaf(p.softcap * t, kLog2e, -l2));
    dsv = pv * (dp - di) * (1.f - t * t);
  } else {
    pv = exp2_approx(fmaf(x, p.fac, -l2));
    dsv = pv * (dp - di);
  }
}

// an accumulator of m64nNk16 packed to bf16x2 as the A operand of the
// products over its N columns (the forward's pack_p)
template <int N>
__device__ __forceinline__ void pack(const float (&s)[N / 2],
                                     uint32_t (&pk)[N / 4]) {
#pragma unroll
  for (int j = 0; j < N / 8; ++j) {
    pk[2 * j] = pack_bf16x2(s[4 * j], s[4 * j + 1]);
    pk[2 * j + 1] = pack_bf16x2(s[4 * j + 2], s[4 * j + 3]);
  }
}

// acc[64 x D] += A[64 x N] . B[N x D]: A from registers, B a [N rows, D]
// tile in shared memory in 64-column swizzled blocks (MN-major)
template <int D, int N>
__device__ __forceinline__ void mma_rs(float (&acc)[D / 2],
                                       const uint32_t (&a)[N / 4],
                                       const __nv_bfloat16* b) {
#pragma unroll
  for (int kk = 0; kk < N / 16; ++kk) {
    const uint32_t ak[4] = {a[4 * kk], a[4 * kk + 1], a[4 * kk + 2],
                            a[4 * kk + 3]};
    const uint64_t db = desc_sw128(b + kk * 16 * 64, N * 64 * 2, 1024);
    if constexpr (D == 128)
      wgmma_m64n128k16_rs(acc, ak, db, 1);
    else
      wgmma_m64n64k16_rs(acc, ak, db, 1);
  }
}

// s[64 x 64] = A[64 rows of a tile of `a_rows`, D] . B[64 rows, D]^T, both
// K-major in 64-column swizzled blocks
template <int D>
__device__ __forceinline__ void mma_ss(float (&s)[32],
                                       const __nv_bfloat16* a, int a_rows,
                                       int a_row0, const __nv_bfloat16* b) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const uint64_t da = desc_sw128(
        a + (kk / 4) * a_rows * 64 + a_row0 * 64 + (kk % 4) * 16, 16, 1024);
    const uint64_t db = desc_sw128(b + (kk / 4) * 64 * 64 + (kk % 4) * 16,
                                   16, 1024);
    wgmma_m64n64k16_ss(s, da, db, kk > 0);
  }
}

// one bulk copy of `bytes` (a multiple of 16) counted on `bar`
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n"
      :: "r"(smem_u32(dst)), "l"(reinterpret_cast<uint64_t>(src)),
         "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// ---- the D_i pre-pass --------------------------------------------------

// stats[b, h, i] = (L_i log2 e, D_i) for i < Sq, (0, 0) on the padding;
// one warp per (b, h, i)
__global__ void __launch_bounds__(256)
flash_bwd_stats_kernel(const Params p) {
  const long long row = (long long)blockIdx.x * 8 + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= (long long)p.B * p.H * p.Sq_pad) return;
  const int i = (int)(row % p.Sq_pad);
  const long long bh = row / p.Sq_pad;
  const int h = (int)(bh % p.H);
  const int b = (int)(bh / p.H);
  float l2 = 0.f, acc = 0.f;
  if (i < p.Sq) {
    const __nv_bfloat16* ob = p.o + b * p.os.b + i * p.os.s + h * p.os.h;
    const __nv_bfloat16* gb =
        p.dout + b * p.dos.b + i * p.dos.s + h * p.dos.h;
    for (int d = lane; d < p.D; d += 32)
      acc = fmaf(__bfloat162float(gb[d]), __bfloat162float(ob[d]), acc);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      acc += __shfl_xor_sync(0xffffffffu, acc, off);
    l2 = p.lse[bh * p.Sq + i] * kLog2e;
  }
  if (lane == 0) p.stats[row] = make_float2(l2, acc);
}

// ---- dK / dV -------------------------------------------------------------

// K and V of the block (128 keys, 64-column blocks of 128-byte rows), a
// ring of q tiles (Q, dO: 64 rows; the rows' stats), then the barriers;
// every tile a multiple of 1024 bytes from a 1024-aligned base
template <int D>
struct SmemKV {
  static constexpr int kKVBytes = kKeysKV * D * 2;
  static constexpr int kQBytes = kRowsKV * D * 2;
  static constexpr int kStatBytes = kRowsKV * 8;
  static constexpr int kBytes =
      2 * kKVBytes + kStages * (2 * kQBytes + kStatBytes) +
      8 * (1 + 2 * kStages);
  __nv_bfloat16* k;
  __nv_bfloat16* v;
  __nv_bfloat16* q0;
  __nv_bfloat16* do0;
  float2* st0;
  uint64_t* kv_full;
  uint64_t* full;
  uint64_t* empty;
  __device__ explicit SmemKV(unsigned char* base) {
    k = reinterpret_cast<__nv_bfloat16*>(base);
    v = reinterpret_cast<__nv_bfloat16*>(base + kKVBytes);
    q0 = reinterpret_cast<__nv_bfloat16*>(base + 2 * kKVBytes);
    do0 = reinterpret_cast<__nv_bfloat16*>(base + 2 * kKVBytes +
                                           kStages * kQBytes);
    st0 = reinterpret_cast<float2*>(base + 2 * kKVBytes +
                                    2 * kStages * kQBytes);
    kv_full = reinterpret_cast<uint64_t*>(
        base + 2 * kKVBytes + kStages * (2 * kQBytes + kStatBytes));
    full = kv_full + 1;
    empty = full + kStages;
  }
  __device__ __nv_bfloat16* q(int st) const { return q0 + st * kRowsKV * D; }
  __device__ __nv_bfloat16* dO(int st) const {
    return do0 + st * kRowsKV * D;
  }
  __device__ float2* stats(int st) const { return st0 + st * kRowsKV; }
};

template <int D>
__device__ __forceinline__ void consume_kv(const SmemKV<D>& sm,
                                           const Params& p, int b, int h,
                                           int k0, int t_lo, int n_q) {
  const int wg = threadIdx.x / 128;
  const int t = threadIdx.x % 128;
  const int lane = t % 32;
  const int kw0 = k0 + wg * kRows;                   // the warpgroup's keys
  const int key0 = kw0 + (t / 32) * 16 + lane / 4;   // this thread's (+ 8)
  const int col0 = 2 * (lane % 4);

  float dk[D / 2], dv[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dk[i] = dv[i] = 0.f;

  mbar_wait(sm.kv_full, 0);
  for (int i = 0; i < n_q; ++i) {
    const int st = i % kStages;
    const int q0 = (t_lo + i) * kRowsKV;
    mbar_wait(&sm.full[st], (i / kStages) & 1);
    const int mask = tile_mask(p, q0, kRowsKV, kw0, kRows);
    if (mask != 2) {
      float s[kRowsKV / 2], dp[kRowsKV / 2];
      wgmma_fence();
      mma_ss<D>(s, sm.k, kKeysKV, wg * kRows, sm.q(st));     // S^T = K Q^T
      mma_ss<D>(dp, sm.v, kKeysKV, wg * kRows, sm.dO(st));   // dP^T = V dO^T
      wgmma_commit();
      wgmma_wait<0>();
      fence_operands(s);
      fence_operands(dp);
      const float2* stats = sm.stats(st);
#pragma unroll
      for (int j = 0; j < kRowsKV / 8; ++j) {
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int col = 8 * j + col0 + c;              // the q row
          const float2 ld = stats[col];
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            const int idx = 4 * j + 2 * r + c;
            float pv, dsv;
            p_ds(p, s[idx], dp[idx], ld.x, ld.y, pv, dsv);
            if (mask == 1 && !visible(p, q0 + col, key0 + 8 * r))
              pv = dsv = 0.f;
            s[idx] = pv;
            dp[idx] = dsv;
          }
        }
      }
      uint32_t pk[kRowsKV / 4], pd[kRowsKV / 4];
      pack<kRowsKV>(s, pk);
      pack<kRowsKV>(dp, pd);
      wgmma_fence();
      mma_rs<D, kRowsKV>(dv, pk, sm.dO(st));                 // dV += P^T dO
      mma_rs<D, kRowsKV>(dk, pd, sm.q(st));                  // dK += dS^T Q
      wgmma_commit();
      wgmma_wait<0>();
      fence_operands(dv);
      fence_operands(dk);
      fence_operands(pk);
      fence_operands(pd);
    }
    mbar_arrive(&sm.empty[st]);
  }

  // this head's float32 partials; the group sum scales dK
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int key = key0 + 8 * r;
    if (key >= p.Sk) continue;
    const long long off = (((long long)b * p.Sk + key) * p.H + h) * D;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      const int c = 8 * j + col0;
      *reinterpret_cast<float2*>(p.dk_part + off + c) =
          make_float2(dk[4 * j + 2 * r], dk[4 * j + 2 * r + 1]);
      *reinterpret_cast<float2*>(p.dv_part + off + c) =
          make_float2(dv[4 * j + 2 * r], dv[4 * j + 2 * r + 1]);
    }
  }
}

// compiled for three warpgroups' registers (168 a thread), which setmaxnreg
// moves from the producer to the consumers at run time
template <int D>
__global__ void __launch_bounds__(3 * 128, 1)
flash_bwd_dkdv_wgmma_kernel(const __grid_constant__ CUtensorMap tm_q,
                            const __grid_constant__ CUtensorMap tm_k,
                            const __grid_constant__ CUtensorMap tm_v,
                            const __grid_constant__ CUtensorMap tm_do,
                            const Params p) {
  using S = SmemKV<D>;
  extern __shared__ unsigned char smem_raw[];
  const S sm(smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023));

  // the KV tiles in order (the heaviest first under the causal mask), each
  // with every (b, q head)
  const int BH = p.B * p.H;
  const int kt = blockIdx.x / BH;
  const int bh = blockIdx.x - kt * BH;
  const int b = bh / p.H;
  const int h = bh - b * p.H;
  const int kh = h / (p.H / p.Kh);
  const int k0 = kt * kKeysKV;

  // the q rows that can see any key of this tile
  const int q_lo = p.causal ? k0 : 0;
  const int q_hi =
      p.window > 0 ? min(p.Sq, k0 + kKeysKV - 1 + p.window) : p.Sq;
  const int t_lo = q_lo / kRowsKV;
  const int n_q = q_hi > q_lo ? (q_hi + kRowsKV - 1) / kRowsKV - t_lo : 0;

  if (threadIdx.x == 0) {
    mbar_init(sm.kv_full, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&sm.full[s], 1);
      mbar_init(&sm.empty[s], 2 * 128);
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (threadIdx.x >= 2 * 128) {            // the producer warpgroup
    regs_dealloc<24>();
    if (threadIdx.x == 2 * 128) {
      mbar_expect_tx(sm.kv_full, 2 * S::kKVBytes);
#pragma unroll
      for (int c = 0; c < D / 64; ++c) {
        tma_load_4d(sm.k + c * kKeysKV * 64, &tm_k, sm.kv_full, 64 * c, k0,
                    kh, b);
        tma_load_4d(sm.v + c * kKeysKV * 64, &tm_v, sm.kv_full, 64 * c, k0,
                    kh, b);
      }
      const float2* stats = p.stats + (long long)bh * p.Sq_pad;
      for (int i = 0; i < n_q; ++i) {
        const int st = i % kStages, par = ((i / kStages) & 1) ^ 1;
        const int q0 = (t_lo + i) * kRowsKV;
        mbar_wait(&sm.empty[st], par);
        mbar_expect_tx(&sm.full[st], 2 * S::kQBytes + S::kStatBytes);
#pragma unroll
        for (int c = 0; c < D / 64; ++c) {
          tma_load_4d(sm.q(st) + c * kRowsKV * 64, &tm_q, &sm.full[st],
                      64 * c, q0, h, b);
          tma_load_4d(sm.dO(st) + c * kRowsKV * 64, &tm_do, &sm.full[st],
                      64 * c, q0, h, b);
        }
        bulk_load(sm.stats(st), stats + q0, S::kStatBytes, &sm.full[st]);
      }
    }
  } else {                                 // the consumer warpgroups
    regs_alloc<240>();
    consume_kv<D>(sm, p, b, h, k0, t_lo, n_q);
  }
}

// dk[b, j, kh] = scale * sum of the group's partials, dv the same unscaled,
// summed in head order; two columns a thread
__global__ void __launch_bounds__(256)
flash_bwd_reduce_kernel(const Params p) {
  const int half = p.D / 2;
  const long long idx = (long long)blockIdx.x * 256 + threadIdx.x;
  if (idx >= (long long)p.B * p.Sk * p.Kh * half) return;
  const int c = (int)(idx % half) * 2;
  long long r = idx / half;
  const int kh = (int)(r % p.Kh);
  r /= p.Kh;
  const int key = (int)(r % p.Sk);
  const int b = (int)(r / p.Sk);
  const int rep = p.H / p.Kh;
  const long long base =
      (((long long)b * p.Sk + key) * p.H + (long long)kh * rep) * p.D + c;
  float2 sk = make_float2(0.f, 0.f), sv = make_float2(0.f, 0.f);
  for (int hh = 0; hh < rep; ++hh) {
    const long long at = base + (long long)hh * p.D;
    const float2 a = *reinterpret_cast<const float2*>(p.dk_part + at);
    const float2 g = *reinterpret_cast<const float2*>(p.dv_part + at);
    sk.x += a.x;
    sk.y += a.y;
    sv.x += g.x;
    sv.y += g.y;
  }
  *reinterpret_cast<uint32_t*>(p.dk + b * p.dks.b + key * p.dks.s +
                               kh * p.dks.h + c) =
      pack_bf16x2(sk.x * p.scale, sk.y * p.scale);
  *reinterpret_cast<uint32_t*>(p.dv + b * p.dvs.b + key * p.dvs.s +
                               kh * p.dvs.h + c) = pack_bf16x2(sv.x, sv.y);
}

// ---- dQ --------------------------------------------------------------------

// Q and dO of the block (128 rows), a ring of K / V tiles (64 keys), then
// the barriers
template <int D>
struct SmemQ {
  static constexpr int kQBytes = kRowsQ * D * 2;
  static constexpr int kKVBytes = kKeysQ * D * 2;
  static constexpr int kBytes =
      2 * kQBytes + 2 * kStages * kKVBytes + 8 * (1 + 2 * kStages);
  __nv_bfloat16* q;
  __nv_bfloat16* dO;
  __nv_bfloat16* k0;
  __nv_bfloat16* v0;
  uint64_t* q_full;
  uint64_t* full;
  uint64_t* empty;
  __device__ explicit SmemQ(unsigned char* base) {
    q = reinterpret_cast<__nv_bfloat16*>(base);
    dO = reinterpret_cast<__nv_bfloat16*>(base + kQBytes);
    k0 = reinterpret_cast<__nv_bfloat16*>(base + 2 * kQBytes);
    v0 = reinterpret_cast<__nv_bfloat16*>(base + 2 * kQBytes +
                                          kStages * kKVBytes);
    q_full = reinterpret_cast<uint64_t*>(base + 2 * kQBytes +
                                         2 * kStages * kKVBytes);
    full = q_full + 1;
    empty = full + kStages;
  }
  __device__ __nv_bfloat16* k(int st) const { return k0 + st * kKeysQ * D; }
  __device__ __nv_bfloat16* v(int st) const { return v0 + st * kKeysQ * D; }
};

template <int D>
__device__ __forceinline__ void consume_q(const SmemQ<D>& sm, const Params& p,
                                          int b, int h, int q0, int t_begin,
                                          int n_tiles) {
  const int wg = threadIdx.x / 128;
  const int t = threadIdx.x % 128;
  const int lane = t % 32;
  const int rq0 = q0 + wg * kRows;                   // the warpgroup's rows
  const int row0 = rq0 + (t / 32) * 16 + lane / 4;   // this thread's (+ 8)
  const int col0 = 2 * (lane % 4);

  float l2[2], di[2];
  const float2* stats =
      p.stats + ((long long)b * p.H + h) * p.Sq_pad;   // rows < Sq_pad
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float2 ld = stats[row0 + 8 * r];
    l2[r] = ld.x;
    di[r] = ld.y;
  }
  float dq[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dq[i] = 0.f;

  mbar_wait(sm.q_full, 0);
  for (int i = 0; i < n_tiles; ++i) {
    const int st = i % kStages;
    const int k0 = (t_begin + i) * kKeysQ;
    mbar_wait(&sm.full[st], (i / kStages) & 1);
    const int mask = tile_mask(p, rq0, kRows, k0, kKeysQ);
    if (mask != 2) {
      float s[kKeysQ / 2], dp[kKeysQ / 2];
      wgmma_fence();
      mma_ss<D>(s, sm.q, kRowsQ, wg * kRows, sm.k(st));      // S = Q K^T
      mma_ss<D>(dp, sm.dO, kRowsQ, wg * kRows, sm.v(st));    // dP = dO V^T
      wgmma_commit();
      wgmma_wait<0>();
      fence_operands(s);
      fence_operands(dp);
#pragma unroll
      for (int j = 0; j < kKeysQ / 8; ++j) {
#pragma unroll
        for (int r = 0; r < 2; ++r) {
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            const int idx = 4 * j + 2 * r + c;
            float pv, dsv;
            p_ds(p, s[idx], dp[idx], l2[r], di[r], pv, dsv);
            if (mask == 1 && !visible(p, row0 + 8 * r, k0 + 8 * j + col0 + c))
              dsv = 0.f;
            dp[idx] = dsv;
          }
        }
      }
      uint32_t pd[kKeysQ / 4];
      pack<kKeysQ>(dp, pd);
      wgmma_fence();
      mma_rs<D, kKeysQ>(dq, pd, sm.k(st));                   // dQ += dS K
      wgmma_commit();
      wgmma_wait<0>();
      fence_operands(dq);
      fence_operands(pd);
    }
    mbar_arrive(&sm.empty[st]);
  }

  __nv_bfloat16* qb = p.dq + b * p.dqs.b + h * p.dqs.h;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + 8 * r;
    if (row >= p.Sq) continue;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      *reinterpret_cast<uint32_t*>(qb + row * p.dqs.s + 8 * j + col0) =
          pack_bf16x2(dq[4 * j + 2 * r] * p.scale,
                      dq[4 * j + 2 * r + 1] * p.scale);
  }
}

template <int D>
__global__ void __launch_bounds__(3 * 128, 1)
flash_bwd_dq_wgmma_kernel(const __grid_constant__ CUtensorMap tm_q,
                          const __grid_constant__ CUtensorMap tm_k,
                          const __grid_constant__ CUtensorMap tm_v,
                          const __grid_constant__ CUtensorMap tm_do,
                          const Params p) {
  using S = SmemQ<D>;
  extern __shared__ unsigned char smem_raw[];
  const S sm(smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023));

  // the q tiles from the last (the heaviest under the causal mask), each
  // with every (b, q head)
  const int BH = p.B * p.H;
  const int n_qt = (p.Sq + kRowsQ - 1) / kRowsQ;
  const int qt = n_qt - 1 - (int)(blockIdx.x / BH);
  const int bh = blockIdx.x % BH;
  const int b = bh / p.H;
  const int h = bh - b * p.H;
  const int kh = h / (p.H / p.Kh);
  const int q0 = qt * kRowsQ;

  // the keys any row of this block can see (the forward's bounds)
  int kv_end = p.Sk;
  if (p.causal) kv_end = min(kv_end, min(q0 + kRowsQ, p.Sq));
  const int kv_begin = p.window > 0 ? max(0, q0 - p.window + 1) : 0;
  const int t_begin = kv_begin / kKeysQ;
  const int n_tiles = max(0, (kv_end + kKeysQ - 1) / kKeysQ - t_begin);

  if (threadIdx.x == 0) {
    mbar_init(sm.q_full, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&sm.full[s], 1);
      mbar_init(&sm.empty[s], 2 * 128);
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (threadIdx.x >= 2 * 128) {            // the producer warpgroup
    regs_dealloc<24>();
    if (threadIdx.x == 2 * 128) {
      mbar_expect_tx(sm.q_full, 2 * S::kQBytes);
#pragma unroll
      for (int c = 0; c < D / 64; ++c) {
        tma_load_4d(sm.q + c * kRowsQ * 64, &tm_q, sm.q_full, 64 * c, q0, h,
                    b);
        tma_load_4d(sm.dO + c * kRowsQ * 64, &tm_do, sm.q_full, 64 * c, q0,
                    h, b);
      }
      for (int i = 0; i < n_tiles; ++i) {
        const int st = i % kStages, par = ((i / kStages) & 1) ^ 1;
        const int k0 = (t_begin + i) * kKeysQ;
        mbar_wait(&sm.empty[st], par);
        mbar_expect_tx(&sm.full[st], 2 * S::kKVBytes);
#pragma unroll
        for (int c = 0; c < D / 64; ++c) {
          tma_load_4d(sm.k(st) + c * kKeysQ * 64, &tm_k, &sm.full[st],
                      64 * c, k0, kh, b);
          tma_load_4d(sm.v(st) + c * kKeysQ * 64, &tm_v, &sm.full[st],
                      64 * c, k0, kh, b);
        }
      }
    }
  } else {                                 // the consumer warpgroups
    regs_alloc<240>();
    consume_q<D>(sm, p, b, h, q0, t_begin, n_tiles);
  }
}

// ---- host side ----------------------------------------------------------

template <typename Kernel>
cudaError_t set_smem(Kernel kernel, int bytes) {
  if (bytes > kSmemLimit) return cudaErrorInvalidValue;
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

// maps: Q and dO in boxes of 128 rows (dQ) and of 64 rows (dK/dV), K and
// V in boxes of 64 keys (dQ) and of 128 keys (dK/dV)
template <int D>
cudaError_t launch(const CUtensorMap* q128, const CUtensorMap* q64,
                   const CUtensorMap* k64, const CUtensorMap* k128,
                   const CUtensorMap* v64, const CUtensorMap* v128,
                   const CUtensorMap* do128, const CUtensorMap* do64,
                   const Params& p, cudaStream_t stream) {
  const long long rows = (long long)p.B * p.H * p.Sq_pad;
  flash_bwd_stats_kernel<<<(unsigned)((rows + 7) / 8), 256, 0, stream>>>(p);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  const int bq = SmemQ<D>::kBytes + 1024;            // + alignment slack
  err = set_smem(flash_bwd_dq_wgmma_kernel<D>, bq);
  if (err != cudaSuccess) return err;
  const unsigned n_qt = (p.Sq + kRowsQ - 1) / kRowsQ;
  flash_bwd_dq_wgmma_kernel<D><<<n_qt * p.B * p.H, 3 * 128, bq, stream>>>(
      *q128, *k64, *v64, *do128, p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  const int bkv = SmemKV<D>::kBytes + 1024;
  err = set_smem(flash_bwd_dkdv_wgmma_kernel<D>, bkv);
  if (err != cudaSuccess) return err;
  const unsigned n_kt = (p.Sk + kKeysKV - 1) / kKeysKV;
  flash_bwd_dkdv_wgmma_kernel<D>
      <<<n_kt * p.B * p.H, 3 * 128, bkv, stream>>>(*q64, *k128, *v128,
                                                   *do64, p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  const long long n = (long long)p.B * p.Sk * p.Kh * (p.D / 2);
  flash_bwd_reduce_kernel<<<(unsigned)((n + 255) / 256), 256, 0, stream>>>(
      p);
  return cudaGetLastError();
}

}  // namespace

// q/o/dout/dq [B, Sq, H, D], k/v/dk/dv [B, Sk, Kh, D], bf16 on the device,
// with element strides {b, s, h} of q, k, v, dout (read by TMA: 16-byte
// aligned, strides a multiple of 8 elements), o, dq, dk, dv (in that order,
// 24 values in host memory) and unit stride along D; D is 64 or 128.  lse
// (the forward's per-row log-sum-exp) float32 [B, H, Sq]; scratch: stats
// float32 [B, H, Sq_pad, 2] with Sq_pad = Sq rounded up to 128, dk_part and
// dv_part float32 [B, Sk, H, D].  window <= 0 and softcap <= 0 mean none.
// Launches the four kernels on `stream`; returns 0, a cudaError_t
// (cudaErrorInvalidValue for a head dim without an instantiation), or
// -CUresult when a tensor map cannot be encoded (-1000: the CUDA driver has
// no cuTensorMapEncodeTiled).
extern "C" int flash_attention_bwd_wgmma_launch(
    const void* q, const void* k, const void* v, const void* o,
    const void* dout, const float* lse, float* stats, float* dk_part,
    float* dv_part, void* dq, void* dk, void* dv, int B, int H, int Kh,
    int Sq, int Sk, int D, const long long* strides, int causal, int window,
    float softcap, float scale, cudaStream_t stream) {
  if (D != 64 && D != 128) return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t bound = bind_device();  // autograd's thread
  if (bound != cudaSuccess) return static_cast<int>(bound);
  EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return -1000;
  CUtensorMap q128, q64, k64, k128, v64, v128, do128, do64;
  CUresult r = encode_bshd(fn, &q128, q, B, Sq, H, D, strides, kRowsQ);
  if (r == CUDA_SUCCESS)
    r = encode_bshd(fn, &q64, q, B, Sq, H, D, strides, kRowsKV);
  if (r == CUDA_SUCCESS)
    r = encode_bshd(fn, &k64, k, B, Sk, Kh, D, strides + 3, kKeysQ);
  if (r == CUDA_SUCCESS)
    r = encode_bshd(fn, &k128, k, B, Sk, Kh, D, strides + 3, kKeysKV);
  if (r == CUDA_SUCCESS)
    r = encode_bshd(fn, &v64, v, B, Sk, Kh, D, strides + 6, kKeysQ);
  if (r == CUDA_SUCCESS)
    r = encode_bshd(fn, &v128, v, B, Sk, Kh, D, strides + 6, kKeysKV);
  if (r == CUDA_SUCCESS)
    r = encode_bshd(fn, &do128, dout, B, Sq, H, D, strides + 9, kRowsQ);
  if (r == CUDA_SUCCESS)
    r = encode_bshd(fn, &do64, dout, B, Sq, H, D, strides + 9, kRowsKV);
  if (r != CUDA_SUCCESS) return -static_cast<int>(r);

  Params p;
  p.o = static_cast<const __nv_bfloat16*>(o);
  p.dout = static_cast<const __nv_bfloat16*>(dout);
  p.lse = lse;
  p.stats = reinterpret_cast<float2*>(stats);
  p.dk_part = dk_part;
  p.dv_part = dv_part;
  p.dq = static_cast<__nv_bfloat16*>(dq);
  p.dk = static_cast<__nv_bfloat16*>(dk);
  p.dv = static_cast<__nv_bfloat16*>(dv);
  p.dos = {strides[9], strides[10], strides[11]};
  p.os = {strides[12], strides[13], strides[14]};
  p.dqs = {strides[15], strides[16], strides[17]};
  p.dks = {strides[18], strides[19], strides[20]};
  p.dvs = {strides[21], strides[22], strides[23]};
  p.B = B;
  p.H = H;
  p.Kh = Kh;
  p.Sq = Sq;
  p.Sk = Sk;
  p.Sq_pad = (Sq + kPadRows - 1) / kPadRows * kPadRows;
  p.D = D;
  p.causal = causal;
  p.window = window;
  p.softcap = softcap;
  p.cap_in = softcap > 0.f ? scale / softcap : 0.f;
  p.fac = scale * kLog2e;
  p.scale = scale;
  cudaError_t err;
  if (D == 128)
    err = launch<128>(&q128, &q64, &k64, &k128, &v64, &v128, &do128, &do64,
                      p, stream);
  else
    err = launch<64>(&q128, &q64, &k64, &k128, &v64, &v128, &do128, &do64,
                     p, stream);
  return static_cast<int>(err);
}
