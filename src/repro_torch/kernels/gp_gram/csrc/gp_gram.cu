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
//   * by default a 32 x 32 output tile per block of 256 threads (4 outputs
//     a thread): the [2384, 64] cross-Gram gives 150 blocks, about one per
//     SM;
//   * writes are coalesced (a warp stores up to 32 neighbouring columns of
//     a row);
//   * plain fp32 FMAs, no tensor cores: at d <= 32 the work is tiny, and
//     TF32 would not hold the |a|^2+|b|^2-2a.b cancellation near the
//     diagonal to 2e-4.
// Any d is accepted: the block walks d in chunks of 32 staged in shared
// memory.
//
// Beyond kExpandedMaxD features (the tuning daemon's 327-332 knobs) the
// chunked walk makes eleven serial round trips to device memory at d 327,
// each with two barriers and, for every staged value, a global read of ls
// and a division; at the default launch's [64, 64] Gram its 2 x 2 blocks
// do ~1.3 M FMAs, so latency, not arithmetic, set its time.  There, with
// one stage (the default launch), a burst pass (matern52_kernel_burst)
// runs instead:
//   * 1/ls once per block into shared memory;
//   * the rows of xa and of xb a block needs are two contiguous runs in
//     memory: two bulk copies (TMA, stage_runs) land them flat, where a
//     copy a value issued by the SM's own threads costs about a cycle of
//     the SM each (tools/gp_gram_phases.py times the phases);
//   * a warp a row lays them out, scaled, in rows padded for 128-bit reads
//     (relayout), and each output's chain of fmaf over features 0 .. d - 1
//     runs four features a read with no barrier between;
//   * both are bound by shared memory's ~128 bytes a cycle of one SM, so
//     when the grid leaves SMs idle (2 x 2 blocks at [64, 64]) 2 or 4
//     blocks share each tile's rows (grid.z), each taking a contiguous
//     part of them.
// Each output's sum is the same chain, each input scaled with one
// rounding, so the bits equal the chunked walk's
// (tools/default_launch_vs_parent.py).  ~170 KB of shared memory at d 327
// and the default tile: one block an SM.  So it runs only where the grid
// has fewer blocks than the card has SMs; a larger grid (the daemon's
// [3939, 64] candidate cross-Gram: 248 blocks) keeps the chunked walk,
// whose 8 KB blocks, several to an SM, hide the same latency, as does a
// tile whose rows do not fit.
//
// The tile knobs (the reference's block, block_m, num_warps, pipeline) pick
// one of the instantiations below and its ring depth: a BN x BM output tile
// (BN, BM in {32, 64, 128}) per block of 32 NW threads (NW in {1, 2, 4, 8});
// each thread owns rows ty + kTY i and columns tx + kTX j of a pass of kPR
// rows, at most kMaxOutputs outputs a pass, and the block walks the tile's
// rows in BN / kPR passes.  With one stage the block loads each d chunk,
// scaled by 1/ls, then sums it (the default launch); with `stages` 2 to 4
// the chunks of a pass stream through a ring of that many slots filled by
// cp.async, so up to stages - 1 chunks load while one is summed, and once
// a chunk has landed each thread scales the values it copied in place.
// Every output's sums over d run in one fixed order (chunk by chunk,
// feature by feature, one fmaf each, the inputs scaled with one rounding),
// so every tiling gives the same bits as the default one.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "hopper.cuh"

namespace {

constexpr int kChunk = 32;       // d columns staged per pass
constexpr int kExpandedMaxD = 64;   // widest d whose r^2 is expanded
constexpr int kMaxOutputs = 16;  // outputs a thread sums at once
constexpr int kMaxStages = 4;
constexpr int kLoad = 0, kIssue = 1, kScale = 2;   // the staging modes
constexpr int kSmemLimit = 232448;  // a block's shared-memory limit on sm_90

__host__ __device__ constexpr int cmin(int a, int b) { return a < b ? a : b; }
__host__ __device__ constexpr int cmax(int a, int b) { return a > b ? a : b; }

template <int BN, int BM, int NW>
struct FwdTile {
  static constexpr int kThreads = 32 * NW;
  static constexpr int kTX = cmin(BM, 32);        // threads along columns
  static constexpr int kTY = kThreads / kTX;      // threads along rows
  static constexpr int kCJ = BM / kTX;            // columns a thread owns
  static constexpr int kRT = BN / kTY;            // rows a thread owns
  static constexpr int kRP = cmin(kRT, cmax(1, kMaxOutputs / kCJ));
  static constexpr int kPR = kRP * kTY;           // rows of one pass
  static constexpr int kPasses = BN / kPR;
  // one ring slot: the pass's rows of xa, the tile's rows of xb (each
  // padded by a column: conflict-free)
  static constexpr int kSlotFloats = (kPR + BM) * (kChunk + 1);
  static constexpr int kStageRows = cmax(kPR, BM);   // rows a pass stages
  static_assert(kThreads % kTX == 0 && BM % kTX == 0, "columns");
  static_assert(kTY <= BN && BN % kTY == 0 && kRT % kRP == 0, "rows");
};

__device__ __forceinline__ void cp_async_4(float* dst, const float* src,
                                           bool ok) {
  // zero-fills the word when !ok (src-size 0)
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d),
               "l"(src), "r"(ok ? 4 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// wait until at most `pending` groups are in flight (0 .. kMaxStages - 1)
__device__ __forceinline__ void cp_async_wait(int pending) {
  switch (pending) {
    case 0: asm volatile("cp.async.wait_group 0;\n" ::: "memory"); break;
    case 1: asm volatile("cp.async.wait_group 1;\n" ::: "memory"); break;
    case 2: asm volatile("cp.async.wait_group 2;\n" ::: "memory"); break;
    default: asm volatile("cp.async.wait_group 3;\n" ::: "memory"); break;
  }
}

// Where a run of global floats starting at `src` lands in its flat buffer:
// at buffer + run_lead(src), so that its 16-byte aligned body stays
// aligned.
__device__ __forceinline__ int run_lead(const float* src) {
  return static_cast<int>((reinterpret_cast<uintptr_t>(src) & 15) >> 2);
}

// Stages two runs of contiguous global floats (src_i [count_i], a count
// may be 0) into flat shared-memory buffers (buf_i: 16-byte aligned,
// flat_floats(count_i) floats), run i from buf_i + run_lead(src_i): thread
// 0 copies each run's 16-byte aligned body with one bulk copy (TMA),
// counted on the mbarrier `bar` (initialised with one arrival), and the
// threads copy the heads and tails (at most 3 floats each); returns once
// all of it has landed and the block has synced (`parity`: the barrier's
// phase).  Staged by the SM's own loads or cp.async, each value costs
// about a cycle of the SM; the bulk copies leave that to the copy engine.
__device__ __forceinline__ void stage_runs(const float* src0, int count0,
                                           float* buf0, const float* src1,
                                           int count1, float* buf1,
                                           uint64_t* bar, int parity) {
  const float* src[2] = {src0, src1};
  const int count[2] = {count0, count1};
  float* buf[2] = {buf0, buf1};
  int lead[2], head[2], body[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    lead[i] = count[i] > 0 ? run_lead(src[i]) : 0;
    head[i] = min(count[i], (4 - lead[i]) & 3);
    body[i] = (count[i] - head[i]) / 4 * 4;
  }
  if (threadIdx.x == 0) {
    hopper::fence_proxy_async();          // the buffers' earlier readers
    hopper::mbar_expect_tx(bar, 4u * (body[0] + body[1]));
#pragma unroll
    for (int i = 0; i < 2; ++i)
      if (body[i] > 0)
        hopper::bulk_load(buf[i] + lead[i] + head[i], src[i] + head[i],
                          4u * body[i], bar);
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int t = threadIdx.x;
    const int tail0 = head[i] + body[i];
    if (t < head[i]) buf[i][lead[i] + t] = src[i][t];
    if (t < count[i] - tail0) buf[i][lead[i] + tail0 + t] = src[i][tail0 + t];
  }
  hopper::mbar_wait(bar, parity);
  __syncthreads();
}

// Floats of a flat buffer for a run of up to `count` floats: its lead, and
// slack for relayout's reads past the run's end, rounded up to keep the
// next buffer 16-byte aligned.
__host__ __device__ inline int flat_floats(int count) {
  return (count + 3 + 8 + 3) / 4 * 4;
}

// Lays `rows` rows (src(r): a row of d floats anywhere in shared memory,
// or null for zeros) out as dp (d rounded up to 4) features a row:
// `put(row, q, value)` stores features 4q .. 4q + 3, zeros at and beyond
// d.  A warp takes a row at a time and its lanes every 32nd group of four
// features: the row's offset from 16-byte alignment (s floats) is the
// same for the whole warp, so each group is two aligned 128-bit reads and
// a funnel shift by s, with no per-value index arithmetic.
template <int kThreads, typename Src, typename Put>
__device__ __forceinline__ void relayout(int rows, int d, int dp, Src src,
                                         Put put) {
  const int lane = threadIdx.x % 32;
  const int nq = dp / 4;
  for (int r = threadIdx.x / 32; r < rows; r += kThreads / 32) {
    const float* f = src(r);
    if (f == nullptr) {
      for (int q = lane; q < nq; q += 32)
        put(r, q, make_float4(0.f, 0.f, 0.f, 0.f));
      continue;
    }
    const int s = static_cast<int>(__cvta_generic_to_shared(f) >> 2) & 3;
    const float4* g = reinterpret_cast<const float4*>(f - s);
    for (int q = lane; q < nq; q += 32) {
      const float4 a = g[q];
      float4 v = a;
      if (s != 0) {
        const float4 b = g[q + 1];
        v = s == 1 ? make_float4(a.y, a.z, a.w, b.x)
          : s == 2 ? make_float4(a.z, a.w, b.x, b.y)
                   : make_float4(a.w, b.x, b.y, b.z);
      }
      const int k = 4 * q;
      if (k + 3 >= d)
        v = make_float4(k < d ? v.x : 0.f, k + 1 < d ? v.y : 0.f,
                        k + 2 < d ? v.z : 0.f, 0.f);
      put(r, q, v);
    }
  }
}

// A burst pass's shared memory (beyond kExpandedMaxD, one stage): the
// mbarrier (4 floats), 1/ls [dp] (d rounded up to 4, zeros beyond d), the
// pass's rows of xa and the tile's rows of xb each padded to `ld` floats
// (16-byte aligned, with an odd number of 16-byte groups, so 128-bit
// reads of eight rows are conflict-free), then the two flat buffers the
// rows land in.
__host__ __device__ inline int burst_dp(int d) { return (d + 3) / 4 * 4; }
__host__ __device__ inline int burst_ld(int d) {
  return (burst_dp(d) / 4) % 2 ? burst_dp(d) : burst_dp(d) + 4;
}
__host__ __device__ inline int burst_floats(int rows_a, int rows_b, int d) {
  return 4 + burst_dp(d) + (rows_a + rows_b) * burst_ld(d) +
         flat_floats(rows_a * d) + flat_floats(rows_b * d);
}

template <int BN, int BM, int NW, bool kDirect>
__global__ void __launch_bounds__(32 * NW)
matern52_kernel(const float* __restrict__ xa, const float* __restrict__ xb,
                const float* __restrict__ ls, const float* __restrict__ sv,
                float* __restrict__ out, int n, int m, int d, int stages) {
  using F = FwdTile<BN, BM, NW>;
  constexpr int kTX = F::kTX, kTY = F::kTY, kCJ = F::kCJ, kRP = F::kRP;
  constexpr int kPR = F::kPR, kLd = kChunk + 1;
  extern __shared__ float smem[];

  const int tid = threadIdx.x;
  const int tx = tid % kTX;               // first output column of the tile
  const int ty = tid / kTX;               // first output row of a pass
  const int col0 = blockIdx.x * BM;
  const int nk = (d + kChunk - 1) / kChunk;
  const float s_var = *sv;
  const float sqrt5 = 2.2360679774997896f;

  for (int pass = 0; pass < F::kPasses; ++pass) {
    const int row0 = blockIdx.y * BN + pass * kPR;
    // chunk kc's inputs into ring slot kc % stages, zeros outside: kLoad
    // loads and scales them, kIssue issues this thread's cp.async copies,
    // kScale scales what they copied once they have landed
    const auto stage = [&](int kc, int mode) {
      float* sa = smem + (kc % stages) * F::kSlotFloats;
      float* sb = sa + kPR * kLd;
      const int k0 = kc * kChunk;
      // one element: dst from src (valid when ok), scaled by inv
      const auto put = [&](float* dst, const float* src, bool ok,
                           float inv) {
        if (mode == kIssue)
          cp_async_4(dst, ok ? src : xa, ok);
        else if (mode == kScale)
          *dst = ok ? *dst * inv : 0.f;
        else
          *dst = ok ? *src * inv : 0.f;
      };
      // row r of both operands' slices per index, as the default launch
      // has always staged them (kPR = BM there)
      for (int idx = tid; idx < F::kStageRows * kChunk;
           idx += F::kThreads) {
        const int r = idx / kChunk;
        const int c = idx % kChunk;
        const int k = k0 + c;
        const float inv = (mode != kIssue && k < d) ? 1.0f / ls[k] : 0.f;
        if (r < kPR)
          put(sa + r * kLd + c, xa + (size_t)(row0 + r) * d + k,
              k < d && row0 + r < n, inv);
        if (r < BM)
          put(sb + r * kLd + c, xb + (size_t)(col0 + r) * d + k,
              k < d && col0 + r < m, inv);
      }
    };

    // a.b, or with kDirect the sum of squared differences
    float dot[kRP][kCJ], a2[kRP], b2[kCJ];
#pragma unroll
    for (int i = 0; i < kRP; ++i) {
      a2[i] = 0.f;
#pragma unroll
      for (int j = 0; j < kCJ; ++j) dot[i][j] = 0.f;
    }
#pragma unroll
    for (int j = 0; j < kCJ; ++j) b2[j] = 0.f;

    for (int kc = 0; kc < stages - 1; ++kc) {
      if (kc < nk) stage(kc, kIssue);
      cp_async_commit();
    }
    for (int kc = 0; kc < nk; ++kc) {
      if (stages == 1) {
        stage(kc, kLoad);
      } else {
        if (kc + stages - 1 < nk) stage(kc + stages - 1, kIssue);
        cp_async_commit();
        cp_async_wait(stages - 1);       // this thread's copies of chunk kc
        stage(kc, kScale);
      }
      __syncthreads();
      const float* sa = smem + (kc % stages) * F::kSlotFloats;
      const float* sb = sa + kPR * kLd;
      const int kn = min(kChunk, d - kc * kChunk);
      for (int c = 0; c < kn; ++c) {
        float bv[kCJ];
#pragma unroll
        for (int j = 0; j < kCJ; ++j) {
          bv[j] = sb[(tx + j * kTX) * kLd + c];
          if (!kDirect) b2[j] = fmaf(bv[j], bv[j], b2[j]);
        }
#pragma unroll
        for (int i = 0; i < kRP; ++i) {
          const float av = sa[(ty + i * kTY) * kLd + c];
          if (!kDirect) a2[i] = fmaf(av, av, a2[i]);
#pragma unroll
          for (int j = 0; j < kCJ; ++j) {
            if (kDirect) {
              const float diff = av - bv[j];
              dot[i][j] = fmaf(diff, diff, dot[i][j]);
            } else {
              dot[i][j] = fmaf(av, bv[j], dot[i][j]);
            }
          }
        }
      }
      __syncthreads();                   // slot kc % stages is free
    }

#pragma unroll
    for (int i = 0; i < kRP; ++i) {
      const int row = row0 + ty + i * kTY;
      if (row >= n) continue;
#pragma unroll
      for (int j = 0; j < kCJ; ++j) {
        const int col = col0 + tx + j * kTX;
        if (col >= m) continue;
        const float d2 =
            kDirect ? dot[i][j] : fmaxf(a2[i] + b2[j] - 2.0f * dot[i][j], 0.0f);
        const float r = d2 > 1e-12f ? sqrtf(d2) : 0.0f;
        const float s = sqrt5 * r;
        out[(size_t)row * m + col] =
            s_var * (1.0f + s + s * s / 3.0f) * expf(-s);
      }
    }
  }
}

// The burst pass (the head note): beyond kExpandedMaxD, with one stage,
// on a grid smaller than the card.  Shared memory as burst_floats lays it
// out; the grid's z splits each tile's rows over gridDim.z blocks, this
// block taking the thread row slots i0 .. i0 + nrp - 1 of kRP, so its
// rows of a pass are a contiguous kPR / gridDim.z of them.  Each output's
// sum is the chunked kernel's chain.
template <int BN, int BM, int NW>
__global__ void __launch_bounds__(32 * NW)
matern52_kernel_burst(const float* __restrict__ xa,
                      const float* __restrict__ xb,
                      const float* __restrict__ ls,
                      const float* __restrict__ sv, float* __restrict__ out,
                      int n, int m, int d) {
  using F = FwdTile<BN, BM, NW>;
  constexpr int kTX = F::kTX, kTY = F::kTY, kCJ = F::kCJ, kRP = F::kRP;
  constexpr int kPR = F::kPR;
  extern __shared__ __align__(16) float burst_smem[];

  const int tid = threadIdx.x;
  const int tx = tid % kTX;               // first output column of the tile
  const int ty = tid / kTX;               // first output row of a pass
  const int col0 = blockIdx.x * BM;
  const float s_var = *sv;
  const float sqrt5 = 2.2360679774997896f;
  const int dp = burst_dp(d), ld = burst_ld(d);
  uint64_t* bar = reinterpret_cast<uint64_t*>(burst_smem);
  float* inv = burst_smem + 4;
  float* rows = inv + dp;                 // the block's rows of xa, then xb's
  float* flat_a = rows + (kPR + BM) * ld;
  float* flat_b = flat_a + flat_floats(kPR * d);
  const int nrp = kRP / (int)gridDim.z;
  const int i0 = (int)blockIdx.z * nrp;
  const int kpr = nrp * kTY;              // this block's rows of a pass
  if (tid == 0) {
    hopper::mbar_init(bar, 1);
    hopper::fence_barrier_init();
  }
  for (int k = tid; k < dp; k += F::kThreads)
    inv[k] = k < d ? 1.0f / ls[k] : 0.f;

  for (int pass = 0; pass < F::kPasses; ++pass) {
    const int row0 = blockIdx.y * BN + pass * kPR;
    const int a0 = row0 + i0 * kTY;       // the first of this block's rows
    __syncthreads();                      // inv, bar; the previous pass
    // the block's rows of xa and the tile's rows of xb, each contiguous
    // in memory, in one burst
    const int na = max(0, min(kpr, n - a0));
    const int nb = max(0, min(BM, m - col0));
    stage_runs(xa + (size_t)a0 * d, na * d, flat_a,
               xb + (size_t)col0 * d, nb * d, flat_b, bar, pass & 1);
    // into the padded rows, scaled by 1/ls with one rounding as the
    // chunked kernel scales them; zeros beyond n (m) rows and d features
    const float* fa = flat_a + (na > 0 ? run_lead(xa + (size_t)a0 * d) : 0);
    const float* fb = flat_b + (nb > 0 ? run_lead(xb + (size_t)col0 * d) : 0);
    relayout<F::kThreads>(
        kpr + BM, d, dp,
        [&](int r) -> const float* {
          if (r < kpr) return r < na ? fa + r * d : nullptr;
          return r - kpr < nb ? fb + (r - kpr) * d : nullptr;
        },
        [&](int r, int q, float4 v) {
          const float4 iv = reinterpret_cast<const float4*>(inv)[q];
          reinterpret_cast<float4*>(rows + r * ld)[q] =
              make_float4(v.x * iv.x, v.y * iv.y, v.z * iv.z, v.w * iv.w);
        });
    __syncthreads();

    // each output's chain of fmaf over features 0 .. dp - 1 (the zeros
    // beyond d add exactly 0), four features a read
    float dot[kRP][kCJ];
#pragma unroll
    for (int i = 0; i < kRP; ++i)
#pragma unroll
      for (int j = 0; j < kCJ; ++j) dot[i][j] = 0.f;
#pragma unroll 2
    for (int q = 0; q < dp / 4; ++q) {
      float4 bv[kCJ];
#pragma unroll
      for (int j = 0; j < kCJ; ++j)
        bv[j] = reinterpret_cast<const float4*>(
            rows + (kpr + tx + j * kTX) * ld)[q];
#pragma unroll
      for (int i = 0; i < kRP; ++i) {
        if (i >= nrp) break;
        const float4 av = reinterpret_cast<const float4*>(
            rows + (ty + i * kTY) * ld)[q];
#pragma unroll
        for (int j = 0; j < kCJ; ++j) {
          float diff = av.x - bv[j].x;
          dot[i][j] = fmaf(diff, diff, dot[i][j]);
          diff = av.y - bv[j].y;
          dot[i][j] = fmaf(diff, diff, dot[i][j]);
          diff = av.z - bv[j].z;
          dot[i][j] = fmaf(diff, diff, dot[i][j]);
          diff = av.w - bv[j].w;
          dot[i][j] = fmaf(diff, diff, dot[i][j]);
        }
      }
    }

#pragma unroll
    for (int i = 0; i < kRP; ++i) {
      if (i >= nrp) break;
      const int row = row0 + ty + (i0 + i) * kTY;
      if (row >= n) continue;
#pragma unroll
      for (int j = 0; j < kCJ; ++j) {
        const int col = col0 + tx + j * kTX;
        if (col >= m) continue;
        const float d2 = dot[i][j];
        const float r = d2 > 1e-12f ? sqrtf(d2) : 0.0f;
        const float s = sqrt5 * r;
        out[(size_t)row * m + col] =
            s_var * (1.0f + s + s * s / 3.0f) * expf(-s);
      }
    }
  }
}

// The device's SM count, read once.
inline int sm_count() {
  static int sms = 0;
  if (sms == 0) {
    int dev = 0, count = 0;
    if (cudaGetDevice(&dev) == cudaSuccess &&
        cudaDeviceGetAttribute(&count, cudaDevAttrMultiProcessorCount, dev) ==
            cudaSuccess)
      sms = count;
  }
  return sms > 0 ? sms : 1;
}

// The burst pass's launch on `grid` with `smem` bytes: when the grid
// leaves SMs idle (2 x 2 blocks at the default launch's [64, 64] Gram), 2
// or 4 blocks share each tile's rows, since the pass reads and sums its
// rows through shared memory at ~128 bytes a cycle of one SM.
template <int BN, int BM, int NW>
int burst_launch(const float* xa, const float* xb, const float* ls,
                 const float* sv, float* out, int n, int m, int d, dim3 grid,
                 int smem, cudaStream_t stream) {
  using F = FwdTile<BN, BM, NW>;
  const int sms = sm_count();
  while (grid.z < 4 && F::kRP % (2 * grid.z) == 0 &&
         (long)grid.x * grid.y * grid.z * 2 <= sms)
    grid.z *= 2;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        matern52_kernel_burst<BN, BM, NW>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  matern52_kernel_burst<BN, BM, NW><<<grid, F::kThreads, smem, stream>>>(
      xa, xb, ls, sv, out, n, m, d);
  return static_cast<int>(cudaGetLastError());
}

template <int BN, int BM, int NW>
int fwd_launch(const float* xa, const float* xb, const float* ls,
               const float* sv, float* out, int n, int m, int d, int stages,
               cudaStream_t stream) {
  using F = FwdTile<BN, BM, NW>;
  const int smem = stages * F::kSlotFloats * (int)sizeof(float);
  if (stages < 1 || stages > kMaxStages || smem > kSmemLimit)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((m + BM - 1) / BM, (n + BN - 1) / BN);
  const bool direct = d > kExpandedMaxD;
  if (direct && stages == 1) {            // the burst pass, where it pays
    const int burst_smem = burst_floats(F::kPR, BM, d) * (int)sizeof(float);
    if (burst_smem <= kSmemLimit && (long)grid.x * grid.y < sm_count())
      return burst_launch<BN, BM, NW>(xa, xb, ls, sv, out, n, m, d, grid,
                                      burst_smem, stream);
  }
  if (smem > 48 * 1024) {
    const cudaError_t e = direct
        ? cudaFuncSetAttribute(matern52_kernel<BN, BM, NW, true>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem)
        : cudaFuncSetAttribute(matern52_kernel<BN, BM, NW, false>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  if (direct)
    matern52_kernel<BN, BM, NW, true><<<grid, F::kThreads, smem, stream>>>(
        xa, xb, ls, sv, out, n, m, d, stages);
  else
    matern52_kernel<BN, BM, NW, false><<<grid, F::kThreads, smem, stream>>>(
        xa, xb, ls, sv, out, n, m, d, stages);
  return static_cast<int>(cudaGetLastError());
}

template <int BN, int BM>
int fwd_launch_nw(int nw, const float* xa, const float* xb, const float* ls,
                  const float* sv, float* out, int n, int m, int d,
                  int stages, cudaStream_t stream) {
  switch (nw) {
    case 1: return fwd_launch<BN, BM, 1>(xa, xb, ls, sv, out, n, m, d, stages, stream);
    case 2: return fwd_launch<BN, BM, 2>(xa, xb, ls, sv, out, n, m, d, stages, stream);
    case 4: return fwd_launch<BN, BM, 4>(xa, xb, ls, sv, out, n, m, d, stages, stream);
    case 8: return fwd_launch<BN, BM, 8>(xa, xb, ls, sv, out, n, m, d, stages, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <int BN>
int fwd_launch_bm(int bm, int nw, const float* xa, const float* xb,
                  const float* ls, const float* sv, float* out, int n, int m,
                  int d, int stages, cudaStream_t stream) {
  switch (bm) {
    case 32: return fwd_launch_nw<BN, 32>(nw, xa, xb, ls, sv, out, n, m, d, stages, stream);
    case 64: return fwd_launch_nw<BN, 64>(nw, xa, xb, ls, sv, out, n, m, d, stages, stream);
    case 128: return fwd_launch_nw<BN, 128>(nw, xa, xb, ls, sv, out, n, m, d, stages, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// xa [n, d], xb [m, d], ls [d], sv [1], out [n, m]: float32, contiguous, on
// the device.  The tile: block_n x block_m outputs (32, 64 or 128 each) per
// block of 32 num_warps threads (1, 2, 4 or 8), d chunks through a ring of
// `stages` slots (1 to 4); the default launch is 32, 32, 8, 1.  Launches on
// `stream` and returns cudaGetLastError() (cudaErrorInvalidValue for a tile
// outside that set).
extern "C" int matern52_launch(const float* xa, const float* xb,
                               const float* ls, const float* sv, float* out,
                               int n, int m, int d, int block_n, int block_m,
                               int num_warps, int stages,
                               cudaStream_t stream) {
  switch (block_n) {
    case 32: return fwd_launch_bm<32>(block_m, num_warps, xa, xb, ls, sv, out, n, m, d, stages, stream);
    case 64: return fwd_launch_bm<64>(block_m, num_warps, xa, xb, ls, sv, out, n, m, d, stages, stream);
    case 128: return fwd_launch_bm<128>(block_m, num_warps, xa, xb, ls, sv, out, n, m, d, stages, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
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

// ---------------------------------------------------------------------------
// The backward beyond kExpandedMaxD features, up to kWideMaxD: the tuning
// daemon's fits at 327-332 knobs (n = 64) and its multi-task prior (n = 128).
// The same function as above, r^2 from direct differences.
//
// What bounds it on an H100: at [64, 327] it reads 0.1 MB and does ~2 M
// fp32 operations, ~0.1 us at the card's rates; the kernel above gave the
// whole sum to one block of one SM, which staged every 32-feature chunk
// twice (for r^2, then for the feature sums) and reduced after each: 22
// round trips to memory and ~66 barriers, ~0.1 ms.  What the design does:
//   * the n x n pairs are cut into kWideRows x kWideCols tiles, one per
//     block (16 at n = 64), and the blocks of a thread-block cluster of
//     kWideCluster (16, the non-portable size: 12.7 us at [64, 327]
//     against 16.1 us with 16 x 32 tiles in clusters of 8, the portable
//     maximum, tools/gp_gram_bwd_variants.py) share out the tiles; up to
//     kWideMaxClusters clusters;
//   * 1/ls once per block into shared memory; a block stages its tile's
//     rows of x (two contiguous runs) over all of d with two bulk copies
//     (stage_runs), and keeps them twice: as they are (the feature sums
//     take x_ik - x_jk) and scaled by 1/ls four features at a time (r^2,
//     as the forward scales them); rows 16-byte aligned with an odd
//     number of 16-byte groups, so 128-bit reads of eight rows are
//     conflict-free;
//   * r^2 of a pair is the forward's chain of fmaf over features 0 .. d - 1
//     (each thread owns kWidePairs pairs); then w_ij, and the sv sum;
//   * the feature sums: each work item is 4 features x kWideItemRows rows
//     of i x all kWideCols columns, summed in a fixed order into registers,
//     then over the items' row groups through shared memory in order;
//   * deterministic, with no atomics: the blocks of a cluster add their
//     sums through distributed shared memory in rank order, and with more
//     than one cluster a one-block pass adds the clusters' partials in
//     order.  Two calls on the same inputs give the same bits;
//   * plain fp32 FMAs, as above.
// The grouping of the pair sums differs from the one-block kernel's, so
// its bits differ from that kernel's at these widths.

constexpr int kWideMaxD = 512;       // widest d whose rows are staged whole
constexpr int kWideRows = 16;        // i rows of a pair tile
constexpr int kWideCols = 16;        // j columns of a pair tile
constexpr int kWideThreads = 256;
constexpr int kWideCluster = 16;     // blocks of a cluster (non-portable)
constexpr int kWideMaxClusters = 16;
constexpr int kWideItemRows = 2;     // i rows of a feature-sum work item
constexpr int kWideGroups = kWideRows / kWideItemRows;
constexpr int kWidePairs = kWideRows * kWideCols / kWideThreads;
constexpr int kWideRowStep = kWideThreads / kWideCols;
constexpr int kWideWarps = kWideThreads / 32;
static_assert(kWideThreads % kWideCols == 0 && kWidePairs >= 1 &&
              kWideRows % kWideItemRows == 0, "the pair tile");

// Float offsets into the wide kernel's dynamic shared memory at width d.
struct WideLayout {
  int dp;       // d rounded up to 4 (zeros beyond d)
  int ld;       // a staged row's stride: dp, or dp + 4 to make dp / 4 odd
  int bar, raw, scaled, part, wt, inv, ls, tot, red, floats;
};

__host__ __device__ inline WideLayout wide_layout(int d) {
  constexpr int kRowsStaged = kWideRows + kWideCols;
  WideLayout L;
  L.dp = (d + 3) / 4 * 4;
  L.ld = (L.dp / 4) % 2 ? L.dp : L.dp + 4;
  L.bar = 0;                                  // the mbarrier (4 floats)
  L.raw = 4;                                  // [rows][ld]: i rows, j rows
  L.scaled = L.raw + kRowsStaged * L.ld;      // the same, scaled by 1/ls
                                              // (first the flat runs)
  L.part = L.scaled + kRowsStaged * L.ld;     // [groups][dp]
  L.wt = L.part + kWideGroups * L.dp;         // w of the tile, [j][i]
  L.inv = L.wt + kWideCols * kWideRows;       // 1/ls, [dp]
  L.ls = L.inv + L.dp;                        // ls, [dp]
  L.tot = L.ls + L.dp;                        // this block's sums, [d + 1]
  L.red = L.tot + L.dp + 4;                   // [warps]
  L.floats = L.red + kWideWarps;
  return L;
}

__global__ void __launch_bounds__(kWideThreads, 1)
matern52_gram_bwd_kernel_wide(const float* __restrict__ x,
                              const float* __restrict__ ls,
                              const float* __restrict__ sv,
                              const float* __restrict__ g,
                              float* __restrict__ partial,
                              float* __restrict__ out, int n, int d) {
  namespace cg = cooperative_groups;
  constexpr int kRowsStaged = kWideRows + kWideCols;
  extern __shared__ __align__(16) float wide_smem[];
  const WideLayout L = wide_layout(d);
  float* raw = wide_smem + L.raw;
  float* scaled = wide_smem + L.scaled;
  float* part = wide_smem + L.part;
  float* wt = wide_smem + L.wt;
  float* inv = wide_smem + L.inv;
  float* ls_s = wide_smem + L.ls;
  float* tot = wide_smem + L.tot;
  float* red = wide_smem + L.red;
  uint64_t* bar = reinterpret_cast<uint64_t*>(wide_smem + L.bar);

  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int warp = tid / 32;
  const int j = tid % kWideCols;          // this thread's column of a tile
  const int i0 = tid / kWideCols;         // its rows: i0 + kWideRowStep * p
  const int nq = L.dp / 4;                // 4-feature groups
  const int tiles_j = (n + kWideCols - 1) / kWideCols;
  const int tiles = (n + kWideRows - 1) / kWideRows * tiles_j;
  const float s_var = *sv;
  const float sqrt5 = 2.2360679774997896f;
  const float five_thirds = 5.0f / 3.0f;

  if (tid == 0) {
    hopper::mbar_init(bar, 1);
    hopper::fence_barrier_init();
  }
  for (int k = tid; k < L.dp + 4; k += kWideThreads) {
    tot[k] = 0.f;
    if (k < L.dp) {
      const float l = k < d ? ls[k] : 1.f;
      ls_s[k] = l;
      inv[k] = k < d ? 1.0f / l : 0.f;
    }
  }
  float acc_sv = 0.f;

  __syncthreads();                        // inv, ls_s, tot
  int parity = 0;
  for (int t = blockIdx.x; t < tiles; t += gridDim.x, parity ^= 1) {
    const int r0 = t / tiles_j * kWideRows;
    const int c0 = t % tiles_j * kWideCols;
    if (t != blockIdx.x) __syncthreads(); // the previous tile's readers

    float gv[kWidePairs];
#pragma unroll
    for (int p = 0; p < kWidePairs; ++p) {
      const int row = r0 + i0 + kWideRowStep * p;
      const int col = c0 + j;
      gv[p] = (row < n && col < n) ? g[(size_t)row * n + col] : 0.f;
    }
    // the tile's rows of i and of j, each contiguous in memory, in one
    // burst into flat buffers where `scaled` will be, then into the padded
    // rows as they are: staged row r is x's row r0 + r (r < kWideRows) or
    // c0 + r - kWideRows, zeros beyond n rows and d features
    const int ni = max(0, min(kWideRows, n - r0));
    const int nj = max(0, min(kWideCols, n - c0));
    float* flat_i = scaled;
    float* flat_j = scaled + flat_floats(kWideRows * d);
    stage_runs(x + (size_t)r0 * d, ni * d, flat_i, x + (size_t)c0 * d,
               nj * d, flat_j, bar, parity);
    {
      const float* fi = flat_i + (ni > 0 ? run_lead(x + (size_t)r0 * d) : 0);
      const float* fj = flat_j + (nj > 0 ? run_lead(x + (size_t)c0 * d) : 0);
      relayout<kWideThreads>(
          kRowsStaged, d, L.dp,
          [&](int r) -> const float* {
            if (r < kWideRows) return r < ni ? fi + r * d : nullptr;
            return r - kWideRows < nj ? fj + (r - kWideRows) * d : nullptr;
          },
          [&](int r, int q, float4 v) {
            reinterpret_cast<float4*>(raw + r * L.ld)[q] = v;
          });
    }
    __syncthreads();
    // scaled by 1/ls with one rounding, as the forward scales them, four
    // features at a time
    for (int it = tid; it < kRowsStaged * nq; it += kWideThreads) {
      const int off = it / nq * L.ld + it % nq * 4;
      const float4 v = *reinterpret_cast<const float4*>(raw + off);
      const float4 iv = reinterpret_cast<const float4*>(inv)[it % nq];
      *reinterpret_cast<float4*>(scaled + off) =
          make_float4(v.x * iv.x, v.y * iv.y, v.z * iv.z, v.w * iv.w);
    }
    __syncthreads();

    // r^2 of this thread's pairs, the forward's chain over the features
    float dot[kWidePairs];
#pragma unroll
    for (int p = 0; p < kWidePairs; ++p) dot[p] = 0.f;
    const float4* bj =
        reinterpret_cast<const float4*>(scaled + (kWideRows + j) * L.ld);
#pragma unroll 4
    for (int q = 0; q < nq; ++q) {
      const float4 b = bj[q];
#pragma unroll
      for (int p = 0; p < kWidePairs; ++p) {
        const float4 a = reinterpret_cast<const float4*>(
            scaled + (i0 + kWideRowStep * p) * L.ld)[q];
        float diff = a.x - b.x;
        dot[p] = fmaf(diff, diff, dot[p]);
        diff = a.y - b.y;
        dot[p] = fmaf(diff, diff, dot[p]);
        diff = a.z - b.z;
        dot[p] = fmaf(diff, diff, dot[p]);
        diff = a.w - b.w;
        dot[p] = fmaf(diff, diff, dot[p]);
      }
    }
    // the pairs' weights, and the sv sum
#pragma unroll
    for (int p = 0; p < kWidePairs; ++p) {
      const float d2 = dot[p];
      const bool pos = d2 > 1e-12f;
      const float s = sqrt5 * (pos ? sqrtf(d2) : 0.0f);
      const float e = expf(-s);
      acc_sv = fmaf(gv[p], (1.0f + s + s * s / 3.0f) * e, acc_sv);
      wt[j * kWideRows + i0 + kWideRowStep * p] =
          pos ? gv[p] * five_thirds * s_var * e * (1.0f + s) : 0.0f;
    }
    __syncthreads();

    // the feature sums: item (row group ig, features 4q .. 4q + 3)
    for (int item = tid; item < kWideGroups * nq; item += kWideThreads) {
      const int ig = item / nq;
      const int q = item % nq;
      const int ia = ig * kWideItemRows;
      float4 xi[kWideItemRows];
#pragma unroll
      for (int r = 0; r < kWideItemRows; ++r)
        xi[r] = reinterpret_cast<const float4*>(raw + (ia + r) * L.ld)[q];
      float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 8
      for (int jj = 0; jj < kWideCols; ++jj) {
        const float4 xj = reinterpret_cast<const float4*>(
            raw + (kWideRows + jj) * L.ld)[q];
        const float* w = wt + jj * kWideRows + ia;
#pragma unroll
        for (int r = 0; r < kWideItemRows; ++r) {
          float diff = xi[r].x - xj.x;
          acc.x = fmaf(w[r] * diff, diff, acc.x);
          diff = xi[r].y - xj.y;
          acc.y = fmaf(w[r] * diff, diff, acc.y);
          diff = xi[r].z - xj.z;
          acc.z = fmaf(w[r] * diff, diff, acc.z);
          diff = xi[r].w - xj.w;
          acc.w = fmaf(w[r] * diff, diff, acc.w);
        }
      }
      reinterpret_cast<float4*>(part + ig * L.dp)[q] = acc;
    }
    __syncthreads();
    for (int k = tid; k < d; k += kWideThreads) {
      float s = 0.f;
#pragma unroll
      for (int ig = 0; ig < kWideGroups; ++ig) s += part[ig * L.dp + k];
      tot[k] += s;
    }
  }

#pragma unroll
  for (int off = 16; off >= 1; off /= 2)
    acc_sv += __shfl_xor_sync(0xffffffffu, acc_sv, off);
  if (lane == 0) red[warp] = acc_sv;
  __syncthreads();
  if (tid == 0) {
    float s = 0.f;
#pragma unroll
    for (int q = 0; q < kWideWarps; ++q) s += red[q];
    tot[d] = s;
  }

  // the cluster's blocks' sums, added in rank order through distributed
  // shared memory; block `rank` takes every kWideCluster-th slice of 256
  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();
  const int rank = static_cast<int>(cluster.block_rank());
  const int clusters = gridDim.x / kWideCluster;
  const int cid = blockIdx.x / kWideCluster;
  for (int k = rank * kWideThreads + tid; k <= d;
       k += kWideCluster * kWideThreads) {
    float s = 0.f;
#pragma unroll
    for (int q = 0; q < kWideCluster; ++q)
      s += cluster.map_shared_rank(tot, q)[k];
    if (clusters > 1) {
      partial[(size_t)cid * (d + 1) + k] = s;
    } else if (k < d) {
      const float l = ls_s[k];
      out[k] = s / (l * l * l);
    } else {
      out[d] = s;
    }
  }
  cluster.sync();                         // no block leaves while read
}

// The clusters the wide kernel takes for n rows (its grid: kWideCluster
// blocks each).
__host__ inline int wide_clusters(int n) {
  const int tiles = ((n + kWideRows - 1) / kWideRows) *
                    ((n + kWideCols - 1) / kWideCols);
  return cmin((tiles + kWideCluster - 1) / kWideCluster, kWideMaxClusters);
}

int bwd_wide_launch(const float* x, const float* ls, const float* sv,
                    const float* g, float* partial, float* out, int n, int d,
                    cudaStream_t stream) {
  const WideLayout L = wide_layout(d);
  const int smem = L.floats * (int)sizeof(float);
  if (smem > kSmemLimit) return static_cast<int>(cudaErrorInvalidValue);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        matern52_gram_bwd_kernel_wide,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  if (kWideCluster > 8) {                 // beyond the portable size
    const cudaError_t e = cudaFuncSetAttribute(
        matern52_gram_bwd_kernel_wide,
        cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const int clusters = wide_clusters(n);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(clusters * kWideCluster);
  cfg.blockDim = dim3(kWideThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = kWideCluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t e = cudaLaunchKernelEx(
      &cfg, matern52_gram_bwd_kernel_wide, x, ls, sv, g, partial, out, n, d);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (clusters > 1)
    matern52_gram_bwd_reduce_kernel<<<1, kBwdThreads, 0, stream>>>(
        partial, ls, out, clusters, d);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x [n, d], ls [d], sv [1], g [n, n]: float32, contiguous, on the device;
// out [d + 1] receives (dL/dls, dL/dsv); partial [rows, d + 1] is scratch,
// read only when rows > 0 (it may be null otherwise): up to kExpandedMaxD
// features and beyond kWideMaxD, rows = ceil(n / 64) when n > 64, else 0
// (one block per 64 rows of i); in between, rows = the wide kernel's
// clusters when more than one, else 0.  Launches on `stream` (one kernel,
// or two with partial rows) and returns cudaGetLastError().  d <= 16 takes
// 16-feature chunks, wider d 32; beyond kExpandedMaxD, r^2 from direct
// differences, on the wide kernel up to kWideMaxD features.
extern "C" int matern52_gram_bwd_launch(const float* x, const float* ls,
                                        const float* sv, const float* g,
                                        float* partial, float* out, int n,
                                        int d, cudaStream_t stream) {
  if (d <= 16)
    return bwd_launch<16, false>(x, ls, sv, g, partial, out, n, d, stream);
  if (d <= kExpandedMaxD)
    return bwd_launch<32, false>(x, ls, sv, g, partial, out, n, d, stream);
  if (d <= kWideMaxD)
    return bwd_wide_launch(x, ls, sv, g, partial, out, n, d, stream);
  return bwd_launch<32, true>(x, ls, sv, g, partial, out, n, d, stream);
}
