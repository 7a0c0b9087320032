// One bf16 vocoder block of the 12 Hz codec decoder, fused, for Hopper (sm_90a).
//
// Replaces the TPU kernel scripts/exp_pallas_vocoder.py (`fused_block`, body
// `make_block_kernel`): for x [B, T_in, C_in] bf16, channels last,
//
//   h = tconv(snake(x))                       causal transposed conv, k = 2s
//   for d in dilations (1, 3, 9):             three residual units
//     c = conv1x1(snake(convK_d(snake(h))))   causal K-tap dilated conv, 1x1 conv
//     h = h + c
//
// K is a runtime argument: the codec's residual units have K = 7 (the
// checkpoint's conv1 weights), the TPU kernel was written for K = 3.
//
// -> [B, T_in * s, C_out] bf16. Rounding points are the JAX package's (and the
// plain version's, ops/cuda/vocoder_block.py): every snake reads bf16, works
// in f32 and writes bf16; every conv sums bf16 products in f32, adds its bias
// (bf16, widened to f32) and rounds once to bf16; the residual add is bf16 +
// bf16 -> bf16. The snake repeats ops/snake.py's polynomial sin^2 step by step
// with round-to-nearest intrinsics (no fused multiply-adds, true division by
// beta + 1e-9, rintf's round-half-to-even), so its bits equal PyTorch's.
//
// Bound. Per output row the block does 2 * (2 C_in C_out + 3 (K + 1) C_out^2)
// tensor-core flops and moves 2 (C_in / s + C_out) bytes: ~4000 flops per
// byte for the codec's blocks 2 (384 -> 192, s = 4) and 3 (192 -> 96, s = 3)
// at K = 7, far above the card's ~295, so bytes do not bind. The snakes run
// on the CUDA cores beside the products: 6 C_out + C_in / s per output row,
// ~35 instructions each (no FMA), which for block 3 is as much time as its
// tensor-core flops. The bound chip_smoke.py states is the largest of the
// three terms (the snake's count comes from this file's SASS).
//
// What the first design (WMMA, a tile a CTA) lost: it recomputed a halo of (K - 1) * 13
// rows in front of every tile (42% of block 2's rows), because shared memory
// held three full activations; and each WMMA weight fragment came straight
// from L2, one dependent load after another, for 4 row tiles. It ran at
// 30-50x its tensor-core bound.
//
// This design:
//   * A CTA (8 warps) walks a segment of consecutive tiles of T output rows
//     of one batch row, left to right. The convolutions are causal, so a
//     tile needs from the tiles before it only the last (K - 1) d input rows
//     of each unit's dilated conv: the CTA keeps them (`hist`, 6 + 18 + 54
//     rows at K = 7) and carries them to the next tile instead of
//     recomputing a halo. A segment that does not start at row 0 first runs
//     ceil((K - 1) * 13 / T) warm-up tiles whose outputs it drops (the
//     history starts as zeros; after that many rows it is exact). Segments
//     are sized so that the grid fills the card once: 13-20 tiles each at
//     the path's shapes, so the warm-up costs 5-8% where the halo cost 42%.
//   * Every conv is a GEMM on the tensor cores (mma.sync m16n8k16 bf16, f32
//     sums), fragments loaded with ldmatrix from padded rows (no bank
//     conflicts). The K-tap conv is one GEMM over K * C_out inner rows (tap
//     j reads the unit's snaked input j * d rows further back); the
//     transposed conv is s GEMMs, one per output phase p, over 2 * C_in
//     inner rows (x[q] with tap 2s-1-p, x[q-1] with tap s-1-p, in the
//     loader's flipped-tap layout).
//   * The weights of a tile's GEMMs, always the same in the same order, are
//     one periodic stream of 32-row stages (16 where a width is not a
//     multiple of 32) through a 3-stage shared-memory ring filled by cp.async
//     two stages ahead; the stream runs on across GEMMs, epilogues and
//     tiles, so the ring never drains (a fourth stage, timed at one CTA an
//     SM, changed nothing). Each staged
//     slice serves all of the tile's rows. The k-loop holds no division:
//     every offset is set up before it.
//   * The warps of a GEMM form a grid, warp_n along the columns and
//     8 / warp_n along the rows, so each holds the same number of m16 x n8
//     tiles: at block 3's 96 columns 4 x 2 warps of 3 x 3 tiles for a
//     96-row tile.
//   * Epilogues (bias, rounding, residual add) run on the accumulators in
//     registers and write bf16 pairs to shared memory; the snakes run as
//     passes over shared memory, each thread on one group of 8 channels
//     whose alpha and reciprocal of beta + 1e-9 it keeps in registers
//     (Markstein's correction keeps the quotient correctly rounded); the
//     8 snakes' common path has no branch, so their chains interleave.
//   * The snaked input rows share the space of the first unit's input rows
//     (dead by then), which makes room for block 3's geometry (C_out 96) at
//     two CTAs an SM (up to 3 x 3 tiles a warp, <= 113 KB), so one CTA's
//     snakes overlap the other's MMAs; block 2 (C_out 192) takes one CTA an
//     SM with up to 3 x 6 tiles a warp.
//   * Short calls split columns. The stream's first packet (B=1, 2 frames)
//     is 14 tiles of block 2 and 40 of block 3: a CTA a tile leaves most
//     SMs idle and every CTA but the first runs a warm-up tile. A cluster of
//     n CTAs (n <= 8, C_out / n a multiple of 16) then shares each tile:
//     each CTA computes C_out / n columns of every GEMM, streams only those
//     columns' weights, snakes its share of each activation's channels and
//     stores them into every peer's shared memory (distributed shared
//     memory), and a cluster barrier takes the place of the block barrier
//     where a GEMM reads what the peers wrote. Each column's sums run in the
//     same order whichever CTA computes it: a split changes no bit. The
//     plan picks n by a cost model: waves x tiles a CTA runs (warm-up
//     included) x (kFixedShare + (1 - kFixedShare) / n), with the clusters
//     that fit at once from cudaOccupancyMaxActiveClusters (a cluster's CTAs
//     share a GPC). Calls that fill the card keep n = 1.
//   * A timed launch (`timeline`) records each CTA's cycles by phase kind.
// Measured (NVIDIA H100 80GB HBM3, 700 W; PERF.md, timed launches): the
// GEMM phases take three quarters of a CTA's cycles at the codec's shapes,
// with a floor of ~1000 cycles a weight stage that neither balanced warps
// nor a deeper ring moved; wgmma
// (B read from shared memory by the hardware, one instruction a warpgroup)
// is the next step.
//
// The launch goes on the caller's stream, allocates nothing and returns
// cudaGetLastError(); the Python wrapper raises on a non-zero code.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kUnits = 3;
constexpr int kMaxCIn = 384;
constexpr int kMaxTaps = 16;
constexpr int kMaxTile = 192;        // output rows of a tile
constexpr int kMmaK = 16;            // inner rows of one mma.sync
constexpr int kMaxStageK = 32;       // inner rows of a weight stage: 16, or 32 when widths allow
constexpr int kMT = 3;               // m16 row tiles a warp holds at once
constexpr int kStages = 3;           // of the weight ring
// The kernel's two variants by the n8 tiles a warp holds: two CTAs an SM
// overlap one's snakes with the other's MMAs; one CTA an SM has the room
// for wider tiles.
constexpr int kNarrowNT = 3;         // 2 CTAs an SM
constexpr int kWideNT = 6;           // 1 CTA an SM
constexpr int kPad = 8;              // bf16 per row of padding (16 B)
constexpr int kVecPerUnit = 6;       // alpha1, beta1, conv1 bias, alpha2, beta2, conv2 bias
constexpr int kSmemPerSm = 233472;   // 228 KB an SM
constexpr int kSmemReserved = 1024;  // reserved per CTA
constexpr int kMaxSplit = 8;         // CTAs of a cluster that share a tile (portable)
// The share of a tile's time that does not shrink when a cluster of n CTAs
// splits its columns (barriers, the k-loops' fixed steps, fewer MMAs to
// overlap): the plan's cost model, time ~ tiles x (kFixedShare +
// (1 - kFixedShare) / n). Timed splits of the stream's shapes
// (chip_smoke.sweep_vocoder_plans, H100) give 0.37-0.6.
constexpr float kFixedShare = 0.5f;
// A timed launch's record per CTA: SM cycles spent in each phase kind,
// summed over its tiles (as thread 0 sees them: a phase ends at the barrier
// after it), then the CTA's whole span.
enum TimelineSlot {
  kTlSnakeIn,   // the block snake of the input rows (+ barrier)
  kTlTconv,     // the transposed conv's GEMMs
  kTlSnakeH,    // each unit's history and snake(h) (+ barrier, history update)
  kTlConvK,     // each unit's K-tap GEMM
  kTlSnakeC,    // each unit's second snake (+ barrier)
  kTlConv1,     // each unit's 1x1 GEMM and residual add
  kTlStore,     // the tile's rows to global memory
  kTlSpan,      // first to last cycle of the CTA
  kTimelineSlots
};

constexpr float kPi = 3.141592653589793f;
constexpr float kInvPi = 0.3183098861837907f;
constexpr float kHalfPi = 1.5707964f;
constexpr float kS3 = -1.0f / 6.0f;
constexpr float kS5 = 1.0f / 120.0f;
constexpr float kS7 = -1.0f / 5040.0f;
constexpr float kS9 = 1.0f / 362880.0f;
constexpr float kNoDivByZero = 1e-9f;
constexpr float kFastDivMin = 0x1p-90f;  // snake numerators below divide the ordinary way

// ops/snake.py for bf16 activations, one rounding per operation. The true
// division by den = beta + 1e-9 takes the per-channel reciprocal rcp =
// RN(1 / den) (snake_divisor): q0 = RN(num rcp), then one exact remainder and
// correction, num - den q0 and q0 + rcp (num - den q0), give RN(num / den)
// (Markstein), the correctly rounded quotient __fdiv_rn gives, without a
// reciprocal on the special-function unit per element. Numerators near
// underflow, and a channel whose den has no normal reciprocal (rcp = 0),
// divide the ordinary way.
__device__ __forceinline__ float snake_num(float x, float alpha) {  // sin^2(alpha x)
  const float u = __fmul_rn(x, alpha);
  float r = __fsub_rn(u, __fmul_rn(kPi, rintf(__fmul_rn(u, kInvPi))));
  r = fminf(fmaxf(r, -kHalfPi), kHalfPi);
  const float r2 = __fmul_rn(r, r);
  float poly = __fadd_rn(kS7, __fmul_rn(r2, kS9));
  poly = __fadd_rn(kS5, __fmul_rn(r2, poly));
  poly = __fadd_rn(kS3, __fmul_rn(r2, poly));
  poly = __fadd_rn(1.0f, __fmul_rn(r2, poly));
  const float s = __fmul_rn(r, poly);
  return __fmul_rn(s, s);
}

__device__ __forceinline__ float fast_div(float num, float den, float rcp) {
  const float q0 = __fmul_rn(num, rcp);
  return __fmaf_rn(rcp, __fmaf_rn(-den, q0, num), q0);
}

// Whether num / den takes the ordinary division (fast_div is not exact).
__device__ __forceinline__ bool slow_div(float num, float rcp) {
  return !(num >= kFastDivMin) || rcp == 0.f;
}

// A channel's (den, rcp) for the snake's division.
__device__ __forceinline__ float2 snake_divisor(float beta) {
  const float den = __fadd_rn(beta, kNoDivByZero);
  const bool normal = den >= 0x1p-100f && den <= 0x1p100f;
  return make_float2(den, normal ? __frcp_rn(den) : 0.f);
}

__device__ __forceinline__ float bf(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ __nv_bfloat16 rb(float v) { return __float2bfloat16_rn(v); }

// 8 bf16 values as one 16-byte word.
union Pack8 {
  uint4 word;
  __nv_bfloat16 v[8];
};

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Four 8x8 bf16 matrices from shared memory; lane l gives the address of
// row l % 8 of matrix l / 8.
__device__ __forceinline__ void ldsm_x4(uint32_t* r, const void* p) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a));
}

// The same, transposed (for B fragments of a row-major [k][n] tile).
__device__ __forceinline__ void ldsm_x4_trans(uint32_t* r, const void* p) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a));
}

// d += a * b on the tensor cores: m16n8k16, bf16 inputs, f32 sums.
__device__ __forceinline__ void mma_bf16(float* d, const uint32_t* a, const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// The cluster barrier, every thread of every CTA of the cluster: release on
// arrive and acquire on wait make each CTA's stores to its peers' shared
// memory visible to them.
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

struct Params {
  const __nv_bfloat16* x;        // [B, T_in, C_in]
  __nv_bfloat16* out;            // [B, T_in * s, C_out]
  const __nv_bfloat16* tconv_w;  // [2s, C_in, C_out], flipped taps
  const __nv_bfloat16* alpha;    // [C_in], the block snake's
  const __nv_bfloat16* beta;     // [C_in]
  const __nv_bfloat16* tconv_b;  // [C_out]
  // [C_out] each: per unit alpha1, beta1, conv1 bias, alpha2, beta2, conv2 bias
  const __nv_bfloat16* unit_vec[kUnits][kVecPerUnit];
  const __nv_bfloat16* w1[kUnits];  // [K, C_out, C_out] (tap j reads row t - (K-1-j) d)
  const __nv_bfloat16* w2[kUnits];  // [C_out, C_out]
  int dil[kUnits];
  int t_in, c_in, c_out, rate, taps;
  int split;       // CTAs of a cluster sharing each tile (1: no cluster)
  int cols;        // output columns a CTA computes: c_out / split
  int warp_n;      // the GEMMs' warp grid: warp_n warps along the columns,
  int warp_nt;     // warp_nt n8 tiles each; kWarps / warp_n along the rows
  int tile;        // output rows of a tile (a multiple of lcm(16, s))
  int m_rows;      // transposed-conv rows of a phase: tile / s
  int xs_rows;     // snaked input rows held: m_rows rounded up to 16, + 1
  int tile_rows;   // tile rounded up to 16 (row buffers)
  int hmax;        // (K - 1) * max(d): history rows in front of the work rows
  int hist_rows;   // (K - 1) * sum(d): every unit's history
  int stage_k;     // inner rows of a weight stage (kMmaK or kMaxStageK)
  int tiles;       // tiles of one batch row
  int seg_tiles;   // tiles a CTA writes
  int warm_tiles;  // tiles a CTA runs before its first, outputs dropped
  // Byte offsets in shared memory.
  int off_xs, off_h, off_hist, off_a, off_c1, off_ring;
  int off_gemms;   // the weight stream's WeightPart of each GEMM of a tile
  unsigned long long* timeline;  // [CTAs][kTimelineSlots] when timed, or nullptr
};

// Thread 0's phase clock of a timed launch (a no-op untimed): it adds each
// phase's cycles to the CTA's slots in global memory (zeros to start).
struct PhaseClock {
  unsigned long long* out;  // this CTA's slots, or nullptr
  long long start, last;

  __device__ __forceinline__ void mark(int slot) {
    if (out == nullptr) return;
    const long long now = clock64();
    out[slot] += (unsigned long long)(now - last);
    last = now;
  }
  __device__ __forceinline__ void finish() {
    if (out != nullptr) out[kTlSpan] = (unsigned long long)(clock64() - start);
  }
};
// One GEMM of a tile: out[m, n] = sum over parts j and inner rows k of
// A[a_row(j) + m][k] * W_j[k][n], n < C_out. A lies in shared memory with
// row stride lda; part j's rows start a_step * j rows after part 0's. Its
// weights W_j (row-major [kp][C_out]) come from the weight stream.
struct Gemm {
  const __nv_bfloat16* a;
  int lda, a_step;
  int parts, kp;
  int m16;  // m16 row tiles to compute
};

// The weights of one GEMM of a tile: part j's at w + j * w_step.
struct WeightPart {
  const __nv_bfloat16* w;
  long long w_step;
  int parts, steps_per_part, passes;
};

constexpr int kMaxRate = 16;
constexpr int kMaxGemms = kMaxRate + 2 * kUnits;  // a tile's GEMMs
template <int kK>
constexpr int kMaxCopies = (kK * kMaxCIn / 8 + 256 - 1) / 256;

// Every tile runs the same GEMMs in the same order (the transposed conv's
// phases, then each unit's two convs), so their weights form one periodic
// stream of kK-row stages (of the CTA's columns). The CTA keeps kStages - 1
// stages in flight across GEMM boundaries, epilogues and tiles: a GEMM
// finds its first stages already landed, and the ring never drains.
template <int kK>
struct WeightStream {
  const WeightPart* gemms;  // in shared memory
  int n_gemms;
  __nv_bfloat16* ring;
  int stage_elems, ld;      // ld: the weights' row stride (C_out)
  int dst_off[kMaxCopies<kK>], src_off[kMaxCopies<kK>];  // this thread's 16 B copies (-1: none)
  int gi, pass, part, kk;  // the next stage to load
  const __nv_bfloat16* src;
  int issued, consumed;

  __device__ __forceinline__ void load_next() {
    __nv_bfloat16* dst = ring + (issued % kStages) * stage_elems;
#pragma unroll
    for (int j = 0; j < kMaxCopies<kK>; ++j) {
      if (dst_off[j] >= 0) cp_async16(dst + dst_off[j], src + src_off[j]);
    }
    cp_async_commit();
    ++issued;
    const WeightPart& g = gemms[gi];
    src += kK * ld;
    if (++kk == g.steps_per_part) {
      kk = 0;
      src += g.w_step - (long long)g.steps_per_part * kK * ld;
      if (++part == g.parts) {
        part = 0;
        src = g.w;
        if (++pass == g.passes) {
          pass = 0;
          gi = gi + 1 == n_gemms ? 0 : gi + 1;
          src = gemms[gi].w;
        }
      }
    }
  }
};

// m16 row-tile passes of a GEMM of m16 row tiles: each pass gives every
// warp row up to kMT of them.
__host__ __device__ __forceinline__ int gemm_passes(int m16, int warp_n) {
  const int per_pass = kWarps / warp_n * kMT;
  return (m16 + per_pass - 1) / per_pass;
}

// The GEMM on the tensor cores, its weights from the stream, for the CTA's
// p.cols columns. The warps form a grid: warp_n along the columns, each
// taking warp_nt adjacent n8 tiles, and kWarps / warp_n along the rows,
// each taking row tiles warp_m, warp_m + rows of the grid, ... (kMT a pass;
// more take more passes over the weights), so every warp has the same
// number of MMAs. epi(m, n, v0, v1) gets each pair of adjacent columns of a
// row (n counted from the CTA's first column). Every address the k-loop
// needs is set up before it (no division inside): the loop is barrier,
// copies, fragment loads and MMAs. Ends with a block barrier: the
// epilogue's writes are visible and the last stage's slot is free.
template <int kNT, int kK, typename Epi>
__device__ __forceinline__ void gemm(const Params& p, const Gemm& g, WeightStream<kK>& st,
                                     Epi epi) {
  constexpr int kNP = (kNT + 1) / 2;  // n16 fragments (ldmatrix .x4.trans) of a warp
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int wm = kWarps / p.warp_n;
  const int warp_m = warp / p.warp_n;
  const int nt_n = p.warp_nt;
  const int n0 = (warp % p.warp_n) * nt_n * 8;  // the warp's first column
  const int ldw = p.cols + kPad;                // a weight stage's row stride
  const int steps_per_part = g.kp / kK;
  const int steps = g.parts * steps_per_part;
  const int a_jump = g.a_step * g.lda - g.kp;  // A, part to part
  // B fragments: lane l gives stage row l % 16 and column n0 + 8 (l / 16);
  // an odd warp_nt reads one n8 tile past its columns (the next warp's, or
  // the padding) and drops it.
  const int b_off = (lane % 16) * ldw + n0 + (lane / 16) * 8;
  for (int mbase = 0; mbase < g.m16; mbase += wm * kMT) {
    int a_off[kMT];
    bool valid[kMT];
#pragma unroll
    for (int mt = 0; mt < kMT; ++mt) {
      const int mi = mbase + mt * wm + warp_m;
      valid[mt] = mi < g.m16;
      a_off[mt] = ((valid[mt] ? mi : 0) * 16 + lane % 16) * g.lda + (lane / 16) * 8;
    }
    float acc[kMT][kNT][4];
#pragma unroll
    for (int mt = 0; mt < kMT; ++mt) {
#pragma unroll
      for (int nt = 0; nt < kNT; ++nt) {
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0.f;
      }
    }
    const __nv_bfloat16* a = g.a;
    int kk = 0;
    for (int s = 0; s < steps; ++s) {
      cp_async_wait<kStages - 2>();
      __syncthreads();  // this stage landed for all; the one before it is free
      st.load_next();
      const __nv_bfloat16* stage = st.ring + (st.consumed % kStages) * st.stage_elems;
      ++st.consumed;
#pragma unroll
      for (int ks = 0; ks < kK / kMmaK; ++ks) {
        uint32_t bfr[kNP][4];
#pragma unroll
        for (int np = 0; np < kNP; ++np) {
          if (2 * np < nt_n) ldsm_x4_trans(bfr[np], stage + b_off + ks * kMmaK * ldw + np * 16);
        }
#pragma unroll
        for (int mt = 0; mt < kMT; ++mt) {
          if (valid[mt]) {
            uint32_t af[4];
            ldsm_x4(af, a + a_off[mt] + ks * kMmaK);
#pragma unroll
            for (int nt = 0; nt < kNT; ++nt) {
              if (nt < nt_n) mma_bf16(acc[mt][nt], af, bfr[nt / 2] + 2 * (nt % 2));
            }
          }
        }
      }
      a += kK;
      if (++kk == steps_per_part) {
        kk = 0;
        a += a_jump;
      }
    }
#pragma unroll
    for (int mt = 0; mt < kMT; ++mt) {
      if (valid[mt]) {
        const int m = (mbase + mt * wm + warp_m) * 16 + lane / 4;
#pragma unroll
        for (int nt = 0; nt < kNT; ++nt) {
          if (nt < nt_n) {
            const int n = n0 + nt * 8 + 2 * (lane % 4);
            epi(m, n, acc[mt][nt][0], acc[mt][nt][1]);
            epi(m + 8, n, acc[mt][nt][2], acc[mt][nt][3]);
          }
        }
      }
    }
    __syncthreads();
  }
}

// Two adjacent bf16 values (4 B aligned) as floats.
__device__ __forceinline__ float2 load2(const __nv_bfloat16* p) {
  const __nv_bfloat162 v = *reinterpret_cast<const __nv_bfloat162*>(p);
  return make_float2(bf(v.x), bf(v.y));
}

__device__ __forceinline__ void store2(__nv_bfloat16* dst, float v0, float v1) {
  __nv_bfloat162 pair;
  pair.x = rb(v0);
  pair.y = rb(v1);
  *reinterpret_cast<__nv_bfloat162*>(dst) = pair;
}

// A 16-byte word to `at` in this CTA's shared memory and, in a cluster, at
// the same offset in every peer's.
__device__ __forceinline__ void store_all(__nv_bfloat16* at, uint4 word, int split) {
  if (split == 1) {
    *reinterpret_cast<uint4*>(at) = word;
    return;
  }
  cg::cluster_group cluster = cg::this_cluster();
  for (int r = 0; r < split; ++r) *reinterpret_cast<uint4*>(cluster.map_shared_rank(at, r)) = word;
}

// A block barrier, or in a cluster the cluster barrier: the peers' stores
// have landed, and every peer is done with what they overwrite next.
__device__ __forceinline__ void sync_peers(int split) {
  if (split == 1) {
    __syncthreads();
    return;
  }
  cluster_arrive();
  cluster_wait();
}

// SnakeBeta of rows [0, rows) of 8-channel groups [g0, g0 + groups): row r,
// channel c of the output at dst + r * ld + c, in this CTA's and every
// peer's shared memory, from src_row(r) + c (nullptr: a row of zeros).
// Each thread keeps one group, its alpha and (den, rcp) in registers,
// across the rows it takes (r = its first, + kThreads / groups, ...).
template <typename Row>
__device__ __forceinline__ void snake_rows(int rows, int g0, int groups,
                                           const __nv_bfloat16* alpha,
                                           const __nv_bfloat16* beta, __nv_bfloat16* dst,
                                           int ld, int split, Row src_row) {
  const int per = kThreads / groups;  // rows a pass
  if ((int)threadIdx.x >= per * groups) return;
  const int c = (g0 + (int)threadIdx.x % groups) * 8;
  float al[8], den[8], rcp[8];
  Pack8 a8, b8;
  a8.word = *reinterpret_cast<const uint4*>(alpha + c);
  b8.word = *reinterpret_cast<const uint4*>(beta + c);
#pragma unroll
  for (int e = 0; e < 8; ++e) {
    al[e] = bf(a8.v[e]);
    const float2 dr = snake_divisor(bf(b8.v[e]));
    den[e] = dr.x;
    rcp[e] = dr.y;
  }
  for (int r = threadIdx.x / groups; r < rows; r += per) {
    const __nv_bfloat16* src = src_row(r);
    Pack8 in, o;
    if (src != nullptr) {
      // The 8 snakes' common path has no branch, so their chains interleave;
      // the rare ordinary division follows for the lanes that need it.
      in.word = *reinterpret_cast<const uint4*>(src + c);
      float x[8], num[8], q[8];
      bool slow = false;
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        x[e] = bf(in.v[e]);
        num[e] = snake_num(x[e], al[e]);
        q[e] = fast_div(num[e], den[e], rcp[e]);
        slow |= slow_div(num[e], rcp[e]);
      }
      if (slow) {
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          if (slow_div(num[e], rcp[e])) q[e] = __fdiv_rn(num[e], den[e]);
        }
      }
#pragma unroll
      for (int e = 0; e < 8; ++e) o.v[e] = rb(__fadd_rn(x[e], q[e]));
    } else {
      o.word = make_uint4(0u, 0u, 0u, 0u);
    }
    store_all(dst + (size_t)r * ld + c, o.word, split);
  }
}

template <int kNT, int kMinBlocks, int kK>
__global__ void __launch_bounds__(kThreads, kMinBlocks) vocoder_block_kernel(const Params p) {
  extern __shared__ __align__(128) unsigned char smem[];
  __nv_bfloat16* xs = reinterpret_cast<__nv_bfloat16*>(smem + p.off_xs);      // [xs_rows][ldx]
  __nv_bfloat16* h = reinterpret_cast<__nv_bfloat16*>(smem + p.off_h);        // [tile_rows][ldc]
  __nv_bfloat16* hist = reinterpret_cast<__nv_bfloat16*>(smem + p.off_hist);  // [hist_rows][ldc]
  __nv_bfloat16* aw = reinterpret_cast<__nv_bfloat16*>(smem + p.off_a);       // [hmax + tile_rows][ldc]
  __nv_bfloat16* c1 = reinterpret_cast<__nv_bfloat16*>(smem + p.off_c1);      // [tile_rows][ldc]
  __nv_bfloat16* ring = reinterpret_cast<__nv_bfloat16*>(smem + p.off_ring);
  const int C = p.c_out;
  const int ldc = C + kPad;
  const int ldx = p.c_in + kPad;
  const int c8 = C / 8;
  const int tid = threadIdx.x;
  const int b = blockIdx.y;
  // In a cluster of p.split CTAs (consecutive in x) each computes the
  // columns [col0, col0 + cols) of every GEMM and snakes its share of every
  // activation's channels into all the peers' shared memory, so that each
  // holds the whole input of the next GEMM.
  const int rank = blockIdx.x % p.split;
  const int col0 = rank * p.cols;
  const int own8 = p.cols / 8;
  const int in8 = p.c_in / p.split / 8;  // input channels this CTA snakes, in 8s
  const int first = blockIdx.x / p.split * p.seg_tiles;
  const int last = min(p.tiles, first + p.seg_tiles);
  const int start = max(0, first - p.warm_tiles);
  const int t_out = p.t_in * p.rate;
  const int T = p.tile;
  const int tile_m16 = p.tile_rows / 16;
  const int tconv_m16 = (p.m_rows + 15) / 16;

  // Rows before the sequence are zeros: so is the history a CTA starts from
  // (at row 0 exact; after warm_tiles tiles exact elsewhere).
  for (int i = tid; i < p.hist_rows * ldc / 8; i += kThreads) {
    reinterpret_cast<uint4*>(hist)[i] = make_uint4(0u, 0u, 0u, 0u);
  }
  // The weight stream: the tile's GEMMs in the order it runs them, the
  // CTA's columns of each.
  WeightPart* gemms = reinterpret_cast<WeightPart*>(smem + p.off_gemms);
  const int n_gemms = p.rate + 2 * kUnits;
  if (tid == 0) {
    const int tconv_passes = gemm_passes(tconv_m16, p.warp_n);
    const int unit_passes = gemm_passes(tile_m16, p.warp_n);
    for (int ph = 0; ph < p.rate; ++ph) {
      gemms[ph] = WeightPart{p.tconv_w + (size_t)(2 * p.rate - 1 - ph) * p.c_in * C + col0,
                             -(long long)p.rate * p.c_in * C, 2, p.c_in / kK,
                             tconv_passes};
    }
    for (int u = 0; u < kUnits; ++u) {
      gemms[p.rate + 2 * u] = WeightPart{p.w1[u] + col0, (long long)C * C, p.taps, C / kK,
                                         unit_passes};
      gemms[p.rate + 2 * u + 1] = WeightPart{p.w2[u] + col0, 0, 1, C / kK, unit_passes};
    }
  }
  __syncthreads();
  WeightStream<kK> st;
  st.gemms = gemms;
  st.n_gemms = n_gemms;
  st.ring = ring;
  st.stage_elems = kK * (p.cols + kPad);
  st.ld = C;
#pragma unroll
  for (int j = 0; j < kMaxCopies<kK>; ++j) {
    const int i = tid + j * kThreads;
    const int row = i / own8;
    const int c = (i - row * own8) * 8;
    st.dst_off[j] = i < kK * own8 ? row * (p.cols + kPad) + c : -1;
    st.src_off[j] = row * C + c;
  }
  st.gi = st.pass = st.part = st.kk = 0;
  st.src = gemms[0].w;
  st.issued = st.consumed = 0;
  for (int i = 0; i < kStages - 1; ++i) st.load_next();
  if (p.split > 1) {  // every peer runs before any CTA stores to it
    cluster_arrive();
    cluster_wait();
  }
  PhaseClock clk{p.timeline && tid == 0
                     ? p.timeline + ((size_t)b * gridDim.x + blockIdx.x) * kTimelineSlots
                     : nullptr};
  if (clk.out != nullptr) clk.start = clk.last = clock64();
  for (int tile = start; tile < last; ++tile) {
    const int t0 = tile * T;
    const int q0 = t0 / p.rate;  // exact: T is a multiple of s

    // ---- snake the input rows: xs row j holds input row q0 - 1 + j ----
    snake_rows(p.xs_rows, rank * in8, in8, p.alpha, p.beta, xs, ldx, p.split, [&](int j) {
      const int q = q0 - 1 + j;  // outside the input: the conv's zero padding
      return q >= 0 && q < p.t_in ? p.x + ((size_t)b * p.t_in + q) * p.c_in : nullptr;
    });
    sync_peers(p.split);
    clk.mark(kTlSnakeIn);

    // ---- transposed conv, phase by phase: tile row m * s + phase ----
    for (int phase = 0; phase < p.rate; ++phase) {
      // part 0: x[q] (xs row m + 1) with tap 2s-1-p; part 1: x[q-1] (xs row m)
      // with tap s-1-p.
      const Gemm g{xs + ldx, ldx, -1, 2, p.c_in, tconv_m16};
      gemm<kNT>(p, g, st, [&](int m, int n, float v0, float v1) {
        if (m < p.m_rows) {
          const float2 bias = load2(p.tconv_b + col0 + n);
          store2(h + (size_t)(m * p.rate + phase) * ldc + col0 + n, v0 + bias.x, v1 + bias.y);
        }
      });
    }
    // The first unit's input rows take the snaked input's space.
    if (p.split > 1) sync_peers(p.split);
    clk.mark(kTlTconv);

    // ---- three residual units ----
    int hist_at = 0;
    for (int u = 0; u < kUnits; ++u) {
      const int d = p.dil[u];
      const int hu = (p.taps - 1) * d;
      __nv_bfloat16* hist_u = hist + (size_t)hist_at * ldc;
      hist_at += hu;
      const __nv_bfloat16* alpha1 = p.unit_vec[u][0];
      const __nv_bfloat16* bias1 = p.unit_vec[u][2];
      const __nv_bfloat16* alpha2 = p.unit_vec[u][3];
      const __nv_bfloat16* bias2 = p.unit_vec[u][5];
      __nv_bfloat16* work = aw + (size_t)p.hmax * ldc;  // the tile's rows

      // The unit's snaked input: its history, then snake(h) of the tile.
      for (int i = tid; i < hu * c8; i += kThreads) {
        const int j = i / c8;
        const int c = (i - j * c8) * 8;
        *reinterpret_cast<uint4*>(work + (ptrdiff_t)(j - hu) * ldc + c) =
            *reinterpret_cast<const uint4*>(hist_u + (size_t)j * ldc + c);
      }
      snake_rows(T, col0 / 8, own8, alpha1, p.unit_vec[u][1], work, ldc, p.split,
                 [&](int r) { return h + (size_t)r * ldc; });
      sync_peers(p.split);
      // The next tile's history: the last hu rows of the unit's input.
      for (int i = tid; i < hu * c8; i += kThreads) {
        const int j = i / c8;
        const int c = (i - j * c8) * 8;
        *reinterpret_cast<uint4*>(hist_u + (size_t)j * ldc + c) =
            *reinterpret_cast<const uint4*>(work + (ptrdiff_t)(T - hu + j) * ldc + c);
      }
      clk.mark(kTlSnakeH);

      // c1 = snake(convK_d(snake(h)) + bias1): tap j reads row r - (K-1-j) d.
      // The snake runs as its own pass over c1, spread over every thread.
      const Gemm g1{work - (ptrdiff_t)hu * ldc, ldc, d, p.taps, C, tile_m16};
      gemm<kNT>(p, g1, st, [&](int m, int n, float v0, float v1) {
        if (m < T) {
          const float2 bias = load2(bias1 + col0 + n);
          store2(c1 + (size_t)m * ldc + col0 + n, v0 + bias.x, v1 + bias.y);
        }
      });
      clk.mark(kTlConvK);
      snake_rows(T, col0 / 8, own8, alpha2, p.unit_vec[u][4], c1, ldc, p.split,
                 [&](int r) { return c1 + (size_t)r * ldc; });
      sync_peers(p.split);
      clk.mark(kTlSnakeC);

      // h = h + (c1 @ W2 + bias2)
      const Gemm g2{c1, ldc, 0, 1, C, tile_m16};
      gemm<kNT>(p, g2, st, [&](int m, int n, float v0, float v1) {
        if (m < T) {
          __nv_bfloat16* at = h + (size_t)m * ldc + col0 + n;
          const float2 old = load2(at);
          const float2 bias = load2(bias2 + col0 + n);
          store2(at, old.x + bf(rb(v0 + bias.x)), old.y + bf(rb(v1 + bias.y)));
        }
      });
      clk.mark(kTlConv1);
    }

    // ---- write the tile's rows, the CTA's columns (a warm-up tile's are
    // dropped; the ragged last tile is masked) ----
    if (tile >= first) {
      for (int i = tid; i < T * own8; i += kThreads) {
        const int r = i / own8;
        const int c = col0 + (i - r * own8) * 8;
        const int t = t0 + r;
        if (t < t_out) {
          *reinterpret_cast<uint4*>(p.out + ((size_t)b * t_out + t) * C + c) =
              *reinterpret_cast<const uint4*>(h + (size_t)r * ldc + c);
        }
      }
    }
    clk.mark(kTlStore);
  }
  clk.finish();
  cp_async_wait<0>();  // the stages fetched ahead for a tile that never comes
}

int gcd(int a, int b) { return b == 0 ? a : gcd(b, a % b); }

int round_up(int v, int m) { return (v + m - 1) / m * m; }

// Shared-memory layout for a tile of `tile` rows; returns its bytes.
int layout(Params* p, int tile) {
  const int ldc = p->c_out + kPad;
  const int ldx = p->c_in + kPad;
  p->tile = tile;
  p->m_rows = tile / p->rate;
  p->xs_rows = round_up(p->m_rows, 16) + 1;
  p->tile_rows = round_up(tile, 16);
  int at = 0;
  auto take = [&](int bytes) {
    const int off = at;
    at = round_up(at + bytes, 128);
    return off;
  };
  // The snaked input rows are dead once the transposed conv has run, before
  // the first unit writes its input rows: they share those rows' space when
  // they fit in it.
  const int xs_bytes = 2 * p->xs_rows * ldx;
  const int a_bytes = 2 * (p->hmax + p->tile_rows) * ldc;
  p->off_h = take(2 * p->tile_rows * ldc);
  p->off_hist = take(2 * p->hist_rows * ldc);
  p->off_a = take(a_bytes > xs_bytes ? a_bytes : xs_bytes);
  p->off_xs = p->off_a;
  p->off_c1 = take(2 * p->tile_rows * ldc);
  p->off_ring = take(2 * kStages * p->stage_k * ldc);
  p->off_gemms = take((int)sizeof(WeightPart) * kMaxGemms);
  return at;
}

// The warp grid of a CTA's `cols` columns for a variant holding kNT n8
// tiles a warp: the fewest warps along the columns (1, 2, 4 or 8) whose
// share is at most kNT tiles. Sets warp_n and warp_nt; false if none.
bool warp_grid(Params* p, int nt_max) {
  const int n8 = p->cols / 8;
  for (int wn = 1; wn <= kWarps; wn *= 2) {
    if (n8 % wn == 0 && n8 / wn <= nt_max) {
      p->warp_n = wn;
      p->warp_nt = n8 / wn;
      return true;
    }
  }
  return false;
}

// The launch plan of one call: kernel variant (up to 3 n8 tiles a warp, 2
// CTAs an SM; or 6, 1 CTA), tile, shared memory, the columns split and the
// segments of tiles that fill the card. The tile is the longest (a
// multiple of lcm(16, s), at most kMaxTile) whose buffers fit and whose
// GEMMs take one pass per warp; two CTAs an SM are taken when that tile is
// at least 64 rows.
struct Plan {
  int nt, ctas_per_sm, smem, segments;  // nt: kNarrowNT or kWideNT
};

int device_attr(cudaDeviceAttr attr) {
  int device = 0, value = 0;
  if (cudaGetDevice(&device) != cudaSuccess) return 0;
  if (cudaDeviceGetAttribute(&value, attr, device) != cudaSuccess) return 0;
  return value;
}

// Whether a cluster of n CTAs can split the block's columns: each CTA
// computes C_out / n columns (a multiple of 16) and snakes C_in / n input
// channels (a multiple of 8).
bool split_fits(const Params& p, int n) {
  return n >= 1 && n <= kMaxSplit && p.c_out % (16 * n) == 0 && p.c_in % (8 * n) == 0;
}

template <int kNT, int kMinBlocks, int kK>
int max_clusters_of(const Plan& plan, int n) {
  auto kernel = vocoder_block_kernel<kNT, kMinBlocks, kK>;
  if (cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, plan.smem) !=
      cudaSuccess) {
    cudaGetLastError();
    return 0;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)n, 1, 1);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = plan.smem;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)n;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  int count = 0;
  if (cudaOccupancyMaxActiveClusters(&count, kernel, &cfg) != cudaSuccess) {
    cudaGetLastError();
    return 0;
  }
  return count;
}

// Clusters of n CTAs the card runs at once with this plan's shared memory
// (a cluster's CTAs share one GPC, so this is not SMs / n), 0 if none.
int cluster_slots(const Params& p, const Plan& plan, int n) {
  if (n == 1) return device_attr(cudaDevAttrMultiProcessorCount) * plan.ctas_per_sm;
  static int cache[2][2][kMaxSplit + 1][2];  // [variant][stage][n] = {smem, clusters}
  const bool narrow = plan.nt == kNarrowNT;
  int* hit = cache[narrow ? 0 : 1][p.stage_k == kMaxStageK ? 0 : 1][n];
  if (hit[0] != plan.smem) {
    hit[1] = p.stage_k == kMaxStageK
                 ? (narrow ? max_clusters_of<kNarrowNT, 2, kMaxStageK>(plan, n)
                           : max_clusters_of<kWideNT, 1, kMaxStageK>(plan, n))
                 : (narrow ? max_clusters_of<kNarrowNT, 2, kMmaK>(plan, n)
                           : max_clusters_of<kWideNT, 1, kMmaK>(plan, n));
    hit[0] = plan.smem;
  }
  return hit[1];
}

// Segments of a batch row at n CTAs a tile: as many as keep every row's
// clusters in one wave of `slots`. Returns the cost the plan compares, the
// tiles each CTA runs (its warm-up included) over the speed of n CTAs a
// tile, times the waves.
float cut_rows(Params* p, int batch, int slots, int n) {
  const int want = max(1, min(p->tiles, slots / batch));
  p->seg_tiles = (p->tiles + want - 1) / want;
  const int segments = (p->tiles + p->seg_tiles - 1) / p->seg_tiles;
  const int waves = (batch * segments + slots - 1) / slots;
  const int runs = p->seg_tiles + (segments > 1 ? p->warm_tiles : 0);
  return (float)waves * runs * (kFixedShare + (1.f - kFixedShare) / n);
}

// tile, split: 0 lets the plan choose; else that tile (a multiple of
// lcm(16, s) that fits) or that split (split_fits).
bool make_plan(Params* p, int batch, int max_optin, int tile_req, int split_req, Plan* plan) {
  int dmax = 0, dsum = 0;
  for (int u = 0; u < kUnits; ++u) {
    dmax = max(dmax, p->dil[u]);
    dsum += p->dil[u];
  }
  p->hmax = (p->taps - 1) * dmax;
  p->hist_rows = (p->taps - 1) * dsum;
  const int step = kMmaK / gcd(kMmaK, p->rate) * p->rate;
  if (tile_req < 0 || tile_req % step || tile_req > kMaxTile) return false;
  if (split_req != 0 && !split_fits(*p, split_req)) return false;
  // 32-row weight stages (half the block barriers) when every GEMM's inner
  // rows come in 32s.
  p->stage_k = p->c_in % kMaxStageK == 0 && p->c_out % kMaxStageK == 0 ? kMaxStageK : kMmaK;
  const int variants[2][3] = {{kNarrowNT, 2, kSmemPerSm / 2 - kSmemReserved},
                              {kWideNT, 1, max_optin}};
  bool found = false;
  p->cols = p->c_out;
  for (int v = 0; v < 2 && !found; ++v) {
    const int nt = variants[v][0];
    const int budget = min(variants[v][2], max_optin);
    if (!warp_grid(p, nt)) continue;
    for (int tile = kMaxTile / step * step; tile >= step; tile -= step) {
      if (tile_req != 0 && tile != tile_req) continue;
      const int bytes = layout(p, tile);
      const bool one_pass = gemm_passes(p->tile_rows / 16, p->warp_n) == 1 &&
                            gemm_passes((p->m_rows + 15) / 16, p->warp_n) == 1;
      // The 1-CTA variant takes any tile that fits, shortest last, with
      // more passes if it must (or the tile asked for).
      if (bytes <= budget && (one_pass || (v == 1 && (tile == step || tile_req != 0))) &&
          (v == 1 || tile >= 64)) {
        plan->nt = nt;
        plan->ctas_per_sm = variants[v][1];
        plan->smem = bytes;
        found = true;
        break;
      }
    }
  }
  if (!found) return false;
  const long long t_out = (long long)p->t_in * p->rate;
  p->tiles = (int)((t_out + p->tile - 1) / p->tile);
  p->warm_tiles = (p->hist_rows + p->tile - 1) / p->tile;
  // The split: the one the cost model gives the least time, the smallest of
  // equals. A call whose rows fill the card keeps 1; a short one (the
  // stream's first packet) splits each tile's columns over a cluster.
  float best = 0.f;
  p->split = 0;
  for (int n = 1; n <= kMaxSplit; ++n) {
    if (!split_fits(*p, n) || (split_req != 0 && n != split_req)) continue;
    p->cols = p->c_out / n;
    if (!warp_grid(p, plan->nt)) continue;
    const int slots = cluster_slots(*p, *plan, n);
    if (slots <= 0) continue;
    const float cost = cut_rows(p, batch, slots, n);
    if (p->split == 0 || cost < best) {
      best = cost;
      p->split = n;
    }
  }
  if (p->split == 0) return false;
  cut_rows(p, batch, cluster_slots(*p, *plan, p->split), p->split);
  p->cols = p->c_out / p->split;
  warp_grid(p, plan->nt);
  plan->segments = (p->tiles + p->seg_tiles - 1) / p->seg_tiles;
  return true;
}

bool geometry_ok(int c_in, int c_out, int rate, int taps, const int* dil) {
  if (c_in <= 0 || c_out <= 0 || c_in % 16 || c_out % 16 || c_in > kMaxCIn) return false;
  if (c_out > kMaxCIn || rate < 1 || rate > kMaxRate || taps < 1 || taps > kMaxTaps) return false;
  for (int u = 0; u < kUnits; ++u) {
    if (dil[u] < 1) return false;
  }
  return true;
}

bool plan_call(Params* p, int batch, int tile, int split, Plan* plan) {
  return make_plan(p, batch, device_attr(cudaDevAttrMaxSharedMemoryPerBlockOptin), tile, split,
                   plan);
}

template <int kNT, int kMinBlocks, int kK>
cudaError_t launch(const Params& p, const Plan& plan, int batch, cudaStream_t stream) {
  auto kernel = vocoder_block_kernel<kNT, kMinBlocks, kK>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, plan.smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((unsigned)(plan.segments * p.split), (unsigned)batch);
  if (p.split == 1) {
    kernel<<<grid, kThreads, plan.smem, stream>>>(p);
    return cudaGetLastError();
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = plan.smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)p.split;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kernel, p);
  return err != cudaSuccess ? err : cudaGetLastError();
}

// Params of a geometry (pointers unset).
Params geometry(int c_in, int c_out, int rate, int taps, int d0, int d1, int d2, int t_in) {
  Params p{};
  p.c_in = c_in;
  p.c_out = c_out;
  p.rate = rate;
  p.taps = taps;
  p.t_in = t_in;
  p.dil[0] = d0;
  p.dil[1] = d1;
  p.dil[2] = d2;
  return p;
}

}  // namespace

// Probes for counting the snake's instructions in the built library's SASS
// (cuobjdump -sass): the same loads and store, with and without one snake on
// its common path (the table-driven division). Never launched.
extern "C" __global__ void vocoder_snake_probe(const __nv_bfloat16* x, const __nv_bfloat16* a,
                                               const float2* div, __nv_bfloat16* out) {
  const int i = threadIdx.x;
  const float2 dr = div[i];
  const float v = bf(x[i]);
  out[i] = rb(__fadd_rn(v, fast_div(snake_num(v, bf(a[i])), dr.x, dr.y)));
}

extern "C" __global__ void vocoder_copy_probe(const __nv_bfloat16* x, const __nv_bfloat16* a,
                                              const float2* div, __nv_bfloat16* out) {
  const int i = threadIdx.x;
  const float2 dr = div[i];
  out[i] = rb(bf(x[i]) + bf(a[i]) + dr.x + dr.y);
}

// The launch plan of one geometry and input on the current card (tile,
// split: 0 = the plan's choice): out[0] tile rows, out[1] warm-up tiles a
// segment, out[2] tiles a segment, out[3] segments a batch row, out[4]
// dynamic shared bytes, out[5] CTAs an SM, out[6] warps along the columns
// in the GEMMs' warp grid, out[7] CTAs of a cluster splitting a tile's
// columns. Returns a
// cudaError_t code.
extern "C" int qtts_vocoder_block_plan(int c_in, int c_out, int rate, int taps, int d0, int d1,
                                       int d2, int batch, int t_in, int tile, int split,
                                       int* out) {
  Params p = geometry(c_in, c_out, rate, taps, d0, d1, d2, t_in);
  Plan plan{};
  if (!geometry_ok(c_in, c_out, rate, taps, p.dil) || batch <= 0 || t_in <= 0 ||
      !plan_call(&p, batch, tile, split, &plan)) {
    return (int)cudaErrorInvalidValue;
  }
  const int values[8] = {p.tile, p.warm_tiles, p.seg_tiles, plan.segments, plan.smem,
                         plan.ctas_per_sm, p.warp_n, p.split};
  for (int i = 0; i < 8; ++i) out[i] = values[i];
  return 0;
}

// x bf16 [B, T_in, C_in] -> out bf16 [B, T_in * rate, C_out]. ``weights``
// and ``vectors`` are host arrays of device pointers, all bf16 (see Params):
// weights tconv_w, w1[0..2], w2[0..2]; vectors alpha, beta, tconv_b, then per
// unit alpha1, beta1, conv1 bias, alpha2, beta2, conv2 bias. taps is K of the
// residual units' dilated convs; tile and split as for the plan. timeline:
// nullptr, or u64 zeros [batch * segments * split][kTimelineSlots] for a
// timed launch (TimelineSlot). Returns a cudaError_t code.
extern "C" int qtts_vocoder_block(const void* x, void* out, const void* const* weights,
                                  const void* const* vectors, int batch, int t_in, int c_in,
                                  int c_out, int rate, int taps, int d0, int d1, int d2,
                                  int tile, int split, void* timeline, void* stream) {
  using bf16p = const __nv_bfloat16*;
  Params p = geometry(c_in, c_out, rate, taps, d0, d1, d2, t_in);
  p.x = static_cast<bf16p>(x);
  p.out = static_cast<__nv_bfloat16*>(out);
  p.tconv_w = static_cast<bf16p>(weights[0]);
  for (int u = 0; u < kUnits; ++u) {
    p.w1[u] = static_cast<bf16p>(weights[1 + u]);
    p.w2[u] = static_cast<bf16p>(weights[1 + kUnits + u]);
    for (int k = 0; k < kVecPerUnit; ++k) {
      p.unit_vec[u][k] = static_cast<bf16p>(vectors[3 + kVecPerUnit * u + k]);
    }
  }
  p.alpha = static_cast<bf16p>(vectors[0]);
  p.beta = static_cast<bf16p>(vectors[1]);
  p.tconv_b = static_cast<bf16p>(vectors[2]);
  p.timeline = static_cast<unsigned long long*>(timeline);
  Plan plan{};
  if (batch <= 0 || t_in <= 0 || batch > 65535 || (long long)t_in * rate > (1LL << 30) ||
      !geometry_ok(c_in, c_out, rate, taps, p.dil) || !plan_call(&p, batch, tile, split, &plan)) {
    return (int)cudaErrorInvalidValue;
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (p.stage_k == kMaxStageK) {
    return (int)(plan.nt == kNarrowNT ? launch<kNarrowNT, 2, kMaxStageK>(p, plan, batch, s)
                                      : launch<kWideNT, 1, kMaxStageK>(p, plan, batch, s));
  }
  return (int)(plan.nt == kNarrowNT ? launch<kNarrowNT, 2, kMmaK>(p, plan, batch, s)
                                    : launch<kWideNT, 1, kMmaK>(p, plan, batch, s));
}
