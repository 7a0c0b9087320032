// One sub-talker micro-step for Hopper (sm_90a): all 5 trunk layers in ONE
// cooperative launch, int8 weights with f32 per-output-channel scales.
//
// Replaces the TPU kernel scripts/exp_pallas_subtalker_step.py
// (`pallas_subtalker_trunk_step`, body `_kernel`): for a [B, 1024] hidden
// state at micro-step position `pos` (one scalar for all rows), per layer
// RMSNorm -> Q/K/V -> per-head QK-RMSNorm + RoPE -> append the K/V row at
// `pos` -> GQA attention over positions <= pos -> o-proj -> RMSNorm ->
// SwiGLU, with the residual held in f32 across all layers and cast once at
// the end. The rounding points are the TPU kernel's: the normed activations,
// the QK-normed heads, the cache rows, the attention probabilities and
// output, and the SwiGLU product are rounded to the activation dtype T;
// every dot accumulates in f32 and takes its f32 scale after the dot.
//
// Dims are the flagship sub-talker's, fixed at compile time (L 5, D 1024,
// H 16, KV 8, hd 128, I 3072); T is float or bf16, B 1..32. The KV cache is
// the port's layout [L, B, G, KV, hd] in T, written in place at row `pos`.
//
// Bound: bytes. A launch streams the 78.6 MB of int8 weights (5 x 15.73 M)
// once: 23.5 us at 3.35 TB/s. The products, 2 x 78.6 M x B flops, stay well
// under that line on the bf16 tensor cores for every B here.
//
// What held the first design at 8.7x the bound, and what this one
// does about it:
//  1. 34 grid barriers per launch, and no weight byte in flight while a
//     block waited at one: loads were issued only inside the GEMV loops.
//     Here one producer warp per block streams the block's weights with
//     1-D bulk copies (cp.async.bulk, completion on an mbarrier) into a
//     ring of 8 x 16 KB stages in shared memory. Weights do not depend on
//     activations, so the producer runs ahead through the next phases and
//     layers while the consumer warps wait at a grid barrier; it stalls only
//     when the ring is full.
//  2. Shallow loads (one 4-byte __ldg per lane per weight row, <= 32 KB in
//     flight per SM). Here up to 128 KB per SM is in flight, 16 KB per copy,
//     marked evict-first in L2 so the stream does not push out activations.
//  3. Split-K partial sums in global memory, reduced serially by their
//     consumer (32-96 partials per element, the SwiGLU input rebuilt by
//     every down-projection unit). Here each block owns whole output columns
//     over the full K: its 8 consumer warps take slices of K and their sums
//     meet in shared memory, added in warp order. The epilogue applies the
//     scale and the residual add or the SwiGLU. Scratch holds no partials:
//     the f32 residual, the scaled Q/K/V, the attention output and the
//     SwiGLU product, 40 KB per batch row (was 1.19 MB).
//  4. Attention on one block per (row, KV head), 32 SMs at B=4, with one
//     dependent warp sum per position. Here one warp per (row, query head)
//     spreads over B x 16 warps across the grid (64 SMs at B=4); each lane
//     scores its own position from a key row it loaded ahead, so the
//     scores are computed in parallel.
//  5. f32 FMAs on the CUDA cores for every product. Here bf16 runs on the
//     tensor cores (mma.sync m16n8k16, bf16 in, f32 accumulate): batch rows
//     are the M side padded to 16 or 32, weight columns the N side in tiles
//     of 8. int8 -> bf16 is exact, so the products are the same numbers;
//     only the order of summation changes. The int8 -> bf16 step and every
//     rounding to bf16 are integer and byte-permute operations (the card's
//     float -> bf16 conversion issues at a quarter rate and was the mma
//     loop's limit). f32, the parity dtype, keeps exact f32 FMAs on the CUDA
//     cores.
//  6. Per-launch host work (the wrapper checked 16 operands and allocated
//     the scratch on every launch). The operands are checked once when they
//     are packed; the scratch is kept with them, one per batch size.
//
// Layout (ops/cuda/subtalker_step.py, `pack_subtalker_weights`). Block j of
// the 128 owns: Q/K/V columns 32j..32j+31 (two groups of 16), o-proj
// columns 8j..8j+7, gate columns 24j..24j+23 with the matching up columns
// (three groups of 8 gate + 8 up), down columns 8j..8j+7. Per layer and
// phase a block's int8 weights are one contiguous run: its groups in order,
// each group over the full K in chunks of <= 16 KB (down: 2 x 1536 rows),
// each chunk as 128-byte tiles of 16 k x 8 columns in k-step order, a
// tile holding each lane's 4 B of the mma B fragment at lane x 4. The
// [gate|up] scales follow the same column order; 120 KB per block per layer.
//
// Phases per layer, a grid barrier after each (24 per launch, was 34):
// Q/K/V -> attention (QK-norm, RoPE, the K/V row write) -> o-proj +
// residual -> gate|up, SwiGLU -> down + residual. Before Q/K/V and gate|up
// each block norms the f32 residual rows it needs (one read of each row)
// into bf16 in shared memory, where every warp reads its A fragments.
//
// The grid barrier is hand-written (the producer warp must not take part):
// the consumer threads meet on a named barrier, then thread 0 makes one
// release add to a 64-bit arrival count and spins on acquire loads until
// every block has arrived. The count only grows; each launch rounds it down
// to find its own start. It measured 1.01 us per barrier on an NVIDIA H100
// 80GB HBM3 at 700 W (`qtts_subtalker_barrier_bench`, chip_smoke.py); a
// variant whose last arrival publishes a flag on a line of its own measured
// 1.44 us.
//
// Where the time goes (B=4 bf16, mid-frame, same card; `timeline` below):
// 101.5 us, 4.3x the bound. The weights wait on the consumers, not the
// reverse: the producer spends 78 us waiting for free stages, the
// consumers 3.4 us for weights (the launch's first chunk). The 24 barriers
// with their skew take ~38 us, the attention phase's single warp per
// (row, head) ~7 us plus ~12 us of the next barrier, the four projections
// ~56 us of latency-bound work (L2 reads of the activations, reductions,
// epilogues).
//
// Deterministic: no atomics on data, every sum in a fixed order, so two
// launches on the same inputs give the same bits. The launch goes on the
// caller's stream, allocates nothing and returns the CUDA error code.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kLayers = 5;
constexpr int kD = 1024;
constexpr int kHeads = 16;
constexpr int kKV = 8;
constexpr int kHD = 128;
constexpr int kI = 3072;
constexpr int kGrp = kHeads / kKV;      // queries per KV head
constexpr int kNQ = kHeads * kHD;       // 2048
constexpr int kNKV = kKV * kHD;         // 1024
constexpr int kNQKV = kNQ + 2 * kNKV;   // 4096
constexpr int kNGU = 2 * kI;            // 6144
constexpr int kMaxBatch = 32;
constexpr int kMaxGroups = 64;
constexpr int kBlocks = 128;            // blocks of the layout, one per SM
constexpr int kWarps = 8;               // consumer warps
constexpr int kConsumers = kWarps * 32;
constexpr int kThreads = kConsumers + 32;  // + the producer warp
constexpr int kStageBytes = 16384;
constexpr int kStages = 8;
constexpr int kTileBytes = 128;         // 16 k x 8 columns of int8
constexpr float kScale = 0.08838834764831845f;  // hd ** -0.5

// One projection's share per block: NT n-tiles of 8 columns per group,
// GROUPS groups, K rows in CHUNKS chunks.
template <int K_, int NT_, int GROUPS_, int CHUNKS_>
struct Proj {
  static constexpr int K = K_, NT = NT_, GROUPS = GROUPS_, CHUNKS = CHUNKS_;
  static constexpr int KS = K / 16 / CHUNKS;             // k-steps per chunk
  static constexpr int CHUNK_BYTES = KS * NT * kTileBytes;
  static constexpr int BLOCK_BYTES = GROUPS * CHUNKS * CHUNK_BYTES;
  static_assert(CHUNK_BYTES <= kStageBytes, "a chunk must fit a ring stage");
  static_assert(KS % kWarps == 0, "every warp takes the same number of k-steps");
};
using QKV = Proj<kD, 2, 2, 1>;      // 32 columns x 1024
using OProj = Proj<kNQ, 1, 1, 1>;   // 8 x 2048
using GateUp = Proj<kD, 2, 3, 1>;   // (8 gate + 8 up) x 3 x 1024
using Down = Proj<kI, 1, 1, 2>;     // 8 x 3072
static_assert(QKV::BLOCK_BYTES * kBlocks == kD * kNQKV, "Q/K/V layout");
static_assert(OProj::BLOCK_BYTES * kBlocks == kNQ * kD, "o-proj layout");
static_assert(GateUp::BLOCK_BYTES * kBlocks == kD * kNGU, "gate|up layout");
static_assert(Down::BLOCK_BYTES * kBlocks == kI * kD, "down layout");

// Scratch: the barrier counts (the step's at byte 0, the barrier bench's at
// byte 64), then per batch row the f32 residual and the scaled Q/K/V, the
// attention output and the SwiGLU product in T.
constexpr int kBarrierBytes = 256;
constexpr int kBenchCountByte = 64;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }

// x rounded to the nearest bf16 (ties to even), still as a float: integer
// ops on the bits, which the card issues at full rate (a float -> bf16
// conversion issues at a quarter of it). Exact for every finite x.
__device__ __forceinline__ float round_bf16(float x) {
  const uint32_t u = __float_as_uint(x);
  return __uint_as_float((u + 0x7FFFu + ((u >> 16) & 1u)) & 0xFFFF0000u);
}

template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __ushort_as_bfloat16((unsigned short)(__float_as_uint(round_bf16(x)) >> 16));
}

// A value rounded to T and read back: where the TPU kernel casts to its dtype.
template <typename T>
__device__ __forceinline__ float round_to(float x) {
  if constexpr (sizeof(T) == 2) {
    return round_bf16(x);
  } else {
    return x;
  }
}

// Two adjacent floats (an even index, so the pair is aligned).
__device__ __forceinline__ float2 load2(const float* p) { return *reinterpret_cast<const float2*>(p); }

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int offset = 16; offset > 0; offset >>= 1) x += __shfl_xor_sync(0xffffffffu, x, offset);
  return x;
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int offset = 16; offset > 0; offset >>= 1) {
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, offset));
  }
  return x;
}

// ---- shared-memory pipeline: mbarriers and bulk copies ---------------------

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_addr(bar)) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

// Spins that outlast this many tries trap: a fault, not a hung card.
constexpr long long kSpinLimit = 1ll << 22;

// Spin until the barrier's phase differs from `parity`.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_addr(bar);
  uint32_t done = 0;
  for (long long tries = 0; !done; ++tries) {
    if (tries == kSpinLimit) __trap();
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  }
}

// `bytes` from global `src` to shared `dst`, completion counted on `bar`;
// the lines are the first L2 evicts (`policy`, from evict_first_policy).
__device__ __forceinline__ void bulk_copy(void* dst, const void* src, uint32_t bytes,
                                          uint64_t* bar, uint64_t policy) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes.L2::cache_hint"
      " [%0], [%1], %2, [%3], %4;\n"
      ::"r"(smem_addr(dst)), "l"(src), "r"(bytes), "r"(smem_addr(bar)), "l"(policy)
      : "memory");
}

// Weights are read once per launch and outnumber L2: they should not push
// out the activations, scratch and KV cache.
__device__ __forceinline__ uint64_t evict_first_policy() {
  uint64_t policy;
  asm volatile("createpolicy.fractional.L2::evict_first.b64 %0, 1.0;\n" : "=l"(policy));
  return policy;
}

// The consumer warps' own block barrier (the producer warp never joins).
__device__ __forceinline__ void consumer_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(kConsumers) : "memory");
}

// ---- the grid barrier ------------------------------------------------------

// Barriers per step launch: 5 per layer, none after the last.
constexpr int kBarriers = 5 * kLayers - 1;

__device__ __forceinline__ unsigned long long load_acquire(const unsigned long long* p) {
  unsigned long long v;
  asm volatile("ld.acquire.gpu.global.u64 %0, [%1];\n" : "=l"(v) : "l"(p) : "memory");
  return v;
}

// The barrier's arrival count only grows, and every launch on one count
// passes the same number of barriers, so a launch starts at a multiple of
// barriers x grid: a block finds it by rounding the count down (fewer than
// `grid` arrivals can precede its own first one). Thread 0's first target.
__device__ __forceinline__ unsigned long long barrier_base(const unsigned long long* count,
                                                           int barriers) {
  const unsigned long long c = load_acquire(count);
  return c - c % ((unsigned long long)barriers * gridDim.x);
}

// Every consumer thread of every block; writes before it are seen after it.
// One release add per block, then acquire loads until all have arrived.
__device__ void grid_barrier(unsigned long long* count, unsigned long long& target) {
  consumer_sync();
  if (threadIdx.x == 0) {
    target += gridDim.x;
    asm volatile("red.release.gpu.global.add.u64 [%0], %1;\n" ::"l"(count), "l"(1ull) : "memory");
    for (long long tries = 0; load_acquire(count) < target; ++tries) {
      if (tries == kSpinLimit) __trap();
    }
  }
  consumer_sync();
}

// ---- operands --------------------------------------------------------------

template <typename T>
struct Params {
  const T* x;  // [B, D]
  const float* cos;  // [hd] for this position
  const float* sin;
  const int8_t* wqkv;  // [L, 128, QKV::BLOCK_BYTES], see the layout above
  const float* qkv_s;  // [L, 4096]
  const int8_t* wo;    // [L, 128, OProj::BLOCK_BYTES]
  const float* wo_s;   // [L, D]
  const int8_t* wgu;   // [L, 128, GateUp::BLOCK_BYTES]
  const float* gu_s;   // [L, 6144] in the layout's column order
  const int8_t* wdown;  // [L, 128, Down::BLOCK_BYTES]
  const float* down_s;  // [L, D]
  const T* in_norm;     // [L, D]
  const T* post_norm;   // [L, D]
  const T* q_norm;      // [L, hd]
  const T* k_norm;      // [L, hd]
  T* k_cache;           // [L, B, G, KV, hd]
  T* v_cache;
  T* out;      // [B, D]
  unsigned long long* barrier;  // the arrival count
  unsigned long long* timeline;  // [grid][kTimelineSlots] when timed, or nullptr
  float* h32;  // [B, D] f32 residual
  float* qkv;  // [B, 4096] scaled Q/K/V sums
  T* attn;     // [B, 2048]
  T* act;      // [B, 3072] SwiGLU product
  int batch, groups, pos;
  float eps;
};

// A timed launch records, per block (consumer thread 0 and the producer),
// SM cycles: the start, the end of each phase and of the barrier after it,
// the cycles spent waiting for weights (consumers) and for free stages (the
// producer), and the end; the global timer at the start and the end gives
// the cycle rate.
constexpr int kTimelineSlots = 64;
constexpr int kTlStart = 0, kTlNsStart = 1, kTlPhases = 2, kTlWaitWeights = 60,
              kTlWaitStages = 61, kTlEnd = 62, kTlNsEnd = 63;

__device__ __forceinline__ unsigned long long global_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;\n" : "=l"(t));
  return t;
}

// A block's scales of one layer, staged in shared memory at the start:
// Q/K/V 32, o-proj 8, [gate|up] 48 (layout order), down 8.
constexpr int kScQKV = 0, kScO = 32, kScGU = 40, kScDown = 88, kScPerLayer = 96;

// ---- the producer: every chunk of the launch, in the consumers' order ------

template <class P>
__device__ __forceinline__ void produce_proj(const int8_t* base, int layer, uint8_t* ring,
                                             uint64_t* full, uint64_t* empty, int& stage,
                                             uint32_t& phase, unsigned long long* waited,
                                             uint64_t policy) {
  const int8_t* src = base + ((size_t)layer * kBlocks + blockIdx.x) * P::BLOCK_BYTES;
  for (int c = 0; c < P::GROUPS * P::CHUNKS; ++c) {
    const long long t0 = waited ? clock64() : 0;
    mbar_wait(&empty[stage], phase ^ 1);
    if (waited) *waited += clock64() - t0;
    mbar_expect_tx(&full[stage], P::CHUNK_BYTES);
    bulk_copy(ring + stage * kStageBytes, src + c * P::CHUNK_BYTES, P::CHUNK_BYTES, &full[stage],
              policy);
    if (++stage == kStages) {
      stage = 0;
      phase ^= 1;
    }
  }
}

template <typename T>
__device__ void produce(const Params<T>& p, uint8_t* ring, uint64_t* full, uint64_t* empty) {
  int stage = 0;
  uint32_t phase = 0;
  unsigned long long waited = 0;
  unsigned long long* w = p.timeline ? &waited : nullptr;
  const uint64_t policy = evict_first_policy();
  for (int l = 0; l < kLayers; ++l) {
    produce_proj<QKV>(p.wqkv, l, ring, full, empty, stage, phase, w, policy);
    produce_proj<OProj>(p.wo, l, ring, full, empty, stage, phase, w, policy);
    produce_proj<GateUp>(p.wgu, l, ring, full, empty, stage, phase, w, policy);
    produce_proj<Down>(p.wdown, l, ring, full, empty, stage, phase, w, policy);
  }
  if (w) p.timeline[blockIdx.x * kTimelineSlots + kTlWaitStages] = waited;
}

// The consumers' position in the ring.
struct Ring {
  uint8_t* base;
  uint64_t* full;
  uint64_t* empty;
  int stage;
  uint32_t phase;
  bool timed;
  unsigned long long waited;  // cycles spent in wait() when timed

  __device__ const uint8_t* wait() {
    const long long t0 = timed ? clock64() : 0;
    mbar_wait(&full[stage], phase);
    if (timed) waited += clock64() - t0;
    return base + stage * kStageBytes;
  }
  // Every consumer warp releases every chunk it waited for.
  __device__ void release() {
    __syncwarp();
    if (threadIdx.x % 32 == 0) mbar_arrive(&empty[stage]);
    if (++stage == kStages) {
      stage = 0;
      phase ^= 1;
    }
  }
};

// ---- activations -------------------------------------------------------

// A projection's input [B, ld] of stored type S, already rounded to T; with
// NORM, the RMSNorm of the residual (x in layer 0, else the f32 h32) times
// the norm weight w, rounded as the TPU kernel rounds it.
template <typename T, typename S, bool NORM>
struct Act {
  const S* src;
  const T* w;
  int ld;
};

template <typename T>
__device__ __forceinline__ float2 norm2(float2 v, float r, float2 w) {
  return make_float2(round_to<T>(round_to<T>(v.x * r) * w.x),
                     round_to<T>(round_to<T>(v.y * r) * w.y));
}

// 1 / rms of each row of the residual into rstd[B] (every block, all rows).
template <typename T>
__device__ void row_rstd(const Params<T>& p, bool from_x, float* rstd) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int b = warp; b < p.batch; b += kWarps) {
    float2 v[kD / 64];
#pragma unroll
    for (int i = 0; i < kD / 64; ++i) {
      const int n = b * kD + 2 * lane + 64 * i;
      v[i] = from_x ? load2(p.x + n) : load2(p.h32 + n);
    }
    float ss = 0.f;
#pragma unroll
    for (int i = 0; i < kD / 64; ++i) ss += v[i].x * v[i].x + v[i].y * v[i].y;
    ss = warp_sum(ss);
    if (lane == 0) rstd[b] = 1.f / sqrtf(ss / kD + p.eps);
  }
  consumer_sync();
}

// Two floats that are bf16 values already (low 16 bits zero) as a bf16 pair.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  return __byte_perm(__float_as_uint(lo), __float_as_uint(hi), 0x7632);
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// The A fragment of one k-step for m-tile m, element e: row g (e even) or
// g + 8 (e odd), columns k + 2q (e < 2) or k + 2q + 8. Rows past the batch
// read the last row: their sums are never read.
__device__ __forceinline__ int frag_row(int m, int e, int batch) {
  return min(16 * m + (threadIdx.x % 32) / 4 + 8 * (e & 1), batch - 1);
}

// The A fragments of one k-step from a bf16 [B, ld] array (global or shared).
// The rows g + 8 of an m-tile are zero when they all lie past the batch.
template <int MT>
__device__ __forceinline__ void load_frag(const __nv_bfloat16* a, int ld, int k, int batch,
                                          uint32_t (&f)[MT][4]) {
  const int col = k + 2 * (threadIdx.x % 4);
#pragma unroll
  for (int m = 0; m < MT; ++m) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      f[m][e] = (e & 1) && 16 * m + 8 >= batch
                    ? 0u
                    : *reinterpret_cast<const uint32_t*>(a + (size_t)frag_row(m, e, batch) * ld +
                                                         col + 8 * (e >> 1));
    }
  }
}

// Row stride of the staged normed input: 8 bf16 of padding put the rows an
// A fragment reads in different banks.
constexpr int kXsStride = kD + 8;

__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const float2 lo = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
  const float2 hi = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
  return make_float4(lo.x, lo.y, hi.x, hi.y);
}

// The RMSNorm of the residual rows (x in layer 0, else h32) times the norm
// weight, rounded to bf16 as the TPU kernel rounds it, into xs [B][kXsStride]
// in shared memory: one read of each row, one of the weight. Warp w takes
// rows w, w + 8, ...; lane l columns 4 l + 128 i.
template <typename S>
__device__ void stage_normed(const S* src, const __nv_bfloat16* w, int batch, float eps,
                             __nv_bfloat16* xs) {
  using T = __nv_bfloat16;
  constexpr int N = kD / 128;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  float4 wv[N];
#pragma unroll
  for (int i = 0; i < N; ++i) wv[i] = load4(w + 4 * lane + 128 * i);
  for (int b = warp; b < batch; b += kWarps) {
    float4 v[N];
    float ss = 0.f;
#pragma unroll
    for (int i = 0; i < N; ++i) {
      v[i] = load4(src + (size_t)b * kD + 4 * lane + 128 * i);
      ss += v[i].x * v[i].x + v[i].y * v[i].y + v[i].z * v[i].z + v[i].w * v[i].w;
    }
    const float r = 1.f / sqrtf(warp_sum(ss) / kD + eps);
#pragma unroll
    for (int i = 0; i < N; ++i) {
      const float2 lo = norm2<T>(make_float2(v[i].x, v[i].y), r, make_float2(wv[i].x, wv[i].y));
      const float2 hi = norm2<T>(make_float2(v[i].z, v[i].w), r, make_float2(wv[i].z, wv[i].w));
      *reinterpret_cast<uint2*>(xs + b * kXsStride + 4 * lane + 128 * i) =
          make_uint2(pack_bf16(lo.x, lo.y), pack_bf16(hi.x, hi.y));
    }
  }
  consumer_sync();
}

// ---- one projection ---------------------------------------------------------

// The sums of a group's COLS columns over the full K are in red[warp][row]
// [column] (each warp holds its K slice); the epilogue adds the 8 warps in
// warp order and applies the scale.
template <int BP, int COLS, class Epilogue>
__device__ __forceinline__ void finish_group(float* red, int grp, Epilogue& epilogue) {
  consumer_sync();
  epilogue(grp, [&](int b, int col) {
    const float* r = red + b * COLS + col;
    float s = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) s += r[w * BP * COLS];
    return s;
  });
  consumer_sync();  // red is rewritten by the next group
}

// This warp's sums of NT tiles into red[warp].
template <int MT, int NT>
__device__ __forceinline__ void store_mma_sums(const float (&c)[NT][MT][4], float* red) {
  constexpr int COLS = 8 * NT, BP = 16 * MT;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane / 4, q = lane % 4;
  float* my = red + warp * BP * COLS;
#pragma unroll
  for (int m = 0; m < MT; ++m) {
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      const int col = 8 * n + 2 * q, r0 = 16 * m + g;
      my[r0 * COLS + col] = c[n][m][0];
      my[r0 * COLS + col + 1] = c[n][m][1];
      my[(r0 + 8) * COLS + col] = c[n][m][2];
      my[(r0 + 8) * COLS + col + 1] = c[n][m][3];
    }
  }
}

// Four int8 weights (k = 2q, 2q+1, 2q+8, 2q+9) as the two bf16 pairs of the
// mma B fragment, exactly and with no conversion instruction: a byte permute
// makes each byte x + 128 the float 2^23 + x + 128, less 2^23 + 128 gives x,
// and an integer that small is a bf16 value.
__device__ __forceinline__ void weights_bf16(uint32_t w, uint32_t& b0, uint32_t& b1) {
  const uint32_t u = w ^ 0x80808080u;
  float f[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    f[i] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7540 + i)) - 8388736.f;
  }
  b0 = pack_bf16(f[0], f[1]);
  b1 = pack_bf16(f[2], f[3]);
}

// mma of k-step `ks` of a stage's tile n into c.
template <int MT, int NT>
__device__ __forceinline__ void mma_tile(const uint8_t* buf, int ks, int n,
                                         const uint32_t (&f)[MT][4], float (&c)[MT][4]) {
  uint32_t b0, b1;
  weights_bf16(*reinterpret_cast<const uint32_t*>(buf + (ks * NT + n) * kTileBytes +
                                                  (threadIdx.x % 32) * 4),
               b0, b1);
#pragma unroll
  for (int m = 0; m < MT; ++m) mma_bf16(c[m], f[m], b0, b1);
}

template <int A, int MT>
__device__ __forceinline__ void zero(float (&c)[A][MT][4]) {
#pragma unroll
  for (int i = 0; i < A; ++i) {
#pragma unroll
    for (int m = 0; m < MT; ++m) {
#pragma unroll
      for (int e = 0; e < 4; ++e) c[i][m][e] = 0.f;
    }
  }
}

// bf16 on the tensor cores. A normed input (Q/K/V, gate|up: several groups,
// one chunk each) is normed once into shared memory and read into
// fragments that serve every group. A plain input (o-proj, down: one group)
// is read from L2 straight into fragments, a chunk at a time (half a chunk
// for B > 16), over two mma chains.
template <int MT, class P, typename S, bool NORM, class Epilogue>
__device__ void project_mma(const Params<__nv_bfloat16>& p,
                            const Act<__nv_bfloat16, S, NORM>& act, Ring& ring, float* red,
                            __nv_bfloat16* xs, Epilogue epilogue) {
  constexpr int NT = P::NT, PW = P::KS / kWarps;
  const int warp = threadIdx.x / 32, batch = p.batch;
  if constexpr (NORM) {
    static_assert(P::CHUNKS == 1, "a normed input is read once for all groups");
    stage_normed(act.src, act.w, batch, p.eps, xs);
    uint32_t f[PW][MT][4];
#pragma unroll
    for (int i = 0; i < PW; ++i) load_frag(xs, kXsStride, (warp * PW + i) * 16, batch, f[i]);
    for (int grp = 0; grp < P::GROUPS; ++grp) {
      float c[NT][MT][4];
      zero(c);
      const uint8_t* buf = ring.wait();
#pragma unroll
      for (int i = 0; i < PW; ++i) {
#pragma unroll
        for (int n = 0; n < NT; ++n) mma_tile<MT, NT>(buf, warp * PW + i, n, f[i], c[n]);
      }
      ring.release();
      store_mma_sums(c, red);
      finish_group<16 * MT, 8 * NT>(red, grp, epilogue);
    }
  } else {
    static_assert(P::GROUPS == 1 && NT == 1, "a plain input feeds one group of one tile");
    float c[2][MT][4];  // two chains: even and odd k-steps
    zero(c);
    auto k_of = [&](int chunk, int i) { return (chunk * P::KS + warp * PW + i) * 16; };
    {
      constexpr int KB = MT == 1 ? PW : PW / 2;  // k-steps read at once
      for (int chunk = 0; chunk < P::CHUNKS; ++chunk) {
        const uint8_t* buf = nullptr;
#pragma unroll
        for (int i0 = 0; i0 < PW; i0 += KB) {
          uint32_t f[KB][MT][4];
#pragma unroll
          for (int i = 0; i < KB; ++i) load_frag(act.src, act.ld, k_of(chunk, i0 + i), batch, f[i]);
          if (i0 == 0) buf = ring.wait();
#pragma unroll
          for (int i = 0; i < KB; ++i) mma_tile<MT, NT>(buf, warp * PW + i0 + i, 0, f[i], c[i % 2]);
        }
        ring.release();
      }
    }
    float sum[1][MT][4];
#pragma unroll
    for (int m = 0; m < MT; ++m) {
#pragma unroll
      for (int e = 0; e < 4; ++e) sum[0][m][e] = c[0][m][e] + c[1][m][e];
    }
    store_mma_sums(sum, red);
    finish_group<16 * MT, 8>(red, 0, epilogue);
  }
}

// f32: exact FMAs on the CUDA cores, one group at a time. Lane 4 g + q
// takes column g at k = 2q, 2q+1, 2q+8, 2q+9 of each tile, for every row.
template <int MT, class P, typename S, bool NORM, class Epilogue>
__device__ void project_fma(const Params<float>& p, const Act<float, S, NORM>& act, bool from_x,
                            Ring& ring, float* red, float* rstd, Epilogue epilogue) {
  constexpr int BP = 16 * MT, NT = P::NT, COLS = 8 * NT, PW = P::KS / kWarps;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, q = lane % 4, batch = p.batch;
  if (NORM) row_rstd(p, from_x, rstd);
  auto fetch = [&](int b, int k) {
    const float2 v = load2(act.src + (size_t)b * act.ld + k);
    return NORM ? norm2<float>(v, rstd[b], load2(act.w + k)) : v;
  };
  for (int grp = 0; grp < P::GROUPS; ++grp) {
    float c[NT][BP];
#pragma unroll
    for (int n = 0; n < NT; ++n) {
#pragma unroll
      for (int b = 0; b < BP; ++b) c[n][b] = 0.f;
    }
    for (int chunk = 0; chunk < P::CHUNKS; ++chunk) {
      const uint8_t* buf = ring.wait();
#pragma unroll 1
      for (int i = 0; i < PW; ++i) {
        const int ks = warp * PW + i;
        const int k0 = (chunk * P::KS + ks) * 16 + 2 * q;
        float w[NT][4];
#pragma unroll
        for (int n = 0; n < NT; ++n) {
          const char4 v =
              *reinterpret_cast<const char4*>(buf + (ks * NT + n) * kTileBytes + lane * 4);
          w[n][0] = v.x;
          w[n][1] = v.y;
          w[n][2] = v.z;
          w[n][3] = v.w;
        }
#pragma unroll
        for (int b = 0; b < BP; ++b) {
          if (b < batch) {
            const float2 lo = fetch(b, k0), hi = fetch(b, k0 + 8);
#pragma unroll
            for (int n = 0; n < NT; ++n) {
              float s = c[n][b];
              s = fmaf(lo.x, w[n][0], s);
              s = fmaf(lo.y, w[n][1], s);
              s = fmaf(hi.x, w[n][2], s);
              s = fmaf(hi.y, w[n][3], s);
              c[n][b] = s;
            }
          }
        }
      }
      ring.release();
    }
    // The 4 lanes of a column add their k subsets; lane q writes rows q mod 4.
    float* my = red + warp * BP * COLS;
#pragma unroll
    for (int n = 0; n < NT; ++n) {
#pragma unroll
      for (int b = 0; b < BP; ++b) {
        float s = c[n][b];
        s += __shfl_xor_sync(0xffffffffu, s, 1);
        s += __shfl_xor_sync(0xffffffffu, s, 2);
        if (b % 4 == q) my[b * COLS + 8 * n + g] = s;
      }
    }
    finish_group<BP, COLS>(red, grp, epilogue);
  }
}

template <int MT, class P, typename T, typename S, bool NORM, class Epilogue>
__device__ __forceinline__ void project(const Params<T>& p, const Act<T, S, NORM>& act,
                                        bool from_x, Ring& ring, float* red, float* rstd,
                                        __nv_bfloat16* xs, Epilogue epilogue) {
  if constexpr (sizeof(T) == 2) {
    project_mma<MT, P>(p, act, ring, red, xs, epilogue);
  } else {
    project_fma<MT, P>(p, act, from_x, ring, red, rstd, epilogue);
  }
}

// ---- attention -------------------------------------------------------------

// Per-head RMSNorm (normed -> T, x weight -> T), then RoPE in f32, rounded
// to T. Lane l holds dims l + 32 e, so d and d +- 64 share a lane.
template <typename T>
__device__ __forceinline__ void head_norm_rope(float (&v)[4], const T* w, const float* cos,
                                               const float* sin, float eps) {
  const int lane = threadIdx.x % 32;
  float ss = 0.f;
#pragma unroll
  for (int e = 0; e < 4; ++e) ss += v[e] * v[e];
  const float r = 1.f / sqrtf(warp_sum(ss) / kHD + eps);
  float n[4];
#pragma unroll
  for (int e = 0; e < 4; ++e) n[e] = round_to<T>(round_to<T>(v[e] * r) * to_float(w[lane + 32 * e]));
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const int d = lane + 32 * e;
    const float rot = e < 2 ? -n[e + 2] : n[e - 2];
    v[e] = round_to<T>(n[e] * cos[d] + rot * sin[d]);
  }
}

// q . row over the head dim for a row of T in 16-byte pieces (loaded here
// from global or shared memory, or already in registers), in 4 partial sums.
template <typename T>
__device__ __forceinline__ void dot_piece(const float* q, uint4 raw, float (&acc)[4]) {
  const T* t = reinterpret_cast<const T*>(&raw);
#pragma unroll
  for (int e = 0; e < 16 / (int)sizeof(T); e += 4) {
    const float4 qv = *reinterpret_cast<const float4*>(q + e);
    acc[0] = fmaf(qv.x, to_float(t[e]), acc[0]);
    acc[1] = fmaf(qv.y, to_float(t[e + 1]), acc[1]);
    acc[2] = fmaf(qv.z, to_float(t[e + 2]), acc[2]);
    acc[3] = fmaf(qv.w, to_float(t[e + 3]), acc[3]);
  }
}

template <typename T>
__device__ __forceinline__ float row_dot(const float* q, const uint4* row) {
  constexpr int PER = 16 / sizeof(T);
  float acc[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
  for (int i = 0; i < kHD / PER; ++i) dot_piece<T>(q + i * PER, row[i], acc);
  return (acc[0] + acc[1]) + (acc[2] + acc[3]);
}




struct AttnSmem {
  float q[kHD];  // the warp's query
  float k[kHD];  // its KV head's key at pos
  float p[kMaxGroups];  // probabilities
};

// One warp per (row, query head), spread over the grid: QK-norm + RoPE of
// the query and of its KV head's key, the K/V row at pos (written by the
// first query head of each KV head), scores with one position per lane,
// softmax, then the probabilities times V with 4 adjacent dims per lane.
// The key rows of earlier positions do not depend on this launch: each
// lane loads its own first, beside the Q/K/V sums.
template <typename T>
__device__ void attention(const Params<T>& p, int l, AttnSmem* smem_all) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  AttnSmem& sm = smem_all[warp];
  const int pos = p.pos;
  for (int u = blockIdx.x + gridDim.x * warp; u < p.batch * kHeads; u += gridDim.x * kWarps) {
    const int b = u / kHeads, hq = u % kHeads, kvh = hq / kGrp;
    // Cache row of (l, b, position j, kvh), in elements.
    const size_t row0 = (((size_t)l * p.batch + b) * p.groups) * kKV + kvh;
    auto cache_row = [&](int j) { return (row0 + (size_t)j * kKV) * kHD; };
    // bf16: lane j < pos loads its key row now, beside this launch's Q/K/V.
    constexpr bool kEarly = sizeof(T) == 2;
    uint4 early[kEarly ? kHD * sizeof(T) / 16 : 1];
    if constexpr (kEarly) {
      if (lane < pos) {
        const uint4* src = reinterpret_cast<const uint4*>(p.k_cache + cache_row(lane));
#pragma unroll
        for (int i = 0; i < kHD * (int)sizeof(T) / 16; ++i) early[i] = src[i];
      }
    }
    const float* row = p.qkv + (size_t)b * kNQKV;
    float qv[4], kv[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int d = lane + 32 * e;
      qv[e] = row[hq * kHD + d];
      kv[e] = row[kNQ + kvh * kHD + d];
    }
    const float4 v4 = load4(row + kNQ + kNKV + kvh * kHD + 4 * lane);
    const float vr[4] = {round_to<T>(v4.x), round_to<T>(v4.y), round_to<T>(v4.z),
                         round_to<T>(v4.w)};
    head_norm_rope<T>(qv, p.q_norm + l * kHD, p.cos, p.sin, p.eps);
    head_norm_rope<T>(kv, p.k_norm + l * kHD, p.cos, p.sin, p.eps);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int d = lane + 32 * e;
      sm.q[d] = qv[e];
      sm.k[d] = kv[e];
      if (hq % kGrp == 0) {
        p.k_cache[cache_row(pos) + d] = from_float<T>(kv[e]);
        p.v_cache[cache_row(pos) + 4 * lane + e] = from_float<T>(vr[e]);
      }
    }
    __syncwarp();

    if constexpr (kEarly) {  // lane pos takes this launch's key, packed as a cache row
      if (lane == pos) {
#pragma unroll
        for (int i = 0; i < kHD / 8; ++i) {
          const float4 a = *reinterpret_cast<const float4*>(sm.k + 8 * i);
          const float4 c = *reinterpret_cast<const float4*>(sm.k + 8 * i + 4);
          early[i] = make_uint4(pack_bf16(a.x, a.y), pack_bf16(a.z, a.w), pack_bf16(c.x, c.y),
                                pack_bf16(c.z, c.w));
        }
      }
    }
    auto score = [&](int j) {
      if constexpr (kEarly) {
        if (j == lane) return row_dot<T>(sm.q, early) * kScale;
      }
      if (j == pos) return row_dot<float>(sm.q, reinterpret_cast<const uint4*>(sm.k)) * kScale;
      return row_dot<T>(sm.q, reinterpret_cast<const uint4*>(p.k_cache + cache_row(j))) * kScale;
    };
    const float s0 = lane <= pos ? score(lane) : -INFINITY;
    const float s1 = lane + 32 <= pos ? score(lane + 32) : -INFINITY;
    const float m = warp_max(fmaxf(s0, s1));
    const float e0 = lane <= pos ? expf(s0 - m) : 0.f;
    const float e1 = lane + 32 <= pos ? expf(s1 - m) : 0.f;
    const float sum = warp_sum(e0 + e1);
    if (lane <= pos) sm.p[lane] = round_to<T>(e0 / sum);
    if (lane + 32 <= pos) sm.p[lane + 32] = round_to<T>(e1 / sum);
    __syncwarp();

    float o[4] = {0.f, 0.f, 0.f, 0.f};
    auto add_row = [&](float pj, float4 v) {
      o[0] = fmaf(pj, v.x, o[0]);
      o[1] = fmaf(pj, v.y, o[1]);
      o[2] = fmaf(pj, v.z, o[2]);
      o[3] = fmaf(pj, v.w, o[3]);
    };
#pragma unroll 8
    for (int j = 0; j < pos; ++j) add_row(sm.p[j], load4(p.v_cache + cache_row(j) + 4 * lane));
    add_row(sm.p[pos], make_float4(vr[0], vr[1], vr[2], vr[3]));
    T* out = p.attn + (size_t)b * kNQ + hq * kHD + 4 * lane;
#pragma unroll
    for (int e = 0; e < 4; ++e) out[e] = from_float<T>(o[e]);
    __syncwarp();  // sm is rewritten by the warp's next unit
  }
}

// ---- the kernel ------------------------------------------------------------

constexpr size_t kRingBytes = (size_t)kStages * kStageBytes;
constexpr size_t kRedBytes = (size_t)kWarps * kMaxBatch * 16 * sizeof(float);
constexpr size_t kWorkBytes =
    kRedBytes > kWarps * sizeof(AttnSmem) ? kRedBytes : kWarps * sizeof(AttnSmem);
constexpr size_t kXsBytes = (size_t)kMaxBatch * kXsStride * sizeof(__nv_bfloat16);
constexpr size_t kSmemBytes = kRingBytes + 2 * kStages * sizeof(uint64_t) +
                              (kMaxBatch + kLayers * kScPerLayer + kMaxBatch * 8) * sizeof(float) +
                              kWorkBytes + kXsBytes;

template <typename T, int MT>
__global__ void __launch_bounds__(kThreads, 1) subtalker_step_kernel(const Params<T> p) {
  extern __shared__ __align__(128) uint8_t smem[];
  uint8_t* ring_base = smem;
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + kRingBytes);
  uint64_t* empty = full + kStages;
  float* rstd = reinterpret_cast<float*>(empty + kStages);  // [B]
  float* sc = rstd + kMaxBatch;                 // [L][kScPerLayer] the block's scales
  float* hown = sc + kLayers * kScPerLayer;     // [B][8] the block's residual columns
  float* work = hown + kMaxBatch * 8;           // the group sums, or the attention's vectors
  // bf16: the normed input of Q/K/V and gate|up [B][kXsStride]
  __nv_bfloat16* xs = reinterpret_cast<__nv_bfloat16*>(work + kWorkBytes / sizeof(float));
  const int warp = threadIdx.x / 32;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == kWarps) {  // the producer
    if (threadIdx.x % 32 == 0) produce(p, ring_base, full, empty);
    return;
  }

  Ring ring{ring_base, full, empty, 0, 0, p.timeline != nullptr, 0};
  const int blk = blockIdx.x, tid = threadIdx.x, batch = p.batch;
  unsigned long long* tl =
      p.timeline && tid == 0 ? p.timeline + blk * kTimelineSlots : nullptr;
  int event = kTlPhases;
  auto mark = [&]() {
    if (tl) tl[event] = clock64();
    ++event;
  };
  if (tl) {
    tl[kTlStart] = clock64();
    tl[kTlNsStart] = global_ns();
  }
  unsigned long long target = tid == 0 ? barrier_base(p.barrier, kBarriers) : 0;
  for (int i = tid; i < kLayers * kScPerLayer; i += kConsumers) {
    const int l = i / kScPerLayer, j = i % kScPerLayer;
    sc[i] = j < kScO ? p.qkv_s[l * kNQKV + blk * 32 + j]
            : j < kScGU ? p.wo_s[l * kD + blk * 8 + j - kScO]
            : j < kScDown ? p.gu_s[l * kNGU + blk * 48 + j - kScGU]
                          : p.down_s[l * kD + blk * 8 + j - kScDown];
  }
  consumer_sync();

  for (int l = 0; l < kLayers; ++l) {
    const bool first = l == 0, last = l == kLayers - 1;
    const float* s = sc + l * kScPerLayer;
    // 1. input RMSNorm, Q/K/V -> qkv (scaled).
    auto qkv_out = [&](int grp, auto sum) {
      for (int idx = tid; idx < batch * 16; idx += kConsumers) {
        const int b = idx / 16, c = idx % 16;
        p.qkv[(size_t)b * kNQKV + blk * 32 + grp * 16 + c] = sum(b, c) * s[kScQKV + grp * 16 + c];
      }
    };
    if (first) {
      project<MT, QKV>(p, Act<T, T, true>{p.x, p.in_norm, kD}, true, ring, work, rstd, xs,
                       qkv_out);
    } else {
      project<MT, QKV>(p, Act<T, float, true>{p.h32, p.in_norm + l * kD, kD}, false, ring, work,
                       rstd, xs, qkv_out);
    }
    mark();
    grid_barrier(p.barrier, target);
    mark();
    // 2. QK-norm + RoPE, the K/V row, attention -> attn.
    attention(p, l, reinterpret_cast<AttnSmem*>(work));
    mark();
    grid_barrier(p.barrier, target);
    mark();
    // 3. o-proj + residual -> h32 (and the block's columns in hown).
    project<MT, OProj>(p, Act<T, T, false>{p.attn, nullptr, kNQ}, false, ring, work, rstd, xs,
                       [&](int, auto sum) {
      for (int idx = tid; idx < batch * 8; idx += kConsumers) {
        const int b = idx / 8, c = idx % 8, i = b * kD + blk * 8 + c;
        const float h = (first ? to_float(p.x[i]) : hown[idx]) + sum(b, c) * s[kScO + c];
        hown[idx] = h;
        p.h32[i] = h;
      }
    });
    mark();
    grid_barrier(p.barrier, target);
    mark();
    // 4. post-attention RMSNorm, gate|up, SwiGLU -> act.
    project<MT, GateUp>(p, Act<T, float, true>{p.h32, p.post_norm + l * kD, kD}, false, ring,
                        work, rstd, xs, [&](int grp, auto sum) {
      for (int idx = tid; idx < batch * 8; idx += kConsumers) {
        const int b = idx / 8, c = idx % 8;
        const float gate = sum(b, c) * s[kScGU + grp * 16 + c];
        const float up = sum(b, 8 + c) * s[kScGU + grp * 16 + 8 + c];
        p.act[(size_t)b * kI + blk * 24 + grp * 8 + c] =
            from_float<T>(gate / (1.f + expf(-gate)) * up);
      }
    });
    mark();
    grid_barrier(p.barrier, target);
    mark();
    // 5. down + residual -> h32; the output after the last layer.
    project<MT, Down>(p, Act<T, T, false>{p.act, nullptr, kI}, false, ring, work, rstd, xs,
                      [&](int, auto sum) {
      for (int idx = tid; idx < batch * 8; idx += kConsumers) {
        const int b = idx / 8, c = idx % 8, i = b * kD + blk * 8 + c;
        const float h = hown[idx] + sum(b, c) * s[kScDown + c];
        hown[idx] = h;
        p.h32[i] = h;
        if (last) p.out[i] = from_float<T>(h);
      }
    });
    mark();
    if (!last) {
      grid_barrier(p.barrier, target);
      mark();
    }
  }
  if (tl) {
    tl[kTlWaitWeights] = ring.waited;
    tl[kTlEnd] = clock64();
    tl[kTlNsEnd] = global_ns();
  }
}

// Barrier cost alone: `n` grid barriers among the consumer threads of the
// step kernel's grid (the producer warp leaves at once, as in the step).
__global__ void __launch_bounds__(kThreads, 1) subtalker_barrier_bench_kernel(
    unsigned long long* count, int n) {
  if (threadIdx.x / 32 == kWarps || n == 0) return;
  unsigned long long target = threadIdx.x == 0 ? barrier_base(count, n) : 0;
  for (int i = 0; i < n; ++i) grid_barrier(count, target);
}

// ---- host side -------------------------------------------------------------

int sm_count() {
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess) {
      return 0;
    }
  }
  return sms;
}

// One block per SM, all resident: the cooperative launch checks it. Set up
// once per instantiation.
template <typename T, int MT>
cudaError_t prepare() {
  static cudaError_t state = cudaErrorNotReady;
  if (state == cudaErrorNotReady) {
    auto kernel = subtalker_step_kernel<T, MT>;
    state = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 (int)kSmemBytes);
    int per_sm = 0;
    if (state == cudaSuccess) {
      state = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, kSmemBytes);
    }
    if (state == cudaSuccess && (per_sm < 1 || sm_count() < kBlocks)) {
      state = cudaErrorCooperativeLaunchTooLarge;
    }
  }
  return state;
}

template <typename T, int MT>
cudaError_t launch(const Params<T>& p, cudaStream_t stream) {
  cudaError_t e = prepare<T, MT>();
  if (e != cudaSuccess) return e;
  void* args[] = {const_cast<Params<T>*>(&p)};
  e = cudaLaunchCooperativeKernel(reinterpret_cast<void*>(subtalker_step_kernel<T, MT>),
                                  dim3(kBlocks), dim3(kThreads), args, kSmemBytes, stream);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

size_t scratch_bytes(int batch) {
  return kBarrierBytes + (size_t)batch * ((kD + kNQKV) * sizeof(float) + (kNQ + kI) * sizeof(float));
}

template <typename T>
int run(const void* const* ptrs, int batch, int groups, int pos, float eps, void* scratch,
        cudaStream_t stream) {
  Params<T> p;
  p.x = static_cast<const T*>(ptrs[0]);
  p.cos = static_cast<const float*>(ptrs[1]);
  p.sin = static_cast<const float*>(ptrs[2]);
  p.wqkv = static_cast<const int8_t*>(ptrs[3]);
  p.qkv_s = static_cast<const float*>(ptrs[4]);
  p.wo = static_cast<const int8_t*>(ptrs[5]);
  p.wo_s = static_cast<const float*>(ptrs[6]);
  p.wgu = static_cast<const int8_t*>(ptrs[7]);
  p.gu_s = static_cast<const float*>(ptrs[8]);
  p.wdown = static_cast<const int8_t*>(ptrs[9]);
  p.down_s = static_cast<const float*>(ptrs[10]);
  p.in_norm = static_cast<const T*>(ptrs[11]);
  p.post_norm = static_cast<const T*>(ptrs[12]);
  p.q_norm = static_cast<const T*>(ptrs[13]);
  p.k_norm = static_cast<const T*>(ptrs[14]);
  p.k_cache = static_cast<T*>(const_cast<void*>(ptrs[15]));
  p.v_cache = static_cast<T*>(const_cast<void*>(ptrs[16]));
  p.out = static_cast<T*>(const_cast<void*>(ptrs[17]));
  p.timeline = static_cast<unsigned long long*>(const_cast<void*>(ptrs[18]));
  uint8_t* s = static_cast<uint8_t*>(scratch);
  p.barrier = reinterpret_cast<unsigned long long*>(s);
  p.h32 = reinterpret_cast<float*>(s + kBarrierBytes);
  p.qkv = p.h32 + (size_t)batch * kD;
  p.attn = reinterpret_cast<T*>(p.qkv + (size_t)batch * kNQKV);
  p.act = p.attn + (size_t)batch * kNQ;
  p.batch = batch;
  p.groups = groups;
  p.pos = pos;
  p.eps = eps;
  const cudaError_t e = batch <= 16 ? launch<T, 1>(p, stream) : launch<T, 2>(p, stream);
  return (int)e;
}

}  // namespace

// Bytes of scratch for `batch` rows; the first kBarrierBytes must be zero
// before the first launch.
extern "C" long long qtts_subtalker_step_scratch_bytes(int batch) {
  return (long long)scratch_bytes(batch);
}

// The launch shape: grid blocks, threads, dynamic shared bytes.
extern "C" int qtts_subtalker_step_launch_shape(int dtype, int batch, int* grid, int* threads,
                                                int* smem) {
  cudaError_t e = cudaErrorInvalidValue;
  if (dtype == 0) e = batch <= 16 ? prepare<float, 1>() : prepare<float, 2>();
  if (dtype == 1) e = batch <= 16 ? prepare<__nv_bfloat16, 1>() : prepare<__nv_bfloat16, 2>();
  *grid = kBlocks;
  *threads = kThreads;
  *smem = (int)kSmemBytes;
  return (int)e;
}

// `n` grid barriers in one cooperative launch of the step's grid; `scratch`
// is a step scratch whose bench count (8 bytes at byte 64) the caller has
// zeroed. Returns a cudaError_t code.
extern "C" int qtts_subtalker_barrier_bench(int n, void* scratch, void* stream) {
  void* count = static_cast<uint8_t*>(scratch) + kBenchCountByte;
  void* args[] = {&count, &n};
  cudaError_t e = cudaLaunchCooperativeKernel(
      reinterpret_cast<void*>(subtalker_barrier_bench_kernel), dim3(kBlocks), dim3(kThreads), args,
      0, static_cast<cudaStream_t>(stream));
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

// dtype: 0 = float32, 1 = bfloat16 (x, out, the norms and the caches).
// `timeline`: nullptr, or [128][64] u64 for a timed launch (see
// kTimelineSlots). Returns a cudaError_t code (0 = success).
extern "C" int qtts_subtalker_step(
    const void* x, const void* cos, const void* sin, const void* wqkv, const void* qkv_s,
    const void* wo, const void* wo_s, const void* wgu, const void* gu_s, const void* wdown,
    const void* down_s, const void* in_norm, const void* post_norm, const void* q_norm,
    const void* k_norm, void* k_cache, void* v_cache, void* out, void* scratch, void* timeline,
    int dtype, int batch, int groups, int pos, float eps, void* stream) {
  if (batch < 1 || batch > kMaxBatch || groups < 1 || groups > kMaxGroups || pos < 0 ||
      pos >= groups) {
    return (int)cudaErrorInvalidValue;
  }
  const void* ptrs[] = {x, cos, sin, wqkv, qkv_s, wo, wo_s, wgu, gu_s, wdown, down_s,
                        in_norm, post_norm, q_norm, k_norm, k_cache, v_cache, out, timeline};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return run<float>(ptrs, batch, groups, pos, eps, scratch, s);
    case 1: return run<__nv_bfloat16>(ptrs, batch, groups, pos, eps, scratch, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
