// x @ W for int8 weights with per-column scales, for Hopper (sm_90a): one
// launch computes every weight of a group that reads the same x.
//
// Not the port of a TPU kernel: the JAX package leaves this product to XLA,
// which fuses the int8 -> activation-dtype convert into the dot, so that
// "only int8 bytes stream from HBM" (qwen_tts_tpu/models/trunk.py,
// `_w_matmul`). Eager PyTorch cannot fuse the convert: casting the weight
// whole and handing it to cuBLAS writes and reads back twice the int8 bytes
// on every call. This kernel reads each int8 weight once and widens it in
// registers. It serves every int8 projection of the talker trunk (prefill,
// M = B * S, and decode, M = B) and the sub-talker's int8 LM heads.
//
//   y_e = round_x(x @ w_e) * s_e           in x's dtype (`_w_matmul`), or
//   y_e = float(round_x(x @ w_e)) * s_e    in f32 (the LM heads' logits)
//
// for x [M, K] f32 or bf16 and a group of up to 4 weights w_e [K, N_e] int8
// (quantize_int8's layout: per output column, N_e % 16 == 0) with scales s_e
// [N_e] bf16: q|k|v read one x, gate|up another. Each int8 weight widens
// exactly (|w| <= 127 is a bf16 and an f32 value); the products sum in f32
// in one order that depends on K alone, never on N, the group or M: a row's
// bits do not depend on the rows beside it, and a weight's outputs in a
// group are the bits of its single launch.
//
// Bound: bytes. A decode step's projection does 2 * M flops per weight byte
// (M = 4 on the serving path), far below the card's ridge, so the least time
// is the int8 weights' bytes (plus x and y) over 3.35 TB/s: 0.31 us for a
// 1024 x 1024 projection, 52 us for the 20 talker layers of a step.
//
// At M = 4 a launch is latency, not bytes. The earlier design (commit
// a9115f3) widened its weight slice into shared memory in a loop with a
// runtime trip count (DRAM round trips one after another: 2.4 of a block's
// 5.9 us at 1024 x 1024 on an H100 80GB HBM3 at 700 W,
// experiments/int8_matmul_redesign.py timeline), then staged x, then met
// its peers at two cluster barriers; and every projection was a launch of
// its own.
// This design groups the projections that read one x into one launch, puts
// every weight byte of a block in flight at once and meets its peers once:
//   * bf16 activations (the serving path): the tensor cores, mma.sync
//     m16n8k16 with B taken straight from the loaded int8 bytes. A block of
//     4 warps owns 64 output columns of one weight of the group (grid y
//     walks the group's column tiles) and one cluster rank's share of K
//     (grid x = rank); warp w takes kSteps steps of 16 rows of it. Lane
//     (g, t) of a warp loads 8 B (columns 8g..8g+7) from each of rows
//     4t..4t+3 of every step: all of its loads, a compile-time count, go out
//     before the first is used. For each of its 8 columns the lane then
//     holds the 4 values of one B fragment: the step's mma positions 2t,
//     2t+1, 2t+8, 2t+9 are rows 4t..4t+3, and the lane's A fragment takes
//     x's values at the same rows (one 8 B load per row of x). So n-tile j
//     of a step computes the columns 8g + j, with no shared memory between
//     the load and the mma. Rows of x pad to 16 (or 32, two m16 tiles, above
//     M = 16) with zeros; rows never mix in an mma, so the zero rows change
//     no row's bits. A 1024 x 1024 projection spreads over 16 column tiles x
//     8 ranks = 128 blocks of 8 KB each.
//   * f32 activations (the f32 parity runs): the CUDA cores, f32 products.
//     A block of 128 threads owns 64 output columns; lane c of a group of 4
//     reads 16 B of int8 (16 columns) per weight row, so 4 lanes read 64
//     contiguous bytes of a row. The block's 32 groups split its K range:
//     group g takes kRows consecutive rows. A thread issues all its weight
//     loads before it uses any and keeps them packed in registers; the
//     block stages its rows of x in shared memory; then each thread walks
//     the rows, 16 f32 sums per row, reduced over the warp's 8 groups by a
//     shuffle tree that halves the columns each lane holds at each level.
//   * Both: the block's 4 warps sum in warp order in shared memory; the
//     ranks of a thread block cluster (up to 8, K split further) then meet
//     once: each rank pushes its sums, 16 B at a time, into the shared
//     memory of the rank that owns them with st.async, which counts the
//     bytes on the owner's mbarrier; each owner waits for its own bytes
//     only, adds the ranks in rank order and stores 4 columns at a time. No
//     atomics, no workspace; the order depends on K alone. A relaxed cluster
//     arrive at the start, whose wait comes just before the first push,
//     proves every peer's barrier is initialised. The scales are loaded at
//     the start, beside the weights.
//   * A timed launch (`timeline`) records each block's global-timer stamps:
//     start, weights landed, x landed, products done, exchange done, stored.
//   * Programmatic dependent launch (the weights requested before
//     griddepcontrol.wait) was measured and left out: the replayed serving
//     decode did not get faster (experiments/int8_matmul_redesign.py pdl).
//
// The launch goes on the caller's stream, allocates nothing and returns its
// cudaError_t; the Python wrapper (ops/cuda/int8_matmul.py) raises on a
// non-zero code.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kCols = 64;                            // output columns per block
constexpr int kMaxSplit = 8;                         // the largest portable cluster
constexpr int kMaxGroup = 4;                         // weights of one launch
// The f32 kernel.
constexpr int kLanesPerRow = 4;                      // 16 columns (16 B of int8) each
constexpr int kGroups = kThreads / kLanesPerRow;     // K groups per block
constexpr int kRowsPerBlock = 8;                     // rows of x per block
constexpr int kMaxRows = 16;                         // weight rows per thread
// The tensor-core kernel.
constexpr int kStep = 16;                            // K rows of one mma step
constexpr int kMaxSteps = 8;                         // mma steps per warp
constexpr int kMmaRowStride = kCols + 8;             // floats a row of its sums

// A timed launch: per block, global-timer stamps (ns).
constexpr int kTimelineSlots = 6;
enum { kTlStart, kTlWeights, kTlX, kTlProducts, kTlExchange, kTlStored };

struct Params {
  const void* x;                   // [M, K] T
  int m, k, out_f32, count;
  const int8_t* w[kMaxGroup];      // [K, N_e]
  const __nv_bfloat16* s[kMaxGroup];  // [N_e]
  void* out[kMaxGroup];            // [M, N_e] T, or f32
  int n[kMaxGroup];
  int tile0[kMaxGroup + 1];        // the first column tile (grid y) of each weight
  unsigned long long* timeline;    // [blocks][kTimelineSlots] when timed, or nullptr
};

// The weight of the group that grid row blockIdx.y belongs to, and its
// first output column there.
struct Tile {
  const int8_t* w;
  const __nv_bfloat16* s;
  void* out;
  int n, n0;
};

__device__ __forceinline__ Tile tile_of(const Params& p) {
  const int y = blockIdx.y;
  Tile t{p.w[0], p.s[0], p.out[0], p.n[0], y * kCols};
#pragma unroll
  for (int e = 1; e < kMaxGroup; ++e) {
    if (e < p.count && y >= p.tile0[e]) {
      t = {p.w[e], p.s[e], p.out[e], p.n[e], (y - p.tile0[e]) * kCols};
    }
  }
  return t;
}

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float round_to(float v, float) { return v; }
__device__ __forceinline__ float round_to(float v, __nv_bfloat16) {
  return __bfloat162float(__float2bfloat16(v));
}

// Byte k of a word of int8 values as a float, exactly: bias by 0x80, place
// the byte in the mantissa of 2^23 and subtract 2^23 + 128.
__device__ __forceinline__ float int8_at(uint32_t word, int k) {
  return __uint_as_float(__byte_perm(word ^ 0x80808080u, 0x4B000000u, 0x7540 + k)) - 8388736.f;
}

// Two floats that are bf16 values already (low 16 bits zero: small
// integers) as a bf16 pair, lo in the low half.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  return __byte_perm(__float_as_uint(lo), __float_as_uint(hi), 0x7632);
}

// 8 B of int8 weights, read once: not kept in L1.
__device__ __forceinline__ uint2 load_weight8(const int8_t* p) {
  uint2 v;
  asm volatile("ld.global.nc.L1::no_allocate.v2.u32 {%0,%1}, [%2];\n"
               : "=r"(v.x), "=r"(v.y)
               : "l"(p));
  return v;
}

__device__ __forceinline__ uint64_t global_ns() {
  uint64_t t;
  asm volatile("mov.u64 %0, %%globaltimer;\n" : "=l"(t)::"memory");
  return t;
}

// The cluster barrier in halves: arrive (relaxed), then wait (acquire).
__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)), "r"(count)
               : "memory");
}

// The barrier's initialisation, visible to the cluster's other blocks.
__device__ __forceinline__ void fence_mbarrier_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// One arrival on `bar`, which now also waits for `bytes` more.
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
        "mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  }
}

// v into rank `rank`'s copy of `slot` (this block's address of it), its 16
// bytes counted on that rank's copy of `bar`: a one-way store into a peer's
// shared memory that completes on the peer's barrier.
__device__ __forceinline__ void push_async(float* slot, uint64_t* bar, int rank, float4 v) {
  uint32_t remote_slot, remote_bar;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(remote_slot)
               : "r"(smem_addr(slot)), "r"(rank));
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(remote_bar)
               : "r"(smem_addr(bar)), "r"(rank));
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.v4.f32 [%0], {%1, %2, %3, %4}, "
      "[%5];\n" ::"r"(remote_slot),
      "f"(v.x), "f"(v.y), "f"(v.z), "f"(v.w), "r"(remote_bar)
      : "memory");
}

// d += a * b on the tensor cores: m16n8k16, bf16 inputs, f32 sums.
__device__ __forceinline__ void mma_bf16(float* d, const uint32_t* a, const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// Thread 0's slot row of a timed launch, or nullptr.
__device__ __forceinline__ unsigned long long* timeline_row(const Params& p) {
  if (!p.timeline || threadIdx.x != 0) return nullptr;
  const size_t block = ((size_t)blockIdx.z * gridDim.y + blockIdx.y) * gridDim.x + blockIdx.x;
  return p.timeline + block * kTimelineSlots;
}

// Row r, columns c..c+3 of the block's tile, summed: rounded to x's dtype,
// scaled (scl: the block's 64 scales, staged) and stored as one vector.
template <typename T>
__device__ __forceinline__ void store4(const Params& p, const Tile& t, const float* scl, int m0,
                                       int r, int c, float4 v) {
  const int n = t.n0 + c;
  if (n >= t.n) return;  // N % 16 == 0: a quad is all in or all out
  const float4 s = *reinterpret_cast<const float4*>(scl + c);
  const float4 y = make_float4(round_to(v.x, T()) * s.x, round_to(v.y, T()) * s.y,
                               round_to(v.z, T()) * s.z, round_to(v.w, T()) * s.w);
  const size_t at = (size_t)(m0 + r) * t.n + n;
  if (p.out_f32 || sizeof(T) == 4) {
    *reinterpret_cast<float4*>(static_cast<float*>(t.out) + at) = y;
  } else {
    const uint2 packed = make_uint2(pack_bf16(round_to(y.x, T()), round_to(y.y, T())),
                                    pack_bf16(round_to(y.z, T()), round_to(y.w, T())));
    *reinterpret_cast<uint2*>(static_cast<__nv_bfloat16*>(t.out) + at) = packed;
  }
}

// What the block's sums and the cluster's exchange use in shared memory:
// part [kWarps][rows][row_stride] (slot p of a row holds column p, or in
// the tensor-core kernel's n-tile order column 8 (p % 8) + p / 8), recv
// [n_split][share] float4 (peers push into it), the staged scales scl
// [kCols] and the exchange's barrier.
struct Sums {
  float* part;
  int warp_stride, row_stride;
  float4* recv;
  float* scl;
  uint64_t* bar;
};

// Quads of 4 outputs a rank owns: quads / n_split, rounded up.
__device__ __forceinline__ int owned_quads(int rows, int rank, int* share) {
  const int quads = rows * kCols / 4;
  *share = (quads + gridDim.x - 1) / gridDim.x;
  return max(0, min(*share, quads - rank * *share));
}

// At a clustered block's start (thread 0): the exchange's barrier waits for
// one arrival, made here, and the bytes the peers will push.
__device__ __forceinline__ void start_exchange(const Sums& sm, int rows) {
  if (threadIdx.x == 0) {
    int share;
    const int own = owned_quads(rows, blockIdx.x, &share);
    mbar_init(sm.bar, 1);
    fence_mbarrier_init();
    mbar_expect_tx(sm.bar, (gridDim.x - 1) * own * 16);
  }
  cluster_arrive_relaxed();  // its wait, in finish, proves every peer's barrier exists
}

// The block's sums and the cluster's, by quads: quad d is row d / 16,
// columns 4 (d % 16)..+3. The warps' sums over their shares of K add in
// warp order. Alone (one rank) the block stores them; in a cluster, quad d
// belongs to rank d / share: every rank pushes its sums into slot
// [rank][d % share] of the owner's recv (st.async, counted on the owner's
// barrier), and each owner, once its barrier has seen every byte, adds the
// ranks in rank order. No block waits for more than the bytes it owns.
template <typename T, bool kPermuted>
__device__ __forceinline__ void finish(const Params& p, const Tile& t, const Sums& sm, int rows,
                                       int m0, unsigned long long* tl) {
  auto add = [](float4& a, const float4& b) {
    a.x += b.x;
    a.y += b.y;
    a.z += b.z;
    a.w += b.w;
  };
  auto block_sum = [&](int d) {
    const float* row = sm.part + (d / (kCols / 4)) * sm.row_stride;
    const int c = 4 * (d % (kCols / 4));
    if constexpr (kPermuted) {  // column c sits in slot 8 (c % 8) + c / 8
      float v[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const float* at = row + 8 * ((c + k) % 8) + (c + k) / 8;
        v[k] = at[0];
#pragma unroll
        for (int w = 1; w < kWarps; ++w) v[k] += at[w * sm.warp_stride];
      }
      return make_float4(v[0], v[1], v[2], v[3]);
    } else {
      float4 s = *reinterpret_cast<const float4*>(row + c);
#pragma unroll
      for (int w = 1; w < kWarps; ++w) {
        add(s, *reinterpret_cast<const float4*>(row + c + w * sm.warp_stride));
      }
      return s;
    }
  };
  auto store = [&](int d, const float4& v) {
    store4<T>(p, t, sm.scl, m0, d / (kCols / 4), 4 * (d % (kCols / 4)), v);
  };
  const int rank = blockIdx.x;
  const int n_split = gridDim.x;
  const int quads = rows * kCols / 4;
  if (n_split == 1) {
    if (tl) tl[kTlExchange] = global_ns();
    for (int d = threadIdx.x; d < quads; d += kThreads) store(d, block_sum(d));
    return;
  }
  int share;
  const int own = owned_quads(rows, rank, &share);
  cluster_wait();  // the start's arrive: every peer's barrier is initialised
  for (int d = threadIdx.x; d < quads; d += kThreads) {
    const float4 v = block_sum(d);
    const int q = d / share;
    float4* slot = sm.recv + rank * share + d - q * share;
    if (q == rank) {
      *slot = v;
    } else {
      push_async(reinterpret_cast<float*>(slot), sm.bar, q, v);
    }
  }
  __syncthreads();  // the block's own quads in recv
  mbar_wait(sm.bar, 0);
  if (tl) tl[kTlExchange] = global_ns();
  for (int i = threadIdx.x; i < own; i += kThreads) {
    float4 v[kMaxSplit];  // every rank's sums loaded at once, then added in order
#pragma unroll
    for (int q = 0; q < kMaxSplit; ++q) {
      if (q < n_split) v[q] = sm.recv[q * share + i];
    }
#pragma unroll
    for (int q = 1; q < kMaxSplit; ++q) {
      if (q < n_split) add(v[0], v[q]);
    }
    store(rank * share + i, v[0]);
  }
}

// The scale of column threadIdx.x of the block's tile (threads < kCols),
// loaded at the start and staged before the sums are stored.
__device__ __forceinline__ float scale_of(const Tile& t) {
  const int n = t.n0 + threadIdx.x;
  return threadIdx.x < kCols && n < t.n ? __bfloat162float(t.s[n]) : 0.f;
}

// The shared memory of a block: its staged x (f32 kernel), part, recv, scl
// and the barrier, in that order.
__host__ __device__ constexpr int sums_floats(int rows, int row_stride) {
  return kWarps * rows * row_stride + rows * kCols + 4 * kMaxSplit + kCols;
}

__device__ __forceinline__ Sums sums_at(unsigned char* base, int rows, int row_stride) {
  Sums sm;
  sm.part = reinterpret_cast<float*>(base);
  sm.warp_stride = rows * row_stride;
  sm.row_stride = row_stride;
  sm.recv = reinterpret_cast<float4*>(sm.part + kWarps * rows * row_stride);
  sm.scl = reinterpret_cast<float*>(sm.recv) + rows * kCols + 4 * kMaxSplit;
  sm.bar = reinterpret_cast<uint64_t*>(sm.scl + kCols);
  return sm;
}

// The f32 kernel. kRows: weight rows per thread (a power of two up to
// kMaxRows).
template <typename T, int kRows>
__global__ void __launch_bounds__(kThreads) int8_matmul_kernel(const Params p) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int kBlockK = kGroups * kRows;        // the block's share of K
  float* xs = reinterpret_cast<float*>(smem);     // [kRowsPerBlock][kBlockK]
  const Sums sm = sums_at(smem + kRowsPerBlock * kBlockK * 4, kRowsPerBlock, kCols);
  unsigned long long* tl = timeline_row(p);
  if (tl) tl[kTlStart] = global_ns();
  const int rank = blockIdx.x;
  const int m0 = blockIdx.z * kRowsPerBlock;
  const int rows = min(kRowsPerBlock, p.m - m0);
  if (gridDim.x > 1) start_exchange(sm, rows);
  const Tile t = tile_of(p);
  const float sc = scale_of(t);
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int lane_c = tid % kLanesPerRow;
  const int grp = tid / kLanesPerRow;
  const int col = t.n0 + lane_c * 16;
  const int kb0 = rank * kBlockK;
  const int k0 = kb0 + grp * kRows;
  const T* __restrict__ x = static_cast<const T*>(p.x);

  // Every weight load of the thread before any use (zeros past K or N),
  // then the block's rows of x into shared memory as f32 (zeros past K).
  uint4 wr[kRows];
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    wr[i] = make_uint4(0u, 0u, 0u, 0u);
    if (k0 + i < p.k && col < t.n) {
      wr[i] = *reinterpret_cast<const uint4*>(t.w + (size_t)(k0 + i) * t.n + col);
    }
  }
  for (int i = tid; i < rows * kBlockK; i += kThreads) {
    const int r = i / kBlockK;
    const int k = kb0 + i % kBlockK;
    xs[i] = k < p.k ? to_float(x[(size_t)(m0 + r) * p.k + k]) : 0.f;
  }
  __syncthreads();
  if (tl) tl[kTlWeights] = tl[kTlX] = global_ns();
  // Per row: the thread's rows in order; then the warp's 8 groups by a
  // fixed tree of shuffles that halves the columns a lane holds at each
  // level (16 -> 8 -> 4 -> 2), so each lane ends with 2 columns' sums.
  const int g8 = lane / kLanesPerRow;  // the lane's group within the warp
  for (int r = 0; r < rows; ++r) {
    float acc[16];
#pragma unroll
    for (int j = 0; j < 16; ++j) acc[j] = 0.f;
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const float xv = xs[r * kBlockK + grp * kRows + i];
      const uint32_t words[4] = {wr[i].x, wr[i].y, wr[i].z, wr[i].w};
#pragma unroll
      for (int j = 0; j < 16; ++j) acc[j] = fmaf(xv, int8_at(words[j / 4], j % 4), acc[j]);
    }
    // Level with half h: a lane whose group bit is set keeps the upper half
    // and sends the lower; its partner the reverse; each adds what it gets.
#pragma unroll
    for (int half = 8, bit = 4; half >= 2; half >>= 1, bit >>= 1) {
      const bool upper = g8 & bit;
#pragma unroll
      for (int j = 0; j < half; ++j) {
        const float send = upper ? acc[j] : acc[j + half];
        const float keep = upper ? acc[j + half] : acc[j];
        acc[j] = keep + __shfl_xor_sync(0xffffffffu, send, bit * kLanesPerRow);
      }
    }
    // The lane's two columns: 8 (bit 4) + 4 (bit 2) + 2 (bit 1) of its group.
    const int col2 = lane_c * 16 + ((g8 & 4) ? 8 : 0) + ((g8 & 2) ? 4 : 0) + ((g8 & 1) ? 2 : 0);
    *reinterpret_cast<float2*>(sm.part + (warp * kRowsPerBlock + r) * kCols + col2) =
        make_float2(acc[0], acc[1]);
  }
  if (threadIdx.x < kCols) sm.scl[threadIdx.x] = sc;
  __syncthreads();
  if (tl) tl[kTlProducts] = global_ns();
  finish<T, false>(p, t, sm, rows, m0, tl);
  if (tl) tl[kTlStored] = global_ns();
}

// The tensor-core kernel (bf16 activations). kSteps: 16-row mma steps per
// warp; kMTiles: m16 tiles of x per block.
template <int kSteps, int kMTiles>
__global__ void __launch_bounds__(kThreads) int8_matmul_kernel_mma(const Params p) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int kRows = 16 * kMTiles;
  const Sums sm = sums_at(smem, kRows, kMmaRowStride);
  unsigned long long* tl = timeline_row(p);
  if (tl) tl[kTlStart] = global_ns();
  const int m0 = blockIdx.z * kRows;
  const int rows = min(kRows, p.m - m0);
  if (gridDim.x > 1) start_exchange(sm, rows);
  const Tile t = tile_of(p);
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4;  // the lane's 8 columns, and its row of x
  const int q = lane % 4;  // its 4 rows of each step
  const int k_warp = (blockIdx.x * kWarps + warp) * kSteps * kStep;
  const int col = t.n0 + 8 * g;
  const bool col_ok = col < t.n;

  // All the lane's weight bytes in flight at once: 8 B from each of rows
  // 4q..4q+3 of every step (zeros past K or N).
  uint2 wr[kSteps][4];
#pragma unroll
  for (int s = 0; s < kSteps; ++s) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int kr = k_warp + s * kStep + 4 * q + i;
      wr[s][i] = kr < p.k && col_ok ? load_weight8(t.w + (size_t)kr * t.n + col)
                                    : make_uint2(0u, 0u);
    }
  }
  const float sc = scale_of(t);
  // x at the same rows: row g (h = 0) and g + 8 (h = 1) of each m16 tile,
  // 4 bf16 a step (zeros past M or K).
  const __nv_bfloat16* x = static_cast<const __nv_bfloat16*>(p.x);
  uint2 xr[kMTiles][2][kSteps];
#pragma unroll
  for (int mt = 0; mt < kMTiles; ++mt) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = m0 + 16 * mt + 8 * h + g;
#pragma unroll
      for (int s = 0; s < kSteps; ++s) {
        const int kx = k_warp + s * kStep + 4 * q;
        xr[mt][h][s] = row < p.m && kx < p.k
                           ? *reinterpret_cast<const uint2*>(x + (size_t)row * p.k + kx)
                           : make_uint2(0u, 0u);
      }
    }
  }
  if (tl) {
    // Thread 0 waits for its own loads, weights first: a value made of them
    // goes to shared memory (part[0], its own slot) before each stamp.
    volatile uint32_t* sink = reinterpret_cast<volatile uint32_t*>(sm.part);
    uint32_t seen = 0;
#pragma unroll
    for (int s = 0; s < kSteps; ++s) {
#pragma unroll
      for (int i = 0; i < 4; ++i) seen ^= wr[s][i].x ^ wr[s][i].y;
    }
    *sink = seen;
    __threadfence_block();
    tl[kTlWeights] = global_ns();
#pragma unroll
    for (int mt = 0; mt < kMTiles; ++mt) {
#pragma unroll
      for (int s = 0; s < kSteps; ++s) seen ^= xr[mt][0][s].x ^ xr[mt][1][s].y;
    }
    *sink = seen;
    __threadfence_block();
    tl[kTlX] = global_ns();
  }

  float acc[kMTiles][8][4];
#pragma unroll
  for (int mt = 0; mt < kMTiles; ++mt) {
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][j][e] = 0.f;
    }
  }
#pragma unroll
  for (int s = 0; s < kSteps; ++s) {
    // Column j of the lane's 8: its rows 4q..4q+3 are mma positions 2q,
    // 2q+1 (b[j][0]) and 2q+8, 2q+9 (b[j][1]).
    uint32_t b[8][2];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int byte = j % 4;
      const uint32_t w0 = j < 4 ? wr[s][0].x : wr[s][0].y;
      const uint32_t w1 = j < 4 ? wr[s][1].x : wr[s][1].y;
      const uint32_t w2 = j < 4 ? wr[s][2].x : wr[s][2].y;
      const uint32_t w3 = j < 4 ? wr[s][3].x : wr[s][3].y;
      b[j][0] = pack_bf16(int8_at(w0, byte), int8_at(w1, byte));
      b[j][1] = pack_bf16(int8_at(w2, byte), int8_at(w3, byte));
    }
#pragma unroll
    for (int mt = 0; mt < kMTiles; ++mt) {
      // A: rows g / g + 8 at positions 2q, 2q+1 (x's rows 4q, 4q+1) and
      // 2q+8, 2q+9 (4q+2, 4q+3).
      const uint32_t a[4] = {xr[mt][0][s].x, xr[mt][1][s].x, xr[mt][0][s].y, xr[mt][1][s].y};
#pragma unroll
      for (int j = 0; j < 8; ++j) mma_bf16(acc[mt][j], a, b[j]);
    }
  }
  // n-tile j's column n is the weight column 8n + j. Its pair of sums
  // (columns n = 2q, 2q + 1) goes to slots 8j + 2q, + 1 of the row (see
  // finish's column()); rows sit kMmaRowStride apart, so a half warp's
  // pairs fall in 32 distinct banks.
  float* mine = sm.part + warp * sm.warp_stride;
#pragma unroll
  for (int mt = 0; mt < kMTiles; ++mt) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = 16 * mt + 8 * h + g;
      if (r < rows) {
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          *reinterpret_cast<float2*>(mine + r * kMmaRowStride + 8 * j + 2 * q) =
              make_float2(acc[mt][j][2 * h], acc[mt][j][2 * h + 1]);
        }
      }
    }
  }
  if (threadIdx.x < kCols) sm.scl[threadIdx.x] = sc;
  __syncthreads();
  if (tl) tl[kTlProducts] = global_ns();
  finish<__nv_bfloat16, true>(p, t, sm, rows, m0, tl);
  if (tl) tl[kTlStored] = global_ns();
}

// The f32 kernel's split of K over a cluster and its rows per thread, from
// K alone: up to 8 ranks while each of a rank's 32 groups keeps at least 4
// rows, then the rows per group that cover K (a power of two). Returns false
// past what one thread holds.
bool choose_split(int k, int* n_split, int* rows) {
  int s = 1;
  while (s < kMaxSplit && s * 2 * kGroups * 4 <= k) s *= 2;
  int r = 1;
  while ((long long)r * s * kGroups < k) r *= 2;
  if (r > kMaxRows) return false;
  *n_split = s;
  *rows = r;
  return true;
}

// The tensor-core kernel's split, from K alone: ranks double up to 8 while
// the cluster's warps (one 16-row step each) do not cover K, then the steps
// per warp double. Returns false past kMaxSteps.
bool choose_mma_split(int k, int* n_split, int* steps) {
  const int chunks = (k + kStep - 1) / kStep;
  int c = 1, s = 1;
  while (c * kWarps * s < chunks) {
    if (c < kMaxSplit) {
      c *= 2;
    } else {
      s *= 2;
    }
  }
  if (s > kMaxSteps) return false;
  *n_split = c;
  *steps = s;
  return true;
}

// A launch's shape: the kernel's split and rows of x a block, the grid and
// the dynamic shared memory.
struct Plan {
  int n_split, per_thread, m_tiles;  // per_thread: rows (f32) or steps (bf16)
  dim3 grid;
  int smem;
};

bool plan_launch(int dtype, int count, const int* n, int m, int k, int* tile0, Plan* pl) {
  if (m <= 0 || k <= 0 || count < 1 || count > kMaxGroup) return false;
  int tiles = 0;
  for (int e = 0; e < count; ++e) {
    if (n[e] <= 0 || n[e] % 16 != 0) return false;
    tile0[e] = tiles;
    tiles += (n[e] + kCols - 1) / kCols;
  }
  for (int e = count; e <= kMaxGroup; ++e) tile0[e] = tiles;
  int rows_per_block;
  if (dtype == 0) {
    if (!choose_split(k, &pl->n_split, &pl->per_thread)) return false;
    pl->m_tiles = 0;
    rows_per_block = kRowsPerBlock;
    pl->smem = (kRowsPerBlock * kGroups * pl->per_thread + sums_floats(kRowsPerBlock, kCols)) * 4
               + 8;
  } else if (dtype == 1) {
    if (k % kStep != 0 || !choose_mma_split(k, &pl->n_split, &pl->per_thread)) return false;
    // Two m16 tiles a block above M = 16 (while the registers allow).
    pl->m_tiles = m > 16 && pl->per_thread <= 4 ? 2 : 1;
    rows_per_block = 16 * pl->m_tiles;
    pl->smem = sums_floats(rows_per_block, kMmaRowStride) * 4 + 8;
  } else {
    return false;
  }
  const long long z = ((long long)m + rows_per_block - 1) / rows_per_block;
  if (z > 65535 || tiles > 65535) return false;
  pl->grid = dim3(pl->n_split, tiles, (unsigned)z);
  return true;
}

// Every launch: a cluster of grid.x ranks.
template <typename Kernel>
cudaError_t launch(Kernel kernel, dim3 grid, int smem, const Params& p, cudaStream_t stream) {
  if (smem > 48 * 1024) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = grid.x;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, kernel, p);
  return err != cudaSuccess ? err : cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_rows(const Plan& pl, const Params& p, cudaStream_t stream) {
  switch (pl.per_thread) {
    case 1: return launch(int8_matmul_kernel<T, 1>, pl.grid, pl.smem, p, stream);
    case 2: return launch(int8_matmul_kernel<T, 2>, pl.grid, pl.smem, p, stream);
    case 4: return launch(int8_matmul_kernel<T, 4>, pl.grid, pl.smem, p, stream);
    case 8: return launch(int8_matmul_kernel<T, 8>, pl.grid, pl.smem, p, stream);
    case 16: return launch(int8_matmul_kernel<T, 16>, pl.grid, pl.smem, p, stream);
    default: return cudaErrorInvalidValue;
  }
}

template <int kMTiles>
cudaError_t dispatch_steps(const Plan& pl, const Params& p, cudaStream_t stream) {
  switch (pl.per_thread) {
    case 1: return launch(int8_matmul_kernel_mma<1, kMTiles>, pl.grid, pl.smem, p, stream);
    case 2: return launch(int8_matmul_kernel_mma<2, kMTiles>, pl.grid, pl.smem, p, stream);
    case 4: return launch(int8_matmul_kernel_mma<4, kMTiles>, pl.grid, pl.smem, p, stream);
    case 8: return launch(int8_matmul_kernel_mma<8, kMTiles>, pl.grid, pl.smem, p, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// The K split of the f32 kernel: cluster ranks and weight rows per thread.
// Returns a cudaError_t code.
extern "C" int qtts_int8_matmul_split(int k, int* n_split, int* rows) {
  return k > 0 && choose_split(k, n_split, rows) ? 0 : (int)cudaErrorInvalidValue;
}

// The K split of the tensor-core kernel: cluster ranks and 16-row steps per
// warp. Returns a cudaError_t code.
extern "C" int qtts_int8_matmul_mma_split(int k, int* n_split, int* steps) {
  return k > 0 && choose_mma_split(k, n_split, steps) ? 0 : (int)cudaErrorInvalidValue;
}

// The grid of a launch (x: cluster ranks, y: the group's column tiles, z:
// row tiles of x), for sizing a timeline. Returns a cudaError_t code.
extern "C" int qtts_int8_matmul_grid(int dtype, int count, const int* n, int m, int k,
                                     int* grid) {
  int tile0[kMaxGroup + 1];
  Plan pl;
  if (!plan_launch(dtype, count, n, m, k, tile0, &pl)) return (int)cudaErrorInvalidValue;
  grid[0] = pl.grid.x;
  grid[1] = pl.grid.y;
  grid[2] = pl.grid.z;
  return 0;
}

// dtype: 0 = float32, 1 = bfloat16 (x, and the outputs unless out_f32).
// x [m, k]; for e < count: w[e] int8 [k, n[e]] (n[e] % 16 == 0, 16 B
// aligned), s[e] bf16 [n[e]], out[e] [m, n[e]]. timeline: nullptr, or
// u64 [blocks][6] (blocks = the product of qtts_int8_matmul_grid's three).
// Returns a cudaError_t code (0 = success).
extern "C" int qtts_int8_matmul(const void* x, int count, const void* const* w,
                                const void* const* s, void* const* out, const int* n,
                                int dtype, int out_f32, int m, int k, void* timeline,
                                void* stream) {
  Params p = {};
  Plan pl;
  if (!plan_launch(dtype, count, n, m, k, p.tile0, &pl)) return (int)cudaErrorInvalidValue;
  p.x = x;
  p.m = m;
  p.k = k;
  p.out_f32 = out_f32;
  p.count = count;
  for (int e = 0; e < count; ++e) {
    p.w[e] = static_cast<const int8_t*>(w[e]);
    p.s[e] = static_cast<const __nv_bfloat16*>(s[e]);
    p.out[e] = out[e];
    p.n[e] = n[e];
  }
  p.timeline = static_cast<unsigned long long*>(timeline);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return (int)dispatch_rows<float>(pl, p, st);
  return (int)(pl.m_tiles == 2 ? dispatch_steps<2>(pl, p, st) : dispatch_steps<1>(pl, p, st));
}
