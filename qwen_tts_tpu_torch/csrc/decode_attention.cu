// Single-token GQA decode attention for Hopper (sm_90a), split over the
// cache positions.
//
// Replaces the TPU kernel qwen_tts_tpu/ops/pallas/decode_attention.py
// (`pallas_attention_decode_step`, body `_kernel`): one new query token per
// batch row attends over that row's fixed-shape KV cache [S_max, KV, hd],
// restricted to positions [valid_from, cur_len) and to an optional sliding
// window (pos >= cur_len - window).
//
// Two cache types, one template: the activation dtype T (f32 / bf16), or the
// int8 dict cache of the serving mode (qwen_tts_tpu/ops/attention.py:93-157):
// int8 K/V [B, S_max, KV, hd] with one f32 scale per token and head
// [B, S_max, KV]. The scales fold into the dots: the score is
// (q . k_i8) * scale * k_s, and the output sums (p_j * v_s_j) * v_i8_j, all in
// f32; no dequantized copy of the cache is made.
//
// Bound: bytes. The work is 4 flops per cached element read, far below the
// card's f32 ridge, so the least time is B * n_valid * KV * 2 * (hd *
// sizeof(cache element) + scales) over 3.35 TB/s: 1.27 us for the talker's
// bf16 cache at B=4 x 2080 positions, 10.2 us at B=32.
//
// What the first design lost. It ran one block of 4 warps per (row, KV head)
// -- 8 blocks on 132 SMs at the talker's B=4 -- and each warp walked its
// positions one after another, paying per position G dependent warp-wide
// shuffle reductions and two expf: a latency chain, not a byte stream. At 65
// positions it took ~500x its byte bound, and its time grew with the cache
// at the chain's rate, not the card's.
//
// This design:
//   * Split over positions, in shares that follow the row alone. The grid is
//     (split, KV head, row). A row's valid range [lo, hi) is cut into chunks
//     of 16 positions counted from lo; chunk j goes to warp slot
//     j mod (n_split * 4) (slot = rank * 4 + warp), which walks its chunks in
//     order. The host picks n_split from S_max alone (`choose_split` in
//     ops/cuda/decode_attention.py): the power of two of blocks whose warps
//     cover ceil(S_max / 16) chunks, at most 8 (one portable cluster; at
//     B=32 x 2080, 16 gave 1.55 waves of blocks): 1 for the
//     sub-talker's 16-17 slots, 2 for the path's talker cache of 97, 8 from
//     257 slots on. So a row's chunks, the warps that take them and the
//     merge's order depend on the row (its query, valid keys and values,
//     window) and on nothing else: not on B, not on S_max, not on where
//     left padding puts the row in its cache. Ranks past a row's last chunk
//     hold an empty share, weight 0, which the merge adds as exact zeros.
//     Each block computes its row's range from cur_len / valid_from on the
//     device: no host sync, no per-launch decision from device values.
//   * Warps run alone. A warp streams its own positions through its own
//     two-stage ring with cp.async (16 B a lane; the int8 scales 4 B), in
//     chunks of 16 positions, and keeps its own online softmax: no block
//     barrier inside the loop. Small stages leave room for five blocks (20
//     warps) an SM, which long caches at large batches need.
//   * Short rows skip the staging. A row of at most one chunk (the
//     sub-talker's caches, short talker rows) gives each of block 0's warps
//     at most 4 positions, loaded with q straight into registers before any
//     use, and walks them one at a time with lanes over dims; here latency,
//     not bytes, is the cost, and this path has the fewest steps.
//   * Scores on the tensor cores for bf16 queries: each chunk is one
//     m16n8k16 m-tile (positions x queries; the talker's G = 8 is n = 8),
//     exact bf16 (or int8 -> bf16) products with f32 sums, q^T held in
//     registers. On the CUDA cores with lanes over positions, every product
//     reads q from shared memory, and the shared-memory issue rate, not the
//     bytes, bounds the launch. f32 queries still take the CUDA cores, for
//     f32 results.
//   * The chunk's softmax runs in the accumulator layout: one max over a
//     lane's positions and three shuffles per query, l summed per lane and
//     across lanes only at the end. The probabilities go through the warp's
//     own shared memory to PV.
//   * PV on the tensor cores too, for bf16 queries: out^T += V^T P^T per 16
//     dims, k = the chunk's 16 positions. On the CUDA cores PV was 16 FMAs
//     per lane and position, most of a chunk's instructions, and at B=32 x
//     2080 the int8 cache missed 4x its bound on them. Each f32 probability
//     is split into three bf16 parts (8 + 8 + 8 significant bits), so the
//     products are the f32 products and the sums stay f32; V's 16 B chunks
//     are XOR-swizzled by row so the transposed fragment loads do not
//     collide in the banks. f32 queries keep PV on the CUDA cores.
//   * Merge in the launch, in a fixed order. The warps merge in shared
//     memory. The splits of one (row, KV head) form one thread block cluster:
//     each block pushes its (m, l) to every block and each block's slice of
//     its acc to that block through distributed shared memory, then one
//     cluster barrier, then each block merges its slice from its own shared
//     memory, the ranks' weights by a fixed shuffle tree (so n_split is a
//     power of two). No workspace, no atomics, no second launch; the bits do
//     not depend on which block finishes first. The shuffle tree over a
//     power of two of ranks, with every rank past the data empty, adds the
//     same sums in the same pairs at any n_split that covers the row's
//     chunks, so a row's bits are those of the row alone: the same at B 1
//     and 32, at S_max 97 and 2080, shifted or not.
// A fully masked row keeps the reference semantics: every score is the -1e9
// fill over all of S_max, so the softmax is uniform over S_max.
//
// The launch goes on the caller's stream, allocates nothing and returns its
// cudaError_t; the Python wrapper raises on a non-zero code.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

namespace cg = cooperative_groups;

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kMaxSplit = 8;  // the largest portable cluster
constexpr float kMaskedScore = -1e9f;
constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int offset = 16; offset > 0; offset >>= 1) x += __shfl_xor_sync(0xffffffffu, x, offset);
  return x;
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// The cluster barrier in halves: arrive (release; relaxed for the first,
// which only says the block has started), then wait (acquire).
__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// Byte k of an int8 word whose bytes were biased by 0x80 (x + 128), as a
// float: the exponent trick (0x4B000000 | (x + 128)) - (2^23 + 128), exact and
// off the slow I2F path.
__device__ __forceinline__ float biased_int8(uint32_t biased, int k) {
  return __uint_as_float(__byte_perm(biased, 0x4B000000u, 0x7540 + k)) - 8388736.f;
}

// The 32-bit word w holds 32 / (8 * sizeof(C)) cache elements; write them to
// out as floats. bf16 widens by a shift, int8 by biased_int8.
template <typename C>
__device__ __forceinline__ void unpack_word(uint32_t w, float* out);
template <>
__device__ __forceinline__ void unpack_word<float>(uint32_t w, float* out) {
  out[0] = __uint_as_float(w);
}
template <>
__device__ __forceinline__ void unpack_word<__nv_bfloat16>(uint32_t w, float* out) {
  out[0] = __uint_as_float(w << 16);
  out[1] = __uint_as_float(w & 0xffff0000u);
}
template <>
__device__ __forceinline__ void unpack_word<int8_t>(uint32_t w, float* out) {
  const uint32_t biased = w ^ 0x80808080u;
#pragma unroll
  for (int k = 0; k < 4; ++k) out[k] = biased_int8(biased, k);
}

// N cache elements from shared memory at p (N * sizeof(C) bytes: 2 to 16,
// aligned to its size) as floats.
template <typename C, int N>
__device__ __forceinline__ void load_elems(const unsigned char* p, float* out) {
  constexpr int kBytes = N * (int)sizeof(C);
  if constexpr (kBytes == 16) {
    const uint4 u = *reinterpret_cast<const uint4*>(p);
    const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) unpack_word<C>(w[i], out + i * (4 / sizeof(C)));
  } else if constexpr (kBytes == 8) {
    const uint2 u = *reinterpret_cast<const uint2*>(p);
    unpack_word<C>(u.x, out);
    unpack_word<C>(u.y, out + 4 / sizeof(C));
  } else if constexpr (kBytes == 4) {
    unpack_word<C>(*reinterpret_cast<const uint32_t*>(p), out);
  } else {
    static_assert(kBytes == 2, "two int8 elements");
    float f[4];
    unpack_word<C>(*reinterpret_cast<const uint16_t*>(p), f);
    out[0] = f[0];
    out[1] = f[1];
  }
}

// N consecutive floats from shared memory, vectorised where aligned.
template <int N>
__device__ __forceinline__ void load_floats(const float* p, float* out) {
  if constexpr (N % 4 == 0) {
#pragma unroll
    for (int i = 0; i < N; i += 4) {
      const float4 f = *reinterpret_cast<const float4*>(p + i);
      out[i] = f.x;
      out[i + 1] = f.y;
      out[i + 2] = f.z;
      out[i + 3] = f.w;
    }
  } else if constexpr (N == 2) {
    const float2 f = *reinterpret_cast<const float2*>(p);
    out[0] = f.x;
    out[1] = f.y;
  } else {
    out[0] = p[0];
  }
}

// d += a * b on the tensor cores: m16n8k16, bf16 inputs, f32 sums.
__device__ __forceinline__ void mma_bf16(float* d, const uint32_t* a, const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// Two floats that bf16 holds exactly (int8 values) as a bf16 pair: their
// top halves, lo in the low half.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  return __byte_perm(__float_as_uint(lo), __float_as_uint(hi), 0x7632);
}

// The f32 pair (a, b) as kSplitParts bf16 pairs, a in the low halves: each
// part rounds what the parts before it left. Three parts of 8 significant
// bits hold an f32's 24, so their products with bf16 (or int8) values on the
// tensor cores are the f32 products, summed in f32.
constexpr int kSplitParts = 3;
__device__ __forceinline__ void split_bf16(float a, float b, uint32_t* parts) {
#pragma unroll
  for (int i = 0; i < kSplitParts; ++i) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
    const float2 hf = __bfloat1622float2(h);
    parts[i] = *reinterpret_cast<const uint32_t*>(&h);
    a -= hf.x;
    b -= hf.y;
  }
}

// Shared-memory layout of one block (byte offsets, all multiples of 16).
template <typename T, typename C, int HD, int G>
struct Layout {
  static constexpr bool kInt8 = std::is_same<C, int8_t>::value;
  // bf16 queries take the tensor cores for the scores (exact products, f32
  // sums); f32 queries the CUDA cores, for f32 results.
  static constexpr bool kMma = std::is_same<T, __nv_bfloat16>::value;
  static constexpr int kRowBytes = HD * (int)sizeof(C);
  // Positions per chunk: one 16-row m-tile. Small stages leave room for
  // five blocks an SM (kMinBlocks).
  static constexpr int kP = 16;
  static constexpr int kMT = kP / 16;
  static constexpr int kNT = (G + 7) / 8;  // 8-query n-tiles
  // K rows padded so that the fragment loads of 8 rows hit distinct banks.
  static constexpr int kKRow = kRowBytes + (kMma && sizeof(C) == 2 ? 32 : 16);
  static constexpr int kCPR = kRowBytes / 16;  // 16 B chunks per row
  static constexpr int kVOff = kP * kKRow;
  static constexpr int kScaleOff = kVOff + kP * kRowBytes;  // int8: k_s[kP], v_s[kP]
  // On the tensor cores a V fragment load reads the same dims of rows 2q,
  // 2q + 2, ...: row r's 16 B chunks are stored XOR-swizzled by r, so those
  // rows fall in distinct banks (two-way at int8 rows of 64 B).
  static constexpr int kSwz = (kCPR < 8 ? kCPR : 8) - 1;
  static __device__ __forceinline__ int v_chunk(int row, int c) {
    return kMma ? c ^ (row & kSwz) : c;
  }
  static constexpr int kStageBytes = kScaleOff + (kInt8 ? 2 * kP * 4 : 0);
  // Per warp: one chunk lands while one is used, unless that passes 96 KB a
  // block (f32 rows of 128): then one stage.
  static constexpr int kStages = kWarps * 2 * kStageBytes <= 98304 ? 2 : 1;
  static constexpr int kWarpRing = kStages * kStageBytes;
  static constexpr int kQRaw = kWarps * kWarpRing;      // q as given [G][HD] T
  static constexpr int kQ = kQRaw + G * HD * (int)sizeof(T);  // q [G][HD] f32 (CUDA cores)
  static constexpr int kPP = kQ + (kMma ? 0 : G * HD * 4);  // per warp [kP][kPPS] probabilities
  // Rows of 4 floats more on the tensor cores, whose fragment loads read
  // the probabilities transposed.
  static constexpr int kPPS = kMma ? G + 4 : G;
  static constexpr int kCS = kPP + kWarps * kP * kPPS * 4;     // per warp [16] rescale (CUDA cores)
  static constexpr int kWM = kCS + kWarps * 64;                // each warp's m [kWarps][G]
  static constexpr int kWL = kWM + kWarps * G * 4;             // each warp's l
  static constexpr int kM = kWL + kWarps * G * 4;             // each block's m [kMaxSplit][G]
  static constexpr int kL = kM + kMaxSplit * G * 4;            // each block's l
  static constexpr int kW = kL + kMaxSplit * G * 4;            // merge weights
  static constexpr int kLAll = kW + kMaxSplit * G * 4;         // merged l [G]
  static constexpr int kAcc = kLAll + 64;  // each block's slice of acc [n_split][per]
  static constexpr int kBytes = kAcc + (G * HD + kMaxSplit) * 4;
  static_assert(G <= 16 && kRowBytes % 16 == 0 && kStageBytes % 16 == 0, "layout");
  static_assert(32 % kCPR == 0 && kP * kCPR % 32 == 0, "a warp copies whole rows per step");
  static_assert(kWarpRing >= G * HD * 4, "a warp's partial acc reuses its drained ring");
  // The talker's heads (hd 64, G 8): five blocks (20 warps) an SM, which
  // long caches at large batches need to hide each warp's latency; the
  // registers are capped to fit (the shared memory above does). An f32
  // cache's stages fit two blocks an SM at most, so its variants keep their
  // registers rather than spill under the cap.
  static constexpr int kMinBlocks = HD == 64 && G <= 8 && sizeof(C) < 4 ? 5 : 1;
};

// Scores of one chunk in the m16n8 accumulator layout: lane (grp = lane / 4,
// quad = lane % 4) holds sc[mt][nt][i] for position mt * 16 + grp + 8 * (i / 2)
// and query nt * 8 + 2 * quad + i % 2 (queries past G are padding). On the
// tensor cores the k index of the fragments is permuted (slots 2q, 2q+1 and
// 2q+8, 2q+9 hold dims 4q..4q+3 of each 16), the same for K and q, so each
// lane reads 4 contiguous dims of a row.
template <typename T, typename C, int HD, int G>
__device__ __forceinline__ void chunk_scores(const unsigned char* stage, const float* qs,
                                             uint32_t (*qb)[Layout<T, C, HD, G>::kNT][2],
                                             int lane,
                                             float (*sc)[Layout<T, C, HD, G>::kNT][4]) {
  using L = Layout<T, C, HD, G>;
  const int grp = lane / 4;
  const int quad = lane % 4;
#pragma unroll
  for (int mt = 0; mt < L::kMT; ++mt) {
#pragma unroll
    for (int nt = 0; nt < L::kNT; ++nt) {
#pragma unroll
      for (int i = 0; i < 4; ++i) sc[mt][nt][i] = 0.f;
    }
  }
  if constexpr (L::kMma) {
    float odd[L::kNT][4] = {};  // odd k-steps: two independent accumulator chains
#pragma unroll
    for (int mt = 0; mt < L::kMT; ++mt) {
      const unsigned char* row0 = stage + (mt * 16 + grp) * L::kKRow;
      const unsigned char* row1 = row0 + 8 * L::kKRow;
#pragma unroll
      for (int ks = 0; ks < HD / 16; ++ks) {
        uint32_t a[4];
        if constexpr (sizeof(C) == 2) {
          const uint2 u0 = *reinterpret_cast<const uint2*>(row0 + (ks * 16 + 4 * quad) * 2);
          const uint2 u1 = *reinterpret_cast<const uint2*>(row1 + (ks * 16 + 4 * quad) * 2);
          a[0] = u0.x;
          a[1] = u1.x;
          a[2] = u0.y;
          a[3] = u1.y;
        } else {
          float f0[4], f1[4];
          unpack_word<C>(*reinterpret_cast<const uint32_t*>(row0 + ks * 16 + 4 * quad), f0);
          unpack_word<C>(*reinterpret_cast<const uint32_t*>(row1 + ks * 16 + 4 * quad), f1);
          a[0] = pack_bf16(f0[0], f0[1]);
          a[1] = pack_bf16(f1[0], f1[1]);
          a[2] = pack_bf16(f0[2], f0[3]);
          a[3] = pack_bf16(f1[2], f1[3]);
        }
#pragma unroll
        for (int nt = 0; nt < L::kNT; ++nt) mma_bf16(ks % 2 ? odd[nt] : sc[mt][nt], a, qb[ks][nt]);
      }
#pragma unroll
      for (int nt = 0; nt < L::kNT; ++nt) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          sc[mt][nt][i] += odd[nt][i];
          odd[nt][i] = 0.f;
        }
      }
    }
  } else {
    constexpr int kEPC = 16 / (int)sizeof(C);
#pragma unroll
    for (int mt = 0; mt < L::kMT; ++mt) {
#pragma unroll
      for (int nt = 0; nt < L::kNT; ++nt) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int n = nt * 8 + 2 * quad + i % 2;
          if (n < G) {
            const unsigned char* krow = stage + (mt * 16 + grp + 8 * (i / 2)) * L::kKRow;
            float s = 0.f;
            for (int c = 0; c < L::kRowBytes / 16; ++c) {
              float kf[kEPC], qf[kEPC];
              load_elems<C, kEPC>(krow + c * 16, kf);
              load_floats<kEPC>(qs + n * HD + c * kEPC, qf);
#pragma unroll
              for (int e = 0; e < kEPC; ++e) s = fmaf(qf[e], kf[e], s);
            }
            sc[mt][nt][i] = s;
          }
        }
      }
    }
  }
}

struct Params {
  const void* q;            // [B, KV*G, HD] T
  const void* k;            // [B, S_max, KV, HD] C
  const void* v;
  const float* k_scale;     // [B, S_max, KV] (int8 cache; else null)
  const float* v_scale;
  const int32_t* cur_len;   // [B]
  const int32_t* valid_from;  // [B]
  void* out;                // [B, KV*G, HD] T
  int s_max, kv_heads, window;
  float scale;
};

template <typename T, typename C, int HD, int G>
__global__ void __launch_bounds__(kThreads, (Layout<T, C, HD, G>::kMinBlocks))
    decode_attention_kernel(const Params prm) {
  using L = Layout<T, C, HD, G>;
  constexpr bool kInt8 = L::kInt8;
  constexpr int kP = L::kP;
  constexpr int kMT = L::kMT;
  constexpr int kNT = L::kNT;
  constexpr int kCPR = L::kCPR;
  constexpr int kDPL = HD / 32;  // dims per lane in PV on the CUDA cores
  constexpr int kDM = HD / 8;    // dims per lane in PV on the tensor cores

  extern __shared__ __align__(128) unsigned char smem[];
  float* qs = reinterpret_cast<float*>(smem + L::kQ);
  float* w_m = reinterpret_cast<float*>(smem + L::kWM);
  float* w_l = reinterpret_cast<float*>(smem + L::kWL);
  float* m_src = reinterpret_cast<float*>(smem + L::kM);
  float* l_src = reinterpret_cast<float*>(smem + L::kL);
  float* wts = reinterpret_cast<float*>(smem + L::kW);
  float* l_all = reinterpret_cast<float*>(smem + L::kLAll);
  float* acc_src = reinterpret_cast<float*>(smem + L::kAcc);

  // The cluster is (n_split, 1, 1) and the grid's x is n_split, so the
  // split index is both blockIdx.x and the rank in the cluster.
  const int rank = blockIdx.x;
  const int n_split = gridDim.x;
  const int kvh = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int grp = lane / 4;
  const int quad = lane % 4;
  const int kv_heads = prm.kv_heads;
  const int s_max = prm.s_max;
  const C* __restrict__ k_cache = static_cast<const C*>(prm.k);
  const C* __restrict__ v_cache = static_cast<const C*>(prm.v);
  float* pp = reinterpret_cast<float*>(smem + L::kPP) + warp * kP * L::kPPS;
  float* cs = reinterpret_cast<float*>(smem + L::kCS) + warp * 16;
  unsigned char* ring = smem + warp * L::kWarpRing;

  // Valid range: [max(valid_from, cur_len - window, 0), min(cur_len, S_max));
  // an empty one becomes [0, S_max) with every score masked. The block takes
  // its rank's share, each warp an equal share of that.
  const int len = prm.cur_len[b];
  const int hi_valid = min(len, s_max);
  const long long window_lo = (long long)len - (long long)prm.window;
  int lo = max(prm.valid_from[b], 0);
  if (window_lo > lo) lo = (int)window_lo;
  const bool empty = lo >= hi_valid;
  const int hi = empty ? s_max : hi_valid;
  if (empty) lo = 0;
  const int n = hi - lo;
  // A row of one chunk or less (the sub-talker's caches, short talker rows)
  // takes the short path: block 0's warps take equal shares of it, at most
  // kP / kWarps positions a warp, loaded straight into registers, no staging
  // and no barrier before the merge. Longer rows: chunk j of the row
  // ([lo + j kP, lo + (j + 1) kP)) goes to warp slot j mod (n_split kWarps),
  // slot = rank kWarps + warp, which walks its chunks in order. Both follow
  // the row alone, and n_split (from S_max) only once a row has more chunks
  // than the largest cluster has warps; ranks past a row's last chunk are
  // empty, and an empty share merges as exact zeros.
  const bool tiny = n <= kP;
  const int w_lo = lo + (tiny && rank == 0 ? n * warp / kWarps : 0);
  const int w_hi = lo + (tiny && rank == 0 ? n * (warp + 1) / kWarps : 0);
  const int row_chunks = (n + kP - 1) / kP;
  const int slot = rank * kWarps + warp;
  const int slots = n_split * kWarps;
  const int n_chunks = tiny || slot >= row_chunks ? 0 : (row_chunks - slot + slots - 1) / slots;
  // A block may write a peer's shared memory only once the peer runs: every
  // block says so here and waits for the others before its first push.
  const bool clustered = n_split > 1;
  if (clustered) cluster_arrive_relaxed();

  auto load_chunk = [&](int t) {  // by this warp's lanes
    unsigned char* stage = ring + (t % L::kStages) * L::kStageBytes;
    const int j0 = lo + (slot + t * slots) * kP;
    const int cnt = min(kP, hi - j0);
    const size_t token0 = ((size_t)b * s_max + j0) * kv_heads + kvh;
    const int c = lane % kCPR;  // the lane's 16 B chunk of each row it copies
#pragma unroll
    for (int it = 0; it < kP * kCPR / 32; ++it) {
      const int row = lane / kCPR + it * (32 / kCPR);
      if (row < cnt) {
        const size_t at = (token0 + (size_t)row * kv_heads) * L::kRowBytes + c * 16;
        cp_async16(stage + row * L::kKRow + c * 16,
                   reinterpret_cast<const unsigned char*>(k_cache) + at);
        cp_async16(stage + L::kVOff + row * L::kRowBytes + L::v_chunk(row, c) * 16,
                   reinterpret_cast<const unsigned char*>(v_cache) + at);
      }
    }
    if constexpr (kInt8) {
      for (int i = lane; i < 2 * kP; i += 32) {
        if (i % kP < cnt) {
          cp_async4(stage + L::kScaleOff + i * 4, (i < kP ? prm.k_scale : prm.v_scale) + token0 +
                                                      (size_t)(i % kP) * kv_heads);
        }
      }
    }
    cp_async_commit();
  };

  // Softmax in base 2 (scores times scale * log2(e), then exp2). Every
  // warp's result: m and l per query in shared memory, acc in registers,
  // lanes over dims.
  const float scale2 = prm.scale * kLog2e;
  const size_t q_base = ((size_t)b * kv_heads + kvh) * G * HD;
  float acc[G][kDPL];  // lanes over dims: the short path and the CUDA cores' PV
#pragma unroll
  for (int g = 0; g < G; ++g) {
#pragma unroll
    for (int e = 0; e < kDPL; ++e) acc[g][e] = 0.f;
  }
  float* w_acc = reinterpret_cast<float*>(ring);  // the warp's acc [G][HD] for the merge
  auto store_acc = [&]() {
#pragma unroll
    for (int g = 0; g < G; ++g) {
#pragma unroll
      for (int e = 0; e < kDPL; ++e) w_acc[g * HD + lane * kDPL + e] = acc[g][e];
    }
  };
  if (tiny) {
    // One position at a time, lanes over dims: q, K and V rows straight from
    // global memory into registers, all loads issued before any use.
    constexpr int kTiny = kP / kWarps;
    const unsigned char* q = reinterpret_cast<const unsigned char*>(
        static_cast<const T*>(prm.q) + q_base + lane * kDPL);
    float qr[G][kDPL], kr[kTiny][kDPL], vr[kTiny][kDPL], k_s[kTiny], v_s[kTiny];
#pragma unroll
    for (int g = 0; g < G; ++g) load_elems<T, kDPL>(q + (size_t)g * HD * sizeof(T), qr[g]);
#pragma unroll
    for (int i = 0; i < kTiny; ++i) {
      k_s[i] = v_s[i] = 1.f;
      if (w_lo + i < w_hi) {
        const size_t token = ((size_t)b * s_max + w_lo + i) * kv_heads + kvh;
        const size_t at = (token * HD + lane * kDPL) * sizeof(C);
        load_elems<C, kDPL>(reinterpret_cast<const unsigned char*>(k_cache) + at, kr[i]);
        load_elems<C, kDPL>(reinterpret_cast<const unsigned char*>(v_cache) + at, vr[i]);
        if constexpr (kInt8) {
          k_s[i] = prm.k_scale[token];
          v_s[i] = prm.v_scale[token];
        }
      }
    }
    float mw[G], lw[G];
#pragma unroll
    for (int g = 0; g < G; ++g) {
      mw[g] = -INFINITY;
      lw[g] = 0.f;
    }
#pragma unroll
    for (int i = 0; i < kTiny; ++i) {
      if (w_lo + i < w_hi) {
#pragma unroll
        for (int g = 0; g < G; ++g) {
          float d = 0.f;
#pragma unroll
          for (int e = 0; e < kDPL; ++e) d = fmaf(qr[g][e], kr[i][e], d);
          d = warp_sum(d);
          const float s = empty ? kMaskedScore : d * scale2 * k_s[i];
          const float m_new = fmaxf(mw[g], s);
          const float c = exp2f(mw[g] - m_new);  // 0 at the first position
          const float p = exp2f(s - m_new);
          lw[g] = lw[g] * c + p;
          mw[g] = m_new;
#pragma unroll
          for (int e = 0; e < kDPL; ++e) acc[g][e] = acc[g][e] * c + (p * v_s[i]) * vr[i][e];
        }
      }
    }
    if (lane == 0) {
#pragma unroll
      for (int g = 0; g < G; ++g) {
        w_m[warp * G + g] = mw[g];
        w_l[warp * G + g] = lw[g];
      }
    }
    store_acc();
  } else {
    // q lands with the first chunk (all asynchronous); then the f32 copy for
    // PV-side use and, for bf16 q, the tensor-core fragments of q^T.
    {
      const unsigned char* q = static_cast<const unsigned char*>(prm.q) + q_base * sizeof(T);
      for (int i = tid; i < G * HD * (int)sizeof(T) / 16; i += kThreads) {
        cp_async16(smem + L::kQRaw + i * 16, q + i * 16);
      }
      cp_async_commit();
    }
    if (n_chunks > 0) {
      load_chunk(0);
    } else {
      cp_async_commit();
    }
    cp_async_wait<1>();  // q, at least
    __syncthreads();
    if constexpr (!L::kMma) {
      const T* q_raw = reinterpret_cast<const T*>(smem + L::kQRaw);
      for (int i = tid; i < G * HD; i += kThreads) qs[i] = to_float(q_raw[i]);
      __syncthreads();
    }
    uint32_t qb[HD / 16][kNT][2];
#pragma unroll
    for (int ks = 0; ks < HD / 16; ++ks) {
#pragma unroll
      for (int nt = 0; nt < kNT; ++nt) {
        const int qn = nt * 8 + grp;
        uint2 u = make_uint2(0u, 0u);
        if (L::kMma && qn < G) {
          u = *reinterpret_cast<const uint2*>(smem + L::kQRaw +
                                              ((size_t)qn * HD + ks * 16 + 4 * quad) * 2);
        }
        qb[ks][nt][0] = u.x;
        qb[ks][nt][1] = u.y;
      }
    }

    // Each warp: an online softmax over its positions, chunk by chunk. A lane
    // keeps m and l of its queries (nt * 8 + 2 * quad + h); l is summed per
    // lane and across lanes at the end.
    float m[kNT][2], l[kNT][2];
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt) {
      m[nt][0] = m[nt][1] = -INFINITY;
      l[nt][0] = l[nt][1] = 0.f;
    }
    // PV on the tensor cores: out^T [dims x queries] += V^T [dims x
    // positions] P^T [positions x queries], one m16n8k16 per 16 dims (m)
    // and 8 queries (n), k = the chunk's 16 positions. Lane (grp, quad)
    // holds dims grp * kDM .. + kDM - 1 of positions 2 quad, 2 quad + 1,
    // 2 quad + 8, 2 quad + 9; m-tile mt's rows grp and grp + 8 are dims
    // grp * kDM + 2 mt and + 1. acc_t[mt][nt] is the accumulator fragment:
    // dims (2 mt, 2 mt + 1 after grp * kDM) x queries (nt * 8 + 2 quad, + 1),
    // the lane's own softmax queries.
    float acc_t[L::kMma ? HD / 16 : 1][kNT][4];
#pragma unroll
    for (int mt = 0; mt < (L::kMma ? HD / 16 : 1); ++mt) {
#pragma unroll
      for (int nt = 0; nt < kNT; ++nt) {
#pragma unroll
        for (int i = 0; i < 4; ++i) acc_t[mt][nt][i] = 0.f;
      }
    }
    for (int t = 0; t < n_chunks; ++t) {
      cp_async_wait<0>();
      __syncwarp();  // chunk t landed for every lane; chunk t-1 fully consumed
      if (L::kStages == 2 && t + 1 < n_chunks) load_chunk(t + 1);

      const unsigned char* stage = ring + (t % L::kStages) * L::kStageBytes;
      const float* scales = reinterpret_cast<const float*>(stage + L::kScaleOff);
      const int cnt = min(kP, hi - (lo + (slot + t * slots) * kP));

      float sc[kMT][kNT][4];
      chunk_scores<T, C, HD, G>(stage, qs, qb, lane, sc);

      // Softmax over the chunk: per query, the max over the lane's positions
      // and then over the 8 lanes of its quad. cf: each query's rescale.
      float cf[kNT][2];
#pragma unroll
      for (int nt = 0; nt < kNT; ++nt) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          float s[kMT][2];
          float mx = -INFINITY;
#pragma unroll
          for (int mt = 0; mt < kMT; ++mt) {
#pragma unroll
            for (int r = 0; r < 2; ++r) {
              const int pos = mt * 16 + grp + 8 * r;
              float v = -INFINITY;
              if (pos < cnt) {
                v = empty ? kMaskedScore : sc[mt][nt][2 * r + h] * scale2;
                if constexpr (kInt8) {
                  if (!empty) v *= scales[pos];
                }
              }
              s[mt][r] = v;
              mx = fmaxf(mx, v);
            }
          }
#pragma unroll
          for (int offset = 4; offset < 32; offset <<= 1) {
            mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, offset));
          }
          const float m_new = fmaxf(m[nt][h], mx);
          const float c = exp2f(m[nt][h] - m_new);  // 0 on the first chunk
          float sum = 0.f;
          const int qn = nt * 8 + 2 * quad + h;
#pragma unroll
          for (int mt = 0; mt < kMT; ++mt) {
#pragma unroll
            for (int r = 0; r < 2; ++r) {
              const int pos = mt * 16 + grp + 8 * r;
              const float p = pos < cnt ? exp2f(s[mt][r] - m_new) : 0.f;
              sum += p;
              if (qn < G) {
                float pv = p;
                if constexpr (kInt8) pv = pos < cnt ? p * scales[kP + pos] : 0.f;
                pp[pos * L::kPPS + qn] = pv;
              }
            }
          }
          l[nt][h] = l[nt][h] * c + sum;
          m[nt][h] = m_new;
          cf[nt][h] = c;
          if (!L::kMma && grp == 0 && qn < G) cs[qn] = c;
        }
      }
      __syncwarp();

      if constexpr (L::kMma) {
        // The probabilities as P^T fragments, each f32 value split into
        // kSplitParts bf16 parts (a product per part, f32 sums), and V^T
        // fragments of the lane's four rows (zero past the chunk's end: a
        // stale row may hold any bits).
        uint32_t pb[kNT][2][kSplitParts];
#pragma unroll
        for (int nt = 0; nt < kNT; ++nt) {
          const int qn = nt * 8 + grp;
#pragma unroll
          for (int half = 0; half < 2; ++half) {
            const int r0 = 2 * quad + 8 * half;
            const float p0 = qn < G ? pp[r0 * L::kPPS + qn] : 0.f;
            const float p1 = qn < G ? pp[(r0 + 1) * L::kPPS + qn] : 0.f;
            split_bf16(p0, p1, pb[nt][half]);
          }
        }
        constexpr int kLaneBytes = kDM * (int)sizeof(C);  // 8, 16 or 32
        uint32_t vw[4][kLaneBytes / 4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int row = 2 * quad + (i & 1) + 8 * (i >> 1);
          const unsigned char* vrow = stage + L::kVOff + row * L::kRowBytes;
          if constexpr (kLaneBytes == 8) {
            uint2 u = make_uint2(0u, 0u);
            if (row < cnt) {
              u = *reinterpret_cast<const uint2*>(vrow + L::v_chunk(row, grp / 2) * 16 +
                                                  (grp % 2) * 8);
            }
            vw[i][0] = u.x;
            vw[i][1] = u.y;
          } else {
#pragma unroll
            for (int c2 = 0; c2 < kLaneBytes / 16; ++c2) {
              uint4 u = make_uint4(0u, 0u, 0u, 0u);
              if (row < cnt) {
                u = *reinterpret_cast<const uint4*>(
                    vrow + L::v_chunk(row, grp * (kLaneBytes / 16) + c2) * 16);
              }
              vw[i][4 * c2] = u.x;
              vw[i][4 * c2 + 1] = u.y;
              vw[i][4 * c2 + 2] = u.z;
              vw[i][4 * c2 + 3] = u.w;
            }
          }
        }
#pragma unroll
        for (int mt = 0; mt < HD / 16; ++mt) {
#pragma unroll
          for (int nt = 0; nt < kNT; ++nt) {
            acc_t[mt][nt][0] *= cf[nt][0];
            acc_t[mt][nt][1] *= cf[nt][1];
            acc_t[mt][nt][2] *= cf[nt][0];
            acc_t[mt][nt][3] *= cf[nt][1];
          }
          // Dims 2 mt and 2 mt + 1 of the lane's slice, as (row, row + 1)
          // pairs: a bf16 word holds both dims, an int8 word four.
          uint32_t a[4];
          if constexpr (sizeof(C) == 2) {
            a[0] = __byte_perm(vw[0][mt], vw[1][mt], 0x5410);
            a[1] = __byte_perm(vw[0][mt], vw[1][mt], 0x7632);
            a[2] = __byte_perm(vw[2][mt], vw[3][mt], 0x5410);
            a[3] = __byte_perm(vw[2][mt], vw[3][mt], 0x7632);
          } else {
            // Only the two bytes this m-tile takes from each row's word.
            const int e = 2 * (mt % 2);
            float f[4][2];
#pragma unroll
            for (int i = 0; i < 4; ++i) {
              const uint32_t biased = vw[i][mt / 2] ^ 0x80808080u;
              f[i][0] = biased_int8(biased, e);
              f[i][1] = biased_int8(biased, e + 1);
            }
            a[0] = pack_bf16(f[0][0], f[1][0]);
            a[1] = pack_bf16(f[0][1], f[1][1]);
            a[2] = pack_bf16(f[2][0], f[3][0]);
            a[3] = pack_bf16(f[2][1], f[3][1]);
          }
#pragma unroll
          for (int nt = 0; nt < kNT; ++nt) {
#pragma unroll
            for (int i = 0; i < kSplitParts; ++i) {
              const uint32_t part[2] = {pb[nt][0][i], pb[nt][1][i]};
              mma_bf16(acc_t[mt][nt], a, part);
            }
          }
        }
      } else {
        // PV: lanes over dims, this warp's positions in order, all G queries.
        {
          float c[G];
          load_floats<G>(cs, c);
#pragma unroll
          for (int g = 0; g < G; ++g) {
#pragma unroll
            for (int e = 0; e < kDPL; ++e) acc[g][e] *= c[g];
          }
        }
        const unsigned char* vbase = stage + L::kVOff + lane * kDPL * (int)sizeof(C);
#pragma unroll 4
        for (int j = 0; j < cnt; ++j) {
          float vf[kDPL], p[G];
          load_elems<C, kDPL>(vbase + j * L::kRowBytes, vf);
          load_floats<G>(pp + j * L::kPPS, p);
#pragma unroll
          for (int g = 0; g < G; ++g) {
#pragma unroll
            for (int e = 0; e < kDPL; ++e) acc[g][e] = fmaf(p[g], vf[e], acc[g][e]);
          }
        }
      }
      if (L::kStages == 1 && t + 1 < n_chunks) {
        __syncwarp();
        load_chunk(t + 1);
      }
    }
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float sum = l[nt][h];
#pragma unroll
        for (int offset = 4; offset < 32; offset <<= 1) {
          sum += __shfl_xor_sync(0xffffffffu, sum, offset);
        }
        const int qn = nt * 8 + 2 * quad + h;
        if (grp == 0 && qn < G) {
          w_m[warp * G + qn] = m[nt][h];
          w_l[warp * G + qn] = sum;
        }
      }
    }
    __syncwarp();  // every lane is done with the ring, which takes the acc
    if constexpr (L::kMma) {
#pragma unroll
      for (int mt = 0; mt < HD / 16; ++mt) {
#pragma unroll
        for (int nt = 0; nt < kNT; ++nt) {
          const int qn = nt * 8 + 2 * quad;
          const int d = grp * kDM + 2 * mt;
          if (qn < G) {
            *reinterpret_cast<float2*>(w_acc + qn * HD + d) =
                make_float2(acc_t[mt][nt][0], acc_t[mt][nt][2]);
          }
          if (qn + 1 < G) {
            *reinterpret_cast<float2*>(w_acc + (qn + 1) * HD + d) =
                make_float2(acc_t[mt][nt][1], acc_t[mt][nt][3]);
          }
        }
      }
    } else {
      store_acc();
    }
  }

  // Merge, in two levels, each in a fixed order: m = max m_s,
  // l = sum l_s e^(m_s - m), acc = sum acc_s e^(m_s - m). A share that saw no
  // position has m_s = -inf and weight 0.
  // 1. The block's warps, through shared memory (each warp stored its acc
  //    [G][HD] in its own ring, drained or unused).
  __syncthreads();
  // The block's partial of output idx: each thread weighs the warps itself.
  auto block_partial = [&](int idx, float* l_out) {
    const int g = idx / HD;
    float mx = -INFINITY;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) mx = fmaxf(mx, w_m[w * G + g]);
    float a = 0.f, lsum = 0.f;
    if (mx != -INFINITY) {  // a block whose share is empty has weight 0 throughout
#pragma unroll
      for (int w = 0; w < kWarps; ++w) {
        const float wt = exp2f(w_m[w * G + g] - mx);
        a += reinterpret_cast<const float*>(smem + w * L::kWarpRing)[idx] * wt;
        lsum += w_l[w * G + g] * wt;
      }
    }
    *l_out = lsum;
    return a;
  };
  T* out = static_cast<T*>(prm.out);
  if (!clustered) {
    for (int idx = tid; idx < G * HD; idx += kThreads) {
      float lsum;
      const float a = block_partial(idx, &lsum);
      out[q_base + idx] = from_float<T>(a / lsum);
    }
    return;
  }

  // 2. The cluster's blocks: each pushes its m and l to every block and each
  //    block's slice of its acc to that block; after one barrier every block
  //    merges its slice from its own shared memory, in a fixed order. No
  //    block touches a peer after the barrier.
  cg::cluster_group cluster = cg::this_cluster();
  const int per = (G * HD + n_split - 1) / n_split;  // outputs merged per block
  cluster_wait();  // every peer runs
  if (tid < G) {
    float mx = -INFINITY;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) mx = fmaxf(mx, w_m[w * G + tid]);
    float lsum;
    block_partial(tid * HD, &lsum);
    for (int r = 0; r < n_split; ++r) {
      cluster.map_shared_rank(m_src, r)[rank * G + tid] = mx;
      cluster.map_shared_rank(l_src, r)[rank * G + tid] = lsum;
    }
  }
  for (int idx = tid; idx < G * HD; idx += kThreads) {
    float lsum;
    const float a = block_partial(idx, &lsum);
    const int dst = idx / per;
    cluster.map_shared_rank(acc_src, dst)[rank * per + (idx - dst * per)] = a;
  }
  cluster_arrive();
  cluster_wait();

  // Weights of the (query, rank) pairs, n_split lanes per query: max and sum
  // over the ranks by a fixed shuffle tree.
  for (int t0 = 0; t0 < G * n_split; t0 += kThreads) {
    const int t = t0 + tid;
    const bool valid = t < G * n_split;
    const int g = valid ? t / n_split : 0;
    const int r = t % n_split;
    const float mv = valid ? m_src[r * G + g] : 0.f;
    float mx = mv;
    for (int off = 1; off < n_split; off <<= 1) {
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
    }
    const float wt = exp2f(mv - mx);
    float lsum = valid ? l_src[r * G + g] * wt : 0.f;
    for (int off = 1; off < n_split; off <<= 1) lsum += __shfl_xor_sync(0xffffffffu, lsum, off);
    if (valid) {
      wts[r * G + g] = wt;
      if (r == 0) l_all[g] = lsum;
    }
  }
  __syncthreads();
  const int first = rank * per;
  const int count = min(per, G * HD - first);
  for (int o = tid; o < count; o += kThreads) {
    const int g = (first + o) / HD;
    float a = 0.f;
    for (int r = 0; r < n_split; ++r) a += acc_src[r * per + o] * wts[r * G + g];
    out[q_base + first + o] = from_float<T>(a / l_all[g]);
  }
}

// Pointers of one call, passed down the dispatch.
struct Args {
  Params p;
  int batch, n_split;
  cudaStream_t stream;
};

template <typename T, typename C, int HD, int G>
cudaError_t launch(const Args& a) {
  using L = Layout<T, C, HD, G>;
  auto kernel = decode_attention_kernel<T, C, HD, G>;
  static bool configured = false;  // per instantiation; setting twice is harmless
  if (!configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, L::kBytes);
    if (err != cudaSuccess) return err;
    configured = true;
  }
  const dim3 grid(a.n_split, a.p.kv_heads, a.batch);
  if (a.n_split == 1) {
    kernel<<<grid, kThreads, L::kBytes, a.stream>>>(a.p);
    return cudaGetLastError();
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = L::kBytes;
  cfg.stream = a.stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = a.n_split;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, kernel, a.p);
  return err != cudaSuccess ? err : cudaGetLastError();
}

template <typename T, typename C, int HD>
cudaError_t dispatch_groups(int groups, const Args& a) {
  switch (groups) {
    case 1: return launch<T, C, HD, 1>(a);
    case 2: return launch<T, C, HD, 2>(a);
    case 4: return launch<T, C, HD, 4>(a);
    case 8: return launch<T, C, HD, 8>(a);
    case 16: return launch<T, C, HD, 16>(a);
    default: return cudaErrorInvalidValue;
  }
}

template <typename T, typename C>
cudaError_t dispatch_head_dim(int head_dim, int groups, const Args& a) {
  switch (head_dim) {
    case 64: return dispatch_groups<T, C, 64>(groups, a);
    case 128: return dispatch_groups<T, C, 128>(groups, a);
    default: return cudaErrorInvalidValue;
  }
}

// int8_cache selects the int8 dict cache (C = int8_t) over a cache in T.
int dispatch(int dtype, bool int8_cache, int heads, int head_dim, const Args& a) {
  // n_split: a power of two (the merge's shuffle tree pairs ranks by xor)
  // up to one cluster.
  if (a.batch <= 0 || a.p.kv_heads <= 0 || a.p.s_max <= 0 || heads % a.p.kv_heads != 0 ||
      a.n_split < 1 || a.n_split > kMaxSplit || (a.n_split & (a.n_split - 1)) != 0) {
    return (int)cudaErrorInvalidValue;
  }
  const int groups = heads / a.p.kv_heads;
  switch (dtype * 2 + (int8_cache ? 1 : 0)) {
    case 0: return (int)dispatch_head_dim<float, float>(head_dim, groups, a);
    case 1: return (int)dispatch_head_dim<float, int8_t>(head_dim, groups, a);
    case 2: return (int)dispatch_head_dim<__nv_bfloat16, __nv_bfloat16>(head_dim, groups, a);
    case 3: return (int)dispatch_head_dim<__nv_bfloat16, int8_t>(head_dim, groups, a);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (q, out and the cache). n_split: blocks
// per (row, KV head), a power of two up to 8 (one cluster). Returns a cudaError_t code
// (0 = success).
extern "C" int qtts_decode_attention(const void* q, const void* k_cache, const void* v_cache,
                                     const void* cur_len, const void* valid_from, void* out,
                                     int dtype, int batch, int heads, int kv_heads,
                                     int head_dim, int s_max, int window, int n_split,
                                     float scale, void* stream) {
  const Params p{q, k_cache, v_cache, nullptr, nullptr,
                 static_cast<const int32_t*>(cur_len), static_cast<const int32_t*>(valid_from),
                 out, s_max, kv_heads, window, scale};
  return dispatch(dtype, false, heads, head_dim,
                  Args{p, batch, n_split, static_cast<cudaStream_t>(stream)});
}

// The int8 dict cache: k_i8 / v_i8 int8 [B, S_max, KV, hd], k_s / v_s f32
// [B, S_max, KV]; dtype is that of q and out.
extern "C" int qtts_decode_attention_int8(const void* q, const void* k_i8, const void* k_s,
                                          const void* v_i8, const void* v_s,
                                          const void* cur_len, const void* valid_from,
                                          void* out, int dtype, int batch, int heads,
                                          int kv_heads, int head_dim, int s_max, int window,
                                          int n_split, float scale, void* stream) {
  const Params p{q, k_i8, v_i8, static_cast<const float*>(k_s), static_cast<const float*>(v_s),
                 static_cast<const int32_t*>(cur_len), static_cast<const int32_t*>(valid_from),
                 out, s_max, kv_heads, window, scale};
  return dispatch(dtype, true, heads, head_dim,
                  Args{p, batch, n_split, static_cast<cudaStream_t>(stream)});
}
