// x @ W for an int8 weight with per-column scales, for Hopper (sm_90a).
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
//   y = round_x(x @ w_i8) * s           in x's dtype (`_w_matmul`), or
//   y = float(round_x(x @ w_i8)) * s    in f32 (the LM heads' logits)
//
// for x [M, K] f32 or bf16, w_i8 [K, N] int8 (quantize_int8's layout: per
// output column, N % 16 == 0) and s [N] bf16. Each int8 weight widens to f32
// exactly; the products sum in f32 in one fixed order that depends on K and
// N only, never on M: a row's bits do not depend on the rows beside it.
//
// Bound: bytes. A decode step's projection does 2 * M flops per weight byte
// (M = 4 on the serving path), far below the card's ridge, so the least time
// is the int8 weight's bytes (plus x and y) over 3.35 TB/s: 0.31 us for a
// 1024 x 1024 projection, 52 us for the talker's 140 projections of a step.
//
// Design (simple first; wgmma and TMA are later work). Two kernels, one per
// activation dtype, each with its own fixed order:
//   * bf16 activations (the serving path): the tensor cores. A block owns 64
//     output columns and one cluster rank's share of K; it widens its int8
//     weight slice to bf16 in shared memory once (exact: |w| <= 127) and
//     stages x's rows (16 or 64 a block, zeros past M) beside it; warp w
//     runs mma.sync m16n8k16 over columns 16w..16w+15 for every row, summing
//     in K order. Rows never mix in an MMA, so the zero rows that pad M to
//     a tile change no row's bits.
//   * f32 activations (the f32 parity runs): the CUDA cores, f32 products.
//     A block of 128 threads owns 64 output columns; lane c of a group of 4
//     reads 16 B of int8 (16 columns) per weight row, so 4 lanes read 64
//     contiguous bytes of a row. The block's 32 groups split its K range:
//     group g takes kRows consecutive rows. A thread issues all its weight
//     loads before it uses any and keeps them packed in registers; the
//     block stages its rows of x in shared memory; then each thread walks
//     the rows, 16 f32 sums per row, reduced over the warp's 8 groups by a
//     shuffle tree that halves the columns each lane holds at each level,
//     then over the 4 warps in order through shared memory.
//   * Both split K further over the blocks of one thread block cluster (up
//     to 8; grid x = cluster rank), so that a 1024 x 1024 projection
//     spreads over 128 blocks and its bytes are all in flight at once, and
//     sum the ranks in order through distributed shared memory. No atomics,
//     no workspace; the order depends on K and N only.
//   * Rows of x tile over grid z; the blocks of later row tiles reread the
//     same weights from L2 (a projection is at most 6 MB of the 50 MB), not
//     from HBM.
//
// The launch goes on the caller's stream, allocates nothing and returns its
// cudaError_t; the Python wrapper (ops/cuda/int8_matmul.py) raises on a
// non-zero code.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 128;
constexpr int kLanesPerRow = 4;                      // 16 columns (16 B of int8) each
constexpr int kCols = kLanesPerRow * 16;             // output columns per block
constexpr int kGroups = kThreads / kLanesPerRow;     // K groups per block
constexpr int kWarps = kThreads / 32;
constexpr int kRowsPerBlock = 8;                     // rows of x per block
constexpr int kMaxSplit = 8;                         // the largest portable cluster
constexpr int kMaxRows = 16;                         // weight rows per thread
constexpr int kPartFloats = kWarps * kRowsPerBlock * kCols;
// x's rows staged as f32 (at most kMaxRows weight rows a thread), the
// warps' partial sums and the block's.
constexpr int kSmemBytes =
    (kRowsPerBlock * kGroups * kMaxRows + kPartFloats + kRowsPerBlock * kCols) * 4;

struct Params {
  const void* x;              // [M, K] T
  const int8_t* w;            // [K, N]
  const __nv_bfloat16* s;     // [N]
  void* out;                  // [M, N] T, or f32
  int m, k, n, out_f32;
  int block_k;  // the tensor-core kernel: K rows of a cluster rank (16s)
};

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

// The cluster barrier in halves: arrive (release), then wait (acquire).
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
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

// The block's partial sums block_sum [rows][cols] (cols per row, count =
// rows * cols) summed over the cluster's ranks in order, each rank a share
// of the outputs from every peer's block_sum (no block leaves while a peer
// may read it); then rounded to x's dtype and scaled.
template <typename T>
__device__ __forceinline__ void finish(const Params& p, float* block_sum, int total, int cols,
                                       int n0, int m0) {
  const int rank = blockIdx.x;
  const int n_split = gridDim.x;
  int first = 0, count = total;
  if (n_split > 1) {
    cluster_arrive();
    cluster_wait();
    const int per = (total + n_split - 1) / n_split;
    first = rank * per;
    count = max(0, min(per, total - first));
  } else {
    __syncthreads();
  }
  cg::cluster_group cluster = cg::this_cluster();
  for (int o = first + threadIdx.x; o < first + count; o += kThreads) {
    float sum = block_sum[o];
    if (n_split > 1) {
      sum = 0.f;
      for (int q = 0; q < n_split; ++q) sum += cluster.map_shared_rank(block_sum, q)[o];
    }
    const int r = o / cols;
    const int n = n0 + o % cols;
    if (n < p.n) {
      const float y = round_to(sum, T());
      const float s = __bfloat162float(p.s[n]);
      const size_t at = (size_t)(m0 + r) * p.n + n;
      if (p.out_f32) {
        static_cast<float*>(p.out)[at] = y * s;
      } else {
        T* out = static_cast<T*>(p.out);
        if constexpr (sizeof(T) == 2) {
          out[at] = __float2bfloat16(y * s);
        } else {
          out[at] = y * s;
        }
      }
    }
  }
  if (n_split > 1) {
    cluster_arrive();
    cluster_wait();
  }
}

// kRows: weight rows per thread (a power of two up to kMaxRows).
template <typename T, int kRows>
__global__ void __launch_bounds__(kThreads) int8_matmul_kernel(const Params p) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int kBlockK = kGroups * kRows;        // the block's share of K
  float* xs = reinterpret_cast<float*>(smem);     // [kRowsPerBlock][kBlockK]
  float* part = xs + kRowsPerBlock * kBlockK;     // [kWarps][kRowsPerBlock][kCols]
  float* block_sum = part + kPartFloats;          // [kRowsPerBlock][kCols], read by peers
  const int rank = blockIdx.x;
  const int n0 = blockIdx.y * kCols;
  const int m0 = blockIdx.z * kRowsPerBlock;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int lane_c = tid % kLanesPerRow;
  const int grp = tid / kLanesPerRow;
  const int col = n0 + lane_c * 16;
  const int kb0 = rank * kBlockK;
  const int k0 = kb0 + grp * kRows;
  const int rows = min(kRowsPerBlock, p.m - m0);
  const T* __restrict__ x = static_cast<const T*>(p.x);

  // Every weight load of the thread before any use (zeros past K or N),
  // then the block's rows of x into shared memory as f32 (zeros past K).
  uint4 wr[kRows];
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    wr[i] = make_uint4(0u, 0u, 0u, 0u);
    if (k0 + i < p.k && col < p.n) {
      wr[i] = *reinterpret_cast<const uint4*>(p.w + (size_t)(k0 + i) * p.n + col);
    }
  }
  for (int i = tid; i < rows * kBlockK; i += kThreads) {
    const int r = i / kBlockK;
    const int k = kb0 + i % kBlockK;
    xs[i] = k < p.k ? to_float(x[(size_t)(m0 + r) * p.k + k]) : 0.f;
  }
  __syncthreads();
  // Per row: the thread's rows in order; then the warp's 8 groups by a
  // fixed tree of shuffles that halves the columns a lane holds at each
  // level (16 -> 8 -> 4 -> 2), so each lane ends with 2 columns' sums;
  // then the block's 4 warps in order.
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
    *reinterpret_cast<float2*>(part + (warp * kRowsPerBlock + r) * kCols + col2) =
        make_float2(acc[0], acc[1]);
  }
  __syncthreads();
  for (int o = tid; o < rows * kCols; o += kThreads) {
    const int r = o / kCols;
    const int c = o % kCols;
    float sum = 0.f;
    for (int w = 0; w < kWarps; ++w) sum += part[(w * kRowsPerBlock + r) * kCols + c];
    block_sum[o] = sum;
  }
  finish<T>(p, block_sum, rows * kCols, kCols, n0, m0);
}

// bf16 activations: the products on the tensor cores. A block widens its
// [block_k x 64] int8 weight slice to bf16 (exact) in shared memory once
// and stages its rows of x beside it; warp w computes columns 16w..16w+15
// for all the block's rows over the block's K (mma.sync m16n8k16, f32 sums
// in K order); the cluster's ranks then sum in order as above. Rows past M
// are zeros: they change no row's sums, so a row's bits do not depend on M.
constexpr int kMmaCols = 64;  // output columns per block: 4 warps x 2 n8 tiles
constexpr int kMmaPad = 8;    // bf16 per row of padding (16 B)

// Shared bytes of the tensor-core kernel: the weight slice and x's rows,
// or the block's sums over them once the products are done.
int mma_smem_bytes(int block_k, int m_tiles) {
  const int staged = 2 * (block_k * (kMmaCols + kMmaPad) + 16 * m_tiles * (block_k + kMmaPad));
  const int sums = 4 * 16 * m_tiles * kMmaCols;
  return staged > sums ? staged : sums;
}

template <int kMTiles>  // m16 tiles of x a block
__global__ void __launch_bounds__(kThreads) int8_matmul_kernel_mma(const Params p) {
  const int block_k = p.block_k;
  extern __shared__ __align__(16) unsigned char smem[];
  const int ldw = kMmaCols + kMmaPad;
  const int ldx = block_k + kMmaPad;
  __nv_bfloat16* wt = reinterpret_cast<__nv_bfloat16*>(smem);  // [block_k][ldw]
  __nv_bfloat16* xs = wt + block_k * ldw;                        // [16 kMTiles][ldx]
  float* block_sum = reinterpret_cast<float*>(smem);             // [16 kMTiles][kMmaCols], later
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int n0 = blockIdx.y * kMmaCols;
  const int m0 = blockIdx.z * 16 * kMTiles;
  const int kb0 = blockIdx.x * block_k;
  const __nv_bfloat16* x = static_cast<const __nv_bfloat16*>(p.x);

  // The weight slice, 16 int8 columns a copy, widened exactly (zeros past
  // K or N); x's rows 8 values a copy (zeros past M or K).
  for (int i = tid; i < block_k * (kMmaCols / 16); i += kThreads) {
    const int kr = i / (kMmaCols / 16);
    const int c = (i - kr * (kMmaCols / 16)) * 16;
    uint4 raw = make_uint4(0u, 0u, 0u, 0u);
    if (kb0 + kr < p.k && n0 + c < p.n) {
      raw = *reinterpret_cast<const uint4*>(p.w + (size_t)(kb0 + kr) * p.n + n0 + c);
    }
    const uint32_t words[4] = {raw.x, raw.y, raw.z, raw.w};
    uint32_t packed[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const __nv_bfloat16 lo = __float2bfloat16(int8_at(words[j / 2], 2 * (j % 2)));
      const __nv_bfloat16 hi = __float2bfloat16(int8_at(words[j / 2], 2 * (j % 2) + 1));
      packed[j] = (uint32_t)(*reinterpret_cast<const uint16_t*>(&lo)) |
                  ((uint32_t)(*reinterpret_cast<const uint16_t*>(&hi)) << 16);
    }
    uint4* dst = reinterpret_cast<uint4*>(wt + (size_t)kr * ldw + c);
    dst[0] = make_uint4(packed[0], packed[1], packed[2], packed[3]);
    dst[1] = make_uint4(packed[4], packed[5], packed[6], packed[7]);
  }
  for (int i = tid; i < 16 * kMTiles * (block_k / 8); i += kThreads) {
    const int r = i / (block_k / 8);
    const int c = (i - r * (block_k / 8)) * 8;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (m0 + r < p.m && kb0 + c < p.k) {
      v = *reinterpret_cast<const uint4*>(x + (size_t)(m0 + r) * p.k + kb0 + c);
    }
    *reinterpret_cast<uint4*>(xs + (size_t)r * ldx + c) = v;
  }
  __syncthreads();
  float acc[kMTiles][2][4];
#pragma unroll
  for (int mt = 0; mt < kMTiles; ++mt) {
#pragma unroll
    for (int nt = 0; nt < 2; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0.f;
    }
  }
  for (int kk = 0; kk < block_k; kk += 16) {
    uint32_t bfr[4];
    ldsm_x4_trans(bfr, wt + (size_t)(kk + lane % 16) * ldw + warp * 16 + (lane / 16) * 8);
#pragma unroll
    for (int mt = 0; mt < kMTiles; ++mt) {
      uint32_t af[4];
      ldsm_x4(af, xs + (size_t)(mt * 16 + lane % 16) * ldx + kk + (lane / 16) * 8);
      mma_bf16(acc[mt][0], af, bfr);
      mma_bf16(acc[mt][1], af, bfr + 2);
    }
  }
  __syncthreads();  // the staged slices are read: the sums take their place
#pragma unroll
  for (int mt = 0; mt < kMTiles; ++mt) {
#pragma unroll
    for (int nt = 0; nt < 2; ++nt) {
      const int col = warp * 16 + nt * 8 + 2 * (lane % 4);
      const int row = mt * 16 + lane / 4;
      *reinterpret_cast<float2*>(block_sum + row * kMmaCols + col) =
          make_float2(acc[mt][nt][0], acc[mt][nt][1]);
      *reinterpret_cast<float2*>(block_sum + (row + 8) * kMmaCols + col) =
          make_float2(acc[mt][nt][2], acc[mt][nt][3]);
    }
  }
  const int rows = min(16 * kMTiles, p.m - m0);
  finish<__nv_bfloat16>(p, block_sum, rows * kMmaCols, kMmaCols, n0, m0);
}

// The split of K over a cluster and the rows per thread, from K alone: up to
// 8 ranks while each of a rank's 32 groups keeps at least 4 rows, then the
// rows per group that cover K (a power of two). Returns false past what one
// thread holds.
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

struct Args {
  Params p;
  int n_split;
  cudaStream_t stream;
};

template <typename T, int kRows>
cudaError_t launch(const Args& a) {
  auto kernel = int8_matmul_kernel<T, kRows>;
  const dim3 grid(a.n_split, (a.p.n + kCols - 1) / kCols,
                  (a.p.m + kRowsPerBlock - 1) / kRowsPerBlock);
  if (kSmemBytes > 48 * 1024) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
    if (err != cudaSuccess) return err;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = kSmemBytes;
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

template <int kMTiles>
cudaError_t launch_mma(const Args& a) {
  auto kernel = int8_matmul_kernel_mma<kMTiles>;
  const int smem = mma_smem_bytes(a.p.block_k, kMTiles);
  const dim3 grid(a.n_split, (a.p.n + kMmaCols - 1) / kMmaCols,
                  (a.p.m + 16 * kMTiles - 1) / (16 * kMTiles));
  if (grid.z > 65535) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         smem);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = a.stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = a.n_split;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kernel, a.p);
  return err != cudaSuccess ? err : cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_rows(int rows, const Args& a) {
  switch (rows) {
    case 1: return launch<T, 1>(a);
    case 2: return launch<T, 2>(a);
    case 4: return launch<T, 4>(a);
    case 8: return launch<T, 8>(a);
    case 16: return launch<T, 16>(a);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// The K split of one launch: cluster ranks and weight rows per thread.
// Returns a cudaError_t code.
extern "C" int qtts_int8_matmul_split(int k, int* n_split, int* rows) {
  return k > 0 && choose_split(k, n_split, rows) ? 0 : (int)cudaErrorInvalidValue;
}

// dtype: 0 = float32, 1 = bfloat16 (x, and out unless out_f32). x [m, k],
// w int8 [k, n] (n % 16 == 0, 16 B aligned), s bf16 [n], out [m, n].
// Returns a cudaError_t code (0 = success).
extern "C" int qtts_int8_matmul(const void* x, const void* w, const void* s, void* out,
                                int dtype, int out_f32, int m, int k, int n, void* stream) {
  int n_split = 0, rows = 0;
  if (m <= 0 || k <= 0 || n <= 0 || n % 16 != 0 || (long long)(m + kRowsPerBlock - 1) /
      kRowsPerBlock > 65535 || !choose_split(k, &n_split, &rows)) {
    return (int)cudaErrorInvalidValue;
  }
  // The tensor-core kernel: K in 16s on every rank.
  const int block_k = (k / 16 + n_split - 1) / n_split * 16;
  const Params p{x, static_cast<const int8_t*>(w), static_cast<const __nv_bfloat16*>(s), out,
                 m, k, n, out_f32, block_k};
  const Args a{p, n_split, static_cast<cudaStream_t>(stream)};
  switch (dtype) {
    case 0: return (int)dispatch_rows<float>(rows, a);
    case 1:
      // 4 m16 tiles a block once x has more than one.
      if (k % 16 != 0) return (int)cudaErrorInvalidValue;
      return (int)(m > 16 ? launch_mma<4>(a) : launch_mma<1>(a));
    default: return (int)cudaErrorInvalidValue;
  }
}
