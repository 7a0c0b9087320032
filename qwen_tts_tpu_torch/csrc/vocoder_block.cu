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
// (bf16, widened to f32) and rounds once to bf16; the residual add is bf16 + bf16 -> bf16. The
// snake repeats ops/snake.py's polynomial sin^2 step by step with
// round-to-nearest intrinsics (no fused multiply-adds, true division by
// beta + 1e-9, rintf's round-half-to-even), so its bits equal PyTorch's.
//
// Bound: bf16 tensor-core operations. Per output row the block does
// 2 * (2 * C_in * C_out + 3 * (K + 1) * C_out^2) flops and moves
// 2 * (C_in / s + C_out) bytes: ~4000 flops per byte for the codec's blocks
// 2 (384 -> 192, s = 4) and 3 (192 -> 96, s = 3) at K = 7, far above the
// card's ~295.
// An unfused chain would write every intermediate to device memory and read
// it back (17 round trips per block); here the block's activations never
// leave shared memory.
//
// Design:
//   * one CTA (8 warps) per (batch row, output tile of t_tile rows). It
//     computes l_ext = t_tile + halo extended rows and writes the last
//     t_tile. The halo covers the residual chain's receptive field,
//     (K - 1) * (1 + 3 + 9) rows (78 at K = 7, 26 at K = 3), rounded up to a
//     multiple of s so that every tile starts on an input row. The ragged
//     last tile is masked on store.
//   * shared memory holds the block's activations in bf16: the residual
//     stream h [l_ext, C_out], the snake of h [l_ext, C_out] right after it
//     (so the dilated conv's taps before row 0 read h's last rows: garbage
//     that only reaches halo rows, never out of bounds), and the first
//     conv's snaked output [l_ext, C_out], which before the transposed conv
//     holds the snaked input rows [l_ext / s + 1, C_in]. l_ext is the largest
//     multiple of lcm(16, s) that fits the card's 227 KB: at K = 7, 192 rows
//     for block 2 (halo 80: 42% of the rows are recomputed halo) and 384 for
//     block 3 (halo 78: 20%). Keeping only a slice of the first conv's output
//     would fit longer tiles.
//   * every conv is a GEMM on the tensor cores through WMMA (m16n16k16 bf16,
//     f32 accumulators). The transposed conv splits into s phases: output row
//     q*s + p = x[q] W'[2s-1-p] + x[q-1] W'[s-1-p], where the loader's
//     flipped-tap layout is W'[j, i, o] = W_torch[i, o, K-1-j]. A warp
//     computes up to 4 row tiles x 1 column tile, so each weight fragment,
//     read through L2 (2.1 MB for block 2, 0.44 MB for block 3), serves 4
//     products. Each warp rounds its accumulators through a 1 KB staging
//     tile in shared memory, where the epilogue (bias, rounding, snake,
//     residual add) runs.
//   * causal zeros: rows whose global index is < 0 are set to exact zeros
//     after the transposed conv and after each unit, and input rows outside
//     [0, T_in) are zeros, so the convs see the reference's zero padding.
// Later work: wgmma with TMA and a pipelined weight ring. A 2-frame first
// packet at B = 1 gives block 3 only 11 CTAs for 132 SMs.
//
// The launch goes on the caller's stream, allocates nothing and returns
// cudaGetLastError(); the Python wrapper raises on a non-zero code.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

namespace {

using namespace nvcuda;

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kFrag = 16;            // WMMA m = n = k
constexpr int kRowTiles = 4;         // row tiles per warp item (weight fragment reuse)
constexpr int kUnits = 3;
constexpr int kMaxCIn = 384;
constexpr int kMaxRows = 1024;       // cap on l_ext
constexpr int kMaxTaps = 16;         // residual conv taps
constexpr int kStageFloats = kFrag * kFrag;
constexpr int kVecPerUnit = 6;       // alpha1, beta1, conv1 bias, alpha2, beta2, conv2 bias

constexpr float kPi = 3.141592653589793f;
constexpr float kInvPi = 0.3183098861837907f;
constexpr float kHalfPi = 1.5707964f;
constexpr float kS3 = -1.0f / 6.0f;
constexpr float kS5 = 1.0f / 120.0f;
constexpr float kS7 = -1.0f / 5040.0f;
constexpr float kS9 = 1.0f / 362880.0f;
constexpr float kNoDivByZero = 1e-9f;

using FragA = wmma::fragment<wmma::matrix_a, kFrag, kFrag, kFrag, __nv_bfloat16, wmma::row_major>;
using FragB = wmma::fragment<wmma::matrix_b, kFrag, kFrag, kFrag, __nv_bfloat16, wmma::row_major>;
using FragC = wmma::fragment<wmma::accumulator, kFrag, kFrag, kFrag, float>;

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
  int l_ext, halo;        // extended rows, left halo
  int m_pad;              // transposed-conv rows per phase (l_ext / s), rounded up to 16
  int region;             // elements of the shared region of c1 / the snaked input
};

// ops/snake.py for bf16 activations, one rounding per operation.
__device__ __forceinline__ float snake(float x, float alpha, float beta) {
  const float u = __fmul_rn(x, alpha);
  float r = __fsub_rn(u, __fmul_rn(kPi, rintf(__fmul_rn(u, kInvPi))));
  r = fminf(fmaxf(r, -kHalfPi), kHalfPi);
  const float r2 = __fmul_rn(r, r);
  float poly = __fadd_rn(kS7, __fmul_rn(r2, kS9));
  poly = __fadd_rn(kS5, __fmul_rn(r2, poly));
  poly = __fadd_rn(kS3, __fmul_rn(r2, poly));
  poly = __fadd_rn(1.0f, __fmul_rn(r2, poly));
  const float s = __fmul_rn(r, poly);
  return __fadd_rn(x, __fdiv_rn(__fmul_rn(s, s), __fadd_rn(beta, kNoDivByZero)));
}

__device__ __forceinline__ float bf(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ __nv_bfloat16 rb(float v) { return __float2bfloat16_rn(v); }

// 8 bf16 values as one 16-byte word.
union Pack8 {
  uint4 word;
  __nv_bfloat16 v[8];
};

// acc[i] += A[rows of tile i] @ W for kk over k_tiles 16-wide steps. A is
// row-major with lda; W row-major [K, C_out] with ldw, already offset to the
// item's column tile.
__device__ __forceinline__ void gemm_tiles(FragC (&acc)[kRowTiles], int count,
                                           const __nv_bfloat16* a, int lda,
                                           const __nv_bfloat16* w, int ldw, int k_tiles) {
  for (int kk = 0; kk < k_tiles; ++kk) {
    FragB b;
    wmma::load_matrix_sync(b, w + (size_t)kk * kFrag * ldw, ldw);
#pragma unroll
    for (int i = 0; i < kRowTiles; ++i) {
      if (i < count) {
        FragA fa;
        wmma::load_matrix_sync(fa, a + (size_t)i * kFrag * lda + kk * kFrag, lda);
        wmma::mma_sync(acc[i], fa, b, acc[i]);
      }
    }
  }
}

__global__ void __launch_bounds__(kThreads, 1) vocoder_block_kernel(const Params p) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int C = p.c_out;
  const int L = p.l_ext;
  __nv_bfloat16* hb = reinterpret_cast<__nv_bfloat16*>(smem);   // [L, C]
  __nv_bfloat16* act0 = hb + (size_t)L * C;                       // [L, C]
  __nv_bfloat16* c1 = act0 + (size_t)L * C;                       // [L, C]
  __nv_bfloat16* xs = c1;                                         // [m_pad + 1, C_in]
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  float* stage = reinterpret_cast<float*>(c1 + p.region) + warp * kStageFloats;

  const int b = blockIdx.y;
  const int t_tile = L - p.halo;
  const int t_out = p.t_in * p.rate;
  const int e0 = (int)blockIdx.x * t_tile - p.halo;  // global row of extended row 0
  const int q0 = e0 / p.rate;                         // exact: e0 is a multiple of s
  const int n_tiles = C / kFrag;
  // Epilogue mapping of a 16 x 16 staging tile: lane -> row, 8 columns.
  const int e_row = lane >> 1;
  const int e_col = (lane & 1) * 8;

  // ---- snake the input rows ----
  const int cin8 = p.c_in / 8;
  for (int i = threadIdx.x; i < (p.m_pad + 1) * cin8; i += kThreads) {
    const int j = i / cin8;
    const int c = (i - j * cin8) * 8;
    const int q = q0 - 1 + j;  // xs row j holds input row q0 - 1 + j
    Pack8 in, o;
    if (q >= 0 && q < p.t_in) {
      in.word = *reinterpret_cast<const uint4*>(p.x + ((size_t)b * p.t_in + q) * p.c_in + c);
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        o.v[e] = rb(snake(bf(in.v[e]), bf(p.alpha[c + e]), bf(p.beta[c + e])));
      }
    } else {
      o.word = make_uint4(0u, 0u, 0u, 0u);  // the conv's zero padding
    }
    *reinterpret_cast<uint4*>(xs + (size_t)j * p.c_in + c) = o.word;
  }
  __syncthreads();

  // ---- transposed conv, phase by phase: extended row r = i * s + phase ----
  {
    const int m_tiles = p.m_pad / kFrag;
    const int m_groups = (m_tiles + kRowTiles - 1) / kRowTiles;
    const int items = p.rate * m_groups * n_tiles;
    for (int item = warp; item < items; item += kWarps) {
      const int nt = item % n_tiles;
      const int mg = (item / n_tiles) % m_groups;
      const int phase = item / (n_tiles * m_groups);
      const int mt0 = mg * kRowTiles;
      const int count = min(kRowTiles, m_tiles - mt0);
      FragC acc[kRowTiles];
#pragma unroll
      for (int i = 0; i < kRowTiles; ++i) wmma::fill_fragment(acc[i], 0.f);
      for (int tap = 0; tap < 2; ++tap) {
        // tap 0: x[q] (xs row i + 1) with W'[2s-1-p]; tap 1: x[q-1] (xs row i) with W'[s-1-p].
        const int j = 2 * p.rate - 1 - phase - tap * p.rate;
        gemm_tiles(acc, count, xs + (size_t)(mt0 * kFrag + 1 - tap) * p.c_in, p.c_in,
                   p.tconv_w + (size_t)j * p.c_in * C + nt * kFrag, C, p.c_in / kFrag);
      }
      const int n = nt * kFrag + e_col;
#pragma unroll
      for (int i = 0; i < kRowTiles; ++i) {
        if (i < count) {
          wmma::store_matrix_sync(stage, acc[i], kFrag, wmma::mem_row_major);
          __syncwarp();
          const int r = ((mt0 + i) * kFrag + e_row) * p.rate + phase;
          if (r < L) {
            const bool before_start = e0 + r < 0;
            Pack8 o;
#pragma unroll
            for (int e = 0; e < 8; ++e) {
              o.v[e] = before_start ? rb(0.f)
                                    : rb(stage[e_row * kFrag + e_col + e] + bf(p.tconv_b[n + e]));
            }
            *reinterpret_cast<uint4*>(hb + (size_t)r * C + n) = o.word;
          }
          __syncwarp();
        }
      }
    }
  }
  __syncthreads();

  // ---- three residual units ----
  const int m_tiles = L / kFrag;
  const int m_groups = (m_tiles + kRowTiles - 1) / kRowTiles;
  const int items = m_groups * n_tiles;
  const int c8 = C / 8;
  for (int u = 0; u < kUnits; ++u) {
    const int d = p.dil[u];
    const __nv_bfloat16* alpha1 = p.unit_vec[u][0];
    const __nv_bfloat16* beta1 = p.unit_vec[u][1];
    const __nv_bfloat16* bias1 = p.unit_vec[u][2];
    const __nv_bfloat16* alpha2 = p.unit_vec[u][3];
    const __nv_bfloat16* beta2 = p.unit_vec[u][4];
    const __nv_bfloat16* bias2 = p.unit_vec[u][5];

    // act = snake(h)
    for (int i = threadIdx.x; i < L * c8; i += kThreads) {
      const int c = (i % c8) * 8;
      Pack8 in, o;
      in.word = *reinterpret_cast<const uint4*>(hb + (size_t)i * 8);
#pragma unroll
      for (int e = 0; e < 8; ++e) o.v[e] = rb(snake(bf(in.v[e]), bf(alpha1[c + e]), bf(beta1[c + e])));
      *reinterpret_cast<uint4*>(act0 + (size_t)i * 8) = o.word;
    }
    __syncthreads();

    // c1 = snake(convK_d(act) + bias1): tap j reads row r - (K-1-j) d.
    for (int item = warp; item < items; item += kWarps) {
      const int nt = item % n_tiles;
      const int mt0 = (item / n_tiles) * kRowTiles;
      const int count = min(kRowTiles, m_tiles - mt0);
      FragC acc[kRowTiles];
#pragma unroll
      for (int i = 0; i < kRowTiles; ++i) wmma::fill_fragment(acc[i], 0.f);
      for (int tap = 0; tap < p.taps; ++tap) {
        const int row0 = mt0 * kFrag - (p.taps - 1 - tap) * d;  // >= -L: inside hb
        gemm_tiles(acc, count, act0 + (ptrdiff_t)row0 * C, C,
                   p.w1[u] + (size_t)tap * C * C + nt * kFrag, C, C / kFrag);
      }
      const int n = nt * kFrag + e_col;
#pragma unroll
      for (int i = 0; i < kRowTiles; ++i) {
        if (i < count) {
          wmma::store_matrix_sync(stage, acc[i], kFrag, wmma::mem_row_major);
          __syncwarp();
          const int r = (mt0 + i) * kFrag + e_row;
          Pack8 o;
#pragma unroll
          for (int e = 0; e < 8; ++e) {
            const float v = bf(rb(stage[e_row * kFrag + e_col + e] + bf(bias1[n + e])));
            o.v[e] = rb(snake(v, bf(alpha2[n + e]), bf(beta2[n + e])));
          }
          *reinterpret_cast<uint4*>(c1 + (size_t)r * C + n) = o.word;
          __syncwarp();
        }
      }
    }
    __syncthreads();

    // h = h + (c1 @ W2 + bias2), rows before t = 0 back to zero.
    for (int item = warp; item < items; item += kWarps) {
      const int nt = item % n_tiles;
      const int mt0 = (item / n_tiles) * kRowTiles;
      const int count = min(kRowTiles, m_tiles - mt0);
      FragC acc[kRowTiles];
#pragma unroll
      for (int i = 0; i < kRowTiles; ++i) wmma::fill_fragment(acc[i], 0.f);
      gemm_tiles(acc, count, c1 + (size_t)mt0 * kFrag * C, C, p.w2[u] + nt * kFrag, C,
                 C / kFrag);
      const int n = nt * kFrag + e_col;
#pragma unroll
      for (int i = 0; i < kRowTiles; ++i) {
        if (i < count) {
          wmma::store_matrix_sync(stage, acc[i], kFrag, wmma::mem_row_major);
          __syncwarp();
          const int r = (mt0 + i) * kFrag + e_row;
          const bool before_start = e0 + r < 0;
          Pack8 h, o;
          h.word = *reinterpret_cast<const uint4*>(hb + (size_t)r * C + n);
#pragma unroll
          for (int e = 0; e < 8; ++e) {
            const float c = bf(rb(stage[e_row * kFrag + e_col + e] + bf(bias2[n + e])));
            o.v[e] = before_start ? rb(0.f) : rb(bf(h.v[e]) + c);
          }
          *reinterpret_cast<uint4*>(hb + (size_t)r * C + n) = o.word;
          __syncwarp();
        }
      }
    }
    __syncthreads();
  }

  // ---- write the tile's t_tile rows (the ragged last tile masked) ----
  for (int i = threadIdx.x; i < t_tile * c8; i += kThreads) {
    const int r = p.halo + i / c8;
    const int c = (i % c8) * 8;
    const int t = e0 + r;
    if (t < t_out) {
      *reinterpret_cast<uint4*>(p.out + ((size_t)b * t_out + t) * C + c) =
          *reinterpret_cast<const uint4*>(hb + (size_t)r * C + c);
    }
  }
}

int gcd(int a, int b) { return b == 0 ? a : gcd(b, a % b); }

// The tile of one geometry: the largest l_ext (a multiple of lcm(16, s),
// at most kMaxRows) whose shared memory fits max_smem. The halo (>= the
// receptive field, >= the deepest tap's reach) keeps every tap read inside
// the snake buffer or h before it. Returns false if no l_ext fits.
bool choose_tile(Params* p, int max_smem, int* smem_bytes) {
  int dsum = 0;
  for (int u = 0; u < kUnits; ++u) dsum += p->dil[u];
  const int reach = (p->taps - 1) * dsum;
  p->halo = (reach + p->rate - 1) / p->rate * p->rate;
  const int step = kFrag / gcd(kFrag, p->rate) * p->rate;
  for (int l = kMaxRows / step * step; l > p->halo; l -= step) {
    const int m_pad = (l / p->rate + kFrag - 1) / kFrag * kFrag;
    const int xs = (m_pad + 1) * p->c_in;
    const int region = l * p->c_out > xs ? l * p->c_out : xs;
    const int bytes = 2 * (2 * l * p->c_out + region) +
                      kWarps * kStageFloats * (int)sizeof(float);
    if (bytes <= max_smem) {
      p->l_ext = l;
      p->m_pad = m_pad;
      p->region = region;
      *smem_bytes = bytes;
      return true;
    }
  }
  return false;
}

bool geometry_ok(int c_in, int c_out, int rate, int taps, const int* dil) {
  if (c_in <= 0 || c_out <= 0 || c_in % kFrag || c_out % kFrag || c_in > kMaxCIn) return false;
  if (rate < 1 || taps < 1 || taps > kMaxTaps) return false;
  for (int u = 0; u < kUnits; ++u) {
    if (dil[u] < 1) return false;
  }
  return true;
}

int max_shared_bytes() {
  int device = 0, bytes = 0;
  if (cudaGetDevice(&device) != cudaSuccess) return 0;
  if (cudaDeviceGetAttribute(&bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin, device) !=
      cudaSuccess) {
    return 0;
  }
  return bytes;
}

}  // namespace

// The tile the kernel takes for one geometry on the current card: extended
// rows, halo and dynamic shared bytes. Returns a cudaError_t code.
extern "C" int qtts_vocoder_block_tile(int c_in, int c_out, int rate, int taps, int d0,
                                       int d1, int d2, int* l_ext, int* halo,
                                       int* smem_bytes) {
  Params p{};
  p.c_in = c_in;
  p.c_out = c_out;
  p.rate = rate;
  p.taps = taps;
  p.dil[0] = d0;
  p.dil[1] = d1;
  p.dil[2] = d2;
  if (!geometry_ok(c_in, c_out, rate, taps, p.dil)) return (int)cudaErrorInvalidValue;
  if (!choose_tile(&p, max_shared_bytes(), smem_bytes)) return (int)cudaErrorInvalidValue;
  *l_ext = p.l_ext;
  *halo = p.halo;
  return 0;
}

// x bf16 [B, T_in, C_in] -> out bf16 [B, T_in * rate, C_out]. ``weights``
// and ``vectors`` are host arrays of device pointers, all bf16 (see Params):
// weights tconv_w, w1[0..2], w2[0..2]; vectors alpha, beta, tconv_b, then per
// unit alpha1, beta1, conv1 bias, alpha2, beta2, conv2 bias. taps is K of the
// residual units' dilated convs. Returns a cudaError_t code.
extern "C" int qtts_vocoder_block(const void* x, void* out, const void* const* weights,
                                  const void* const* vectors, int batch, int t_in, int c_in,
                                  int c_out, int rate, int taps, int d0, int d1, int d2,
                                  void* stream) {
  using bf16p = const __nv_bfloat16*;
  Params p{};
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
  p.dil[0] = d0;
  p.dil[1] = d1;
  p.dil[2] = d2;
  p.t_in = t_in;
  p.c_in = c_in;
  p.c_out = c_out;
  p.rate = rate;
  p.taps = taps;
  if (batch <= 0 || t_in <= 0 || batch > 65535 ||
      !geometry_ok(c_in, c_out, rate, taps, p.dil)) {
    return (int)cudaErrorInvalidValue;
  }
  int smem = 0;
  if (!choose_tile(&p, max_shared_bytes(), &smem)) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(vocoder_block_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const int t_tile = p.l_ext - p.halo;
  const long long t_out = (long long)t_in * rate;
  const dim3 grid((unsigned)((t_out + t_tile - 1) / t_tile), (unsigned)batch);
  vocoder_block_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(p);
  return (int)cudaGetLastError();
}
