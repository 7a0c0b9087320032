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
// once: 23.5 us at 3.35 TB/s. The products, 2 x 78.6 M x B flops, stay under
// that line at bf16 tensor-core rates for any B here; this first kernel does
// them with f32 FMAs on the CUDA cores, which still keeps B <= 8 under the
// byte time.
//
// Design. Every phase needs the whole previous vector, so the launch is
// cooperative (all blocks co-resident) with a grid-wide barrier between
// phases; the f32 residual and all intermediates live in a global scratch
// buffer (L2-resident), not in shared memory. Per layer:
//   1. each block recomputes the row norms of h it needs; GEMV units of
//      (128 columns x 32 weight rows) over [Wq|Wk|Wv] write f32 partial sums;
//   2. one block per (row, KV head): sum the partials, scale, QK-norm + RoPE,
//      write the K/V row, __syncthreads, then attention for the head's 2
//      queries over positions 0..pos -- the row it just wrote included;
//   3. o-proj GEMV units; 4. residual += scale x sum of partials;
//   5. row norms + [gate|up] GEMV units; 6. down GEMV units, each building
//      its SwiGLU input slice from the gate/up partials; 7. residual.
// A GEMV unit is one warp: lane l owns 4 adjacent columns (one 4-byte load
// per weight row, 128 bytes per warp), the unit's x slice [B, 32] is staged
// in the warp's shared memory, int8 -> f32 conversion happens in registers,
// and the sums run over the unit's 32 rows in a fixed order, so the result
// does not depend on the schedule. Partials are reduced in a fixed order by
// their consumer: no atomics, the same bits every run. One block per SM and
// 32-row units ran faster on the H100 than two blocks per SM and 64-row
// units: the barriers cost less, and more warps stream weights (PERF.md).
//
// The launch goes on the caller's stream, allocates nothing (the wrapper
// passes the scratch) and returns the CUDA error code.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace cg = cooperative_groups;

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
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kKC = 32;                 // weight rows per GEMV unit
constexpr int kTile = 128;              // columns per GEMV unit (32 lanes x 4)
// Partial sums per output element (the number of k slices).
constexpr int kSplitQKV = kD / kKC;     // 32
constexpr int kSplitO = kNQ / kKC;      // 64
constexpr int kSplitGU = kD / kKC;      // 32
constexpr int kSplitDown = kI / kKC;    // 96
constexpr float kScale = 0.08838834764831845f;  // hd ** -0.5

// Scratch floats per batch row: h32 [D], partials A [32 x 6144] (Q/K/V,
// o-proj and gate/up take turns), partials B [96 x D] (down), attn [2048].
constexpr int kPartA = kSplitGU * kNGU;  // >= kSplitQKV * kNQKV, kSplitO * kD
constexpr int kPartB = kSplitDown * kD;
constexpr int kScratchPerRow = kD + kPartA + kPartB + kNQ;

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

// A value rounded to T and read back: where the TPU kernel casts to its dtype.
template <typename T>
__device__ __forceinline__ float round_to(float x) { return to_float(from_float<T>(x)); }

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int offset = 16; offset > 0; offset >>= 1) x += __shfl_xor_sync(0xffffffffu, x, offset);
  return x;
}

template <typename T>
struct Params {
  const T* x;  // [B, D]
  const float* cos;  // [hd] for this position
  const float* sin;
  const int8_t* wqkv;  // [L, D, 4096]: q | k | v columns
  const float* qkv_s;  // [L, 4096]
  const int8_t* wo;    // [L, 2048, D]
  const float* wo_s;   // [L, D]
  const int8_t* wgu;   // [L, D, 6144]: gate | up columns
  const float* gu_s;   // [L, 6144]
  const int8_t* wdown;  // [L, I, D]
  const float* down_s;  // [L, D]
  const T* in_norm;     // [L, D]
  const T* post_norm;   // [L, D]
  const T* q_norm;      // [L, hd]
  const T* k_norm;      // [L, hd]
  T* k_cache;           // [L, B, G, KV, hd]
  T* v_cache;
  T* out;      // [B, D]
  float* h32;  // scratch, see kScratchPerRow
  float* part_a;
  float* part_b;
  float* attn;
  int batch, groups, pos;
  float eps;
};

enum Source { kFromNorm, kFromAttn, kFromSwiGLU };

// The residual entering this phase: the input x in layer 0's first half.
template <typename T>
__device__ __forceinline__ float h_in(const Params<T>& p, bool from_x, int idx) {
  return from_x ? to_float(p.x[idx]) : p.h32[idx];
}

// 1 / rms of each row of h into rstd[B] (every block computes all rows).
template <typename T>
__device__ void row_rstd(const Params<T>& p, bool from_x, float* rstd) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int b = warp; b < p.batch; b += kWarps) {
    float ss = 0.f;
    for (int n = lane; n < kD; n += 32) {
      const float v = h_in(p, from_x, b * kD + n);
      ss += v * v;
    }
    ss = warp_sum(ss);
    if (lane == 0) rstd[b] = 1.f / sqrtf(ss / kD + p.eps);
  }
  __syncthreads();
}

// The unit's input slice x[b, k0 .. k0 + kKC) for every row, into the warp's
// shared memory (rows >= B are zero).
template <typename T, int BP>
__device__ void stage_x(const Params<T>& p, int l, Source src, bool from_x, const T* norm_w,
                        const float* rstd, int k0, float* xs) {
  const int lane = threadIdx.x % 32;
  for (int idx = lane; idx < BP * kKC; idx += 32) {
    const int b = idx / kKC, k = k0 + idx % kKC;
    float v = 0.f;
    if (b < p.batch) {
      if (src == kFromNorm) {  // RMSNorm: normed -> T, x weight -> T
        v = round_to<T>(round_to<T>(h_in(p, from_x, b * kD + k) * rstd[b]) * to_float(norm_w[k]));
      } else if (src == kFromAttn) {
        v = p.attn[b * kNQ + k];
      } else {  // SwiGLU of the gate/up partials, in f32, -> T
        float g = 0.f, u = 0.f;
        for (int s = 0; s < kSplitGU; ++s) {
          const float* row = p.part_a + ((size_t)s * p.batch + b) * kNGU;
          g += row[k];
          u += row[kI + k];
        }
        g *= p.gu_s[l * kNGU + k];
        u *= p.gu_s[l * kNGU + kI + k];
        v = round_to<T>(g / (1.f + expf(-g)) * u);
      }
    }
    xs[idx] = v;
  }
  __syncwarp();
}

// part[s, b, n] = sum over the kKC rows of slice s of x[b, k] * W[k, n] for the
// int8 weight W [K, N] of one layer; units spread over every warp of the grid.
template <typename T, int BP>
__device__ void gemv(const Params<T>& p, int l, Source src, bool from_x,
                     const int8_t* __restrict__ w, int K, int N, const T* norm_w,
                     const float* rstd, float* part, float* xs_all) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  float* xs = xs_all + warp * BP * kKC;
  const int tiles = N / kTile;
  const int units = tiles * (K / kKC);
  for (int u = blockIdx.x * kWarps + warp; u < units; u += gridDim.x * kWarps) {
    const int tile = u % tiles, split = u / tiles;
    const int k0 = split * kKC, n = tile * kTile + 4 * lane;
    stage_x<T, BP>(p, l, src, from_x, norm_w, rstd, k0, xs);

    float acc[BP][4];
#pragma unroll
    for (int b = 0; b < BP; ++b) {
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[b][c] = 0.f;
    }
    const int8_t* wp = w + (size_t)k0 * N + n;
#pragma unroll
    for (int kk = 0; kk < kKC; kk += 4) {
      float wf[4][4];
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const char4 wr = __ldg(reinterpret_cast<const char4*>(wp + (size_t)(kk + r) * N));
        wf[r][0] = wr.x;
        wf[r][1] = wr.y;
        wf[r][2] = wr.z;
        wf[r][3] = wr.w;
      }
#pragma unroll
      for (int b = 0; b < BP; ++b) {
        const float4 xv = *reinterpret_cast<const float4*>(xs + b * kKC + kk);
        const float xr[4] = {xv.x, xv.y, xv.z, xv.w};
#pragma unroll
        for (int r = 0; r < 4; ++r) {
#pragma unroll
          for (int c = 0; c < 4; ++c) acc[b][c] = fmaf(xr[r], wf[r][c], acc[b][c]);
        }
      }
    }
#pragma unroll
    for (int b = 0; b < BP; ++b) {
      if (b < p.batch) {
        *reinterpret_cast<float4*>(part + ((size_t)split * p.batch + b) * N + n) =
            make_float4(acc[b][0], acc[b][1], acc[b][2], acc[b][3]);
      }
    }
    __syncwarp();  // xs is restaged by the next unit
  }
}

// h = h_in + scale[n] * (sum of the partials), and the output after the last layer.
template <typename T>
__device__ void residual(const Params<T>& p, bool from_x, const float* part, int splits,
                         const float* scale, bool last) {
  const int total = p.batch * kD;
  for (int idx = blockIdx.x * kThreads + threadIdx.x; idx < total; idx += gridDim.x * kThreads) {
    const int b = idx / kD, n = idx % kD;
    float acc = 0.f;
    for (int s = 0; s < splits; ++s) acc += part[((size_t)s * p.batch + b) * kD + n];
    const float h = h_in(p, from_x, idx) + acc * scale[n];
    p.h32[idx] = h;
    if (last) p.out[idx] = from_float<T>(h);
  }
}

struct AttnSmem {
  float vec[kGrp + 2][kHD];  // the head's queries, then k, then v (scaled sums)
  float q[kGrp][kHD];        // QK-normed, rotated queries, rounded to T
  float score[kGrp][kMaxGroups];
};

// Phase 2: one block per (row, KV head).
template <typename T>
__device__ void attention(const Params<T>& p, int l, AttnSmem& sm) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const float* qkv_s = p.qkv_s + (size_t)l * kNQKV;
  for (int unit = blockIdx.x; unit < p.batch * kKV; unit += gridDim.x) {
    const int b = unit / kKV, kvh = unit % kKV;
    for (int idx = threadIdx.x; idx < (kGrp + 2) * kHD; idx += kThreads) {
      const int which = idx / kHD, d = idx % kHD;
      const int col = which < kGrp ? (kvh * kGrp + which) * kHD + d
                                   : kNQ + (which - kGrp) * kNKV + kvh * kHD + d;
      float acc = 0.f;
      for (int s = 0; s < kSplitQKV; ++s) acc += p.part_a[((size_t)s * p.batch + b) * kNQKV + col];
      sm.vec[which][d] = acc * qkv_s[col];
    }
    __syncthreads();

    // Cache row of (l, b, position j, kvh), in elements.
    const size_t row0 = (((size_t)l * p.batch + b) * p.groups) * kKV + kvh;
    auto row = [&](int j) { return (row0 + (size_t)j * kKV) * kHD; };
    if (warp <= kGrp) {  // warps 0..kGrp-1: the queries; warp kGrp: k
      const bool is_k = warp == kGrp;
      const T* norm_w = (is_k ? p.k_norm : p.q_norm) + l * kHD;
      float v[4], n[4], ss = 0.f;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        v[e] = sm.vec[warp][lane + 32 * e];
        ss += v[e] * v[e];
      }
      const float r = 1.f / sqrtf(warp_sum(ss) / kHD + p.eps);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        n[e] = round_to<T>(round_to<T>(v[e] * r) * to_float(norm_w[lane + 32 * e]));
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) {  // rotate-half: dims d and d +- 64 share a lane
        const int d = lane + 32 * e;
        const float rot = e < 2 ? -n[e + 2] : n[e - 2];
        const float o = n[e] * p.cos[d] + rot * p.sin[d];
        if (is_k) {
          p.k_cache[row(p.pos) + d] = from_float<T>(o);
        } else {
          sm.q[warp][d] = round_to<T>(o);
        }
      }
    } else if (warp == kGrp + 1) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int d = lane + 32 * e;
        p.v_cache[row(p.pos) + d] = from_float<T>(sm.vec[kGrp + 1][d]);
      }
    }
    __syncthreads();  // the new K/V row is written before it is read

    if (warp < kGrp) {
      float m = -INFINITY;
      for (int j = 0; j <= p.pos; ++j) {
        const T* k = p.k_cache + row(j);
        float dot = 0.f;
#pragma unroll
        for (int e = 0; e < 4; ++e) dot += sm.q[warp][lane + 32 * e] * to_float(k[lane + 32 * e]);
        const float s = warp_sum(dot) * kScale;
        if (lane == 0) sm.score[warp][j] = s;
        m = fmaxf(m, s);
      }
      __syncwarp();
      float sum = 0.f;
      for (int j = 0; j <= p.pos; ++j) sum += expf(sm.score[warp][j] - m);
      float o[4] = {0.f, 0.f, 0.f, 0.f};
      for (int j = 0; j <= p.pos; ++j) {
        const float pj = round_to<T>(expf(sm.score[warp][j] - m) / sum);
        const T* v = p.v_cache + row(j);
#pragma unroll
        for (int e = 0; e < 4; ++e) o[e] += pj * to_float(v[lane + 32 * e]);
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        p.attn[b * kNQ + (kvh * kGrp + warp) * kHD + lane + 32 * e] = round_to<T>(o[e]);
      }
    }
    __syncthreads();  // shared memory is reused by the next unit
  }
}

template <typename T, int BP>
__global__ void __launch_bounds__(kThreads, BP >= 16 ? 1 : 2)
subtalker_step_kernel(const Params<T> p) {
  extern __shared__ float4 dynamic_smem[];
  float* xs = reinterpret_cast<float*>(dynamic_smem);  // [kWarps][BP][kKC]
  __shared__ float rstd[kMaxBatch];
  __shared__ AttnSmem att;
  cg::grid_group grid = cg::this_grid();

  for (int l = 0; l < kLayers; ++l) {
    const bool first = l == 0;
    // 1. input RMSNorm, Q/K/V projection -> partials A.
    row_rstd(p, first, rstd);
    gemv<T, BP>(p, l, kFromNorm, first, p.wqkv + (size_t)l * kD * kNQKV, kD, kNQKV,
                p.in_norm + l * kD, rstd, p.part_a, xs);
    grid.sync();
    // 2. QK-norm + RoPE, K/V row append, attention -> attn.
    attention(p, l, att);
    grid.sync();
    // 3. o-proj -> partials A.
    gemv<T, BP>(p, l, kFromAttn, false, p.wo + (size_t)l * kNQ * kD, kNQ, kD, nullptr,
                nullptr, p.part_a, xs);
    grid.sync();
    // 4. residual.
    residual(p, first, p.part_a, kSplitO, p.wo_s + l * kD, false);
    grid.sync();
    // 5. post-attention RMSNorm, gate|up projection -> partials A.
    row_rstd(p, false, rstd);
    gemv<T, BP>(p, l, kFromNorm, false, p.wgu + (size_t)l * kD * kNGU, kD, kNGU,
                p.post_norm + l * kD, rstd, p.part_a, xs);
    grid.sync();
    // 6. SwiGLU + down projection -> partials B.
    gemv<T, BP>(p, l, kFromSwiGLU, false, p.wdown + (size_t)l * kI * kD, kI, kD, nullptr,
                nullptr, p.part_b, xs);
    grid.sync();
    // 7. residual; the output after the last layer.
    residual(p, false, p.part_b, kSplitDown, p.down_s + l * kD, l == kLayers - 1);
    if (l + 1 < kLayers) grid.sync();
  }
}

struct LaunchShape {
  int grid = 0;
  size_t smem = 0;
};

// Grid: one block per SM (a cooperative launch needs all blocks resident).
// Worked out once per instantiation.
template <typename T, int BP>
cudaError_t launch_shape(LaunchShape* shape) {
  static LaunchShape cached;
  if (cached.grid == 0) {
    const size_t smem = (size_t)kWarps * BP * kKC * sizeof(float);
    auto kernel = subtalker_step_kernel<T, BP>;
    cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
    if (e != cudaSuccess) return e;
    int dev = 0, sms = 0, per_sm = 0;  // per_sm only checks that one fits
    if ((e = cudaGetDevice(&dev)) != cudaSuccess) return e;
    if ((e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess) {
      return e;
    }
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, smem);
    if (e != cudaSuccess) return e;
    if (per_sm < 1) return cudaErrorInvalidConfiguration;
    cached.smem = smem;
    cached.grid = sms;
  }
  *shape = cached;
  return cudaSuccess;
}

template <typename T, int BP>
cudaError_t launch(const Params<T>& p, cudaStream_t stream) {
  LaunchShape shape;
  cudaError_t e = launch_shape<T, BP>(&shape);
  if (e != cudaSuccess) return e;
  void* args[] = {const_cast<Params<T>*>(&p)};
  e = cudaLaunchCooperativeKernel(reinterpret_cast<void*>(subtalker_step_kernel<T, BP>),
                                  dim3(shape.grid), dim3(kThreads), args, shape.smem, stream);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_batch(const Params<T>& p, cudaStream_t stream) {
  if (p.batch <= 4) return launch<T, 4>(p, stream);
  if (p.batch <= 8) return launch<T, 8>(p, stream);
  if (p.batch <= 16) return launch<T, 16>(p, stream);
  return launch<T, 32>(p, stream);
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
  float* s = static_cast<float*>(scratch);
  p.h32 = s;
  p.part_a = p.h32 + (size_t)batch * kD;
  p.part_b = p.part_a + (size_t)batch * kPartA;
  p.attn = p.part_b + (size_t)batch * kPartB;
  p.batch = batch;
  p.groups = groups;
  p.pos = pos;
  p.eps = eps;
  return (int)dispatch_batch(p, stream);
}

}  // namespace

// Floats of scratch the wrapper allocates for `batch` rows.
extern "C" long long qtts_subtalker_step_scratch_floats(int batch) {
  return (long long)batch * kScratchPerRow;
}

// The launch shape for (dtype, batch): grid blocks, threads, dynamic shared bytes.
extern "C" int qtts_subtalker_step_launch_shape(int dtype, int batch, int* grid, int* threads,
                                                int* smem) {
  LaunchShape shape;
  cudaError_t e = cudaErrorInvalidValue;
  const int bp = batch <= 4 ? 4 : batch <= 8 ? 8 : batch <= 16 ? 16 : 32;
  if (dtype == 0) {
    e = bp == 4 ? launch_shape<float, 4>(&shape) : bp == 8 ? launch_shape<float, 8>(&shape)
        : bp == 16 ? launch_shape<float, 16>(&shape) : launch_shape<float, 32>(&shape);
  } else if (dtype == 1) {
    e = bp == 4 ? launch_shape<__nv_bfloat16, 4>(&shape)
        : bp == 8 ? launch_shape<__nv_bfloat16, 8>(&shape)
        : bp == 16 ? launch_shape<__nv_bfloat16, 16>(&shape)
        : launch_shape<__nv_bfloat16, 32>(&shape);
  }
  *grid = shape.grid;
  *threads = kThreads;
  *smem = (int)shape.smem;
  return (int)e;
}

// dtype: 0 = float32, 1 = bfloat16 (x, out, the norms and the caches).
// Returns a cudaError_t code (0 = success).
extern "C" int qtts_subtalker_step(
    const void* x, const void* cos, const void* sin, const void* wqkv, const void* qkv_s,
    const void* wo, const void* wo_s, const void* wgu, const void* gu_s, const void* wdown,
    const void* down_s, const void* in_norm, const void* post_norm, const void* q_norm,
    const void* k_norm, void* k_cache, void* v_cache, void* out, void* scratch, int dtype,
    int batch, int groups, int pos, float eps, void* stream) {
  if (batch < 1 || batch > kMaxBatch || groups < 1 || groups > kMaxGroups || pos < 0 ||
      pos >= groups) {
    return (int)cudaErrorInvalidValue;
  }
  const void* ptrs[] = {x, cos, sin, wqkv, qkv_s, wo, wo_s, wgu, gu_s, wdown, down_s,
                        in_norm, post_norm, q_norm, k_norm, k_cache, v_cache, out};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return run<float>(ptrs, batch, groups, pos, eps, scratch, s);
    case 1: return run<__nv_bfloat16>(ptrs, batch, groups, pos, eps, scratch, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
