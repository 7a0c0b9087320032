// Single-token GQA decode attention for Hopper (sm_90a).
//
// Replaces the TPU kernel qwen_tts_tpu/ops/pallas/decode_attention.py
// (`pallas_attention_decode_step`, body `_kernel`): one new query token per
// batch row attends over that row's fixed-shape KV cache [S_max, KV, hd],
// restricted to positions [valid_from, cur_len) and to an optional sliding
// window (pos >= cur_len - window).
//
// Bound: bytes. The work is 4 flops per cached element read, far below the
// card's ~20 flops/byte f32 ridge, so the least time is
// B * n_valid * KV * hd * 2 * sizeof(T) over 3.35 TB/s. At the main path's
// caches (talker ~100 positions, sub-talker <= 16) that is well under a
// microsecond, so launch latency bounds it in practice.
//
// Design, where the Pallas kernel stages the whole cache and masks it:
//   * one block per (batch row, KV head); the G = H / KV queries of that head
//     are loaded once into registers (lane l holds dims l, l+32, ...);
//   * the loop runs over the valid range only, so masked positions are
//     skipped rather than multiplied by zero;
//   * each warp takes every kWarps-th position and keeps an online softmax
//     (running max and sum, f32) per query; each K/V row is read once for all
//     G queries, a warp-wide coalesced load;
//   * the warps merge through shared memory at the end;
//   * `window` is a runtime int (a large sentinel means "no window"), so the
//     per-layer window of the trunk needs no recompile.
// A fully masked row (never on the main path) keeps the reference semantics:
// every score is the -1e9 fill, so the softmax is uniform over S_max.
//
// The launch goes on the caller's stream, allocates nothing and returns
// cudaGetLastError(); the Python wrapper raises on a non-zero code.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 4;
constexpr float kMaskedScore = -1e9f;

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
  for (int offset = 16; offset > 0; offset >>= 1) {
    x += __shfl_xor_sync(0xffffffffu, x, offset);
  }
  return x;
}

template <typename T, int HD, int G>
__global__ void __launch_bounds__(kWarps * 32)
decode_attention_kernel(const T* __restrict__ q,          // [B, KV*G, HD]
                        const T* __restrict__ k_cache,    // [B, S_max, KV, HD]
                        const T* __restrict__ v_cache,    // [B, S_max, KV, HD]
                        const int32_t* __restrict__ cur_len,     // [B]
                        const int32_t* __restrict__ valid_from,  // [B]
                        T* __restrict__ out,              // [B, KV*G, HD]
                        int s_max, int kv_heads, int window, float scale) {
  constexpr int kPerLane = HD / 32;
  const int b = blockIdx.x;
  const int kvh = blockIdx.y;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int heads = kv_heads * G;
  const size_t q_base = ((size_t)b * heads + (size_t)kvh * G) * HD;

  float qr[G][kPerLane];
#pragma unroll
  for (int g = 0; g < G; ++g) {
#pragma unroll
    for (int e = 0; e < kPerLane; ++e) {
      qr[g][e] = to_float(q[q_base + (size_t)g * HD + e * 32 + lane]);
    }
  }

  // Valid range: [max(valid_from, cur_len - window, 0), min(cur_len, S_max)).
  const int len = cur_len[b];
  const int hi_valid = min(len, s_max);
  const long long window_lo = (long long)len - (long long)window;
  int lo = max(valid_from[b], 0);
  if (window_lo > lo) lo = (int)window_lo;
  const bool empty = lo >= hi_valid;
  const int hi = empty ? s_max : hi_valid;
  if (empty) lo = 0;

  float m[G], l[G], acc[G][kPerLane];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    m[g] = -INFINITY;
    l[g] = 0.f;
#pragma unroll
    for (int e = 0; e < kPerLane; ++e) acc[g][e] = 0.f;
  }

  for (int j = lo + warp; j < hi; j += kWarps) {
    const size_t row = (((size_t)b * s_max + j) * kv_heads + kvh) * HD;
    float kr[kPerLane], vr[kPerLane];
#pragma unroll
    for (int e = 0; e < kPerLane; ++e) {
      kr[e] = to_float(k_cache[row + e * 32 + lane]);
      vr[e] = to_float(v_cache[row + e * 32 + lane]);
    }
#pragma unroll
    for (int g = 0; g < G; ++g) {
      float s = 0.f;
#pragma unroll
      for (int e = 0; e < kPerLane; ++e) s += qr[g][e] * kr[e];
      s = empty ? kMaskedScore : warp_sum(s) * scale;
      const float m_new = fmaxf(m[g], s);
      const float correction = expf(m[g] - m_new);
      const float p = expf(s - m_new);
      l[g] = l[g] * correction + p;
#pragma unroll
      for (int e = 0; e < kPerLane; ++e) acc[g][e] = acc[g][e] * correction + p * vr[e];
      m[g] = m_new;
    }
  }

  __shared__ float sm_m[kWarps][G];
  __shared__ float sm_l[kWarps][G];
  __shared__ float sm_acc[kWarps][G][HD];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    if (lane == 0) {
      sm_m[warp][g] = m[g];
      sm_l[warp][g] = l[g];
    }
#pragma unroll
    for (int e = 0; e < kPerLane; ++e) sm_acc[warp][g][e * 32 + lane] = acc[g][e];
  }
  __syncthreads();

  for (int idx = threadIdx.x; idx < G * HD; idx += kWarps * 32) {
    const int g = idx / HD;
    const int d = idx % HD;
    float m_all = -INFINITY;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) m_all = fmaxf(m_all, sm_m[w][g]);
    float l_all = 0.f, o = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float c = expf(sm_m[w][g] - m_all);  // 0 for a warp that saw no position
      l_all += sm_l[w][g] * c;
      o += sm_acc[w][g][d] * c;
    }
    out[q_base + (size_t)g * HD + d] = from_float<T>(o / l_all);
  }
}

template <typename T, int HD, int G>
cudaError_t launch(const void* q, const void* k, const void* v, const void* cur_len,
                   const void* valid_from, void* out, int batch, int kv_heads, int s_max,
                   int window, float scale, cudaStream_t stream) {
  dim3 grid(batch, kv_heads);
  decode_attention_kernel<T, HD, G><<<grid, kWarps * 32, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const int32_t*>(cur_len), static_cast<const int32_t*>(valid_from),
      static_cast<T*>(out), s_max, kv_heads, window, scale);
  return cudaGetLastError();
}

template <typename T, int HD>
cudaError_t dispatch_groups(int groups, const void* q, const void* k, const void* v,
                            const void* cur_len, const void* valid_from, void* out, int batch,
                            int kv_heads, int s_max, int window, float scale,
                            cudaStream_t stream) {
  switch (groups) {
    case 1: return launch<T, HD, 1>(q, k, v, cur_len, valid_from, out, batch, kv_heads, s_max, window, scale, stream);
    case 2: return launch<T, HD, 2>(q, k, v, cur_len, valid_from, out, batch, kv_heads, s_max, window, scale, stream);
    case 4: return launch<T, HD, 4>(q, k, v, cur_len, valid_from, out, batch, kv_heads, s_max, window, scale, stream);
    case 8: return launch<T, HD, 8>(q, k, v, cur_len, valid_from, out, batch, kv_heads, s_max, window, scale, stream);
    case 16: return launch<T, HD, 16>(q, k, v, cur_len, valid_from, out, batch, kv_heads, s_max, window, scale, stream);
    default: return cudaErrorInvalidValue;
  }
}

template <typename T>
cudaError_t dispatch_head_dim(int head_dim, int groups, const void* q, const void* k,
                              const void* v, const void* cur_len, const void* valid_from,
                              void* out, int batch, int kv_heads, int s_max, int window,
                              float scale, cudaStream_t stream) {
  switch (head_dim) {
    case 64: return dispatch_groups<T, 64>(groups, q, k, v, cur_len, valid_from, out, batch, kv_heads, s_max, window, scale, stream);
    case 128: return dispatch_groups<T, 128>(groups, q, k, v, cur_len, valid_from, out, batch, kv_heads, s_max, window, scale, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. Returns a cudaError_t code (0 = success).
extern "C" int qtts_decode_attention(const void* q, const void* k_cache, const void* v_cache,
                                     const void* cur_len, const void* valid_from, void* out,
                                     int dtype, int batch, int heads, int kv_heads,
                                     int head_dim, int s_max, int window, float scale,
                                     void* stream) {
  if (batch <= 0 || kv_heads <= 0 || s_max <= 0 || heads % kv_heads != 0) {
    return (int)cudaErrorInvalidValue;
  }
  const int groups = heads / kv_heads;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return (int)dispatch_head_dim<float>(head_dim, groups, q, k_cache, v_cache, cur_len, valid_from, out, batch, kv_heads, s_max, window, scale, s);
    case 1: return (int)dispatch_head_dim<__nv_bfloat16>(head_dim, groups, q, k_cache, v_cache, cur_len, valid_from, out, batch, kv_heads, s_max, window, scale, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
