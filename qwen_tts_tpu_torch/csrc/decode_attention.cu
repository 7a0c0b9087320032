// Single-token GQA decode attention for Hopper (sm_90a).
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
// card's ~20 flops/byte f32 ridge, so the least time is
// B * n_valid * KV * (hd * 2 * sizeof(cache element) + scales) over
// 3.35 TB/s. At the main path's caches (talker ~100 positions, sub-talker
// <= 16) that is well under a microsecond, so launch latency bounds it in
// practice.
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

#include <type_traits>

namespace {

constexpr int kWarps = 4;
constexpr float kMaskedScore = -1e9f;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_float(int8_t x) { return static_cast<float>(x); }

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

// C is the cache element: T, or int8_t with per-(token, head) f32 scales
// k_scale / v_scale [B, S_max, KV] (unused, null, for a float cache).
template <typename T, typename C, int HD, int G>
__global__ void __launch_bounds__(kWarps * 32)
decode_attention_kernel(const T* __restrict__ q,          // [B, KV*G, HD]
                        const C* __restrict__ k_cache,    // [B, S_max, KV, HD]
                        const C* __restrict__ v_cache,    // [B, S_max, KV, HD]
                        const float* __restrict__ k_scale,  // [B, S_max, KV] (int8)
                        const float* __restrict__ v_scale,
                        const int32_t* __restrict__ cur_len,     // [B]
                        const int32_t* __restrict__ valid_from,  // [B]
                        T* __restrict__ out,              // [B, KV*G, HD]
                        int s_max, int kv_heads, int window, float scale) {
  constexpr bool kInt8 = std::is_same<C, int8_t>::value;
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
    const size_t token = ((size_t)b * s_max + j) * kv_heads + kvh;
    const size_t row = token * HD;
    float kr[kPerLane], vr[kPerLane];
#pragma unroll
    for (int e = 0; e < kPerLane; ++e) {
      kr[e] = to_float(k_cache[row + e * 32 + lane]);
      vr[e] = to_float(v_cache[row + e * 32 + lane]);
    }
    float k_s = 1.f, v_s = 1.f;
    if constexpr (kInt8) {
      k_s = k_scale[token];
      v_s = v_scale[token];
    }
#pragma unroll
    for (int g = 0; g < G; ++g) {
      float s = 0.f;
#pragma unroll
      for (int e = 0; e < kPerLane; ++e) s += qr[g][e] * kr[e];
      s = empty ? kMaskedScore : warp_sum(s) * scale * k_s;
      const float m_new = fmaxf(m[g], s);
      const float correction = expf(m[g] - m_new);
      const float p = expf(s - m_new);
      const float pv = p * v_s;
      l[g] = l[g] * correction + p;
#pragma unroll
      for (int e = 0; e < kPerLane; ++e) acc[g][e] = acc[g][e] * correction + pv * vr[e];
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

// Pointers of one call, passed down the dispatch.
struct Args {
  const void* q;
  const void* k;
  const void* v;
  const float* k_scale;
  const float* v_scale;
  const int32_t* cur_len;
  const int32_t* valid_from;
  void* out;
  int batch, kv_heads, s_max, window;
  float scale;
  cudaStream_t stream;
};

template <typename T, typename C, int HD, int G>
cudaError_t launch(const Args& a) {
  dim3 grid(a.batch, a.kv_heads);
  decode_attention_kernel<T, C, HD, G><<<grid, kWarps * 32, 0, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const C*>(a.k), static_cast<const C*>(a.v),
      a.k_scale, a.v_scale, a.cur_len, a.valid_from, static_cast<T*>(a.out), a.s_max,
      a.kv_heads, a.window, a.scale);
  return cudaGetLastError();
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
  if (a.batch <= 0 || a.kv_heads <= 0 || a.s_max <= 0 || heads % a.kv_heads != 0) {
    return (int)cudaErrorInvalidValue;
  }
  const int groups = heads / a.kv_heads;
  switch (dtype * 2 + (int8_cache ? 1 : 0)) {
    case 0: return (int)dispatch_head_dim<float, float>(head_dim, groups, a);
    case 1: return (int)dispatch_head_dim<float, int8_t>(head_dim, groups, a);
    case 2: return (int)dispatch_head_dim<__nv_bfloat16, __nv_bfloat16>(head_dim, groups, a);
    case 3: return (int)dispatch_head_dim<__nv_bfloat16, int8_t>(head_dim, groups, a);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (q, out and the cache). Returns a
// cudaError_t code (0 = success).
extern "C" int qtts_decode_attention(const void* q, const void* k_cache, const void* v_cache,
                                     const void* cur_len, const void* valid_from, void* out,
                                     int dtype, int batch, int heads, int kv_heads,
                                     int head_dim, int s_max, int window, float scale,
                                     void* stream) {
  const Args a{q, k_cache, v_cache, nullptr, nullptr,
               static_cast<const int32_t*>(cur_len), static_cast<const int32_t*>(valid_from),
               out, batch, kv_heads, s_max, window, scale, static_cast<cudaStream_t>(stream)};
  return dispatch(dtype, false, heads, head_dim, a);
}

// The int8 dict cache: k_i8 / v_i8 int8 [B, S_max, KV, hd], k_s / v_s f32
// [B, S_max, KV]; dtype is that of q and out.
extern "C" int qtts_decode_attention_int8(const void* q, const void* k_i8, const void* k_s,
                                          const void* v_i8, const void* v_s,
                                          const void* cur_len, const void* valid_from,
                                          void* out, int dtype, int batch, int heads,
                                          int kv_heads, int head_dim, int s_max, int window,
                                          float scale, void* stream) {
  const Args a{q, k_i8, v_i8, static_cast<const float*>(k_s), static_cast<const float*>(v_s),
               static_cast<const int32_t*>(cur_len), static_cast<const int32_t*>(valid_from),
               out, batch, kv_heads, s_max, window, scale, static_cast<cudaStream_t>(stream)};
  return dispatch(dtype, true, heads, head_dim, a);
}
