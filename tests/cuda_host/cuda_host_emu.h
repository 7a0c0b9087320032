// Host emulation of the CUDA features that csrc/decode_attention.cu uses, so
// that the kernel's source compiles with g++ and runs on the CPU: one
// std::thread per CUDA thread, std::barrier for warps, blocks and clusters,
// shuffles through a warp's exchange slots, mma.sync m16n8k16 by its PTX
// fragment layouts, cp.async as a plain copy (a copy that lands early is one
// of the orders the card allows). The PTX helpers of the kernel are cut from
// its source and these take their place (tests/test_torch_attention_emulated.py).
#pragma once
#include <algorithm>
#include <barrier>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <memory>
#include <optional>
#include <thread>
#include <vector>
#include <type_traits>

#define __device__
#define __global__
#define __host__
#define __forceinline__ inline
#define __launch_bounds__(...)
#define __restrict__ __restrict
#define __align__(n)

using std::max;
using std::min;

struct dim3 { unsigned x = 1, y = 1, z = 1; dim3() {} dim3(unsigned a, unsigned b = 1, unsigned c = 1) : x(a), y(b), z(c) {} };
struct uint2 { uint32_t x, y; };
struct uint4 { uint32_t x, y, z, w; };
struct float2 { float x, y; };
struct float4 { float x, y, z, w; };
inline uint2 make_uint2(uint32_t a, uint32_t b) { return {a, b}; }
inline uint4 make_uint4(uint32_t a, uint32_t b, uint32_t c, uint32_t d) { return {a, b, c, d}; }
inline float2 make_float2(float a, float b) { return {a, b}; }

typedef int cudaError_t;
enum { cudaSuccess = 0, cudaErrorInvalidValue = 1 };
typedef void* cudaStream_t;

inline float __uint_as_float(uint32_t u) { float f; memcpy(&f, &u, 4); return f; }
inline uint32_t __float_as_uint(float f) { uint32_t u; memcpy(&u, &f, 4); return u; }
inline uint32_t __byte_perm(uint32_t x, uint32_t y, uint32_t s) {
  uint8_t b[8];
  memcpy(b, &x, 4);
  memcpy(b + 4, &y, 4);
  uint32_t r = 0;
  for (int i = 0; i < 4; ++i) r |= (uint32_t)b[(s >> (4 * i)) & 7] << (8 * i);
  return r;
}

struct __nv_bfloat16 { uint16_t bits; };
struct __nv_bfloat162 { __nv_bfloat16 x, y; };
inline __nv_bfloat16 __float2bfloat16(float f) {
  uint32_t u = __float_as_uint(f);
  if (std::isnan(f)) return {(uint16_t)0x7fc0};
  u += 0x7fff + ((u >> 16) & 1);
  return {(uint16_t)(u >> 16)};
}
inline float __bfloat162float(__nv_bfloat16 h) { return __uint_as_float((uint32_t)h.bits << 16); }
inline __nv_bfloat162 __floats2bfloat162_rn(float a, float b) { return {__float2bfloat16(a), __float2bfloat16(b)}; }
inline float2 __bfloat1622float2(__nv_bfloat162 h) { return {__bfloat162float(h.x), __bfloat162float(h.y)}; }

namespace emu {
struct Warp {
  std::barrier<> bar{32};
  uint32_t xch[32];
  uint32_t a[32][4], b[32][2];
  float d[32][4];
};
struct Block {
  std::barrier<> bar{128};
  Warp warps[4];
  std::vector<unsigned char> smem;
};
struct Cluster {
  std::unique_ptr<std::barrier<>> bar;
  std::vector<unsigned char*> smem;
};
struct Tls {
  dim3 thread_idx, block_idx, grid_dim;
  int lane, warp;
  Warp* w;
  Block* blk;
  Cluster* cl;
  unsigned char* smem;
  std::optional<std::barrier<>::arrival_token> token;
};
inline thread_local Tls tls;
}  // namespace emu

#define threadIdx (emu::tls.thread_idx)
#define blockIdx (emu::tls.block_idx)
#define gridDim (emu::tls.grid_dim)

inline void __syncwarp(unsigned = 0xffffffffu) { emu::tls.w->bar.arrive_and_wait(); }
inline void __syncthreads() { emu::tls.blk->bar.arrive_and_wait(); }
template <typename V>
inline V __shfl_xor_sync(unsigned, V v, int off) {
  static_assert(sizeof(V) == 4, "32-bit shuffles");
  auto& w = *emu::tls.w;
  uint32_t u;
  memcpy(&u, &v, 4);
  w.xch[emu::tls.lane] = u;
  w.bar.arrive_and_wait();
  u = w.xch[emu::tls.lane ^ off];
  w.bar.arrive_and_wait();
  memcpy(&v, &u, 4);
  return v;
}

// The helpers written in PTX in the kernel.
inline void cp_async16(void* dst, const void* src) { memcpy(dst, src, 16); }
inline void cp_async4(void* dst, const void* src) { memcpy(dst, src, 4); }
inline void cp_async_commit() {}
template <int N>
inline void cp_async_wait() {}
inline void cluster_arrive_relaxed() {
  if (emu::tls.token) abort();
  emu::tls.token.emplace(emu::tls.cl->bar->arrive());
}
inline void cluster_arrive() { cluster_arrive_relaxed(); }
inline void cluster_wait() {
  if (!emu::tls.token) abort();
  emu::tls.cl->bar->wait(std::move(*emu::tls.token));
  emu::tls.token.reset();
}
inline float bf(uint32_t w, int hi) { return __uint_as_float(hi ? (w & 0xffff0000u) : (w << 16)); }
// m16n8k16 row.col bf16 -> f32, per the PTX fragment layouts.
inline void mma_bf16(float* d, const uint32_t* a, const uint32_t* b) {
  auto& w = *emu::tls.w;
  const int l = emu::tls.lane;
  for (int i = 0; i < 4; ++i) w.a[l][i] = a[i];
  for (int i = 0; i < 2; ++i) w.b[l][i] = b[i];
  w.bar.arrive_and_wait();
  float A[16][16], B[16][8];
  for (int ln = 0; ln < 32; ++ln) {
    const int g = ln / 4, t = ln % 4;
    for (int h = 0; h < 2; ++h) {
      A[g][2 * t + h] = bf(w.a[ln][0], h);
      A[g + 8][2 * t + h] = bf(w.a[ln][1], h);
      A[g][2 * t + 8 + h] = bf(w.a[ln][2], h);
      A[g + 8][2 * t + 8 + h] = bf(w.a[ln][3], h);
      B[2 * t + h][g] = bf(w.b[ln][0], h);
      B[2 * t + 8 + h][g] = bf(w.b[ln][1], h);
    }
  }
  w.bar.arrive_and_wait();
  const int g = l / 4, t = l % 4;
  const int rows[4] = {g, g, g + 8, g + 8}, cols[4] = {2 * t, 2 * t + 1, 2 * t, 2 * t + 1};
  for (int i = 0; i < 4; ++i) {
    double s = d[i];
    for (int k = 0; k < 16; ++k) s += (double)A[rows[i]][k] * B[k][cols[i]];
    d[i] = (float)s;
  }
}

namespace cooperative_groups {
struct cluster_group {
  template <typename P>
  P* map_shared_rank(P* p, int r) const {
    auto off = reinterpret_cast<unsigned char*>(p) - emu::tls.smem;
    return reinterpret_cast<P*>(emu::tls.cl->smem[r] + off);
  }
};
inline cluster_group this_cluster() { return {}; }
}  // namespace cooperative_groups

namespace emu {
// Runs kernel over the grid, one cluster (grid.x blocks) at a time.
template <typename K, typename P>
int run(K kernel, dim3 grid, int smem_bytes, const P& prm) {
  for (unsigned z = 0; z < grid.z; ++z) {
    for (unsigned y = 0; y < grid.y; ++y) {
      Cluster cl;
      cl.bar = std::make_unique<std::barrier<>>(grid.x * 128);
      std::vector<std::unique_ptr<Block>> blocks;
      for (unsigned x = 0; x < grid.x; ++x) {
        blocks.push_back(std::make_unique<Block>());
        blocks.back()->smem.assign(smem_bytes, 0xff);  // stale bits: NaN patterns
        cl.smem.push_back(blocks.back()->smem.data());
      }
      std::vector<std::thread> threads;
      for (unsigned x = 0; x < grid.x; ++x) {
        for (int t = 0; t < 128; ++t) {
          threads.emplace_back([&, x, t]() {
            tls.thread_idx = dim3(t);
            tls.block_idx = dim3(x, y, z);
            tls.grid_dim = grid;
            tls.lane = t % 32;
            tls.warp = t / 32;
            tls.blk = blocks[x].get();
            tls.w = &blocks[x]->warps[t / 32];
            tls.cl = &cl;
            tls.smem = blocks[x]->smem.data();
            kernel(prm);
          });
        }
      }
      for (auto& th : threads) th.join();
    }
  }
  return 0;
}
}  // namespace emu
