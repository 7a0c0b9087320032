// Host emulation of the CUDA features that the kernels of csrc/ use, so
// that a kernel's source compiles with g++ and runs on the CPU: one
// std::thread per CUDA thread, std::barrier for warps, blocks and clusters,
// shuffles through a warp's exchange slots, mma.sync m16n8k16 by its PTX
// fragment layouts, cp.async as a plain copy (a copy that lands early is one
// of the orders the card allows), ldmatrix by its fragment layouts, mbarriers
// with transaction bytes and st.async into a peer's shared memory. The PTX
// helpers of a kernel are cut from its source and these take their place
// (tests/torch_port_fixtures.py: host_source).
#pragma once
#include <algorithm>
#include <atomic>
#include <barrier>
#include <chrono>
#include <cmath>
#include <condition_variable>
#include <cstdint>
#include <cstring>
#include <map>
#include <memory>
#include <mutex>
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
inline float4 make_float4(float a, float b, float c, float d) { return {a, b, c, d}; }

typedef int cudaError_t;
enum { cudaSuccess = 0, cudaErrorInvalidValue = 1 };
typedef void* cudaStream_t;
enum cudaDeviceAttr { cudaDevAttrMaxSharedMemoryPerBlockOptin, cudaDevAttrMultiProcessorCount };

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
inline __nv_bfloat16 __float2bfloat16_rn(float f) { return __float2bfloat16(f); }
inline float __fmul_rn(float a, float b) { return a * b; }
inline float __fadd_rn(float a, float b) { return a + b; }
inline float __fsub_rn(float a, float b) { return a - b; }
inline float __fdiv_rn(float a, float b) { return a / b; }
inline float __frcp_rn(float a) { return 1.0f / a; }
inline float __fmaf_rn(float a, float b, float c) { return std::fma(a, b, c); }
using std::rintf;
using std::fminf;
using std::fmaxf;
inline __nv_bfloat162 __floats2bfloat162_rn(float a, float b) { return {__float2bfloat16(a), __float2bfloat16(b)}; }
inline float2 __bfloat1622float2(__nv_bfloat162 h) { return {__bfloat162float(h.x), __bfloat162float(h.y)}; }

namespace emu {
// A warp's exchange slots, two sets: a collective (shuffle, ldmatrix, mma)
// writes the set of its parity, meets the warp at one barrier and reads it.
// A lane writes a set again two collectives later, after every lane has
// passed the barrier of the one between, so every read of it is done.
struct Exchange {
  uint32_t xch[32];
  uint32_t a[32][4], b[32][2];
  const void* addr[32];
};
struct Warp {
  std::barrier<> bar{32};
  Exchange x[2];
};
struct Block {
  explicit Block(int threads) : bar(threads), warps(new Warp[threads / 32]) {}
  std::barrier<> bar;
  std::unique_ptr<Warp[]> warps;
  std::vector<unsigned char> smem;
};
// What cudaDeviceGetAttribute reports (a test may set the SM count).
inline int sm_count = 132;
inline int max_smem_optin = 232448;
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
  unsigned collectives;  // the warp collectives this lane has run
};
inline thread_local Tls tls;
// The exchange set of this lane's next warp collective.
inline Exchange& exchange() { return tls.w->x[tls.collectives++ & 1]; }
}  // namespace emu

#define threadIdx (emu::tls.thread_idx)
#define blockIdx (emu::tls.block_idx)
#define gridDim (emu::tls.grid_dim)

inline void __syncwarp(unsigned = 0xffffffffu) { emu::tls.w->bar.arrive_and_wait(); }
inline void __syncthreads() { emu::tls.blk->bar.arrive_and_wait(); }
template <typename V>
inline V __shfl_xor_sync(unsigned, V v, int off) {
  static_assert(sizeof(V) == 4, "32-bit shuffles");
  auto& x = emu::exchange();
  uint32_t u;
  memcpy(&u, &v, 4);
  x.xch[emu::tls.lane] = u;
  emu::tls.w->bar.arrive_and_wait();
  u = x.xch[emu::tls.lane ^ off];
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
// m16n8k16 row.col bf16 -> f32, per the PTX fragment layouts. Lane l holds
// D rows g and g + 8, columns 2t and 2t + 1 (g = l / 4, t = l % 4): it reads
// those two rows of A from lanes 4g..4g+3 and those two columns of B from
// lanes 2t*4.. (column n of B lives in lanes 4n..4n+3).
inline void mma_bf16(float* d, const uint32_t* a, const uint32_t* b) {
  auto& x = emu::exchange();
  const int l = emu::tls.lane;
  for (int i = 0; i < 4; ++i) x.a[l][i] = a[i];
  for (int i = 0; i < 2; ++i) x.b[l][i] = b[i];
  emu::tls.w->bar.arrive_and_wait();
  const int g = l / 4, t = l % 4;
  float A[2][16], B[16][2];
  for (int tt = 0; tt < 4; ++tt) {
    const int ln = 4 * g + tt;  // A rows g and g + 8, columns 2tt, 2tt + 1, + 8
    for (int h = 0; h < 2; ++h) {
      A[0][2 * tt + h] = bf(x.a[ln][0], h);
      A[1][2 * tt + h] = bf(x.a[ln][1], h);
      A[0][2 * tt + 8 + h] = bf(x.a[ln][2], h);
      A[1][2 * tt + 8 + h] = bf(x.a[ln][3], h);
    }
    for (int c = 0; c < 2; ++c) {  // B columns 2t and 2t + 1, rows 2tt, 2tt + 1, + 8
      const int lb = 4 * (2 * t + c) + tt;
      for (int h = 0; h < 2; ++h) {
        B[2 * tt + h][c] = bf(x.b[lb][0], h);
        B[2 * tt + 8 + h][c] = bf(x.b[lb][1], h);
      }
    }
  }
  for (int i = 0; i < 4; ++i) {
    double s = d[i];
    for (int k = 0; k < 16; ++k) s += (double)A[i / 2][k] * B[k][i % 2];
    d[i] = (float)s;
  }
}

// ldmatrix .x4 (and .trans): lane l gives the address of row l % 8 of
// matrix l / 8; register i of lane l takes matrix i's row l / 4, columns
// 2 (l % 4) and + 1 (transposed: rows 2 (l % 4) and + 1 of column l / 4).
inline void ldsm_x4_any(uint32_t* r, const void* p, bool trans) {
  auto& x = emu::exchange();
  const int l = emu::tls.lane;
  x.addr[l] = p;
  emu::tls.w->bar.arrive_and_wait();
  for (int i = 0; i < 4; ++i) {
    uint16_t lo, hi;
    if (trans) {
      lo = static_cast<const uint16_t*>(x.addr[8 * i + 2 * (l % 4)])[l / 4];
      hi = static_cast<const uint16_t*>(x.addr[8 * i + 2 * (l % 4) + 1])[l / 4];
    } else {
      const uint16_t* row = static_cast<const uint16_t*>(x.addr[8 * i + l / 4]);
      lo = row[2 * (l % 4)];
      hi = row[2 * (l % 4) + 1];
    }
    r[i] = (uint32_t)lo | (uint32_t)hi << 16;
  }
}
inline void ldsm_x4(uint32_t* r, const void* p) { ldsm_x4_any(r, p, false); }
inline void ldsm_x4_trans(uint32_t* r, const void* p) { ldsm_x4_any(r, p, true); }

// Loads and stamps: a weight load is a plain copy.
inline uint2 load_weight8(const int8_t* p) {
  uint2 v;
  memcpy(&v, p, 8);
  return v;
}
inline void __threadfence_block() { std::atomic_thread_fence(std::memory_order_seq_cst); }
inline uint64_t global_ns() {
  return (uint64_t)std::chrono::duration_cast<std::chrono::nanoseconds>(
             std::chrono::steady_clock::now().time_since_epoch()).count();
}

// mbarriers: a table keyed by the barrier's address in the emulated shared
// memory, under one lock. A phase completes when its pending arrivals and
// its transaction bytes both reach 0; the bytes may be counted down before
// they are expected, as on the card. A waiter sleeps on the barrier's
// condition variable, notified where a phase completes.
namespace emu {
struct Mbar {
  int count = 0, pending = 0;
  long long tx = 0;
  uint32_t phase = 0;
  std::condition_variable cv;
};
inline std::mutex mbar_lock;
inline std::map<const void*, Mbar> mbars;
inline void mbar_settle(Mbar& b) {
  if (b.pending == 0 && b.tx == 0) {
    b.phase ^= 1;
    b.pending = b.count;
    b.cv.notify_all();
  }
}
}  // namespace emu
inline void mbar_init(uint64_t* bar, uint32_t count) {
  std::lock_guard<std::mutex> g(emu::mbar_lock);
  emu::Mbar& b = emu::mbars[bar];
  b.count = b.pending = (int)count;
  b.tx = 0;
  b.phase = 0;
}
inline void fence_mbarrier_init() {}
inline void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  std::lock_guard<std::mutex> g(emu::mbar_lock);
  emu::Mbar& b = emu::mbars.at(bar);
  b.tx += bytes;
  b.pending -= 1;
  emu::mbar_settle(b);
}
inline void mbar_wait(uint64_t* bar, uint32_t parity) {
  std::unique_lock<std::mutex> g(emu::mbar_lock);
  emu::Mbar& b = emu::mbars.at(bar);
  b.cv.wait(g, [&] { return b.phase != parity; });
}
// st.async into a peer's shared memory: the copy, then its bytes counted
// on the peer's barrier.
inline void push_async(float* slot, uint64_t* bar, int rank, float4 v) {
  unsigned char* peer = emu::tls.cl->smem[rank];
  memcpy(peer + (reinterpret_cast<unsigned char*>(slot) - emu::tls.smem), &v, 16);
  auto* peer_bar = peer + (reinterpret_cast<unsigned char*>(bar) - emu::tls.smem);
  std::lock_guard<std::mutex> g(emu::mbar_lock);
  emu::Mbar& b = emu::mbars.at(peer_bar);
  b.tx -= 16;
  emu::mbar_settle(b);
}

inline long long clock64() { return 0; }
inline cudaError_t cudaGetDevice(int* d) { *d = 0; return cudaSuccess; }
inline cudaError_t cudaDeviceGetAttribute(int* v, cudaDeviceAttr a, int) {
  *v = a == cudaDevAttrMultiProcessorCount ? emu::sm_count : emu::max_smem_optin;
  return cudaSuccess;
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
// Runs kernel over the grid, one row of grid.x blocks at a time, in
// clusters of cluster_x consecutive blocks (0: the whole row).
template <typename K, typename P>
int run(K kernel, dim3 grid, int smem_bytes, const P& prm, int block_threads = 128,
        unsigned cluster_x = 0) {
  if (cluster_x == 0) cluster_x = grid.x;
  for (unsigned z = 0; z < grid.z; ++z) {
    for (unsigned y = 0; y < grid.y; ++y) {
      std::vector<Cluster> clusters((grid.x + cluster_x - 1) / cluster_x);
      for (auto& c : clusters) c.bar = std::make_unique<std::barrier<>>(cluster_x * block_threads);
      std::vector<std::unique_ptr<Block>> blocks;
      for (unsigned x = 0; x < grid.x; ++x) {
        blocks.push_back(std::make_unique<Block>(block_threads));
        blocks.back()->smem.assign(smem_bytes, 0xff);  // stale bits: NaN patterns
        clusters[x / cluster_x].smem.push_back(blocks.back()->smem.data());
      }
      std::vector<std::thread> threads;
      for (unsigned x = 0; x < grid.x; ++x) {
        for (int t = 0; t < block_threads; ++t) {
          threads.emplace_back([&, x, t]() {
            tls.thread_idx = dim3(t);
            tls.block_idx = dim3(x, y, z);
            tls.grid_dim = grid;
            tls.lane = t % 32;
            tls.warp = t / 32;
            tls.blk = blocks[x].get();
            tls.w = &blocks[x]->warps[t / 32];
            tls.collectives = 0;
            tls.cl = &clusters[x / cluster_x];
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
