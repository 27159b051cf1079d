// The packet walk of the bitmask (search_bitmask.cu, K2) and packed
// (search_packed.cu, K3) kernels, designed for Hopper (sm_90a). The range
// (search_range.cu, K4 and K5) and words (search_words.cu, K6 and K7)
// kernels run the same pieces (load_packet, test_block, warp_lex_min) over
// work items, a piece of each packet's block list, in one shared persistent
// loop (search_items, at the end of this file).
//
// One warp serves one 8-ray packet. The packet's culling words are the same
// for the whole warp, so the warp walks the packet's own set bits in
// ascending order (tile by tile, word by word, __ffs), each bit's granule
// blocks clipped to the tile, and no other packet's: the walk never
// diverges, and the (ray, triangle) pairs tested are exactly those of the
// packet's table. Every lane holds the packet's 8 rays in registers. For
// each tested 128-triangle block, lane l takes triangles l, l + 32, l + 64
// and l + 96: it loads each one's 12 plane words and original index once
// (the warp reads 128 consecutive bytes of each row) and tests it against
// all 8 rays with rtc::mt_distance, keeping 8 running (dst, orig_idx) bests
// under the lexicographic rule of rtc::lex_min. At the end of the packet a
// warp lex-min (5 __shfl_xor_sync rounds per ray) combines the lanes, and
// lanes 0-7 write rays 8p .. 8p + 7.
//
// The minimum of a total order does not depend on the order of the pairs
// visited, and mt_distance never returns NaN, so the result equals the
// one-thread-per-ray walk and the plain versions bit for bit, lowest
// original index on equal distances included.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "mt.cuh"

namespace rtc {

// Warps (packets) per CTA: small, so that a CTA's slot frees soon after its
// longest packet. On the H100, 1 and 2 warps measured within 2% of each
// other and 4 warps 2-6% slower (PERF.md, the K2/K3 redesign).
constexpr int kPacketWarps = 2;
constexpr int kPacketThreads = kPacketWarps * 32;
constexpr int kGroups = kBlock / 32;  // triangles per lane per block

// One triangle of the (12, t_stride) plane: A, AB, AC, N and its original
// index.
struct Tri {
  float w[12];
  int32_t oi;
};

__device__ __forceinline__ Tri load_tri(const float* __restrict__ plane,
                                        const int32_t* __restrict__ orig_idx,
                                        int64_t t_stride, int64_t col) {
  Tri t;
#pragma unroll
  for (int r = 0; r < 12; ++r) t.w[r] = __ldg(plane + r * t_stride + col);
  t.oi = __ldg(orig_idx + col);
  return t;
}

// The blocks of one packet's set bits, in ascending order: bit j of word w
// of tile t covers the tile-local blocks [(w * 31 + j) * granule, ... +
// granule), clipped to blocks_per_tile. Its state is the same on every lane.
struct BlockCursor {
  const int32_t* words;  // this packet's n_tiles * n_words words
  int n_tiles, n_words, blocks_per_tile, granule;
  int t = 0, w = -1;  // the current tile and word
  uint32_t m = 0u;    // bits of word w not walked yet
  int b = 0, end = 0;  // the next block of the current bit, and its end

  // The next block (global: t * blocks_per_tile + b), or -1 after the last.
  __device__ __forceinline__ int64_t next() {
    while (b >= end) {
      while (m == 0u) {
        if (++w >= n_words) {
          w = 0;
          if (++t >= n_tiles) return -1;
        }
        m = static_cast<uint32_t>(__ldg(words + t * n_words + w));
      }
      const int j = __ffs(m) - 1;
      m &= m - 1u;
      b = (w * kBitsPerWord + j) * granule;
      end = min(b + granule, blocks_per_tile);
    }
    return static_cast<int64_t>(t) * blocks_per_tile + b++;
  }
};

// Tests triangle `tri` against the packet's rays, keeping each ray's best.
__device__ __forceinline__ void test_tri(const Ray (&ray)[kPacket],
                                         const Tri& tri,
                                         float (&best_d)[kPacket],
                                         int32_t (&best_i)[kPacket]) {
#pragma unroll
  for (int i = 0; i < kPacket; ++i) {
    const float dst =
        mt_distance(ray[i], tri.w[0], tri.w[1], tri.w[2], tri.w[3], tri.w[4],
                    tri.w[5], tri.w[6], tri.w[7], tri.w[8], tri.w[9],
                    tri.w[10], tri.w[11]);
    lex_min(best_d[i], best_i[i], dst, tri.oi);
  }
}

// Loads rays r0 .. r0 + 7 (zeros past n_rays) into every lane and resets
// their running bests to (kMissDst, kBigIdx).
__device__ __forceinline__ void load_packet(const float* __restrict__ o,
                                            const float* __restrict__ d,
                                            int r0, int n_rays,
                                            Ray (&ray)[kPacket],
                                            float (&best_d)[kPacket],
                                            int32_t (&best_i)[kPacket]) {
#pragma unroll
  for (int i = 0; i < kPacket; ++i) {
    ray[i] = load_ray(o, d, r0 + i, r0 + i < n_rays);
    best_d[i] = kMissDst;
    best_i[i] = kBigIdx;
  }
}

// Tests the 128 triangles of block `blk` of the (12, t_stride) plane against
// the packet's rays: lane l takes triangles l, l + 32, l + 64 and l + 96.
// 16 resident warps per SM (128 registers a thread) hide the L2 latency of
// the loads: a register double buffer (the next triangle loaded while this
// one is tested) was tried and measured no faster on the H100.
__device__ __forceinline__ void test_block(const Ray (&ray)[kPacket],
                                           const float* __restrict__ plane,
                                           const int32_t* __restrict__ orig_idx,
                                           int64_t t_stride, int64_t blk,
                                           int lane, float (&best_d)[kPacket],
                                           int32_t (&best_i)[kPacket]) {
#pragma unroll 1
  for (int g = 0; g < kGroups; ++g) {
    const Tri tri = load_tri(plane, orig_idx, t_stride,
                             blk * kBlock + g * 32 + lane);
    test_tri(ray, tri, best_d, best_i);
  }
}

// Warp lex-min per ray (5 __shfl_xor_sync rounds each): lane i < kPacket
// gets ray i's best in (out_d, out_i); the other lanes get (kMissDst,
// kBigIdx).
__device__ __forceinline__ void warp_lex_min(float (&best_d)[kPacket],
                                             int32_t (&best_i)[kPacket],
                                             int lane, float& out_d,
                                             int32_t& out_i) {
  out_d = kMissDst;
  out_i = kBigIdx;
#pragma unroll
  for (int i = 0; i < kPacket; ++i) {
#pragma unroll
    for (int s = 16; s > 0; s >>= 1) {
      const float od = __shfl_xor_sync(0xffffffffu, best_d[i], s);
      const int32_t oi = __shfl_xor_sync(0xffffffffu, best_i[i], s);
      lex_min(best_d[i], best_i[i], od, oi);
    }
    if (lane == i) {
      out_d = best_d[i];
      out_i = best_i[i];
    }
  }
}

// The search of the packet of this warp (packet blockIdx.x * kPacketWarps +
// warp): words holds n_tiles * n_words words per packet, the plane
// n_tiles * blocks_per_tile blocks. Writes dst_out and idx_out (-1 on a
// miss) for the packet's rays below n_rays. Where blocks_out is not null,
// lane 0 adds the blocks the warp walked to it (one atomic a warp that
// walked any).
__device__ __forceinline__ void search_packet(
    const float* __restrict__ o, const float* __restrict__ d,
    const int32_t* __restrict__ words, const float* __restrict__ plane,
    const int32_t* __restrict__ orig_idx, int n_rays, int n_tiles,
    int n_words, int blocks_per_tile, int granule, float* __restrict__ dst_out,
    int32_t* __restrict__ idx_out, unsigned long long* __restrict__ blocks_out) {
  const int lane = threadIdx.x & 31;
  const int p = blockIdx.x * kPacketWarps + (threadIdx.x >> 5);
  const int r0 = p * kPacket;
  if (r0 >= n_rays) return;  // the whole warp

  Ray ray[kPacket];
  float best_d[kPacket];
  int32_t best_i[kPacket];
  load_packet(o, d, r0, n_rays, ray, best_d, best_i);

  const int64_t t_stride =
      static_cast<int64_t>(n_tiles) * blocks_per_tile * kBlock;
  BlockCursor cur{words + static_cast<int64_t>(p) * n_tiles * n_words,
                  n_tiles, n_words, blocks_per_tile, granule};
  unsigned long long walked = 0ull;
  for (int64_t blk = cur.next(); blk >= 0; blk = cur.next()) {
    test_block(ray, plane, orig_idx, t_stride, blk, lane, best_d, best_i);
    ++walked;
  }
  if (blocks_out != nullptr && lane == 0 && walked != 0ull) {
    atomicAdd(blocks_out, walked);
  }

  float out_d;
  int32_t out_i;
  warp_lex_min(best_d, best_i, lane, out_d, out_i);
  const int r = r0 + lane;
  if (lane < kPacket && r < n_rays) {
    dst_out[r] = out_d;
    idx_out[r] = out_d < kMissDst ? out_i : -1;
  }
}

// ---------------------------------------------------------------------------
// Work items (the range and words kernels; the union walk K9 is the words
// kernel with one word row per 1,024-ray program, and the MXU search K8
// runs the same claim loop, keys and unpack). Each packet's block list is cut
// into work items of at most kSplit blocks; a count kernel gives each packet
// its item count, the wrapper scans the counts on the device (torch.cumsum,
// no host sync) into `ends`, and a persistent grid (about SMs x resident
// CTAs) of warps claims items from an atomic counter, finds an item's packet
// by binary search over the scan, walks its blocks and merges its 8 results
// into the rays' 64-bit keys (bits(dst) << 32) | orig_idx with atomicMin.
// mt_distance returns either a distance >= kEpsilon or kMissDst, never NaN,
// so dst is positive and its bits order like the floats; orig_idx <=
// kBigIdx = 2^30. So the key orders exactly like (dst, orig_idx)
// lexicographically, the minimum of a total order does not depend on the
// order of the atomics, and the bits are those of one walk on every run. A
// warp whose item misses on a ray writes nothing for it.

constexpr int kItemWarps = 4;  // warps per CTA of the item search
constexpr int kItemThreads = kItemWarps * 32;
constexpr int kItemMinCtas = 4;  // per SM: <= 128 registers a thread
constexpr int kCountThreads = 256;

// The packed miss (kMissDst, kBigIdx): 999999.0f has the bits 0x497423F0
// (ops/search_range.py MISS_KEY, held to this on the card).
constexpr unsigned long long kMissKey = (0x497423F0ull << 32) | (1ull << 30);

// The count kernels' other jobs, for packet p: its rays' keys start at the
// packed miss, and thread 0 of the grid zeroes the claim counter (the search
// launch that follows on the same stream sees both).
__device__ __forceinline__ void reset_item_state(
    int p, int n_rays, unsigned long long* __restrict__ counter,
    unsigned long long* __restrict__ keys) {
  if (p == 0) *counter = 0ull;
#pragma unroll
  for (int i = 0; i < kPacket; ++i) {
    if (p * kPacket + i < n_rays) keys[p * kPacket + i] = kMissKey;
  }
}

// A hit's key, bits(dst) << 32 | orig_idx (dst >= kEpsilon, orig_idx <=
// kBigIdx).
__device__ __forceinline__ unsigned long long hit_key(float dst, int32_t i) {
  return (static_cast<unsigned long long>(__float_as_uint(dst)) << 32) |
         static_cast<uint32_t>(i);
}

// The persistent claim loop of every item search (the packet walks below;
// the MXU search, search_mxu.cu): each warp claims item after item until
// the counter passes ends[n_units - 1], the total. Item j belongs to the
// least unit u with ends[u] > j, as its k-th item, k = j - ends[u - 1]; the
// warp runs body(u, k) for it.
template <typename Body>
__device__ __forceinline__ void claim_items(
    const int64_t* __restrict__ ends, int n_units,
    unsigned long long* __restrict__ counter, Body&& body) {
  const int lane = threadIdx.x & 31;
  const int64_t total = __ldg(ends + n_units - 1);
  for (;;) {
    unsigned long long claim = 0;
    if (lane == 0) claim = atomicAdd(counter, 1ull);
    const int64_t item =
        static_cast<int64_t>(__shfl_sync(0xffffffffu, claim, 0));
    if (item >= total) return;  // the whole warp

    int a = 0, b = n_units - 1;  // the least u with ends[u] > item
    while (a < b) {
      const int m = (a + b) >> 1;
      if (__ldg(ends + m) > item) b = m; else a = m + 1;
    }
    body(a, static_cast<int>(item - (a > 0 ? __ldg(ends + a - 1) : 0)));
  }
}

// The packet walks' persistent loop: the units are the packets, and
// `items.begin(p, k)` gives a cursor over item k's blocks of packet p
// (global block ids of the (12, t_stride) plane): next() returns the next
// one, or -1 after the last.
template <typename Items>
__device__ __forceinline__ void search_items(
    const float* __restrict__ o, const float* __restrict__ d,
    const int64_t* __restrict__ ends, const float* __restrict__ plane,
    const int32_t* __restrict__ orig_idx, int64_t t_stride, int n_rays,
    int n_packets, const Items& items,
    unsigned long long* __restrict__ counter,
    unsigned long long* __restrict__ keys) {
  const int lane = threadIdx.x & 31;
  claim_items(ends, n_packets, counter, [&](int p, int k) {
    auto cur = items.begin(p, k);
    const int r0 = p * kPacket;
    Ray ray[kPacket];
    float best_d[kPacket];
    int32_t best_i[kPacket];
    load_packet(o, d, r0, n_rays, ray, best_d, best_i);
    for (int64_t blk = cur.next(); blk >= 0; blk = cur.next()) {
      test_block(ray, plane, orig_idx, t_stride, blk, lane, best_d, best_i);
    }
    float out_d;
    int32_t out_i;
    warp_lex_min(best_d, best_i, lane, out_d, out_i);
    const int r = r0 + lane;
    if (lane < kPacket && r < n_rays && out_d < kMissDst) {
      atomicMin(keys + r, hit_key(out_d, out_i));
    }
  });
}

// The persistent grid of an item search kernel: resident CTAs of
// kItemThreads per SM, and SMs.
template <typename Kernel>
cudaError_t item_grid(Kernel kernel, int* ctas_per_sm, int* sms) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
  }
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(ctas_per_sm, kernel,
                                                        kItemThreads, 0);
  }
  return err;
}

}  // namespace rtc
