// Range packet search over the block-AABB accel, hand-written for Hopper.
//
// Replaces two TPU kernels of raytracingc_tpu/ops/intersect_pallas.py:
// _search_kernel (with _search_tile, the resident range kernel) and
// _search_kernel_streamed (the same over triangle tiles). Rays come in
// packets of 8 (ray r is in packet r / 8). Packet p carries one block span
// [first[p], last[p]] (ops/culling.py::packet_block_ranges): the lowest and
// highest 128-triangle block that passes the slab test for some live lane of
// the packet, or the empty span first = 2^30, last = -1. Every ray of the
// packet, live or dead, tests the blocks of the span that lie in the plane,
// max(first, 0) .. min(last, n_blocks - 1), with the shared Moller-Trumbore
// test (mt.cuh), and keeps the lexicographic minimum of (dst, original
// index). An empty span tests nothing: (MISS_DST, -1).
//
// Why one kernel serves both. The span holds GLOBAL block ids, so it does
// not depend on tiling. The streamed TPU kernel clips the span to each tile,
// takes each tile's lex-min (-1 when it misses) and merges the tiles into
// its revisited output with
//   take = d < cur_d || (d == cur_d && i >= 0 && i < cur_i)
// (intersect_pallas.py:415-425): a lex-min over the tiles' real hits, in
// which a miss never replaces anything. The clipped pieces partition the
// span, and the lex-min over a partition is the lex-min over the whole, so
// its bits are those of one walk over the span of the tile-padded plane
// (ops/culling.py::stream_tile_pad; the padding blocks lie past every span,
// which the prelude takes from the real blocks only). That is what this
// kernel computes for both; it equals the plain version (ops/
// search_range.py::search_range_reference) bit for bit.
//
// What bounds it on an H100. (1) The MT operations of the span's pairs:
// 61 un-fused FP32 operations (--fmad=false) per (ray, triangle) pair, 8 x
// 128 pairs for every block of every span, hit or not; the plane (8.5 MB
// at 163,840 triangles) stays in the 50 MB L2. (2) The tail of the widest
// span: a packet whose live lanes hit both ends of the Morton order gets a
// span of nearly the whole plane (1,280 blocks at 163,840 triangles against
// a mean of ~21), and a warp that walks it whole runs long after the rest of
// the card has finished.
//
// What the design does about each. (1) packet_walk.cuh's layout, as in K2
// and K3: a warp holds one packet's 8 rays in registers and lane l tests
// triangles l, l + 32, l + 64, l + 96 of each block against all 8 (one
// coalesced load of a triangle serves 8 tests), so no lane idles on another
// packet's span. (2) Each clipped span is cut into work items of at most
// kSplit blocks, walked by packet_walk.cuh's persistent loop
// (rtc::search_items, shared with the words kernel): range_items_kernel
// counts each packet's items (and fills the keys with the packed miss and
// zeroes the claim counter), the wrapper scans the counts (torch.cumsum, on
// the device), the search merges each item's results into the rays' 64-bit
// keys with atomicMin, and unpack_keys_kernel turns the keys into (dst, idx)
// (ops/search_range.py::unpack_keys is its plain version). The words
// wrapper runs the same unpack. Left out as TPU aids that change no result:
// the per-program dead flags and the SMEM ray slicing.

#include <cuda_runtime.h>
#include <stdint.h>

#include "packet_walk.cuh"

namespace {

// Blocks per work item. A/B on the H100 at 8 / 16 / 32 / 64 (PERF.md, the
// K4/K5 redesign).
constexpr int kSplit = 16;

// items[p]: the work items of packet p's clipped span, ceil(blocks / kSplit)
// (0 for an empty span or one past the plane); also resets the keys and the
// claim counter (rtc::reset_item_state).
__global__ void __launch_bounds__(rtc::kCountThreads)
range_items_kernel(const int32_t* __restrict__ first,   // [P]
                   const int32_t* __restrict__ last,    // [P]
                   int n_rays, int n_packets, int n_blocks,
                   int32_t* __restrict__ items,          // [P]
                   unsigned long long* __restrict__ counter,  // [1]
                   unsigned long long* __restrict__ keys) {   // [R]
  const int p = blockIdx.x * rtc::kCountThreads + threadIdx.x;
  if (p >= n_packets) return;
  rtc::reset_item_state(p, n_rays, counter, keys);
  const int lo = max(first[p], 0);
  const int hi = min(last[p], n_blocks - 1);
  items[p] = hi >= lo ? (hi - lo) / kSplit + 1 : 0;
}

// Item k of packet p covers the blocks lo + k * kSplit .. min(lo + k *
// kSplit + kSplit - 1, hi) of p's clipped span [lo, hi].
struct SpanItems {
  const int32_t* first;
  const int32_t* last;
  int n_blocks;

  struct Cursor {
    int blk, hi;
    __device__ __forceinline__ int64_t next() { return blk <= hi ? blk++ : -1; }
  };

  __device__ __forceinline__ Cursor begin(int p, int k) const {
    const int lo = max(__ldg(first + p), 0) + k * kSplit;
    return {lo, min(min(__ldg(last + p), n_blocks - 1), lo + kSplit - 1)};
  }
};

__global__ void __launch_bounds__(rtc::kItemThreads, rtc::kItemMinCtas)
search_range_kernel(const float* __restrict__ o,              // [R, 3]
                    const float* __restrict__ d,              // [R, 3]
                    const int32_t* __restrict__ first,        // [P]
                    const int32_t* __restrict__ last,         // [P]
                    const int64_t* __restrict__ ends,         // [P] inclusive scan
                    const float* __restrict__ plane,          // [12, T]
                    const int32_t* __restrict__ orig_idx,     // [T]
                    int n_rays, int n_packets, int n_blocks,
                    unsigned long long* __restrict__ counter, // [1], 0
                    unsigned long long* __restrict__ keys) {  // [R]
  rtc::search_items(o, d, ends, plane, orig_idx,
                    static_cast<int64_t>(n_blocks) * rtc::kBlock, n_rays,
                    n_packets, SpanItems{first, last, n_blocks}, counter,
                    keys);
}

// (dst, idx) of each ray's key; idx -1 where dst is the miss.
__global__ void __launch_bounds__(rtc::kCountThreads)
unpack_keys_kernel(const unsigned long long* __restrict__ keys,  // [R]
                   int n, float* __restrict__ dst,               // [R]
                   int32_t* __restrict__ idx) {                  // [R]
  const int r = blockIdx.x * rtc::kCountThreads + threadIdx.x;
  if (r >= n) return;
  const unsigned long long key = keys[r];
  const float dr = __uint_as_float(static_cast<uint32_t>(key >> 32));
  dst[r] = dr;
  idx[r] = dr < rtc::kMissDst ? static_cast<int32_t>(static_cast<uint32_t>(key))
                              : -1;
}

int count_blocks(int n) {
  return (n + rtc::kCountThreads - 1) / rtc::kCountThreads;
}

}  // namespace

extern "C" {

// Counts each packet's work items into items [ceil(n_rays / 8)] (int32),
// fills keys [n_rays] (int64) with the packed miss and zeroes counter [1]
// (int64), on `stream`; returns cudaGetLastError() as an int (0 =
// launched).
int rtc_range_items(const void* first, const void* last, int n_rays,
                    int n_blocks, void* items, void* counter, void* keys,
                    void* stream) {
  if (n_rays <= 0) return static_cast<int>(cudaGetLastError());
  const int n_packets = (n_rays + rtc::kPacket - 1) / rtc::kPacket;
  range_items_kernel<<<count_blocks(n_packets), rtc::kCountThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(first), static_cast<const int32_t*>(last),
      n_rays, n_packets, n_blocks, static_cast<int32_t*>(items),
      static_cast<unsigned long long*>(counter),
      static_cast<unsigned long long*>(keys));
  return static_cast<int>(cudaGetLastError());
}

// Launches the search on `stream`: ends [ceil(n_rays / 8)] int64 is the
// inclusive scan of rtc_range_items' counts, and counter and keys are as
// rtc_range_items left them; keys receive each ray's packed lex-min.
// Returns cudaGetLastError() as an int (0 = launched).
int rtc_search_range(const void* o, const void* d, const void* first,
                     const void* last, const void* ends, const void* plane,
                     const void* orig_idx, int n_rays, int n_blocks,
                     void* counter, void* keys, void* stream) {
  if (n_rays <= 0) return static_cast<int>(cudaGetLastError());
  int ctas_per_sm = 0, sms = 0;
  const cudaError_t err =
      rtc::item_grid(search_range_kernel, &ctas_per_sm, &sms);
  if (err != cudaSuccess) return static_cast<int>(err);
  search_range_kernel<<<ctas_per_sm * sms, rtc::kItemThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(o), static_cast<const float*>(d),
      static_cast<const int32_t*>(first), static_cast<const int32_t*>(last),
      static_cast<const int64_t*>(ends), static_cast<const float*>(plane),
      static_cast<const int32_t*>(orig_idx), n_rays,
      (n_rays + rtc::kPacket - 1) / rtc::kPacket, n_blocks,
      static_cast<unsigned long long*>(counter),
      static_cast<unsigned long long*>(keys));
  return static_cast<int>(cudaGetLastError());
}

// The search's persistent grid on the current device: resident CTAs per SM
// (of rtc::kItemThreads threads) and SMs. Returns a cudaError_t as an int.
int rtc_search_range_grid(int* ctas_per_sm, int* sms) {
  return static_cast<int>(
      rtc::item_grid(search_range_kernel, ctas_per_sm, sms));
}

// Unpacks keys [n] (int64) of the range and words searches into dst [n]
// (float32) and idx [n] (int32, -1 on a miss) on `stream`; returns
// cudaGetLastError() as an int (0 = launched).
int rtc_unpack_keys(const void* keys, int n, void* dst, void* idx,
                    void* stream) {
  if (n <= 0) return static_cast<int>(cudaGetLastError());
  unpack_keys_kernel<<<count_blocks(n), rtc::kCountThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const unsigned long long*>(keys), n,
      static_cast<float*>(dst), static_cast<int32_t*>(idx));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
