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
// kSplit blocks, one warp walk each: range_items_kernel counts each packet's
// items, the wrapper scans the counts (torch.cumsum, on the device), and a
// persistent grid (about SMs x resident CTAs) of warps claims items from an
// atomic counter, finds an item's packet by binary search over the scan,
// walks its blocks and merges its 8 results into the rays' 64-bit keys
// (bits(dst) << 32) | orig_idx with atomicMin. mt_distance returns either
// a distance >= kEpsilon or kMissDst, never NaN, so dst is positive and its
// bits order like the floats; orig_idx <= kBigIdx = 2^30. So the key orders
// exactly like (dst, orig_idx) lexicographically, the minimum of a total
// order does not depend on the order of the atomics, and the bits are those
// of one walk on every run. The wrapper fills the keys with the packed miss
// (kMissDst, kBigIdx) and unpacks them with torch ops (ops/search_range.py::
// unpack_keys). A warp whose item misses on a ray writes nothing for it.
// Left out as TPU aids that change no result: the per-program dead flags
// and the SMEM ray slicing.

#include <cuda_runtime.h>
#include <stdint.h>

#include "packet_walk.cuh"

namespace {

// Blocks per work item. A/B on the H100 at 8 / 16 / 32 / 64 (PERF.md, the
// K4/K5 redesign).
constexpr int kSplit = 16;
constexpr int kWarps = 4;                 // warps per CTA of the search
constexpr int kThreads = kWarps * 32;
constexpr int kMinCtas = 4;               // per SM: <= 128 registers a thread
constexpr int kCountThreads = 256;

// items[p]: the work items of packet p's clipped span, ceil(blocks / kSplit)
// (0 for an empty span or one past the plane).
__global__ void __launch_bounds__(kCountThreads)
range_items_kernel(const int32_t* __restrict__ first,  // [P]
                   const int32_t* __restrict__ last,   // [P]
                   int n_packets, int n_blocks,
                   int32_t* __restrict__ items) {       // [P]
  const int p = blockIdx.x * kCountThreads + threadIdx.x;
  if (p >= n_packets) return;
  const int lo = max(first[p], 0);
  const int hi = min(last[p], n_blocks - 1);
  items[p] = hi >= lo ? (hi - lo) / kSplit + 1 : 0;
}

// Persistent warps: each claims item after item until the counter passes
// ends[n_packets - 1], the total. Item j of packet p (ends[p - 1] <= j <
// ends[p]) covers the blocks lo + k * kSplit .. min(lo + k * kSplit +
// kSplit - 1, hi), k = j - ends[p - 1], of p's clipped span [lo, hi].
__global__ void __launch_bounds__(kThreads, kMinCtas)
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
  const int lane = threadIdx.x & 31;
  const int64_t total = __ldg(ends + n_packets - 1);
  const int64_t t_stride = static_cast<int64_t>(n_blocks) * rtc::kBlock;
  for (;;) {
    unsigned long long claim = 0;
    if (lane == 0) claim = atomicAdd(counter, 1ull);
    const int64_t item =
        static_cast<int64_t>(__shfl_sync(0xffffffffu, claim, 0));
    if (item >= total) return;  // the whole warp

    int a = 0, b = n_packets - 1;  // the least p with ends[p] > item
    while (a < b) {
      const int m = (a + b) >> 1;
      if (__ldg(ends + m) > item) b = m; else a = m + 1;
    }
    const int p = a;
    const int k = static_cast<int>(item - (p > 0 ? __ldg(ends + p - 1) : 0));
    const int lo = max(__ldg(first + p), 0) + k * kSplit;
    const int hi = min(min(__ldg(last + p), n_blocks - 1), lo + kSplit - 1);

    const int r0 = p * rtc::kPacket;
    rtc::Ray ray[rtc::kPacket];
    float best_d[rtc::kPacket];
    int32_t best_i[rtc::kPacket];
    rtc::load_packet(o, d, r0, n_rays, ray, best_d, best_i);
    for (int blk = lo; blk <= hi; ++blk) {
      rtc::test_block(ray, plane, orig_idx, t_stride, blk, lane, best_d,
                      best_i);
    }
    float out_d;
    int32_t out_i;
    rtc::warp_lex_min(best_d, best_i, lane, out_d, out_i);
    const int r = r0 + lane;
    if (lane < rtc::kPacket && r < n_rays && out_d < rtc::kMissDst) {
      const unsigned long long key =
          (static_cast<unsigned long long>(__float_as_uint(out_d)) << 32) |
          static_cast<uint32_t>(out_i);
      atomicMin(keys + r, key);
    }
  }
}

// The persistent grid: SMs x resident CTAs of search_range_kernel.
cudaError_t search_grid(int* ctas_per_sm, int* sms) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
  }
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        ctas_per_sm, search_range_kernel, kThreads, 0);
  }
  return err;
}

}  // namespace

extern "C" {

// Counts each packet's work items into items [n_packets] (int32) on
// `stream`; returns cudaGetLastError() as an int (0 = launched).
int rtc_range_items(const void* first, const void* last, int n_packets,
                    int n_blocks, void* items, void* stream) {
  if (n_packets <= 0) return static_cast<int>(cudaGetLastError());
  const int blocks = (n_packets + kCountThreads - 1) / kCountThreads;
  range_items_kernel<<<blocks, kCountThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(first), static_cast<const int32_t*>(last),
      n_packets, n_blocks, static_cast<int32_t*>(items));
  return static_cast<int>(cudaGetLastError());
}

// Launches the search on `stream`: ends [ceil(n_rays / 8)] int64 is the
// inclusive scan of rtc_range_items' counts, counter [1] int64 is 0, keys
// [n_rays] int64 hold the packed miss and receive each ray's packed lex-min.
// Returns cudaGetLastError() as an int (0 = launched).
int rtc_search_range(const void* o, const void* d, const void* first,
                     const void* last, const void* ends, const void* plane,
                     const void* orig_idx, int n_rays, int n_blocks,
                     void* counter, void* keys, void* stream) {
  if (n_rays <= 0) return static_cast<int>(cudaGetLastError());
  int ctas_per_sm = 0, sms = 0;
  const cudaError_t err = search_grid(&ctas_per_sm, &sms);
  if (err != cudaSuccess) return static_cast<int>(err);
  search_range_kernel<<<ctas_per_sm * sms, kThreads, 0,
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
// (of kThreads threads) and SMs. Returns a cudaError_t as an int.
int rtc_search_range_grid(int* ctas_per_sm, int* sms) {
  return static_cast<int>(search_grid(ctas_per_sm, sms));
}

}  // extern "C"
