// Bitmask packet search over the block-AABB accel, hand-written for Hopper.
//
// Replaces raytracingc_tpu/ops/intersect_pallas.py::_search_kernel_bitmask
// (with _search_tile_bitmask, its walk). Rays come in packets of 8 (ray r is
// in packet r / 8). Packet p carries n_words culling words: bit j of word w
// is set iff some live lane of the packet passes the slab test of the
// 128-triangle Morton block w * 31 + j (ops/culling.py::packet_block_masks).
// Every ray of the packet, live or dead, tests exactly the blocks of its
// packet's set bits with the shared Moller-Trumbore test (mt.cuh) and keeps
// the lexicographic minimum of (dst, original index). A packet with no set
// bit misses: (MISS_DST, -1). This is the TPU kernel's result bit for bit,
// and equals the plain version (ops/search_bitmask.py::
// search_bitmask_reference) on the card.
//
// What bounds it on an H100: FP32 issue. Under --fmad=false each of the 61
// operations of an MT test is its own instruction, and a tested block is
// 8 x 128 tests against 13 x 128 words (6.5 KB) read from L2 (the plane of
// any scene this kernel serves, <= 248 blocks, is <= 1.5 MB).
//
// What the design does about it (packet_walk.cuh): one warp per packet, so
// the warp walks only its own packet's bits and every lane tests every
// pair it is given (no lane idles on another packet's block), and the
// triangles across the lanes with the packet's 8 rays in registers, so one
// coalesced load of a triangle's 13 words serves 8 tests. This kernel is
// that walk with one tile, granule 1 and blocks_per_tile = n_blocks (bits
// past n_blocks are ignored). The TPU kernel's packing of active columns,
// its descending-popcount column sort and the grouped lockstep walk
// (RTC_COL_GROUP) schedule the TPU's scalar core and change no result; they
// are left out. The words are read from global memory, so no ray slicing
// to fit a scratch budget is needed.
//
// The kernel also counts its work: each warp adds the blocks it walked to a
// device int64 that the wrapper owns (one atomic a warp), with no launch or
// host sync of its own; the wrapper reads it only when asked.

#include <cuda_runtime.h>
#include <stdint.h>

#include "packet_walk.cuh"

namespace {

__global__ void __launch_bounds__(rtc::kPacketThreads)
search_bitmask_kernel(const float* __restrict__ o,          // [R, 3]
                      const float* __restrict__ d,          // [R, 3]
                      const int32_t* __restrict__ words,    // [ceil(R/8), W]
                      const float* __restrict__ plane,      // [12, T]
                      const int32_t* __restrict__ orig_idx, // [T]
                      int n_rays, int n_words, int n_blocks,
                      float* __restrict__ dst_out,          // [R]
                      int32_t* __restrict__ idx_out,        // [R]
                      unsigned long long* __restrict__ walked) {  // [1]
  rtc::search_packet(o, d, words, plane, orig_idx, n_rays, 1, n_words,
                     n_blocks, 1, dst_out, idx_out, walked);
}

}  // namespace

extern "C" {

// Launches the search on `stream` and returns cudaGetLastError() as an int
// (0 = launched). The (packet, block) pairs walked are added to the int64 at
// `walked`.
int rtc_search_bitmask(const void* o, const void* d, const void* words,
                       const void* plane, const void* orig_idx, int n_rays,
                       int n_words, int n_blocks, void* dst, void* idx,
                       void* walked, void* stream) {
  if (n_rays <= 0) return static_cast<int>(cudaGetLastError());
  const int packets = (n_rays + rtc::kPacket - 1) / rtc::kPacket;
  const int blocks = (packets + rtc::kPacketWarps - 1) / rtc::kPacketWarps;
  search_bitmask_kernel<<<blocks, rtc::kPacketThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(o), static_cast<const float*>(d),
      static_cast<const int32_t*>(words), static_cast<const float*>(plane),
      static_cast<const int32_t*>(orig_idx), n_rays, n_words, n_blocks,
      static_cast<float*>(dst), static_cast<int32_t*>(idx),
      static_cast<unsigned long long*>(walked));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
