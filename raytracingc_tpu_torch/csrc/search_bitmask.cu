// Bitmask packet search over the block-AABB accel, hand-written for Hopper.
//
// Replaces raytracingc_tpu/ops/intersect_pallas.py::_search_kernel_bitmask
// (with _search_tile_bitmask, its walk). Rays come in packets of 8 (ray r is
// in packet r / 8). Packet p carries n_words culling words: bit j of word w
// is set iff some live lane of the packet passes the slab test of the
// 128-triangle Morton block w * 31 + j (ops/culling.py::packet_block_masks).
// Every ray of the packet, live or dead, tests exactly the blocks of its
// packet's set bits, in ascending block order, with the shared
// Moller-Trumbore test (mt.cuh), and keeps the lexicographic minimum of
// (dst, original index). A packet with no set bit misses: (MISS_DST, -1).
// This is the TPU kernel's result bit for bit, and equals the plain version
// (ops/search_bitmask.py::search_bitmask_reference) on the card.
//
// What bounds it on an H100: the MT work, ~60 FP32 operations per (ray,
// tested triangle), and the warp divergence of the bit walk. Each block test
// reads 13 x 128 words of the plane (6.5 KB), from L2 for any scene this
// kernel serves (<= 248 blocks, a 1.5 MB plane).
//
// What the design does about it: one thread per ray keeps the ray and its
// running best in registers. The 8 lanes of a packet read the same words, so
// a packet never diverges internally; the warp (4 packets) walks the union
// of its packets' bits with __ffs, so packets that share a block test it in
// step and its rows are read once per warp, while a lane whose packet has
// that bit clear idles. The TPU kernel's packing of active columns, its
// descending-popcount column sort and the grouped lockstep walk
// (RTC_COL_GROUP) change no result and are left out: they schedule the
// TPU's scalar core. The words are read from global memory, so no ray
// slicing to fit a scratch budget is needed. No shared memory, no tensor
// cores: the simple first version.

#include <cuda_runtime.h>
#include <stdint.h>

#include "mt.cuh"

namespace {

constexpr int kThreads = 256;  // rays per block: 32 packets, 8 warps

__global__ void __launch_bounds__(kThreads)
search_bitmask_kernel(const float* __restrict__ o,          // [R, 3]
                      const float* __restrict__ d,          // [R, 3]
                      const int32_t* __restrict__ words,    // [ceil(R/8), W]
                      const float* __restrict__ plane,      // [12, T]
                      const int32_t* __restrict__ orig_idx, // [T]
                      int n_rays, int n_words, int n_blocks,
                      float* __restrict__ dst_out,          // [R]
                      int32_t* __restrict__ idx_out) {      // [R]
  const int r = blockIdx.x * kThreads + threadIdx.x;
  const bool in_range = r < n_rays;
  const rtc::Ray ray = rtc::load_ray(o, d, r, in_range);
  const int64_t t_stride = static_cast<int64_t>(n_blocks) * rtc::kBlock;
  const int32_t* packet_words =
      words + static_cast<int64_t>(r / rtc::kPacket) * n_words;

  float best_d = rtc::kMissDst;
  int32_t best_i = rtc::kBigIdx;
  for (int w = 0; w < n_words; ++w) {  // uniform over the grid
    const uint32_t m =
        in_range ? static_cast<uint32_t>(__ldg(packet_words + w)) : 0u;
    rtc::for_each_bit(m, [&](int j) {
      const int blk = w * rtc::kBitsPerWord + j;
      if (blk < n_blocks) {
        rtc::mt_block(ray, plane, orig_idx, t_stride, blk, best_d, best_i);
      }
    });
  }
  if (in_range) {
    dst_out[r] = best_d;
    idx_out[r] = best_d < rtc::kMissDst ? best_i : -1;
  }
}

}  // namespace

extern "C" {

// Launches the search on `stream` and returns cudaGetLastError() as an int
// (0 = launched).
int rtc_search_bitmask(const void* o, const void* d, const void* words,
                       const void* plane, const void* orig_idx, int n_rays,
                       int n_words, int n_blocks, void* dst, void* idx,
                       void* stream) {
  if (n_rays <= 0) return static_cast<int>(cudaGetLastError());
  const int blocks = (n_rays + kThreads - 1) / kThreads;
  search_bitmask_kernel<<<blocks, kThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(o), static_cast<const float*>(d),
      static_cast<const int32_t*>(words), static_cast<const float*>(plane),
      static_cast<const int32_t*>(orig_idx), n_rays, n_words, n_blocks,
      static_cast<float*>(dst), static_cast<int32_t*>(idx));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
