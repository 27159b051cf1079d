// One-word-per-tile packet search over triangle tiles, hand-written for
// Hopper.
//
// Replaces two TPU kernels of raytracingc_tpu/ops/intersect_pallas.py:
// _search_kernel_streamed_words (ray-major grid, in-kernel cross-tile merge;
// also the resident words route, one tile of the whole plane) and
// _search_kernel_streamed_words_tmajor (tile-major grid, cross-tile lex-min
// fold in XLA). The (12, T) plane is cut into n_tiles tiles of
// blocks_per_tile 128-triangle blocks. Packet p (rays 8p .. 8p + 7) carries
// ONE culling word per tile (ops/culling.py::packet_tile_words): bit j of
// tile t's word covers the tile-local blocks [j * granule, ... + granule),
// clipped to the tile, with granule = ceil(blocks_per_tile / 31), and is set
// iff some live lane of the packet passes the slab test of that granule's
// union AABB. Every ray of the packet tests the blocks of its set bits,
// tiles and blocks in ascending order, with the shared Moller-Trumbore test
// (mt.cuh), keeping the lexicographic minimum of (dst, original index). A
// packet with no set bit misses.
//
// The two TPU kernels differ only in their grid order and in where the
// tiles' results meet: a merge into a revisited output, or an XLA fold of
// one output per (tile, program). Both are the lex-min over the tiles' real
// hits, and a lex-min over a partition is the lex-min over the whole, so
// both give the bits of one walk whose running best carries across tiles.
// Here the loop over tiles runs inside the thread, so the grid order has no
// meaning and RTC_STREAM_ORDER (tile or ray) runs this one kernel. It equals
// the plain version (ops/search_words.py::search_words_reference) on the
// card.
//
// The walk is rtc::walk_tile_words (mt.cuh) with one word per (packet,
// tile), a constant the compiler folds into this instance. What bounds it on
// an H100: the MT work and the divergence of the bit walk. The design is the
// first one of the packet kernels: one thread per ray, the warp walking the
// union of its 4 packets' bits, the plane in L2 (search_bitmask.cu and
// search_packed.cu have since moved to packet_walk.cuh's warp per packet).
// No shared memory, no tensor cores: the simple first version.

#include <cuda_runtime.h>
#include <stdint.h>

#include "mt.cuh"

namespace {

constexpr int kThreads = 256;  // rays per block: 32 packets, 8 warps

__global__ void __launch_bounds__(kThreads)
search_words_kernel(const float* __restrict__ o,           // [R, 3]
                    const float* __restrict__ d,           // [R, 3]
                    const int32_t* __restrict__ words,     // [ceil(R/8), n_tiles]
                    const float* __restrict__ plane,       // [12, n_tiles * tile]
                    const int32_t* __restrict__ orig_idx,  // [n_tiles * tile]
                    int n_rays, int n_tiles, int blocks_per_tile, int granule,
                    float* __restrict__ dst_out,           // [R]
                    int32_t* __restrict__ idx_out) {       // [R]
  const int r = blockIdx.x * kThreads + threadIdx.x;
  const bool in_range = r < n_rays;
  const rtc::Ray ray = rtc::load_ray(o, d, r, in_range);
  const int32_t* packet_words =
      words + static_cast<int64_t>(r / rtc::kPacket) * n_tiles;

  float best_d = rtc::kMissDst;
  int32_t best_i = rtc::kBigIdx;
  rtc::walk_tile_words(ray, packet_words, in_range, n_tiles, 1,
                       blocks_per_tile, granule, plane, orig_idx, best_d,
                       best_i);
  if (in_range) {
    dst_out[r] = best_d;
    idx_out[r] = best_d < rtc::kMissDst ? best_i : -1;
  }
}

}  // namespace

extern "C" {

// Launches the search on `stream` and returns cudaGetLastError() as an int
// (0 = launched).
int rtc_search_words(const void* o, const void* d, const void* words,
                     const void* plane, const void* orig_idx, int n_rays,
                     int n_tiles, int blocks_per_tile, int granule, void* dst,
                     void* idx, void* stream) {
  if (n_rays <= 0) return static_cast<int>(cudaGetLastError());
  const int blocks = (n_rays + kThreads - 1) / kThreads;
  search_words_kernel<<<blocks, kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(o), static_cast<const float*>(d),
      static_cast<const int32_t*>(words), static_cast<const float*>(plane),
      static_cast<const int32_t*>(orig_idx), n_rays, n_tiles,
      blocks_per_tile, granule, static_cast<float*>(dst),
      static_cast<int32_t*>(idx));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
