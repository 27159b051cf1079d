// Packed multi-word packet search over triangle tiles, hand-written for
// Hopper.
//
// Replaces raytracingc_tpu/ops/intersect_pallas.py::
// _search_kernel_streamed_packed_tmajor together with the cross-tile lex-min
// fold its launcher runs in XLA. The (12, T) plane is cut into n_tiles tiles
// of blocks_per_tile 128-triangle blocks (one tile for the resident case).
// Packet p (rays 8p .. 8p + 7) carries n_words culling words per tile
// (ops/culling.py::packet_tile_words_multi): bit j of word w of tile t
// covers the tile-local blocks [(w * 31 + j) * granule, ... + granule),
// clipped to blocks_per_tile, and is set iff some live lane of the packet
// passes the slab test of that granule's union AABB. Every ray of the packet
// tests the blocks of its set bits with the shared Moller-Trumbore test
// (mt.cuh), keeping the lexicographic minimum of (dst, original index). A
// packet with no set bit misses.
//
// The TPU kernel writes one result per (tile, program) and folds the tiles
// afterwards by lex-min, because its grid is sequential and its revisited
// output blocks were unreliable. Here the walk runs over the tiles inside
// the warp and the running bests carry across tiles: a lex-min over a
// partition is the lex-min over the whole, so the result bits are the same,
// and it equals the plain version (ops/search_packed.py::
// search_packed_reference) on the card.
//
// What bounds it on an H100: FP32 issue, as for search_bitmask.cu (61
// un-fused operations per MT test, 8 x 128 tests per block against 6.5 KB
// of plane rows); the plane (8.5 MB at 163,840 triangles) stays in the
// 50 MB L2, and the words are 4 bytes per (packet, tile, word). The design
// is packet_walk.cuh's: one warp per packet walking its own bits tile by
// tile, each bit's granule blocks clipped to the tile, triangles across the
// lanes and the packet's 8 rays in registers. Left out as TPU scheduling
// aids that change no result: the packing of active columns per (program,
// tile), the descending-popcount sort and the grouped lockstep walk
// (RTC_COL_GROUP).

#include <cuda_runtime.h>
#include <stdint.h>

#include "packet_walk.cuh"

namespace {

__global__ void __launch_bounds__(rtc::kPacketThreads)
search_packed_kernel(const float* __restrict__ o,           // [R, 3]
                     const float* __restrict__ d,           // [R, 3]
                     const int32_t* __restrict__ words,     // [ceil(R/8), n_tiles, W]
                     const float* __restrict__ plane,       // [12, n_tiles * tile]
                     const int32_t* __restrict__ orig_idx,  // [n_tiles * tile]
                     int n_rays, int n_tiles, int n_words,
                     int blocks_per_tile, int granule,
                     float* __restrict__ dst_out,           // [R]
                     int32_t* __restrict__ idx_out) {       // [R]
  rtc::search_packet(o, d, words, plane, orig_idx, n_rays, n_tiles, n_words,
                     blocks_per_tile, granule, dst_out, idx_out, nullptr);
}

}  // namespace

extern "C" {

// Launches the search on `stream` and returns cudaGetLastError() as an int
// (0 = launched).
int rtc_search_packed(const void* o, const void* d, const void* words,
                      const void* plane, const void* orig_idx, int n_rays,
                      int n_tiles, int n_words, int blocks_per_tile,
                      int granule, void* dst, void* idx, void* stream) {
  if (n_rays <= 0) return static_cast<int>(cudaGetLastError());
  const int packets = (n_rays + rtc::kPacket - 1) / rtc::kPacket;
  const int blocks = (packets + rtc::kPacketWarps - 1) / rtc::kPacketWarps;
  search_packed_kernel<<<blocks, rtc::kPacketThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(o), static_cast<const float*>(d),
      static_cast<const int32_t*>(words), static_cast<const float*>(plane),
      static_cast<const int32_t*>(orig_idx), n_rays, n_tiles, n_words,
      blocks_per_tile, granule, static_cast<float*>(dst),
      static_cast<int32_t*>(idx));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
