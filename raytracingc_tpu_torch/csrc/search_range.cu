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
// max(first, 0) .. min(last, n_blocks - 1), in ascending order with the
// shared Moller-Trumbore test (mt.cuh), and keeps the lexicographic minimum
// of (dst, original index). An empty span tests nothing: (MISS_DST, -1).
//
// Why one kernel serves both. The span holds GLOBAL block ids, so it does
// not depend on tiling. The streamed TPU kernel clips the span to each tile,
// takes each tile's lex-min (-1 when it misses) and merges the tiles into
// its revisited output with
//   take = d < cur_d || (d == cur_d && i >= 0 && i < cur_i)
// (intersect_pallas.py:415-425): a lex-min over the tiles' real hits, in
// which a miss never replaces anything. The clipped pieces partition the
// span, and the lex-min over a partition is the lex-min over the whole, so
// its bits are those of one ascending walk over the span of the tile-padded
// plane (ops/culling.py::stream_tile_pad; the padding blocks lie past every
// span, which the prelude takes from the real blocks only). That walk is
// the resident kernel's walk on that plane, and it is what this kernel does
// for both; it equals the plain version (ops/search_range.py::
// search_range_reference) on the card.
//
// What bounds it on an H100: the MT work, ~60 FP32 operations per (ray,
// tested triangle), over every block of the span, hit or not (the TPU
// kernel's semantics: on the box scene's incoherent secondary bounces a
// span can cover most of the scene). The plane stays in the 50 MB L2
// (8.5 MB at 163,840 triangles). What the design does about it: one thread
// per ray keeps the ray and its best in registers; the warp (4 packets)
// walks from the least `first` to the greatest `last` of its lanes
// (__reduce_min_sync / __reduce_max_sync), so packets whose spans overlap
// test a shared block in step and read its rows once per warp, while a lane
// outside its own span idles. Left out as TPU aids that change no result:
// the per-program dead flags (a program of empty spans tests nothing here
// either) and the SMEM ray slicing. No shared memory, no tensor cores: the
// simple first version.

#include <cuda_runtime.h>
#include <stdint.h>

#include "mt.cuh"

namespace {

constexpr int kThreads = 256;           // rays per block: 32 packets, 8 warps
constexpr int kEmptyFirst = 1 << 30;    // `first` of an empty span

__global__ void __launch_bounds__(kThreads)
search_range_kernel(const float* __restrict__ o,           // [R, 3]
                    const float* __restrict__ d,           // [R, 3]
                    const int32_t* __restrict__ first,     // [ceil(R/8)]
                    const int32_t* __restrict__ last,      // [ceil(R/8)]
                    const float* __restrict__ plane,       // [12, T]
                    const int32_t* __restrict__ orig_idx,  // [T]
                    int n_rays, int n_blocks,
                    float* __restrict__ dst_out,           // [R]
                    int32_t* __restrict__ idx_out) {       // [R]
  const int r = blockIdx.x * kThreads + threadIdx.x;
  const bool in_range = r < n_rays;
  const rtc::Ray ray = rtc::load_ray(o, d, r, in_range);
  const int64_t t_stride = static_cast<int64_t>(n_blocks) * rtc::kBlock;

  int lo = kEmptyFirst;
  int hi = -1;
  if (in_range) {
    lo = max(__ldg(first + r / rtc::kPacket), 0);
    hi = min(__ldg(last + r / rtc::kPacket), n_blocks - 1);
  }
  const int warp_lo = __reduce_min_sync(0xffffffffu, lo);
  const int warp_hi = __reduce_max_sync(0xffffffffu, hi);

  float best_d = rtc::kMissDst;
  int32_t best_i = rtc::kBigIdx;
  for (int b = warp_lo; b <= warp_hi; ++b) {  // uniform over the warp
    if (b >= lo && b <= hi) {
      rtc::mt_block(ray, plane, orig_idx, t_stride, b, best_d, best_i);
    }
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
int rtc_search_range(const void* o, const void* d, const void* first,
                     const void* last, const void* plane,
                     const void* orig_idx, int n_rays, int n_blocks,
                     void* dst, void* idx, void* stream) {
  if (n_rays <= 0) return static_cast<int>(cudaGetLastError());
  const int blocks = (n_rays + kThreads - 1) / kThreads;
  search_range_kernel<<<blocks, kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(o), static_cast<const float*>(d),
      static_cast<const int32_t*>(first), static_cast<const int32_t*>(last),
      static_cast<const float*>(plane), static_cast<const int32_t*>(orig_idx),
      n_rays, n_blocks, static_cast<float*>(dst),
      static_cast<int32_t*>(idx));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
