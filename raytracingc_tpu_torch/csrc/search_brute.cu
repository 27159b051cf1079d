// Brute-force closest-hit triangle search, hand-written for Hopper (sm_90a).
//
// Replaces raytracingc_tpu/ops/intersect_pallas.py::_search_kernel_brute,
// together with the dead-lane post-mask its launcher applies in
// search_triangles_pallas. For every ray it runs the Moller-Trumbore test
// against every live triangle in original order and keeps the closest hit:
//
//   * backface cull on d.N < 0 against the stored face normal;
//   * the |det| < EPSILON degenerate guard, with inv_det = 1 / (deg ? 1 : det);
//   * u >= 0, u <= 1, v >= 0, u + v <= 1 and dst >= EPSILON;
//   * a strict '<' over ascending triangle index, so among equal distances
//     the lowest index wins (the C scan order);
//   * dead lanes (alive[r] == 0) and misses write (MISS_DST, -1).
//
// The arithmetic is that of the TPU kernel, op for op and in the same order
// (rtc::mt_distance in mt.cuh, shared with the packet kernels). Built with
// --fmad=false, IEEE division and no flush-to-zero, every multiply and add
// rounds on its own, as PyTorch's eager elementwise ops do, so dst and idx
// equal the plain version (ops/search_brute.py::search_brute_reference) bit
// for bit on the card.
//
// What bounds it on an H100: about 60 floating-point operations per (ray,
// triangle) pair and 24 + 1 bytes in, 8 bytes out per ray. At 640 triangles
// (box_scene tessellated 64-fold) the pair work is ~2.5 GFLOP per 65,536-ray
// call, so the kernel is compute bound; at 10 triangles (box_scene) the work
// is ~40 MFLOP and the launch itself dominates.
//
// What the design does about it: one thread per ray keeps the ray and its
// running best in registers for the whole scan, so the inner loop is pure
// FP32 ALU work. Triangles are staged through shared memory in tiles of 256
// rows (12 KB), loaded cooperatively; every thread of the block then reads the
// same row, a broadcast with no bank conflicts. A block whose 256 lanes are
// all dead skips the scan (__syncthreads_or), as the TPU kernel skips dead
// programs. The kernel launches on the caller's stream, does not synchronise
// and allocates nothing. No tensor cores and no TMA: this is the correct,
// simple first version.

#include <cuda_runtime.h>
#include <stdint.h>

#include "mt.cuh"

namespace {

using rtc::kMissDst;
constexpr int kThreads = 256;          // rays per block
constexpr int kTile = 256;             // triangle rows staged per pass
constexpr int kRow = 12;               // A, AB, AC, N

__global__ void __launch_bounds__(kThreads)
search_brute_kernel(const float* __restrict__ o,        // [R, 3]
                    const float* __restrict__ d,        // [R, 3]
                    const uint8_t* __restrict__ alive,  // [R] or null
                    const float* __restrict__ tri,      // [n_live, 12]
                    int n_rays, int n_live,
                    float* __restrict__ dst_out,        // [R]
                    int32_t* __restrict__ idx_out) {    // [R]
  __shared__ float s_tri[kTile * kRow];

  const int r = blockIdx.x * kThreads + threadIdx.x;
  const bool in_range = r < n_rays;
  const bool live = in_range && (alive == nullptr || alive[r] != 0);

  const rtc::Ray ray = rtc::load_ray(o, d, r, in_range);
  float best_d = kMissDst;
  int32_t best_i = -1;

  // Block-uniform: every thread reaches the barriers below, or none does.
  if (__syncthreads_or(live)) {
    for (int base = 0; base < n_live; base += kTile) {
      const int n = min(kTile, n_live - base);
      const float* src = tri + static_cast<size_t>(base) * kRow;
      for (int k = threadIdx.x; k < n * kRow; k += kThreads) s_tri[k] = src[k];
      __syncthreads();
      if (live) {
        for (int j = 0; j < n; ++j) {
          const float* t = s_tri + j * kRow;
          const float dst = rtc::mt_distance(ray, t[0], t[1], t[2], t[3], t[4],
                                             t[5], t[6], t[7], t[8], t[9],
                                             t[10], t[11]);
          if (dst < best_d) {  // strict '<': original order = C scan order
            best_d = dst;
            best_i = base + j;
          }
        }
      }
      __syncthreads();
    }
  }
  if (in_range) {
    dst_out[r] = live ? best_d : kMissDst;
    idx_out[r] = live ? best_i : -1;
  }
}

}  // namespace

extern "C" {

// Launches the search on `stream` and returns cudaGetLastError() as an int
// (0 = launched). `alive` may be null (every lane live).
int rtc_search_brute(const void* o, const void* d, const void* alive,
                     const void* tri, int n_rays, int n_live, void* dst,
                     void* idx, void* stream) {
  if (n_rays <= 0) return static_cast<int>(cudaGetLastError());
  const int blocks = (n_rays + kThreads - 1) / kThreads;
  search_brute_kernel<<<blocks, kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(o), static_cast<const float*>(d),
      static_cast<const uint8_t*>(alive), static_cast<const float*>(tri),
      n_rays, n_live, static_cast<float*>(dst), static_cast<int32_t*>(idx));
  return static_cast<int>(cudaGetLastError());
}

const char* rtc_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
