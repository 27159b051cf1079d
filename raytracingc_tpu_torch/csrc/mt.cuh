// Shared device code of the triangle-search kernels (sm_90a).
//
// The counterpart of raytracingc_tpu/ops/intersect_pallas.py::_mt_block_test
// and of the per-triangle body of _search_kernel_brute: one Moller-Trumbore
// test per (ray, triangle) pair with the backface cull on the stored normal,
// the EPSILON guards, IEEE division and, with the library built with
// --fmad=false, every multiply and add rounded on its own. Every kernel of
// the library runs this one function, so the kernels agree with each other
// and with the plain PyTorch versions (ops/search_brute.py::mt_distance) bit
// for bit.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace rtc {

constexpr float kEpsilon = 1e-3f;      // scene/types.py EPSILON
constexpr float kMissDst = 999999.0f;  // scene/types.py MISS_DST
constexpr int32_t kBigIdx = 1 << 30;   // orig_idx of padding slots
constexpr int kBlock = 128;            // triangles per accel block
constexpr int kPacket = 8;             // rays per culling packet
constexpr int kBitsPerWord = 31;       // culling bits per int32 word

struct Ray {
  float ox, oy, oz, dx, dy, dz;
};

// Ray r of the [R, 3] origin and direction arrays; zeros past the end.
__device__ __forceinline__ Ray load_ray(const float* __restrict__ o,
                                        const float* __restrict__ d, int r,
                                        bool in_range) {
  Ray ray{0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  if (in_range) {
    ray.ox = o[3 * r + 0]; ray.oy = o[3 * r + 1]; ray.oz = o[3 * r + 2];
    ray.dx = d[3 * r + 0]; ray.dy = d[3 * r + 1]; ray.dz = d[3 * r + 2];
  }
  return ray;
}

// Distance from the ray to the triangle (A, AB = B - A, AC = C - A, stored
// normal N), or kMissDst when the test rejects it.
__device__ __forceinline__ float mt_distance(
    const Ray& r, float ax, float ay, float az, float abx, float aby,
    float abz, float acx, float acy, float acz, float nx, float ny,
    float nz) {
  const float dn = r.dx * nx + r.dy * ny + r.dz * nz;  // backface cull
  const float hx = r.dy * acz - r.dz * acy;
  const float hy = r.dz * acx - r.dx * acz;
  const float hz = r.dx * acy - r.dy * acx;
  const float det = abx * hx + aby * hy + abz * hz;
  const bool degenerate = fabsf(det) < kEpsilon;
  const float inv_det = 1.0f / (degenerate ? 1.0f : det);
  const float sx = r.ox - ax;
  const float sy = r.oy - ay;
  const float sz = r.oz - az;
  const float u = (sx * hx + sy * hy + sz * hz) * inv_det;
  const float qx = sy * abz - sz * aby;
  const float qy = sz * abx - sx * abz;
  const float qz = sx * aby - sy * abx;
  const float v = (r.dx * qx + r.dy * qy + r.dz * qz) * inv_det;
  const float dst = (acx * qx + acy * qy + acz * qz) * inv_det;
  const bool valid = (dn < 0.0f) && !degenerate && (u >= 0.0f) &&
                     (u <= 1.0f) && (v >= 0.0f) && (u + v <= 1.0f) &&
                     (dst >= kEpsilon);
  return valid ? dst : kMissDst;
}

// Tests the 128 triangles of block `blk` of the (12, t_stride) plane of A,
// AB, AC, N rows (ops/accel.py packed_plane) and keeps the running best
// lexicographically on (dst, orig_idx): among equal distances the lowest
// ORIGINAL index wins, whatever order the Morton permutation put them in.
__device__ __forceinline__ void mt_block(const Ray& r,
                                         const float* __restrict__ plane,
                                         const int32_t* __restrict__ orig_idx,
                                         int64_t t_stride, int64_t blk,
                                         float& best_d, int32_t& best_i) {
  const int64_t base = blk * kBlock;
  for (int k = 0; k < kBlock; ++k) {
    const float* p = plane + base + k;
    const float dst = mt_distance(
        r, __ldg(p), __ldg(p + t_stride), __ldg(p + 2 * t_stride),
        __ldg(p + 3 * t_stride), __ldg(p + 4 * t_stride),
        __ldg(p + 5 * t_stride), __ldg(p + 6 * t_stride),
        __ldg(p + 7 * t_stride), __ldg(p + 8 * t_stride),
        __ldg(p + 9 * t_stride), __ldg(p + 10 * t_stride),
        __ldg(p + 11 * t_stride));
    const int32_t oi = __ldg(orig_idx + base + k);
    if (dst < best_d || (dst == best_d && oi < best_i)) {
      best_d = dst;
      best_i = oi;
    }
  }
}

}  // namespace rtc
