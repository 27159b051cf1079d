// Union-walk search over the block-AABB accel, hand-written for Hopper (K9).
//
// Replaces tools/union_walk_ab.py::_union_kernel (launcher
// _search_padded_union), the JAX package's A/B prototype of program-level
// culling with scalar Moller-Trumbore. Rays come in programs of 1,024 (ray
// r is in program r / 1024). Program g carries n_words union words: bit j of
// word w is set iff some live lane of one of the program's 128 packets
// passes the slab test of block w * 31 + j (ops/culling.py::
// program_union_words); flags[g] is 0 iff all its words are. Every ray of the
// program tests every triangle of those blocks, in ascending block order,
// with the shared MT test (mt.cuh) and keeps the lexicographic minimum of
// (dst, original index). This is the TPU kernel's result bit for bit, and
// equals the plain version (ops/search_union.py::search_union_reference).
//
// What bounds it on an H100: the MT work, ~60 FP32 operations per (ray,
// tested triangle), of every union block for all 1,024 rays of the program:
// the union holds more blocks than a ray's packet (pair inflation, counted
// in chip_smoke.py), so it tests more pairs than the per-packet kernels.
//
// What the design does about it: one thread per ray. A CTA of 256 rays lies
// in one program, so all its lanes walk the same word with __ffs: no lane
// idles through another packet's bits, no warp diverges, and each block's
// rows are read by every warp in step (L1/L2 hits). No shared memory.

#include <cuda_runtime.h>
#include <stdint.h>

#include "mt.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kRaysPerProgram = 1024;
static_assert(kRaysPerProgram % kThreads == 0, "a CTA lies in one program");

__global__ void __launch_bounds__(kThreads)
search_union_kernel(const float* __restrict__ o,          // [R, 3]
                    const float* __restrict__ d,          // [R, 3]
                    const int32_t* __restrict__ words,    // [G, n_words]
                    const int32_t* __restrict__ flags,    // [G]
                    const float* __restrict__ plane,      // [12, T]
                    const int32_t* __restrict__ orig_idx, // [T]
                    int n_rays, int n_words, int n_blocks,
                    float* __restrict__ dst_out,          // [R]
                    int32_t* __restrict__ idx_out) {      // [R]
  const int r = blockIdx.x * kThreads + threadIdx.x;
  const int prog = blockIdx.x * kThreads / kRaysPerProgram;
  const bool in_range = r < n_rays;
  const rtc::Ray ray = rtc::load_ray(o, d, r, in_range);
  const int64_t t_stride = static_cast<int64_t>(n_blocks) * rtc::kBlock;

  float best_d = rtc::kMissDst;
  int32_t best_i = rtc::kBigIdx;
  if (__ldg(flags + prog) != 0) {  // uniform over the CTA
    for (int w = 0; w < n_words; ++w) {
      uint32_t m = static_cast<uint32_t>(__ldg(words + prog * n_words + w));
      while (m != 0u) {
        const int blk = w * rtc::kBitsPerWord + __ffs(m) - 1;
        m &= m - 1u;
        if (blk < n_blocks) {
          rtc::mt_block(ray, plane, orig_idx, t_stride, blk, best_d, best_i);
        }
      }
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
int rtc_search_union(const void* o, const void* d, const void* words,
                     const void* flags, const void* plane,
                     const void* orig_idx, int n_rays, int n_words,
                     int n_blocks, void* dst, void* idx, void* stream) {
  if (n_rays <= 0) return static_cast<int>(cudaGetLastError());
  const int blocks = (n_rays + kThreads - 1) / kThreads;
  search_union_kernel<<<blocks, kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(o), static_cast<const float*>(d),
      static_cast<const int32_t*>(words), static_cast<const int32_t*>(flags),
      static_cast<const float*>(plane), static_cast<const int32_t*>(orig_idx),
      n_rays, n_words, n_blocks, static_cast<float*>(dst),
      static_cast<int32_t*>(idx));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
