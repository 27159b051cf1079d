// Brute-force closest-hit triangle search, designed for Hopper (sm_90a).
//
// Replaces raytracingc_tpu/ops/intersect_pallas.py::_search_kernel_brute,
// together with the dead-lane post-mask its launcher applies in
// search_triangles_pallas. For every ray it runs the Moller-Trumbore test
// against every live triangle and keeps the closest hit:
//
//   * backface cull on d.N < 0 against the stored face normal;
//   * the |det| < EPSILON degenerate guard, with inv_det = 1 / (deg ? 1 : det);
//   * u >= 0, u <= 1, v >= 0, u + v <= 1 and dst >= EPSILON;
//   * among equal distances the lowest triangle index wins (the C scan
//     order: a strict '<' over ascending index);
//   * dead lanes (alive[r] == 0) and misses write (MISS_DST, -1).
//
// The arithmetic is that of the TPU kernel, op for op and in the same order
// (rtc::mt_distance in mt.cuh, shared with the packet kernels). Built with
// --fmad=false, IEEE division and no flush-to-zero, every multiply and add
// rounds on its own, as PyTorch's eager elementwise ops do, so dst and idx
// equal the plain version (ops/search_brute.py::search_brute_reference) bit
// for bit on the card.
//
// What bounds it on an H100: the FP32 issue rate. Each live (ray, triangle)
// pair is one MT test: 61 operations (chip_smoke.py MT_OPS), ~80 issued
// instructions with the IEEE reciprocal's refinement and range check, the
// three LDS.128, the running best and the loop (tools/sass_loop.py counts
// them in the built library). 24 + 1 bytes in and 8 out per ray are
// nothing beside that. At 640 triangles and 65,536 rays the work is ~2.5
// GFLOP; at box_scene's 10 triangles the launch and the host path are the
// whole cost.
//
// What the design does about it:
// - Parts. S lanes share one ray's scan (S = 1..16, a power of two, from the
//   ray and triangle counts: brute_parts below), so that a 65,536-ray call
//   still gives every SM more warps than it holds (S = 8: 16,384 warps for
//   132 SMs of 48) to hide the MT test's chain of dependent operations; a
//   compacted bounce of 16,384 rays gets S = 16. Lane `part` of a ray scans
//   triangles part, part + S, part + 2S, ... in ascending order with the
//   strict '<', and a shuffle lex-min on (dst, idx) merges the S results,
//   the identity being (kMissDst, -1). That is the sequential scan bit for
//   bit: every pair's dst has the same bits in any lane, a lane keeps the
//   lowest index among its part's least distances, and the lex-min of the
//   parts is the lowest index among all least distances. A hit at exactly
//   kMissDst is never recorded, by the scan or a part. The parts interleave
//   (rather than being contiguous ranges) so that the S lanes of a ray read
//   S neighbouring 48-byte rows: one shared-memory wavefront without bank
//   conflicts for S <= 8. (ops/search_brute.py::search_brute_split is the
//   plain model.)
// - Dense warps. A CTA of 512 lanes owns 512 / S rays. It reads their alive
//   flags, writes (kMissDst, -1) for the dead ones at once, and packs the
//   live ones (ballot and popc per warp, then a scan of the warp counts)
//   into the first groups of lanes. Warps left without a ray leave at once.
// - Registers. Over a staged table the kernel fits 40 registers with no
//   spill, so 3 CTAs (48 warps) share an SM. At 640 triangles and 65,536
//   rays on the H100, 64 registers (32 warps), 256-lane CTAs and two
//   triangles a loop pass each timed slower; so did 4 lanes a ray with
//   dead lanes and 16 with all lanes live (PERF.md, K1's redesign:
//   tools/packet_sweep.py --match K1 from edited copies).
// - The table staged once per CTA. Up to kTileRows triangles (72 KB: three
//   CTAs fit an SM's shared memory), the whole [n_live, 12] table is brought
//   into shared memory by every thread's plain loads before the compaction,
//   and each row is read back as three float4. Packed rows are copied as
//   float4; a table of given vertices (the pack-free entry,
//   rtc_search_brute_tris) has each thread form AB = b - a and AC = c - a
//   of its rows with the same IEEE subtraction as
//   ops/search_brute.py::pack_triangles, so the same bits. (Bulk
//   asynchronous copies on an mbarrier staged the packed rows no faster:
//   PERF.md, K1's redesign.) Larger tables (RTC_KERNEL=brute at any size)
//   are walked in tiles of kTileRows rows, with two barriers per tile.
// The kernel launches on the caller's stream, does not synchronise and
// allocates nothing.

#include <cuda_runtime.h>
#include <stdint.h>

#include "mt.cuh"

namespace {

using rtc::kMissDst;
constexpr int kThreads = 512;                       // lanes per CTA
constexpr int kWarps = kThreads / 32;
// CTAs per SM: 3 (<= 40 registers a thread, 48 warps an SM) over a staged
// table, 2 (<= 64 registers, 32 warps) for the tiled walk, whose tile loop
// keeps more state: ptxas spills it at 40 or 48 registers.
constexpr int kMinBlocks = 3;
constexpr int kMinBlocksTiled = 2;
constexpr int kRow = 12;                            // A, AB, AC, N
constexpr int kTileRows = 1536;                     // rows staged at once
constexpr int kTileBytes = kTileRows * kRow * 4;    // 73,728
constexpr int64_t kFillLanes = 132 * 2048;          // an H100's resident threads
constexpr int kMaxParts = 16;
constexpr int kMinPartRows = 16;                    // rows per part, at least

// Where the triangles come from: packed rows, or the scene's vertices and
// normals ([n, 3] each) when rows is null.
struct Table {
  const float* rows;
  const float* a;
  const float* b;
  const float* c;
  const float* n;
};

// Lanes per ray: the smallest power of two S that gives the call about a
// card's worth of threads (n_rays * S >= kFillLanes), at most kMaxParts and
// with at least kMinPartRows rows per part.
int brute_parts(int n_rays, int n_live) {
  int s = 1;
  while (s < kMaxParts && static_cast<int64_t>(n_rays) * s < kFillLanes &&
         n_live >= 2 * s * kMinPartRows) {
    s *= 2;
  }
  return s;
}

// Rows [base, base + rows) of the table into s_rows by plain loads, every
// thread of the CTA taking part.
__device__ __forceinline__ void stage(const Table& tb, int base, int rows,
                                      float4* s_rows) {
  if (tb.rows != nullptr) {
    const float* src = tb.rows + static_cast<size_t>(base) * kRow;
    if ((reinterpret_cast<uintptr_t>(src) & 15) == 0) {
      const float4* src4 = reinterpret_cast<const float4*>(src);
      for (int k = threadIdx.x; k < rows * 3; k += kThreads) s_rows[k] = __ldg(src4 + k);
    } else {
      float* dst = reinterpret_cast<float*>(s_rows);
      for (int k = threadIdx.x; k < rows * kRow; k += kThreads) dst[k] = __ldg(src + k);
    }
    return;
  }
  for (int j = threadIdx.x; j < rows; j += kThreads) {
    const size_t v = 3 * static_cast<size_t>(base + j);
    const float ax = __ldg(tb.a + v), ay = __ldg(tb.a + v + 1), az = __ldg(tb.a + v + 2);
    const float bx = __ldg(tb.b + v), by = __ldg(tb.b + v + 1), bz = __ldg(tb.b + v + 2);
    const float cx = __ldg(tb.c + v), cy = __ldg(tb.c + v + 1), cz = __ldg(tb.c + v + 2);
    const float nx = __ldg(tb.n + v), ny = __ldg(tb.n + v + 1), nz = __ldg(tb.n + v + 2);
    s_rows[3 * j] = make_float4(ax, ay, az, bx - ax);
    s_rows[3 * j + 1] = make_float4(by - ay, bz - az, cx - ax, cy - ay);
    s_rows[3 * j + 2] = make_float4(cz - az, nx, ny, nz);
  }
}

// This lane's part of one ray's scan over the staged rows [0, rows), whose
// first is triangle `base`: rows part, part + S, ... in ascending order.
template <int S>
__device__ __forceinline__ void scan(const float4* __restrict__ s_rows,
                                     int base, int rows, int part,
                                     const rtc::Ray& ray, float& best_d,
                                     int32_t& best_i) {
#pragma unroll 1
  for (int j = part; j < rows; j += S) {
    const float4 p = s_rows[3 * j];
    const float4 q = s_rows[3 * j + 1];
    const float4 w = s_rows[3 * j + 2];
    const float dst = rtc::mt_distance(ray, p.x, p.y, p.z, p.w, q.x, q.y,
                                       q.z, q.w, w.x, w.y, w.z, w.w);
    if (dst < best_d) {  // strict '<': the lowest index of the part wins
      best_d = dst;
      best_i = base + j;
    }
  }
}

// kTiled: the table is walked in tiles of kTileRows rows (n_live >
// kTileRows), else staged whole once.
template <int S, bool kTiled>
__global__ void __launch_bounds__(kThreads, kTiled ? kMinBlocksTiled : kMinBlocks)
search_brute_kernel(const float* __restrict__ o,        // [R, 3]
                    const float* __restrict__ d,        // [R, 3]
                    const uint8_t* __restrict__ alive,  // [R] or null
                    const Table tb, int n_rays, int n_live,
                    float* __restrict__ dst_out,        // [R]
                    int32_t* __restrict__ idx_out) {    // [R]
  constexpr int kRays = kThreads / S;   // rays of this CTA
  constexpr int kGroups = 32 / S;       // rays of a warp
  extern __shared__ __align__(16) float4 s_rows[];  // [min(n_live, kTileRows) * 3]
  __shared__ int s_ray[kRays];                      // the live rays, packed
  __shared__ int s_count[kWarps];

  const int t = threadIdx.x;
  const int lane = t & 31;
  const int warp = t >> 5;
  const int first = blockIdx.x * kRays;
  stage(tb, 0, n_live < kTileRows ? n_live : kTileRows, s_rows);

  // Pack the live rays of the CTA into the first groups of lanes.
  bool live = false;
  if (t < kRays) {
    const int r = first + t;
    if (r < n_rays) {
      live = alive == nullptr || alive[r] != 0;
      if (!live) {
        dst_out[r] = kMissDst;
        idx_out[r] = -1;
      }
    }
  }
  const uint32_t mask = __ballot_sync(0xffffffffu, live);
  if (lane == 0) s_count[warp] = __popc(mask);
  __syncthreads();  // also: the first tile is staged
  int k = 0;
  int before = 0;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    const int c = s_count[w];
    before += w < warp ? c : 0;
    k += c;
  }
  if (live) s_ray[before + __popc(mask & ((1u << lane) - 1u))] = first + t;
  __syncthreads();

  const int g = warp * kGroups + lane / S;  // this lane's slot in s_ray
  const int part = lane % S;
  const bool busy = warp * kGroups < k;     // warp-uniform
  const bool has_ray = g < k;
  const int r = has_ray ? s_ray[g] : 0;
  const rtc::Ray ray = rtc::load_ray(o, d, r, has_ray);
  float best_d = kMissDst;
  int32_t best_i = -1;
  if (!kTiled) {
    if (!busy) return;
    if (has_ray) scan<S>(s_rows, 0, n_live, part, ray, best_d, best_i);
  } else {
    for (int base = 0; base < n_live; base += kTileRows) {
      const int rows = n_live - base < kTileRows ? n_live - base : kTileRows;
      if (base > 0) {
        __syncthreads();  // every lane is done with the last tile
        stage(tb, base, rows, s_rows);
        __syncthreads();
      }
      if (has_ray) scan<S>(s_rows, base, rows, part, ray, best_d, best_i);
    }
    if (!busy) return;
  }

  // Lex-min of the S parts; lane `part == 0` of each group holds the ray's.
#pragma unroll
  for (int off = S / 2; off > 0; off >>= 1) {
    const float od = __shfl_xor_sync(0xffffffffu, best_d, off);
    const int32_t oi = __shfl_xor_sync(0xffffffffu, best_i, off);
    rtc::lex_min(best_d, best_i, od, oi);
  }
  if (has_ray && part == 0) {
    dst_out[r] = best_d;
    idx_out[r] = best_i;
  }
}

template <int S, bool kTiled>
cudaError_t launch(const float* o, const float* d, const uint8_t* alive,
                   const Table& tb, int n_rays, int n_live, float* dst,
                   int32_t* idx, cudaStream_t stream) {
  static uint64_t limit_set = 0;  // devices whose shared-memory limit is raised
  const int rows = n_live < 1 ? 1 : (n_live < kTileRows ? n_live : kTileRows);
  const size_t smem = static_cast<size_t>(rows) * kRow * sizeof(float);
  if (smem > 48 * 1024) {
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return err;
    const uint64_t bit = dev < 64 ? uint64_t{1} << dev : 0;
    if (!(limit_set & bit)) {
      err = cudaFuncSetAttribute(search_brute_kernel<S, kTiled>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 kTileBytes);
      if (err != cudaSuccess) return err;
      limit_set |= bit;
    }
  }
  constexpr int kRays = kThreads / S;
  const int grid = (n_rays + kRays - 1) / kRays;
  search_brute_kernel<S, kTiled><<<grid, kThreads, smem, stream>>>(
      o, d, alive, tb, n_rays, n_live, dst, idx);
  return cudaGetLastError();
}

template <bool kTiled>
cudaError_t by_parts(const float* o, const float* d, const uint8_t* alive,
                     const Table& tb, int n_rays, int n_live, float* dst,
                     int32_t* idx, cudaStream_t s) {
  switch (brute_parts(n_rays, n_live)) {
    case 1: return launch<1, kTiled>(o, d, alive, tb, n_rays, n_live, dst, idx, s);
    case 2: return launch<2, kTiled>(o, d, alive, tb, n_rays, n_live, dst, idx, s);
    case 4: return launch<4, kTiled>(o, d, alive, tb, n_rays, n_live, dst, idx, s);
    case 8: return launch<8, kTiled>(o, d, alive, tb, n_rays, n_live, dst, idx, s);
    default: return launch<16, kTiled>(o, d, alive, tb, n_rays, n_live, dst, idx, s);
  }
}

int search(const void* o, const void* d, const void* alive, const Table& tb,
           int n_rays, int n_live, void* dst, void* idx, void* stream) {
  if (n_rays <= 0) return static_cast<int>(cudaGetLastError());
  const float* of = static_cast<const float*>(o);
  const float* df = static_cast<const float*>(d);
  const uint8_t* al = static_cast<const uint8_t*>(alive);
  float* dd = static_cast<float*>(dst);
  int32_t* id = static_cast<int32_t*>(idx);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return static_cast<int>(n_live > kTileRows
                              ? by_parts<true>(of, df, al, tb, n_rays, n_live, dd, id, s)
                              : by_parts<false>(of, df, al, tb, n_rays, n_live, dd, id, s));
}

}  // namespace

extern "C" {

// Launches the search on `stream` and returns cudaGetLastError() as an int
// (0 = launched). `tri` holds [n_live, 12] packed rows (A, AB, AC, N);
// `alive` may be null (every lane live).
int rtc_search_brute(const void* o, const void* d, const void* alive,
                     const void* tri, int n_rays, int n_live, void* dst,
                     void* idx, void* stream) {
  const Table tb{static_cast<const float*>(tri), nullptr, nullptr, nullptr, nullptr};
  return search(o, d, alive, tb, n_rays, n_live, dst, idx, stream);
}

// The same search over the scene's own [n_live, 3] vertex and normal arrays
// (the pack-free entry): AB and AC are formed while staging.
int rtc_search_brute_tris(const void* o, const void* d, const void* alive,
                          const void* a, const void* b, const void* c,
                          const void* normal, int n_rays, int n_live,
                          void* dst, void* idx, void* stream) {
  const Table tb{nullptr, static_cast<const float*>(a),
                 static_cast<const float*>(b), static_cast<const float*>(c),
                 static_cast<const float*>(normal)};
  return search(o, d, alive, tb, n_rays, n_live, dst, idx, stream);
}

// Lanes per ray of a launch of n_rays rays over n_live triangles.
int rtc_search_brute_parts(int n_rays, int n_live) {
  return brute_parts(n_rays, n_live);
}

const char* rtc_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
