// Moller-Trumbore as bilinear forms on Hopper's tensor cores (K8).
//
// Replaces raytracingc_tpu/ops/intersect_mxu.py::_search_kernel_mxu (with
// _mxu_block_test, its per-block body, and the launcher _search_padded_mxu).
// Every MT quantity of a ray and a triangle is a dot product of 16 ray
// features f = [1, o, d, ox*dy, ox*dz, oy*dx, oy*dz, oz*dx, oz*dy, 0, 0, 0]
// with 16 coefficients of the triangle (ops/intersect_mxu.py::
// pack_coeffs_mxu, the [6T, 16] f32 table, block-major: 128 rows each of
// det, dn, u', v', t', index per 128-triangle block). Rays come in programs
// of 1,024; every ray of program g, dead lanes included, tests every block
// of g's union word (the OR of its 128 packets' block words, ops/culling.py
// ::program_union_words), and a program whose flag is 0 misses. Per (ray,
// triangle) pair:
//   det, dn, u', v'   on the tensor cores: mma.sync bf16 -> f32, A = the
//                     features of 16 rays, B = one plane of 8 triangles
//                     (m16n8k16; m16n8k8 for det and dn, whose
//                     coefficients are zero past the direction's columns
//                     4-6: the same sums, bit for bit on the H100, at half
//                     the tensor work); the four planes of the same rays
//                     and triangles land in the same (thread, register)
//                     slots, so the epilogue runs in registers;
//   t'                on the CUDA cores in f32, ((c0 + c1 ox) + c2 oy) +
//                     c3 oz, the plain version's op order (t' cancels
//                     catastrophically, so it stays off the bf16 path and is
//                     bitwise equal to the plain version);
//   the epilogue      inv_det = 1 / (|det| < EPS ? 1 : det), u, v, dst =
//                     t' inv_det and the MT validity tests (mt.cuh's), then
//                     the lexicographic minimum of (dst, ORIGINAL index),
//                     the index read from orig_idx (the TPU carried it as a
//                     matmul plane because Mosaic cannot gather).
// Dead lanes report (MISS_DST, -1).
//
// Precision. Hopper has no f32 tensor-core product, so both modes split
// each f32 operand x into bf16 parts (round to nearest even) whose products
// are exact in f32:
//   split3  (precision 0): x = hi + lo, three products ch.fh + ch.fl +
//           cl.fh into one accumulator (the JAX kernel's scheme, dropping
//           cl.fl, ~2^-16 of the term);
//   highest (precision 1): x = hi + mid + lo, the six products of parts
//           whose ranks sum to <= 2 ("bf16x6"; the dropped ones are below
//           2^-24 of the term), the same code with the number of parts as a
//           template parameter.
// The products are summed smallest first. The tensor cores' accumulation
// order and rounding are not specified, so the kernel equals its plain
// version (ops/intersect_mxu.py::search_mxu_reference) within a contract,
// not bit for bit: winners equal except at validity boundaries, distances
// within 1e-5 relative, or 2^-20 times det's condition number (capped at
// 128) on grazing hits (chip_smoke.py phase 3c). A pair's sums do not depend
// on the batch or on the order of the work items, so one call on R rays
// gives the bits of two calls on its halves, and two runs the same bits.
//
// What bounds it on an H100: per tested (ray, triangle) pair the four
// planes need 24 multiply-adds (the non-zero coefficients: det 3, dn 3,
// u' 9, v' 9), so 2 x 24 x (3 or 6) = 144 or 288 bf16 tensor-core FLOPs,
// and the epilogue 21 FP32 operations. At the peaks (989 TFLOP/s bf16 dense;
// 33.4e12 un-fused FP32 operations/s under --fmad=false) that is 0.15 or 0.29
// ps of tensor work against 0.63 ps of FP32 work per pair: the epilogue on
// the CUDA cores sets the bound in both modes. Program-level culling tests
// every block of the union for all 1,024 rays of a program (pair inflation
// over the per-packet kernels, counted in chip_smoke.py).
//
// What the design does about it:
//   * No staging. mxu_pack_kernel splits the table's four planes into bf16
//     parts once per call, into a scratch table (n_blocks x kParts x 16 KiB,
//     <= 3 MiB at the 8,192-triangle cap: it stays in the 50 MB L2) laid out
//     in the m16n8k16 A-fragment order: for each (block, plane, part, tile
//     of 16 triangles), lane l = 4 g + t holds one uint4 whose 8 bf16 are
//     rows g and g + 8, columns 2t, 2t + 1, 2t + 8, 2t + 9 (register i / 2 =
//     row g + 8 (i / 2 & 1), column 2t + (i & 1) + 8 (i / 4)). The search
//     kernel swaps the operands (rays as M, triangles as N): the same uint4
//     is the B fragment of two n-tiles, registers (0, 2) for triangles 0-7 of
//     the tile and (1, 3) for 8-15. A warp loads it with one 16-byte load per
//     lane: no shared memory, no __syncthreads, and no CTA re-splits a block
//     another has split. t' and orig_idx are read from the table and
//     orig_idx as they are.
//   * The ray side in registers: each lane builds the A fragments of its
//     rays (g and g + 8 of each 16-ray tile: features 2t, 2t + 1, 2t + 8,
//     2t + 9) once per work item, and keeps their origins for t'.
//   * Warps that fill the card whatever R is: a work item is (program, a
//     slice of kSlice rays, a run of <= kSplit of the program's union
//     blocks). mxu_items_kernel resets the keys and the claim counter
//     (packet_walk.cuh's reset_item_state) and writes the inclusive scan
//     of the programs' item counts itself; persistent warps claim items
//     (rtc::claim_items) and merge their rays' bests into the 64-bit keys
//     bits(dst) << 32 | orig_idx with atomicMin. A valid hit has dst >=
//     EPSILON and a miss is MISS_DST, never NaN, and orig_idx <= 2^30, so
//     the key orders like (dst, orig_idx) and the result does not depend on
//     the order of the items. The CUDA unpack of search_range.cu turns the
//     keys into (dst, idx), dead lanes into (MISS_DST, -1). One C call
//     (rtc_search_mxu) makes the four launches, so that the wrapper's host
//     time does not set a small scene's time (PERF.md).
//   * No epilogue where nothing can be valid (split3): a warp none of whose
//     128 (ray, triangle) slots of a 16 x 8 tile has dn < 0 and |det| >=
//     EPS (both required of a hit) skips the epilogue. For coherent rays a
//     tile of triangles on one face is back-facing as a whole. The vote
//     follows all four planes' products, so their chains overlap. On the
//     H100 it saved 9% at 2,560 coherent triangles in split3 and cost 7-8%
//     in highest, whose six-product chains overlap the epilogue better
//     without the branch, so highest does not vote (PERF.md, the K8
//     redesign).
// Not used: wgmma and TMA (the bound is the FP32 epilogue).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "packet_walk.cuh"

namespace {

constexpr int kFeats = 16;
constexpr int kQuantRows = 6 * rtc::kBlock;  // table rows per block
constexpr int kPlanes = 4;                   // det, dn, u', v'
constexpr int kTPlane = 4;                   // the t' plane of the table
constexpr int kTriTiles = rtc::kBlock / 16;  // tiles of 16 triangles a block
constexpr int kRaysPerProgram = 1024;
constexpr int kPackThreads = 256;
// Rays per work item (kSlice / 16 tiles of 16 rays per warp) and union
// blocks per work item. A/B on the H100 (PERF.md, the K8 redesign).
constexpr int kSlice = 32;
constexpr int kRayTiles = kSlice / 16;
constexpr int kSplit = 4;
static_assert(kRaysPerProgram % kSlice == 0, "a slice lies in one program");

// x split into kParts bf16 parts, each the round-to-nearest-even bf16 of
// what the earlier parts leave (each residual is exact in f32).
template <int kParts>
__device__ __forceinline__ void split(float x, uint16_t (&out)[kParts]) {
#pragma unroll
  for (int p = 0; p < kParts; ++p) {
    const __nv_bfloat16 h = __float2bfloat16_rn(x);
    out[p] = __bfloat16_as_ushort(h);
    x = x - __bfloat162float(h);
  }
}

// The kParts parts of a pair (x, y) of adjacent columns, packed as the
// mma.sync operands hold them: x in the low half, y in the high half.
template <int kParts>
__device__ __forceinline__ void split_pair(float x, float y,
                                           uint32_t (&out)[kParts]) {
  uint16_t px[kParts], py[kParts];
  split<kParts>(x, px);
  split<kParts>(y, py);
#pragma unroll
  for (int p = 0; p < kParts; ++p) {
    out[p] = static_cast<uint32_t>(px[p]) | (static_cast<uint32_t>(py[p]) << 16);
  }
}

// D = A B + C, A 16x16 row-major (rays x features), B 16x8 column-major
// (features x triangles), bf16 in, f32 out.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1,
                                         const float (&c)[4]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%10, %11, %12, %13};\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1),
        "f"(c[0]), "f"(c[1]), "f"(c[2]), "f"(c[3]));
}

// D = A B + C, A 16x8 row-major (rays x features 0-7), B 8x8 column-major
// (features 0-7 x triangles), bf16 in, f32 out.
__device__ __forceinline__ void mma_bf16_k8(float (&d)[4], uint32_t a0,
                                            uint32_t a1, uint32_t b,
                                            const float (&c)[4]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5}, {%6}, {%7, %8, %9, %10};\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
      : "r"(a0), "r"(a1), "r"(b), "f"(c[0]), "f"(c[1]), "f"(c[2]), "f"(c[3]));
}

// det or dn of n-tile h: their coefficients are zero past column 6 (the
// direction's), so the products run on features 0-7 only (m16n8k8: the
// A registers 0 and 1, the B register x or y), in plane_mma's order.
template <int kParts>
__device__ __forceinline__ void plane_mma_k8(float (&acc)[4],
                                             const uint32_t (&f)[kParts][4],
                                             const uint4 (&cf)[kParts], int h) {
  uint32_t b[kParts];
#pragma unroll
  for (int p = 0; p < kParts; ++p) b[p] = h == 0 ? cf[p].x : cf[p].y;
  const float zero[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  if constexpr (kParts == 2) {  // ch.fl, cl.fh, ch.fh
    mma_bf16_k8(acc, f[1][0], f[1][1], b[0], zero);
    mma_bf16_k8(acc, f[0][0], f[0][1], b[1], acc);
    mma_bf16_k8(acc, f[0][0], f[0][1], b[0], acc);
  } else {  // c1.f1, c0.f2, c2.f0, c0.f1, c1.f0, c0.f0
    mma_bf16_k8(acc, f[1][0], f[1][1], b[1], zero);
    mma_bf16_k8(acc, f[2][0], f[2][1], b[0], acc);
    mma_bf16_k8(acc, f[0][0], f[0][1], b[2], acc);
    mma_bf16_k8(acc, f[1][0], f[1][1], b[0], acc);
    mma_bf16_k8(acc, f[0][0], f[0][1], b[1], acc);
    mma_bf16_k8(acc, f[0][0], f[0][1], b[0], acc);
  }
}

// One plane of n-tile h (0: triangles 0-7 of the tile, registers x and z of
// each part's fragment; 1: triangles 8-15, y and w): the products of the
// coefficient parts cf and the feature parts f, smallest first.
template <int kParts>
__device__ __forceinline__ void plane_mma(float (&acc)[4],
                                          const uint32_t (&f)[kParts][4],
                                          const uint4 (&cf)[kParts], int h) {
  uint32_t b0[kParts], b1[kParts];
#pragma unroll
  for (int p = 0; p < kParts; ++p) {
    b0[p] = h == 0 ? cf[p].x : cf[p].y;
    b1[p] = h == 0 ? cf[p].z : cf[p].w;
  }
  const float zero[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  if constexpr (kParts == 2) {  // ch.fl, cl.fh, ch.fh
    mma_bf16(acc, f[1], b0[0], b1[0], zero);
    mma_bf16(acc, f[0], b0[1], b1[1], acc);
    mma_bf16(acc, f[0], b0[0], b1[0], acc);
  } else {  // c1.f1, c0.f2, c2.f0, c0.f1, c1.f0, c0.f0
    mma_bf16(acc, f[1], b0[1], b1[1], zero);
    mma_bf16(acc, f[2], b0[0], b1[0], acc);
    mma_bf16(acc, f[0], b0[2], b1[2], acc);
    mma_bf16(acc, f[1], b0[0], b1[0], acc);
    mma_bf16(acc, f[0], b0[1], b1[1], acc);
    mma_bf16(acc, f[0], b0[0], b1[0], acc);
  }
}

// The epilogue of one (ray, triangle) pair, folded into the ray's best.
__device__ __forceinline__ void mxu_test(float det, float dn, float up,
                                         float vp, const float4& tc,
                                         float ox, float oy, float oz,
                                         int32_t oi, float& best_d,
                                         int32_t& best_i) {
  const float tp = ((tc.x * 1.0f + tc.y * ox) + tc.z * oy) + tc.w * oz;
  const bool degenerate = fabsf(det) < rtc::kEpsilon;
  const float inv_det = __frcp_rn(degenerate ? 1.0f : det);  // IEEE 1 / x
  const float u = up * inv_det;
  const float v = vp * inv_det;
  const float dst = tp * inv_det;
  // mt.cuh's tests but u <= 1, which v >= 0 and u + v <= 1 imply (u and v
  // are finite, and rounding is monotone: fl(u + v) >= u when v >= 0).
  const bool valid = (dn < 0.0f) && !degenerate && (u >= 0.0f) &&
                     (v >= 0.0f) && (u + v <= 1.0f) && (dst >= rtc::kEpsilon);
  if (valid) rtc::lex_min(best_d, best_i, dst, oi);
}

// Word w of a program's union row, only the bits of blocks in the plane
// (bit j of word w is block 31 w + j; bit 31 is never a block).
__device__ __forceinline__ uint32_t union_word(const int32_t* __restrict__ row,
                                               int w, int n_blocks) {
  const int n = min(max(n_blocks - w * rtc::kBitsPerWord, 0), rtc::kBitsPerWord);
  return static_cast<uint32_t>(__ldg(row + w)) & ((1u << n) - 1u);
}

__device__ __forceinline__ int union_blocks(const int32_t* __restrict__ row,
                                            int n_words, int n_blocks) {
  int n = 0;
  for (int w = 0; w < n_words; ++w) n += __popc(union_word(row, w, n_blocks));
  return n;
}

// The A-fragment table: thread (block, plane, tile, lane) splits the 8
// coefficients that lane l = 4 g + t holds, rows 16 tile + g (+ 8) and
// columns 2t, 2t + 1 (+ 8), into frags[((block * 4 + plane) * kParts +
// part) * 8 + tile][lane] (uint4 registers x, y, z, w = (row g, cols 2t..),
// (row g + 8, cols 2t..), (row g, cols 2t + 8..), (row g + 8, cols 2t + 8..)).
template <int kParts>
__global__ void __launch_bounds__(kPackThreads)
mxu_pack_kernel(const float* __restrict__ coeffs,  // [6T, 16]
                int n_blocks, uint4* __restrict__ frags) {
  const int e = blockIdx.x * kPackThreads + threadIdx.x;
  if (e >= n_blocks * kPlanes * kTriTiles * 32) return;
  const int lane = e & 31;
  const int tile = (e >> 5) % kTriTiles;
  const int plane = (e / (32 * kTriTiles)) % kPlanes;
  const int blk = e / (32 * kTriTiles * kPlanes);
  const int g = lane >> 2, t = lane & 3;
  const float* rows = coeffs + (static_cast<int64_t>(blk) * kQuantRows +
                                plane * rtc::kBlock + tile * 16 + g) * kFeats;
  uint32_t r[4][kParts];
#pragma unroll
  for (int i = 0; i < 4; ++i) {  // register i: row g + 8 (i & 1), col + 8 (i >> 1)
    const float* x = rows + (i & 1) * 8 * kFeats + 2 * t + (i >> 1) * 8;
    split_pair<kParts>(__ldg(x), __ldg(x + 1), r[i]);
  }
#pragma unroll
  for (int p = 0; p < kParts; ++p) {
    frags[((static_cast<int64_t>(blk) * kPlanes + plane) * kParts + p) *
              kTriTiles * 32 + tile * 32 + lane] =
        make_uint4(r[0][p], r[1][p], r[2][p], r[3][p]);
  }
}

// The work items of program g: ceil(rays / kSlice) slices x ceil(union
// blocks / kSplit) runs, 0 if flags[g] is 0.
__device__ __forceinline__ long long program_items(
    const int32_t* __restrict__ words, const int32_t* __restrict__ flags,
    int g, int n_rays, int n_words, int n_blocks) {
  if (__ldg(flags + g) == 0) return 0;
  const int rays = min(n_rays - g * kRaysPerProgram, kRaysPerProgram);
  const int blocks = union_blocks(words + static_cast<int64_t>(g) * n_words,
                                  n_words, n_blocks);
  return static_cast<long long>((rays + kSlice - 1) / kSlice) *
         ((blocks + kSplit - 1) / kSplit);
}

// The count kernel: thread p resets packet p's keys (and, p = 0, the claim
// counter; packet_walk.cuh's reset_item_state), and CTA 0 writes ends, the
// inclusive scan of the programs' item counts, 256 programs at a time (a
// warp scan by shuffles, then one over the 8 warps' totals), so that no
// other launch scans them.
__global__ void __launch_bounds__(rtc::kCountThreads)
mxu_items_kernel(const int32_t* __restrict__ words,  // [G, n_words]
                 const int32_t* __restrict__ flags,  // [G]
                 int n_rays, int n_packets, int n_programs, int n_words,
                 int n_blocks, long long* __restrict__ ends,  // [G]
                 unsigned long long* __restrict__ counter,    // [1]
                 unsigned long long* __restrict__ keys) {     // [R]
  constexpr int kWarps = rtc::kCountThreads / 32;
  const int p = blockIdx.x * rtc::kCountThreads + threadIdx.x;
  if (p < n_packets) rtc::reset_item_state(p, n_rays, counter, keys);
  if (blockIdx.x != 0) return;
  __shared__ long long warp_total[kWarps];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  long long carry = 0;
  for (int base = 0; base < n_programs; base += rtc::kCountThreads) {
    const int g = base + threadIdx.x;
    long long v = g < n_programs
                      ? program_items(words, flags, g, n_rays, n_words, n_blocks)
                      : 0;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const long long u = __shfl_up_sync(0xffffffffu, v, off);
      if (lane >= off) v += u;
    }
    if (lane == 31) warp_total[warp] = v;
    __syncthreads();
    long long before = carry;
    for (int w = 0; w < warp; ++w) before += warp_total[w];
    if (g < n_programs) ends[g] = before + v;
    for (int w = 0; w < kWarps; ++w) carry += warp_total[w];
    __syncthreads();
  }
}

// Item k of program g: run k / slices (union blocks kSplit run .. kSplit
// run + kSplit - 1 in ascending order) for ray slice k % slices, so that
// the items claimed together read the same blocks.
template <int kParts>
__global__ void __launch_bounds__(rtc::kItemThreads, 3)
search_mxu_kernel(const float* __restrict__ o,          // [R, 3]
                  const float* __restrict__ d,          // [R, 3]
                  const int32_t* __restrict__ words,    // [G, n_words]
                  const int64_t* __restrict__ ends,     // [G] inclusive scan
                  const uint4* __restrict__ frags,      // mxu_pack_kernel's
                  const float* __restrict__ coeffs,     // [6T, 16]
                  const int32_t* __restrict__ orig_idx, // [T]
                  int n_rays, int n_words, int n_blocks,
                  unsigned long long* __restrict__ counter,  // [1], 0
                  unsigned long long* __restrict__ keys) {   // [R]
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int n_programs = (n_rays + kRaysPerProgram - 1) / kRaysPerProgram;
  rtc::claim_items(ends, n_programs, counter, [&](int prog, int k) {
    const int32_t* row = words + static_cast<int64_t>(prog) * n_words;
    const int rays = min(n_rays - prog * kRaysPerProgram, kRaysPerProgram);
    const int slices = (rays + kSlice - 1) / kSlice;
    const int r0 = prog * kRaysPerProgram + (k % slices) * kSlice;

    // The ray side: rays r0 + 16 m + g + 8 j (zeros past n_rays), their
    // features 2t, 2t + 1, 2t + 8, 2t + 9 split into A fragments (register
    // j: ray g + 8 j, columns 2t..; register 2 + j: columns 2t + 8..).
    uint32_t fa[kRayTiles][kParts][4];
    float ox[kRayTiles][2], oy[kRayTiles][2], oz[kRayTiles][2];
    float best_d[kRayTiles][2];
    int32_t best_i[kRayTiles][2];
#pragma unroll
    for (int m = 0; m < kRayTiles; ++m) {
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int r = r0 + 16 * m + 8 * j + g;
        const rtc::Ray ray = rtc::load_ray(o, d, r, r < n_rays);
        ox[m][j] = ray.ox;
        oy[m][j] = ray.oy;
        oz[m][j] = ray.oz;
        best_d[m][j] = rtc::kMissDst;
        best_i[m][j] = rtc::kBigIdx;
        const float f0 = t == 0 ? 1.0f : t == 1 ? ray.oy : t == 2 ? ray.dx : ray.dz;
        const float f1 = t == 0 ? ray.ox : t == 1 ? ray.oz : t == 2 ? ray.dy
                                                                    : ray.ox * ray.dy;
        const float f8 = t == 0 ? ray.ox * ray.dz : t == 1 ? ray.oy * ray.dz
                                                  : t == 2 ? ray.oz * ray.dy : 0.0f;
        const float f9 = t == 0 ? ray.oy * ray.dx : t == 1 ? ray.oz * ray.dx : 0.0f;
        uint32_t lo[kParts], hi[kParts];
        split_pair<kParts>(f0, f1, lo);
        split_pair<kParts>(f8, f9, hi);
#pragma unroll
        for (int p = 0; p < kParts; ++p) {
          fa[m][p][j] = lo[p];
          fa[m][p][2 + j] = hi[p];
        }
      }
    }

    // The run's first block: skip kSplit * run set bits, whole words by
    // popcount.
    int skip = (k / slices) * kSplit;
    int w = 0;
    uint32_t bits = union_word(row, 0, n_blocks);
    while (skip >= __popc(bits)) {
      skip -= __popc(bits);
      bits = union_word(row, ++w, n_blocks);
    }
    for (; skip > 0; --skip) bits &= bits - 1u;

#pragma unroll 1
    for (int left = kSplit; left > 0; --left) {
      while (bits == 0u) {
        if (++w >= n_words) break;
        bits = union_word(row, w, n_blocks);
      }
      if (bits == 0u) break;  // the program's last block was walked
      const int blk = w * rtc::kBitsPerWord + __ffs(bits) - 1;
      bits &= bits - 1u;
      const uint4* bf = frags + static_cast<int64_t>(blk) * kPlanes * kParts *
                                    kTriTiles * 32 + lane;
      const float4* tpl = reinterpret_cast<const float4*>(
          coeffs + (static_cast<int64_t>(blk) * kQuantRows +
                    kTPlane * rtc::kBlock) * kFeats);
      const int32_t* oib = orig_idx + static_cast<int64_t>(blk) * rtc::kBlock;

#pragma unroll 1
      for (int tile = 0; tile < kTriTiles; ++tile) {
        uint4 cf[kPlanes][kParts];
#pragma unroll
        for (int pl = 0; pl < kPlanes; ++pl) {
#pragma unroll
          for (int p = 0; p < kParts; ++p) {
            cf[pl][p] = __ldg(bf + ((pl * kParts + p) * kTriTiles + tile) * 32);
          }
        }
        // Triangle 8 h + 2t + c of the tile is slot (j, c) of n-tile h.
        float4 tc[2][2];
        int32_t oi[2][2];
#pragma unroll
        for (int h = 0; h < 2; ++h) {
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            const int q = tile * 16 + 8 * h + 2 * t + c;
            tc[h][c] = __ldg(tpl + q * (kFeats / 4));
            oi[h][c] = __ldg(oib + q);
          }
        }
#pragma unroll
        for (int m = 0; m < kRayTiles; ++m) {
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            // Accumulator slot s: ray g + 8 (s >> 1), triangle 8 h + 2t +
            // (s & 1).
            float det[4], dn[4], up[4], vp[4];
            plane_mma_k8<kParts>(det, fa[m], cf[0], h);
            plane_mma_k8<kParts>(dn, fa[m], cf[1], h);
            plane_mma<kParts>(up, fa[m], cf[2], h);
            plane_mma<kParts>(vp, fa[m], cf[3], h);
            if constexpr (kParts == 2) {  // split3 only (see the header)
              bool any = false;
#pragma unroll
              for (int s = 0; s < 4; ++s) {
                any |= (dn[s] < 0.0f) && !(fabsf(det[s]) < rtc::kEpsilon);
              }
              if (!__any_sync(0xffffffffu, any)) continue;  // the whole warp
            }
#pragma unroll
            for (int s = 0; s < 4; ++s) {
              const int j = s >> 1, c = s & 1;
              mxu_test(det[s], dn[s], up[s], vp[s], tc[h][c], ox[m][j],
                       oy[m][j], oz[m][j], oi[h][c], best_d[m][j],
                       best_i[m][j]);
            }
          }
        }
      }
    }

    // The 4 lanes of a row group (same g) hold the same rays' bests over
    // different triangles: reduce them, then merge into the keys.
#pragma unroll
    for (int m = 0; m < kRayTiles; ++m) {
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        float bd = best_d[m][j];
        int32_t bi = best_i[m][j];
#pragma unroll
        for (int off = 1; off < 4; off <<= 1) {
          const float od = __shfl_xor_sync(0xffffffffu, bd, off);
          const int32_t oj = __shfl_xor_sync(0xffffffffu, bi, off);
          rtc::lex_min(bd, bi, od, oj);
        }
        const int r = r0 + 16 * m + 8 * j + g;
        if (t == 0 && r < n_rays && bd < rtc::kMissDst) {
          atomicMin(keys + r, rtc::hit_key(bd, bi));
        }
      }
    }
  });
}

int pack_blocks(int n) { return (n + kPackThreads - 1) / kPackThreads; }

template <int kParts>
cudaError_t pack(const void* coeffs, int n_blocks, void* frags,
                 cudaStream_t stream) {
  mxu_pack_kernel<kParts><<<pack_blocks(n_blocks * kPlanes * kTriTiles * 32),
                            kPackThreads, 0, stream>>>(
      static_cast<const float*>(coeffs), n_blocks, static_cast<uint4*>(frags));
  return cudaGetLastError();
}

cudaError_t count(const void* words, const void* flags, int n_rays,
                  int n_words, int n_blocks, void* ends, void* counter,
                  void* keys, cudaStream_t stream) {
  const int n_packets = (n_rays + rtc::kPacket - 1) / rtc::kPacket;
  mxu_items_kernel<<<(n_packets + rtc::kCountThreads - 1) / rtc::kCountThreads,
                     rtc::kCountThreads, 0, stream>>>(
      static_cast<const int32_t*>(words), static_cast<const int32_t*>(flags),
      n_rays, n_packets, (n_rays + kRaysPerProgram - 1) / kRaysPerProgram,
      n_words, n_blocks, static_cast<long long*>(ends),
      static_cast<unsigned long long*>(counter),
      static_cast<unsigned long long*>(keys));
  return cudaGetLastError();
}

template <int kParts>
cudaError_t search(const void* o, const void* d, const void* words,
                   const void* ends, const void* frags, const void* coeffs,
                   const void* orig_idx, int n_rays, int n_words,
                   int n_blocks, void* counter, void* keys,
                   cudaStream_t stream) {
  int ctas_per_sm = 0, sms = 0;
  const cudaError_t err =
      rtc::item_grid(search_mxu_kernel<kParts>, &ctas_per_sm, &sms);
  if (err != cudaSuccess) return err;
  search_mxu_kernel<kParts><<<ctas_per_sm * sms, rtc::kItemThreads, 0, stream>>>(
      static_cast<const float*>(o), static_cast<const float*>(d),
      static_cast<const int32_t*>(words), static_cast<const int64_t*>(ends),
      static_cast<const uint4*>(frags), static_cast<const float*>(coeffs),
      static_cast<const int32_t*>(orig_idx), n_rays, n_words, n_blocks,
      static_cast<unsigned long long*>(counter),
      static_cast<unsigned long long*>(keys));
  return cudaGetLastError();
}

template <int kParts>
cudaError_t pack_count_search(const void* o, const void* d, const void* words,
                              const void* flags, const void* coeffs,
                              const void* orig_idx, int n_rays, int n_words,
                              int n_blocks, unsigned char* scratch,
                              cudaStream_t stream) {
  const int n_programs = (n_rays + kRaysPerProgram - 1) / kRaysPerProgram;
  unsigned char* frags = scratch;
  long long* ends = reinterpret_cast<long long*>(
      scratch + static_cast<int64_t>(n_blocks) * kParts * kPlanes * kTriTiles * 32 * 16);
  long long* counter = ends + n_programs;
  long long* keys = counter + 1;
  cudaError_t err = pack<kParts>(coeffs, n_blocks, frags, stream);
  if (err == cudaSuccess) {
    err = count(words, flags, n_rays, n_words, n_blocks, ends, counter, keys,
                stream);
  }
  if (err == cudaSuccess) {
    err = search<kParts>(o, d, words, ends, frags, coeffs, orig_idx, n_rays,
                         n_words, n_blocks, counter, keys, stream);
  }
  return err;
}

}  // namespace

extern "C" {

int rtc_unpack_keys(const void* keys, const void* alive, int n, void* dst,
                    void* idx, void* stream);  // search_range.cu

// Splits the four comparison planes of coeffs [n_blocks * 768, 16] (f32)
// into frags (n_blocks * (precision + 2) * 16 KiB, 16-byte aligned) in the
// A-fragment order, on `stream`. precision: 0 = split3 (2 parts), 1 =
// highest (3 parts). Returns cudaGetLastError() as an int (0 = launched).
int rtc_mxu_pack(const void* coeffs, int n_blocks, int precision, void* frags,
                 void* stream) {
  if (precision != 0 && precision != 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n_blocks <= 0) return static_cast<int>(cudaGetLastError());
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return static_cast<int>(precision == 0 ? pack<2>(coeffs, n_blocks, frags, s)
                                         : pack<3>(coeffs, n_blocks, frags, s));
}

// Writes ends [ceil(n_rays / 1024)] (int64), the inclusive scan of the
// programs' work items, fills keys [n_rays] (int64) with the packed miss and
// zeroes counter [1] (int64), on `stream`; returns cudaGetLastError() as an
// int (0 = launched).
int rtc_mxu_items(const void* words, const void* flags, int n_rays,
                  int n_words, int n_blocks, void* ends, void* counter,
                  void* keys, void* stream) {
  if (n_rays <= 0) return static_cast<int>(cudaGetLastError());
  return static_cast<int>(count(words, flags, n_rays, n_words, n_blocks, ends,
                                counter, keys,
                                static_cast<cudaStream_t>(stream)));
}

// The whole search on `stream`: the pack, the count, the search and the
// unpack (with the dead lanes, alive [n_rays] bool or null) into dst
// [n_rays] (f32) and idx [n_rays] (int32). scratch holds, 16-byte aligned,
// the fragment table (n_blocks * (precision + 2) * 16 KiB), then ends
// [ceil(n_rays / 1024)], the counter and the keys [n_rays], all int64.
// Returns cudaGetLastError() as an int (0 = launched).
int rtc_search_mxu(const void* o, const void* d, const void* alive,
                   const void* words, const void* flags, const void* coeffs,
                   const void* orig_idx, int n_rays, int n_words,
                   int n_blocks, int precision, void* scratch, void* dst,
                   void* idx, void* stream) {
  if (precision != 0 && precision != 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n_rays <= 0) return static_cast<int>(cudaGetLastError());
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  unsigned char* buf = static_cast<unsigned char*>(scratch);
  const cudaError_t err =
      precision == 0
          ? pack_count_search<2>(o, d, words, flags, coeffs, orig_idx, n_rays,
                                 n_words, n_blocks, buf, s)
          : pack_count_search<3>(o, d, words, flags, coeffs, orig_idx, n_rays,
                                 n_words, n_blocks, buf, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t frag_bytes =
      static_cast<int64_t>(n_blocks) * (precision + 2) * kPlanes * kTriTiles * 32 * 16;
  const int n_programs = (n_rays + kRaysPerProgram - 1) / kRaysPerProgram;
  return rtc_unpack_keys(buf + frag_bytes + 8 * (n_programs + 1), alive,
                         n_rays, dst, idx, stream);
}

// The search's persistent grid at `precision` on the current device:
// resident CTAs per SM (of rtc::kItemThreads threads) and SMs. Returns a
// cudaError_t as an int.
int rtc_search_mxu_grid(int precision, int* ctas_per_sm, int* sms) {
  return static_cast<int>(
      precision == 0
          ? rtc::item_grid(search_mxu_kernel<2>, ctas_per_sm, sms)
          : rtc::item_grid(search_mxu_kernel<3>, ctas_per_sm, sms));
}

}  // extern "C"
