// Moller-Trumbore as bilinear forms on Hopper's tensor cores (K8).
//
// Replaces raytracingc_tpu/ops/intersect_mxu.py::_search_kernel_mxu (with
// _mxu_block_test, its per-block body, and the launcher _search_padded_mxu).
// Every MT quantity of a ray and a triangle is a dot product of 16 ray
// features f = [1, o, d, ox*dy, ox*dz, oy*dx, oy*dz, oz*dx, oz*dy, 0, 0, 0]
// with 16 coefficients of the triangle (ops/intersect_mxu.py::
// pack_coeffs_mxu, the [6T, 16] f32 table, block-major: 128 rows each of
// det, dn, u', v', t', index per 128-triangle block). Per 1,024-ray program
// the kernel walks the set bits of the program's union word (the OR of its
// 128 packets' block words, ops/culling.py::program_union_words) and, for
// each block, computes
//   det, dn, u', v'   on the tensor cores: mma.sync m16n8k16 bf16 -> f32,
//                     A = 16 triangle rows of one plane, B = the features
//                     of 8 rays; the four planes of the same 16 triangles
//                     and 8 rays land in the same (thread, register) slots,
//                     so the epilogue runs in registers;
//   t'                on the CUDA cores in f32, ((c0 + c1 ox) + c2 oy) +
//                     c3 oz, the plain version's op order (t' cancels
//                     catastrophically, so it stays off the bf16 path and is
//                     bitwise equal to the plain version);
//   the epilogue      inv_det = 1 / (|det| < EPS ? 1 : det), u, v, dst =
//                     t' inv_det and the MT validity tests (mt.cuh's), then
//                     the lexicographic minimum of (dst, ORIGINAL index),
//                     the index read from orig_idx (the TPU carried it as a
//                     matmul plane because Mosaic cannot gather).
// Dead lanes report (MISS_DST, -1); a program whose flag is 0 misses.
//
// Precision. Hopper has no f32 tensor-core product, so both modes split
// each f32 operand x into bf16 parts (round to nearest even) whose products
// are exact in f32:
//   split3  (precision 0): x = hi + lo, three products ch.fh + ch.fl +
//           cl.fh into one accumulator (the JAX kernel's scheme, dropping
//           cl.fl, ~2^-16 of the term);
//   highest (precision 1): x = hi + mid + lo, the six products of parts
//           whose ranks sum to <= 2 ("bf16x6"; the dropped ones are below
//           2^-24 of the term). It shares the split3 code path with the
//           number of parts as a template parameter; 3xTF32 on m16n8k8 would
//           need a second MMA shape and keeps fewer bits (2 x 11).
// The products are summed smallest first. The tensor cores' accumulation
// order and rounding are not specified, so the kernel equals its plain
// version (ops/intersect_mxu.py::search_mxu_reference) within a contract,
// not bit for bit: winners equal except at validity boundaries, distances
// within 1e-5 relative, or 2^-20 times det's condition number (capped at
// 128) on grazing hits (chip_smoke.py phase 3c).
//
// What bounds it on an H100: per tested (ray, triangle) pair the four
// planes need 24 multiply-adds (the non-zero coefficients: det 3, dn 3,
// u' 9, v' 9), so 2 x 24 x (3 or 6) = 144 or 288 bf16 tensor-core FLOPs,
// and the epilogue 21 FP32 operations. At the published peaks (989 TFLOP/s
// bf16 dense, 67 TFLOP/s FP32) that is 0.15 or 0.29 ps of tensor work
// against 0.31 ps of FP32 work per pair: the epilogue on the CUDA cores
// sets the bound in both modes. The kernel issues 4 x 16 multiply-adds per
// plane product (the structural zeros included), and mma.sync reaches only
// part of the wgmma rate. Program-level culling tests every block of the
// union for all 1,024 rays of a program (pair inflation over the
// per-packet kernels, counted in chip_smoke.py).
//
// What the design does about it: a simple first version. One CTA of 4
// warps covers 512 rays, half a program (two CTAs per program fill the 132
// SMs at 65,536 rays, where one per program would leave half idle); both
// read the program's union word, so both test the same blocks. Each warp
// owns 128 rays (16 n-tiles of 8) and keeps their running best in registers
// (2 rays x 16 n-tiles per thread), reduced over the 8 lanes of a column
// group with shuffles at the end. Per block the CTA stages the block's four
// planes into shared memory, already split into bf16 parts and laid out in
// the MMA's A-fragment order (one 16-byte load per fragment, no ldmatrix,
// no bank conflicts), with the t' row and orig_idx beside them; the ray
// features are built once, split and stored in B-fragment order. Not yet
// used: wgmma, TMA, a pipeline that overlaps a block's staging with the
// previous block's MMAs.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mt.cuh"

namespace {

constexpr int kFeats = 16;
constexpr int kQuantRows = 6 * rtc::kBlock;  // table rows per block
constexpr int kPlanes = 4;                   // det, dn, u', v'
constexpr int kTPlane = 4;                   // the t' plane of the table
constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kNTiles = 16;                  // n-tiles of 8 rays per warp
constexpr int kRaysPerCta = kWarps * kNTiles * 8;  // 512
constexpr int kRaysPerProgram = 1024;
constexpr int kCtasPerProgram = kRaysPerProgram / kRaysPerCta;
constexpr int kCtaNTiles = kWarps * kNTiles;  // 64
constexpr int kMTiles = rtc::kBlock / 16;     // 8 m-tiles of 16 triangles
constexpr int kRaysPerThread = kRaysPerCta / kThreads;

// Shared memory of one CTA, in bytes, for kParts bf16 parts per operand.
template <int kParts>
struct Smem {
  static constexpr int kFeatBytes = kParts * kCtaNTiles * 32 * 8;        // B
  static constexpr int kCoefBytes = kPlanes * kParts * kMTiles * 32 * 16;  // A
  static constexpr int kOBytes = 3 * kRaysPerCta * 4;
  static constexpr int kTpBytes = 4 * rtc::kBlock * 4;
  static constexpr int kOiBytes = rtc::kBlock * 4;
  static constexpr int kCoef = kFeatBytes;
  static constexpr int kO = kCoef + kCoefBytes;
  static constexpr int kTp = kO + kOBytes;
  static constexpr int kOi = kTp + kTpBytes;
  static constexpr int kTotal = kOi + kOiBytes;
};

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

// D = A B + D, A 16x16 row-major, B 16x8 column-major, bf16 in, f32 out.
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint4& a,
                                         const uint2& b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a.x), "r"(a.y), "r"(a.z), "r"(a.w), "r"(b.x), "r"(b.y));
}

// One plane: the products of the parts, smallest first.
template <int kParts>
__device__ __forceinline__ void plane_mma(float (&c)[4],
                                          const uint4 (&a)[kParts],
                                          const uint2 (&b)[kParts]) {
  if constexpr (kParts == 2) {
    mma_bf16(c, a[0], b[1]);
    mma_bf16(c, a[1], b[0]);
    mma_bf16(c, a[0], b[0]);
  } else {
    mma_bf16(c, a[1], b[1]);
    mma_bf16(c, a[0], b[2]);
    mma_bf16(c, a[2], b[0]);
    mma_bf16(c, a[0], b[1]);
    mma_bf16(c, a[1], b[0]);
    mma_bf16(c, a[0], b[0]);
  }
}

// The epilogue of one (triangle, ray) pair, folded into the running best.
__device__ __forceinline__ void mxu_test(float det, float dn, float up,
                                         float vp, const float* tc,
                                         float ox, float oy, float oz,
                                         int32_t oi, float& best_d,
                                         int32_t& best_i) {
  const float tp = ((tc[0] * 1.0f + tc[1] * ox) + tc[2] * oy) + tc[3] * oz;
  const bool degenerate = fabsf(det) < rtc::kEpsilon;
  const float inv_det = 1.0f / (degenerate ? 1.0f : det);
  const float u = up * inv_det;
  const float v = vp * inv_det;
  const float dst = tp * inv_det;
  const bool valid = (dn < 0.0f) && !degenerate && (u >= 0.0f) &&
                     (u <= 1.0f) && (v >= 0.0f) && (u + v <= 1.0f) &&
                     (dst >= rtc::kEpsilon);
  if (valid && (dst < best_d || (dst == best_d && oi < best_i))) {
    best_d = dst;
    best_i = oi;
  }
}

template <int kParts>
__global__ void __launch_bounds__(kThreads)
search_mxu_kernel(const float* __restrict__ o,          // [R, 3]
                  const float* __restrict__ d,          // [R, 3]
                  const uint8_t* __restrict__ alive,    // [R] bool or null
                  const int32_t* __restrict__ words,    // [G, n_words]
                  const int32_t* __restrict__ flags,    // [G]
                  const float* __restrict__ coeffs,     // [6T, 16]
                  const int32_t* __restrict__ orig_idx, // [T]
                  int n_rays, int n_words, int n_blocks,
                  float* __restrict__ dst_out,          // [R]
                  int32_t* __restrict__ idx_out) {      // [R]
  using S = Smem<kParts>;
  extern __shared__ __align__(16) unsigned char smem[];
  uint16_t* feat_h = reinterpret_cast<uint16_t*>(smem);
  const uint2* feat_frag = reinterpret_cast<const uint2*>(smem);
  uint16_t* coef_h = reinterpret_cast<uint16_t*>(smem + S::kCoef);
  const uint4* coef_frag = reinterpret_cast<const uint4*>(smem + S::kCoef);
  float* o_s = reinterpret_cast<float*>(smem + S::kO);    // [3][512]
  float* tp_s = reinterpret_cast<float*>(smem + S::kTp);  // [4][128]
  int32_t* oi_s = reinterpret_cast<int32_t*>(smem + S::kOi);

  const int tid = threadIdx.x;
  const int ray0 = blockIdx.x * kRaysPerCta;
  const int prog = blockIdx.x / kCtasPerProgram;

  if (__ldg(flags + prog) == 0) {  // uniform over the CTA
    for (int k = 0; k < kRaysPerThread; ++k) {
      const int r = ray0 + k * kThreads + tid;
      if (r < n_rays) {
        dst_out[r] = rtc::kMissDst;
        idx_out[r] = -1;
      }
    }
    return;
  }

  // The features of the CTA's rays, split, in B-fragment order: ray n of
  // n-tile nt, feature k sits in lane 4n + (k & 7) / 2, register k / 8,
  // half k & 1 of the (part, nt) fragment.
  for (int k = 0; k < kRaysPerThread; ++k) {
    const int rl = k * kThreads + tid;
    const int r = ray0 + rl;
    const rtc::Ray ray = rtc::load_ray(o, d, r, r < n_rays);
    o_s[rl] = ray.ox;
    o_s[kRaysPerCta + rl] = ray.oy;
    o_s[2 * kRaysPerCta + rl] = ray.oz;
    const float f[kFeats] = {
        1.0f, ray.ox, ray.oy, ray.oz, ray.dx, ray.dy, ray.dz,
        ray.ox * ray.dy, ray.ox * ray.dz, ray.oy * ray.dx, ray.oy * ray.dz,
        ray.oz * ray.dx, ray.oz * ray.dy, 0.0f, 0.0f, 0.0f};
    const int nt = rl >> 3, n = rl & 7;
#pragma unroll
    for (int j = 0; j < kFeats; ++j) {
      uint16_t parts[kParts];
      split<kParts>(f[j], parts);
      const int lane = n * 4 + ((j & 7) >> 1);
      const int slot = (j >> 3) * 2 + (j & 1);
#pragma unroll
      for (int p = 0; p < kParts; ++p) {
        feat_h[((p * kCtaNTiles + nt) * 32 + lane) * 4 + slot] = parts[p];
      }
    }
  }

  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  float best_d[kNTiles][2];
  int32_t best_i[kNTiles][2];
#pragma unroll
  for (int nt = 0; nt < kNTiles; ++nt) {
    best_d[nt][0] = best_d[nt][1] = rtc::kMissDst;
    best_i[nt][0] = best_i[nt][1] = rtc::kBigIdx;
  }

  for (int w = 0; w < n_words; ++w) {  // uniform over the CTA
    uint32_t m = static_cast<uint32_t>(__ldg(words + prog * n_words + w));
    while (m != 0u) {
      const int blk = w * rtc::kBitsPerWord + __ffs(m) - 1;
      m &= m - 1u;
      if (blk >= n_blocks) continue;
      const float* table = coeffs + static_cast<int64_t>(blk) * kQuantRows * kFeats;
      __syncthreads();  // the previous block's shared rows are read
      // The four planes, split, in A-fragment order: row rr of m-tile mt,
      // column k sits in lane 4 (rr & 7) + (k & 7) / 2, register
      // (rr >> 3) + 2 (k >> 3), half k & 1.
      for (int e = tid; e < kPlanes * rtc::kBlock * kFeats / 4; e += kThreads) {
        const float4 q = __ldg(reinterpret_cast<const float4*>(table) + e);
        const int plane = e / (rtc::kBlock * kFeats / 4);
        const int row = (e / (kFeats / 4)) % rtc::kBlock;
        const int k0 = (e % (kFeats / 4)) * 4;
        const int mt = row >> 4, rr = row & 15;
        const float v[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int k = k0 + c;
          uint16_t parts[kParts];
          split<kParts>(v[c], parts);
          const int ln = (rr & 7) * 4 + ((k & 7) >> 1);
          const int slot = ((rr >> 3) + 2 * (k >> 3)) * 2 + (k & 1);
#pragma unroll
          for (int p = 0; p < kParts; ++p) {
            coef_h[(((plane * kParts + p) * kMTiles + mt) * 32 + ln) * 8 + slot] =
                parts[p];
          }
        }
      }
      for (int row = tid; row < rtc::kBlock; row += kThreads) {
        const float4 q = __ldg(reinterpret_cast<const float4*>(
            table + (kTPlane * rtc::kBlock + row) * kFeats));
        tp_s[row] = q.x;
        tp_s[rtc::kBlock + row] = q.y;
        tp_s[2 * rtc::kBlock + row] = q.z;
        tp_s[3 * rtc::kBlock + row] = q.w;
        oi_s[row] = __ldg(orig_idx + blk * rtc::kBlock + row);
      }
      __syncthreads();

#pragma unroll 1
      for (int mt = 0; mt < kMTiles; ++mt) {
        uint4 a[kPlanes][kParts];
#pragma unroll
        for (int pl = 0; pl < kPlanes; ++pl) {
#pragma unroll
          for (int p = 0; p < kParts; ++p) {
            a[pl][p] = coef_frag[((pl * kParts + p) * kMTiles + mt) * 32 + lane];
          }
        }
        const int r0 = mt * 16 + g, r1 = r0 + 8;
        float tc0[4], tc1[4];
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          tc0[c] = tp_s[c * rtc::kBlock + r0];
          tc1[c] = tp_s[c * rtc::kBlock + r1];
        }
        const int32_t oi0 = oi_s[r0], oi1 = oi_s[r1];
#pragma unroll
        for (int nt = 0; nt < kNTiles; ++nt) {
          const int ntc = warp * kNTiles + nt;
          uint2 b[kParts];
#pragma unroll
          for (int p = 0; p < kParts; ++p) {
            b[p] = feat_frag[(p * kCtaNTiles + ntc) * 32 + lane];
          }
          float acc[kPlanes][4];
#pragma unroll
          for (int pl = 0; pl < kPlanes; ++pl) {
            acc[pl][0] = acc[pl][1] = acc[pl][2] = acc[pl][3] = 0.0f;
            plane_mma<kParts>(acc[pl], a[pl], b);
          }
          // Accumulator slot s holds triangle row (s < 2 ? r0 : r1) and ray
          // column 2t + (s & 1) of the n-tile.
          const int rl = ntc * 8 + 2 * t;
#pragma unroll
          for (int s = 0; s < 4; ++s) {
            const int c = s & 1;
            const float* tc = s < 2 ? tc0 : tc1;
            mxu_test(acc[0][s], acc[1][s], acc[2][s], acc[3][s], tc, o_s[rl + c], o_s[kRaysPerCta + rl + c],
                     o_s[2 * kRaysPerCta + rl + c], s < 2 ? oi0 : oi1,
                     best_d[nt][c], best_i[nt][c]);
          }
        }
      }
    }
  }

  // The 8 lanes of a column group (same t) hold the same rays' bests over
  // different triangle rows: reduce them, lexicographically.
#pragma unroll
  for (int nt = 0; nt < kNTiles; ++nt) {
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      float bd = best_d[nt][c];
      int32_t bi = best_i[nt][c];
#pragma unroll
      for (int off = 4; off < 32; off <<= 1) {
        const float od = __shfl_xor_sync(0xffffffffu, bd, off);
        const int32_t oi = __shfl_xor_sync(0xffffffffu, bi, off);
        if (od < bd || (od == bd && oi < bi)) {
          bd = od;
          bi = oi;
        }
      }
      const int r = ray0 + (warp * kNTiles + nt) * 8 + 2 * t + c;
      if (g == 0 && r < n_rays) {
        const bool dead = alive != nullptr && alive[r] == 0;
        dst_out[r] = dead ? rtc::kMissDst : bd;
        idx_out[r] = (dead || !(bd < rtc::kMissDst)) ? -1 : bi;
      }
    }
  }
}

template <int kParts>
int launch(const void* o, const void* d, const void* alive, const void* words,
           const void* flags, const void* coeffs, const void* orig_idx,
           int n_rays, int n_words, int n_blocks, void* dst, void* idx,
           cudaStream_t stream) {
  const int bytes = Smem<kParts>::kTotal;
  cudaError_t err = cudaFuncSetAttribute(
      search_mxu_kernel<kParts>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int blocks = (n_rays + kRaysPerCta - 1) / kRaysPerCta;
  search_mxu_kernel<kParts><<<blocks, kThreads, bytes, stream>>>(
      static_cast<const float*>(o), static_cast<const float*>(d),
      static_cast<const uint8_t*>(alive), static_cast<const int32_t*>(words),
      static_cast<const int32_t*>(flags), static_cast<const float*>(coeffs),
      static_cast<const int32_t*>(orig_idx), n_rays, n_words, n_blocks,
      static_cast<float*>(dst), static_cast<int32_t*>(idx));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Launches the search on `stream` and returns cudaGetLastError() as an int
// (0 = launched). precision: 0 = split3, 1 = highest.
int rtc_search_mxu(const void* o, const void* d, const void* alive,
                   const void* words, const void* flags, const void* coeffs,
                   const void* orig_idx, int n_rays, int n_words, int n_blocks,
                   int precision, void* dst, void* idx, void* stream) {
  if (n_rays <= 0) return static_cast<int>(cudaGetLastError());
  if (precision != 0 && precision != 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return precision == 0
             ? launch<2>(o, d, alive, words, flags, coeffs, orig_idx, n_rays,
                         n_words, n_blocks, dst, idx, s)
             : launch<3>(o, d, alive, words, flags, coeffs, orig_idx, n_rays,
                         n_words, n_blocks, dst, idx, s);
}

}  // extern "C"
