// The culling prelude of the packet searches: per-packet hit-bit words over
// a list of boxes, hand-written for Hopper (sm_90a).
//
// Replaces no Pallas kernel. The JAX package computes these words on the XLA
// side (raytracingc_tpu/ops/intersect_pallas.py: _slab_any_hit and its
// callers packet_block_masks, packet_tile_words_multi and the MXU launcher's
// per-program union); the port's torch version (ops/culling.py _box_words
// over culling.packets) is ~37 eager launches a call of slab tests on
// [C, 8, G, 3] temporaries, most of a K2 search's host time. This file
// computes the same words in one launch:
//
//   words[p, w] bit j is set iff box w * 31 + j (< n_boxes) passes the slab
//   test for some live lane among rays 8p .. 8p + 7.
//
// Bit for bit the torch prelude. The reciprocal is 1 / (|d| < 1e-20 ?
// 1e-20 : d) in IEEE division (a tiny negative component or -0.0 becomes
// +1e-20); t0 = (lo - o) * inv and t1 = (hi - o) * inv, each rounded on its
// own (--fmad=false); tmin is the max over the axes of min(t0, t1), tmax the
// min of max(t0, t1), and the box is hit iff tmax >= max(tmin, 0). PyTorch's
// minimum, maximum, amax and amin propagate NaN where fminf and fmaxf drop
// it, so the min and max here are PTX's min.NaN and max.NaN: a NaN in any of
// a lane's six slab values makes that lane miss, as in torch. (A signed zero
// can leave a min or max with the other sign of zero than torch's; only the
// final comparison reads them, and it does not see the sign.) A box with
// !(lo <= hi) on some axis (inverted, or NaN) sets no bit. Dead lanes and
// the missing lanes of the tail packet set no bit, so neither the rays nor
// the boxes need padding; a packet with no live lane gets zero words. Bit 31
// is never set: the words stay non-negative int32.
//
// What bounds it on an H100: FP32 issue. A (ray, box) test is 24 operations
// (6 subtracts, 6 multiplies, 6 min/max of the slabs, 4 of the reductions,
// the max with 0 and the compare), so 65,536 rays by 128 boxes (the K2
// route at 16,384 triangles) are 2.0e8 operations, ~6 us at 33.4e12/s. Its
// bytes are few: 25 a ray in, 4 a word out, and the boxes once per CTA.
//
// What the design does about it: one warp per packet. Lanes 0-7 load ray
// 8p + lane once and compute its reciprocal; __shfl_sync hands all 8 rays to
// every lane, which holds them in registers. Lane j < 31 owns bit j of every
// word (lane 31 none) and tests its box against the packet's live rays (a
// warp-uniform branch skips dead ones); the word is __ballot_sync of the
// lanes' hits, so it costs no reduction and no atomics. Lane w % 32 keeps
// word w, and the warp writes up to 32 words at a time in one coalesced
// store. The CTA stages the box list in shared memory, kStageWords words
// (248 boxes, 6 KB) at a time: at most one round for the K2 and MXU routes
// (<= 8 words), more for the tile lists of the packed and words routes.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kPacket = 8;        // rays per culling packet
constexpr int kBitsPerWord = 31;  // culling bits per int32 word
constexpr int kWarps = 8;         // packets per CTA
constexpr int kThreads = kWarps * 32;
constexpr int kStageWords = 8;    // words of boxes in shared memory at a time
constexpr int kStageBoxes = kStageWords * kBitsPerWord;
constexpr unsigned kAll = 0xffffffffu;

// PyTorch's NaN-propagating minimum and maximum (PTX, sm_80 and later).
__device__ __forceinline__ float min_nan(float a, float b) {
  float r;
  asm("min.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}

__device__ __forceinline__ float max_nan(float a, float b) {
  float r;
  asm("max.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}

// ops/culling.py _inv_dir: |d| < 1e-20 becomes +1e-20, then IEEE 1 / d.
__device__ __forceinline__ float inv_dir(float d) {
  return 1.0f / (fabsf(d) < 1e-20f ? 1e-20f : d);
}

struct SlabRay {
  float ox, oy, oz, ix, iy, iz;  // origin and reciprocal direction
};

// ops/culling.py slab_any_hit for one live lane and one valid box.
__device__ __forceinline__ bool slab_hit(const SlabRay& r, float lx, float ly,
                                         float lz, float hx, float hy,
                                         float hz) {
  const float t0x = (lx - r.ox) * r.ix, t1x = (hx - r.ox) * r.ix;
  const float t0y = (ly - r.oy) * r.iy, t1y = (hy - r.oy) * r.iy;
  const float t0z = (lz - r.oz) * r.iz, t1z = (hz - r.oz) * r.iz;
  const float tmin = max_nan(max_nan(min_nan(t0x, t1x), min_nan(t0y, t1y)),
                             min_nan(t0z, t1z));
  const float tmax = min_nan(min_nan(max_nan(t0x, t1x), max_nan(t0y, t1y)),
                             max_nan(t0z, t1z));
  return tmax >= max_nan(tmin, 0.0f);
}

__global__ void __launch_bounds__(kThreads)
cull_words_kernel(const float* __restrict__ o,        // [R, 3]
                  const float* __restrict__ d,        // [R, 3]
                  const uint8_t* __restrict__ alive,  // [R] bool, or null
                  const float* __restrict__ lo,       // [N, 3]
                  const float* __restrict__ hi,       // [N, 3]
                  int n_rays, int n_boxes, int n_words,
                  int32_t* __restrict__ words) {      // [ceil(R / 8), W]
  __shared__ float s_lo[kStageBoxes * 3];
  __shared__ float s_hi[kStageBoxes * 3];
  const int lane = threadIdx.x & 31;
  const int64_t packet =
      static_cast<int64_t>(blockIdx.x) * kWarps + (threadIdx.x >> 5);
  const bool mine = packet * kPacket < n_rays;  // the same on the whole warp

  SlabRay own{0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  bool live = false;
  if (mine && lane < kPacket) {
    const int64_t r = packet * kPacket + lane;
    if (r < n_rays && (alive == nullptr || alive[r] != 0)) {
      live = true;
      own.ox = o[3 * r + 0]; own.oy = o[3 * r + 1]; own.oz = o[3 * r + 2];
      own.ix = inv_dir(d[3 * r + 0]);
      own.iy = inv_dir(d[3 * r + 1]);
      own.iz = inv_dir(d[3 * r + 2]);
    }
  }
  const unsigned live_lanes = __ballot_sync(kAll, live);
  SlabRay ray[kPacket];
#pragma unroll
  for (int i = 0; i < kPacket; ++i) {
    ray[i].ox = __shfl_sync(kAll, own.ox, i);
    ray[i].oy = __shfl_sync(kAll, own.oy, i);
    ray[i].oz = __shfl_sync(kAll, own.oz, i);
    ray[i].ix = __shfl_sync(kAll, own.ix, i);
    ray[i].iy = __shfl_sync(kAll, own.iy, i);
    ray[i].iz = __shfl_sync(kAll, own.iz, i);
  }

  int32_t kept = 0;  // word w, on lane w % 32, until the warp writes it
  int32_t* out = words + packet * n_words;
  for (int w0 = 0; w0 < n_words; w0 += kStageWords) {
    const int b0 = w0 * kBitsPerWord;
    const int nb = min(kStageBoxes, n_boxes - b0);
    __syncthreads();  // every warp is done with the previous round's boxes
    for (int k = threadIdx.x; k < nb * 3; k += kThreads) {
      s_lo[k] = lo[3 * b0 + k];
      s_hi[k] = hi[3 * b0 + k];
    }
    __syncthreads();
    if (!mine) continue;
    const int nw = min(kStageWords, n_words - w0);
    for (int w = 0; w < nw; ++w) {
      const int j = w * kBitsPerWord + lane;  // this lane's box of the round
      bool hit = false;
      if (lane < kBitsPerWord && j < nb) {
        const float lx = s_lo[3 * j + 0], ly = s_lo[3 * j + 1],
                    lz = s_lo[3 * j + 2];
        const float hx = s_hi[3 * j + 0], hy = s_hi[3 * j + 1],
                    hz = s_hi[3 * j + 2];
        if (lx <= hx && ly <= hy && lz <= hz) {
#pragma unroll
          for (int i = 0; i < kPacket; ++i) {
            if (live_lanes & (1u << i)) {
              hit |= slab_hit(ray[i], lx, ly, lz, hx, hy, hz);
            }
          }
        }
      }
      const int32_t word = static_cast<int32_t>(__ballot_sync(kAll, hit));
      const int wg = w0 + w;
      if (lane == (wg & 31)) kept = word;
      if ((wg & 31) == 31 || wg == n_words - 1) {
        if (lane <= (wg & 31)) out[(wg & ~31) + lane] = kept;
      }
    }
  }
}

}  // namespace

extern "C" {

// Launches the prelude on `stream` and returns cudaGetLastError() as an int
// (0 = launched). `alive` may be null (every lane live).
int rtc_cull_words(const void* o, const void* d, const void* alive,
                   const void* lo, const void* hi, int n_rays, int n_boxes,
                   void* words, void* stream) {
  if (n_rays <= 0 || n_boxes <= 0) return static_cast<int>(cudaGetLastError());
  const int n_words = (n_boxes + kBitsPerWord - 1) / kBitsPerWord;
  const int packets = (n_rays + kPacket - 1) / kPacket;
  const int blocks = (packets + kWarps - 1) / kWarps;
  cull_words_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(o), static_cast<const float*>(d),
      static_cast<const uint8_t*>(alive), static_cast<const float*>(lo),
      static_cast<const float*>(hi), n_rays, n_boxes, n_words,
      static_cast<int32_t*>(words));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
