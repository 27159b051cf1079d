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
// union AABB. Every ray of the packet, dead lanes included, tests the blocks
// of its set bits with the shared Moller-Trumbore test (mt.cuh), keeping the
// lexicographic minimum of (dst, original index). A packet with no set bit
// misses.
//
// The two TPU kernels differ only in their grid order and in where the
// tiles' results meet: a merge into a revisited output, or an XLA fold of
// one output per (tile, program). Both are the lex-min over the tiles' real
// hits, and a lex-min over a partition is the lex-min over the whole, so
// both give the bits of one walk over the packet's blocks. That is what this
// kernel computes for both (RTC_STREAM_ORDER only names K6 or K7); it equals
// the plain version (ops/search_words.py::search_words_reference) bit for
// bit.
//
// What bounds it on an H100. (1) The MT operations of the tested pairs: 61
// un-fused FP32 operations (--fmad=false) per (ray, triangle) pair, 8 x 128
// for every block of every set bit; the plane (8.5 MB at 163,840 triangles)
// stays in the 50 MB L2. (2) Long, uneven walks: the granule is coarse (5
// blocks a bit at 16,384-triangle tiles, 11 on the resident 40,960-triangle
// plane), so a coherent packet walks ~28 (K7) to ~66 (K6) blocks, and the
// packets after a diffuse bounce, whose rays point apart, walk several times
// more, some of them most of the plane.
//
// What the design does about each. (1) packet_walk.cuh's layout, as in K2 -
// K5: a warp holds one packet's 8 rays in registers and lane l tests
// triangles l, l + 32, l + 64, l + 96 of each block against all 8, so one
// coalesced load of a triangle serves 8 tests and the warp walks only its
// own packet's bits. (2) Work items, as in the range kernel: a packet's
// blocks, in walk order (tile, then bit, then block within the bit's clipped
// granule), are cut into items of at most kSplit blocks.
// words_items_kernel counts each packet's items (and resets the keys and the
// claim counter), the wrapper scans the counts on the device, and
// packet_walk.cuh's persistent loop (rtc::search_items) walks the items and
// merges them exactly through the 64-bit keys; the range kernel's unpack
// (search_range.cu) gives (dst, idx). An item starts at block k * kSplit of
// its packet's list: WordItems::begin skips whole tiles by popcount
// (tile_blocks, the count kernel's own arithmetic), then the set bits before
// the item's by division, so no block is walked twice and none is skipped
// (tests/test_torch_search_words.py holds this skip, on its plain model in
// ops/search_words.py, to the packet's block list).

#include <cuda_runtime.h>
#include <stdint.h>

#include "packet_walk.cuh"

namespace {

// Blocks per work item. A/B on the H100 at 8 / 16 / 32 (PERF.md, the K6/K7
// redesign).
constexpr int kSplit = 16;

// A tile's bits: ceil(blocks_per_tile / granule), at most 31.
__device__ __forceinline__ int tile_bits(int blocks_per_tile, int granule) {
  return (blocks_per_tile + granule - 1) / granule;
}

// The blocks that a tile's word covers: granule for each set bit among the
// tile's bits, less what the last bit lacks when granule does not divide
// blocks_per_tile (it is clipped to the tile). Bits past the tile's cover
// nothing.
__device__ __forceinline__ int tile_blocks(uint32_t word, int blocks_per_tile,
                                           int granule) {
  const int n = tile_bits(blocks_per_tile, granule);
  const uint32_t m = word & ((1u << n) - 1u);
  return __popc(m) * granule -
         static_cast<int>((m >> (n - 1)) & 1u) * (n * granule - blocks_per_tile);
}

// items[p]: ceil(blocks / kSplit) of packet p's blocks over all tiles; also
// resets the keys and the claim counter (rtc::reset_item_state).
__global__ void __launch_bounds__(rtc::kCountThreads)
words_items_kernel(const int32_t* __restrict__ words,  // [P, n_tiles]
                   int n_rays, int n_packets, int n_tiles,
                   int blocks_per_tile, int granule,
                   int32_t* __restrict__ items,                // [P]
                   unsigned long long* __restrict__ counter,   // [1]
                   unsigned long long* __restrict__ keys) {    // [R]
  const int p = blockIdx.x * rtc::kCountThreads + threadIdx.x;
  if (p >= n_packets) return;
  rtc::reset_item_state(p, n_rays, counter, keys);
  const int32_t* pw = words + static_cast<int64_t>(p) * n_tiles;
  int blocks = 0;
  for (int t = 0; t < n_tiles; ++t) {
    blocks += tile_blocks(static_cast<uint32_t>(pw[t]), blocks_per_tile,
                          granule);
  }
  items[p] = (blocks + kSplit - 1) / kSplit;
}

// Item k of packet p: blocks k * kSplit .. k * kSplit + kSplit - 1 of the
// packet's block list (the last item may hold fewer).
struct WordItems {
  const int32_t* words;
  int n_tiles, blocks_per_tile, granule;

  struct Cursor {
    rtc::BlockCursor cur;
    int left;  // blocks of the item not returned yet
    __device__ __forceinline__ int64_t next() {
      return left-- > 0 ? cur.next() : -1;
    }
  };

  __device__ __forceinline__ Cursor begin(int p, int k) const {
    const int32_t* pw = words + static_cast<int64_t>(p) * n_tiles;
    rtc::BlockCursor cur{pw, n_tiles, 1, blocks_per_tile, granule};
    // The item's first block, s of the packet's list. The count kernel's
    // items end before the list does, so some tile holds it.
    int s = k * kSplit;
    uint32_t m = 0u;
    for (cur.t = 0; cur.t < n_tiles; ++cur.t) {  // whole tiles, by popcount
      m = static_cast<uint32_t>(__ldg(pw + cur.t));
      const int n = tile_blocks(m, blocks_per_tile, granule);
      if (s < n) break;
      s -= n;
    }
    // Every bit before the tile's last covers granule blocks, so block s of
    // the tile lies in its (s / granule)-th set bit, s % granule blocks in,
    // whether or not that bit is the clipped last one.
    m &= (1u << tile_bits(blocks_per_tile, granule)) - 1u;
    for (int q = s / granule; q > 0; --q) m &= m - 1u;
    const int start = (__ffs(m) - 1) * granule;
    cur.w = 0;
    cur.m = m & (m - 1u);
    cur.b = start + s % granule;
    cur.end = min(start + granule, blocks_per_tile);
    return {cur, kSplit};
  }
};

__global__ void __launch_bounds__(rtc::kItemThreads, rtc::kItemMinCtas)
search_words_kernel(const float* __restrict__ o,              // [R, 3]
                    const float* __restrict__ d,              // [R, 3]
                    const int32_t* __restrict__ words,        // [P, n_tiles]
                    const int64_t* __restrict__ ends,         // [P] inclusive scan
                    const float* __restrict__ plane,          // [12, n_tiles * tile]
                    const int32_t* __restrict__ orig_idx,     // [n_tiles * tile]
                    int n_rays, int n_packets, int n_tiles,
                    int blocks_per_tile, int granule,
                    unsigned long long* __restrict__ counter, // [1], 0
                    unsigned long long* __restrict__ keys) {  // [R]
  rtc::search_items(
      o, d, ends, plane, orig_idx,
      static_cast<int64_t>(n_tiles) * blocks_per_tile * rtc::kBlock, n_rays,
      n_packets, WordItems{words, n_tiles, blocks_per_tile, granule}, counter,
      keys);
}

}  // namespace

extern "C" {

// Counts each packet's work items into items [ceil(n_rays / 8)] (int32),
// fills keys [n_rays] (int64) with the packed miss and zeroes counter [1]
// (int64), on `stream`; returns cudaGetLastError() as an int (0 =
// launched).
int rtc_words_items(const void* words, int n_rays, int n_tiles,
                    int blocks_per_tile, int granule, void* items,
                    void* counter, void* keys, void* stream) {
  if (n_rays <= 0) return static_cast<int>(cudaGetLastError());
  const int n_packets = (n_rays + rtc::kPacket - 1) / rtc::kPacket;
  words_items_kernel<<<(n_packets + rtc::kCountThreads - 1) /
                           rtc::kCountThreads,
                       rtc::kCountThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(words), n_rays, n_packets, n_tiles,
      blocks_per_tile, granule, static_cast<int32_t*>(items),
      static_cast<unsigned long long*>(counter),
      static_cast<unsigned long long*>(keys));
  return static_cast<int>(cudaGetLastError());
}

// Launches the search on `stream`: ends [ceil(n_rays / 8)] int64 is the
// inclusive scan of rtc_words_items' counts, and counter and keys are as
// rtc_words_items left them; keys receive each ray's packed lex-min.
// Returns cudaGetLastError() as an int (0 = launched).
int rtc_search_words(const void* o, const void* d, const void* words,
                     const void* ends, const void* plane,
                     const void* orig_idx, int n_rays, int n_tiles,
                     int blocks_per_tile, int granule, void* counter,
                     void* keys, void* stream) {
  if (n_rays <= 0) return static_cast<int>(cudaGetLastError());
  int ctas_per_sm = 0, sms = 0;
  const cudaError_t err =
      rtc::item_grid(search_words_kernel, &ctas_per_sm, &sms);
  if (err != cudaSuccess) return static_cast<int>(err);
  search_words_kernel<<<ctas_per_sm * sms, rtc::kItemThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(o), static_cast<const float*>(d),
      static_cast<const int32_t*>(words), static_cast<const int64_t*>(ends),
      static_cast<const float*>(plane),
      static_cast<const int32_t*>(orig_idx), n_rays,
      (n_rays + rtc::kPacket - 1) / rtc::kPacket, n_tiles, blocks_per_tile,
      granule, static_cast<unsigned long long*>(counter),
      static_cast<unsigned long long*>(keys));
  return static_cast<int>(cudaGetLastError());
}

// The search's persistent grid on the current device: resident CTAs per SM
// (of rtc::kItemThreads threads) and SMs. Returns a cudaError_t as an int.
int rtc_search_words_grid(int* ctas_per_sm, int* sms) {
  return static_cast<int>(
      rtc::item_grid(search_words_kernel, ctas_per_sm, sms));
}

}  // extern "C"
