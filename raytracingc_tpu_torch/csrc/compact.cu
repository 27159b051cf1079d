// The integrator's live-lane compaction in one launch (sm_90a).
//
// Replaces no TPU kernel. The JAX package runs its bounces at fixed widths
// (a while-loop tier cascade), because XLA needs static shapes; the port
// runs each bounce on exactly the live lanes (render/integrator.py), and
// eager PyTorch selects them with torch.nonzero (cub's select, a copy of
// the count to the host and a sync), writes the dead lanes' radiance back
// with an out-of-place index_copy (a clone of the whole image and the copy)
// and gathers every lane tensor on its own: ~13 launches a bounce. This
// file does the same in one launch, for the calls through which no
// derivative can flow (ops/compact.py chooses the route):
//
//   out_lanes[rank(i)] = lanes[i] (i when lanes is null) and
//   out_q[rank(i)] = in_q[i] for every payload q, for each lane i whose
//   mask byte is set, rank(i) being the number of set lanes before i: the
//   order of torch.nonzero, so every later search sees the same lanes in
//   the same order;
//   wb_out[lanes[i]] = wb_in[i] for each lane i whose mask byte is clear
//   (the dead lanes' radiance, written into the image in place);
//   the number of set lanes, written by the block of the last tile into a
//   word of pinned host memory mapped into the card's address space.
//
// The entry then synchronises the stream and returns that count: the one
// host read a bounce needs, with no copy launch.
//
// It only moves data, so its outputs are the gathers' bits. Rows are copied
// as 32-bit words, 1 to 4 a row (the integrator's are 4, 8 and 12 bytes).
//
// What bounds it on an H100: bytes. At 65,536 lanes a bounce call moves
// ~65 bytes a live lane (mask, lane id, five rows in, the id and five rows
// out), ~4 MB, ~1.3 us at 3.35 TB/s; its arithmetic is a few integer
// operations a lane. Its time is the launch's, the scan's chain of tiles
// and the sync's. So the design is one pass, one lane a thread: each CTA
// takes a tile of 256 lanes in the order of an atomic ticket, loads its
// set lanes' rows (or its clear lanes' write-back row) into registers at
// once, so that they are in flight during the scan; __ballot_sync and
// __popc rank the lanes within a warp, one warp scans the tile's 8 warp
// counts, and the tile's offset comes from a decoupled look-back over the
// tiles before it (each tile publishes its count, then its inclusive
// prefix; a warp reads 32 predecessors at once). Tiles taken in ticket
// order only ever wait on tiles already running, so the scan cannot
// deadlock on the order in which CTAs are scheduled. The status words
// carry the launch's epoch in their high half, so no launch is needed to
// reset them; the ticket counter is never reset either: the host passes
// the count of tickets taken before (ticket_base).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;               // lanes a CTA: one a thread
constexpr int kWarps = kThreads / 32;
constexpr int kMaxPayload = 8;
constexpr int kMaxWords = 4;                // 32-bit words a row, at most
constexpr unsigned kAll = 0xffffffffu;
// A status word: the epoch (high 32 bits), the flag (bit 31: the value is
// the inclusive prefix; else the tile's own count) and the value.
constexpr unsigned long long kPrefix = 1ull << 31;
constexpr unsigned long long kValue = kPrefix - 1;

struct Rows {
  const uint32_t* in;
  uint32_t* out;
  int words;  // 32-bit words a row, 1 to kMaxWords
};

struct Payload {
  Rows q[kMaxPayload];
  int n;
};

__device__ __forceinline__ unsigned long long status_word(unsigned epoch,
                                                          bool prefix,
                                                          unsigned value) {
  return (static_cast<unsigned long long>(epoch) << 32) |
         (prefix ? kPrefix : 0ull) | value;
}

// Row `from` of r.in into v (the words past r.words are left as they are).
__device__ __forceinline__ void load_row(const Rows& r, int64_t from,
                                         uint32_t (&v)[kMaxWords]) {
#pragma unroll
  for (int w = 0; w < kMaxWords; ++w) {
    if (w < r.words) v[w] = r.in[from * r.words + w];
  }
}

__device__ __forceinline__ void store_row(const Rows& r, int64_t to,
                                          const uint32_t (&v)[kMaxWords]) {
#pragma unroll
  for (int w = 0; w < kMaxWords; ++w) {
    if (w < r.words) r.out[to * r.words + w] = v[w];
  }
}

// The set lanes of the tiles before `tile` (tile > 0), by warp 0 of its
// CTA: a decoupled look-back over 32 predecessors at a time, spinning
// while any of them has not published this launch's count.
__device__ __forceinline__ unsigned look_back(
    volatile unsigned long long* st, int tile, unsigned epoch, int lane) {
  unsigned prefix = 0;
  for (int last = tile - 1;; last -= 32) {  // lane 0's predecessor
    const int t = last - lane;
    unsigned long long s;
    do {
      s = t >= 0 ? st[t] : status_word(epoch, true, 0);
    } while (__any_sync(kAll, static_cast<unsigned>(s >> 32) != epoch));
    const unsigned done = __ballot_sync(kAll, (s & kPrefix) != 0);
    const int stop = done ? __ffs(done) - 1 : 31;  // the nearest prefix
    unsigned v = lane <= stop ? static_cast<unsigned>(s & kValue) : 0u;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kAll, v, o);
    prefix += v;
    if (done) return prefix;
  }
}

__global__ void __launch_bounds__(kThreads)
compact_kernel(const uint8_t* __restrict__ mask,      // [n] bool
               const int64_t* __restrict__ lanes,     // [n], or null: i
               int n, Payload payload,
               int64_t* __restrict__ out_lanes,       // [>= count]
               Rows wb,                               // wb.out null: none
               unsigned long long* status,            // [tiles]
               unsigned* ticket, unsigned ticket_base, unsigned epoch,
               int tiles, int* total) {               // pinned, mapped
  __shared__ int s_tile;
  __shared__ unsigned s_offset[kWarps];
  __shared__ unsigned s_prefix;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  if (tid == 0) s_tile = static_cast<int>(atomicAdd(ticket, 1u) - ticket_base);
  __syncthreads();
  const int tile = s_tile;
  const int i = tile * kThreads + tid;  // n <= 2**31 - 1 - kThreads
  const bool in = i < n;
  const bool live = in && mask[i] != 0;
  const unsigned ballot = __ballot_sync(kAll, live);
  if (lane == 0) s_offset[warp] = __popc(ballot);

  // The lane's rows are loaded before the scan, which they do not need.
  uint32_t v[kMaxPayload][kMaxWords];
  int64_t id = 0;
  if (in) {
    id = lanes == nullptr ? i : lanes[i];
    if (live) {
#pragma unroll
      for (int q = 0; q < kMaxPayload; ++q) {
        if (q < payload.n) load_row(payload.q[q], i, v[q]);
      }
    } else if (wb.out != nullptr) {
      load_row(wb, i, v[0]);
    }
  }
  __syncthreads();

  if (warp == 0) {
    const unsigned c = lane < kWarps ? s_offset[lane] : 0u;
    unsigned incl = c;
#pragma unroll
    for (int s = 1; s < kWarps; s <<= 1) {
      const unsigned up = __shfl_up_sync(kAll, incl, s);
      if (lane >= s) incl += up;
    }
    const unsigned own = __shfl_sync(kAll, incl, kWarps - 1);
    __syncwarp();
    if (lane < kWarps) s_offset[lane] = incl - c;
    volatile unsigned long long* st = status;
    unsigned prefix = 0;
    if (tile == 0) {
      if (lane == 0) st[0] = status_word(epoch, true, own);
    } else {
      if (lane == 0) st[tile] = status_word(epoch, false, own);
      prefix = look_back(st, tile, epoch, lane);
      if (lane == 0) st[tile] = status_word(epoch, true, prefix + own);
    }
    if (lane == 0) {
      s_prefix = prefix;
      if (tile == tiles - 1) {
        *reinterpret_cast<volatile int*>(total) = static_cast<int>(prefix + own);
        __threadfence_system();
      }
    }
  }
  __syncthreads();

  if (live) {
    const int64_t r = static_cast<int64_t>(s_prefix) + s_offset[warp] +
                      __popc(ballot & ((1u << lane) - 1u));
    out_lanes[r] = id;
#pragma unroll
    for (int q = 0; q < kMaxPayload; ++q) {
      if (q < payload.n) store_row(payload.q[q], r, v[q]);
    }
  } else if (in && wb.out != nullptr) {
    store_row(wb, id, v[0]);
  }
}

}  // namespace

extern "C" {

// Allocates one word of pinned host memory mapped into every card's address
// space (portable; under unified addressing the card's pointer is the
// host's) and stores its address in *word. Returns a cudaError_t as an int.
int rtc_compact_word(void* word) {
  void* h = nullptr;
  cudaError_t e = cudaHostAlloc(&h, sizeof(int),
                                cudaHostAllocMapped | cudaHostAllocPortable);
  if (e != cudaSuccess) return static_cast<int>(e);
  void* d = nullptr;
  e = cudaHostGetDevicePointer(&d, h, 0);
  if (e == cudaSuccess && d != h) e = cudaErrorNotSupported;
  if (e != cudaSuccess) {
    cudaFreeHost(h);
    return static_cast<int>(e);
  }
  *static_cast<int*>(h) = 0;
  *static_cast<void**>(word) = h;
  return 0;
}

// Launches the compaction of n lanes on `stream`, synchronises the stream
// and writes the number of set lanes to *count (an int on the host).
// `desc`: a host array of (in, out, row bytes) for each of the n_payload
// (<= 8) payloads, then for the write-back (in null: none); rows of 4 to 16
// bytes, multiples of 4; n <= 2**31 - 257. `lanes` may be null (lane i's
// id is i). `status` holds at least ceil(n / 256) words, `ticket` one
// counter that has handed out `ticket_base` tickets (mod 2**32); `epoch`
// is new to `status`. Nothing is launched when n == 0. Returns a
// cudaError_t as an int (0 = done).
int rtc_compact(const void* mask, const void* lanes, int n,
                const unsigned long long* desc, int n_payload, void* out_lanes,
                void* status, void* ticket, unsigned ticket_base, unsigned epoch,
                void* word, void* count, void* stream) {
  if (n_payload < 0 || n_payload > kMaxPayload || n < 0 || n > 0x7fffffff - kThreads) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Rows rows[kMaxPayload + 1];
  for (int q = 0; q <= n_payload; ++q) {
    const unsigned long long* d = desc + 3 * q;
    const bool wb_none = q == n_payload && d[0] == 0;
    if (!wb_none && (d[2] == 0 || d[2] > 4 * kMaxWords || d[2] % 4 != 0)) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    rows[q] = Rows{reinterpret_cast<const uint32_t*>(d[0]),
                   wb_none ? nullptr : reinterpret_cast<uint32_t*>(d[1]),
                   static_cast<int>(d[2] / 4)};
  }
  if (n == 0) {
    *static_cast<int*>(count) = 0;
    return static_cast<int>(cudaGetLastError());
  }
  Payload p{};
  p.n = n_payload;
  for (int q = 0; q < n_payload; ++q) p.q[q] = rows[q];
  const int tiles = (n + kThreads - 1) / kThreads;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  compact_kernel<<<tiles, kThreads, 0, s>>>(
      static_cast<const uint8_t*>(mask), static_cast<const int64_t*>(lanes), n,
      p, static_cast<int64_t*>(out_lanes), rows[n_payload],
      static_cast<unsigned long long*>(status), static_cast<unsigned*>(ticket),
      ticket_base, epoch, tiles, static_cast<int*>(word));
  cudaError_t e = cudaGetLastError();
  if (e == cudaSuccess) e = cudaStreamSynchronize(s);
  if (e != cudaSuccess) return static_cast<int>(e);
  *static_cast<int*>(count) = *static_cast<volatile int*>(word);
  return 0;
}

}  // extern "C"
