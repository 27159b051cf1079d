// Shared-memory probe, hand-written for Hopper (K10).
//
// Replaces tools/smem_probe.py::_kernel (launcher probe), the JAX package's
// probe of the largest table a kernel can hold in the TPU's scalar memory.
// Here the n-word table is staged whole in DYNAMIC shared memory and each
// CTA, one per 8 x 128 tile of x, computes the TPU kernel's function
//   o = x + f32(sm[pid] + sm[n - 1 - pid] + sm[n / 2])
// reading scattered entries so that the table cannot be elided. The launch
// asks for n * 4 bytes of dynamic shared memory; the kernel's limit is
// raised once per device (rtc_smem_set_limit) to the device's opt-in maximum
// per block (cudaDevAttrMaxSharedMemoryPerBlockOptin, 232,448 bytes on an
// H100), so a table up to that size runs and the first larger one is refused
// by the launch (cudaErrorInvalidValue): the refusal is the measurement.
// The kernel has no static shared memory, so the whole opt-in maximum is
// the table's.
//
// What bounds it: staging the table, n * 4 bytes per CTA from L2 (8 CTAs
// for the probe's 64 x 128 x), and the launch; the function itself reads
// three table words per tile. The design:
// - The table's body, a multiple of 16 bytes, comes in by bulk asynchronous
//   copies (cp.async.bulk, the TMA's non-tensor form) issued by one thread
//   and counted on an mbarrier; no thread spends a load on it. The body
//   stops at least kTailMin words short of n, and the mbarrier lives in the
//   first 8 bytes of that tail (the table owns all of the shared memory);
//   thread 0 loads the tail words into registers while the copy is in
//   flight and writes them over the invalidated mbarrier afterwards.
// - While the copy is in flight every thread loads its 4 elements of x as
//   one float4; it stores its 4 outputs as one float4.
// An A/B variant that made 8 CTAs one cluster and multicast each eighth of
// the body into all 8 (L2 read once per cluster) was slower, 3.6 against
// 2.3 us a launch (PERF.md), and is gone. staging_body() is the split,
// modelled by tools/smem_probe.py::staging_split.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTile = 8 * 128;
constexpr int kTailMin = 2;          // words left to plain loads: the mbarrier's 8 bytes
constexpr uint32_t kChunkBytes = 32768;  // bytes per bulk copy

// Words of the table staged by the bulk copies: a multiple of 4 (16 bytes),
// at most n - kTailMin; 0 for n < 6 (no bulk copy, no mbarrier).
__host__ __device__ inline int staging_body(int n) {
  return n >= 4 + kTailMin ? (n - kTailMin) / 4 * 4 : 0;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(bar) : "memory");
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
               ::"r"(bar), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
  }
}

__device__ __forceinline__ void mbar_inval(uint32_t bar) {
  asm volatile("mbarrier.inval.shared::cta.b64 [%0];" ::"r"(bar) : "memory");
}

__device__ __forceinline__ void bulk_copy(uint32_t dst, const void* src,
                                          uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];"
      ::"r"(dst), "l"(src), "r"(bytes), "r"(bar) : "memory");
}

__global__ void __launch_bounds__(kThreads)
smem_probe_kernel(const int32_t* __restrict__ sm,  // [n], 16-byte aligned
                  const float* __restrict__ x,     // [n_tiles * 8, 128]
                  int n, float* __restrict__ out) {
  extern __shared__ __align__(16) int32_t table[];
  const int t = threadIdx.x;
  const int body = staging_body(n);
  const int tail = n - body;  // kTailMin..kTailMin + 3 words, or n < 6
  const uint32_t bar = smem_addr(table + body);
  if (t == 0 && body > 0) {
    mbar_init(bar);
    const uint32_t bytes = static_cast<uint32_t>(body) * 4u;
    mbar_expect_tx(bar, bytes);
    const char* src = reinterpret_cast<const char*>(sm);
    for (uint32_t off = 0; off < bytes; off += kChunkBytes) {
      const uint32_t len = bytes - off < kChunkBytes ? bytes - off : kChunkBytes;
      bulk_copy(smem_addr(table) + off, src + off, len, bar);
    }
  }
  int32_t tail_v[kTailMin + 4];
  if (t == 0) {
#pragma unroll
    for (int i = 0; i < kTailMin + 4; ++i) tail_v[i] = i < tail ? __ldg(sm + body + i) : 0;
  }
  const int64_t base = static_cast<int64_t>(blockIdx.x) * kTile;
  const float4 xv = reinterpret_cast<const float4*>(x + base)[t];
  __syncthreads();  // the mbarrier is initialised before anyone waits on it
  if (body > 0) mbar_wait(bar, 0);
  __syncthreads();  // every thread is past the mbarrier
  if (t == 0) {
    if (body > 0) mbar_inval(bar);
#pragma unroll
    for (int i = 0; i < kTailMin + 4; ++i) {
      if (i < tail) table[body + i] = tail_v[i];
    }
  }
  __syncthreads();
  // int32 sums wrap, as the TPU kernel's do.
  const int pid = blockIdx.x;
  const uint32_t s = static_cast<uint32_t>(table[pid]) +
                     static_cast<uint32_t>(table[n - 1 - pid]) +
                     static_cast<uint32_t>(table[n / 2]);
  const float sf = static_cast<float>(static_cast<int32_t>(s));
  reinterpret_cast<float4*>(out + base)[t] =
      make_float4(xv.x + sf, xv.y + sf, xv.z + sf, xv.w + sf);
}

}  // namespace

extern "C" {

// The device's opt-in maximum of shared memory per block, in bytes, into
// *bytes; returns the cudaError_t as an int.
int rtc_smem_optin(int device, void* bytes) {
  return static_cast<int>(cudaDeviceGetAttribute(
      static_cast<int*>(bytes), cudaDevAttrMaxSharedMemoryPerBlockOptin,
      device));
}

// Raises the kernel's dynamic shared-memory limit on the current device to
// `bytes` (the opt-in maximum); the wrapper calls it once per device and
// process. Returns the cudaError_t as an int.
int rtc_smem_set_limit(int bytes) {
  return static_cast<int>(cudaFuncSetAttribute(
      smem_probe_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes));
}

// Launches the probe `launches` times back to back on `stream` (n_tiles
// CTAs, n * 4 bytes of dynamic shared memory each) and returns the first
// cudaGetLastError() that is not 0, else 0.
int rtc_smem_probe(const void* sm, const void* x, int n, int n_tiles,
                   void* out, int launches, void* stream) {
  const size_t bytes = static_cast<size_t>(n) * sizeof(int32_t);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int32_t* table = static_cast<const int32_t*>(sm);
  const float* xf = static_cast<const float*>(x);
  float* o = static_cast<float*>(out);
  for (int i = 0; i < launches; ++i) {
    smem_probe_kernel<<<n_tiles, kThreads, bytes, s>>>(table, xf, n, o);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return 0;
}

}  // extern "C"
