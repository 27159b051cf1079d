// Shared-memory probe, hand-written for Hopper (K10).
//
// Replaces tools/smem_probe.py::_kernel (launcher probe), the JAX package's
// probe of the largest table a kernel can hold in the TPU's scalar memory.
// Here the n-word table is staged whole in DYNAMIC shared memory and each
// CTA, one per 8 x 128 tile of x, computes the TPU kernel's function
//   o = x + f32(sm[pid] + sm[n - 1 - pid] + sm[n / 2])
// reading scattered entries so that the table cannot be elided. The launch
// asks for n * 4 bytes of dynamic shared memory after raising the kernel's
// limit to the device's opt-in maximum per block
// (cudaDevAttrMaxSharedMemoryPerBlockOptin, 232,448 bytes on an H100), so a
// table up to that size runs and the first larger one is refused by the
// launch (cudaErrorInvalidValue): the refusal is the measurement.
//
// What bounds it: the copy of the table into shared memory, n * 4 bytes
// per CTA read from L2 (8 CTAs for the probe's 64 x 128 x), and the launch.
// The design: 256 threads copy the table with coalesced loads, then each
// writes 4 of the tile's 1,024 outputs.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTile = 8 * 128;

__global__ void __launch_bounds__(kThreads)
smem_probe_kernel(const int32_t* __restrict__ sm,  // [n]
                  const float* __restrict__ x,     // [n_tiles * 8, 128]
                  int n, float* __restrict__ out) {
  extern __shared__ int32_t table[];
  for (int i = threadIdx.x; i < n; i += kThreads) table[i] = __ldg(sm + i);
  __syncthreads();
  const int pid = blockIdx.x;
  // int32 sums wrap, as the TPU kernel's do.
  const uint32_t s = static_cast<uint32_t>(table[pid]) +
                     static_cast<uint32_t>(table[n - 1 - pid]) +
                     static_cast<uint32_t>(table[n / 2]);
  const float sf = static_cast<float>(static_cast<int32_t>(s));
  const int64_t base = static_cast<int64_t>(pid) * kTile;
  for (int i = threadIdx.x; i < kTile; i += kThreads) {
    out[base + i] = x[base + i] + sf;
  }
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

// Launches the probe on `stream` (n_tiles CTAs, n * 4 bytes of dynamic
// shared memory) and returns cudaGetLastError() as an int (0 = launched).
int rtc_smem_probe(const void* sm, const void* x, int n, int n_tiles,
                   void* out, void* stream) {
  int device = 0;
  int optin = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(
        &optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  }
  if (err == cudaSuccess) {
    err = cudaFuncSetAttribute(smem_probe_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               optin);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t bytes = static_cast<size_t>(n) * sizeof(int32_t);
  smem_probe_kernel<<<n_tiles, kThreads, bytes,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(sm), static_cast<const float*>(x), n,
      static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
