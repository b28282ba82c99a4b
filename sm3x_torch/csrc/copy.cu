// Identity copy of a float32 array (K4), the port's device-memory bandwidth
// probe.
//
// Replaces the Pallas TPU kernel `copy_kernel` behind `pallas_copy`
// (tools/bench_pallas_io.py:44-51), which copied (rows, 1024) float32 in
// (512, 1024) VMEM blocks to measure the TPU's HBM streaming rate.
//
// What bounds it on the H100: device memory, 4 bytes read and 4 written per
// element against 3.35 TB/s. The design: a grid-stride loop of 16-byte
// loads and stores (float4) over the bulk, sized to a few blocks per SM so
// that enough loads are in flight, and a masked scalar tail for the last
// n % 4 elements. Pointers that are not 16-byte aligned take the scalar
// loop throughout.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kBlocksPerSm = 8;

__global__ void __launch_bounds__(kThreads) copy_kernel(const float* __restrict__ src,
                                                        float* __restrict__ dst,
                                                        long long n) {
  const long long tid = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long step = (long long)gridDim.x * blockDim.x;
  const bool aligned =
      ((reinterpret_cast<uintptr_t>(src) | reinterpret_cast<uintptr_t>(dst)) & 15) == 0;
  long long done = 0;
  if (aligned) {
    const long long n4 = n / 4;
    const float4* s4 = reinterpret_cast<const float4*>(src);
    float4* d4 = reinterpret_cast<float4*>(dst);
    for (long long i = tid; i < n4; i += step) d4[i] = s4[i];
    done = 4 * n4;
  }
  for (long long i = done + tid; i < n; i += step) dst[i] = src[i];
}

}  // namespace

extern "C" {

// dst[i] = src[i] for i < n. Returns cudaGetLastError() after the launch.
int sm3x_copy(const float* src, float* dst, long long n, cudaStream_t stream) {
  if (n <= 0) return 0;
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const long long want = (n / 4 + kThreads - 1) / kThreads + 1;
  const long long cap = (long long)sms * kBlocksPerSm;
  const int blocks = (int)(want < cap ? want : cap);
  copy_kernel<<<blocks, kThreads, 0, stream>>>(src, dst, n);
  return (int)cudaGetLastError();
}

}  // extern "C"
