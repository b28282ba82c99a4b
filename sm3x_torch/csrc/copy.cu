// Identity copy of a float32 array (K4), the port's device-memory bandwidth
// probe.
//
// Replaces the Pallas TPU kernel `copy_kernel` behind `pallas_copy`
// (tools/bench_pallas_io.py:44-51), which copied (rows, 1024) float32 in
// (512, 1024) VMEM blocks to measure the TPU's HBM streaming rate.
//
// What bounds it on the H100: device memory, 4 bytes read and 4 written per
// element against 3.35 TB/s. The design: one block per 8 KB of the array
// and no loop. A thread starts its two 16-byte loads (float4, streaming:
// no line is read twice) before its first store, and the hardware's block
// scheduler spreads the 8 KB pieces over the SMs as they free up. A few
// persistent blocks an SM walking the array in a grid-stride loop, the
// first design, ran 6-9% behind `cudaMemcpyAsync` whatever the loads in
// flight a thread (2, 4, 8), the cache hints or the grid (4 to 32 blocks an
// SM, or the occupancy query's count): tools/copy_variants_torch.cu times
// the variants. The last, partial block and pointers that are not 16-byte
// aligned take masked scalar loads.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kLoads = 2;                            // 16-byte loads a thread
constexpr int kBlockElems = kThreads * kLoads * 4;   // 2048 floats, 8 KB

__global__ void __launch_bounds__(kThreads) copy_kernel(const float* __restrict__ src,
                                                        float* __restrict__ dst,
                                                        long long n, bool aligned) {
  const long long base = (long long)blockIdx.x * kBlockElems;
  if (aligned && base + kBlockElems <= n) {
    const float4* s4 = reinterpret_cast<const float4*>(src + base) + threadIdx.x;
    float4* d4 = reinterpret_cast<float4*>(dst + base) + threadIdx.x;
    float4 v[kLoads];
#pragma unroll
    for (int u = 0; u < kLoads; ++u) v[u] = __ldcs(s4 + u * kThreads);
#pragma unroll
    for (int u = 0; u < kLoads; ++u) __stcs(d4 + u * kThreads, v[u]);
  } else {
#pragma unroll
    for (int j = 0; j < kLoads * 4; ++j) {
      const long long i = base + threadIdx.x + j * kThreads;
      if (i < n) dst[i] = src[i];
    }
  }
}

}  // namespace

extern "C" {

// dst[i] = src[i] for i < n. Returns cudaGetLastError() after the launch.
int sm3x_copy(const float* src, float* dst, long long n, cudaStream_t stream) {
  if (n <= 0) return 0;
  const long long blocks = (n + kBlockElems - 1) / kBlockElems;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const bool aligned =
      ((reinterpret_cast<uintptr_t>(src) | reinterpret_cast<uintptr_t>(dst)) & 15) == 0;
  copy_kernel<<<(unsigned)blocks, kThreads, 0, stream>>>(src, dst, n, aligned);
  return (int)cudaGetLastError();
}

}  // extern "C"
