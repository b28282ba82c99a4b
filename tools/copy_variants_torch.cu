// Copy-kernel variants against cudaMemcpyAsync over 256 MiB of float32 on
// one NVIDIA GPU: the measurement behind the design of K4
// (sm3x_torch/csrc/copy.cu). A standalone program, no PyTorch:
//
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 \
//        -o build/copy_variants tools/copy_variants_torch.cu && build/copy_variants
//
// Each line is the device time of one variant, CUDA events around 50
// launches in a row after a warm-up, two rounds in turns:
//   base     a grid-stride loop of 16-byte loads and stores, 4 to 32 blocks
//            of 256 threads an SM;
//   unroll   U 16-byte loads a thread started before its first store, plain
//            (cs=0) or streaming (cs=1, __ldcs / __stcs), with the grid the
//            occupancy query's count times the SMs, half of it, or one
//            256 U x 16-byte chunk a block and no loop.
#include <cuda_runtime.h>
#include <stdio.h>
#include <stdint.h>
constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads) base_kernel(const float4* __restrict__ s, float4* __restrict__ d, long long n4) {
  const long long tid = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long step = (long long)gridDim.x * blockDim.x;
  for (long long i = tid; i < n4; i += step) d[i] = s[i];
}

template <int U, bool CS>
__global__ void __launch_bounds__(kThreads) unroll_kernel(const float4* __restrict__ s, float4* __restrict__ d, long long n4) {
  constexpr long long chunk = (long long)kThreads * U;
  const long long nchunks = n4 / chunk;
  for (long long c = blockIdx.x; c < nchunks; c += gridDim.x) {
    const float4* sp = s + c * chunk + threadIdx.x;
    float4* dp = d + c * chunk + threadIdx.x;
    float4 v[U];
#pragma unroll
    for (int u = 0; u < U; ++u) v[u] = CS ? __ldcs(sp + u * kThreads) : sp[u * kThreads];
#pragma unroll
    for (int u = 0; u < U; ++u) { if (CS) __stcs(dp + u * kThreads, v[u]); else dp[u * kThreads] = v[u]; }
  }
  const long long tid = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long step = (long long)gridDim.x * blockDim.x;
  for (long long i = nchunks * chunk + tid; i < n4; i += step) d[i] = s[i];
}

template <class F> float time_ms(F f, int reps = 50) {
  for (int i = 0; i < 3; ++i) f();
  cudaEvent_t a, b; cudaEventCreate(&a); cudaEventCreate(&b);
  cudaDeviceSynchronize();
  cudaEventRecord(a);
  for (int i = 0; i < reps; ++i) f();
  cudaEventRecord(b); cudaEventSynchronize(b);
  float ms; cudaEventElapsedTime(&ms, a, b); return ms / reps;
}

template <int U, bool CS> void run(const char* name, const float4* s, float4* d, long long n4, int sms) {
  int occ = 0;
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&occ, unroll_kernel<U, CS>, kThreads, 0);
  const long long nchunks = n4 / ((long long)kThreads * U);
  for (int mode = 0; mode < 3; ++mode) {
    long long blocks = mode == 0 ? (long long)sms * occ : mode == 1 ? (long long)sms * occ / 2 : nchunks;
    if (blocks > nchunks) blocks = nchunks;
    float ms = time_ms([&] { unroll_kernel<U, CS><<<(int)blocks, kThreads>>>(s, d, n4); });
    printf("%s U=%d cs=%d occ=%d grid=%lld (%s): %.4f ms  %.1f GB/s  err=%d\n", name, U, (int)CS, occ, blocks,
           mode == 0 ? "sms*occ" : mode == 1 ? "sms*occ/2" : "one chunk a block", ms, 2.0 * n4 * 16 / ms / 1e6, (int)cudaGetLastError());
  }
}

int main() {
  const long long n = 64LL * 1024 * 1024;  // floats, 256 MiB
  const long long n4 = n / 4;
  float *s, *d; cudaMalloc(&s, n * 4); cudaMalloc(&d, n * 4);
  cudaMemset(s, 1, n * 4);
  int sms; cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, 0);
  const float4* s4 = (const float4*)s; float4* d4 = (float4*)d;
  for (int round = 0; round < 2; ++round) {
    float ms = time_ms([&] { cudaMemcpyAsync(d, s, n * 4, cudaMemcpyDeviceToDevice, 0); });
    printf("cudaMemcpyAsync: %.4f ms %.1f GB/s\n", ms, 2.0 * n * 4 / ms / 1e6);
    for (int bps : {4, 8, 16, 32}) {
      ms = time_ms([&] { base_kernel<<<sms * bps, kThreads>>>(s4, d4, n4); });
      printf("base blocks/sm=%d: %.4f ms %.1f GB/s\n", bps, ms, 2.0 * n * 4 / ms / 1e6);
    }
    run<2, false>("unroll", s4, d4, n4, sms);
    run<4, false>("unroll", s4, d4, n4, sms);
    run<8, false>("unroll", s4, d4, n4, sms);
    run<2, true>("unroll", s4, d4, n4, sms);
    run<4, true>("unroll", s4, d4, n4, sms);
    run<8, true>("unroll", s4, d4, n4, sms);
    ms = time_ms([&] { cudaMemcpyAsync(d, s, n * 4, cudaMemcpyDeviceToDevice, 0); });
    printf("cudaMemcpyAsync: %.4f ms %.1f GB/s\n", ms, 2.0 * n * 4 / ms / 1e6);
  }
  return 0;
}
