// NT-Xent forward and backward for Hopper (K2f / K2b).
//
// Replaces the Pallas TPU kernels `_fwd_kernel` / `_bwd_kernel`
// (sm3x/ops/ntxent_pallas.py:37-74, called from `_pallas_fwd` :77 and
// `_pallas_bwd` :91). The TPU version held one (2b, D) problem and its whole
// (2b, 2b) similarity matrix in VMEM per call; the SSL loss called it once
// per term and group from a Python loop.
//
// Here every problem of one `ssl_loss` call is one launch: z is (P, n, D)
// with n = 2b rows per problem. What bounds it on the H100: nothing large.
// At the stage-1 shapes (P = 8, n = 96, D = 128) the work is 8 * 96 * 96 *
// 128 multiply-adds and 400 KB of input, so launch latency and the serial
// column loop dominate. The design keeps it simple and exact:
//   * one warp per row i; the row's normalised vector lives in registers
//     (D / 32 values a lane), and the warp walks the n columns with a
//     shuffle-reduced dot product each, so S is never written to memory;
//   * the forward keeps an online max and sum of the row's logits, and saves
//     the row's logsumexp and inverse norm for the backward;
//   * rows are reduced to the per-problem mean by a second kernel with a
//     fixed summation order (no float atomics), so the loss is repeatable;
//   * the backward uses the symmetry of S: with p_ij = exp(S_ij - lse_i),
//     dzh_i = g / (n T) * (sum_j (p_ij + p_ji) zh_j - 2 zh_pos(i)),
//     then dz_i = (dzh_i - zh_i (dzh_i . zh_i)) * inv_i.
// The row normalisation is rsqrt(max(|z|^2, 1e-24)), the definition shared
// with the plain version (sm3x_torch/ops/ntxent.py::inv_norm).

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kWarps = 8;          // rows per block
constexpr int kMaxPerLane = 16;    // D <= 32 * kMaxPerLane = 512
constexpr int kReduceThreads = 256;

__device__ __forceinline__ float warp_sum(float v) {
  // xor butterfly: every lane ends with the same bits
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// inv[r] = rsqrt(max(|z_r|^2, 1e-24)) for every row of every problem
__global__ void inv_norm_kernel(const float* __restrict__ z,
                                float* __restrict__ inv, int rows, int d) {
  const int row = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (row >= rows) return;
  const float* zr = z + (size_t)row * d;
  float s = 0.f;
  for (int k = lane; k < d; k += 32) s += zr[k] * zr[k];
  s = warp_sum(s);
  if (lane == 0) inv[row] = rsqrtf(fmaxf(s, 1e-24f));
}

__device__ __forceinline__ void load_row(const float* __restrict__ zr, float inv,
                                         int d, int lane, float (&v)[kMaxPerLane]) {
#pragma unroll
  for (int c = 0; c < kMaxPerLane; ++c) {
    const int k = lane + 32 * c;
    v[c] = k < d ? zr[k] * inv : 0.f;
  }
}

__global__ void ntxent_fwd_kernel(const float* __restrict__ z,
                                  const float* __restrict__ inv,
                                  float* __restrict__ lse,
                                  float* __restrict__ row_loss,
                                  int n, int d, float temperature) {
  const int p = blockIdx.x;
  const int i = blockIdx.y * kWarps + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (i >= n) return;
  const float* zp = z + (size_t)p * n * d;
  const float* invp = inv + (size_t)p * n;
  const int pos = (i + n / 2) % n;

  float zi[kMaxPerLane];
  load_row(zp + (size_t)i * d, invp[i], d, lane, zi);

  float m = -INFINITY, l = 0.f, s_pos = 0.f;
  for (int j = 0; j < n; ++j) {
    const float* zj = zp + (size_t)j * d;
    const float inv_j = invp[j];
    float dot = 0.f;
#pragma unroll
    for (int c = 0; c < kMaxPerLane; ++c) {
      const int k = lane + 32 * c;
      if (k < d) dot += zi[c] * (zj[k] * inv_j);
    }
    const float s = warp_sum(dot) / temperature;
    if (j == pos) s_pos = s;
    if (j == i) continue;  // the diagonal is masked out of the softmax
    if (s > m) {
      l = l * expf(m - s) + 1.f;
      m = s;
    } else {
      l += expf(s - m);
    }
  }
  if (lane == 0) {
    const float row_lse = m + logf(l);
    lse[(size_t)p * n + i] = row_lse;
    row_loss[(size_t)p * n + i] = row_lse - s_pos;
  }
}

// loss[p] = mean of row_loss[p, :], summed in a fixed order
__global__ void row_mean_kernel(const float* __restrict__ row_loss,
                                float* __restrict__ loss, int n) {
  __shared__ float part[kReduceThreads];
  const float* r = row_loss + (size_t)blockIdx.x * n;
  float s = 0.f;
  for (int k = threadIdx.x; k < n; k += kReduceThreads) s += r[k];
  part[threadIdx.x] = s;
  __syncthreads();
  for (int w = kReduceThreads / 2; w > 0; w >>= 1) {
    if (threadIdx.x < w) part[threadIdx.x] += part[threadIdx.x + w];
    __syncthreads();
  }
  if (threadIdx.x == 0) loss[blockIdx.x] = part[0] / n;
}

__global__ void ntxent_bwd_kernel(const float* __restrict__ z,
                                  const float* __restrict__ inv,
                                  const float* __restrict__ lse,
                                  const float* __restrict__ g,
                                  float* __restrict__ dz,
                                  int n, int d, float temperature) {
  const int p = blockIdx.x;
  const int i = blockIdx.y * kWarps + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (i >= n) return;
  const float* zp = z + (size_t)p * n * d;
  const float* invp = inv + (size_t)p * n;
  const float* lsep = lse + (size_t)p * n;
  const int pos = (i + n / 2) % n;
  const float lse_i = lsep[i];

  float zi[kMaxPerLane], acc[kMaxPerLane];
  load_row(zp + (size_t)i * d, invp[i], d, lane, zi);
#pragma unroll
  for (int c = 0; c < kMaxPerLane; ++c) acc[c] = 0.f;

  for (int j = 0; j < n; ++j) {
    if (j == i) continue;  // p_ii = 0
    float zj[kMaxPerLane];
    load_row(zp + (size_t)j * d, invp[j], d, lane, zj);
    float dot = 0.f;
#pragma unroll
    for (int c = 0; c < kMaxPerLane; ++c) dot += zi[c] * zj[c];
    const float s = warp_sum(dot) / temperature;
    float coef = expf(s - lse_i) + expf(s - lsep[j]);
    if (j == pos) coef -= 2.f;
#pragma unroll
    for (int c = 0; c < kMaxPerLane; ++c) acc[c] += coef * zj[c];
  }

  const float scale = g[p] / (n * temperature);
  float proj = 0.f;
#pragma unroll
  for (int c = 0; c < kMaxPerLane; ++c) {
    acc[c] *= scale;  // acc is now d(zh_i)
    proj += acc[c] * zi[c];
  }
  proj = warp_sum(proj);
  const float inv_i = invp[i];
  float* out = dz + ((size_t)p * n + i) * d;
#pragma unroll
  for (int c = 0; c < kMaxPerLane; ++c) {
    const int k = lane + 32 * c;
    if (k < d) out[k] = (acc[c] - zi[c] * proj) * inv_i;
  }
}

}  // namespace

extern "C" {

// z (P, n, D) f32 -> loss (P,), lse (P, n), inv (P, n); row_loss (P, n) is
// scratch. Returns cudaGetLastError() after the launches.
int sm3x_ntxent_fwd(const float* z, float* loss, float* lse, float* inv,
                    float* row_loss, int problems, int n, int d,
                    float temperature, cudaStream_t stream) {
  const int rows = problems * n;
  inv_norm_kernel<<<(rows + kWarps - 1) / kWarps, kWarps * 32, 0, stream>>>(
      z, inv, rows, d);
  dim3 grid(problems, (n + kWarps - 1) / kWarps);
  ntxent_fwd_kernel<<<grid, kWarps * 32, 0, stream>>>(z, inv, lse, row_loss, n,
                                                      d, temperature);
  row_mean_kernel<<<problems, kReduceThreads, 0, stream>>>(row_loss, loss, n);
  return (int)cudaGetLastError();
}

// z (P, n, D), lse and inv from the forward, g (P,) -> dz (P, n, D).
int sm3x_ntxent_bwd(const float* z, const float* lse, const float* inv,
                    const float* g, float* dz, int problems, int n, int d,
                    float temperature, cudaStream_t stream) {
  dim3 grid(problems, (n + kWarps - 1) / kWarps);
  ntxent_bwd_kernel<<<grid, kWarps * 32, 0, stream>>>(z, inv, lse, g, dz, n, d,
                                                      temperature);
  return (int)cudaGetLastError();
}

}  // extern "C"
