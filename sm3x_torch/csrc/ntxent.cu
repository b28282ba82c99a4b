// NT-Xent forward and backward for Hopper (K2f / K2b).
//
// Replaces the Pallas TPU kernels `_fwd_kernel` / `_bwd_kernel`
// (sm3x/ops/ntxent_pallas.py:37-74, called from `_pallas_fwd` :77 and
// `_pallas_bwd` :91). The TPU version held one (2b, D) problem and its whole
// (2b, 2b) similarity matrix in VMEM per call; the SSL loss called it once
// per term and group from a Python loop.
//
// Here every problem of one `ssl_loss` call is one launch each way: z is
// (P, n, D) with n = 2b rows per problem. What bounds it on the H100:
// nothing large. At the stage-1 shapes (P = 8, n = 96, D = 128) the work is
// 8 * 96 * 96 * 128 multiply-adds and 400 KB of input, far below what a
// launch costs, so the forward is built to be one short launch:
//   * one kernel computes the row norms, the logits, the row logsumexp and
//     the per-problem mean; a cluster of 8 blocks owns a problem, a block
//     n / 8 of its rows, 12 at a time (4 warps of 3);
//   * the rows of z come into shared memory once, by cp.async, in tiles of
//     a multiple of 96 rows with a padded stride (ntxent_tile.cuh); at the
//     stage-1 shape the whole problem is one tile of 57 KB, larger problems
//     stream tiles under an online max and sum;
//   * lanes own columns: a lane accumulates the dot products of its warp's
//     3 rows with 3 columns over D from shared memory in float32 FMAs and
//     keeps its own running max and sum of each row; one shuffle reduction
//     a row, at its end, replaces one a column. The positive and the masked
//     diagonal are picked by index. S is never written to memory;
//   * the mean keeps a fixed order: a block adds its rows' losses in row
//     order, and block 0 of the cluster adds the blocks' sums in rank order,
//     read through distributed shared memory. No float atomics: the loss
//     repeats bit for bit;
//   * the row's logsumexp and inverse norm are saved for the backward.
// The backward is one warp per row i with the row in registers, walking the
// n columns with a shuffle-reduced dot product each; it uses the symmetry
// of S: with p_ij = exp(S_ij - lse_i),
//     dzh_i = g / (n T) * (sum_j (p_ij + p_ji) zh_j - 2 zh_pos(i)),
//     then dz_i = (dzh_i - zh_i (dzh_i . zh_i)) * inv_i.
// The row normalisation is rsqrt(max(|z|^2, 1e-24)), the definition shared
// with the plain version (sm3x_torch/ops/ntxent.py::inv_norm).

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>

#include "ntxent_tile.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kWarps = 8;          // backward: rows per block
constexpr int kMaxPerLane = 16;    // backward: D <= 32 * kMaxPerLane = 512

// forward: the wrapper's shape plan (ops/ntxent_cuda.py) mirrors these
constexpr int kFwdCluster = 8;     // blocks a problem
constexpr int kFwdWarps = 4;
constexpr int kRW = 3;             // rows a warp
constexpr int kCW = 3;             // columns a lane: blocks of 96 columns
constexpr int kChunk = kFwdWarps * kRW;  // rows a block handles at a time

__device__ __forceinline__ float warp_sum(float v) {
  // xor butterfly: every lane ends with the same bits
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// Dynamic shared memory: kChunk own rows and tile_rows rows of the problem,
// `stride` floats apart, then their inverse norms.
__global__ void __cluster_dims__(kFwdCluster, 1, 1) __launch_bounds__(kFwdWarps * 32)
ntxent_fwd_kernel(const float* __restrict__ z, float* __restrict__ loss,
                  float* __restrict__ lse, float* __restrict__ inv, int n, int d,
                  int tile_rows, int vec, float temperature) {
  using namespace ntxent_tile;
  extern __shared__ __align__(16) float smem[];
  __shared__ float row_loss[kChunk];
  __shared__ float part;  // this block's sum of row losses
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int p = blockIdx.y;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int stride = tile_stride(d), d4 = (d + 3) & ~3;
  float* own = smem;
  float* tile = own + kChunk * stride;
  float* own_inv = tile + tile_rows * stride;
  float* tile_inv = own_inv + kChunk;
  const float* zp = z + (size_t)p * n * d;
  const int per_block = (n + kFwdCluster - 1) / kFwdCluster;
  const int r_begin = min(rank * per_block, n);
  const int r_end = min(r_begin + per_block, n);
  const bool one_tile = tile_rows >= n;
  float block_sum = 0.f;  // thread 0's

  for (int c0 = r_begin; c0 < r_end; c0 += kChunk) {
    const int c_rows = min(kChunk, r_end - c0);
    const bool fill = !one_tile || c0 == r_begin;  // a single tile is loaded once
    float m[kRW], l[kRW], s_pos[kRW];
#pragma unroll
    for (int r = 0; r < kRW; ++r) {
      m[r] = -INFINITY;
      l[r] = 0.f;
      s_pos[r] = 0.f;
    }
    __syncthreads();  // the chunk before is done with its rows and the tile
    tile_load(own, zp + (size_t)c0 * d, c_rows, d, stride, vec);
    for (int t0 = 0; t0 < n; t0 += tile_rows) {
      const int t_rows = min(tile_rows, n - t0);
      if (fill) {
        if (t0 > 0) __syncthreads();  // every warp is done with the tile before
        tile_load(tile, zp + (size_t)t0 * d, t_rows, d, stride, vec);
      }
      cp_async_commit();
      cp_async_wait_all();
      __syncthreads();
      if (t0 == 0) tile_row_norms(own, own_inv, c_rows, d, stride);
      if (fill) tile_row_norms(tile, tile_inv, t_rows, d, stride);
      __syncthreads();

      if (warp * kRW < c_rows) {
        for (int g0 = 0; g0 < t_rows; g0 += 32 * kCW) {
          float acc[kRW][kCW];
          tile_dots<kRW, kCW>(own + warp * kRW * stride, tile + g0 * stride, d4, stride, lane,
                              acc);
#pragma unroll
          for (int r = 0; r < kRW; ++r) {
            const int i = c0 + warp * kRW + r;  // rows >= r_end are dropped below
            const int pos = (i + n / 2) % n;
            const float inv_i = own_inv[warp * kRW + r];
            float s[kCW], top = -INFINITY;
#pragma unroll
            for (int c = 0; c < kCW; ++c) {
              const int jt = g0 + lane + 32 * c, j = t0 + jt;
              const float v = acc[r][c] * (inv_i * tile_inv[jt]) / temperature;
              if (j == pos) s_pos[r] = v;
              // the diagonal is masked out of the softmax
              s[c] = (j < n && j != i) ? v : -INFINITY;
              top = fmaxf(top, s[c]);
            }
            if (top > -INFINITY) {
              const float m_new = fmaxf(m[r], top);
              float add = 0.f;
#pragma unroll
              for (int c = 0; c < kCW; ++c) add += expf(s[c] - m_new);
              l[r] = l[r] * expf(m[r] - m_new) + add;
              m[r] = m_new;
            }
          }
        }
      }
    }

    // one reduction of (max, sum) and of the positive a row; the rows of a
    // warp past the chunk's end hold nothing and are not written
    float top[kRW], sum[kRW], positive[kRW];
#pragma unroll
    for (int r = 0; r < kRW; ++r) top[r] = warp_max(m[r]);
#pragma unroll
    for (int r = 0; r < kRW; ++r) sum[r] = warp_sum(l[r] * expf(m[r] - top[r]));
#pragma unroll
    for (int r = 0; r < kRW; ++r) positive[r] = warp_sum(s_pos[r]);  // one lane holds it
    if (lane == 0) {
#pragma unroll
      for (int r = 0; r < kRW; ++r) {
        const int k = warp * kRW + r;
        if (k < c_rows) {
          const float row_lse = top[r] + logf(sum[r]);
          const size_t at = (size_t)p * n + c0 + k;
          lse[at] = row_lse;
          inv[at] = own_inv[k];
          row_loss[k] = row_lse - positive[r];
        }
      }
    }
    __syncthreads();
    if (threadIdx.x == 0)
      for (int k = 0; k < c_rows; ++k) block_sum += row_loss[k];
  }

  if (threadIdx.x == 0) part = block_sum;
  cluster.sync();
  if (rank == 0 && threadIdx.x == 0) {
    float total = 0.f;
    for (int b = 0; b < kFwdCluster; ++b) total += *cluster.map_shared_rank(&part, b);
    loss[p] = total / n;
  }
  cluster.sync();  // no block leaves while block 0 reads its sum
}

__device__ __forceinline__ void load_row(const float* __restrict__ zr, float inv,
                                         int d, int lane, float (&v)[kMaxPerLane]) {
#pragma unroll
  for (int c = 0; c < kMaxPerLane; ++c) {
    const int k = lane + 32 * c;
    v[c] = k < d ? zr[k] * inv : 0.f;
  }
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

// z (P, n, D) f32 -> loss (P,), lse (P, n), inv (P, n), one launch.
// tile_rows (a multiple of 96) and vec (16-byte copies) come from the
// wrapper's shape plan. Returns the first CUDA error, or 0.
int sm3x_ntxent_fwd(const float* z, float* loss, float* lse, float* inv,
                    int problems, int n, int d, int tile_rows, int vec,
                    float temperature, cudaStream_t stream) {
  if (tile_rows <= 0 || tile_rows % (32 * kCW) != 0) return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)(kChunk + tile_rows) *
                      (ntxent_tile::tile_stride(d) + 1) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      ntxent_fwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(kFwdCluster, problems);
  ntxent_fwd_kernel<<<grid, kFwdWarps * 32, smem, stream>>>(
      z, loss, lse, inv, n, d, tile_rows, vec, temperature);
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
