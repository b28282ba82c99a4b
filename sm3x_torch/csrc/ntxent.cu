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
//     stream tiles under an online max and sum; where D is too wide for 96
//     rows a tile, a lane takes 1 column and tiles are multiples of 32 rows;
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
// The backward (K2b) stands on the same tiles. With p_ij = exp(S_ij - lse_i)
// off the diagonal it uses the symmetry of S:
//     dzh_i = g / (n T) * (sum_j (p_ij + p_ji) zh_j - 2 zh_pos(i)),
//     then dz_i = (dzh_i - zh_i (dzh_i . zh_i)) * inv_i.
// Rows of dz are independent, so it needs no cluster: a block takes a share
// of a problem's rows, `chunk` (3 a warp) at a time, and
//   * brings the problem's rows into shared memory once by cp.async, with
//     the saved lse and inverse norms beside them (no norm is recomputed);
//   * first product, lanes own columns (`tile_dots`): from S_ij each lane
//     forms coef_ij = (p_ij + p_ji - 2 [j = pos(i)]) inv_j, 0 on the diagonal
//     and past n, into a coefficient buffer in shared memory;
//   * second product, lanes own dimensions: acc_i[k] = sum_j coef_ij z_j[k],
//     a lane on 4 consecutive k (16-byte loads down the tile, free of bank
//     conflicts), coef_ij a broadcast read, j in index order, D in blocks of
//     128 with the partial row in shared memory: no array in registers grows
//     with D, so D is bounded by shared memory alone;
//   * tail: one shuffle reduction a row for dzh_i . zh_i, then dz_i.
// Problems larger than shared memory stream tiles, adding into the partial
// rows in tile order. Every sum has a fixed order and there are no float
// atomics: dz repeats bit for bit.
// The row normalisation is rsqrt(max(|z|^2, 1e-24)), the definition shared
// with the plain version (sm3x_torch/ops/ntxent.py::inv_norm).

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>

#include "ntxent_tile.cuh"

namespace cg = cooperative_groups;

namespace {

// the wrapper's shape plans (ops/ntxent_cuda.py) mirror these
constexpr int kRW = 3;             // rows a warp, both kernels
// columns a lane (the template parameter CW): 3, blocks of 96 columns, or 1
// where 96 rows of a wide D do not fit in shared memory
constexpr int kFwdCluster = 8;     // forward: blocks a problem
constexpr int kFwdWarps = 4;
constexpr int kChunk = kFwdWarps * kRW;  // forward: rows a block handles at a time
constexpr int kBwdMaxWarps = 8;    // backward: the launch sets the warps a block
// Both kernels name 1 block an SM in their launch bounds: left to itself
// ptxas holds them to about 70 registers (and spills 20 bytes of the
// forward's), with the 1 it takes about 110 and the kernels are 8-20%
// faster on an H100 (0.0090 -> 0.0082 and 0.0102 -> 0.0093 ms at (8, 96, 128)).

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
template <int CW>
__global__ void __cluster_dims__(kFwdCluster, 1, 1) __launch_bounds__(kFwdWarps * 32, 1)
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
        for (int g0 = 0; g0 < t_rows; g0 += 32 * CW) {
          float acc[kRW][CW];
          tile_dots<kRW, CW>(own + warp * kRW * stride, tile + g0 * stride, d4, stride, lane,
                              acc);
#pragma unroll
          for (int r = 0; r < kRW; ++r) {
            const int i = c0 + warp * kRW + r;  // rows >= r_end are dropped below
            const int pos = (i + n / 2) % n;
            const float inv_i = own_inv[warp * kRW + r];
            float s[CW], top = -INFINITY;
#pragma unroll
            for (int c = 0; c < CW; ++c) {
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
              for (int c = 0; c < CW; ++c) add += expf(s[c] - m_new);
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

// Dynamic shared memory, in floats (chunk = 3 x the block's warps): the
// block's own rows and their partial sums (chunk x stride each), the tile
// (tile_rows x stride), the coefficients (chunk x tile_rows), then inv and
// lse of the own rows and of the tile's.
template <int CW>
__global__ void __launch_bounds__(kBwdMaxWarps * 32, 1)
ntxent_bwd_kernel(const float* __restrict__ z, const float* __restrict__ inv,
                  const float* __restrict__ lse, const float* __restrict__ g,
                  float* __restrict__ dz, int n, int d, int tile_rows, int vec,
                  float temperature) {
  using namespace ntxent_tile;
  extern __shared__ __align__(16) float smem[];
  const int p = blockIdx.y;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int chunk = (blockDim.x >> 5) * kRW;
  const int stride = tile_stride(d), d4 = (d + 3) & ~3;
  float* own = smem;
  float* accb = own + chunk * stride;
  float* tile = accb + chunk * stride;
  float* coef = tile + tile_rows * stride;
  float* own_inv = coef + chunk * tile_rows;
  float* own_lse = own_inv + chunk;
  float* tile_inv = own_lse + chunk;
  float* tile_lse = tile_inv + tile_rows;
  const float* zp = z + (size_t)p * n * d;
  const float* invp = inv + (size_t)p * n;
  const float* lsep = lse + (size_t)p * n;
  const int per_block = (n + gridDim.x - 1) / gridDim.x;
  const int r_begin = min((int)blockIdx.x * per_block, n);
  const int r_end = min(r_begin + per_block, n);
  const bool one_tile = tile_rows >= n;
  const float scale = g[p] / (n * temperature);
  // this warp's rows of the chunk, their partial sums and coefficients
  const float* my_rows = own + warp * kRW * stride;
  float* my_acc = accb + warp * kRW * stride;
  float* my_coef = coef + warp * kRW * tile_rows;

  for (int c0 = r_begin; c0 < r_end; c0 += chunk) {
    const int c_rows = min(chunk, r_end - c0);
    const bool fill = !one_tile || c0 == r_begin;  // a single tile is loaded once
    const bool active = warp * kRW < c_rows;
    __syncthreads();  // the chunk before is done with its rows and the tile
    tile_load(own, zp + (size_t)c0 * d, c_rows, d, stride, vec);
    for (int k = threadIdx.x; k < c_rows; k += blockDim.x) {
      own_inv[k] = invp[c0 + k];
      own_lse[k] = lsep[c0 + k];
    }
    for (int t0 = 0; t0 < n; t0 += tile_rows) {
      const int t_rows = min(tile_rows, n - t0);
      if (fill) {
        if (t0 > 0) __syncthreads();  // every warp is done with the tile before
        tile_load(tile, zp + (size_t)t0 * d, t_rows, d, stride, vec);
        for (int k = threadIdx.x; k < t_rows; k += blockDim.x) {
          tile_inv[k] = invp[t0 + k];
          tile_lse[k] = lsep[t0 + k];
        }
      }
      cp_async_commit();
      cp_async_wait_all();
      __syncthreads();
      if (d4 != d) {
        if (t0 == 0) tile_zero_tails(own, c_rows, d, stride);
        if (fill) tile_zero_tails(tile, t_rows, d, stride);
        __syncthreads();
      }
      if (!active) continue;

      // first product, lanes own columns: the coefficients of this warp's
      // rows against the tile. Rows of the tile past t_rows hold anything;
      // their coefficients are 0 and the second product never reads them.
      for (int g0 = 0; g0 < t_rows; g0 += 32 * CW) {
        float acc[kRW][CW];
        tile_dots<kRW, CW>(my_rows, tile + g0 * stride, d4, stride, lane, acc);
#pragma unroll
        for (int r = 0; r < kRW; ++r) {
          const int i = c0 + warp * kRW + r;  // rows >= r_end are dropped below
          const int pos = (i + n / 2) % n;
          const float inv_i = own_inv[warp * kRW + r], lse_i = own_lse[warp * kRW + r];
#pragma unroll
          for (int c = 0; c < CW; ++c) {
            const int jt = g0 + lane + 32 * c, j = t0 + jt;
            float v = 0.f;
            if (j < n && j != i) {  // p_ii = 0
              const float inv_j = tile_inv[jt];
              const float s = acc[r][c] * (inv_i * inv_j) / temperature;
              v = expf(s - lse_i) + expf(s - tile_lse[jt]);
              if (j == pos) v -= 2.f;
              v *= inv_j;  // the second product runs on the rows as they are
            }
            my_coef[r * tile_rows + jt] = v;
          }
        }
      }
      __syncwarp();

      // second product, lanes own dimensions, j in index order; the partial
      // rows of a lane are its own from tile to tile
      for (int kb = 4 * lane; kb < d4; kb += 128) {
        float4 a[kRW];
#pragma unroll
        for (int r = 0; r < kRW; ++r)
          a[r] = t0 == 0 ? make_float4(0.f, 0.f, 0.f, 0.f)
                         : *reinterpret_cast<const float4*>(my_acc + r * stride + kb);
        const float* col = tile + kb;
        const int t4 = t_rows & ~3;
        for (int j = 0; j < t4; j += 4) {
          float4 c4[kRW];
#pragma unroll
          for (int r = 0; r < kRW; ++r)
            c4[r] = *reinterpret_cast<const float4*>(my_coef + r * tile_rows + j);
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float4 zj = *reinterpret_cast<const float4*>(col + (j + e) * stride);
#pragma unroll
            for (int r = 0; r < kRW; ++r) {
              const float c = e == 0 ? c4[r].x : e == 1 ? c4[r].y : e == 2 ? c4[r].z : c4[r].w;
              a[r].x = fmaf(c, zj.x, a[r].x);
              a[r].y = fmaf(c, zj.y, a[r].y);
              a[r].z = fmaf(c, zj.z, a[r].z);
              a[r].w = fmaf(c, zj.w, a[r].w);
            }
          }
        }
        for (int j = t4; j < t_rows; ++j) {
          const float4 zj = *reinterpret_cast<const float4*>(col + j * stride);
#pragma unroll
          for (int r = 0; r < kRW; ++r) {
            const float c = my_coef[r * tile_rows + j];
            a[r].x = fmaf(c, zj.x, a[r].x);
            a[r].y = fmaf(c, zj.y, a[r].y);
            a[r].z = fmaf(c, zj.z, a[r].z);
            a[r].w = fmaf(c, zj.w, a[r].w);
          }
        }
#pragma unroll
        for (int r = 0; r < kRW; ++r)
          *reinterpret_cast<float4*>(my_acc + r * stride + kb) = a[r];
      }
      __syncwarp();  // the next tile's coefficients wait for this product
    }
    if (!active) continue;

    // tail: dzh_i = acc_i g / (n T), one reduction a row for dzh_i . zh_i,
    // then dz_i. A lane reads back the partial sums it wrote.
    for (int r = 0; r < kRW; ++r) {
      const int k = warp * kRW + r;
      if (k >= c_rows) break;
      const float inv_i = own_inv[k];
      float part = 0.f;
      for (int kb = 4 * lane; kb < d4; kb += 128) {
        const float4 a = *reinterpret_cast<const float4*>(my_acc + r * stride + kb);
        const float4 zi = *reinterpret_cast<const float4*>(my_rows + r * stride + kb);
        part += (a.x * zi.x + a.y * zi.y) + (a.z * zi.z + a.w * zi.w);
      }
      const float proj = warp_sum(part) * (scale * inv_i);  // dzh_i . zh_i
      float* out = dz + ((size_t)p * n + c0 + k) * d;
      for (int kb = 4 * lane; kb < d4; kb += 128) {
        const float4 a = *reinterpret_cast<const float4*>(my_acc + r * stride + kb);
        const float4 zi = *reinterpret_cast<const float4*>(my_rows + r * stride + kb);
        float4 o;
        o.x = (a.x * scale - zi.x * inv_i * proj) * inv_i;
        o.y = (a.y * scale - zi.y * inv_i * proj) * inv_i;
        o.z = (a.z * scale - zi.z * inv_i * proj) * inv_i;
        o.w = (a.w * scale - zi.w * inv_i * proj) * inv_i;
        if (vec) {
          *reinterpret_cast<float4*>(out + kb) = o;
        } else {
          if (kb < d) out[kb] = o.x;
          if (kb + 1 < d) out[kb + 1] = o.y;
          if (kb + 2 < d) out[kb + 2] = o.z;
          if (kb + 3 < d) out[kb + 3] = o.w;
        }
      }
    }
  }
}

}  // namespace

extern "C" {

// z (P, n, D) f32 -> loss (P,), lse (P, n), inv (P, n), one launch.
// tile_rows (a multiple of 32 * cw), cw (3 or 1 columns a lane) and vec
// (16-byte copies) come from the wrapper's shape plan. Returns the first CUDA
// error, or 0.
int sm3x_ntxent_fwd(const float* z, float* loss, float* lse, float* inv,
                    int problems, int n, int d, int tile_rows, int cw, int vec,
                    float temperature, cudaStream_t stream) {
  if ((cw != 1 && cw != 3) || tile_rows <= 0 || tile_rows % (32 * cw) != 0)
    return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)(kChunk + tile_rows) *
                      (ntxent_tile::tile_stride(d) + 1) * sizeof(float);
  auto kernel = cw == 3 ? ntxent_fwd_kernel<3> : ntxent_fwd_kernel<1>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(kFwdCluster, problems);
  kernel<<<grid, kFwdWarps * 32, smem, stream>>>(z, loss, lse, inv, n, d, tile_rows, vec,
                                                 temperature);
  return (int)cudaGetLastError();
}

// z (P, n, D), lse and inv from the forward, g (P,) -> dz (P, n, D), one
// launch of `blocks` blocks a problem, `warps` warps each. tile_rows, cw,
// warps, blocks and vec come from the wrapper's shape plan.
int sm3x_ntxent_bwd(const float* z, const float* lse, const float* inv,
                    const float* g, float* dz, int problems, int n, int d,
                    int tile_rows, int cw, int warps, int blocks, int vec,
                    float temperature, cudaStream_t stream) {
  if ((cw != 1 && cw != 3) || tile_rows <= 0 || tile_rows % (32 * cw) != 0 || warps < 1 ||
      warps > kBwdMaxWarps || blocks < 1)
    return (int)cudaErrorInvalidValue;
  const int chunk = warps * kRW, stride = ntxent_tile::tile_stride(d);
  const size_t smem = ((size_t)chunk * (2 * stride + tile_rows + 2) +
                       (size_t)tile_rows * (stride + 2)) * sizeof(float);
  auto kernel = cw == 3 ? ntxent_bwd_kernel<3> : ntxent_bwd_kernel<1>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(blocks, problems);
  kernel<<<grid, warps * 32, smem, stream>>>(z, inv, lse, g, dz, n, d, tile_rows, vec,
                                             temperature);
  return (int)cudaGetLastError();
}

}  // extern "C"
