// Batch norm over channels-last activations in train mode, with a residual
// block's add and ReLU folded into its apply pass (K6), and its backward.
//
// Replaces no TPU kernel: the JAX package leaves batch norm to XLA, which
// fuses it with the add and the ReLU beside it. It was added because on an
// H100 PyTorch's channels-last batch-norm kernels, and the ReLU and add
// kernels around them, took ~63 ms of the ~111 ms ResNet-50 SSL step
// (bf16, 4 encoder calls of 96 images at 224 a step), the statistics
// kernel at 18% of its bytes bound.
//
// The layout: x is (R, C) row-major, R = N H W rows of C channels (a
// channels-last (N, C, H, W) tensor), float32 or bfloat16; the per-channel
// parameters and statistics are float32. With n = R:
//   bn_fwd_stats_kernel   the batch mean and the biased variance of each
//                         channel; writes mean and invstd = 1 / sqrt(var +
//                         eps), and moves the running statistics toward
//                         them (Flax's convention: the biased variance) and
//                         the step count by one
//   bn_fwd_apply_kernel   y = relu?((x - mean) gamma invstd + beta (+ res))
//   bn_bwd_reduce_kernel  S1 = sum dy', S2 = sum dy' (x - mean), with dy' =
//                         dy [v > 0] under the ReLU (v the value before it);
//                         writes S1, S2, dgamma = S2 invstd, dbeta = S1
//   bn_bwd_elemt_kernel   dx = gamma invstd (dy' - S1 / n - (x - mean)
//                         invstd^2 S2 / n), and d_res = dy' where there is a
//                         residual, in one pass
// The ReLU's mask is recomputed from x where there is no residual (the
// forward's arithmetic, instruction for instruction) and read from the
// saved output y where there is one (y is the next block's input, which
// its convolution keeps for the backward anyway; the residual may not be).
// Arithmetic is float32; each output is rounded once.
//
// What bounds it on the H100: device memory (3.35 TB/s). A step's passes
// over its activations are what the time is: 1 (statistics) + 2 (apply) +
// 2 (reduce) + 3 (elemt), two more reads and one more write with a
// residual, against the eight of PyTorch's four kernels plus two for the
// ReLU, three for its backward and three for the add.
//
// The design. A block of 256 threads is TR rows by TC threads along C (TC
// a power of two, up to 8 in the wrapper's plan: 128 bytes of a row); a
// thread reads 16 bytes of channels a row (8 bf16 or 4 float32) with
// `kUnroll` rows in flight, so a warp reads whole 128-byte lines and the
// channel tiles are gridDim.y columns. The two reductions run two blocks
// an SM (the wrapper's plan),
// each walking the row tiles in a grid stride: per thread a Welford
// (count, mean, M2) for the statistics, plain float32 sums for the
// backward, merged in the block by a tree in shared memory; the block's
// partial goes to scratch, and the last block of each column to finish
// (a counter that it resets, so a replayed CUDA graph finds 0) merges the
// partials with Chan et al.'s pairwise formula (the sums: added) in a
// fixed order, so every run gives the same bits. The two elementwise
// kernels take one tile a block with no loop (a block per 16 KB read, as
// K4) and start at the last tile, which the reduction before them read
// last and which is likeliest still in the 50 MB L2. The counters are
// device globals: two launches of this family must not run at once on
// one device (the port runs them on its one compute stream).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace sm3x {
namespace {

constexpr int kThreads = 256;
constexpr int kUnroll = 4;          // rows in flight a thread
constexpr int kMaxColumns = 1024;   // channel tiles of a launch
constexpr int kMaskNone = 0, kMaskFromX = 1, kMaskFromY = 2;

__device__ unsigned int g_stats_arrivals[kMaxColumns];
__device__ unsigned int g_reduce_arrivals[kMaxColumns];

// 16 bytes of one type as floats.
template <typename T>
struct Vec;

template <>
struct Vec<float> {
  static constexpr int N = 4;
  __device__ __forceinline__ static void unpack(const uint4& u, float* f) {
    f[0] = __uint_as_float(u.x);
    f[1] = __uint_as_float(u.y);
    f[2] = __uint_as_float(u.z);
    f[3] = __uint_as_float(u.w);
  }
  __device__ __forceinline__ static uint4 pack(const float* f) {
    return make_uint4(__float_as_uint(f[0]), __float_as_uint(f[1]), __float_as_uint(f[2]),
                      __float_as_uint(f[3]));
  }
};

__device__ __forceinline__ unsigned pack_bf16x2(float lo, float hi) {
  __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<unsigned*>(&h);
}

template <>
struct Vec<__nv_bfloat16> {
  static constexpr int N = 8;
  __device__ __forceinline__ static void unpack(const uint4& u, float* f) {
    const unsigned w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      f[2 * i] = __uint_as_float(w[i] << 16);
      f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
  }
  __device__ __forceinline__ static uint4 pack(const float* f) {
    return make_uint4(pack_bf16x2(f[0], f[1]), pack_bf16x2(f[2], f[3]), pack_bf16x2(f[4], f[5]),
                      pack_bf16x2(f[6], f[7]));
  }
};

// Where a thread sits: TC = 1 << tc_log2 threads along C, TR along rows.
struct Place {
  int tc, tr, lane_c, lane_r, chunk;
  bool active;
  __device__ __forceinline__ Place(int tc_log2, int chunks) {
    tc = 1 << tc_log2;
    tr = kThreads >> tc_log2;
    lane_c = threadIdx.x & (tc - 1);
    lane_r = threadIdx.x >> tc_log2;
    chunk = blockIdx.y * tc + lane_c;
    active = chunk < chunks;
  }
  __device__ __forceinline__ long long tile_rows() const { return (long long)tr * kUnroll; }
};

// The forward's pre-activation: (x - mean) * (gamma invstd) + beta, each
// step rounded as written, so the backward's mask is the forward's.
__device__ __forceinline__ float affine(float x, float mean, float scale, float shift) {
  return __fmaf_rn(__fsub_rn(x, mean), scale, shift);
}

__device__ __forceinline__ float relu(float v) { return v < 0.f ? 0.f : v; }  // NaN stays NaN

// Chan et al.'s merge of (nb, mb, qb) into (n, m, q): counts, means, M2.
template <int V>
__device__ __forceinline__ void chan_merge(float& n, float* m, float* q, float nb, const float* mb,
                                           const float* qb) {
  if (nb == 0.f) return;
  const float total = n + nb;
  const float wb = nb / total;
  const float cross = n * wb;
#pragma unroll
  for (int i = 0; i < V; ++i) {
    const float d = mb[i] - m[i];
    m[i] = fmaf(d, wb, m[i]);
    q[i] = q[i] + qb[i] + d * d * cross;
  }
  n = total;
}

// Merge the TR threads of each channel chunk into the one at lane_r 0: a
// tree over shared memory (`sa`, `sb`: V * kThreads floats, `sn`: kThreads).
// kWelford: (n, a, b) are Welford's; otherwise a and b are sums and n unused.
template <int V, bool kWelford>
__device__ __forceinline__ void block_merge(const Place& p, float& n, float* a, float* b, float* sn,
                                            float* sa, float* sb) {
  for (int stride = p.tr / 2; stride > 0; stride >>= 1) {
    if (p.lane_r >= stride && p.lane_r < 2 * stride) {
      sn[threadIdx.x] = n;
#pragma unroll
      for (int i = 0; i < V; ++i) {
        sa[i * kThreads + threadIdx.x] = a[i];
        sb[i * kThreads + threadIdx.x] = b[i];
      }
    }
    __syncthreads();
    if (p.lane_r < stride) {
      const int o = threadIdx.x + stride * p.tc;
      float ob[V], oq[V];
#pragma unroll
      for (int i = 0; i < V; ++i) {
        ob[i] = sa[i * kThreads + o];
        oq[i] = sb[i * kThreads + o];
      }
      if (kWelford) {
        chan_merge<V>(n, a, b, sn[o], ob, oq);
      } else {
#pragma unroll
        for (int i = 0; i < V; ++i) {
          a[i] += ob[i];
          b[i] += oq[i];
        }
      }
    }
    __syncthreads();
  }
}

// After a block has written its partial: whether it is the last block of
// its column to do so (then every partial of the column is visible to it).
__device__ __forceinline__ bool last_to_arrive(unsigned* arrivals, bool* flag) {
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) *flag = atomicAdd(arrivals + blockIdx.y, 1u) == gridDim.x - 1;
  __syncthreads();
  if (*flag) __threadfence();
  return *flag;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    bn_fwd_stats_kernel(const uint4* __restrict__ x, float* __restrict__ part, int rows,
                        int chunks, int tc_log2, float* __restrict__ mean_out,
                        float* __restrict__ invstd_out, float* __restrict__ running_mean,
                        float* __restrict__ running_var, long long* __restrict__ steps,
                        float momentum, float eps) {
  using P = Vec<T>;
  constexpr int V = P::N;
  __shared__ float sn[kThreads], sa[V * kThreads], sb[V * kThreads];
  __shared__ bool last;
  const Place p(tc_log2, chunks);
  const int C = chunks * V, blocks = gridDim.x;
  float n = 0.f, m[V], q[V];
#pragma unroll
  for (int i = 0; i < V; ++i) m[i] = q[i] = 0.f;
  if (p.active) {
    const long long tiles = (rows + p.tile_rows() - 1) / p.tile_rows();
    for (long long t = blockIdx.x; t < tiles; t += blocks) {
      const long long r0 = t * p.tile_rows() + p.lane_r;
      uint4 v[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const long long r = r0 + (long long)u * p.tr;
        if (r < rows) v[u] = __ldg(x + r * chunks + p.chunk);
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        if (r0 + (long long)u * p.tr >= rows) continue;
        float f[V];
        P::unpack(v[u], f);
        n += 1.f;
        const float inv = __frcp_rn(n);
#pragma unroll
        for (int i = 0; i < V; ++i) {
          const float d = f[i] - m[i];
          m[i] = fmaf(d, inv, m[i]);
          q[i] = fmaf(d, f[i] - m[i], q[i]);
        }
      }
    }
  }
  block_merge<V, true>(p, n, m, q, sn, sa, sb);
  float* pm = part;                              // [blocks][C] means
  float* pq = part + (size_t)blocks * C;         // [blocks][C] M2
  float* pn = part + 2 * (size_t)blocks * C;     // [columns][blocks] counts
  if (p.lane_r == 0 && p.active) {
#pragma unroll
    for (int i = 0; i < V; ++i) {
      pm[(size_t)blockIdx.x * C + p.chunk * V + i] = m[i];
      pq[(size_t)blockIdx.x * C + p.chunk * V + i] = q[i];
    }
  }
  if (threadIdx.x == 0) pn[(size_t)blockIdx.y * blocks + blockIdx.x] = n;
  if (!last_to_arrive(g_stats_arrivals, &last)) return;

  n = 0.f;
#pragma unroll
  for (int i = 0; i < V; ++i) m[i] = q[i] = 0.f;
  if (p.active) {
    for (int b0 = p.lane_r; b0 < blocks; b0 += p.tr * kUnroll) {
      float bn[kUnroll], bm[kUnroll][V], bq[kUnroll][V];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int b = b0 + u * p.tr;
        bn[u] = 0.f;
        if (b >= blocks) continue;
        bn[u] = __ldcg(pn + (size_t)blockIdx.y * blocks + b);
#pragma unroll
        for (int i = 0; i < V; ++i) {
          bm[u][i] = __ldcg(pm + (size_t)b * C + p.chunk * V + i);
          bq[u][i] = __ldcg(pq + (size_t)b * C + p.chunk * V + i);
        }
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) chan_merge<V>(n, m, q, bn[u], bm[u], bq[u]);
    }
  }
  block_merge<V, true>(p, n, m, q, sn, sa, sb);
  if (p.lane_r == 0 && p.active) {
#pragma unroll
    for (int i = 0; i < V; ++i) {
      const int c = p.chunk * V + i;
      const float var = q[i] / n;
      mean_out[c] = m[i];
      invstd_out[c] = 1.f / sqrtf(var + eps);
      if (running_mean != nullptr) {
        running_mean[c] = (1.f - momentum) * running_mean[c] + momentum * m[i];
        running_var[c] = (1.f - momentum) * running_var[c] + momentum * var;
      }
    }
  }
  if (threadIdx.x == 0) {
    g_stats_arrivals[blockIdx.y] = 0;
    if (steps != nullptr && blockIdx.y == 0) *steps += 1;
  }
}

// Per-channel constants of a thread's V channels.
template <int V>
__device__ __forceinline__ void load_affine(const Place& p, const float* mean, const float* invstd,
                                            const float* gamma, const float* beta, float* m,
                                            float* s, float* b) {
#pragma unroll
  for (int i = 0; i < V; ++i) {
    const int c = p.chunk * V + i;
    m[i] = mean[c];
    s[i] = __fmul_rn(gamma != nullptr ? gamma[c] : 1.f, invstd[c]);
    b[i] = beta != nullptr ? beta[c] : 0.f;
  }
}

template <typename T, bool kResidual, bool kRelu>
__global__ void __launch_bounds__(kThreads)
    bn_fwd_apply_kernel(const uint4* __restrict__ x, const uint4* __restrict__ res,
                        uint4* __restrict__ y, const float* __restrict__ mean,
                        const float* __restrict__ invstd, const float* __restrict__ gamma,
                        const float* __restrict__ beta, int rows, int chunks, int tc_log2) {
  using P = Vec<T>;
  constexpr int V = P::N;
  const Place p(tc_log2, chunks);
  if (!p.active) return;
  float m[V], s[V], b[V];
  load_affine<V>(p, mean, invstd, gamma, beta, m, s, b);
  const long long r0 = (long long)(gridDim.x - 1 - blockIdx.x) * p.tile_rows() + p.lane_r;
  uint4 xv[kUnroll], rv[kUnroll];
#pragma unroll
  for (int u = 0; u < kUnroll; ++u) {
    const long long r = r0 + (long long)u * p.tr;
    if (r >= rows) continue;
    xv[u] = __ldg(x + r * chunks + p.chunk);
    if (kResidual) rv[u] = __ldg(res + r * chunks + p.chunk);
  }
#pragma unroll
  for (int u = 0; u < kUnroll; ++u) {
    const long long r = r0 + (long long)u * p.tr;
    if (r >= rows) continue;
    float f[V], g[V];
    P::unpack(xv[u], f);
    if (kResidual) P::unpack(rv[u], g);
#pragma unroll
    for (int i = 0; i < V; ++i) {
      float v = affine(f[i], m[i], s[i], b[i]);
      if (kResidual) v = __fadd_rn(v, g[i]);
      f[i] = kRelu ? relu(v) : v;
    }
    y[r * chunks + p.chunk] = P::pack(f);
  }
}

// dy' of one 16-byte piece: dy where the ReLU passed its value, else 0.
template <typename T, int kMask, int V>
__device__ __forceinline__ void masked_grad(const uint4& dyv, const float* xf, const uint4& yv,
                                            const float* m, const float* s, const float* b,
                                            float* g) {
  Vec<T>::unpack(dyv, g);
  if (kMask == kMaskFromX) {
#pragma unroll
    for (int i = 0; i < V; ++i)
      if (!(affine(xf[i], m[i], s[i], b[i]) > 0.f)) g[i] = 0.f;
  } else if (kMask == kMaskFromY) {
    float yf[V];
    Vec<T>::unpack(yv, yf);
#pragma unroll
    for (int i = 0; i < V; ++i)
      if (!(yf[i] > 0.f)) g[i] = 0.f;
  }
}

template <typename T, int kMask>
__global__ void __launch_bounds__(kThreads)
    bn_bwd_reduce_kernel(const uint4* __restrict__ dy, const uint4* __restrict__ x,
                         const uint4* __restrict__ y, const float* __restrict__ mean,
                         const float* __restrict__ invstd, const float* __restrict__ gamma,
                         const float* __restrict__ beta, float* __restrict__ part, int rows,
                         int chunks, int tc_log2, float* __restrict__ sums,
                         float* __restrict__ dgamma, float* __restrict__ dbeta) {
  using P = Vec<T>;
  constexpr int V = P::N;
  __shared__ float sn[kThreads], sa[V * kThreads], sb[V * kThreads];
  __shared__ bool last;
  const Place p(tc_log2, chunks);
  const int C = chunks * V, blocks = gridDim.x;
  float s1[V], s2[V], unused = 0.f;
#pragma unroll
  for (int i = 0; i < V; ++i) s1[i] = s2[i] = 0.f;
  if (p.active) {
    float m[V], s[V], b[V];
    load_affine<V>(p, mean, invstd, gamma, beta, m, s, b);
    const long long tiles = (rows + p.tile_rows() - 1) / p.tile_rows();
    for (long long t = blockIdx.x; t < tiles; t += blocks) {
      const long long r0 = t * p.tile_rows() + p.lane_r;
      uint4 dv[kUnroll], xv[kUnroll], yv[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const long long r = r0 + (long long)u * p.tr;
        if (r >= rows) continue;
        dv[u] = __ldg(dy + r * chunks + p.chunk);
        xv[u] = __ldg(x + r * chunks + p.chunk);
        if (kMask == kMaskFromY) yv[u] = __ldg(y + r * chunks + p.chunk);
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        if (r0 + (long long)u * p.tr >= rows) continue;
        float xf[V], g[V];
        P::unpack(xv[u], xf);
        masked_grad<T, kMask, V>(dv[u], xf, yv[u], m, s, b, g);
#pragma unroll
        for (int i = 0; i < V; ++i) {
          s1[i] += g[i];
          s2[i] = fmaf(g[i], xf[i] - m[i], s2[i]);
        }
      }
    }
  }
  block_merge<V, false>(p, unused, s1, s2, sn, sa, sb);
  float* p1 = part;
  float* p2 = part + (size_t)blocks * C;
  if (p.lane_r == 0 && p.active) {
#pragma unroll
    for (int i = 0; i < V; ++i) {
      p1[(size_t)blockIdx.x * C + p.chunk * V + i] = s1[i];
      p2[(size_t)blockIdx.x * C + p.chunk * V + i] = s2[i];
    }
  }
  if (!last_to_arrive(g_reduce_arrivals, &last)) return;

#pragma unroll
  for (int i = 0; i < V; ++i) s1[i] = s2[i] = 0.f;
  if (p.active) {
#pragma unroll 4
    for (int b = p.lane_r; b < blocks; b += p.tr) {
#pragma unroll
      for (int i = 0; i < V; ++i) {
        s1[i] += __ldcg(p1 + (size_t)b * C + p.chunk * V + i);
        s2[i] += __ldcg(p2 + (size_t)b * C + p.chunk * V + i);
      }
    }
  }
  block_merge<V, false>(p, unused, s1, s2, sn, sa, sb);
  if (p.lane_r == 0 && p.active) {
#pragma unroll
    for (int i = 0; i < V; ++i) {
      const int c = p.chunk * V + i;
      sums[c] = s1[i];
      sums[C + c] = s2[i];
      if (dgamma != nullptr) {
        dgamma[c] = s2[i] * invstd[c];
        dbeta[c] = s1[i];
      }
    }
  }
  if (threadIdx.x == 0) g_reduce_arrivals[blockIdx.y] = 0;
}

template <typename T, int kMask, bool kDres>
__global__ void __launch_bounds__(kThreads)
    bn_bwd_elemt_kernel(const uint4* __restrict__ dy, const uint4* __restrict__ x,
                        const uint4* __restrict__ y, const float* __restrict__ mean,
                        const float* __restrict__ invstd, const float* __restrict__ gamma,
                        const float* __restrict__ beta, const float* __restrict__ sums,
                        uint4* __restrict__ dx, uint4* __restrict__ dres, int rows, int chunks,
                        int tc_log2) {
  using P = Vec<T>;
  constexpr int V = P::N;
  const Place p(tc_log2, chunks);
  if (!p.active) return;
  const int C = chunks * V;
  float m[V], s[V], b[V], k1[V], k2[V];
  load_affine<V>(p, mean, invstd, gamma, beta, m, s, b);
  const float inv_n = 1.f / (float)rows;
#pragma unroll
  for (int i = 0; i < V; ++i) {
    const int c = p.chunk * V + i;
    const float is = invstd[c];
    k1[i] = sums[c] * inv_n;
    k2[i] = sums[C + c] * inv_n * is * is;
  }
  const long long r0 = (long long)(gridDim.x - 1 - blockIdx.x) * p.tile_rows() + p.lane_r;
  uint4 dv[kUnroll], xv[kUnroll], yv[kUnroll];
#pragma unroll
  for (int u = 0; u < kUnroll; ++u) {
    const long long r = r0 + (long long)u * p.tr;
    if (r >= rows) continue;
    dv[u] = __ldg(dy + r * chunks + p.chunk);
    xv[u] = __ldg(x + r * chunks + p.chunk);
    if (kMask == kMaskFromY) yv[u] = __ldg(y + r * chunks + p.chunk);
  }
#pragma unroll
  for (int u = 0; u < kUnroll; ++u) {
    const long long r = r0 + (long long)u * p.tr;
    if (r >= rows) continue;
    float xf[V], g[V], o[V];
    P::unpack(xv[u], xf);
    masked_grad<T, kMask, V>(dv[u], xf, yv[u], m, s, b, g);
#pragma unroll
    for (int i = 0; i < V; ++i) o[i] = s[i] * (g[i] - k1[i] - (xf[i] - m[i]) * k2[i]);
    dx[r * chunks + p.chunk] = P::pack(o);
    if (kDres) dres[r * chunks + p.chunk] = P::pack(g);
  }
}

bool bad_plan(int rows, int chunks, int tc_log2, int columns, int blocks) {
  return rows < 1 || chunks < 1 || tc_log2 < 0 || tc_log2 > 5 || columns < 1 ||
         columns > kMaxColumns || ((long long)columns << tc_log2) < chunks || blocks < 1;
}

// The elementwise kernels' grid: one tile of TR * kUnroll rows a block.
unsigned tiles(int rows, int tc_log2) {
  const int tile_rows = (kThreads >> tc_log2) * kUnroll;
  return (unsigned)((rows + tile_rows - 1) / tile_rows);
}

template <typename T>
void launch_fwd(const void* x, const void* res, void* y, float* mean, float* invstd,
                const float* gamma, const float* beta, float* running_mean, float* running_var,
                long long* steps, float* part, int rows, int chunks, int tc_log2, int columns,
                int blocks, int relu, float momentum, float eps, cudaStream_t stream) {
  bn_fwd_stats_kernel<T><<<dim3(blocks, columns), kThreads, 0, stream>>>(
      (const uint4*)x, part, rows, chunks, tc_log2, mean, invstd, running_mean, running_var,
      steps, momentum, eps);
  const dim3 grid(tiles(rows, tc_log2), columns);
  const uint4 *xv = (const uint4*)x, *rv = (const uint4*)res;
  uint4* yv = (uint4*)y;
  if (res != nullptr && relu)
    bn_fwd_apply_kernel<T, true, true><<<grid, kThreads, 0, stream>>>(
        xv, rv, yv, mean, invstd, gamma, beta, rows, chunks, tc_log2);
  else if (res != nullptr)
    bn_fwd_apply_kernel<T, true, false><<<grid, kThreads, 0, stream>>>(
        xv, rv, yv, mean, invstd, gamma, beta, rows, chunks, tc_log2);
  else if (relu)
    bn_fwd_apply_kernel<T, false, true><<<grid, kThreads, 0, stream>>>(
        xv, rv, yv, mean, invstd, gamma, beta, rows, chunks, tc_log2);
  else
    bn_fwd_apply_kernel<T, false, false><<<grid, kThreads, 0, stream>>>(
        xv, rv, yv, mean, invstd, gamma, beta, rows, chunks, tc_log2);
}

template <typename T, int kMask>
void launch_bwd_masked(const void* dy, const void* x, const void* y, const float* mean,
                       const float* invstd, const float* gamma, const float* beta, float* sums,
                       float* dgamma, float* dbeta, void* dx, void* dres, float* part, int rows,
                       int chunks, int tc_log2, int columns, int blocks, cudaStream_t stream) {
  const uint4 *dv = (const uint4*)dy, *xv = (const uint4*)x, *yv = (const uint4*)y;
  bn_bwd_reduce_kernel<T, kMask><<<dim3(blocks, columns), kThreads, 0, stream>>>(
      dv, xv, yv, mean, invstd, gamma, beta, part, rows, chunks, tc_log2, sums, dgamma, dbeta);
  if (dx == nullptr) return;
  const dim3 grid(tiles(rows, tc_log2), columns);
  if (dres != nullptr)
    bn_bwd_elemt_kernel<T, kMask, true><<<grid, kThreads, 0, stream>>>(
        dv, xv, yv, mean, invstd, gamma, beta, sums, (uint4*)dx, (uint4*)dres, rows, chunks,
        tc_log2);
  else
    bn_bwd_elemt_kernel<T, kMask, false><<<grid, kThreads, 0, stream>>>(
        dv, xv, yv, mean, invstd, gamma, beta, sums, (uint4*)dx, nullptr, rows, chunks,
        tc_log2);
}

template <typename T>
void launch_bwd(int mask, const void* dy, const void* x, const void* y, const float* mean,
                const float* invstd, const float* gamma, const float* beta, float* sums,
                float* dgamma, float* dbeta, void* dx, void* dres, float* part, int rows,
                int chunks, int tc_log2, int columns, int blocks, cudaStream_t stream) {
  if (mask == kMaskFromY)
    launch_bwd_masked<T, kMaskFromY>(dy, x, y, mean, invstd, gamma, beta, sums, dgamma, dbeta,
                                     dx, dres, part, rows, chunks, tc_log2, columns, blocks,
                                     stream);
  else if (mask == kMaskFromX)
    launch_bwd_masked<T, kMaskFromX>(dy, x, y, mean, invstd, gamma, beta, sums, dgamma, dbeta,
                                     dx, dres, part, rows, chunks, tc_log2, columns, blocks,
                                     stream);
  else
    launch_bwd_masked<T, kMaskNone>(dy, x, y, mean, invstd, gamma, beta, sums, dgamma, dbeta,
                                    dx, nullptr, part, rows, chunks, tc_log2, columns, blocks,
                                    stream);
}

}  // namespace
}  // namespace sm3x

extern "C" {

// Both entry points take (rows, chunks) = (N H W, C / values in 16 bytes),
// the plan (tc_log2, columns, and the blocks a column of the reduction),
// `bf16` 1 for bfloat16 activations and 0 for float32, and return
// cudaGetLastError() after their launches. Null pointers: no residual, no
// gamma / beta (1 and 0), no running statistics or step count to move (the
// second forward of a recomputed block); in the backward no dx (the
// elementwise kernel is not launched), no d_res, no dgamma / dbeta.
// `part` is float32 scratch of 2 * blocks * C + columns * blocks floats
// (forward) or 2 * blocks * C (backward); `sums` 2 * C.

int sm3x_bn_fwd(const void* x, const void* residual, void* y, float* mean, float* invstd,
                const float* gamma, const float* beta, float* running_mean, float* running_var,
                long long* steps, float* part, int rows, int chunks, int tc_log2, int columns,
                int blocks, int bf16, int relu, float momentum, float eps, cudaStream_t stream) {
  using namespace sm3x;
  if (bad_plan(rows, chunks, tc_log2, columns, blocks)) return (int)cudaErrorInvalidValue;
  if (bf16)
    launch_fwd<__nv_bfloat16>(x, residual, y, mean, invstd, gamma, beta, running_mean,
                              running_var, steps, part, rows, chunks, tc_log2, columns, blocks,
                              relu, momentum, eps, stream);
  else
    launch_fwd<float>(x, residual, y, mean, invstd, gamma, beta, running_mean, running_var,
                      steps, part, rows, chunks, tc_log2, columns, blocks, relu, momentum, eps,
                      stream);
  return (int)cudaGetLastError();
}

// `mask`: 0 no ReLU, 1 the ReLU's mask recomputed from x, 2 read from y.
int sm3x_bn_bwd(const void* dy, const void* x, const void* y, const float* mean,
                const float* invstd, const float* gamma, const float* beta, float* sums,
                float* dgamma, float* dbeta, void* dx, void* dres, float* part, int rows,
                int chunks, int tc_log2, int columns, int blocks, int bf16, int mask,
                cudaStream_t stream) {
  using namespace sm3x;
  if (bad_plan(rows, chunks, tc_log2, columns, blocks) || mask < 0 || mask > 2 ||
      (mask == kMaskFromY && y == nullptr))
    return (int)cudaErrorInvalidValue;
  if (bf16)
    launch_bwd<__nv_bfloat16>(mask, dy, x, y, mean, invstd, gamma, beta, sums, dgamma, dbeta, dx,
                              dres, part, rows, chunks, tc_log2, columns, blocks, stream);
  else
    launch_bwd<float>(mask, dy, x, y, mean, invstd, gamma, beta, sums, dgamma, dbeta, dx, dres,
                      part, rows, chunks, tc_log2, columns, blocks, stream);
  return (int)cudaGetLastError();
}

}  // extern "C"
