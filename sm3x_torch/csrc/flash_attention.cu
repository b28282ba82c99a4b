// Flash attention for Hopper: forward K3f, backward K3b-dq and K3b-dkv.
//
// Replaces the TPU flash attention that sm3x/models/vit.py:61-87
// (`_flash_attention_fn`) calls from JAX's Pallas library
// (jax/experimental/pallas/ops/tpu/flash_attention.py: `_flash_attention_impl`
// :589, `_flash_attention_bwd_dkv` :941, `_flash_attention_bwd_dq` :1287).
// The TPU wrapper transposed (B, S, H, D) to (B, H, S, D) and padded S = 197
// to 256 with segment ids; here the kernels read (B, S, H, D) through its
// strides and mask the ragged tail themselves: a key index >= S scores -inf
// (its probability is 0) and a query row >= S is never written.
//
// softmax(Q K^T * scale) V with the per-row logsumexp saved for the
// backward, D = 64 (the head width of every ViT of the repo), float32 or
// bf16 in, output in the input type. The kernels of this file take float32
// and compute in float32 throughout; bf16 inputs run on the tensor cores
// instead, the forward in flash_attention_fwd_mma.cu and the backward in
// flash_attention_bwd_mma.cu (`dispatch` below).
//
// What bounds them on the H100: arithmetic. At ViT-B's (64, 197, 12, 64)
// the forward is 2 * 64 * 12 * 197^2 * 64 = 3.8e9 multiply-adds over 116 MB
// of float32 q/k/v/o, and the backward 2.5 times that. These kernels run on
// the CUDA cores (FMA, float32), so that float32 inputs meet the float32
// tolerances of the JAX package's tests. The design:
//   * 64 x 64 tiles of q, k, v (and dO) are staged in shared memory as
//     float32, rows padded to 68 floats so that the 16-byte reads below are
//     free of bank conflicts;
//   * a block of 256 threads is a 16 x 16 grid; thread (ty, tx) owns the
//     4 x 4 scores of rows ty + 16 i and columns tx + 16 j, and 4 x 4
//     outputs of rows ty + 16 i and columns 4 tx .. 4 tx + 3. A row's max
//     and sum are reduced over the 16 lanes that share ty by shuffles;
//   * the forward keeps an online max and sum per row (one block per
//     (b, h, query tile), looping over key tiles), so the S x S scores
//     never reach device memory;
//   * the float32 backward recomputes P = exp(S * scale - lse) tile by tile
//     and uses no float atomics, so its results do not change from run to run:
//     K3b-dq takes one block per (b, h, query tile) and loops over key
//     tiles; it also computes Delta = rowsum(dO o O) for its rows and
//     stores it. K3b-dkv, launched after it, takes one block per
//     (b, h, key tile), loops over query tiles and reads Delta.
//     dS = P o (dP - Delta); dQ = scale dS K, dK = scale dS^T Q, dV = P^T dO.

#include <cuda_runtime.h>
#include <math.h>

namespace sm3x {
// K3f for bf16 on the tensor cores, flash_attention_fwd_mma.cu
int flash_fwd_mma(const void* const* ptrs, const long long* strides, int B, int S, int H,
                  float scale, cudaStream_t stream);
// K3b-dq (which 1) and K3b-dkv (which 2) for bf16 on the tensor cores,
// flash_attention_bwd_mma.cu
int flash_bwd_mma(int which, const void* const* ptrs, const long long* strides, int B, int S,
                  int H, float scale, cudaStream_t stream);
}  // namespace sm3x

namespace {

constexpr int kD = 64;                      // head dim
constexpr int kTile = 64;                   // query and key rows per tile
constexpr int kStride = kD + 4;             // shared row stride, floats
constexpr int kTileFloats = kTile * kStride;
constexpr int kThreads = 256;

struct Strides {  // in elements; the head dim is contiguous
  long long b, s, h;
};

struct Attn {
  const float *q, *k, *v, *o, *dout;
  float *out, *dq, *dk, *dv;
  const float* lse_in;
  float *lse, *delta;
  Strides sq, sk, sv, so, sdo, sout;
  int H, S;
  float scale;
};

__device__ __forceinline__ float group16_max(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float group16_sum(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// rows row0 .. row0 + 63 of one (b, h) slice into shared memory as float32;
// rows >= S are zero
__device__ __forceinline__ void load_tile(float* __restrict__ dst,
                                          const float* __restrict__ src, Strides st,
                                          int b, int h, int row0, int S) {
  const float* base = src + b * st.b + h * st.h;
  for (int idx = threadIdx.x; idx < kTile * kD; idx += kThreads) {
    const int r = idx / kD, c = idx % kD;
    const int row = row0 + r;
    dst[r * kStride + c] = row < S ? base[row * st.s + c] : 0.f;
  }
}

// acc[i][j] = A[ty + 16 i] . B[tx + 16 j] over the head dim
__device__ __forceinline__ void tile_dot(const float* __restrict__ A,
                                         const float* __restrict__ B, int ty,
                                         int tx, float (&acc)[4][4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
#pragma unroll 4
  for (int d = 0; d < kD; d += 4) {
    float4 a[4], b[4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      a[i] = *reinterpret_cast<const float4*>(A + (ty + 16 * i) * kStride + d);
#pragma unroll
    for (int j = 0; j < 4; ++j)
      b[j] = *reinterpret_cast<const float4*>(B + (tx + 16 * j) * kStride + d);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        float s = acc[i][j];
        s = fmaf(a[i].x, b[j].x, s);
        s = fmaf(a[i].y, b[j].y, s);
        s = fmaf(a[i].z, b[j].z, s);
        s = fmaf(a[i].w, b[j].w, s);
        acc[i][j] = s;
      }
  }
}

// acc[i][c] += sum_k P[ty + 16 i][k] * V[k][4 tx + c]: P is (rows, keys) and
// V (keys, head dim), both with row stride kStride
__device__ __forceinline__ void tile_pv(const float* __restrict__ P,
                                        const float* __restrict__ V, int ty,
                                        int tx, float (&acc)[4][4]) {
#pragma unroll 2
  for (int k = 0; k < kTile; k += 4) {
    float4 p[4], v[4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      p[i] = *reinterpret_cast<const float4*>(P + (ty + 16 * i) * kStride + k);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      v[kk] = *reinterpret_cast<const float4*>(V + (k + kk) * kStride + 4 * tx);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float pk[4] = {p[i].x, p[i].y, p[i].z, p[i].w};
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        acc[i][0] = fmaf(pk[kk], v[kk].x, acc[i][0]);
        acc[i][1] = fmaf(pk[kk], v[kk].y, acc[i][1]);
        acc[i][2] = fmaf(pk[kk], v[kk].z, acc[i][2]);
        acc[i][3] = fmaf(pk[kk], v[kk].w, acc[i][3]);
      }
    }
  }
}

// a 4 x 4 tile of rows ty + 16 i, columns 4 tx .. 4 tx + 3, scaled, to the
// rows < S of a (B, S, H, D) tensor
__device__ __forceinline__ void store_rows(float* __restrict__ dst, Strides st,
                                           int b, int h, int row0, int S,
                                           int ty, int tx, float scale,
                                           const float (&acc)[4][4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = row0 + ty + 16 * i;
    if (row >= S) continue;
    float* p = dst + b * st.b + row * st.s + h * st.h + 4 * tx;
#pragma unroll
    for (int c = 0; c < 4; ++c) p[c] = acc[i][c] * scale;
  }
}

__global__ void __launch_bounds__(kThreads, 2) flash_fwd_kernel(Attn a) {
  extern __shared__ float4 smem4[];
  float* Qs = reinterpret_cast<float*>(smem4);
  float* Ks = Qs + kTileFloats;
  float* Vs = Ks + kTileFloats;
  float* Ps = Vs + kTileFloats;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int bh = blockIdx.x, b = bh / a.H, h = bh % a.H;
  const int q0 = blockIdx.y * kTile;
  const int S = a.S;

  load_tile(Qs, a.q, a.sq, b, h, q0, S);
  float m[4], l[4], o[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < 4; ++c) o[i][c] = 0.f;
  }

  for (int k0 = 0; k0 < S; k0 += kTile) {
    __syncthreads();  // the previous tile's readers are done
    load_tile(Ks, a.k, a.sk, b, h, k0, S);
    load_tile(Vs, a.v, a.sv, b, h, k0, S);
    __syncthreads();
    float s[4][4];
    tile_dot(Qs, Ks, ty, tx, s);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = k0 + tx + 16 * j < S ? s[i][j] * a.scale : -INFINITY;
        mx = fmaxf(mx, s[i][j]);
      }
      // key k0 < S is in every tile, so the new max is finite
      const float m_new = fmaxf(m[i], group16_max(mx));
      const float alpha = expf(m[i] - m_new);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = expf(s[i][j] - m_new);
        rs += s[i][j];
      }
      l[i] = l[i] * alpha + group16_sum(rs);
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < 4; ++c) o[i][c] *= alpha;
#pragma unroll
      for (int j = 0; j < 4; ++j) Ps[(ty + 16 * i) * kStride + tx + 16 * j] = s[i][j];
    }
    __syncthreads();
    tile_pv(Ps, Vs, ty, tx, o);
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty + 16 * i;
    if (row >= S) continue;
    const float inv = 1.f / l[i];
    float* p = a.out + b * a.sout.b + row * a.sout.s + h * a.sout.h + 4 * tx;
#pragma unroll
    for (int c = 0; c < 4; ++c) p[c] = o[i][c] * inv;
    if (tx == 0) a.lse[(long long)bh * S + row] = m[i] + logf(l[i]);
  }
}

__global__ void __launch_bounds__(kThreads, 2) flash_bwd_dq_kernel(Attn a) {
  extern __shared__ float4 smem4[];
  float* Qs = reinterpret_cast<float*>(smem4);
  float* dOs = Qs + kTileFloats;
  float* Ks = dOs + kTileFloats;
  float* Vs = Ks + kTileFloats;
  float* dSs = Vs + kTileFloats;
  float* Ls = dSs + kTileFloats;
  float* Ds = Ls + kTile;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int bh = blockIdx.x, b = bh / a.H, h = bh % a.H;
  const int q0 = blockIdx.y * kTile;
  const int S = a.S;

  load_tile(Qs, a.q, a.sq, b, h, q0, S);
  load_tile(dOs, a.dout, a.sdo, b, h, q0, S);
  __syncthreads();
  {
    // Delta = rowsum(dO o O): four lanes a row, 16 columns each
    const int r = threadIdx.x >> 2, part = threadIdx.x & 3;
    const int row = q0 + r;
    float acc = 0.f;
    if (row < S) {
      const float* orow = a.o + b * a.so.b + row * a.so.s + h * a.so.h + 16 * part;
      const float* drow = dOs + r * kStride + 16 * part;
#pragma unroll
      for (int c = 0; c < 16; ++c) acc = fmaf(drow[c], orow[c], acc);
    }
    acc += __shfl_xor_sync(0xffffffffu, acc, 1);
    acc += __shfl_xor_sync(0xffffffffu, acc, 2);
    if (part == 0) {
      Ds[r] = acc;
      Ls[r] = row < S ? a.lse_in[(long long)bh * S + row] : 0.f;
      if (row < S) a.delta[(long long)bh * S + row] = acc;
    }
  }
  __syncthreads();
  float lse_r[4], delta_r[4], dq[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    lse_r[i] = Ls[ty + 16 * i];
    delta_r[i] = Ds[ty + 16 * i];
#pragma unroll
    for (int c = 0; c < 4; ++c) dq[i][c] = 0.f;
  }

  for (int k0 = 0; k0 < S; k0 += kTile) {
    __syncthreads();
    load_tile(Ks, a.k, a.sk, b, h, k0, S);
    load_tile(Vs, a.v, a.sv, b, h, k0, S);
    __syncthreads();
    float s[4][4], dp[4][4];
    tile_dot(Qs, Ks, ty, tx, s);
    tile_dot(dOs, Vs, ty, tx, dp);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p =
            k0 + tx + 16 * j < S ? expf(s[i][j] * a.scale - lse_r[i]) : 0.f;
        dSs[(ty + 16 * i) * kStride + tx + 16 * j] = p * (dp[i][j] - delta_r[i]);
      }
    __syncthreads();
    tile_pv(dSs, Ks, ty, tx, dq);
  }
  store_rows(a.dq, a.sout, b, h, q0, S, ty, tx, a.scale, dq);
}

__global__ void __launch_bounds__(kThreads, 2) flash_bwd_dkv_kernel(Attn a) {
  extern __shared__ float4 smem4[];
  float* Ks = reinterpret_cast<float*>(smem4);
  float* Vs = Ks + kTileFloats;
  float* Qs = Vs + kTileFloats;
  float* dOs = Qs + kTileFloats;
  float* Ps = dOs + kTileFloats;
  float* dSs = Ps + kTileFloats;
  float* Ls = dSs + kTileFloats;
  float* Ds = Ls + kTile;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int bh = blockIdx.x, b = bh / a.H, h = bh % a.H;
  const int k0 = blockIdx.y * kTile;
  const int S = a.S;

  load_tile(Ks, a.k, a.sk, b, h, k0, S);
  load_tile(Vs, a.v, a.sv, b, h, k0, S);
  float dk[4][4], dv[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < 4; ++c) dk[i][c] = dv[i][c] = 0.f;

  for (int q0 = 0; q0 < S; q0 += kTile) {
    __syncthreads();
    load_tile(Qs, a.q, a.sq, b, h, q0, S);
    load_tile(dOs, a.dout, a.sdo, b, h, q0, S);
    if (threadIdx.x < kTile) {
      const int row = q0 + threadIdx.x;
      Ls[threadIdx.x] = row < S ? a.lse_in[(long long)bh * S + row] : 0.f;
      Ds[threadIdx.x] = row < S ? a.delta[(long long)bh * S + row] : 0.f;
    }
    __syncthreads();
    // transposed scores: rows are this block's keys, columns the queries
    float st[4][4], dpt[4][4];
    tile_dot(Ks, Qs, ty, tx, st);
    tile_dot(Vs, dOs, ty, tx, dpt);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = tx + 16 * j;
      const bool valid = q0 + col < S;
      const float lq = Ls[col], dq = Ds[col];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float p = valid ? expf(st[i][j] * a.scale - lq) : 0.f;
        Ps[(ty + 16 * i) * kStride + col] = p;
        dSs[(ty + 16 * i) * kStride + col] = p * (dpt[i][j] - dq);
      }
    }
    __syncthreads();
    tile_pv(Ps, dOs, ty, tx, dv);
    tile_pv(dSs, Qs, ty, tx, dk);
  }
  store_rows(a.dk, a.sout, b, h, k0, S, ty, tx, a.scale, dk);
  store_rows(a.dv, a.sout, b, h, k0, S, ty, tx, 1.f, dv);
}

constexpr size_t kFwdSmem = 4 * kTileFloats * sizeof(float);
constexpr size_t kDqSmem = (5 * kTileFloats + 2 * kTile) * sizeof(float);
constexpr size_t kDkvSmem = (6 * kTileFloats + 2 * kTile) * sizeof(float);

Strides strides_at(const long long* s, int i) { return {s[3 * i], s[3 * i + 1], s[3 * i + 2]}; }

// the float32 kernels: which 0 K3f, 1 K3b-dq, 2 K3b-dkv
int launch(int which, const void* const* ptrs, const long long* strides,
           int B, int S, int H, float scale, cudaStream_t stream) {
  Attn a{};
  a.H = H;
  a.S = S;
  a.scale = scale;
  dim3 grid(B * H, (S + kTile - 1) / kTile);
  if (which == 0) {  // q, k, v, out, lse
    a.q = static_cast<const float*>(ptrs[0]);
    a.k = static_cast<const float*>(ptrs[1]);
    a.v = static_cast<const float*>(ptrs[2]);
    a.out = static_cast<float*>(const_cast<void*>(ptrs[3]));
    a.lse = static_cast<float*>(const_cast<void*>(ptrs[4]));
    a.sq = strides_at(strides, 0);
    a.sk = strides_at(strides, 1);
    a.sv = strides_at(strides, 2);
    a.sout = strides_at(strides, 3);
    cudaFuncSetAttribute(flash_fwd_kernel,
                         cudaFuncAttributeMaxDynamicSharedMemorySize, kFwdSmem);
    flash_fwd_kernel<<<grid, kThreads, kFwdSmem, stream>>>(a);
  } else {
    // q, k, v, o, dout, lse, delta, grad (dq) or grads (dk, dv)
    a.q = static_cast<const float*>(ptrs[0]);
    a.k = static_cast<const float*>(ptrs[1]);
    a.v = static_cast<const float*>(ptrs[2]);
    a.o = static_cast<const float*>(ptrs[3]);
    a.dout = static_cast<const float*>(ptrs[4]);
    a.lse_in = static_cast<const float*>(ptrs[5]);
    a.delta = static_cast<float*>(const_cast<void*>(ptrs[6]));
    a.sq = strides_at(strides, 0);
    a.sk = strides_at(strides, 1);
    a.sv = strides_at(strides, 2);
    a.so = strides_at(strides, 3);
    a.sdo = strides_at(strides, 4);
    a.sout = strides_at(strides, 5);
    if (which == 1) {
      a.dq = static_cast<float*>(const_cast<void*>(ptrs[7]));
      cudaFuncSetAttribute(flash_bwd_dq_kernel,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, kDqSmem);
      flash_bwd_dq_kernel<<<grid, kThreads, kDqSmem, stream>>>(a);
    } else {
      a.dk = static_cast<float*>(const_cast<void*>(ptrs[7]));
      a.dv = static_cast<float*>(const_cast<void*>(ptrs[8]));
      cudaFuncSetAttribute(flash_bwd_dkv_kernel,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, kDkvSmem);
      flash_bwd_dkv_kernel<<<grid, kThreads, kDkvSmem, stream>>>(a);
    }
  }
  return (int)cudaGetLastError();
}

int dispatch(int which, const void* const* ptrs, const long long* strides, int B,
             int S, int H, int D, float scale, int bf16, cudaStream_t stream) {
  if (D != kD || B < 1 || S < 1 || H < 1) return (int)cudaErrorInvalidValue;
  if (!bf16) return launch(which, ptrs, strides, B, S, H, scale, stream);
  if (which == 0) return sm3x::flash_fwd_mma(ptrs, strides, B, S, H, scale, stream);
  return sm3x::flash_bwd_mma(which, ptrs, strides, B, S, H, scale, stream);
}

}  // namespace

extern "C" {

// K3f. ptrs: q, k, v, out (B, S, H, D) and lse (B, H, S) float32; strides:
// (b, s, h) in elements for q, k, v, out (host array of 12). bf16: 0 for
// float32 tensors (the FMA kernel above), 1 for bfloat16 (the tensor-core
// kernel, 16-byte-aligned rows). Returns cudaGetLastError().
int sm3x_flash_fwd(const void* const* ptrs, const long long* strides, int B,
                   int S, int H, int D, float scale, int bf16,
                   cudaStream_t stream) {
  return dispatch(0, ptrs, strides, B, S, H, D, scale, bf16, stream);
}

// K3b-dq. ptrs: q, k, v, o, dout, lse, delta (out, (B, H, S) float32), dq;
// strides: q, k, v, o, dout, dq (host array of 18). float32 runs the FMA
// kernel above, bf16 the tensor-core one (16-byte-aligned rows).
int sm3x_flash_bwd_dq(const void* const* ptrs, const long long* strides, int B,
                      int S, int H, int D, float scale, int bf16,
                      cudaStream_t stream) {
  return dispatch(1, ptrs, strides, B, S, H, D, scale, bf16, stream);
}

// K3b-dkv, after K3b-dq on the same stream. ptrs: q, k, v, o (unused), dout,
// lse, delta (from K3b-dq), dk, dv; strides: q, k, v, o, dout, and dk / dv,
// which share one layout (host array of 18). float32 and bf16 as for dq.
int sm3x_flash_bwd_dkv(const void* const* ptrs, const long long* strides, int B,
                       int S, int H, int D, float scale, int bf16,
                       cudaStream_t stream) {
  return dispatch(2, ptrs, strides, B, S, H, D, scale, bf16, stream);
}

}  // extern "C"
