// Flash-attention backward on the tensor cores, for bf16 inputs: K3b-dq and
// K3b-dkv. `dispatch` in flash_attention.cu sends bf16 here; float32 inputs
// stay on the FMA kernels there, which meet the float32 tolerances of the JAX
// package's tests.
//
// Replaces the TPU kernels `_flash_attention_bwd_dq`
// (jax/experimental/pallas/ops/tpu/flash_attention.py:1287, pallas_call
// :1456) and `_flash_attention_bwd_dkv` (:941, pallas_call :1121), with their
// arithmetic: bf16 operands and float32 accumulation. P and scale * dS are
// rounded to bf16 before the products that consume them, dV = P^T dO,
// dK = dS^T Q and dQ = dS K (:900, :918, :1258); S, the exponent, Delta, dP
// and every sum stay float32. The plain version is
// `attention_backward_plain(..., operand_dtype=torch.bfloat16)` in
// sm3x_torch/ops/attention.py.
//
// What bounds them on the H100. At ViT-B's (64, 197, 12, 64) the backward
// is about 19 GFLOP, which the bf16 tensor cores (989 TFLOP/s dense) finish
// in tens of microseconds, and moves about 155 MB (q, k, v, o, dO in, dq,
// dk, dv out, bf16), about 50 us at 3.35 TB/s. The FMA kernels before them
// were bound by float32 arithmetic on the CUDA cores. Here the limits are
// issue and latency: each warp runs `mma.sync` m16n8k16 and loads its own
// B operands with `ldmatrix`, and a 197-token sequence leaves part of the
// last 64-row tile idle. The design:
//   * a block of 4 warps takes one 64-row tile of one (b, h): query rows
//     for dq, key rows for dkv. Warp w owns rows 16 w .. 16 w + 15 and keeps
//     their Q and dO (dq) or K and V (dkv) as A fragments in registers for
//     the whole loop;
//   * the other side's 64-row tiles (K and V for dq; Q and dO with their lse
//     and Delta for dkv) stream through shared memory as bf16, in two
//     buffers filled by cp.async, 16 bytes a copy: the next tile arrives
//     while the current one computes. Rows are padded to 72 elements (144
//     bytes), so the 8 rows that one ldmatrix phase reads fall in distinct
//     banks;
//   * 16 columns at a time: S and dP (m16n8k16, float32 accumulators),
//     P = exp(S scale - lse) and dS = P (dP - Delta) scale, rounded to bf16
//     in registers. The accumulator layout of one m16n8k16 is the A layout
//     of the next, so P and dS go straight into dQ += dS K (dq) or
//     dV += P^T dO and dK += dS^T Q (dkv) without a trip through shared
//     memory; those B operands are read with ldmatrix .trans;
//   * the ragged tail: rows >= S are zero-filled by cp.async, a column >= S
//     (a key for dq, a query for dkv) gets P = 0, and 16-row slabs and 8-
//     column blocks that lie wholly beyond S are skipped. At S = 197 the last
//     tile costs one slab of one block, and the executed scores fall from
//     256^2 to 208 x 200 per (b, h). Rows >= S are not written;
//   * no atomics, so the same inputs give the same bits: a row of dQ is
//     summed by one warp over the key tiles in order, a row of dK and dV by
//     one warp over the query tiles in order. K3b-dq writes Delta =
//     rowsum(dO o O) and K3b-dkv reads it, launched after it on the same
//     stream.
// ptxas (CUDA 12.8, sm_90a): dq 128 registers, dkv 163, no spills; with
// 55.6 and 56.3 KB of dynamic shared memory that is 4 and 3 blocks (16 and
// 12 warps) an SM.
// cp.async and ldmatrix need 16-byte-aligned rows: the wrappers
// (sm3x_torch/ops/attention_cuda.py) raise for bf16 tensors whose data
// pointer or (b, s, h) strides are not. The cp.async, ldmatrix and mma.sync
// helpers are in flash_mma.cuh, shared with the forward kernel K3f.

#include "flash_mma.cuh"

namespace sm3x {

namespace {

using namespace mma;

struct Bwd {
  const bf16 *q, *k, *v, *o, *dout;
  bf16 *dq, *dk, *dv;
  const float* lse;
  float* delta;
  Strides sq, sk, sv, so, sdo, sg;  // sg: the gradients' layout
  int H, S;
  float scale;
};

// K3b-dq: one block per (b, h, 64 query rows), looping over key tiles
__global__ void __launch_bounds__(kThreads) bwd_dq_kernel(Bwd a) {
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* Qs = reinterpret_cast<bf16*>(smem);
  bf16* dOs = Qs + kTileElems;
  bf16* KVs = dOs + kTileElems;  // buffer i: K at KVs + 2 i kTileElems, V after it
  float* Ds = reinterpret_cast<float*>(KVs + 4 * kTileElems);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int bh = blockIdx.x, b = bh / a.H, h = bh % a.H;
  const int q0 = blockIdx.y * kTile, S = a.S;
  const bf16* kbase = a.k + b * a.sk.b + h * a.sk.h;
  const bf16* vbase = a.v + b * a.sv.b + h * a.sv.h;
  const bf16* dobase = a.dout + b * a.sdo.b + h * a.sdo.h;

  load_tile(Qs, a.q + b * a.sq.b + h * a.sq.h, a.sq.s, q0, S);
  load_tile(dOs, dobase, a.sdo.s, q0, S);
  load_tile(KVs, kbase, a.sk.s, 0, S);
  load_tile(KVs + kTileElems, vbase, a.sv.s, 0, S);
  cp_async_commit();

  {
    // Delta = rowsum(dO o O) in float32 while the copies fly: two threads
    // a row, 32 columns (4 loads of 16 bytes) each
    const int r = threadIdx.x >> 1, half = threadIdx.x & 1;
    const int row = q0 + r;
    float acc = 0.f;
    if (row < S) {
      const uint4* o4 = reinterpret_cast<const uint4*>(a.o + b * a.so.b + row * a.so.s +
                                                       h * a.so.h + 32 * half);
      const uint4* d4 = reinterpret_cast<const uint4*>(dobase + row * a.sdo.s + 32 * half);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const uint4 x = o4[i], y = d4[i];
        const __nv_bfloat162* xo = reinterpret_cast<const __nv_bfloat162*>(&x);
        const __nv_bfloat162* yd = reinterpret_cast<const __nv_bfloat162*>(&y);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float2 fo = __bfloat1622float2(xo[e]), fd = __bfloat1622float2(yd[e]);
          acc = fmaf(fd.x, fo.x, acc);
          acc = fmaf(fd.y, fo.y, acc);
        }
      }
    }
    acc += __shfl_xor_sync(0xffffffffu, acc, 1);
    if (half == 0) {
      Ds[r] = acc;
      if (row < S) a.delta[(long long)bh * S + row] = acc;
    }
  }

  const int g = lane >> 2, c2 = (lane & 3) * 2;
  const int r0 = warp * 16;  // the warp's rows in the tile
  const bool active = q0 + r0 < S;
  float lse_r[2], delta_r[2] = {0.f, 0.f};
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = q0 + r0 + g + 8 * i;
    lse_r[i] = row < S ? a.lse[(long long)bh * S + row] : 0.f;
  }
  uint32_t qa[4][4], da[4][4];
  float dq[8][4];
  zero(dq);

  const int nkt = (S + kTile - 1) / kTile;
  for (int it = 0; it < nkt; ++it) {
    const int k0 = it * kTile;
    const bf16* Ks = KVs + (it & 1) * 2 * kTileElems;
    const bf16* Vs = Ks + kTileElems;
    if (it + 1 < nkt) {
      bf16* next = KVs + ((it + 1) & 1) * 2 * kTileElems;
      load_tile(next, kbase, a.sk.s, k0 + kTile, S);
      load_tile(next + kTileElems, vbase, a.sv.s, k0 + kTile, S);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    if (active) {
      if (it == 0) {
        load_a(qa, Qs, r0, lane);
        load_a(da, dOs, r0, lane);
        delta_r[0] = Ds[r0 + g];
        delta_r[1] = Ds[r0 + g + 8];
      }
#pragma unroll
      for (int n0 = 0; n0 < kTile; n0 += 16) {
        if (k0 + n0 >= S) break;
        const bool two = k0 + n0 + 8 < S;
        float s[2][4], dp[2][4];
        gemm_abt(s, qa, Ks, n0, two, lane);
        gemm_abt(dp, da, Vs, n0, two, lane);
#pragma unroll
        for (int hb = 0; hb < 2; ++hb)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int key = k0 + n0 + 8 * hb + c2 + (e & 1), i = e >> 1;
            const float p = key < S ? expf(s[hb][e] * a.scale - lse_r[i]) : 0.f;
            s[hb][e] = p * (dp[hb][e] - delta_r[i]) * a.scale;  // dS
          }
        uint32_t dsa[4];
        pack_a(dsa, s);
        gemm_ab(dq, dsa, Ks, n0, lane);
      }
    }
    __syncthreads();  // the buffer is refilled next iteration
  }
  if (active) store_slab(a.dq + b * a.sg.b + h * a.sg.h, a.sg.s, q0 + r0, S, dq, lane);
}

// K3b-dkv: one block per (b, h, 64 key rows), looping over query tiles;
// scores transposed (rows are keys, columns queries)
__global__ void __launch_bounds__(kThreads) bwd_dkv_kernel(Bwd a) {
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* Ks = reinterpret_cast<bf16*>(smem);
  bf16* Vs = Ks + kTileElems;
  bf16* QDs = Vs + kTileElems;  // buffer i: Q at QDs + 2 i kTileElems, dO after it
  float* stats = reinterpret_cast<float*>(QDs + 4 * kTileElems);  // buffer i: lse, Delta
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int bh = blockIdx.x, b = bh / a.H, h = bh % a.H;
  const int k0 = blockIdx.y * kTile, S = a.S;
  const bf16* qbase = a.q + b * a.sq.b + h * a.sq.h;
  const bf16* dobase = a.dout + b * a.sdo.b + h * a.sdo.h;
  const float* lse = a.lse + (long long)bh * S;
  const float* delta = a.delta + (long long)bh * S;

  load_tile(Ks, a.k + b * a.sk.b + h * a.sk.h, a.sk.s, k0, S);
  load_tile(Vs, a.v + b * a.sv.b + h * a.sv.h, a.sv.s, k0, S);
  load_tile(QDs, qbase, a.sq.s, 0, S);
  load_tile(QDs + kTileElems, dobase, a.sdo.s, 0, S);
  load_rowstats(stats, stats + kTile, lse, delta, 0, S);
  cp_async_commit();

  const int c2 = (lane & 3) * 2;
  const int r0 = warp * 16;  // the warp's key rows in the tile
  const bool active = k0 + r0 < S;
  uint32_t ka[4][4], va[4][4];
  float dk[8][4], dv[8][4];
  zero(dk);
  zero(dv);

  const int nqt = (S + kTile - 1) / kTile;
  for (int it = 0; it < nqt; ++it) {
    const int q0 = it * kTile;
    const bf16* Qs = QDs + (it & 1) * 2 * kTileElems;
    const bf16* dOs = Qs + kTileElems;
    const float* Ls = stats + (it & 1) * 2 * kTile;
    const float* Ds = Ls + kTile;
    if (it + 1 < nqt) {
      const int nb = (it + 1) & 1;
      bf16* next = QDs + nb * 2 * kTileElems;
      float* nstats = stats + nb * 2 * kTile;
      load_tile(next, qbase, a.sq.s, q0 + kTile, S);
      load_tile(next + kTileElems, dobase, a.sdo.s, q0 + kTile, S);
      load_rowstats(nstats, nstats + kTile, lse, delta, q0 + kTile, S);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    if (active) {
      if (it == 0) {
        load_a(ka, Ks, r0, lane);
        load_a(va, Vs, r0, lane);
      }
#pragma unroll
      for (int n0 = 0; n0 < kTile; n0 += 16) {
        if (q0 + n0 >= S) break;
        const bool two = q0 + n0 + 8 < S;
        float st[2][4], dpt[2][4];
        gemm_abt(st, ka, Qs, n0, two, lane);
        gemm_abt(dpt, va, dOs, n0, two, lane);
#pragma unroll
        for (int hb = 0; hb < 2; ++hb) {
          const int col = n0 + 8 * hb + c2;
          const float2 l = *reinterpret_cast<const float2*>(Ls + col);
          const float2 d = *reinterpret_cast<const float2*>(Ds + col);
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const bool odd = e & 1;
            const float p = q0 + col + odd < S
                                ? expf(st[hb][e] * a.scale - (odd ? l.y : l.x))
                                : 0.f;
            st[hb][e] = p;                                               // P^T
            dpt[hb][e] = p * (dpt[hb][e] - (odd ? d.y : d.x)) * a.scale;  // dS^T
          }
        }
        uint32_t pa[4], dsa[4];
        pack_a(pa, st);
        pack_a(dsa, dpt);
        gemm_ab(dv, pa, dOs, n0, lane);
        gemm_ab(dk, dsa, Qs, n0, lane);
      }
    }
    __syncthreads();  // the buffer is refilled next iteration
  }
  if (active) {
    store_slab(a.dk + b * a.sg.b + h * a.sg.h, a.sg.s, k0 + r0, S, dk, lane);
    store_slab(a.dv + b * a.sg.b + h * a.sg.h, a.sg.s, k0 + r0, S, dv, lane);
  }
}

constexpr size_t kDqSmem = 6 * kTileElems * sizeof(bf16) + kTile * sizeof(float);
constexpr size_t kDkvSmem = 6 * kTileElems * sizeof(bf16) + 4 * kTile * sizeof(float);

}  // namespace

// which: 1 K3b-dq, 2 K3b-dkv; ptrs and strides as for sm3x_flash_bwd_dq /
// sm3x_flash_bwd_dkv in flash_attention.cu. Returns cudaGetLastError().
int flash_bwd_mma(int which, const void* const* ptrs, const long long* strides, int B, int S,
                  int H, float scale, cudaStream_t stream) {
  Bwd a{};
  a.q = static_cast<const bf16*>(ptrs[0]);
  a.k = static_cast<const bf16*>(ptrs[1]);
  a.v = static_cast<const bf16*>(ptrs[2]);
  a.o = static_cast<const bf16*>(ptrs[3]);
  a.dout = static_cast<const bf16*>(ptrs[4]);
  a.lse = static_cast<const float*>(ptrs[5]);
  a.delta = static_cast<float*>(const_cast<void*>(ptrs[6]));
  a.sq = strides_at(strides, 0);
  a.sk = strides_at(strides, 1);
  a.sv = strides_at(strides, 2);
  a.so = strides_at(strides, 3);
  a.sdo = strides_at(strides, 4);
  a.sg = strides_at(strides, 5);
  a.H = H;
  a.S = S;
  a.scale = scale;
  const dim3 grid(B * H, (S + kTile - 1) / kTile);
  if (which == 1) {
    a.dq = static_cast<bf16*>(const_cast<void*>(ptrs[7]));
    cudaFuncSetAttribute(bwd_dq_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kDqSmem);
    bwd_dq_kernel<<<grid, kThreads, kDqSmem, stream>>>(a);
  } else {
    a.dk = static_cast<bf16*>(const_cast<void*>(ptrs[7]));
    a.dv = static_cast<bf16*>(const_cast<void*>(ptrs[8]));
    cudaFuncSetAttribute(bwd_dkv_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kDkvSmem);
    bwd_dkv_kernel<<<grid, kThreads, kDkvSmem, stream>>>(a);
  }
  return (int)cudaGetLastError();
}

}  // namespace sm3x
