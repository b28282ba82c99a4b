// Flash-attention forward on the tensor cores, for bf16 inputs: K3f.
// `dispatch` in flash_attention.cu sends the bf16 forward here; float32
// inputs stay on the FMA kernel there, which meets the float32 tolerances of
// the JAX package's tests.
//
// Replaces the TPU kernel `_flash_attention_impl`
// (jax/experimental/pallas/ops/tpu/flash_attention.py:589, pallas_call :758,
// body `_flash_attention_kernel_single_batch` :341; reached from
// sm3x/models/vit.py:85), with its arithmetic: bf16 operands and float32
// accumulation; S, the running max, the exponent, the row sum l and the
// logsumexp stay float32, and P = exp(S scale - m), relative to the running
// max of its key block, is rounded to bf16 before P V (:396, :471) while l
// sums the unrounded P. The plain version is
// `attention_plain(..., operand_dtype=torch.bfloat16, block_k=64)` in
// sm3x_torch/ops/attention.py.
//
// What bounds it on the H100. At ViT-B's (64, 197, 12, 64) the forward is
// 7.6 GFLOP, 8 us of the bf16 tensor cores (989 TFLOP/s dense), and moves
// 78 MB (q, k, v in, out and lse out), 23 us at 3.35 TB/s: bytes. The FMA
// kernel before it was bound by float32 arithmetic on the CUDA cores
// (0.62 ms). Here, as for K3b, the limits are instruction rate and latency. The design:
//   * a block of 4 warps takes 64 query rows of one (b, h); warp w owns rows
//     16 w .. 16 w + 15 and keeps their Q as A fragments in registers for
//     the whole loop over key tiles. The query tiles of one (b, h) are
//     neighbours in the grid, so they run together and find its K and V in
//     L2 (5% against the (b, h)-major order);
//   * K and V stream through shared memory in 64-row tiles, two buffers
//     filled by cp.async: the next tile arrives while the current one
//     computes (46 KB with the Q tile, 4 blocks an SM);
//   * per key tile a warp computes its 16 x 64 scores (K by ldmatrix), and
//     runs the online softmax in registers: a row's scores lie in the four
//     lanes of a quad, so its max and its sum are two shuffles each. The
//     exponent is ex2.approx with scale * log2(e) folded into the scores
//     (exp2f's extra scaling for denormal results cost 10% of the kernel);
//   * P is rounded to bf16 in registers and is the A operand of O += P V
//     directly (V by ldmatrix .trans): no trip through shared memory and one
//     __syncthreads() pair a key tile, for the buffers;
//   * the ragged tail: rows >= S are zero-filled by cp.async, a key >= S
//     scores -inf (P = 0), and 16-row slabs and 16- or 8-key column blocks
//     that lie wholly beyond S are skipped. Rows >= S are not written;
//   * no atomics and a fixed summation order: the same inputs give the same
//     bits.

#include <math.h>

#include "flash_mma.cuh"

namespace sm3x {

namespace {

using namespace mma;

struct Fwd {
  const bf16 *q, *k, *v;
  bf16* out;
  float* lse;
  Strides sq, sk, sv, so;
  int H, S;
  float scale;
};

// 2^x by the special-function unit alone (ex2.approx: relative error 2^-22,
// 2^-inf = 0), without exp2f's extra scaling for denormal results
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// K3f: one block per (b, h, 64 query rows), looping over key tiles
__global__ void __launch_bounds__(kThreads) fwd_kernel(Fwd a) {
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* Qs = reinterpret_cast<bf16*>(smem);
  bf16* KVs = Qs + kTileElems;  // buffer i: K at KVs + 2 i kTileElems, V after it
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  // the query tiles of one (b, h) are neighbours in the grid, so they run
  // together and share its K and V in L2
  const int bh = blockIdx.y, b = bh / a.H, h = bh % a.H;
  const int q0 = blockIdx.x * kTile, S = a.S;
  const bf16* kbase = a.k + b * a.sk.b + h * a.sk.h;
  const bf16* vbase = a.v + b * a.sv.b + h * a.sv.h;

  load_tile(Qs, a.q + b * a.sq.b + h * a.sq.h, a.sq.s, q0, S);
  load_tile(KVs, kbase, a.sk.s, 0, S);
  load_tile(KVs + kTileElems, vbase, a.sv.s, 0, S);
  cp_async_commit();

  const int g = lane >> 2, c2 = (lane & 3) * 2;
  const int r0 = warp * 16;  // the warp's rows in the tile
  const bool active = q0 + r0 < S;
  // scores in units of log2: exp(x scale - m) = exp2(x sl2 - m log2(e))
  const float sl2 = a.scale * 1.4426950408889634f;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};  // rows g and g + 8
  uint32_t qa[4][4];
  float o[8][4];
  zero(o);

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
      if (it == 0) load_a(qa, Qs, r0, lane);
      // 16-key column groups of this tile that hold a key < S
      const int n16 = min(kTile / 16, (S - k0 + 15) / 16);
      float s[4][2][4];
      float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if (j >= n16) continue;
        gemm_abt(s[j], qa, Ks, 16 * j, k0 + 16 * j + 8 < S, lane);
#pragma unroll
        for (int hb = 0; hb < 2; ++hb)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int key = k0 + 16 * j + 8 * hb + c2 + (e & 1);
            const float t = key < S ? s[j][hb][e] * sl2 : -INFINITY;
            s[j][hb][e] = t;
            mx[e >> 1] = fmaxf(mx[e >> 1], t);
          }
      }
      float alpha[2], rs[2] = {0.f, 0.f};
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        // key k0 < S is in every tile, so the new max is finite
        const float m_new = fmaxf(m[i], quad_max(mx[i]));
        alpha[i] = fast_exp2(m[i] - m_new);
        m[i] = m_new;
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if (j >= n16) continue;
#pragma unroll
        for (int hb = 0; hb < 2; ++hb)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float p = fast_exp2(s[j][hb][e] - m[e >> 1]);
            s[j][hb][e] = p;
            rs[e >> 1] += p;
          }
      }
#pragma unroll
      for (int i = 0; i < 2; ++i) l[i] = l[i] * alpha[i] + quad_sum(rs[i]);
#pragma unroll
      for (int n = 0; n < 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) o[n][e] *= alpha[e >> 1];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if (j >= n16) continue;
        uint32_t pa[4];
        pack_a(pa, s[j]);
        gemm_ab(o, pa, Vs, 16 * j, lane);
      }
    }
    __syncthreads();  // the buffer is refilled next iteration
  }
  if (active) {
    const float inv[2] = {1.f / l[0], 1.f / l[1]};
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[n][e] *= inv[e >> 1];
    store_slab(a.out + b * a.so.b + h * a.so.h, a.so.s, q0 + r0, S, o, lane);
    if ((lane & 3) == 0) {
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int row = q0 + r0 + g + 8 * i;
        if (row < S)
          a.lse[(long long)bh * S + row] = (m[i] + log2f(l[i])) * 0.6931471805599453f;
      }
    }
  }
}

constexpr size_t kFwdSmem = 5 * kTileElems * sizeof(bf16);

}  // namespace

// K3f for bf16. ptrs and strides as for sm3x_flash_fwd in
// flash_attention.cu. Returns cudaGetLastError().
int flash_fwd_mma(const void* const* ptrs, const long long* strides, int B, int S, int H,
                  float scale, cudaStream_t stream) {
  Fwd a{};
  a.q = static_cast<const bf16*>(ptrs[0]);
  a.k = static_cast<const bf16*>(ptrs[1]);
  a.v = static_cast<const bf16*>(ptrs[2]);
  a.out = static_cast<bf16*>(const_cast<void*>(ptrs[3]));
  a.lse = static_cast<float*>(const_cast<void*>(ptrs[4]));
  a.sq = strides_at(strides, 0);
  a.sk = strides_at(strides, 1);
  a.sv = strides_at(strides, 2);
  a.so = strides_at(strides, 3);
  a.H = H;
  a.S = S;
  a.scale = scale;
  if ((long long)B * H > 65535) return (int)cudaErrorInvalidValue;  // gridDim.y
  const dim3 grid((S + kTile - 1) / kTile, B * H);
  cudaFuncSetAttribute(fwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kFwdSmem);
  fwd_kernel<<<grid, kThreads, kFwdSmem, stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace sm3x
