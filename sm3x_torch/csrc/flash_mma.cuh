// Tensor-core building blocks shared by the bf16 flash-attention kernels:
// K3f (flash_attention_fwd_mma.cu) and K3b-dq / K3b-dkv
// (flash_attention_bwd_mma.cu).
//
// A block of 4 warps works on 64-row tiles of bf16 with the head dim (64)
// contiguous. Tiles sit in shared memory in rows padded to 72 elements
// (144 bytes), so the 8 rows that one ldmatrix phase reads fall in distinct
// banks; they are filled by cp.async, 16 bytes a copy, with rows >= S
// zero-filled. Products are `mma.sync` m16n8k16, bf16 operands and float32
// accumulators; warp w owns rows 16 w .. 16 w + 15 of its block's tile. The
// accumulator layout of two 8-column blocks is the A-operand layout of one
// 16-deep k-step, so a product's result, rounded to bf16 in registers, feeds
// the next product without a trip through shared memory (`pack_a`).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace sm3x {
namespace mma {

using bf16 = __nv_bfloat16;

constexpr int kD = 64;                  // head dim
constexpr int kTile = 64;               // rows of a block's tile and of a streamed tile
constexpr int kRow = kD + 8;            // shared row stride, elements (144 bytes)
constexpr int kTileElems = kTile * kRow;
constexpr int kThreads = 128;           // 4 warps x 16 rows

struct Strides {  // in elements; the head dim is contiguous
  long long b, s, h;
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared; with !valid nothing is read and zeros are written
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(valid ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p))
               : "memory");
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p))
               : "memory");
}

// c += a b: a 16 x 16 (row), b 16 x 8 (col), bf16; c 16 x 8 float32
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two float32 values rounded to bf16 (to nearest even), `lo` in the low half
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// the bf16 A operand (16 x 16) of one 16-deep k-step, from the float32
// accumulators of two 8-column blocks: the m16n8k16 accumulator layout of
// columns 0..7 and 8..15 is the A layout of k 0..7 and 8..15
__device__ __forceinline__ void pack_a(uint32_t (&a)[4], const float (&c)[2][4]) {
  a[0] = pack_bf16(c[0][0], c[0][1]);
  a[1] = pack_bf16(c[0][2], c[0][3]);
  a[2] = pack_bf16(c[1][0], c[1][1]);
  a[3] = pack_bf16(c[1][2], c[1][3]);
}

// rows row0 .. row0 + 63 of one (b, h) slice (`base` at row 0, row stride
// `ld` elements) into a shared tile, 4 cp.async of 16 bytes a thread; rows
// >= S are zero-filled
__device__ __forceinline__ void load_tile(bf16* dst, const bf16* base, long long ld, int row0,
                                          int S) {
#pragma unroll
  for (int j = 0; j < kTile * kD / 8 / kThreads; ++j) {
    const int i = threadIdx.x + j * kThreads;
    const int r = i >> 3, c = (i & 7) * 8;
    const int row = row0 + r;
    const bool ok = row < S;
    cp_async16(dst + r * kRow + c, base + (ok ? row : 0) * ld + c, ok);
  }
}

// lse and Delta of rows row0 .. row0 + 63 (one (b, h)) into shared memory,
// threads 0-63 the lse and 64-127 Delta; rows >= S are zero-filled
__device__ __forceinline__ void load_rowstats(float* ls, float* ds, const float* lse,
                                              const float* delta, int row0, int S) {
  const int r = threadIdx.x & (kTile - 1), row = row0 + r;
  const bool ok = row < S;
  const bool is_lse = threadIdx.x < kTile;
  cp_async4((is_lse ? ls : ds) + r, (is_lse ? lse : delta) + (ok ? row : 0), ok);
}

// the A operands of rows r0 .. r0 + 15 of a shared tile over the head dim
// (4 k-steps of 16)
__device__ __forceinline__ void load_a(uint32_t (&a)[4][4], const bf16* tile, int r0, int lane) {
  const bf16* p = tile + (r0 + (lane & 15)) * kRow + (lane >> 4) * 8;
#pragma unroll
  for (int t = 0; t < 4; ++t) ldsm_x4(a[t], p + 16 * t);
}

// acc[h] = A . T[n0 + 8 h .. n0 + 8 h + 7]^T over the head dim, for the
// rows of a shared tile T; the second block only when `two`
__device__ __forceinline__ void gemm_abt(float (&acc)[2][4], const uint32_t (&a)[4][4],
                                         const bf16* tile, int n0, bool two, int lane) {
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[h][e] = 0.f;
  const bf16* p = tile + (n0 + (lane & 7) + ((lane >> 4) << 3)) * kRow + ((lane >> 3) & 1) * 8;
#pragma unroll
  for (int t = 0; t < 4; ++t) {
    uint32_t b[4];
    ldsm_x4(b, p + 16 * t);
    mma_bf16(acc[0], a[t], b[0], b[1]);
    if (two) mma_bf16(acc[1], a[t], b[2], b[3]);
  }
}

// acc += A . T[k0 .. k0 + 15] (16 rows x the head dim) of a shared tile T
__device__ __forceinline__ void gemm_ab(float (&acc)[8][4], const uint32_t (&a)[4],
                                        const bf16* tile, int k0, int lane) {
  const bf16* p = tile + (k0 + (lane & 7) + (((lane >> 3) & 1) << 3)) * kRow + (lane >> 4) * 8;
#pragma unroll
  for (int n = 0; n < 4; ++n) {
    uint32_t b[4];
    ldsm_x4_trans(b, p + 16 * n);
    mma_bf16(acc[2 * n], a, b[0], b[1]);
    mma_bf16(acc[2 * n + 1], a, b[2], b[3]);
  }
}

// a warp's 16 x 64 accumulator, rows row .. row + 15, as bf16 to the rows
// < S of one (b, h) slice (`base` at row 0, row stride `ld`)
__device__ __forceinline__ void store_slab(bf16* base, long long ld, int row, int S,
                                           const float (&acc)[8][4], int lane) {
  const int g = lane >> 2, c = (lane & 3) * 2;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int r = row + g + 8 * half;
    if (r >= S) continue;
    bf16* p = base + r * ld + c;
#pragma unroll
    for (int j = 0; j < 8; ++j)
      *reinterpret_cast<__nv_bfloat162*>(p + 8 * j) =
          __floats2bfloat162_rn(acc[j][2 * half], acc[j][2 * half + 1]);
  }
}

__device__ __forceinline__ void zero(float (&acc)[8][4]) {
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
}

inline Strides strides_at(const long long* s, int i) {
  return {s[3 * i], s[3 * i + 1], s[3 * i + 2]};
}

}  // namespace mma
}  // namespace sm3x
