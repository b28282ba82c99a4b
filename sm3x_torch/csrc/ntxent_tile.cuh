// Building blocks of the NT-Xent kernels (ntxent.cu): rows of z in shared
// memory, and the similarity of a few rows with a block of columns.
//
// A tile holds rows of one problem's z as they are in device memory (not
// normalised), `stride` floats apart: the least odd number of 16-byte
// steps that leaves at least one step of padding after D floats. With an
// odd step count the eight lanes of a quarter warp that read 16 bytes each
// from eight consecutive rows hit eight distinct groups of four banks:
// reads down a column of z are free of conflicts. The tail of a row
// between D and D rounded up to 4 is set to zero by `tile_row_norms`, so
// products run over whole 16-byte steps.
// Rows are filled by cp.async (16 bytes a copy where D is a multiple of 4
// and z is 16-byte aligned, else 4 bytes a copy), all copies of a tile in
// flight at once. The row normalisation is kept beside the tile as
// inv[r] = rsqrt(max(|z_r|^2, 1e-24)) and multiplied into the products:
// S_ij = (z_i . z_j) inv_i inv_j / T.
//
// Lanes own columns: in `tile_dots` lane l of a warp accumulates the dot
// products of the warp's RW rows with columns l, l + 32, ... of a block of
// 32 * CW columns over D, 16 bytes a step, in float32 FMAs. A step costs
// RW broadcast loads and CW column loads for 4 * RW * CW FMAs, and no
// shuffle: a row's logits are reduced across lanes once, at its end.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace ntxent_tile {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_addr(dst)), "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(smem_addr(dst)), "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// The padded row stride of a tile, in floats (the wrapper computes the same).
__host__ __device__ inline int tile_stride(int d) { return 4 * ((((d + 3) >> 2) + 1) | 1); }

// Start the copies of `rows` rows of `d` floats from src (rows d apart) to
// dst (rows `stride` apart), spread over the block's threads. The caller
// commits, waits and synchronises.
__device__ __forceinline__ void tile_load(float* dst, const float* __restrict__ src, int rows,
                                          int d, int stride, bool vec) {
  if (vec) {
    const int per_row = d >> 2;
    for (int i = threadIdx.x; i < rows * per_row; i += blockDim.x) {
      const int r = i / per_row, q = i - r * per_row;
      cp_async16(dst + r * stride + 4 * q, src + (size_t)r * d + 4 * q);
    }
  } else {
    for (int i = threadIdx.x; i < rows * d; i += blockDim.x) {
      const int r = i / d, k = i - r * d;
      cp_async4(dst + r * stride + k, src + (size_t)r * d + k);
    }
  }
}

// inv[r] = rsqrt(max(|row r|^2, 1e-24)) for the tile's rows, one thread a
// row, in a fixed order of summation; zeroes the row's tail up to a multiple
// of 4. The caller synchronises before inv or the tails are read.
__device__ __forceinline__ void tile_row_norms(float* tile, float* inv, int rows, int d,
                                               int stride) {
  const int d4 = (d + 3) & ~3;
  for (int r = threadIdx.x; r < rows; r += blockDim.x) {
    float* row = tile + r * stride;
    for (int k = d; k < d4; ++k) row[k] = 0.f;
    float s0 = 0.f, s1 = 0.f, s2 = 0.f, s3 = 0.f;
#pragma unroll 4
    for (int k = 0; k < d4; k += 4) {
      const float4 v = *reinterpret_cast<const float4*>(row + k);
      s0 += v.x * v.x;
      s1 += v.y * v.y;
      s2 += v.z * v.z;
      s3 += v.w * v.w;
    }
    inv[r] = rsqrtf(fmaxf((s0 + s1) + (s2 + s3), 1e-24f));
  }
}

// acc[r][c] = rows[r] . cols[lane + 32 c] over d4 floats (d4 a multiple of
// 4), both `stride` apart. Every row read lies inside its buffer; what a
// row past the data holds is the caller's to ignore.
template <int RW, int CW>
__device__ __forceinline__ void tile_dots(const float* rows, const float* cols, int d4,
                                          int stride, int lane, float (&acc)[RW][CW]) {
#pragma unroll
  for (int r = 0; r < RW; ++r)
#pragma unroll
    for (int c = 0; c < CW; ++c) acc[r][c] = 0.f;
  const float* col = cols + lane * stride;
#pragma unroll 2
  for (int k = 0; k < d4; k += 4) {
    float4 a[RW], b[CW];
#pragma unroll
    for (int r = 0; r < RW; ++r) a[r] = *reinterpret_cast<const float4*>(rows + r * stride + k);
#pragma unroll
    for (int c = 0; c < CW; ++c)
      b[c] = *reinterpret_cast<const float4*>(col + 32 * c * stride + k);
#pragma unroll
    for (int r = 0; r < RW; ++r)
#pragma unroll
      for (int c = 0; c < CW; ++c) {
        acc[r][c] = fmaf(a[r].x, b[c].x, acc[r][c]);
        acc[r][c] = fmaf(a[r].y, b[c].y, acc[r][c]);
        acc[r][c] = fmaf(a[r].z, b[c].z, acc[r][c]);
        acc[r][c] = fmaf(a[r].w, b[c].w, acc[r][c]);
      }
  }
}

}  // namespace ntxent_tile
