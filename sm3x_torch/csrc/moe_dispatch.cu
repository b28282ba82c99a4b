// The sparse-expert layer's token moves (K5): dispatch of token rows into
// expert slots and the weighted combine of slot rows back into tokens, each
// with its backward.
//
// Replaces no TPU kernel: the JAX package has no sparse-expert layer. It was
// added for V-MoE (sm3x_torch/models/vmoe.py), whose plain form is a chain
// of index, cast and scatter operations over (E * C, D) that the device
// trace cannot name as one layer.
//
// The layout: a routing group of N tokens, k choices a token, E experts of
// C slots each (S = E * C slots). The host builds a slot map of int32:
// token_slot (N, k), the slot of each choice or -1 where the capacity cut
// dropped it; slot_assign (S), the choice t * k + j a slot holds or -1 for
// an empty slot. With both maps every direction is a gather, so no kernel
// needs an atomic and each gives the same bits on every run:
//   dispatch forward   out[s]    = x[t(s)]                  (0 where empty)
//   combine forward    out[t]    = sum_j g[t, j] y[slot(t, j)]
//   combine backward   dy[s]     = g[a(s)] dout[t(s)], dg[a(s)] = dout[t(s)] . y[s]
//   dispatch backward  dx[t]     = sum_j dslots[slot(t, j)]
// Sums are float32 and each output row is rounded once.
//
// What bounds it on the H100: device memory. Each row is D values (768 bf16,
// 1536 bytes at ViT-B width) moved once, with a few bytes of map a row. The
// design: one warp a row, 16-byte loads and stores, the warp's lanes on
// neighbouring 16-byte pieces of the row, eight warps a block; a row's map
// entries are read once by every lane (one broadcast). Rows are the grid, so
// S = 26,464 slots or N = 12,608 tokens give thousands of blocks.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace sm3x {
namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kMaxChoices = 4;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// Values of T in one 16-byte piece.
template <typename T>
struct Piece {
  static constexpr int kValues = 16 / sizeof(T);
  __device__ __forceinline__ static void unpack(const uint4& u, float* f) {
    const T* p = reinterpret_cast<const T*>(&u);
#pragma unroll
    for (int i = 0; i < kValues; ++i) f[i] = to_float(p[i]);
  }
  __device__ __forceinline__ static uint4 pack(const float* f) {
    uint4 u;
    T* p = reinterpret_cast<T*>(&u);
#pragma unroll
    for (int i = 0; i < kValues; ++i) p[i] = from_float<T>(f[i]);
    return u;
  }
};

__device__ __forceinline__ int warp_row(int rows) {
  const int row = blockIdx.x * kWarps + threadIdx.x / 32;
  return row < rows ? row : -1;
}

__global__ void __launch_bounds__(kThreads)
    moe_dispatch_fwd_kernel(const uint4* __restrict__ x, const int* __restrict__ slot_assign,
                            uint4* __restrict__ out, int slots, int k, int pieces) {
  const int row = warp_row(slots);
  if (row < 0) return;
  const int lane = threadIdx.x % 32;
  const int a = slot_assign[row];
  uint4* o = out + (long long)row * pieces;
  if (a < 0) {
    for (int v = lane; v < pieces; v += 32) o[v] = make_uint4(0, 0, 0, 0);
    return;
  }
  const uint4* src = x + (long long)(a / k) * pieces;
  for (int v = lane; v < pieces; v += 32) o[v] = __ldg(src + v);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    moe_combine_fwd_kernel(const uint4* __restrict__ y, const float* __restrict__ gates,
                           const int* __restrict__ token_slot, uint4* __restrict__ out,
                           int tokens, int k, int pieces) {
  using P = Piece<T>;
  const int row = warp_row(tokens);
  if (row < 0) return;
  const int lane = threadIdx.x % 32;
  int slot[kMaxChoices];
  float g[kMaxChoices];
#pragma unroll
  for (int j = 0; j < kMaxChoices; ++j) {
    slot[j] = j < k ? token_slot[row * k + j] : -1;
    g[j] = j < k ? gates[row * k + j] : 0.f;
  }
  for (int v = lane; v < pieces; v += 32) {
    float acc[P::kValues], f[P::kValues];
#pragma unroll
    for (int i = 0; i < P::kValues; ++i) acc[i] = 0.f;
#pragma unroll
    for (int j = 0; j < kMaxChoices; ++j) {
      if (slot[j] < 0) continue;
      P::unpack(__ldg(y + (long long)slot[j] * pieces + v), f);
#pragma unroll
      for (int i = 0; i < P::kValues; ++i) acc[i] = __fadd_rn(acc[i], __fmul_rn(g[j], f[i]));
    }
    out[(long long)row * pieces + v] = P::pack(acc);
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    moe_combine_bwd_kernel(const uint4* __restrict__ dout, const uint4* __restrict__ y,
                           const float* __restrict__ gates, const int* __restrict__ slot_assign,
                           uint4* __restrict__ dy, float* __restrict__ dgates, int slots, int k,
                           int pieces) {
  using P = Piece<T>;
  const int row = warp_row(slots);
  if (row < 0) return;
  const int lane = threadIdx.x % 32;
  const int a = slot_assign[row];
  uint4* o = dy + (long long)row * pieces;
  if (a < 0) {
    for (int v = lane; v < pieces; v += 32) o[v] = make_uint4(0, 0, 0, 0);
    return;
  }
  const uint4* d = dout + (long long)(a / k) * pieces;
  const uint4* ys = y + (long long)row * pieces;
  const float g = gates[a];
  float dot = 0.f, fd[P::kValues], fy[P::kValues];
  for (int v = lane; v < pieces; v += 32) {
    P::unpack(__ldg(d + v), fd);
    P::unpack(__ldg(ys + v), fy);
#pragma unroll
    for (int i = 0; i < P::kValues; ++i) {
      dot = fmaf(fd[i], fy[i], dot);
      fd[i] = __fmul_rn(g, fd[i]);
    }
    o[v] = P::pack(fd);
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) dot += __shfl_xor_sync(0xffffffffu, dot, off);
  if (lane == 0) dgates[a] = dot;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    moe_dispatch_bwd_kernel(const uint4* __restrict__ dslots, const int* __restrict__ token_slot,
                            uint4* __restrict__ dx, int tokens, int k, int pieces) {
  using P = Piece<T>;
  const int row = warp_row(tokens);
  if (row < 0) return;
  const int lane = threadIdx.x % 32;
  int slot[kMaxChoices];
#pragma unroll
  for (int j = 0; j < kMaxChoices; ++j) slot[j] = j < k ? token_slot[row * k + j] : -1;
  for (int v = lane; v < pieces; v += 32) {
    float acc[P::kValues], f[P::kValues];
#pragma unroll
    for (int i = 0; i < P::kValues; ++i) acc[i] = 0.f;
#pragma unroll
    for (int j = 0; j < kMaxChoices; ++j) {
      if (slot[j] < 0) continue;
      P::unpack(__ldg(dslots + (long long)slot[j] * pieces + v), f);
#pragma unroll
      for (int i = 0; i < P::kValues; ++i) acc[i] = __fadd_rn(acc[i], f[i]);
    }
    dx[(long long)row * pieces + v] = P::pack(acc);
  }
}

unsigned blocks_for(int rows) { return (unsigned)((rows + kWarps - 1) / kWarps); }

bool bad_shape(int rows, int k, int pieces) {
  return rows < 0 || k < 1 || k > kMaxChoices || pieces < 1;
}

}  // namespace
}  // namespace sm3x

extern "C" {

// Every entry point takes rows of `pieces` 16-byte pieces (D * sizeof(T) /
// 16), `bf16` 1 for bfloat16 rows and 0 for float32, and returns
// cudaGetLastError() after its launch.

int sm3x_moe_dispatch_fwd(const void* x, const int* slot_assign, void* out, int slots, int k,
                          int pieces, cudaStream_t stream) {
  using namespace sm3x;
  if (bad_shape(slots, k, pieces)) return (int)cudaErrorInvalidValue;
  if (slots == 0) return 0;
  moe_dispatch_fwd_kernel<<<blocks_for(slots), kThreads, 0, stream>>>(
      (const uint4*)x, slot_assign, (uint4*)out, slots, k, pieces);
  return (int)cudaGetLastError();
}

int sm3x_moe_combine_fwd(const void* y, const float* gates, const int* token_slot, void* out,
                         int tokens, int k, int pieces, int bf16, cudaStream_t stream) {
  using namespace sm3x;
  if (bad_shape(tokens, k, pieces)) return (int)cudaErrorInvalidValue;
  if (tokens == 0) return 0;
  if (bf16)
    moe_combine_fwd_kernel<__nv_bfloat16><<<blocks_for(tokens), kThreads, 0, stream>>>(
        (const uint4*)y, gates, token_slot, (uint4*)out, tokens, k, pieces);
  else
    moe_combine_fwd_kernel<float><<<blocks_for(tokens), kThreads, 0, stream>>>(
        (const uint4*)y, gates, token_slot, (uint4*)out, tokens, k, pieces);
  return (int)cudaGetLastError();
}

int sm3x_moe_combine_bwd(const void* dout, const void* y, const float* gates,
                         const int* slot_assign, void* dy, float* dgates, int slots, int k,
                         int pieces, int bf16, cudaStream_t stream) {
  using namespace sm3x;
  if (bad_shape(slots, k, pieces)) return (int)cudaErrorInvalidValue;
  if (slots == 0) return 0;
  if (bf16)
    moe_combine_bwd_kernel<__nv_bfloat16><<<blocks_for(slots), kThreads, 0, stream>>>(
        (const uint4*)dout, (const uint4*)y, gates, slot_assign, (uint4*)dy, dgates, slots, k,
        pieces);
  else
    moe_combine_bwd_kernel<float><<<blocks_for(slots), kThreads, 0, stream>>>(
        (const uint4*)dout, (const uint4*)y, gates, slot_assign, (uint4*)dy, dgates, slots, k,
        pieces);
  return (int)cudaGetLastError();
}

int sm3x_moe_dispatch_bwd(const void* dslots, const int* token_slot, void* dx, int tokens, int k,
                          int pieces, int bf16, cudaStream_t stream) {
  using namespace sm3x;
  if (bad_shape(tokens, k, pieces)) return (int)cudaErrorInvalidValue;
  if (tokens == 0) return 0;
  if (bf16)
    moe_dispatch_bwd_kernel<__nv_bfloat16><<<blocks_for(tokens), kThreads, 0, stream>>>(
        (const uint4*)dslots, token_slot, (uint4*)dx, tokens, k, pieces);
  else
    moe_dispatch_bwd_kernel<float><<<blocks_for(tokens), kThreads, 0, stream>>>(
        (const uint4*)dslots, token_slot, (uint4*)dx, tokens, k, pieces);
  return (int)cudaGetLastError();
}

}  // extern "C"
