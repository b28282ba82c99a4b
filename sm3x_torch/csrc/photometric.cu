// Fused photometric augmentation chain for Hopper (K1).
//
// Replaces the Pallas TPU kernel `photometric_pallas` / `_photometric_kernel`
// (sm3x/ops/augment_pallas.py:63-189). Per image: four ColorJitter rounds in
// a per-image order (brightness, contrast against the current image's mean
// gray, saturation, HSV hue rotation), gated by do_jit; then grayscale,
// horizontal flip, a 3x3 separable Gaussian blur with reflect padding and
// per-image sigma, and mean/std normalisation. The parameter row layout is
// the (B, 16) matrix of `build_params` (augment_pallas.py:27-32).
//
// What bounds it on the H100: memory. Each pixel needs one read and one
// write of 12 bytes; the arithmetic (hue rotation included) is a few dozen
// flops a pixel. Two kernels, chosen by the wrapper from the shape alone:
//
// `photometric_band_kernel` reads each pixel from device memory once and
// writes it once. A thread-block cluster owns an image, a block a band of
// its rows, kept with one halo row above and below in shared memory for the
// whole chain. The wrapper's shape plan sets the cluster's size: at 224 x
// 224 it is 14 blocks of 16 + 2 rows (48 KB, four blocks an SM; 96 images
// are 1344 blocks over all 132 SMs). While one block of an SM waits for
// its copies or at the cluster's barrier, the others compute or store.
//   * The band comes in by cp.async, every copy in flight at once, and goes
//     out from shared memory as one span, both with neighbouring threads on
//     neighbouring 16 bytes: a thread that took its own four pixels (48
//     bytes) from or to device memory touched every 32-byte sector twice,
//     and the kernel ran at half the card's memory rate.
//   * Every step before the blur is pointwise given one scalar, so halo rows
//     are jittered like the others and no block waits for a neighbour's
//     pixels. Only a contrast round needs the whole image: its mean gray.
//     The rounds run in place in shared memory, in passes that end before
//     each contrast round: there the block sums the gray of its own rows in
//     a fixed order, leaves the sum where the cluster can read it
//     (distributed shared memory), and after one cluster barrier every
//     block adds the blocks' sums in rank order. No float atomics: the mean
//     repeats bit for bit and is the same in every block. An op order is a
//     permutation, so this happens once an image; an order that names
//     contrast again is still computed, with one more reduction.
//   * IEEE division and fmodf were most of the chain's instructions; the
//     hue rotation uses one approximate reciprocal each for 1 / delta and
//     1 / max, and its modulos are a conditional subtraction and a floor
//     (exact on their ranges).
//   * Grayscale, blur and normalisation are one pass over shared memory. A
//     thread blurs four neighbouring pixels of a row vertically, takes the
//     two columns beside them from the lanes beside it (shuffles; from
//     shared memory at a warp's ends, reflected at the image's), blurs
//     horizontally and normalises. The blur is symmetric, so the flip is an
//     index reversal at the store. Results go back into shared memory one
//     row above their own, chunk of rows by chunk, where no later chunk
//     reads.
//   * With W a multiple of 4 every access to device and shared memory is 16
//     bytes wide (four pixels are three float4; at 48 bytes a thread the
//     shared accesses are free of bank conflicts); other widths take the
//     same kernel with one pixel and scalar accesses a thread.
//
// `photometric_scratch_kernel` is the general-shape path, for a band that
// exceeds shared memory: one block per image, jitter rounds as pointwise
// passes over a scratch copy of the image in device memory, then one final
// pass that fetches up to nine neighbours a pixel.
//
// Data stay NHWC (interleaved RGB) on both sides. The TPU kernel's
// channel-major planes and its flip-as-matmul were TPU workarounds.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 1024;        // the scratch kernel's block
constexpr int kMaxCluster = 16;       // blocks an image in the band kernel, at most
constexpr int kMaxBandThreads = 512;  // threads of one of them, at most

// parameter columns (augment_pallas.py:28-32); columns 0-3 are the factors
// of ops 0-3: brightness, contrast, saturation, hue
constexpr int P_ORD0 = 4;
constexpr int P_DO_JIT = 8, P_DO_GRAY = 9, P_DO_FLIP = 10, P_DO_BLUR = 11;
constexpr int P_SIGMA = 12, P_SIZE = 16;

__device__ __forceinline__ float gray_of(float r, float g, float b) {
  return 0.299f * r + 0.587f * g + 0.114f * b;
}

// fmin(fmax(x, 0), 1) in one instruction, fused into the multiply before it
__device__ __forceinline__ float clip01(float x) { return __saturatef(x); }

// a / b to about 2 ulp: one reciprocal and one multiply. The chain is held
// to rtol 1e-4 / atol 1e-5, and IEEE division and fmodf were most of its
// instructions.
__device__ __forceinline__ float fast_div(float a, float b) { return __fdividef(a, b); }

// v - v s clamp(min(k, 4 - k), 0, 1) with k = (n + 6 h) mod 6, for h in
// [0, 1] and n in {1, 3, 5}: n + 6 h lies in [1, 11], so the modulo is one
// conditional subtraction, exact in float32.
__device__ __forceinline__ float hue_comp(float n, float h, float vs, float v) {
  float k = fmaf(h, 6.f, n);
  k = k >= 6.f ? k - 6.f : k;
  return fmaf(-vs, __saturatef(fminf(k, 4.f - k)), v);
}

// RGB -> HSV, h <- (h + f) mod 1 (the sign follows the divisor, as
// jnp.remainder and torch.remainder compute it), HSV -> RGB.
__device__ __forceinline__ void hue_rotate(float& r, float& g, float& b, float f) {
  const float maxc = fmaxf(fmaxf(r, g), b);
  const float minc = fminf(fminf(r, g), b);
  const float delta = maxc - minc;
  const float inv_delta = fast_div(1.f, delta == 0.f ? 1.f : delta);
  const float rc = (maxc - r) * inv_delta;
  const float gc = (maxc - g) * inv_delta;
  const float bc = (maxc - b) * inv_delta;
  float h = maxc == r ? bc - gc : (maxc == g ? 2.f + rc - bc : 4.f + gc - rc);
  h = delta == 0.f ? 0.f : h * (1.f / 6.f);  // in [-1/6, 5/6]
  h = h < 0.f ? h + 1.f : h;
  const float s = maxc == 0.f ? 0.f : fast_div(delta, maxc == 0.f ? 1.f : maxc);
  const float v = maxc, vs = v * s;
  h += f;
  h -= floorf(h);
  r = hue_comp(5.f, h, vs, v);
  g = hue_comp(3.f, h, vs, v);
  b = hue_comp(1.f, h, vs, v);
}

// One ColorJitter round on one pixel: op 0 brightness, 1 contrast against
// mean_gray, 2 saturation, 3 hue, with the op's factor f = params[op].
__device__ __forceinline__ void jitter_round(int op, float f, float mean_gray, float& r,
                                             float& g, float& b) {
  if (op == 0) {
    r = clip01(r * f); g = clip01(g * f); b = clip01(b * f);
  } else if (op == 1) {
    const float c = (1.f - f) * mean_gray;
    r = clip01(r * f + c); g = clip01(g * f + c); b = clip01(b * f + c);
  } else if (op == 2) {
    const float gr = gray_of(r, g, b);
    r = clip01(r * f + (1.f - f) * gr);
    g = clip01(g * f + (1.f - f) * gr);
    b = clip01(b * f + (1.f - f) * gr);
  } else {
    hue_rotate(r, g, b, f);
  }
}

// The blur's centre and side weights for one image.
__device__ __forceinline__ void blur_weights(float sigma, float& w0, float& w1) {
  const float w1raw = expf(-0.5f / fmaxf(sigma * sigma, 1e-8f));
  const float norm = 1.f + 2.f * w1raw;
  w0 = 1.f / norm;
  w1 = w1raw / norm;
}

// Mean gray of one image, summed in a fixed order. Every thread returns it.
__device__ float block_mean_gray(const float* __restrict__ px, int npx,
                                 float* red) {
  float s = 0.f;
  for (int q = threadIdx.x; q < npx; q += kThreads)
    s += gray_of(px[3 * q], px[3 * q + 1], px[3 * q + 2]);
  for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (lane == 0) red[warp] = s;
  __syncthreads();
  if (warp == 0) {
    float t = red[lane];  // kThreads / 32 == 32 partial sums
    for (int o = 16; o > 0; o >>= 1) t += __shfl_xor_sync(0xffffffffu, t, o);
    if (lane == 0) red[32] = t / (float)npx;
  }
  __syncthreads();
  const float mean = red[32];
  __syncthreads();  // red is reused by the next reduction
  return mean;
}

__global__ void __launch_bounds__(kThreads)
photometric_scratch_kernel(const float* images,
                   const float* __restrict__ params,
                   float* scratch, float* __restrict__ out,
                   int h, int w, float m0, float m1, float m2, float s0,
                   float s1, float s2) {
  __shared__ float red[33];
  const float* p = params + (size_t)blockIdx.x * P_SIZE;
  const int npx = h * w;
  const size_t base = (size_t)blockIdx.x * npx * 3;
  // images and scratch are both read through src, so neither is restrict
  const float* src = images + base;

  if (p[P_DO_JIT] > 0.5f) {
    float* scr = scratch + base;
    const float* cur = src;
    for (int t = 0; t < 4; ++t) {
      const int op = (int)p[P_ORD0 + t];
      float mean_gray = 0.f;
      if (op == 1) mean_gray = block_mean_gray(cur, npx, red);
      for (int q = threadIdx.x; q < npx; q += kThreads) {
        float r = cur[3 * q], g = cur[3 * q + 1], b = cur[3 * q + 2];
        jitter_round(op, p[op], mean_gray, r, g, b);
        scr[3 * q] = r; scr[3 * q + 1] = g; scr[3 * q + 2] = b;
      }
      cur = scr;
      __syncthreads();  // a later contrast round reads every pixel
    }
    src = scr;
  }

  const bool do_gray = p[P_DO_GRAY] > 0.5f;
  const bool do_flip = p[P_DO_FLIP] > 0.5f;
  const bool do_blur = p[P_DO_BLUR] > 0.5f;
  float w0, w1;
  blur_weights(p[P_SIGMA], w0, w1);

  // pixel (y, x) of the grayed, flipped image
  auto fetch = [&](int y, int x, float& r, float& g, float& b) {
    const int xs = do_flip ? w - 1 - x : x;
    const float* q = src + 3 * ((size_t)y * w + xs);
    r = q[0]; g = q[1]; b = q[2];
    if (do_gray) r = g = b = gray_of(r, g, b);
  };
  // vertical blur at column x: w0 * v(y) + w1 * (v(y-1) + v(y+1)), reflected
  auto vblur = [&](int y, int yu, int yd, int x, float& r, float& g, float& b) {
    float r0, g0, b0, ru, gu, bu, rd, gd, bd;
    fetch(y, x, r0, g0, b0);
    fetch(yu, x, ru, gu, bu);
    fetch(yd, x, rd, gd, bd);
    r = w0 * r0 + w1 * (ru + rd);
    g = w0 * g0 + w1 * (gu + gd);
    b = w0 * b0 + w1 * (bu + bd);
  };

  float* dst = out + base;
  for (int q = threadIdx.x; q < npx; q += kThreads) {
    const int y = q / w, x = q - y * w;
    float r, g, b;
    if (do_blur) {
      const int yu = y == 0 ? 1 : y - 1, yd = y == h - 1 ? h - 2 : y + 1;
      const int xl = x == 0 ? 1 : x - 1, xr = x == w - 1 ? w - 2 : x + 1;
      float rc, gc, bc, rl, gl, bl, rr, gr, br;
      vblur(y, yu, yd, x, rc, gc, bc);
      vblur(y, yu, yd, xl, rl, gl, bl);
      vblur(y, yu, yd, xr, rr, gr, br);
      r = w0 * rc + w1 * (rl + rr);
      g = w0 * gc + w1 * (gl + gr);
      b = w0 * bc + w1 * (bl + br);
    } else {
      fetch(y, x, r, g, b);
    }
    dst[3 * q] = (r - m0) / s0;
    dst[3 * q + 1] = (g - m1) / s1;
    dst[3 * q + 2] = (b - m2) / s2;
  }
}


// ---- the band kernel ------------------------------------------------------

// PX pixels (3 PX floats) between registers and memory: 16 bytes wide for
// PX = 4 (the address is 16-byte aligned then), scalar for PX = 1.
template <int PX>
__device__ __forceinline__ void load_px(const float* p, float (&v)[3 * PX]) {
  if constexpr (PX == 4) {
    const float4* q = reinterpret_cast<const float4*>(p);
    const float4 a = q[0], b = q[1], c = q[2];
    v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
    v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
    v[8] = c.x; v[9] = c.y; v[10] = c.z; v[11] = c.w;
  } else {
#pragma unroll
    for (int k = 0; k < 3 * PX; ++k) v[k] = p[k];
  }
}

template <int PX>
__device__ __forceinline__ void store_px(float* p, const float (&v)[3 * PX]) {
  if constexpr (PX == 4) {
    float4* q = reinterpret_cast<float4*>(p);
    q[0] = make_float4(v[0], v[1], v[2], v[3]);
    q[1] = make_float4(v[4], v[5], v[6], v[7]);
    q[2] = make_float4(v[8], v[9], v[10], v[11]);
  } else {
#pragma unroll
    for (int k = 0; k < 3 * PX; ++k) p[k] = v[k];
  }
}

// `count` floats from device to shared memory by cp.async, spread over the
// block: 16 bytes a copy for PX = 4 (count is a multiple of 4 and both
// addresses are 16-byte aligned then), else 4 bytes a copy.
template <int PX>
__device__ __forceinline__ void copy_span(float* dst, const float* src, int count) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  if constexpr (PX == 4) {
    for (int i = threadIdx.x; i < (count >> 2); i += blockDim.x)
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d + 16 * i),
                   "l"(src + 4 * i)
                   : "memory");
  } else {
    for (int i = threadIdx.x; i < count; i += blockDim.x)
      asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d + 4 * i), "l"(src + i)
                   : "memory");
  }
}

__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
}

// The sum over the cluster of each block's `mine` (a per-thread partial sum),
// added in a fixed order: lanes by xor butterfly, warps in warp order,
// blocks in rank order. Every thread of every block returns the same bits.
// `reading` says that the blocks may still be reading `part` from the call
// before; it is left set, and the kernel waits once more before it ends.
__device__ float cluster_sum(float mine, float* warp_part, float* part, bool& reading) {
  cg::cluster_group cluster = cg::this_cluster();
  for (int o = 16; o > 0; o >>= 1) mine += __shfl_xor_sync(0xffffffffu, mine, o);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (lane == 0) warp_part[warp] = mine;
  if (reading) cluster_wait();
  __syncthreads();
  if (threadIdx.x == 0) {
    float t = 0.f;
    for (int k = 0; k < (int)(blockDim.x >> 5); ++k) t += warp_part[k];
    *part = t;
  }
  cluster.sync();  // every block's sum is written, and visible to the cluster
  float total = 0.f;
  for (int b = 0; b < (int)cluster.num_blocks(); ++b) total += *cluster.map_shared_rank(part, b);
  cluster_arrive();
  reading = true;
  return total;
}

// rounds [t0, t1) of the image's op order on PX pixels in registers; ops
// and their factors are the image's, read once
template <int PX>
__device__ __forceinline__ void jitter_rounds(const int (&ops)[4], const float (&factors)[4],
                                              int t0, int t1, float mean_gray,
                                              float (&v)[3 * PX]) {
#pragma unroll
  for (int t = 0; t < 4; ++t) {
    if (t < t0 || t >= t1) continue;
#pragma unroll
    for (int j = 0; j < PX; ++j)
      jitter_round(ops[t], factors[t], mean_gray, v[3 * j], v[3 * j + 1], v[3 * j + 2]);
  }
}

// the first contrast round at or after t, or 4
__device__ __forceinline__ int next_contrast(const int (&ops)[4], int t) {
  int at = 4;
#pragma unroll
  for (int k = 3; k >= 0; --k)
    if (k >= t && ops[k] == 1) at = k;
  return at;
}

// Grid: a cluster of blocks an image (the launch sets its size), block
// `rank` owns rows rank * band .. Dynamic shared memory: (band + 2) rows of
// 3 w floats, the halo row above first. PX = 4 needs w a multiple of 4 and
// 16-byte aligned images and out.
template <int PX>
__global__ void __launch_bounds__(kMaxBandThreads, 2)
photometric_band_kernel(const float* __restrict__ images,
                        const float* __restrict__ params, float* __restrict__ out,
                        int h, int w, int band, float m0, float m1, float m2,
                        float s0, float s1, float s2) {
  extern __shared__ __align__(16) float band_rows[];
  float* const rows = band_rows;
  __shared__ float warp_part[kMaxBandThreads / 32];
  __shared__ float part;  // this block's gray sum, read by the whole cluster
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int img = blockIdx.x / (int)cluster.num_blocks();
  const int y0 = min(rank * band, h), y1 = min(y0 + band, h), n = y1 - y0;
  const int row_f = 3 * w, groups = w / PX, threads = blockDim.x;
  const int lane = threadIdx.x & 31;
  const int items = n > 0 ? (n + 2) * groups : 0;
  const int out_items = n * groups;
  const size_t image_f = (size_t)h * row_f;
  const float i0 = 1.f / s0, i1 = 1.f / s1, i2 = 1.f / s2;
  bool reading = false;  // the cluster may still be reading `part`

  // device -> shared memory: every copy of the band in flight at once,
  // neighbouring threads on neighbouring addresses. The band's own rows are
  // one span of device memory; halo rows reflect at the image's edges.
  if (n > 0) {
    const float* src = images + img * image_f;
    copy_span<PX>(rows + row_f, src + (size_t)y0 * row_f, n * row_f);
    copy_span<PX>(rows, src + (size_t)(y0 == 0 ? 1 : y0 - 1) * row_f, row_f);
    copy_span<PX>(rows + (n + 1) * row_f, src + (size_t)(y1 == h ? h - 2 : y1) * row_f,
                  row_f);
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
  __syncthreads();

  const float* p = params + (size_t)img * P_SIZE;
  int ops[4];
  float factors[4];
#pragma unroll
  for (int t = 0; t < 4; ++t) {
    ops[t] = (int)p[P_ORD0 + t];
    factors[t] = p[ops[t] & 3];
  }

  // the jitter rounds, in place, from one contrast round to the next. A
  // thread meets the same items in every pass, so only the mean crosses
  // threads. Halo rows are jittered too and left out of the gray sum.
  if (p[P_DO_JIT] > 0.5f) {
    int ta = 0, tb = next_contrast(ops, 0);
    float mean_gray = 0.f;
    while (true) {
      float gray_sum = 0.f;
      for (int it = threadIdx.x; it < items; it += threads) {
        const int slot = it / groups, gx = it - slot * groups;
        float* at = rows + slot * row_f + 3 * PX * gx;
        float v[3 * PX];
        load_px<PX>(at, v);
        jitter_rounds<PX>(ops, factors, ta, tb, mean_gray, v);
        if (tb < 4 && slot >= 1 && slot <= n) {
#pragma unroll
          for (int j = 0; j < PX; ++j)
            gray_sum += gray_of(v[3 * j], v[3 * j + 1], v[3 * j + 2]);
        }
        if (tb > ta) store_px<PX>(at, v);
      }
      if (tb >= 4) break;
      mean_gray = cluster_sum(gray_sum, warp_part, &part, reading) / (float)(h * w);
      ta = tb;  // the contrast round, then those up to the next one
      tb = next_contrast(ops, tb + 1);
    }
    __syncthreads();
  }

  // gray, vertical blur of the thread's own pixels, the columns beside
  // them from the lanes beside it, horizontal blur, normalise, flip at the
  // store back into shared memory
  const bool do_gray = p[P_DO_GRAY] > 0.5f;
  const bool do_flip = p[P_DO_FLIP] > 0.5f;
  const bool do_blur = p[P_DO_BLUR] > 0.5f;
  float w0, w1;
  blur_weights(p[P_SIGMA], w0, w1);

  // PX pixels of one band row (slot), grayed, blurred vertically
  auto column = [&](int slot, int x, float (&c)[3 * PX]) {
    const float* mid = rows + slot * row_f + 3 * x;
    load_px<PX>(mid, c);
    if (do_gray) {
#pragma unroll
      for (int j = 0; j < PX; ++j)
        c[3 * j] = c[3 * j + 1] = c[3 * j + 2] = gray_of(c[3 * j], c[3 * j + 1], c[3 * j + 2]);
    }
    if (!do_blur) return;
    float up[3 * PX], dn[3 * PX];
    load_px<PX>(mid - row_f, up);
    load_px<PX>(mid + row_f, dn);
    if (do_gray) {
#pragma unroll
      for (int j = 0; j < PX; ++j) {
        up[3 * j] = up[3 * j + 1] = up[3 * j + 2] =
            gray_of(up[3 * j], up[3 * j + 1], up[3 * j + 2]);
        dn[3 * j] = dn[3 * j + 1] = dn[3 * j + 2] =
            gray_of(dn[3 * j], dn[3 * j + 1], dn[3 * j + 2]);
      }
    }
#pragma unroll
    for (int k = 0; k < 3 * PX; ++k) c[k] = w0 * c[k] + w1 * (up[k] + dn[k]);
  };
  // one pixel's column, from shared memory (a warp's first and last lane)
  auto column1 = [&](int slot, int x, float (&c)[3]) {
    const float* mid = rows + slot * row_f + 3 * x;
    float q[3][3];
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      const float* r = mid + (a - 1) * row_f;
      q[a][0] = r[0]; q[a][1] = r[1]; q[a][2] = r[2];
      if (do_gray) q[a][0] = q[a][1] = q[a][2] = gray_of(q[a][0], q[a][1], q[a][2]);
    }
#pragma unroll
    for (int k = 0; k < 3; ++k) c[k] = w0 * q[1][k] + w1 * (q[0][k] + q[2][k]);
  };

  // In chunks of whole rows, an item a thread: the results wait in
  // registers until every thread has read its inputs, then go to the slot
  // above their own row, which no later chunk reads.
  const int chunk_items = (threads / groups) * groups;
  for (int first = 0; first < out_items; first += chunk_items) {
    const bool live =
        (int)threadIdx.x < chunk_items && first + (int)threadIdx.x < out_items;
    // idle lanes still shuffle
    const int it = live ? first + (int)threadIdx.x : out_items - 1;
    const int row = it / groups, gx = it - row * groups, slot = row + 1;
    float c[3 * PX];
    column(slot, PX * gx, c);
    if (do_blur) {
      float left[3], right[3];
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        left[k] = __shfl_up_sync(0xffffffffu, c[3 * (PX - 1) + k], 1);
        right[k] = __shfl_down_sync(0xffffffffu, c[k], 1);
      }
      if (lane == 0 && gx > 0) column1(slot, PX * gx - 1, left);
      if (lane == 31 && gx < groups - 1) column1(slot, PX * (gx + 1), right);
      // reflect: column -1 is column 1, column w is column w - 2
      if constexpr (PX > 1) {
#pragma unroll
        for (int k = 0; k < 3; ++k) {
          if (gx == 0) left[k] = c[3 + k];
          if (gx == groups - 1) right[k] = c[3 * (PX - 2) + k];
        }
      } else {
        const bool at_left = gx == 0, at_right = gx == groups - 1;
#pragma unroll
        for (int k = 0; k < 3; ++k) {
          const float l = left[k], r = right[k];
          if (at_left) left[k] = r;
          if (at_right) right[k] = l;
        }
      }
      float o[3 * PX];
#pragma unroll
      for (int j = 0; j < PX; ++j)
#pragma unroll
        for (int k = 0; k < 3; ++k) {
          const float l = j == 0 ? left[k] : c[3 * (j - 1) + k];
          const float r = j == PX - 1 ? right[k] : c[3 * (j + 1) + k];
          o[3 * j + k] = w0 * c[3 * j + k] + w1 * (l + r);
        }
#pragma unroll
      for (int k = 0; k < 3 * PX; ++k) c[k] = o[k];
    }
    float o[3 * PX];
#pragma unroll
    for (int j = 0; j < PX; ++j) {
      constexpr int kRev = 3 * (PX - 1);  // the flip reverses the thread's pixels
      o[3 * j] = ((do_flip ? c[kRev - 3 * j] : c[3 * j]) - m0) * i0;
      o[3 * j + 1] = ((do_flip ? c[kRev - 3 * j + 1] : c[3 * j + 1]) - m1) * i1;
      o[3 * j + 2] = ((do_flip ? c[kRev - 3 * j + 2] : c[3 * j + 2]) - m2) * i2;
    }
    const int gout = do_flip ? groups - 1 - gx : gx;
    __syncthreads();
    if (live) store_px<PX>(rows + row * row_f + 3 * PX * gout, o);
  }
  __syncthreads();

  // shared memory -> device: the band's rows are one span of the output
  float* dst = out + img * image_f + (size_t)y0 * row_f;
  if constexpr (PX == 4) {
    const float4* from = reinterpret_cast<const float4*>(rows);
    float4* to = reinterpret_cast<float4*>(dst);
    for (int i = threadIdx.x; i < (n * row_f >> 2); i += threads) to[i] = from[i];
  } else {
    for (int i = threadIdx.x; i < n * row_f; i += threads) dst[i] = rows[i];
  }
  if (reading) cluster_wait();  // no block leaves while another reads its sum
}

}  // namespace

extern "C" {

// The band kernel: images (B, H, W, 3) f32 in [0, 1], params (B, 16) f32 ->
// out (B, H, W, 3). `cluster` blocks an image of `band` rows each (together
// they cover H), `px` pixels a thread (4 needs W % 4 == 0 and 16-byte
// aligned images and out, else 1) and `threads` a block come from the
// wrapper's shape plan. Returns the first CUDA error, or 0.
int sm3x_photometric_band(const float* images, const float* params, float* out,
                          int batch, int h, int w, int cluster, int band, int px,
                          int threads, float m0, float m1, float m2, float s0,
                          float s1, float s2, cudaStream_t stream) {
  if (batch < 1 || h < 2 || w < 2 || cluster < 1 || cluster > kMaxCluster || band < 1 ||
      band * cluster < h || (px != 1 && px != 4) || (px == 4 && w % 4 != 0) ||
      threads < 32 || threads > kMaxBandThreads || threads % 32 != 0 || w / px > threads)
    return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)(band + 2) * 3 * w * sizeof(float);
  auto kernel = px == 4 ? photometric_band_kernel<4> : photometric_band_kernel<1>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  if (cluster > 8) {  // above the size every device must take
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) return (int)err;
  }
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3(batch * cluster);
  config.blockDim = dim3(threads);
  config.dynamicSmemBytes = smem;
  config.stream = stream;
  cudaLaunchAttribute attribute;
  attribute.id = cudaLaunchAttributeClusterDimension;
  attribute.val.clusterDim.x = cluster;
  attribute.val.clusterDim.y = 1;
  attribute.val.clusterDim.z = 1;
  config.attrs = &attribute;
  config.numAttrs = 1;
  err = cudaLaunchKernelEx(&config, kernel, images, params, out, h, w, band, m0, m1, m2,
                           s0, s1, s2);
  return err != cudaSuccess ? (int)err : (int)cudaGetLastError();
}

// The general-shape kernel: as above, with scratch of the shape of images.
// H, W >= 2. Returns cudaGetLastError().
int sm3x_photometric_scratch(const float* images, const float* params,
                             float* scratch, float* out, int batch, int h, int w,
                             float m0, float m1, float m2, float s0, float s1,
                             float s2, cudaStream_t stream) {
  photometric_scratch_kernel<<<batch, kThreads, 0, stream>>>(
      images, params, scratch, out, h, w, m0, m1, m2, s0, s1, s2);
  return (int)cudaGetLastError();
}

}  // extern "C"
