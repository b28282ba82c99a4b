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
// flops a pixel. Design:
//   * one block per image: the op order and flags are per image, so every
//     branch is uniform within the block;
//   * jitter rounds are pointwise passes over a scratch copy of the image in
//     device memory (a 224^2 f32 image is 602 KB and stays in L2 between
//     passes); a contrast round first reduces the mean gray of the current
//     image with a fixed-order block reduction, so results repeat bit for bit;
//   * grayscale, flip, blur and normalisation are one final pass that reads
//     the flipped column with a reflect halo of 1 and writes the output;
//   * data stay NHWC (interleaved RGB) on both sides. The TPU kernel's
//     channel-major planes and its flip-as-matmul were TPU workarounds; here a
//     flip is an index reversal.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 1024;

// parameter columns (augment_pallas.py:28-32)
constexpr int P_FB = 0, P_FC = 1, P_FS = 2, P_FH = 3, P_ORD0 = 4;
constexpr int P_DO_JIT = 8, P_DO_GRAY = 9, P_DO_FLIP = 10, P_DO_BLUR = 11;
constexpr int P_SIGMA = 12, P_SIZE = 16;

__device__ __forceinline__ float gray_of(float r, float g, float b) {
  return 0.299f * r + 0.587f * g + 0.114f * b;
}

__device__ __forceinline__ float clip01(float x) {
  return fminf(fmaxf(x, 0.f), 1.f);
}

// Python-style float modulo (the sign follows the divisor), as jnp.remainder
// and torch.remainder compute it.
__device__ __forceinline__ float pymod(float a, float b) {
  float m = fmodf(a, b);
  if (m != 0.f && ((b < 0.f) != (m < 0.f))) m += b;
  return m;
}

__device__ __forceinline__ float hue_comp(float n, float h, float v, float s) {
  const float k = pymod(n + h * 6.f, 6.f);
  return v - v * s * fminf(fmaxf(fminf(k, 4.f - k), 0.f), 1.f);
}

__device__ __forceinline__ void hue_rotate(float& r, float& g, float& b, float f) {
  const float maxc = fmaxf(fmaxf(r, g), b);
  const float minc = fminf(fminf(r, g), b);
  const float delta = maxc - minc;
  const float safe = delta == 0.f ? 1.f : delta;
  const float rc = (maxc - r) / safe;
  const float gc = (maxc - g) / safe;
  const float bc = (maxc - b) / safe;
  float h = maxc == r ? bc - gc : (maxc == g ? 2.f + rc - bc : 4.f + gc - rc);
  h = pymod(delta == 0.f ? 0.f : h / 6.f, 1.f);
  const float s = maxc == 0.f ? 0.f : delta / (maxc == 0.f ? 1.f : maxc);
  const float v = maxc;
  h = pymod(h + f, 1.f);
  r = hue_comp(5.f, h, v, s);
  g = hue_comp(3.f, h, v, s);
  b = hue_comp(1.f, h, v, s);
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
photometric_kernel(const float* images,
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
        if (op == 0) {
          const float f = p[P_FB];
          r = clip01(r * f); g = clip01(g * f); b = clip01(b * f);
        } else if (op == 1) {
          const float f = p[P_FC], c = (1.f - f) * mean_gray;
          r = clip01(r * f + c); g = clip01(g * f + c); b = clip01(b * f + c);
        } else if (op == 2) {
          const float f = p[P_FS], gr = gray_of(r, g, b);
          r = clip01(r * f + (1.f - f) * gr);
          g = clip01(g * f + (1.f - f) * gr);
          b = clip01(b * f + (1.f - f) * gr);
        } else {
          hue_rotate(r, g, b, p[P_FH]);
        }
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
  const float sigma = p[P_SIGMA];
  const float w1raw = expf(-0.5f / fmaxf(sigma * sigma, 1e-8f));
  const float norm = 1.f + 2.f * w1raw;
  const float w0 = 1.f / norm, w1 = w1raw / norm;

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

}  // namespace

extern "C" {

// images (B, H, W, 3) f32 in [0, 1], params (B, 16) f32 -> out (B, H, W, 3).
// scratch has the shape of images. H, W >= 2. Returns cudaGetLastError().
int sm3x_photometric(const float* images, const float* params, float* scratch,
                     float* out, int batch, int h, int w, float m0, float m1,
                     float m2, float s0, float s1, float s2,
                     cudaStream_t stream) {
  photometric_kernel<<<batch, kThreads, 0, stream>>>(
      images, params, scratch, out, h, w, m0, m1, m2, s0, s1, s2);
  return (int)cudaGetLastError();
}

}  // extern "C"
