// sm3x native data loader: multi-threaded JPEG decode + border crop +
// aspect-preserving letterbox into preallocated uint8 canvases.
//
// This owns the host-side half of the reference's input pipeline (SURVEY
// §2b N3: OpenCV C++ imread in DataLoader workers, functional.py:30-36 +
// the 25-px crop, datasets.py:499). The TPU half (all random transforms)
// lives in sm3x/ops/augment.py. Exposed as a C ABI for ctypes; PNG and
// other formats fall back to the Python/OpenCV path.
//
// Build: g++ -O3 -shared -fPIC -o libsm3x_loader.so loader.cpp -ljpeg -lpthread

#include <cstddef>
#include <cstdio>

#include <jpeglib.h>

#include <algorithm>
#include <atomic>
#include <csetjmp>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <thread>
#include <vector>

namespace {

struct ErrMgr {
  jpeg_error_mgr pub;
  jmp_buf jump;
};

void error_exit(j_common_ptr cinfo) {
  ErrMgr* err = reinterpret_cast<ErrMgr*>(cinfo->err);
  longjmp(err->jump, 1);
}

// Decode one JPEG file into an RGB buffer. Returns true on success.
bool decode_jpeg(const char* path, std::vector<uint8_t>& out, int& h, int& w) {
  FILE* f = fopen(path, "rb");
  if (!f) return false;

  jpeg_decompress_struct cinfo;
  ErrMgr jerr;
  cinfo.err = jpeg_std_error(&jerr.pub);
  jerr.pub.error_exit = error_exit;
  if (setjmp(jerr.jump)) {
    jpeg_destroy_decompress(&cinfo);
    fclose(f);
    return false;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_stdio_src(&cinfo, f);
  jpeg_read_header(&cinfo, TRUE);
  cinfo.out_color_space = JCS_RGB;
  jpeg_start_decompress(&cinfo);
  h = cinfo.output_height;
  w = cinfo.output_width;
  out.resize(static_cast<size_t>(h) * w * 3);
  std::vector<uint8_t*> rows(h);
  for (int y = 0; y < h; ++y) rows[y] = out.data() + static_cast<size_t>(y) * w * 3;
  while (cinfo.output_scanline < cinfo.output_height) {
    jpeg_read_scanlines(&cinfo, rows.data() + cinfo.output_scanline,
                        cinfo.output_height - cinfo.output_scanline);
  }
  jpeg_finish_decompress(&cinfo);
  jpeg_destroy_decompress(&cinfo);
  fclose(f);
  return true;
}

// Area-average downscale (the INTER_AREA the Python path uses) of the
// crop region [cy0,cy1)x[cx0,cx1) of src into dst (dh x dw x 3).
void resize_area(const uint8_t* src, int sw, int cy0, int cx0, int ch, int cw,
                 uint8_t* dst, int dh, int dw) {
  const float sy = static_cast<float>(ch) / dh;
  const float sx = static_cast<float>(cw) / dw;
  for (int oy = 0; oy < dh; ++oy) {
    const float fy0 = oy * sy, fy1 = (oy + 1) * sy;
    const int y0 = static_cast<int>(fy0), y1 = std::min(static_cast<int>(fy1 + 0.9999f), ch);
    for (int ox = 0; ox < dw; ++ox) {
      const float fx0 = ox * sx, fx1 = (ox + 1) * sx;
      const int x0 = static_cast<int>(fx0), x1 = std::min(static_cast<int>(fx1 + 0.9999f), cw);
      float acc[3] = {0, 0, 0};
      float area = 0.f;
      for (int y = y0; y < y1; ++y) {
        const float wy = std::min(fy1, static_cast<float>(y + 1)) -
                         std::max(fy0, static_cast<float>(y));
        const uint8_t* row = src + (static_cast<size_t>(cy0 + y) * sw + cx0) * 3;
        for (int x = x0; x < x1; ++x) {
          const float wx = std::min(fx1, static_cast<float>(x + 1)) -
                           std::max(fx0, static_cast<float>(x));
          const float wgt = wy * wx;
          acc[0] += wgt * row[x * 3 + 0];
          acc[1] += wgt * row[x * 3 + 1];
          acc[2] += wgt * row[x * 3 + 2];
          area += wgt;
        }
      }
      uint8_t* o = dst + (static_cast<size_t>(oy) * dw + ox) * 3;
      const float inv = area > 0 ? 1.f / area : 0.f;
      for (int c = 0; c < 3; ++c) {
        float v = acc[c] * inv;
        o[c] = static_cast<uint8_t>(v < 0 ? 0 : (v > 255 ? 255 : v + 0.5f));
      }
    }
  }
}

}  // namespace

extern "C" {

// Decode paths[i] (JPEG), crop `crop` px border, letterbox into
// canvases[i] (cache*cache*3, zero-padded bottom/right), write the valid
// (h, w) into out_hw[i*2]. status[i]: 1 ok, 0 failed (caller falls back).
void sm3x_decode_letterbox_batch(const char** paths, int n, int cache,
                                 int crop, uint8_t* canvases, int32_t* out_hw,
                                 int32_t* status, int n_threads) {
  std::atomic<int> next(0);
  auto worker = [&]() {
    std::vector<uint8_t> buf;
    for (;;) {
      const int i = next.fetch_add(1);
      if (i >= n) break;
      int h = 0, w = 0;
      uint8_t* canvas = canvases + static_cast<size_t>(i) * cache * cache * 3;
      std::memset(canvas, 0, static_cast<size_t>(cache) * cache * 3);
      if (!decode_jpeg(paths[i], buf, h, w)) {
        status[i] = 0;
        out_hw[i * 2] = out_hw[i * 2 + 1] = 0;
        continue;
      }
      int cy0 = 0, cx0 = 0, ch = h, cw = w;
      if (crop > 0 && h > 2 * crop && w > 2 * crop) {
        cy0 = cx0 = crop;
        ch = h - 2 * crop;
        cw = w - 2 * crop;
      }
      int nh = ch, nw = cw;
      if (ch > cache || cw > cache) {
        const float scale = std::min(static_cast<float>(cache) / ch,
                                     static_cast<float>(cache) / cw);
        nh = std::max(1, static_cast<int>(ch * scale + 0.5f));
        nw = std::max(1, static_cast<int>(cw * scale + 0.5f));
        nh = std::min(nh, cache);
        nw = std::min(nw, cache);
        std::vector<uint8_t> resized(static_cast<size_t>(nh) * nw * 3);
        resize_area(buf.data(), w, cy0, cx0, ch, cw, resized.data(), nh, nw);
        for (int y = 0; y < nh; ++y)
          std::memcpy(canvas + static_cast<size_t>(y) * cache * 3,
                      resized.data() + static_cast<size_t>(y) * nw * 3,
                      static_cast<size_t>(nw) * 3);
      } else {
        for (int y = 0; y < nh; ++y)
          std::memcpy(canvas + static_cast<size_t>(y) * cache * 3,
                      buf.data() + ((static_cast<size_t>(cy0 + y) * w) + cx0) * 3,
                      static_cast<size_t>(nw) * 3);
      }
      out_hw[i * 2] = nh;
      out_hw[i * 2 + 1] = nw;
      status[i] = 1;
    }
  };
  std::vector<std::thread> threads;
  const int nt = n_threads > 0 ? n_threads : 1;
  threads.reserve(nt);
  for (int t = 0; t < nt; ++t) threads.emplace_back(worker);
  for (auto& t : threads) t.join();
}

}  // extern "C"
