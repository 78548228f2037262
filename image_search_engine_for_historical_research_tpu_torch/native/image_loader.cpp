// Threaded JPEG decode + thumbnail: the host-side feeder for batched
// extraction and batched serving.
//
// The PyTorch port's copy of the JAX package's native/image_loader.cpp; the
// decode, the box filter and the output layout are the same, so both
// packages decode a file to the same pixels.
//
// Counterpart of the reference's DataLoader worker processes
// (src/networks/imageretrievalnet.py:363-366: 8 workers around PIL), which
// exist purely to hide per-image decode latency. Here one thread pool decodes
// a whole batch in place: libjpeg with DCT-domain prescaling (decode at 1/2,
// 1/4, 1/8 when the target is much smaller than the file), then box-filtered
// area downsampling to max-side `imsize` (PIL.thumbnail-like; only shrinks),
// float32 RGB in [0, 1].
//
// Per-image failures (non-JPEG, truncated files) are reported via hw = (0, 0)
// and the Python wrapper falls back to the PIL path for those images only,
// matching the reference's truncated-file tolerance (datahelpers.py:28-34).

#include <cstddef>
#include <cstdio>

#include <jpeglib.h>

#include <algorithm>
#include <atomic>
#include <cmath>
#include <csetjmp>
#include <cstdio>
#include <cstring>
#include <thread>
#include <vector>

namespace {

struct ErrMgr {
  jpeg_error_mgr pub;
  jmp_buf jump;
};

void err_exit(j_common_ptr cinfo) {
  ErrMgr* e = reinterpret_cast<ErrMgr*>(cinfo->err);
  longjmp(e->jump, 1);
}

// Decode one JPEG to RGB8. Returns false on any decode error.
bool decode_jpeg(const char* path, int target, std::vector<unsigned char>& rgb,
                 int& h, int& w) {
  FILE* f = std::fopen(path, "rb");
  if (!f) return false;

  jpeg_decompress_struct cinfo;
  ErrMgr jerr;
  cinfo.err = jpeg_std_error(&jerr.pub);
  jerr.pub.error_exit = err_exit;
  if (setjmp(jerr.jump)) {
    jpeg_destroy_decompress(&cinfo);
    std::fclose(f);
    return false;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_stdio_src(&cinfo, f);
  jpeg_read_header(&cinfo, TRUE);
  cinfo.out_color_space = JCS_RGB;

  // DCT-domain prescale: pick the largest 1/2^k with max-side still >= target
  if (target > 0) {
    int full = std::max<int>(cinfo.image_width, cinfo.image_height);
    int denom = 1;
    while (denom < 8 && full / (denom * 2) >= target) denom *= 2;
    cinfo.scale_num = 1;
    cinfo.scale_denom = denom;
  }

  jpeg_start_decompress(&cinfo);
  w = cinfo.output_width;
  h = cinfo.output_height;
  rgb.resize(static_cast<size_t>(h) * w * 3);
  const int stride = w * 3;
  while (static_cast<int>(cinfo.output_scanline) < h) {
    unsigned char* row = rgb.data() + static_cast<size_t>(cinfo.output_scanline) * stride;
    jpeg_read_scanlines(&cinfo, &row, 1);
  }
  jpeg_finish_decompress(&cinfo);
  jpeg_destroy_decompress(&cinfo);
  std::fclose(f);
  return true;
}

// Area-averaged (box-filter) resample RGB8 -> float32 [0, 1].
void resize_area(const unsigned char* src, int sh, int sw, float* dst, int dh,
                 int dw) {
  const float sy = static_cast<float>(sh) / dh;
  const float sx = static_cast<float>(sw) / dw;
  for (int y = 0; y < dh; ++y) {
    const float y0f = y * sy, y1f = std::min<float>((y + 1) * sy, sh);
    const int y0 = static_cast<int>(y0f);
    const int y1 = std::max(y0 + 1, static_cast<int>(std::ceil(y1f)));
    for (int x = 0; x < dw; ++x) {
      const float x0f = x * sx, x1f = std::min<float>((x + 1) * sx, sw);
      const int x0 = static_cast<int>(x0f);
      const int x1 = std::max(x0 + 1, static_cast<int>(std::ceil(x1f)));
      float acc[3] = {0, 0, 0};
      float area = 0;
      for (int yy = y0; yy < y1 && yy < sh; ++yy) {
        const float wy = std::min<float>(yy + 1, y1f) - std::max<float>(yy, y0f);
        for (int xx = x0; xx < x1 && xx < sw; ++xx) {
          const float wx =
              std::min<float>(xx + 1, x1f) - std::max<float>(xx, x0f);
          const float ww = wy * wx;
          const unsigned char* p =
              src + (static_cast<size_t>(yy) * sw + xx) * 3;
          acc[0] += ww * p[0];
          acc[1] += ww * p[1];
          acc[2] += ww * p[2];
          area += ww;
        }
      }
      float* q = dst + (static_cast<size_t>(y) * dw + x) * 3;
      const float inv = area > 0 ? 1.0f / (255.0f * area) : 0.0f;
      q[0] = acc[0] * inv;
      q[1] = acc[1] * inv;
      q[2] = acc[2] * inv;
    }
  }
}

}  // namespace

extern "C" {

// Decode + thumbnail a batch. out: (n, imsize, imsize, 3) float32, zero-
// padded; hw: (n, 2) int32 actual thumbnail sizes, (0, 0) on failure.
// Thumbnail semantics = PIL imthumbnail: only shrink, keep aspect, max side
// == imsize (ties to data/images.py:load_test_image).
void decode_thumbnail_batch(const char** paths, int n, int imsize, float* out,
                            int* hw, int n_threads) {
  std::atomic<int> next(0);
  const size_t canvas = static_cast<size_t>(imsize) * imsize * 3;
  std::memset(out, 0, sizeof(float) * canvas * n);

  auto worker = [&]() {
    std::vector<unsigned char> rgb;
    for (int i = next.fetch_add(1); i < n; i = next.fetch_add(1)) {
      int h = 0, w = 0;
      hw[2 * i] = hw[2 * i + 1] = 0;
      // an exception escaping a thread entry calls std::terminate — a
      // crafted header declaring e.g. 65500x65500 can make the decode
      // buffers throw bad_alloc; report failure (PIL fallback) instead
      try {
      if (!decode_jpeg(paths[i], imsize, rgb, h, w)) continue;
      int th = h, tw = w;
      const int full = std::max(h, w);
      if (full > imsize) {  // thumbnail only shrinks
        const double s = static_cast<double>(imsize) / full;
        th = std::max(1, static_cast<int>(std::lround(h * s)));
        tw = std::max(1, static_cast<int>(std::lround(w * s)));
        th = std::min(th, imsize);
        tw = std::min(tw, imsize);
        // resample directly into the canvas row-major window
        std::vector<float> tmp(static_cast<size_t>(th) * tw * 3);
        resize_area(rgb.data(), h, w, tmp.data(), th, tw);
        for (int y = 0; y < th; ++y)
          std::memcpy(out + canvas * i + (static_cast<size_t>(y) * imsize) * 3,
                      tmp.data() + static_cast<size_t>(y) * tw * 3,
                      sizeof(float) * tw * 3);
      } else {
        for (int y = 0; y < th; ++y) {
          float* q = out + canvas * i + (static_cast<size_t>(y) * imsize) * 3;
          const unsigned char* p = rgb.data() + static_cast<size_t>(y) * w * 3;
          for (int x = 0; x < tw * 3; ++x) q[x] = p[x] / 255.0f;
        }
      }
      hw[2 * i] = th;
      hw[2 * i + 1] = tw;
      } catch (...) {
        hw[2 * i] = hw[2 * i + 1] = 0;
      }
    }
  };

  const int t = std::max(1, n_threads);
  std::vector<std::thread> pool;
  pool.reserve(t);
  for (int k = 0; k < t; ++k) pool.emplace_back(worker);
  for (auto& th : pool) th.join();
}

}  // extern "C"
