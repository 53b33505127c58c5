// The port's threaded JPEG decoder: each image of a batch is decoded once
// with libjpeg and resized to the canonical square, straight into a
// caller-owned uint8 arena, [N, S, S, 3] (HWC) or [N, 3, S, S] (planar,
// the preprocess kernel's layout).
//
// Its bytes are the JAX package's decoder's, so that both packages train
// on the same pixels:
//  - libjpeg's DCT scaling decodes at 1/2, 1/4 or 1/8 of the source when
//    that stays at or above the target on both sides, which skips most
//    of the IDCT of a large frame;
//  - the output is JCS_RGB; a grayscale frame is replicated to three
//    channels;
//  - a downscale is a float box filter (area average, OpenCV INTER_AREA's
//    class), an upscale a bilinear resize (INTER_LINEAR's), both rounded
//    with +0.5f;
//  - a file that fails to open or decode leaves its slot zero-filled and
//    its index reported.
// A pool of threads takes the images in turn from an atomic index, with
// no Python in the loop: the caller's batch call runs without the GIL.
//
// Built at first use by ops/kernels/build.py (g++ -O3 -shared, -ljpeg).

// jpeglib.h uses size_t and FILE without including their headers
#include <cstddef>
#include <cstdio>

#include <jpeglib.h>

#include <atomic>
#include <cmath>
#include <csetjmp>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

namespace {

struct ErrorMgr {
  jpeg_error_mgr pub;
  jmp_buf setjmp_buffer;
};

void error_exit(j_common_ptr cinfo) {
  ErrorMgr* err = reinterpret_cast<ErrorMgr*>(cinfo->err);
  longjmp(err->setjmp_buffer, 1);
}

// Where a resized image goes: channel c of pixel p at
// base[p * pixel_stride + c * channel_stride].
struct Dest {
  uint8_t* base;
  size_t pixel_stride;
  size_t channel_stride;

  uint8_t& at(size_t pixel, int c) const {
    return base[pixel * pixel_stride + c * channel_stride];
  }
};

uint8_t round_u8(float v) {
  return (uint8_t)(v < 0 ? 0 : (v > 255 ? 255 : v + 0.5f));
}

// Decode one JPEG file to interleaved RGB at the smallest DCT scale that
// keeps both sides >= target. Returns an empty vector on failure.
std::vector<uint8_t> decode_jpeg(const char* path, int target, int* out_w,
                                 int* out_h) {
  FILE* f = std::fopen(path, "rb");
  if (!f) return {};

  jpeg_decompress_struct cinfo;
  ErrorMgr jerr;
  cinfo.err = jpeg_std_error(&jerr.pub);
  jerr.pub.error_exit = error_exit;
  std::vector<uint8_t> pixels;
  if (setjmp(jerr.setjmp_buffer)) {
    jpeg_destroy_decompress(&cinfo);
    std::fclose(f);
    return {};
  }
  jpeg_create_decompress(&cinfo);
  jpeg_stdio_src(&cinfo, f);
  jpeg_read_header(&cinfo, TRUE);
  cinfo.out_color_space = JCS_RGB;

  int denom = 1;
  while (denom < 8 && (int)cinfo.image_width / (denom * 2) >= target &&
         (int)cinfo.image_height / (denom * 2) >= target) {
    denom *= 2;
  }
  cinfo.scale_num = 1;
  cinfo.scale_denom = denom;

  jpeg_start_decompress(&cinfo);
  const int w = cinfo.output_width;
  const int h = cinfo.output_height;
  const int stride = w * cinfo.output_components;
  pixels.resize((size_t)h * stride);
  while ((int)cinfo.output_scanline < h) {
    uint8_t* row = pixels.data() + (size_t)cinfo.output_scanline * stride;
    jpeg_read_scanlines(&cinfo, &row, 1);
  }
  jpeg_finish_decompress(&cinfo);
  jpeg_destroy_decompress(&cinfo);
  std::fclose(f);

  if (cinfo.output_components != 3) {
    std::vector<uint8_t> rgb((size_t)h * w * 3);
    for (size_t i = 0; i < (size_t)h * w; ++i) {
      rgb[3 * i] = rgb[3 * i + 1] = rgb[3 * i + 2] = pixels[i];
    }
    pixels.swap(rgb);
  }
  *out_w = w;
  *out_h = h;
  return pixels;
}

// Bilinear resize with half-pixel centres, edges clamped.
void resize_bilinear(const uint8_t* src, int sw, int sh, const Dest& dst,
                     int size) {
  const float sx = (float)sw / size;
  const float sy = (float)sh / size;
  for (int oy = 0; oy < size; ++oy) {
    float fy = (oy + 0.5f) * sy - 0.5f;
    int y0 = (int)std::floor(fy);
    float wy = fy - y0;
    int y1 = y0 + 1;
    if (y0 < 0) { y0 = 0; y1 = 0; wy = 0; }
    if (y1 >= sh) { y1 = sh - 1; if (y0 > y1) y0 = y1; }
    for (int ox = 0; ox < size; ++ox) {
      float fx = (ox + 0.5f) * sx - 0.5f;
      int x0 = (int)std::floor(fx);
      float wx = fx - x0;
      int x1 = x0 + 1;
      if (x0 < 0) { x0 = 0; x1 = 0; wx = 0; }
      if (x1 >= sw) { x1 = sw - 1; if (x0 > x1) x0 = x1; }
      const uint8_t* p00 = src + ((size_t)y0 * sw + x0) * 3;
      const uint8_t* p01 = src + ((size_t)y0 * sw + x1) * 3;
      const uint8_t* p10 = src + ((size_t)y1 * sw + x0) * 3;
      const uint8_t* p11 = src + ((size_t)y1 * sw + x1) * 3;
      const size_t p = (size_t)oy * size + ox;
      for (int c = 0; c < 3; ++c) {
        float v = (1 - wy) * ((1 - wx) * p00[c] + wx * p01[c]) +
                  wy * ((1 - wx) * p10[c] + wx * p11[c]);
        dst.at(p, c) = round_u8(v);
      }
    }
  }
}

// Exact-size resize: the area average of the source pixels each output
// pixel covers (fractional edges weighted) for a downscale; bilinear
// where either side grows; a copy where the size already matches.
void resize(const uint8_t* src, int sw, int sh, const Dest& dst, int size) {
  if (sw == size && sh == size) {
    for (size_t p = 0; p < (size_t)size * size; ++p) {
      for (int c = 0; c < 3; ++c) dst.at(p, c) = src[3 * p + c];
    }
    return;
  }
  if (sw < size || sh < size) {
    resize_bilinear(src, sw, sh, dst, size);
    return;
  }
  const float sx = (float)sw / size;
  const float sy = (float)sh / size;
  for (int oy = 0; oy < size; ++oy) {
    float fy0 = oy * sy, fy1 = (oy + 1) * sy;
    int y0 = (int)fy0;
    int y1 = (int)std::ceil(fy1);
    if (y1 > sh) y1 = sh;
    if (y1 <= y0) y1 = y0 + 1;
    for (int ox = 0; ox < size; ++ox) {
      float fx0 = ox * sx, fx1 = (ox + 1) * sx;
      int x0 = (int)fx0;
      int x1 = (int)std::ceil(fx1);
      if (x1 > sw) x1 = sw;
      if (x1 <= x0) x1 = x0 + 1;
      float acc[3] = {0, 0, 0};
      float total = 0.f;
      for (int y = y0; y < y1; ++y) {
        float wy = 1.f;
        if (y < fy0) wy -= (fy0 - y);
        if (y + 1 > fy1) wy -= (y + 1 - fy1);
        if (wy <= 0) continue;
        for (int x = x0; x < x1; ++x) {
          float wx = 1.f;
          if (x < fx0) wx -= (fx0 - x);
          if (x + 1 > fx1) wx -= (x + 1 - fx1);
          if (wx <= 0) continue;
          const float w = wx * wy;
          const uint8_t* q = src + ((size_t)y * sw + x) * 3;
          acc[0] += w * q[0];
          acc[1] += w * q[1];
          acc[2] += w * q[2];
          total += w;
        }
      }
      const size_t p = (size_t)oy * size + ox;
      for (int c = 0; c < 3; ++c) {
        dst.at(p, c) = round_u8(total > 0 ? acc[c] / total : 0.f);
      }
    }
  }
}

}  // namespace

extern "C" {

// Decode n images into out (uint8, caller-allocated, n * size * size * 3
// bytes): planar == 0 gives out[N, size, size, 3], planar != 0 gives
// out[N, 3, size, size]. Returns the number of images decoded. A failed
// slot is zero-filled and its index written to failed_idx (capacity n;
// may be null); n_failed receives their count.
int sia_decode_batch(const char** paths, int n, uint8_t* out, int size,
                     int n_threads, int* failed_idx, int* n_failed,
                     int planar) {
  if (n_threads < 1) n_threads = 1;
  std::atomic<int> next(0), ok(0), fail_count(0);
  const size_t plane = (size_t)size * size;
  const size_t per_img = plane * 3;

  auto worker = [&]() {
    for (;;) {
      int i = next.fetch_add(1);
      if (i >= n) break;
      int w = 0, h = 0;
      std::vector<uint8_t> img = decode_jpeg(paths[i], size, &w, &h);
      uint8_t* slot = out + (size_t)i * per_img;
      if (img.empty()) {
        std::memset(slot, 0, per_img);
        int k = fail_count.fetch_add(1);
        if (failed_idx) failed_idx[k] = i;
        continue;
      }
      const Dest dst = planar ? Dest{slot, 1, plane} : Dest{slot, 3, 1};
      resize(img.data(), w, h, dst, size);
      ok.fetch_add(1);
    }
  };

  std::vector<std::thread> threads;
  const int nt = n_threads > n ? (n > 0 ? n : 1) : n_threads;
  threads.reserve(nt);
  for (int t = 0; t < nt; ++t) threads.emplace_back(worker);
  for (auto& t : threads) t.join();
  if (n_failed) *n_failed = fail_count.load();
  return ok.load();
}

}  // extern "C"
