// Native LF loader: multi-threaded PNG decode into a contiguous float32
// light-field tensor.
//
// The reference's native IO layer is io_png.c, a libpng wrapper decoding one
// sub-aperture image at a time on the CLI thread (SURVEY.md §2 #6). A light
// field is 81+ files; Python/PIL decodes them serially at ~10 MB/s-class
// throughput, which starves the device pipeline in streaming mode (driver
// config 5). This module is the parallel equivalent: a C++ thread pool
// decodes every SAI in parallel straight into the caller-provided float
// buffer in the pipeline's [aH, aW, H, W, C] layout and [0, 255] scale
// (16-bit samples divided by 257, matching lfbm5d_tpu.lf.io).
//
// Exposed as a plain C ABI for ctypes (no pybind11 in this image):
//   int lf_load_png(const char** paths, int n, float* out,
//                   int h, int w, int c, int* err_index);
// Returns 0 on success; on failure, err_index names the offending file.
//
// Build: make -C lfbm5d_tpu/native   (links -lpng -lpthread)

#include <png.h>

#include <atomic>
#include <cmath>
#include <cstdio>
#include <cstring>
#include <thread>
#include <vector>

namespace {

// Decode one PNG into out[h*w*c] floats in [0,255]. Returns 0 on success.
int decode_one(const char* path, float* out, int h, int w, int c) {
  FILE* fp = std::fopen(path, "rb");
  if (!fp) return 1;
  png_structp png =
      png_create_read_struct(PNG_LIBPNG_VER_STRING, nullptr, nullptr, nullptr);
  if (!png) {
    std::fclose(fp);
    return 2;
  }
  png_infop info = png_create_info_struct(png);
  if (!info || setjmp(png_jmpbuf(png))) {
    png_destroy_read_struct(&png, &info, nullptr);
    std::fclose(fp);
    return 3;
  }
  png_init_io(png, fp);
  png_read_info(png, info);

  const int bit_depth = png_get_bit_depth(png, info);
  const int color_type = png_get_color_type(png, info);
  if (color_type == PNG_COLOR_TYPE_PALETTE) png_set_palette_to_rgb(png);
  if (color_type == PNG_COLOR_TYPE_GRAY && bit_depth < 8)
    png_set_expand_gray_1_2_4_to_8(png);
  if (png_get_valid(png, info, PNG_INFO_tRNS)) png_set_tRNS_to_alpha(png);
  png_set_strip_alpha(png);
  if (c == 3 &&
      (color_type == PNG_COLOR_TYPE_GRAY ||
       color_type == PNG_COLOR_TYPE_GRAY_ALPHA))
    png_set_gray_to_rgb(png);
  if (c == 1 &&
      (color_type == PNG_COLOR_TYPE_RGB ||
       color_type == PNG_COLOR_TYPE_RGB_ALPHA ||
       color_type == PNG_COLOR_TYPE_PALETTE))
    png_set_rgb_to_gray_fixed(png, 1, -1, -1);
  // keep 16-bit as big-endian pairs; swap to host order below
  if (bit_depth == 16) png_set_swap(png);
  png_read_update_info(png, info);

  const png_uint_32 ih = png_get_image_height(png, info);
  const png_uint_32 iw = png_get_image_width(png, info);
  const int channels = png_get_channels(png, info);
  const int depth = png_get_bit_depth(png, info);
  if ((int)ih != h || (int)iw != w || channels != c) {
    png_destroy_read_struct(&png, &info, nullptr);
    std::fclose(fp);
    return 4;
  }

  const size_t row_bytes = png_get_rowbytes(png, info);
  std::vector<unsigned char> row(row_bytes);
  const float scale16 = 1.0f / 257.0f;
  for (int y = 0; y < h; ++y) {
    png_read_row(png, row.data(), nullptr);
    float* dst = out + (size_t)y * w * c;
    if (depth == 16) {
      const unsigned short* src = (const unsigned short*)row.data();
      for (int i = 0; i < w * c; ++i) dst[i] = (float)src[i] * scale16;
    } else {
      const unsigned char* src = row.data();
      for (int i = 0; i < w * c; ++i) dst[i] = (float)src[i];
    }
  }
  png_read_end(png, nullptr);
  png_destroy_read_struct(&png, &info, nullptr);
  std::fclose(fp);
  return 0;
}

// Encode one SAI plane (floats in [0,255]) to a PNG file. bit_depth 8 or
// 16 (16-bit samples scaled by 257, the inverse of the loader's 1/257).
int encode_one(const char* path, const float* in, int h, int w, int c,
               int bit_depth) {
  FILE* fp = std::fopen(path, "wb");
  if (!fp) return 1;
  png_structp png =
      png_create_write_struct(PNG_LIBPNG_VER_STRING, nullptr, nullptr,
                              nullptr);
  if (!png) {
    std::fclose(fp);
    return 2;
  }
  png_infop info = png_create_info_struct(png);
  if (!info || setjmp(png_jmpbuf(png))) {
    png_destroy_write_struct(&png, &info);
    std::fclose(fp);
    return 3;
  }
  png_init_io(png, fp);
  const int color_type =
      c == 1 ? PNG_COLOR_TYPE_GRAY : PNG_COLOR_TYPE_RGB;
  png_set_IHDR(png, info, w, h, bit_depth, color_type,
               PNG_INTERLACE_NONE, PNG_COMPRESSION_TYPE_DEFAULT,
               PNG_FILTER_TYPE_DEFAULT);
  png_write_info(png, info);
  if (bit_depth == 16) png_set_swap(png);  // host order -> big-endian

  std::vector<unsigned char> row((size_t)w * c * (bit_depth / 8));
  for (int y = 0; y < h; ++y) {
    const float* src = in + (size_t)y * w * c;
    if (bit_depth == 16) {
      unsigned short* dst = (unsigned short*)row.data();
      for (int i = 0; i < w * c; ++i) {
        float v = src[i] * 257.0f + 0.5f;
        if (!std::isfinite(v)) v = 0.f;  // NaN passes both clamps; UB on cast
        dst[i] = (unsigned short)(v < 0.f ? 0.f : (v > 65535.f ? 65535.f : v));
      }
    } else {
      unsigned char* dst = row.data();
      for (int i = 0; i < w * c; ++i) {
        float v = src[i] + 0.5f;
        if (!std::isfinite(v)) v = 0.f;
        dst[i] = (unsigned char)(v < 0.f ? 0.f : (v > 255.f ? 255.f : v));
      }
    }
    png_write_row(png, row.data());
  }
  png_write_end(png, nullptr);
  png_destroy_write_struct(&png, &info);
  std::fclose(fp);
  return 0;
}

}  // namespace

extern "C" {

int lf_load_png(const char** paths, int n, float* out, int h, int w, int c,
                int* err_index) {
  const size_t plane = (size_t)h * w * c;
  const unsigned n_threads =
      std::min<unsigned>(std::max(1u, std::thread::hardware_concurrency()),
                         (unsigned)n);
  std::atomic<int> next(0);
  std::atomic<int> err(0);
  std::atomic<int> err_i(-1);

  auto worker = [&]() {
    for (;;) {
      const int i = next.fetch_add(1);
      if (i >= n || err.load()) return;
      const int rc = decode_one(paths[i], out + plane * i, h, w, c);
      if (rc) {
        err.store(rc);
        err_i.store(i);
        return;
      }
    }
  };
  std::vector<std::thread> pool;
  for (unsigned t = 0; t < n_threads; ++t) pool.emplace_back(worker);
  for (auto& t : pool) t.join();
  if (err_index) *err_index = err_i.load();
  return err.load();
}

// Thread-pooled encoder: the write-side twin of lf_load_png (the
// reference's io_png.c exposes both directions, SURVEY.md §2 #6).
int lf_save_png(const char** paths, int n, const float* in, int h, int w,
                int c, int bit_depth, int* err_index) {
  if (bit_depth != 8 && bit_depth != 16) return 5;
  const size_t plane = (size_t)h * w * c;
  const unsigned n_threads =
      std::min<unsigned>(std::max(1u, std::thread::hardware_concurrency()),
                         (unsigned)n);
  std::atomic<int> next(0);
  std::atomic<int> err(0);
  std::atomic<int> err_i(-1);

  auto worker = [&]() {
    for (;;) {
      const int i = next.fetch_add(1);
      if (i >= n || err.load()) return;
      const int rc = encode_one(paths[i], in + plane * i, h, w, c, bit_depth);
      if (rc) {
        err.store(rc);
        err_i.store(i);
        return;
      }
    }
  };
  std::vector<std::thread> pool;
  for (unsigned t = 0; t < n_threads; ++t) pool.emplace_back(worker);
  for (auto& t : pool) t.join();
  if (err_index) *err_index = err_i.load();
  return err.load();
}

}  // extern "C"
