// Native host frame pipeline, the half that needs libjpeg: multi-threaded
// JPEG decode of pre-extracted frames and the longest-side NEAREST
// downscale (rt_resize_nearest, framepipe_patch.cpp). The decode is
// retake_tpu/native/framepipe.cpp's (RGB out, libjpeg's default DCT and
// upsampling), with one difference: a fatal libjpeg error returns an error
// code through setjmp instead of exiting the process (libjpeg's default
// error_exit), so the caller can take its PIL path.

#include "framepipe.h"

#include <cstddef>
#include <cstdio>

#include <jpeglib.h>

#include <algorithm>
#include <atomic>
#include <csetjmp>
#include <cstring>
#include <thread>
#include <vector>

namespace {

struct ErrorMgr {
  jpeg_error_mgr pub;
  std::jmp_buf jump;
};

void error_exit(j_common_ptr cinfo) {
  std::longjmp(reinterpret_cast<ErrorMgr*>(cinfo->err)->jump, 1);
}

// The image size from the header of one JPEG file; 0 on success.
int probe_size(const char* path, int* w, int* h) {
  FILE* f = fopen(path, "rb");
  if (!f) return -1;
  jpeg_decompress_struct cinfo;
  ErrorMgr err;
  cinfo.err = jpeg_std_error(&err.pub);
  err.pub.error_exit = error_exit;
  if (setjmp(err.jump)) {
    jpeg_destroy_decompress(&cinfo);
    fclose(f);
    return -2;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_stdio_src(&cinfo, f);
  jpeg_read_header(&cinfo, TRUE);
  *w = cinfo.image_width;
  *h = cinfo.image_height;
  jpeg_destroy_decompress(&cinfo);
  fclose(f);
  return 0;
}

}  // namespace

extern "C" {

// Decode one JPEG file; writes RGB uint8 into out (caller-allocated, cap
// bytes). Returns 0 on success and fills *w, *h.
int rt_decode_jpeg(const char* path, uint8_t* out, long cap, int* w, int* h) {
  FILE* f = fopen(path, "rb");
  if (!f) return -1;
  jpeg_decompress_struct cinfo;
  ErrorMgr err;
  cinfo.err = jpeg_std_error(&err.pub);
  err.pub.error_exit = error_exit;
  if (setjmp(err.jump)) {
    jpeg_destroy_decompress(&cinfo);
    fclose(f);
    return -2;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_stdio_src(&cinfo, f);
  if (jpeg_read_header(&cinfo, TRUE) != JPEG_HEADER_OK) {
    jpeg_destroy_decompress(&cinfo);
    fclose(f);
    return -2;
  }
  cinfo.out_color_space = JCS_RGB;
  jpeg_start_decompress(&cinfo);
  const long need = (long)cinfo.output_width * cinfo.output_height * 3;
  if (need > cap) {
    jpeg_abort_decompress(&cinfo);
    jpeg_destroy_decompress(&cinfo);
    fclose(f);
    return -3;
  }
  *w = cinfo.output_width;
  *h = cinfo.output_height;
  const int stride = cinfo.output_width * 3;
  while (cinfo.output_scanline < cinfo.output_height) {
    uint8_t* row = out + (long)cinfo.output_scanline * stride;
    jpeg_read_scanlines(&cinfo, &row, 1);
  }
  jpeg_finish_decompress(&cinfo);
  jpeg_destroy_decompress(&cinfo);
  fclose(f);
  return 0;
}

// Decode n JPEG frame files and longest-side resize into a packed
// [n, out_h, out_w, 3] buffer. paths: concatenated NUL-separated strings.
// All frames must share the source dimensions of the first (benchmark frame
// dirs do). Returns 0 on success and fills *out_h/*out_w.
int rt_load_frames(const char* paths, int n, int resolution, uint8_t* out,
                   int* out_h, int* out_w, int threads) {
  std::vector<const char*> files(n);
  const char* p = paths;
  for (int i = 0; i < n; ++i) {
    files[i] = p;
    p += strlen(p) + 1;
  }
  int sw = 0, sh = 0;
  if (probe_size(files[0], &sw, &sh)) return -1;
  int dh = sh, dw = sw;
  if (std::max(sh, sw) > resolution && resolution > 0) {
    double factor = (double)resolution / std::max(sh, sw);
    dw = (int)(sw * factor);
    dh = (int)(sh * factor);
  }
  *out_h = dh;
  *out_w = dw;
  const long frame_bytes = (long)dh * dw * 3;
  std::atomic<int> next(0), err(0);
  auto worker = [&]() {
    std::vector<uint8_t> raw((long)sh * sw * 3);
    while (true) {
      int i = next.fetch_add(1);
      if (i >= n || err.load()) break;
      int w = 0, h = 0;
      if (rt_decode_jpeg(files[i], raw.data(), (long)raw.size(), &w, &h)) {
        err.store(1);
        break;
      }
      if (w != sw || h != sh) {
        err.store(2);
        break;
      }
      if (dh == sh && dw == sw) {
        memcpy(out + (long)i * frame_bytes, raw.data(), frame_bytes);
      } else {
        rt_resize_nearest(raw.data(), sh, sw, out + (long)i * frame_bytes,
                          dh, dw);
      }
    }
  };
  int nt = std::max(1, std::min(threads, n));
  std::vector<std::thread> pool;
  for (int t = 0; t < nt; ++t) pool.emplace_back(worker);
  for (auto& t : pool) t.join();
  return err.load();
}

}  // extern "C"
