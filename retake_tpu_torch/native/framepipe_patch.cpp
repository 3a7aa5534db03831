// Native host frame pipeline, the half that needs only a C++ compiler:
// longest-side NEAREST resize and the Qwen2-VL patchify (uint8 frames ->
// normalized float32 flattened patches in the spatial-merge block order,
// rescale + normalize + the 9-D transpose in one pass). The arithmetic is
// retake_tpu/native/framepipe.cpp's, built with the same flags, so the
// patches are bit-identical to the JAX package's native path.

#include "framepipe.h"

#include <algorithm>
#include <atomic>
#include <cstring>
#include <thread>
#include <vector>

extern "C" {

// NEAREST resize (PIL-compatible pixel centers: src = floor((i+0.5)*scale)).
void rt_resize_nearest(const uint8_t* src, int sh, int sw, uint8_t* dst,
                       int dh, int dw) {
  std::vector<int> xmap(dw);
  const double sx = (double)sw / dw, sy = (double)sh / dh;
  for (int x = 0; x < dw; ++x) {
    int v = (int)((x + 0.5) * sx);
    xmap[x] = std::min(v, sw - 1);
  }
  for (int y = 0; y < dh; ++y) {
    int syi = std::min((int)((y + 0.5) * sy), sh - 1);
    const uint8_t* srow = src + (long)syi * sw * 3;
    uint8_t* drow = dst + (long)y * dw * 3;
    for (int x = 0; x < dw; ++x) {
      memcpy(drow + x * 3, srow + xmap[x] * 3, 3);
    }
  }
}

// Qwen2-VL patchify: frames [T, H, W, 3] uint8 (H, W multiples of ps*merge)
// -> out float32 [grid_t * gh * gw, 3 * tps * ps * ps] in spatial-merge block
// order, normalized (x/255 - mean) / std. Temporal tail repeats last frame.
int rt_patchify_qwen(const uint8_t* frames, int T, int H, int W, int ps,
                     int tps, int merge, const float* mean, const float* std_,
                     float* out, int threads) {
  const int gh = H / ps, gw = W / ps;
  const int grid_t = (T + tps - 1) / tps;
  const int row_len = 3 * tps * ps * ps;
  const long frame_px = (long)H * W * 3;
  float inv255_scale[3], bias[3];
  for (int c = 0; c < 3; ++c) {
    inv255_scale[c] = 1.0f / (255.0f * std_[c]);
    bias[c] = -mean[c] / std_[c];
  }
  std::atomic<int> next(0);
  auto worker = [&]() {
    while (true) {
      int gt = next.fetch_add(1);
      if (gt >= grid_t) break;
      for (int hb = 0; hb < gh / merge; ++hb) {
        for (int wb = 0; wb < gw / merge; ++wb) {
          for (int mh = 0; mh < merge; ++mh) {
            for (int mw = 0; mw < merge; ++mw) {
              const int ph_idx = hb * merge + mh;  // patch row
              const int pw_idx = wb * merge + mw;  // patch col
              const long row_idx =
                  ((long)gt * (gh / merge) * (gw / merge) + (long)hb * (gw / merge) + wb) *
                      merge * merge +
                  mh * merge + mw;
              float* dst = out + row_idx * row_len;
              // row layout: [c][t in tps][ps][ps]
              for (int c = 0; c < 3; ++c) {
                for (int dt = 0; dt < tps; ++dt) {
                  int t = std::min(gt * tps + dt, T - 1);
                  const uint8_t* fr = frames + (long)t * frame_px;
                  for (int py = 0; py < ps; ++py) {
                    const uint8_t* srow =
                        fr + ((long)(ph_idx * ps + py) * W + pw_idx * ps) * 3;
                    float* drow =
                        dst + ((c * tps + dt) * ps + py) * ps;
                    for (int px = 0; px < ps; ++px) {
                      drow[px] =
                          srow[px * 3 + c] * inv255_scale[c] + bias[c];
                    }
                  }
                }
              }
            }
          }
        }
      }
    }
  };
  int nt = std::max(1, std::min(threads, grid_t));
  std::vector<std::thread> pool;
  for (int t = 0; t < nt; ++t) pool.emplace_back(worker);
  for (auto& t : pool) t.join();
  return 0;
}

}  // extern "C"
