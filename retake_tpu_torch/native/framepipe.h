// The port's native host frame pipeline (copy of retake_tpu/native/framepipe.cpp,
// split in two translation units): framepipe_patch.cpp needs only a C++
// compiler, framepipe_jpeg.cpp also needs libjpeg's headers and library.
#pragma once

#include <cstdint>

extern "C" {

// NEAREST resize of one RGB uint8 frame (PIL-compatible pixel centers).
void rt_resize_nearest(const uint8_t* src, int sh, int sw, uint8_t* dst, int dh, int dw);

// Qwen2-VL normalize + patchify of [T, H, W, 3] uint8 frames.
int rt_patchify_qwen(const uint8_t* frames, int T, int H, int W, int ps, int tps, int merge,
                     const float* mean, const float* std_, float* out, int threads);

// Decode one JPEG file into RGB uint8 (libjpeg).
int rt_decode_jpeg(const char* path, uint8_t* out, long cap, int* w, int* h);

// Decode n JPEG files and longest-side resize into [n, out_h, out_w, 3].
int rt_load_frames(const char* paths, int n, int resolution, uint8_t* out, int* out_h,
                   int* out_w, int threads);

}  // extern "C"
