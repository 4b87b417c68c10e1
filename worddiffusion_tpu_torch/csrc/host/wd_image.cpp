// Copy of native/src/wd_image.cpp (the JAX repo's host image pass), built by worddiffusion_tpu_torch/data/native.py.
// wd_image: native batch image preprocessing for the input pipeline.
//
// The reference does per-image PIL work inside the DataLoader; at TPU
// training rates the host becomes the bottleneck. These kernels fuse
// the dataset's fixed preprocessing (aspect-preserving bilinear resize
// to target height, white right-pad to target width, [-1,1] normalize)
// into one float-producing pass over whole batches with OpenMP,
// exposed through a C ABI for ctypes.
//
// Build: make -C native  (produces native/libwdimage.so)

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <vector>

#ifdef _OPENMP
#include <omp.h>
#endif

extern "C" {

// One word crop -> fixed [th, tw, c] float32 canvas in [-1, 1]:
// bilinear scale to target height (clamp width), right-pad with white.
// Fused resize+normalize: reads uint8 once, writes float32 once.
void wd_resize_pad_normalize(const uint8_t* src, int sh, int sw, int c,
                             float* dst, int th, int tw) {
  int new_w = (int)std::lround((double)sw * th / sh);
  new_w = std::max(1, std::min(new_w, tw));

  const float ys = th > 1 ? float(sh - 1) / float(th - 1) : 0.f;
  const float xs = new_w > 1 ? float(sw - 1) / float(new_w - 1) : 0.f;

  // precompute column sampling (x0, wx) once
  std::vector<int> x0v(new_w);
  std::vector<float> wxv(new_w);
  for (int x = 0; x < new_w; ++x) {
    const float fx = x * xs;
    int x0 = (int)fx;
    if (x0 > sw - 2) x0 = sw > 1 ? sw - 2 : 0;
    x0v[x] = x0;
    wxv[x] = fx - x0;
  }

  // true division: 255/255.f == 1.f exactly (a reciprocal multiply
  // rounds 255 * fl(1/255) up to 1.0000001, escaping [-1, 1])
  for (int y = 0; y < th; ++y) {
    const float fy = y * ys;
    int y0 = (int)fy;
    if (y0 > sh - 2) y0 = sh > 1 ? sh - 2 : 0;
    const float wy = fy - y0;
    const uint8_t* r0 = src + (size_t)y0 * sw * c;
    const uint8_t* r1 = src + (size_t)std::min(y0 + 1, sh - 1) * sw * c;
    float* row = dst + (size_t)y * tw * c;

    for (int x = 0; x < new_w; ++x) {
      const int o0 = x0v[x] * c;
      const int o1 = o0 + (x0v[x] + 1 < sw ? c : 0);
      const float wx = wxv[x];
      for (int k = 0; k < c; ++k) {
        const float v0 = r0[o0 + k] + (r0[o1 + k] - r0[o0 + k]) * wx;
        const float v1 = r1[o0 + k] + (r1[o1 + k] - r1[o0 + k]) * wx;
        row[x * c + k] = ((v0 + (v1 - v0) * wy) / 255.0f - 0.5f) * 2.0f;
      }
    }
    for (int x = new_w * c; x < tw * c; ++x) row[x] = 1.0f;  // white pad
  }
}

// Batch variant over variable-size images packed at offsets[i].
void wd_batch_resize_pad_normalize(const uint8_t* src, const int64_t* offsets,
                                   const int32_t* shapes /* [n][2] h,w */,
                                   int n, int c, float* dst, int th, int tw) {
  const size_t out_stride = (size_t)th * tw * c;
#ifdef _OPENMP
#pragma omp parallel for schedule(dynamic)
#endif
  for (int i = 0; i < n; ++i) {
    wd_resize_pad_normalize(src + offsets[i], shapes[2 * i], shapes[2 * i + 1],
                            c, dst + i * out_stride, th, tw);
  }
}

// uint8 HWC batch -> float32 [-1,1] (same shape).
void wd_batch_normalize(const uint8_t* src, float* dst, int64_t count) {
#ifdef _OPENMP
#pragma omp parallel for schedule(static)
#endif
  for (int64_t i = 0; i < count; ++i)
    dst[i] = (src[i] / 255.0f - 0.5f) * 2.0f;
}

// float [0,1] batch -> uint8 (PNG write prep).
void wd_batch_denormalize(const float* src, uint8_t* dst, int64_t count) {
#ifdef _OPENMP
#pragma omp parallel for schedule(static)
#endif
  for (int64_t i = 0; i < count; ++i) {
    float v = src[i];
    v = v < 0.f ? 0.f : (v > 1.f ? 1.f : v);
    dst[i] = (uint8_t)(v * 255.0f + 0.5f);
  }
}

// Vertical white eraser lines (augmentation; uint8 HWC in-place).
void wd_vertical_lines(uint8_t* img, int h, int w, int c,
                       const int32_t* xs, int n_lines, uint8_t value) {
  for (int j = 0; j < n_lines; ++j) {
    const int x = xs[j];
    if (x < 0 || x >= w) continue;
    for (int y = 0; y < h; ++y)
      for (int k = 0; k < c; ++k) img[(y * (size_t)w + x) * c + k] = value;
  }
}

int wd_version() { return 1; }

}  // extern "C"
