// Fast host-side image resizing for the data pipeline.
//
// The reference's data layer resizes every 4K source image into 10 LR/HR
// pairs through PIL (data_class.py:61-68) — the host-side hot op of both
// dataset classes and the streaming preprocessor. This library implements
// the same separable antialiased bilinear resampling (PIL/torchvision
// semantics: support widened by the downscale factor, per-pixel weight
// normalization) as a C++ shared object with OpenMP row parallelism,
// exposed through ctypes (transformerupscaler_torch/native.py, which builds
// it at first use into build/torch_native/). The port's own copy of the JAX
// package's native/resize.cpp, the same source.
//
// Layout: HWC uint8 in -> HWC uint8 or float32 [0,1] out.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <vector>

namespace {

struct Taps {
  // For each output index: first source index and normalized weights.
  std::vector<int> first;
  std::vector<int> count;
  std::vector<float> weights;  // stride = max_count
  int max_count = 0;
};

// PIL-style antialiased triangle (bilinear) taps.
Taps build_taps(int in_size, int out_size) {
  Taps t;
  t.first.resize(out_size);
  t.count.resize(out_size);
  const double scale = static_cast<double>(in_size) / out_size;
  const double filterscale = std::max(scale, 1.0);
  const double support = 1.0 * filterscale;
  t.max_count = static_cast<int>(std::ceil(support)) * 2 + 1;
  t.weights.assign(static_cast<size_t>(out_size) * t.max_count, 0.0f);

  for (int i = 0; i < out_size; ++i) {
    const double center = (i + 0.5) * scale;
    int xmin = static_cast<int>(center - support + 0.5);
    int xmax = static_cast<int>(center + support + 0.5);
    xmin = std::max(xmin, 0);
    xmax = std::min(xmax, in_size);
    double total = 0.0;
    std::vector<double> w(xmax - xmin);
    for (int x = xmin; x < xmax; ++x) {
      double d = (x + 0.5 - center) / filterscale;
      double v = std::max(0.0, 1.0 - std::fabs(d));
      w[x - xmin] = v;
      total += v;
    }
    if (total == 0.0) total = 1.0;
    t.first[i] = xmin;
    t.count[i] = xmax - xmin;
    for (int x = xmin; x < xmax; ++x) {
      t.weights[static_cast<size_t>(i) * t.max_count + (x - xmin)] =
          static_cast<float>(w[x - xmin] / total);
    }
  }
  return t;
}

}  // namespace

extern "C" {

// src: (in_h, in_w, c) uint8; dst: (out_h, out_w, c) uint8.
// Returns 0 on success.
int tux_resize_bilinear_u8(const uint8_t* src, int in_h, int in_w, int c,
                           uint8_t* dst, int out_h, int out_w) {
  if (c <= 0 || c > 16) return 1;
  const Taps th = build_taps(in_h, out_h);
  const Taps tw = build_taps(in_w, out_w);

  // Horizontal pass: (in_h, out_w, c) float.
  std::vector<float> tmp(static_cast<size_t>(in_h) * out_w * c);
#pragma omp parallel for schedule(static)
  for (int y = 0; y < in_h; ++y) {
    const uint8_t* row = src + static_cast<size_t>(y) * in_w * c;
    float* orow = tmp.data() + static_cast<size_t>(y) * out_w * c;
    for (int x = 0; x < out_w; ++x) {
      const float* w = tw.weights.data() + static_cast<size_t>(x) * tw.max_count;
      const int f = tw.first[x], n = tw.count[x];
      for (int ch = 0; ch < c; ++ch) {
        float acc = 0.0f;
        for (int k = 0; k < n; ++k)
          acc += w[k] * row[(f + k) * c + ch];
        orow[x * c + ch] = acc;
      }
    }
  }

  // Vertical pass + round to uint8.
#pragma omp parallel for schedule(static)
  for (int y = 0; y < out_h; ++y) {
    const float* w = th.weights.data() + static_cast<size_t>(y) * th.max_count;
    const int f = th.first[y], n = th.count[y];
    uint8_t* orow = dst + static_cast<size_t>(y) * out_w * c;
    for (int x = 0; x < out_w; ++x) {
      for (int ch = 0; ch < c; ++ch) {
        float acc = 0.0f;
        for (int k = 0; k < n; ++k)
          acc += w[k] * tmp[(static_cast<size_t>(f + k) * out_w + x) * c + ch];
        int v = static_cast<int>(acc + 0.5f);
        orow[x * c + ch] = static_cast<uint8_t>(std::clamp(v, 0, 255));
      }
    }
  }
  return 0;
}

// Same, but emits float32 in [0, 1] (fused normalize — saves one pass for
// the model input path).
int tux_resize_bilinear_u8_to_f32(const uint8_t* src, int in_h, int in_w,
                                  int c, float* dst, int out_h, int out_w) {
  if (c <= 0 || c > 16) return 1;
  const Taps th = build_taps(in_h, out_h);
  const Taps tw = build_taps(in_w, out_w);

  std::vector<float> tmp(static_cast<size_t>(in_h) * out_w * c);
#pragma omp parallel for schedule(static)
  for (int y = 0; y < in_h; ++y) {
    const uint8_t* row = src + static_cast<size_t>(y) * in_w * c;
    float* orow = tmp.data() + static_cast<size_t>(y) * out_w * c;
    for (int x = 0; x < out_w; ++x) {
      const float* w = tw.weights.data() + static_cast<size_t>(x) * tw.max_count;
      const int f = tw.first[x], n = tw.count[x];
      for (int ch = 0; ch < c; ++ch) {
        float acc = 0.0f;
        for (int k = 0; k < n; ++k)
          acc += w[k] * row[(f + k) * c + ch];
        orow[x * c + ch] = acc;
      }
    }
  }

#pragma omp parallel for schedule(static)
  for (int y = 0; y < out_h; ++y) {
    const float* w = th.weights.data() + static_cast<size_t>(y) * th.max_count;
    const int f = th.first[y], n = th.count[y];
    float* orow = dst + static_cast<size_t>(y) * out_w * c;
    for (int x = 0; x < out_w; ++x) {
      for (int ch = 0; ch < c; ++ch) {
        float acc = 0.0f;
        for (int k = 0; k < n; ++k)
          acc += w[k] * tmp[(static_cast<size_t>(f + k) * out_w + x) * c + ch];
        orow[x * c + ch] = acc * (1.0f / 255.0f);
      }
    }
  }
  return 0;
}

}  // extern "C"
