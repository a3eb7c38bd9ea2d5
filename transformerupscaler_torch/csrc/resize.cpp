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
//
// tux_resize_bicubic_u8 is PIL's BICUBIC resize of 8-bit images
// (Pillow's libImaging/Resample.c): the cubic filter with a = -0.5 and
// support 2, widened by the scale when downsizing, weights normalized per
// output pixel and then rounded to 22-bit fixed point; the horizontal pass
// first, rounded and clipped to uint8, then the vertical pass; a pass whose
// extent does not change is skipped.

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

constexpr int kPrecisionBits = 32 - 8 - 2;

double bicubic_filter(double x) {
  constexpr double a = -0.5;
  if (x < 0.0) x = -x;
  if (x < 1.0) return ((a + 2.0) * x - (a + 3.0)) * x * x + 1;
  if (x < 2.0) return (((x - 5) * x + 8) * x - 4) * a;
  return 0.0;
}

// PIL's precompute_coeffs + normalize_coeffs_8bpc for the bicubic filter:
// per output index its first source index, its tap count and ksize fixed-
// point weights.
struct FixedTaps {
  std::vector<int> first, count, weights;
  int ksize = 0;
};

FixedTaps bicubic_taps(int in_size, int out_size) {
  FixedTaps t;
  const double scale = static_cast<double>(in_size) / out_size;
  const double filterscale = std::max(scale, 1.0);
  const double support = 2.0 * filterscale;
  t.ksize = static_cast<int>(std::ceil(support)) * 2 + 1;
  t.first.resize(out_size);
  t.count.resize(out_size);
  t.weights.assign(static_cast<size_t>(out_size) * t.ksize, 0);
  std::vector<double> k(t.ksize);
  for (int i = 0; i < out_size; ++i) {
    const double center = (i + 0.5) * scale;
    const double ss = 1.0 / filterscale;
    int xmin = static_cast<int>(center - support + 0.5);
    int xmax = static_cast<int>(center + support + 0.5);
    if (xmin < 0) xmin = 0;
    if (xmax > in_size) xmax = in_size;
    xmax -= xmin;
    double ww = 0.0;
    for (int x = 0; x < xmax; ++x) {
      k[x] = bicubic_filter((x + xmin - center + 0.5) * ss);
      ww += k[x];
    }
    for (int x = 0; x < xmax; ++x) {
      const double w = ww != 0.0 ? k[x] / ww : k[x];
      t.weights[static_cast<size_t>(i) * t.ksize + x] =
          w < 0 ? static_cast<int>(-0.5 + w * (1 << kPrecisionBits))
                : static_cast<int>(0.5 + w * (1 << kPrecisionBits));
    }
    t.first[i] = xmin;
    t.count[i] = xmax;
  }
  return t;
}

uint8_t clip8(int v) {
  if (v >= (1 << kPrecisionBits << 8)) return 255;
  if (v <= 0) return 0;
  return static_cast<uint8_t>(v >> kPrecisionBits);
}

}  // namespace

extern "C" {

// src: (in_h, in_w, c) uint8; dst: (out_h, out_w, c) uint8, PIL BICUBIC.
// Returns 0 on success.
int tux_resize_bicubic_u8(const uint8_t* src, int in_h, int in_w, int c,
                          uint8_t* dst, int out_h, int out_w) {
  if (c <= 0 || c > 16 || in_h <= 0 || in_w <= 0 || out_h <= 0 ||
      out_w <= 0)
    return 1;
  const int rnd = 1 << (kPrecisionBits - 1);
  // Horizontal pass: (in_h, out_w, c) uint8, or the source unchanged.
  std::vector<uint8_t> tmp;
  const uint8_t* mid = src;
  if (out_w != in_w) {
    const FixedTaps tw = bicubic_taps(in_w, out_w);
    tmp.resize(static_cast<size_t>(in_h) * out_w * c);
#pragma omp parallel for schedule(static)
    for (int y = 0; y < in_h; ++y) {
      const uint8_t* row = src + static_cast<size_t>(y) * in_w * c;
      uint8_t* orow = tmp.data() + static_cast<size_t>(y) * out_w * c;
      for (int x = 0; x < out_w; ++x) {
        const int* w = tw.weights.data() + static_cast<size_t>(x) * tw.ksize;
        const int f = tw.first[x], n = tw.count[x];
        for (int ch = 0; ch < c; ++ch) {
          int acc = rnd;
          for (int k = 0; k < n; ++k) acc += row[(f + k) * c + ch] * w[k];
          orow[x * c + ch] = clip8(acc);
        }
      }
    }
    mid = tmp.data();
  }
  // Vertical pass, or a copy where the height does not change.
  if (out_h == in_h) {
    std::memcpy(dst, mid, static_cast<size_t>(out_h) * out_w * c);
    return 0;
  }
  const FixedTaps th = bicubic_taps(in_h, out_h);
#pragma omp parallel for schedule(static)
  for (int y = 0; y < out_h; ++y) {
    const int* w = th.weights.data() + static_cast<size_t>(y) * th.ksize;
    const int f = th.first[y], n = th.count[y];
    uint8_t* orow = dst + static_cast<size_t>(y) * out_w * c;
    for (int x = 0; x < out_w * c; ++x) {
      int acc = rnd;
      for (int k = 0; k < n; ++k)
        acc += mid[static_cast<size_t>(f + k) * out_w * c + x] * w[k];
      orow[x] = clip8(acc);
    }
  }
  return 0;
}

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
