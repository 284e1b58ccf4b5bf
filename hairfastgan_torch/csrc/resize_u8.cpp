// resize_u8: the Keys (a = -0.75) bicubic uint8 resize of the native image
// loader (native/hf_loader.cpp), alone: no decoder, so it builds on hosts
// without libjpeg / libpng headers. utils/images.to_image_u8 uses it for
// the upload_res coercion on every host, so that a host-resized upload
// tracks the device resampler (ops/resample.resize "bicubic") whether or
// not the full loader builds.
//
// The arithmetic is a copy of hf_loader.cpp's cubic / build_axis /
// resize_to_float / resize_to_u8; built with the same flags, the two
// libraries give the same bytes.
//
// Build: g++ -O3 -march=native -shared -fPIC resize_u8.cpp -o libresize_u8.so
//
// C ABI:
//   int hfl_resize_u8(const unsigned char* in, int in_h, int in_w,
//                     int out_size, unsigned char* out);  // 1 ok, 0 bad size

#include <cmath>
#include <cstddef>
#include <cstring>
#include <vector>

namespace {

struct Image {
  int w = 0, h = 0, c = 0;
  std::vector<unsigned char> data;  // HWC, 8-bit
};

// Keys cubic (a = -0.75), the torch F.interpolate bicubic kernel.
inline float cubic(float x) {
  const float a = -0.75f;
  x = std::fabs(x);
  if (x <= 1.f) return ((a + 2.f) * x - (a + 3.f)) * x * x + 1.f;
  if (x < 2.f) return (((x - 5.f) * x + 8.f) * x - 4.f) * a;
  return 0.f;
}

struct AxisMap {
  std::vector<int> idx;     // 4 taps per output
  std::vector<float> wgt;
};

AxisMap build_axis(int in, int out) {
  AxisMap m;
  m.idx.resize(size_t(out) * 4);
  m.wgt.resize(size_t(out) * 4);
  const double scale = double(in) / out;
  for (int o = 0; o < out; ++o) {
    double src = (o + 0.5) * scale - 0.5;
    int j0 = int(std::floor(src));
    for (int k = -1; k <= 2; ++k) {
      int j = j0 + k;
      float w = cubic(float(src - j));
      j = j < 0 ? 0 : (j >= in ? in - 1 : j);
      m.idx[size_t(o) * 4 + (k + 1)] = j;
      m.wgt[size_t(o) * 4 + (k + 1)] = w;  // torch does not renormalize
    }
  }
  return m;
}

// HWC uint8 -> out_size^2 x 3 float [0,1]
void resize_to_float(const Image& im, int out_size, float* out) {
  if (im.w == out_size && im.h == out_size) {
    const size_t n = size_t(out_size) * out_size * 3;
    for (size_t i = 0; i < n; ++i) out[i] = im.data[i] * (1.f / 255.f);
    return;
  }
  AxisMap mx = build_axis(im.w, out_size);
  AxisMap my = build_axis(im.h, out_size);

  // pass 1: horizontal into a float intermediate [h][out][3]
  std::vector<float> tmp(size_t(im.h) * out_size * 3);
  for (int y = 0; y < im.h; ++y) {
    const unsigned char* row = im.data.data() + size_t(y) * im.w * 3;
    float* trow = tmp.data() + size_t(y) * out_size * 3;
    for (int o = 0; o < out_size; ++o) {
      const int* ji = &mx.idx[size_t(o) * 4];
      const float* jw = &mx.wgt[size_t(o) * 4];
      for (int ch = 0; ch < 3; ++ch) {
        float acc = 0.f;
        for (int k = 0; k < 4; ++k) acc += jw[k] * row[ji[k] * 3 + ch];
        trow[o * 3 + ch] = acc * (1.f / 255.f);
      }
    }
  }
  // pass 2: vertical
  for (int o = 0; o < out_size; ++o) {
    const int* ji = &my.idx[size_t(o) * 4];
    const float* jw = &my.wgt[size_t(o) * 4];
    float* orow = out + size_t(o) * out_size * 3;
    for (int x = 0; x < out_size * 3; ++x) {
      float acc = 0.f;
      for (int k = 0; k < 4; ++k)
        acc += jw[k] * tmp[size_t(ji[k]) * out_size * 3 + x];
      orow[x] = acc < 0.f ? 0.f : (acc > 1.f ? 1.f : acc);
    }
  }
}

// Right-sized images pass through as raw bytes; resized ones quantize
// round-half-up, matching the Python coercion (utils/images.to_image_u8).
void resize_to_u8(const Image& im, int out_size, unsigned char* out) {
  if (im.w == out_size && im.h == out_size) {
    std::memcpy(out, im.data.data(), size_t(out_size) * out_size * 3);
    return;
  }
  std::vector<float> f(size_t(out_size) * out_size * 3);
  resize_to_float(im, out_size, f.data());
  for (size_t i = 0; i < f.size(); ++i) {
    float v = f[i] * 255.f + 0.5f;
    out[i] = v <= 0.f ? 0 : (v >= 255.f ? 255 : (unsigned char)v);
  }
}

}  // namespace

extern "C" {

int hfl_resize_u8(const unsigned char* in, int in_h, int in_w, int out_size,
                  unsigned char* out) {
  if (in_h <= 0 || in_w <= 0 || out_size <= 0) return 0;
  Image im;
  im.w = in_w;
  im.h = in_h;
  im.c = 3;
  im.data.assign(in, in + size_t(in_h) * in_w * 3);
  resize_to_u8(im, out_size, out);
  return 1;
}

}  // extern "C"
