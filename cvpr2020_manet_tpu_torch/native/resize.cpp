// Pillow's uint8 Image.resize, bit for bit, for the training sampler's
// joint augmentation:
//   - BILINEAR on 3-channel images: Pillow's separable two-pass resample
//     (Resample.c). Per output index, a triangle filter whose support is
//     scaled by max(1, in / out) when downscaling, centred at
//     (i + 0.5) * in / out, its taps normalized in double and fixed to 22
//     fraction bits; the horizontal pass runs first and rounds and clips
//     to uint8, the vertical pass follows; a pass whose axis keeps its
//     size is skipped.
//   - NEAREST on 1-channel label maps: Pillow's affine scale
//     (Geometry.c), which samples the source at each output pixel's
//     centre, the centre stepped by in / out in double from one pixel to
//     the next.
// Each entry computes a window [y0, y0 + oh) x [x0, x0 + ow) of the full
// (out_h, out_w) result for n frames: an output pixel depends only on its
// own index, so a window equals the same crop of the full resize, and the
// sampler resizes only the crop it keeps. The library is built with
// -ffp-contract=off so that no multiply-add is fused (Pillow's builds
// round each operation).
//
// C interface (ctypes): ivos_resize_bilinear_rgb, ivos_resize_nearest_u8;
// each returns 0, or 1 on bad sizes.

#include <cmath>
#include <cstdint>
#include <vector>

namespace {

constexpr int kPrecisionBits = 32 - 8 - 2;

inline double bilinear_filter(double x) {
  if (x < 0.0) x = -x;
  if (x < 1.0) return 1.0 - x;
  return 0.0;
}

inline uint8_t clip8(int v) {
  v >>= kPrecisionBits;  // arithmetic shift: floor, as Pillow's table
  return v < 0 ? 0 : (v > 255 ? 255 : (uint8_t)v);
}

// Pillow's precompute_coeffs + normalize_coeffs_8bpc for the output
// indices [first, first + count) of an in_size -> out_size axis.
struct Coeffs {
  int ksize = 0;
  std::vector<int> start, taps;  // first source index, number of taps
  std::vector<int32_t> k;        // count x ksize fixed-point taps
};

Coeffs precompute(int in_size, int out_size, int first, int count) {
  Coeffs c;
  double scale = (double)((float)in_size - 0.0f) / out_size;
  double filterscale = scale < 1.0 ? 1.0 : scale;
  double support = 1.0 * filterscale;
  c.ksize = (int)std::ceil(support) * 2 + 1;
  c.start.resize(count);
  c.taps.resize(count);
  c.k.assign((size_t)count * c.ksize, 0);
  std::vector<double> w(c.ksize);
  for (int i = 0; i < count; ++i) {
    int xx = first + i;
    double center = 0.0 + (xx + 0.5) * scale;
    double ww = 0.0;
    double ss = 1.0 / filterscale;
    int xmin = (int)(center - support + 0.5);
    if (xmin < 0) xmin = 0;
    int xmax = (int)(center + support + 0.5);
    if (xmax > in_size) xmax = in_size;
    xmax -= xmin;
    for (int x = 0; x < xmax; ++x) {
      double v = bilinear_filter((x + xmin - center + 0.5) * ss);
      w[x] = v;
      ww += v;
    }
    for (int x = 0; x < xmax; ++x) {
      if (ww != 0.0) w[x] /= ww;
      double f = w[x] * (1 << kPrecisionBits);
      c.k[(size_t)i * c.ksize + x] =
          w[x] < 0 ? (int32_t)(-0.5 + f) : (int32_t)(0.5 + f);
    }
    c.start[i] = xmin;
    c.taps[i] = xmax;
  }
  return c;
}

bool bad(int h, int w, int out_h, int out_w, int y0, int x0, int oh, int ow) {
  return h < 1 || w < 1 || out_h < 1 || out_w < 1 || y0 < 0 || x0 < 0 ||
         oh < 1 || ow < 1 || y0 + oh > out_h || x0 + ow > out_w;
}

// Pillow's NEAREST sample positions of the output indices [0, end): the
// centre starts at half a step and is stepped in double; -1 outside.
std::vector<int> nearest_table(int in_size, int out_size, int end) {
  std::vector<int> t(end);
  double a = (double)((float)in_size - 0.0f) / out_size;
  double pos = 0.0 + a * 0.5;
  for (int i = 0; i < end; ++i) {
    int v = pos < 0.0 ? -1 : (int)pos;
    t[i] = (v >= 0 && v < in_size) ? v : -1;
    pos += a;
  }
  return t;
}

}  // namespace

// n frames (n, h, w, 3) uint8 -> the window (n, oh, ow, 3) of their
// (out_h, out_w) BILINEAR resize.
extern "C" int ivos_resize_bilinear_rgb(const uint8_t* src, int n, int h,
                                        int w, int out_h, int out_w, int y0,
                                        int x0, int oh, int ow,
                                        uint8_t* dst) {
  if (n < 0 || bad(h, w, out_h, out_w, y0, x0, oh, ow)) return 1;
  const bool need_h = out_w != w, need_v = out_h != h;
  Coeffs ch, cv;
  if (need_h) ch = precompute(w, out_w, x0, ow);
  if (need_v) cv = precompute(h, out_h, y0, oh);
  // source rows the window's vertical pass reads
  int r0 = need_v ? cv.start[0] : y0;
  int r1 = need_v ? cv.start[oh - 1] + cv.taps[oh - 1] : y0 + oh;
  int rows = r1 - r0;
  std::vector<uint8_t> tmp((size_t)rows * ow * 3);
  for (int f = 0; f < n; ++f) {
    const uint8_t* in = src + (size_t)f * h * w * 3;
    uint8_t* out = dst + (size_t)f * oh * ow * 3;
    // horizontal pass (or the window's columns as they are)
    for (int r = 0; r < rows; ++r) {
      const uint8_t* row = in + (size_t)(r0 + r) * w * 3;
      uint8_t* t = tmp.data() + (size_t)r * ow * 3;
      for (int i = 0; i < ow; ++i) {
        if (!need_h) {
          for (int b = 0; b < 3; ++b) t[i * 3 + b] = row[(x0 + i) * 3 + b];
          continue;
        }
        const int32_t* k = ch.k.data() + (size_t)i * ch.ksize;
        const uint8_t* p = row + ch.start[i] * 3;
        int s0 = 1 << (kPrecisionBits - 1), s1 = s0, s2 = s0;
        for (int x = 0; x < ch.taps[i]; ++x) {
          s0 += p[x * 3 + 0] * k[x];
          s1 += p[x * 3 + 1] * k[x];
          s2 += p[x * 3 + 2] * k[x];
        }
        t[i * 3 + 0] = clip8(s0);
        t[i * 3 + 1] = clip8(s1);
        t[i * 3 + 2] = clip8(s2);
      }
    }
    // vertical pass (or the window's rows as they are)
    for (int j = 0; j < oh; ++j) {
      uint8_t* o = out + (size_t)j * ow * 3;
      if (!need_v) {
        const uint8_t* t = tmp.data() + (size_t)j * ow * 3;
        for (int i = 0; i < ow * 3; ++i) o[i] = t[i];
        continue;
      }
      const int32_t* k = cv.k.data() + (size_t)j * cv.ksize;
      const uint8_t* t = tmp.data() + (size_t)(cv.start[j] - r0) * ow * 3;
      for (int i = 0; i < ow * 3; ++i) {
        int s = 1 << (kPrecisionBits - 1);
        for (int y = 0; y < cv.taps[j]; ++y)
          s += t[(size_t)y * ow * 3 + i] * k[y];
        o[i] = clip8(s);
      }
    }
  }
  return 0;
}

// n label maps (n, h, w) uint8 -> the window (n, oh, ow) of their
// (out_h, out_w) NEAREST resize (0 where a centre falls outside).
extern "C" int ivos_resize_nearest_u8(const uint8_t* src, int n, int h, int w,
                                      int out_h, int out_w, int y0, int x0,
                                      int oh, int ow, uint8_t* dst) {
  if (n < 0 || bad(h, w, out_h, out_w, y0, x0, oh, ow)) return 1;
  std::vector<int> ty = nearest_table(h, out_h, y0 + oh);
  std::vector<int> tx = nearest_table(w, out_w, x0 + ow);
  for (int f = 0; f < n; ++f) {
    const uint8_t* in = src + (size_t)f * h * w;
    uint8_t* out = dst + (size_t)f * oh * ow;
    for (int j = 0; j < oh; ++j) {
      int sy = ty[y0 + j];
      for (int i = 0; i < ow; ++i) {
        int sx = tx[x0 + i];
        out[(size_t)j * ow + i] =
            (sy < 0 || sx < 0) ? 0 : in[(size_t)sy * w + sx];
      }
    }
  }
  return 0;
}
