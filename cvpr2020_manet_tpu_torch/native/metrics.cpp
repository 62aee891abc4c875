// Native host-side metric kernels for the interactive benchmark service.
//
// The protocol scores every submission with per-object region-J and
// boundary-F (SURVEY.md C20). Boundary-F needs, per (frame, object): two
// boundary extractions and two disk-tolerance matchings; a full DAVIS eval
// performs ~10^5 of them, which dominates host time when done with
// generic SciPy morphology. This kernel does the same computation with an
// exact O(HW) Euclidean distance transform (Felzenszwalb & Huttenlocher)
// instead of explicit disk dilation: a pixel is "within tolerance" of a
// boundary iff its squared EDT to the boundary set is <= r^2 — identical
// semantics, ~2 orders of magnitude faster.
//
// Built with:  g++ -O3 -march=native -shared -fPIC metrics.cpp -o libivosmetrics.so
// Loaded via ctypes (cvpr2020_manet_tpu_torch/native/__init__.py); the Python
// SciPy implementation in interactive/metrics.py is the semantic oracle
// and fallback.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <limits>
#include <vector>

namespace {

// "Infinity" as a large finite value: the vanilla Felzenszwalb recurrence
// then needs no special cases (parabolas with kBig offsets simply never
// win where real sites exist), and unreachable pixels come out >= kBig,
// far above any tolerance radius squared.
constexpr float kBig = 1e20f;
constexpr float kInf = std::numeric_limits<float>::infinity();

// 1-D squared distance transform (Felzenszwalb & Huttenlocher 2004).
void dt1d(const float* f, float* d, int n, int* v, float* z) {
  int k = 0;
  v[0] = 0;
  z[0] = -kInf;
  z[1] = kInf;
  for (int q = 1; q < n; ++q) {
    float s = ((f[q] + q * (float)q) - (f[v[k]] + v[k] * (float)v[k])) /
              (2.0f * (q - v[k]));
    while (s <= z[k]) {
      --k;
      s = ((f[q] + q * (float)q) - (f[v[k]] + v[k] * (float)v[k])) /
          (2.0f * (q - v[k]));
    }
    ++k;
    v[k] = q;
    z[k] = s;
    z[k + 1] = kInf;
  }
  k = 0;
  for (int q = 0; q < n; ++q) {
    while (z[k + 1] < q) { ++k; }
    d[q] = (q - v[k]) * (float)(q - v[k]) + f[v[k]];
  }
}

// 2-D squared EDT of the zero-set given an indicator (1 = in set).
void edt2d(const uint8_t* indicator, float* out, int h, int w,
           std::vector<float>& tmp, std::vector<int>& vbuf,
           std::vector<float>& zbuf, std::vector<float>& col) {
  // columns first
  for (int x = 0; x < w; ++x) {
    for (int y = 0; y < h; ++y)
      col[y] = indicator[y * w + x] ? 0.0f : kBig;
    dt1d(col.data(), tmp.data() + 0, h, vbuf.data(), zbuf.data());
    for (int y = 0; y < h; ++y) out[y * w + x] = tmp[y];
  }
  // then rows
  for (int y = 0; y < h; ++y) {
    std::memcpy(col.data(), out + y * w, w * sizeof(float));
    dt1d(col.data(), out + y * w, w, vbuf.data(), zbuf.data());
  }
}

// 8-connected inner boundary of a binary mask.
void boundary(const uint8_t* m, uint8_t* b, int h, int w) {
  for (int y = 0; y < h; ++y) {
    for (int x = 0; x < w; ++x) {
      uint8_t v = m[y * w + x];
      if (!v) { b[y * w + x] = 0; continue; }
      bool interior = true;
      for (int dy = -1; dy <= 1 && interior; ++dy) {
        for (int dx = -1; dx <= 1; ++dx) {
          int yy = y + dy, xx = x + dx;
          // erosion with border_value=0: outside counts as background
          if (yy < 0 || yy >= h || xx < 0 || xx >= w ||
              !m[yy * w + xx]) { interior = false; break; }
        }
      }
      b[y * w + x] = interior ? 0 : 1;
    }
  }
}

}  // namespace

extern "C" {

// Boundary F-measure for a batch of binary masks.
// pred, gt: (T, H, W) uint8 {0,1}; out: (T,) float64.
// bound_pix: tolerance radius in pixels (>= 1).
void batched_f_measure(const uint8_t* pred, const uint8_t* gt,
                       int t, int h, int w, int bound_pix, double* out) {
  int n = h * w;
  float r2 = (float)bound_pix * (float)bound_pix;
  std::vector<uint8_t> fgb(n), gtb(n);
  std::vector<float> d_fg(n), d_gt(n);
  int m = std::max(h, w);
  std::vector<float> tmp(m), zbuf(m + 1), col(m);
  std::vector<int> vbuf(m);

  for (int f = 0; f < t; ++f) {
    const uint8_t* p = pred + (size_t)f * n;
    const uint8_t* g = gt + (size_t)f * n;
    bool any_p = false, any_g = false;
    for (int i = 0; i < n; ++i) { any_p |= p[i] != 0; any_g |= g[i] != 0; }
    if (!any_p && !any_g) { out[f] = 1.0; continue; }

    boundary(p, fgb.data(), h, w);
    boundary(g, gtb.data(), h, w);
    long n_fg = 0, n_gt = 0;
    for (int i = 0; i < n; ++i) { n_fg += fgb[i]; n_gt += gtb[i]; }
    if (n_fg == 0 && n_gt == 0) { out[f] = 1.0; continue; }
    if (n_fg == 0 || n_gt == 0) { out[f] = 0.0; continue; }

    edt2d(gtb.data(), d_gt.data(), h, w, tmp, vbuf, zbuf, col);
    edt2d(fgb.data(), d_fg.data(), h, w, tmp, vbuf, zbuf, col);

    long match_p = 0, match_r = 0;
    for (int i = 0; i < n; ++i) {
      if (fgb[i] && d_gt[i] <= r2) ++match_p;
      if (gtb[i] && d_fg[i] <= r2) ++match_r;
    }
    double precision = (double)match_p / (double)n_fg;
    double recall = (double)match_r / (double)n_gt;
    out[f] = (precision + recall == 0.0)
                 ? 0.0
                 : 2.0 * precision * recall / (precision + recall);
  }
}

// Batched Jaccard for integer label maps, one object id at a time.
// pred, gt: (T, H, W) int32 labels; out: (T,) float64 IoU of (label == obj).
void batched_jaccard_obj(const int32_t* pred, const int32_t* gt,
                         int t, int h, int w, int obj, double* out) {
  size_t n = (size_t)h * w;
  for (int f = 0; f < t; ++f) {
    const int32_t* p = pred + (size_t)f * n;
    const int32_t* g = gt + (size_t)f * n;
    long inter = 0, uni = 0;
    for (size_t i = 0; i < n; ++i) {
      bool a = p[i] == obj, b = g[i] == obj;
      inter += (a && b);
      uni += (a || b);
    }
    out[f] = uni == 0 ? 1.0 : (double)inter / (double)uni;
  }
}

}  // extern "C"
