// Native host-side metric kernels for the interactive benchmark service.
//
// The protocol scores every submission with per-object region-J and
// boundary-F (SURVEY.md C20). Boundary-F needs, per (frame, object): two
// boundary extractions and two disk-tolerance matchings; a full DAVIS eval
// performs ~10^5 of them, which dominates host time when done with
// generic SciPy morphology. A pixel is "within tolerance" of a boundary
// iff some boundary pixel lies at dx^2 + dy^2 <= r^2: this kernel answers
// that for each boundary pixel with 2r + 1 lookups in per-row prefix
// counts of the other boundary (one span per row offset of the disk)
// instead of an explicit disk dilation — identical semantics, O(HW) plus
// O(r) per boundary pixel.
//
// Built with:  g++ -O3 -march=native -shared -fPIC metrics.cpp -o libivosmetrics.so
// Loaded via ctypes (cvpr2020_manet_tpu_torch/native/__init__.py); the Python
// SciPy implementation in interactive/metrics.py is the semantic oracle
// and fallback.

#include <algorithm>
#include <cstdint>
#include <vector>

namespace {

// Per-row prefix counts of a boundary map: pre[y * (w + 1) + x] is the
// number of boundary pixels in row y left of column x.
void row_prefix(const uint8_t* b, int32_t* pre, int h, int w) {
  for (int y = 0; y < h; ++y) {
    int32_t* p = pre + (size_t)y * (w + 1);
    p[0] = 0;
    for (int x = 0; x < w; ++x) p[x + 1] = p[x] + b[(size_t)y * w + x];
  }
}

// Number of pixels of `a` with a pixel of the set behind `pre_b` (row
// prefix counts) at dx^2 + dy^2 <= r^2: per row offset dy, a span of
// half-width half[dy + r] = floor(sqrt(r^2 - dy^2)), one subtraction.
long matched(const uint8_t* a, const int32_t* pre_b, int h, int w, int r,
             const std::vector<int>& half) {
  long m = 0;
  for (int y = 0; y < h; ++y) {
    for (int x = 0; x < w; ++x) {
      if (!a[(size_t)y * w + x]) continue;
      for (int dy = std::max(-r, -y); dy <= std::min(r, h - 1 - y); ++dy) {
        const int32_t* p = pre_b + (size_t)(y + dy) * (w + 1);
        int x0 = std::max(0, x - half[dy + r]);
        int x1 = std::min(w - 1, x + half[dy + r]);
        if (p[x1 + 1] > p[x0]) { ++m; break; }
      }
    }
  }
  return m;
}

// 8-connected inner boundary of a binary mask (nonzero = in): the mask
// less its erosion by a 3x3 square (border_value=0: outside counts as
// background), as a horizontal 3-AND per row (`h3`, h + 2 rows, zero rows
// around), then a vertical one.
void boundary(const uint8_t* m, uint8_t* b, int h, int w,
              std::vector<uint8_t>& h3) {
  std::fill(h3.begin(), h3.begin() + w, 0);
  std::fill(h3.end() - w, h3.end(), 0);
  for (int y = 0; y < h; ++y) {
    const uint8_t* row = m + (size_t)y * w;
    uint8_t* out = h3.data() + (size_t)(y + 1) * w;
    out[0] = 0;
    out[w - 1] = 0;
    for (int x = 1; x < w - 1; ++x)
      out[x] = (row[x - 1] != 0) & (row[x] != 0) & (row[x + 1] != 0);
  }
  for (int y = 0; y < h; ++y) {
    const uint8_t* up = h3.data() + (size_t)y * w;
    const uint8_t* mid = up + w;
    const uint8_t* down = mid + w;
    const uint8_t* row = m + (size_t)y * w;
    uint8_t* out = b + (size_t)y * w;
    for (int x = 0; x < w; ++x)
      out[x] = (row[x] != 0) & !(up[x] & mid[x] & down[x]);
  }
}

}  // namespace

extern "C" {

// Boundary F-measure for a batch of binary masks.
// pred, gt: (T, H, W) uint8, nonzero = in; out: (T,) float64.
// bound_pix: tolerance radius in pixels (>= 1).
void batched_f_measure(const uint8_t* pred, const uint8_t* gt,
                       int t, int h, int w, int bound_pix, double* out) {
  int n = h * w;
  std::vector<uint8_t> fgb(n), gtb(n), h3((size_t)(h + 2) * w);
  std::vector<int32_t> pre_fg((size_t)h * (w + 1));
  std::vector<int32_t> pre_gt((size_t)h * (w + 1));
  // half[dy + r]: the largest dx with dx^2 + dy^2 <= r^2
  int r = bound_pix;
  std::vector<int> half(2 * r + 1);
  for (int dy = -r; dy <= r; ++dy) {
    int dx = 0;
    while ((dx + 1) * (dx + 1) + dy * dy <= r * r) ++dx;
    half[dy + r] = dx;
  }

  for (int f = 0; f < t; ++f) {
    const uint8_t* p = pred + (size_t)f * n;
    const uint8_t* g = gt + (size_t)f * n;
    bool any_p = false, any_g = false;
    for (int i = 0; i < n; ++i) { any_p |= p[i] != 0; any_g |= g[i] != 0; }
    if (!any_p && !any_g) { out[f] = 1.0; continue; }

    boundary(p, fgb.data(), h, w, h3);
    boundary(g, gtb.data(), h, w, h3);
    long n_fg = 0, n_gt = 0;
    for (int i = 0; i < n; ++i) { n_fg += fgb[i]; n_gt += gtb[i]; }
    if (n_fg == 0 && n_gt == 0) { out[f] = 1.0; continue; }
    if (n_fg == 0 || n_gt == 0) { out[f] = 0.0; continue; }

    row_prefix(gtb.data(), pre_gt.data(), h, w);
    row_prefix(fgb.data(), pre_fg.data(), h, w);
    long match_p = matched(fgb.data(), pre_gt.data(), h, w, r, half);
    long match_r = matched(gtb.data(), pre_fg.data(), h, w, r, half);
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
