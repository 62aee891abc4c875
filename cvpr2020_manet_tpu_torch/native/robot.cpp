// Native host-side scribble-robot kernels (SURVEY.md C20).
//
// davisinteractive's InteractiveScribblesRobot skeletonizes each error
// region (skimage.morphology.medial_axis) and walks the skeleton graph
// for its longest path (networkx). Neither package is available here and
// a pure-Python reimplementation measured ~20 s per 480p interaction
// (breadth-first search over ~3e5-pixel regions plus a 165x165
// structuring-element erosion). This file implements the same intent --
// "a polyline along the spine of the largest error region, safely inside
// it" -- in O(HW):
//
//   1. largest 8-connected component of the error mask (iterative BFS)
//   2. proportional shrink: keep pixels whose exact Euclidean distance to
//      the background exceeds r = kernel_size * sqrt(area)  (identical
//      semantics to binary erosion with a radius-r disk, via the
//      Felzenszwalb-Huttenlocher EDT from metrics.cpp)
//   3. Zhang-Suen thinning of the shrunk region -> 1-px-wide skeleton
//      (connectivity-preserving, so the spine of a curved region curves)
//   4. double-BFS graph diameter over skeleton pixels -> ordered polyline
//
// Built into the same .so as metrics.cpp (see native/__init__.py).

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <limits>
#include <vector>

namespace {

constexpr float kBig = 1e20f;
constexpr float kInf = std::numeric_limits<float>::infinity();

// 1-D squared distance transform (shared shape with metrics.cpp; kept
// internal to each TU via anonymous namespace).
void dt1d_r(const float* f, float* d, int n, int* v, float* z) {
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

// Squared EDT to the zero-pixels of `mask` (plus the implicit background
// border outside the image, matching scipy binary_erosion border_value=0).
void edt_to_background(const uint8_t* mask, float* out, int h, int w) {
  int m = std::max(h, w);
  std::vector<float> tmp(m), zbuf(m + 1), col(m);
  std::vector<int> vbuf(m);
  for (int x = 0; x < w; ++x) {
    for (int y = 0; y < h; ++y) col[y] = mask[y * w + x] ? kBig : 0.0f;
    dt1d_r(col.data(), tmp.data(), h, vbuf.data(), zbuf.data());
    for (int y = 0; y < h; ++y) out[y * w + x] = tmp[y];
  }
  std::vector<float> row(w);
  for (int y = 0; y < h; ++y) {
    std::memcpy(row.data(), out + y * w, w * sizeof(float));
    dt1d_r(row.data(), out + y * w, w, vbuf.data(), zbuf.data());
  }
  for (int y = 0; y < h; ++y) {
    for (int x = 0; x < w; ++x) {
      float bd = (float)(std::min(std::min(y, h - 1 - y),
                                  std::min(x, w - 1 - x)) + 1);
      out[y * w + x] = std::min(out[y * w + x], bd * bd);
    }
  }
}

const int kDy[8] = {-1, -1, -1, 0, 0, 1, 1, 1};
const int kDx[8] = {-1, 0, 1, -1, 1, -1, 0, 1};

// Largest 8-connected component of nonzero pixels; returns its size and
// writes it as {0,1} into `comp`.
long largest_component(const uint8_t* mask, uint8_t* comp, int h, int w,
                       std::vector<int32_t>& stack) {
  int n = h * w;
  std::vector<int32_t> label(n, -1);
  long best_size = 0;
  int32_t best_label = -1;
  int32_t next = 0;
  for (int i = 0; i < n; ++i) {
    if (!mask[i] || label[i] >= 0) continue;
    long size = 0;
    stack.clear();
    stack.push_back(i);
    label[i] = next;
    while (!stack.empty()) {
      int p = stack.back();
      stack.pop_back();
      ++size;
      int y = p / w, x = p % w;
      for (int k = 0; k < 8; ++k) {
        int yy = y + kDy[k], xx = x + kDx[k];
        if (yy < 0 || yy >= h || xx < 0 || xx >= w) continue;
        int q = yy * w + xx;
        if (mask[q] && label[q] < 0) {
          label[q] = next;
          stack.push_back(q);
        }
      }
    }
    if (size > best_size) { best_size = size; best_label = next; }
    ++next;
  }
  for (int i = 0; i < n; ++i) comp[i] = (label[i] == best_label) ? 1 : 0;
  return best_size;
}

// Zhang-Suen thinning (1984), restricted to the component bounding box.
// Preserves 8-connectivity; leaves a 1-px-wide skeleton in-place.
void thin_zhang_suen(uint8_t* img, int h, int w,
                     int y0, int y1, int x0, int x1) {
  auto at = [&](int y, int x) -> uint8_t {
    return (y < 0 || y >= h || x < 0 || x >= w) ? 0 : img[y * w + x];
  };
  std::vector<int32_t> del;
  bool changed = true;
  while (changed) {
    changed = false;
    for (int pass = 0; pass < 2; ++pass) {
      del.clear();
      for (int y = y0; y <= y1; ++y) {
        for (int x = x0; x <= x1; ++x) {
          if (!img[y * w + x]) continue;
          // neighbors clockwise from north: p2..p9
          uint8_t p2 = at(y - 1, x), p3 = at(y - 1, x + 1);
          uint8_t p4 = at(y, x + 1), p5 = at(y + 1, x + 1);
          uint8_t p6 = at(y + 1, x), p7 = at(y + 1, x - 1);
          uint8_t p8 = at(y, x - 1), p9 = at(y - 1, x - 1);
          int b = p2 + p3 + p4 + p5 + p6 + p7 + p8 + p9;
          if (b < 2 || b > 6) continue;
          int a = (p2 == 0 && p3 == 1) + (p3 == 0 && p4 == 1) +
                  (p4 == 0 && p5 == 1) + (p5 == 0 && p6 == 1) +
                  (p6 == 0 && p7 == 1) + (p7 == 0 && p8 == 1) +
                  (p8 == 0 && p9 == 1) + (p9 == 0 && p2 == 1);
          if (a != 1) continue;
          if (pass == 0) {
            if (p2 * p4 * p6 != 0 || p4 * p6 * p8 != 0) continue;
          } else {
            if (p2 * p4 * p8 != 0 || p2 * p6 * p8 != 0) continue;
          }
          del.push_back(y * w + x);
        }
      }
      for (int32_t p : del) img[p] = 0;
      if (!del.empty()) changed = true;
    }
  }
}

// BFS over nonzero pixels from `start`; returns farthest pixel; fills
// `parent` (-1 where unvisited).
int bfs_far(const uint8_t* img, int h, int w, int start,
            std::vector<int32_t>& parent, std::vector<int32_t>& queue) {
  std::vector<int32_t> dist((size_t)h * w, -1);
  std::fill(parent.begin(), parent.end(), -1);
  queue.clear();
  queue.push_back(start);
  dist[start] = 0;
  int far = start;
  size_t head = 0;
  while (head < queue.size()) {
    int p = queue[head++];
    int y = p / w, x = p % w;
    for (int k = 0; k < 8; ++k) {
      int yy = y + kDy[k], xx = x + kDx[k];
      if (yy < 0 || yy >= h || xx < 0 || xx >= w) continue;
      int q = yy * w + xx;
      if (img[q] && dist[q] < 0) {
        dist[q] = dist[p] + 1;
        parent[q] = p;
        queue.push_back(q);
        if (dist[q] > dist[far]) far = q;
      }
    }
  }
  return far;
}

}  // namespace

extern "C" {

// Spine polyline of the largest error region.
//   err:        (H, W) uint8 {0,1} error mask
//   kernel_size, min_region_pixels: RobotParams semantics
//   max_kernel_radius: cap on the EDT shrink radius in pixels (upstream
//       davisinteractive `max_kernel_radius`); <= 0 means uncapped —
//       without it, very large error regions erode more than upstream's
//       robot would and the scribble geometry diverges exactly in the
//       heavy-error rounds
//   min_path_nodes: if the skeleton's longest path is shorter than this
//       (compact blobs thin to a point), fall back to the geodesic
//       diameter of the shrunk region itself
//   out_yx:     int32 buffer for up to max_pts (y, x) pairs
// Returns the number of path points written (0 = no usable region).
int scribble_path(const uint8_t* err, int h, int w, float kernel_size,
                  float max_kernel_radius,
                  int min_region_pixels, int min_path_nodes,
                  int32_t* out_yx, int max_pts) {
  int n = h * w;
  std::vector<uint8_t> comp(n), region(n);
  std::vector<int32_t> stack;
  long area = largest_component(err, comp.data(), h, w, stack);
  if (area < min_region_pixels) return 0;

  // proportional shrink via exact EDT (disk-erosion semantics)
  float r = std::max(1.0f, kernel_size * std::sqrt((float)area));
  if (max_kernel_radius > 0.0f) r = std::min(r, max_kernel_radius);
  std::vector<float> d(n);
  edt_to_background(comp.data(), d.data(), h, w);
  long inner = 0;
  for (int i = 0; i < n; ++i) {
    region[i] = (comp[i] && d[i] > r * r) ? 1 : 0;
    inner += region[i];
  }
  if (inner < 3) { std::memcpy(region.data(), comp.data(), n); }
  else {
    // keep the largest component of the shrunk region
    std::vector<uint8_t> tmp(region);
    largest_component(tmp.data(), region.data(), h, w, stack);
  }

  // bounding box for the thinning sweeps
  int y0 = h, y1 = -1, x0 = w, x1 = -1;
  for (int y = 0; y < h; ++y)
    for (int x = 0; x < w; ++x)
      if (region[y * w + x]) {
        y0 = std::min(y0, y); y1 = std::max(y1, y);
        x0 = std::min(x0, x); x1 = std::max(x1, x);
      }
  if (y1 < 0) return 0;

  std::vector<uint8_t> pre_thin(region);
  thin_zhang_suen(region.data(), h, w, y0, y1, x0, x1);

  std::vector<int32_t> parent(n), queue;
  auto diameter = [&](const uint8_t* img) {
    std::vector<int32_t> path;
    int seed = -1;
    for (int i = 0; i < n && seed < 0; ++i)
      if (img[i]) seed = i;
    if (seed < 0) return path;
    int a = bfs_far(img, h, w, seed, parent, queue);
    int b = bfs_far(img, h, w, a, parent, queue);
    for (int p = b; p >= 0; p = parent[p]) {
      path.push_back(p);
      if (p == a) break;
    }
    return path;
  };

  std::vector<int32_t> path = diameter(region.data());
  if ((int)path.size() < min_path_nodes)
    path = diameter(pre_thin.data());
  int npts = std::min((int)path.size(), max_pts);
  for (int i = 0; i < npts; ++i) {
    out_yx[2 * i] = path[i] / w;
    out_yx[2 * i + 1] = path[i] % w;
  }
  return npts;
}

}  // extern "C"
