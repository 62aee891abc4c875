// Windowed local matching against the previous frame, for Hopper (sm_90a).
//
// Replaces the TPU kernel cvpr2020_manet_tpu/ops/local_matching_pallas.py
// `_kernel` (called by `local_matching_pallas`). For every query pixel p
// and object o it computes
//
//   out[p, o] = normalize(clamp(|q_p|^2 +
//                 min_{|dy|,|dx| <= w, p+(dy,dx) in the image}
//                     (kno[p+(dy,dx), o] - 2 q_p . k_{p+(dy,dx)}), 0, 1e8))
//
// where kno is the gated |k|^2 of the previous frame: |k|^2 on pixels the
// previous mask gives to o, |k|^2 + 1e8 elsewhere. Keys outside the image
// are skipped (on the TPU they were padding rows with |k|^2 = 1e8, which
// can only win where every candidate saturates to 1.0 anyway).
//
// Design: the TPU kernel multiplies a whole strip of rows and masks the
// band; here one warp owns one query pixel and walks its (2w+1)^2 window
// directly. Each lane holds 4 of every 128 channels of q, dots them with
// the key's (one coalesced 512-byte row read per 128 channels), and the
// warp reduces the dot product with shuffles; lane o then folds the
// candidate into object o's running min. Neighbouring warps read
// overlapping windows, so keys come mostly from L1/L2.
//
// With ARGMIN (entry `manet_local_matching_argmin`) the kernel also
// returns the winner's flat index y * w + x into the previous frame: this
// replaces the TPU kernel `_kernel_argmin` (called by
// `local_matching_pallas_argmin`), the forward of the training path's
// argmin-routed local matching. The window is walked in raster order and a
// candidate replaces the running minimum only when it is smaller, so among
// equal minima the lowest flat index wins, as `jnp.argmin` over the strip
// does; -1 stays where no key beats the 1e8 sentinel. Out-of-image keys
// are never visited. Where no key of the object lies in the window the
// TPU kernel may name another pixel or a padding key, but there the output
// saturates at 1.0 and the routed gradient is gated to 0 either way.
//
// Bound on an H100: 2 (h w) (window pairs) C f32 operations over a few MB
// of inputs — bound by operations (67 TFLOP/s f32 outside the tensor
// cores). The per-offset shuffle reduction costs more instructions than
// the dot product itself; amortizing it over several offsets per lane is
// the next step.

#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int WARPS = 8;              // query pixels per block
constexpr int C_CHUNKS = 4;           // up to 4 x 128 channels

template <bool ARGMIN>
__global__ void __launch_bounds__(WARPS * 32)
local_matching_kernel(const float* __restrict__ q, const float* __restrict__ k,
                      const float* __restrict__ kno, float* __restrict__ out,
                      int* __restrict__ idx, int h, int w, int c, int num_obj,
                      int window) {
  const int lane = threadIdx.x & 31;
  const int64_t p = static_cast<int64_t>(blockIdx.x) * WARPS + (threadIdx.x >> 5);
  if (p >= static_cast<int64_t>(h) * w) return;  // the whole warp leaves
  const int y = static_cast<int>(p / w), x = static_cast<int>(p % w);
  const int nchunk = c / 128;

  float4 qv[C_CHUNKS];
  float qn = 0.f;
#pragma unroll
  for (int ch = 0; ch < C_CHUNKS; ++ch) {
    qv[ch] = make_float4(0.f, 0.f, 0.f, 0.f);
    if (ch < nchunk) {
      qv[ch] = *reinterpret_cast<const float4*>(q + p * c + ch * 128 + lane * 4);
      qn = fmaf(qv[ch].x, qv[ch].x, qn);
      qn = fmaf(qv[ch].y, qv[ch].y, qn);
      qn = fmaf(qv[ch].z, qv[ch].z, qn);
      qn = fmaf(qv[ch].w, qv[ch].w, qn);
    }
  }
  qn = manet::warp_sum(qn);

  const int y0 = max(0, y - window), y1 = min(h - 1, y + window);
  const int x0 = max(0, x - window), x1 = min(w - 1, x + window);
  float run = manet::kBig;
  int arg = -1;
  for (int ky = y0; ky <= y1; ++ky) {
    for (int kx = x0; kx <= x1; ++kx) {
      const int64_t kp = static_cast<int64_t>(ky) * w + kx;
      const float* kr = k + kp * c + lane * 4;
      float s = 0.f;
#pragma unroll
      for (int ch = 0; ch < C_CHUNKS; ++ch) {
        if (ch < nchunk) {
          const float4 kv = *reinterpret_cast<const float4*>(kr + ch * 128);
          s = fmaf(qv[ch].x, kv.x, s);
          s = fmaf(qv[ch].y, kv.y, s);
          s = fmaf(qv[ch].z, kv.z, s);
          s = fmaf(qv[ch].w, kv.w, s);
        }
      }
      s = manet::warp_sum(s);
      if (lane < num_obj) {
        const float cand = fmaf(-2.f, s, kno[kp * num_obj + lane]);
        if constexpr (ARGMIN) {
          if (cand < run) {
            run = cand;
            arg = static_cast<int>(kp);
          }
        } else {
          run = fminf(run, cand);
        }
      }
    }
  }
  if (lane < num_obj) {
    out[p * num_obj + lane] = manet::finish_distance(run, qn);
    if constexpr (ARGMIN) idx[p * num_obj + lane] = arg;
  }
}

template <bool ARGMIN>
int launch(const void* q, const void* k, const void* kno, void* out,
           void* idx, int h, int w, int c, int num_obj, int window,
           void* stream) {
  if (h <= 0 || w <= 0 || c <= 0 || c % 128 != 0 || c > 128 * C_CHUNKS ||
      num_obj <= 0 || num_obj > 32 || window < 0 || (ARGMIN && idx == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const int64_t n = static_cast<int64_t>(h) * w;
  const dim3 grid(static_cast<unsigned>((n + WARPS - 1) / WARPS));
  local_matching_kernel<ARGMIN><<<grid, WARPS * 32, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(kno), static_cast<float*>(out),
      static_cast<int*>(idx), h, w, c, num_obj, window);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q, k (h, w, c) f32 with c a multiple of 128 (at most 512); kno and out
// (h, w, num_obj) f32, num_obj <= 32. All contiguous on the current device.
extern "C" int manet_local_matching(const void* q, const void* k,
                                    const void* kno, void* out, int h, int w,
                                    int c, int num_obj, int window,
                                    void* stream) {
  return launch<false>(q, k, kno, out, nullptr, h, w, c, num_obj, window,
                       stream);
}

// As manet_local_matching, plus idx (h, w, num_obj) int32: the flat index
// of each minimum's key in the (h, w) previous frame.
extern "C" int manet_local_matching_argmin(const void* q, const void* k,
                                           const void* kno, void* out,
                                           void* idx, int h, int w, int c,
                                           int num_obj, int window,
                                           void* stream) {
  return launch<true>(q, k, kno, out, idx, h, w, c, num_obj, window, stream);
}
