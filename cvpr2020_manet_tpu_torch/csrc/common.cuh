// Shared helpers of the port's matching kernels.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace manet {

// Distance of a wrong-label or padding key (ops/matching.py
// WRONG_LABEL_PADDING_DISTANCE); it never wins a min.
constexpr float kBig = 1e8f;

// FEELVOS normalization of a squared distance: 1 - 2 / (1 + exp(min(d, 30))).
__device__ __forceinline__ float normalize_distance(float d) {
  return 1.f - 2.f / (1.f + expf(fminf(d, 30.f)));
}

// Squared distance from (min over keys of |k|^2 - 2 q.k) and |q|^2,
// clamped to [0, kBig] and normalized.
__device__ __forceinline__ float finish_distance(float emin, float qn) {
  return normalize_distance(fminf(fmaxf(emin + qn, 0.f), kBig));
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

}  // namespace manet
