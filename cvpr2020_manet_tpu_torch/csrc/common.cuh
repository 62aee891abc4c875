// Shared helpers of the port's matching kernels.
#pragma once

#include <stdint.h>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace manet {

// Distance of a wrong-label or padding key (ops/matching.py
// WRONG_LABEL_PADDING_DISTANCE); it never wins a min.
constexpr float kBig = 1e8f;

constexpr int O_MAX = 16;      // objects per accumulator row

// Fold (ov, oi) into (v, i): the smaller value, and of equal values the
// lower row (-1, no row yet, counts as the highest).
__device__ __forceinline__ void argmin_fold(float& v, int& i, float ov, int oi) {
  if (ov < v || (ov == v && static_cast<unsigned>(oi) < static_cast<unsigned>(i))) {
    v = ov;
    i = oi;
  }
}

// argmin_fold with the lane `mask` away.
__device__ __forceinline__ void argmin_xor(float& v, int& i, int mask) {
  argmin_fold(v, i, __shfl_xor_sync(0xffffffffu, v, mask),
              __shfl_xor_sync(0xffffffffu, i, mask));
}

// Keep the candidate `c` of bucketed row `row` if it is below the running
// minimum (the first of equal minima stays).
__device__ __forceinline__ void keep_min(float& v, int& i, float c, int row) {
  if (c < v) {
    v = c;
    i = row;
  }
}

// FEELVOS normalization of a squared distance: 1 - 2 / (1 + exp(min(d, 30))).
__device__ __forceinline__ float normalize_distance(float d) {
  return 1.f - 2.f / (1.f + expf(fminf(d, 30.f)));
}

// Squared distance from (min over keys of |k|^2 - 2 q.k) and |q|^2,
// clamped to [0, kBig] and normalized.
__device__ __forceinline__ float finish_distance(float emin, float qn) {
  return normalize_distance(fminf(fmaxf(emin + qn, 0.f), kBig));
}

// x rounded to TF32 (to nearest, ties away): the f32 bit pattern with the
// low 13 bits zero
__device__ __forceinline__ uint32_t tf32_rna(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}

}  // namespace manet
