// Global matching on the CUDA cores (f32 FMA), shared by kernel 1's f32
// variant (global_matching.cu) and the ring step (ring_matching.cu,
// kernel 6), so that both fold every (query, key) pair with the same
// arithmetic: the cross term is one fmaf chain over the channels in
// ascending order, the candidate is that plus |k|^2, |q|^2 is the same
// fmaf chain, and every fold is an exact min.
//
// A block owns 64 queries and walks every k-block in 64-key tiles, 4 x 4
// outputs per thread; each tile is folded into a running row-min right
// away and, at the end of its k-block, into the block's (queries, O)
// accumulator in shared memory.
//
// The ring step carries that accumulator between launches: `acc_in`
// (nullptr: start at kBig) seeds it with the running minima of the shards
// folded so far, and `acc_out` (nullptr: finalize into `out`) takes it
// back un-normalized instead of the finish. Kernel 1 passes nullptr for
// both.
#pragma once

#include <stdint.h>

#include "common.cuh"

namespace manet {

constexpr int O_MAX = 16;      // objects per accumulator row
constexpr int TILE_K = 64;     // keys per tile; divides block_k

// Fold (v, i) with the lane `mask` away: the smaller value, and of equal
// values the lower row (-1, no row yet, counts as the highest).
__device__ __forceinline__ void argmin_xor(float& v, int& i, int mask) {
  const float ov = __shfl_xor_sync(0xffffffffu, v, mask);
  const int oi = __shfl_xor_sync(0xffffffffu, i, mask);
  if (ov < v || (ov == v && static_cast<unsigned>(oi) < static_cast<unsigned>(i))) {
    v = ov;
    i = oi;
  }
}

// Keep the candidate `c` of bucketed row `row` if it is below the running
// minimum (the first of equal minima stays).
__device__ __forceinline__ void keep_min(float& v, int& i, float c, int row) {
  if (c < v) {
    v = c;
    i = row;
  }
}

constexpr int FMA_TQ = 64;       // queries per block
constexpr int FMA_CK = 32;       // channels per staged key chunk
constexpr int FMA_C_MAX = 128;   // channels held for the query tile
constexpr int FMA_PAD = 4;       // keeps float4 rows aligned, spreads banks
constexpr int FMA_THREADS = 256; // 16 x 16 threads, 4 x 4 outputs each

// The launch's arguments are valid for global_matching_fma.
inline bool fma_shape_ok(long long nq, int c, int nkb, int block_k,
                         int num_obj) {
  return nq > 0 && c > 0 && c <= FMA_C_MAX && c % FMA_CK == 0 &&
         block_k > 0 && block_k % TILE_K == 0 && num_obj > 0 &&
         num_obj <= O_MAX && nkb >= 0;
}

template <bool ARGMIN>
__global__ void __launch_bounds__(FMA_THREADS)
global_matching_fma(const float* __restrict__ query,
                    const float* __restrict__ neg2,
                    const float* __restrict__ sqnorm,
                    const int* __restrict__ block_obj,
                    float* __restrict__ out, int* __restrict__ idx,
                    const float* acc_in, float* acc_out,
                    int64_t nq, int c, int nkb, int block_k, int num_obj) {
  __shared__ __align__(16) float qs[FMA_C_MAX][FMA_TQ + FMA_PAD];  // transposed
  __shared__ __align__(16) float kc[FMA_CK][TILE_K + FMA_PAD];     // transposed
  __shared__ float acc[ARGMIN ? 1 : FMA_TQ][O_MAX];
  __shared__ float qn[FMA_TQ];

  const int tid = threadIdx.x;
  const int tx = tid & 15;  // keys tx*4 .. tx*4+3 of a tile
  const int ty = tid >> 4;  // queries ty*4 .. ty*4+3 of the block
  const int64_t q0 = static_cast<int64_t>(blockIdx.x) * FMA_TQ;

  for (int i = tid; i < FMA_TQ * c; i += FMA_THREADS) {
    const int row = i / c, col = i - row * c;
    const int64_t gq = q0 + row;
    qs[col][row] = gq < nq ? query[gq * c + col] : 0.f;
  }
  if constexpr (ARGMIN) {
    // |q|^2 first, and the empty-object answer prefilled by the thread
    // (tx == 0) that writes the row's results later
    __syncthreads();
    if (tid < FMA_TQ) {
      float s = 0.f;
      for (int col = 0; col < c; ++col) s = fmaf(qs[col][tid], qs[col][tid], s);
      qn[tid] = s;
    }
    __syncthreads();
    if (tx == 0) {
      for (int i = 0; i < 4; ++i) {
        const int64_t gq = q0 + ty * 4 + i;
        if (gq >= nq) continue;
        for (int o = 0; o < num_obj; ++o) {
          out[gq * num_obj + o] = manet::finish_distance(manet::kBig, qn[ty * 4 + i]);
          idx[gq * num_obj + o] = -1;
        }
      }
    }
  } else {
    // the running minima of the shards folded before (ring step) or none
    for (int i = tid; i < FMA_TQ * O_MAX; i += FMA_THREADS) {
      const int row = i / O_MAX, o = i - row * O_MAX;
      const int64_t gq = q0 + row;
      (&acc[0][0])[i] = (acc_in == nullptr || o >= num_obj || gq >= nq)
                            ? manet::kBig : acc_in[gq * num_obj + o];
    }
  }

  // running minima (and rows) of this thread's queries: per k-block, or
  // (argmin) per object, whose blocks are consecutive
  float bmin[4] = {manet::kBig, manet::kBig, manet::kBig, manet::kBig};
  int barg[4] = {-1, -1, -1, -1};
  for (int kb = 0; kb < nkb; ++kb) {
    const int obj = block_obj[kb];
    if (obj < 0 || obj >= num_obj) continue;  // slack block (uniform branch)
    for (int kt = 0; kt < block_k; kt += TILE_K) {
      const int64_t k0 = static_cast<int64_t>(kb) * block_k + kt;
      float r[4][4] = {};
      for (int c0 = 0; c0 < c; c0 += FMA_CK) {
        __syncthreads();  // the previous chunk is consumed (and qs is ready)
        for (int i = tid; i < TILE_K * FMA_CK; i += FMA_THREADS) {
          const int row = i / FMA_CK, col = i - row * FMA_CK;
          kc[col][row] = neg2[(k0 + row) * c + c0 + col];
        }
        __syncthreads();
#pragma unroll 8
        for (int j = 0; j < FMA_CK; ++j) {
          const float4 av = *reinterpret_cast<const float4*>(&qs[c0 + j][ty * 4]);
          const float4 bv = *reinterpret_cast<const float4*>(&kc[j][tx * 4]);
          const float a4[4] = {av.x, av.y, av.z, av.w};
          const float b4[4] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int jj = 0; jj < 4; ++jj) r[i][jj] = fmaf(a4[i], b4[jj], r[i][jj]);
        }
      }
      float sq[4];
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) sq[jj] = sqnorm[k0 + tx * 4 + jj];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) {
          if constexpr (ARGMIN)
            keep_min(bmin[i], barg[i], r[i][jj] + sq[jj],
                     static_cast<int>(k0) + tx * 4 + jj);
          else
            bmin[i] = fminf(bmin[i], r[i][jj] + sq[jj]);
        }
    }
    if constexpr (ARGMIN) {
      if (kb + 1 < nkb && block_obj[kb + 1] == obj) continue;  // object goes on
      // (min, row) over the 16 threads (lane bits 0..3) sharing these queries
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int off = 8; off > 0; off >>= 1) argmin_xor(bmin[i], barg[i], off);
      if (tx == 0) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int64_t gq = q0 + ty * 4 + i;
          if (gq < nq) {
            out[gq * num_obj + obj] = manet::finish_distance(bmin[i], qn[ty * 4 + i]);
            idx[gq * num_obj + obj] = barg[i];
          }
        }
      }
    } else {
      // min over the 16 threads (lane bits 0..3) that share these queries
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int off = 8; off > 0; off >>= 1)
          bmin[i] = fminf(bmin[i], __shfl_xor_sync(0xffffffffu, bmin[i], off));
      if (tx == 0) {
#pragma unroll
        for (int i = 0; i < 4; ++i)
          acc[ty * 4 + i][obj] = fminf(acc[ty * 4 + i][obj], bmin[i]);
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      bmin[i] = manet::kBig;
      barg[i] = -1;
    }
  }

  if constexpr (!ARGMIN) {
    __syncthreads();
    if (acc_out != nullptr) {  // hand the minima to the next ring step
      for (int i = tid; i < FMA_TQ * num_obj; i += FMA_THREADS) {
        const int row = i / num_obj, o = i - row * num_obj;
        const int64_t gq = q0 + row;
        if (gq < nq) acc_out[gq * num_obj + o] = acc[row][o];
      }
      return;
    }
    if (tid < FMA_TQ) {
      float s = 0.f;
      for (int col = 0; col < c; ++col) s = fmaf(qs[col][tid], qs[col][tid], s);
      qn[tid] = s;
    }
    __syncthreads();
    for (int i = tid; i < FMA_TQ * num_obj; i += FMA_THREADS) {
      const int row = i / num_obj, o = i - row * num_obj;
      const int64_t gq = q0 + row;
      if (gq < nq) out[gq * num_obj + o] = manet::finish_distance(acc[row][o], qn[row]);
    }
  }
}

}  // namespace manet
