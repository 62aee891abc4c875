// Global matching against a bucketed reference, for Hopper (sm_90a).
//
// Replaces the TPU kernel cvpr2020_manet_tpu/ops/matching_pallas.py
// `_matching_kernel` (called by `global_matching_prepared`). For every
// query row q and object o it computes
//
//   out[q, o] = normalize(clamp(|q|^2 + min_{k in o} (|k|^2 - 2 q.k), 0, 1e8))
//
// over a reference that `prepare_ref` sorted into block_k-row blocks, one
// object per block (`block_obj`; slack blocks carry a sentinel >= num_obj
// and are skipped). `neg2` holds -2k in the model dtype and `sqnorm` the
// f32 |k|^2 (1e8 on padding rows), so a tile needs one product and one add
// per pair. An object without blocks keeps 1e8 and normalizes to 1.0.
//
// The TPU grid's sequential k axis becomes a loop inside the block: a
// block owns a tile of queries and walks every k-block; each key tile is
// folded into a running row-min right away and, at the end of its k-block,
// into the block's (queries, O) accumulator in shared memory. The distance
// matrix never reaches device memory.
//
// Bound on an H100: the cross term is 2 Nq Nk C operations against
// Nq C + Nk C input elements, far above the card's ridge point, so the
// function is bound by operations (989 TFLOP/s bf16 on the tensor cores).
//
// With ARGMIN (entry `manet_global_matching_argmin`) the kernels also
// return each minimum's row in the bucketed layout (-1 for an object
// without rows): this replaces the TPU kernel `_matching_kernel_argmin`
// (called by `global_matching_prepared_argmin`), the forward of the
// training path's argmin-routed matching. Ties go to the lowest bucketed
// row, as on the TPU: a thread visits its keys in ascending row order and
// keeps the first of equal minima (strict <), and the reduction across
// threads takes the lower row of equal values. The argmin variants hold
// the running (min, row) of the current object in registers, because an
// object's blocks are consecutive: when its last block is done the row's
// owner thread writes the result straight to `out` / `idx` (prefilled
// with the empty-object answer). They need no (queries, O) accumulator in
// shared memory, which would not fit beside the key tiles.
//
// Two variants:
// - bf16 with C = 128 (the model's path): tensor cores through
//   `mma.sync.m16n8k16` (bf16 in, f32 accumulate). A block of 4 warps owns
//   128 queries; each warp keeps the A fragments of its 32 queries x 128
//   channels in registers for the whole kernel and reuses every B fragment
//   for two 16-row tiles. 64-key tiles of -2k stream through shared memory
//   with cp.async, double-buffered. `mma.sync` reaches a fraction of the
//   `wgmma` peak; a warpgroup (wgmma + TMA) version is the next step.
// - f32 (the tiny test config): plain FMA on the CUDA cores, 64 queries x
//   64 keys per tile, 4 x 4 outputs per thread.
//
// The int8 kernel (entry `manet_global_matching_int8`) replaces the TPU
// kernel `_matching_kernel_int8` (called by `global_matching_prepared_int8`,
// the opt-in int8 serving mode). Query rows q^ and keys k^ are symmetric
// int8 (per-row query scales s_q, one key scale s_k); `sqnorm` holds
// s_k^2 |k^|^2 and `scales` per query row [-2 s_q s_k, s_q^2], so
//
//   e = float(q^.k^) * scales[0] + sqnorm,   d = min_k e + float(|q^|^2) * scales[1]
//
// is the exact f32 distance between the dequantized vectors. It keeps the
// bf16 kernel's layout with `mma.sync.m16n8k32` (int8 in, int32
// accumulate): an int8 row of 128 channels is 128 bytes, so a tile holds 128
// keys in the shared memory that holds 64 bf16 keys. The cross term is
// exact in int32, and below 128 * 127^2 = 2,064,512 < 2^22 in magnitude, so
// the accumulators start at the bits of the float 1.5 * 2^23: the sum then
// reads as the float 1.5 * 2^23 + cross, and one exact subtraction gives
// float(cross) without the slower int-to-float conversion. The epilogue's
// multiply and add are rounded separately (__fmul_rn, __fadd_rn, no FMA
// contraction), in the order of the plain version, so kernel and plain
// version differ only in the exp of the normalization. Bound on an H100:
// operations (1,979 TOP/s int8 dense); at these shapes the f32 epilogue per
// (query, key) pair costs about as much issue time as the products.

#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int O_MAX = 16;      // objects per accumulator row
constexpr int TILE_K = 64;     // keys per tile; divides block_k

// ------------------------------------------------------------ tensor cores

constexpr int MMA_C = 128;                 // channels (the padded embedding)
constexpr int MMA_WARPS = 4;
constexpr int MMA_ROWS = 32;               // queries per warp (2 m16 tiles)
constexpr int MMA_TQ = MMA_WARPS * MMA_ROWS;
constexpr int MMA_PITCH = MMA_C + 8;       // bf16 per staged key row
constexpr int MMA_KSTEPS = MMA_C / 16;

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
__device__ __forceinline__ void cp_async_wait_one() {
  asm volatile("cp.async.wait_group 1;\n" ::);
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// First block at or after kb that holds an object (slack blocks skipped).
__device__ __forceinline__ int next_block(const int* __restrict__ block_obj,
                                          int kb, int nkb, int num_obj) {
  while (kb < nkb && static_cast<unsigned>(block_obj[kb]) >= static_cast<unsigned>(num_obj)) ++kb;
  return kb;
}

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

template <bool ARGMIN>
__global__ void __launch_bounds__(MMA_WARPS * 32, 3)
global_matching_mma_bf16(const __nv_bfloat16* __restrict__ query,
                         const __nv_bfloat16* __restrict__ neg2,
                         const float* __restrict__ sqnorm,
                         const int* __restrict__ block_obj,
                         float* __restrict__ out, int* __restrict__ idx,
                         int64_t nq, int nkb, int block_k, int num_obj) {
  __shared__ __align__(16) __nv_bfloat16 ks[2][TILE_K * MMA_PITCH];
  __shared__ float acc[ARGMIN ? 1 : MMA_TQ][O_MAX];
  __shared__ float qn[ARGMIN ? 1 : MMA_TQ];

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;   // mma fragment coordinates
  const int64_t q0 = static_cast<int64_t>(blockIdx.x) * MMA_TQ;

  if constexpr (!ARGMIN) {
    for (int i = tid; i < MMA_TQ * O_MAX; i += MMA_WARPS * 32)
      (&acc[0][0])[i] = manet::kBig;
  }

  // A fragments of this warp's 32 queries (rows g, g+8 of two m16 tiles)
  // and their partial |q|^2 over the channels this lane holds.
  uint32_t a[2][MMA_KSTEPS][4];
  float qsq[2][2] = {{0.f, 0.f}, {0.f, 0.f}};
#pragma unroll
  for (int m = 0; m < 2; ++m) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int64_t row = q0 + warp * MMA_ROWS + m * 16 + g + half * 8;
      const uint32_t* src = reinterpret_cast<const uint32_t*>(query + row * MMA_C);
#pragma unroll
      for (int s = 0; s < MMA_KSTEPS; ++s) {
        const uint32_t lo = row < nq ? src[s * 8 + t] : 0u;       // cols 2t, 2t+1
        const uint32_t hi = row < nq ? src[s * 8 + 4 + t] : 0u;   // cols 2t+8, 2t+9
        a[m][s][half] = lo;
        a[m][s][2 + half] = hi;
        const __nv_bfloat162 l2 = *reinterpret_cast<const __nv_bfloat162*>(&lo);
        const __nv_bfloat162 h2 = *reinterpret_cast<const __nv_bfloat162*>(&hi);
        const float2 lf = __bfloat1622float2(l2), hf = __bfloat1622float2(h2);
        qsq[m][half] += lf.x * lf.x + lf.y * lf.y + hf.x * hf.x + hf.y * hf.y;
      }
    }
  }

  // (argmin) the full |q|^2 of each row in every lane of its quad, and
  // the empty-object answer prefilled by the quad's lane 0, which also
  // writes the row's results later (same thread, program order)
  int rarg[2][2] = {{-1, -1}, {-1, -1}};
  if constexpr (ARGMIN) {
#pragma unroll
    for (int m = 0; m < 2; ++m) {
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        float v = qsq[m][half];
        v += __shfl_xor_sync(0xffffffffu, v, 1);
        v += __shfl_xor_sync(0xffffffffu, v, 2);
        qsq[m][half] = v;
        const int64_t row = q0 + warp * MMA_ROWS + m * 16 + g + half * 8;
        if (t == 0 && row < nq) {
          for (int o = 0; o < num_obj; ++o) {
            out[row * num_obj + o] = manet::finish_distance(manet::kBig, v);
            idx[row * num_obj + o] = -1;
          }
        }
      }
    }
  }

  // stage tile (kb, kt) of -2k into buffer `buf`: 64 rows x 256 bytes
  auto load_tile = [&](int buf, int kb, int kt) {
    const __nv_bfloat16* src = neg2 + (static_cast<int64_t>(kb) * block_k + kt) * MMA_C;
#pragma unroll
    for (int j = 0; j < TILE_K * MMA_C / 8 / (MMA_WARPS * 32); ++j) {
      const int idx = tid + j * MMA_WARPS * 32;
      const int row = idx >> 4, chunk = idx & 15;
      cp_async16(&ks[buf][row * MMA_PITCH + chunk * 8], src + row * MMA_C + chunk * 8);
    }
  };

  float rmin[2][2] = {{manet::kBig, manet::kBig}, {manet::kBig, manet::kBig}};
  int kb = next_block(block_obj, 0, nkb, num_obj), kt = 0, buf = 0;
  if (kb < nkb) load_tile(0, kb, 0);
  cp_async_commit();
  while (kb < nkb) {
    int nkt = kt + TILE_K, nkb2 = kb;
    if (nkt == block_k) {
      nkt = 0;
      nkb2 = next_block(block_obj, kb + 1, nkb, num_obj);
    }
    if (nkb2 < nkb) load_tile(buf ^ 1, nkb2, nkt);
    cp_async_commit();
    cp_async_wait_one();   // this tile has landed
    __syncthreads();

    const __nv_bfloat16* tile = ks[buf];
    const float* sq = sqnorm + static_cast<int64_t>(kb) * block_k + kt;
#pragma unroll 1
    for (int ns = 0; ns < TILE_K / 8; ns += 2) {
      float d[2][2][4] = {};   // [n-subtile][m-tile][fragment]
#pragma unroll
      for (int s = 0; s < MMA_KSTEPS; ++s) {
#pragma unroll
        for (int n = 0; n < 2; ++n) {
          const uint32_t* brow = reinterpret_cast<const uint32_t*>(
              tile + ((ns + n) * 8 + g) * MMA_PITCH + s * 16);
          const uint32_t b0 = brow[t], b1 = brow[4 + t];
          mma_bf16(d[n][0], a[0][s], b0, b1);
          mma_bf16(d[n][1], a[1][s], b0, b1);
        }
      }
#pragma unroll
      for (int n = 0; n < 2; ++n) {
        const float2 s2 = *reinterpret_cast<const float2*>(sq + (ns + n) * 8 + 2 * t);
#pragma unroll
        for (int m = 0; m < 2; ++m) {
          if constexpr (ARGMIN) {
            // columns 2t, 2t+1 of subtile ns+n, in ascending row order
            const int col = kb * block_k + kt + (ns + n) * 8 + 2 * t;
            keep_min(rmin[m][0], rarg[m][0], d[n][m][0] + s2.x, col);
            keep_min(rmin[m][0], rarg[m][0], d[n][m][1] + s2.y, col + 1);
            keep_min(rmin[m][1], rarg[m][1], d[n][m][2] + s2.x, col);
            keep_min(rmin[m][1], rarg[m][1], d[n][m][3] + s2.y, col + 1);
          } else {
            rmin[m][0] = fminf(rmin[m][0], fminf(d[n][m][0] + s2.x, d[n][m][1] + s2.y));
            rmin[m][1] = fminf(rmin[m][1], fminf(d[n][m][2] + s2.x, d[n][m][3] + s2.y));
          }
        }
      }
    }

    if constexpr (ARGMIN) {
      const int obj = block_obj[kb];
      // the object's last block: its blocks are consecutive
      if (nkb2 >= nkb || block_obj[nkb2] != obj) {
#pragma unroll
        for (int m = 0; m < 2; ++m) {
#pragma unroll
          for (int half = 0; half < 2; ++half) {
            float v = rmin[m][half];
            int i = rarg[m][half];
            argmin_xor(v, i, 1);
            argmin_xor(v, i, 2);
            const int64_t row = q0 + warp * MMA_ROWS + m * 16 + g + half * 8;
            if (t == 0 && row < nq) {
              out[row * num_obj + obj] = manet::finish_distance(v, qsq[m][half]);
              idx[row * num_obj + obj] = i;
            }
            rmin[m][half] = manet::kBig;
            rarg[m][half] = -1;
          }
        }
      }
    } else if (nkb2 != kb) {   // the k-block ends: fold its minima into its object
      const int obj = block_obj[kb];
#pragma unroll
      for (int m = 0; m < 2; ++m) {
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          float v = rmin[m][half];
          v = fminf(v, __shfl_xor_sync(0xffffffffu, v, 1));
          v = fminf(v, __shfl_xor_sync(0xffffffffu, v, 2));
          if (t == 0) {
            float* cell = &acc[warp * MMA_ROWS + m * 16 + g + half * 8][obj];
            *cell = fminf(*cell, v);
          }
          rmin[m][half] = manet::kBig;
        }
      }
    }
    __syncthreads();   // the tile is consumed before its buffer refills
    kb = nkb2;
    kt = nkt;
    buf ^= 1;
  }
  if constexpr (!ARGMIN) {   // (argmin: every object was written as it ended)
#pragma unroll
    for (int m = 0; m < 2; ++m) {
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        float v = qsq[m][half];
        v += __shfl_xor_sync(0xffffffffu, v, 1);
        v += __shfl_xor_sync(0xffffffffu, v, 2);
        if (t == 0) qn[warp * MMA_ROWS + m * 16 + g + half * 8] = v;
      }
    }
    __syncthreads();
    for (int i = tid; i < MMA_TQ * num_obj; i += MMA_WARPS * 32) {
      const int row = i / num_obj, o = i - row * num_obj;
      const int64_t gq = q0 + row;
      if (gq < nq) out[gq * num_obj + o] = manet::finish_distance(acc[row][o], qn[row]);
    }
  }
}

// ------------------------------------------------------ int8 tensor cores

constexpr int I8_TILE_K = 128;              // keys per tile
constexpr int I8_PITCH = MMA_C + 16;        // bytes per staged key row
constexpr int I8_KSTEPS = MMA_C / 32;       // m16n8k32 steps over the channels
constexpr int I8_MAGIC = 0x4B400000;        // the bits of the float 1.5 * 2^23
constexpr float I8_MAGIC_F = 12582912.f;    // 1.5 * 2^23

__device__ __forceinline__ void mma_s8(int (&d)[4], const uint32_t (&a)[4],
                                       uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// e = float(cross) * sc + kn, from an accumulator that started at I8_MAGIC
__device__ __forceinline__ float int8_candidate(int acc, float sc, float kn) {
  const float cross = __fsub_rn(__int_as_float(acc), I8_MAGIC_F);
  return __fadd_rn(__fmul_rn(cross, sc), kn);
}

__global__ void __launch_bounds__(MMA_WARPS * 32, 4)
global_matching_mma_int8(const int8_t* __restrict__ query,
                         const int8_t* __restrict__ keys,
                         const float* __restrict__ sqnorm,
                         const int* __restrict__ block_obj,
                         const float* __restrict__ scales,
                         float* __restrict__ out, int64_t nq, int nkb,
                         int block_k, int num_obj) {
  __shared__ __align__(16) int8_t ks[2][I8_TILE_K * I8_PITCH];
  __shared__ float acc[MMA_TQ][O_MAX];
  __shared__ float qn[MMA_TQ];

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;   // mma fragment coordinates
  const int64_t q0 = static_cast<int64_t>(blockIdx.x) * MMA_TQ;

  for (int i = tid; i < MMA_TQ * O_MAX; i += MMA_WARPS * 32)
    (&acc[0][0])[i] = manet::kBig;

  // A fragments of this warp's 32 queries (rows g, g+8 of two m16 tiles;
  // each register holds 4 channels), the partial integer |q^|^2 over the
  // channels this lane holds, and each row's cross-term scale
  uint32_t a[2][I8_KSTEPS][4];
  int qsq[2][2] = {{0, 0}, {0, 0}};
  float sc0[2][2];
#pragma unroll
  for (int m = 0; m < 2; ++m) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int64_t row = q0 + warp * MMA_ROWS + m * 16 + g + half * 8;
      const uint32_t* src = reinterpret_cast<const uint32_t*>(query + row * MMA_C);
#pragma unroll
      for (int s = 0; s < I8_KSTEPS; ++s) {
        const uint32_t lo = row < nq ? src[s * 8 + t] : 0u;       // cols 4t..4t+3
        const uint32_t hi = row < nq ? src[s * 8 + 4 + t] : 0u;   // cols 16+4t..
        a[m][s][half] = lo;
        a[m][s][2 + half] = hi;
        qsq[m][half] = __dp4a(static_cast<int>(lo), static_cast<int>(lo), qsq[m][half]);
        qsq[m][half] = __dp4a(static_cast<int>(hi), static_cast<int>(hi), qsq[m][half]);
      }
      sc0[m][half] = row < nq ? scales[row * 2] : 0.f;
    }
  }

  // stage tile (kb, kt) of k^ into buffer `buf`: 128 rows x 128 bytes
  auto load_tile = [&](int buf, int kb, int kt) {
    const int8_t* src = keys + (static_cast<int64_t>(kb) * block_k + kt) * MMA_C;
#pragma unroll
    for (int j = 0; j < I8_TILE_K * MMA_C / 16 / (MMA_WARPS * 32); ++j) {
      const int idx = tid + j * MMA_WARPS * 32;
      const int row = idx >> 3, chunk = idx & 7;
      cp_async16(&ks[buf][row * I8_PITCH + chunk * 16], src + row * MMA_C + chunk * 16);
    }
  };

  float rmin[2][2] = {{manet::kBig, manet::kBig}, {manet::kBig, manet::kBig}};
  int kb = next_block(block_obj, 0, nkb, num_obj), kt = 0, buf = 0;
  if (kb < nkb) load_tile(0, kb, 0);
  cp_async_commit();
  while (kb < nkb) {
    int nkt = kt + I8_TILE_K, nkb2 = kb;
    if (nkt == block_k) {
      nkt = 0;
      nkb2 = next_block(block_obj, kb + 1, nkb, num_obj);
    }
    if (nkb2 < nkb) load_tile(buf ^ 1, nkb2, nkt);
    cp_async_commit();
    cp_async_wait_one();   // this tile has landed
    __syncthreads();

    const int8_t* tile = ks[buf];
    const float* sq = sqnorm + static_cast<int64_t>(kb) * block_k + kt;
#pragma unroll 1
    for (int ns = 0; ns < I8_TILE_K / 8; ns += 2) {
      int d[2][2][4];   // [n-subtile][m-tile][fragment]
#pragma unroll
      for (int n = 0; n < 2; ++n)
#pragma unroll
        for (int m = 0; m < 2; ++m)
#pragma unroll
          for (int i = 0; i < 4; ++i) d[n][m][i] = I8_MAGIC;
#pragma unroll
      for (int s = 0; s < I8_KSTEPS; ++s) {
#pragma unroll
        for (int n = 0; n < 2; ++n) {
          const uint32_t* brow = reinterpret_cast<const uint32_t*>(
              tile + ((ns + n) * 8 + g) * I8_PITCH + s * 32);
          const uint32_t b0 = brow[t], b1 = brow[4 + t];
          mma_s8(d[n][0], a[0][s], b0, b1);
          mma_s8(d[n][1], a[1][s], b0, b1);
        }
      }
#pragma unroll
      for (int n = 0; n < 2; ++n) {
        const float2 s2 = *reinterpret_cast<const float2*>(sq + (ns + n) * 8 + 2 * t);
#pragma unroll
        for (int m = 0; m < 2; ++m) {
          rmin[m][0] = fminf(rmin[m][0],
                             fminf(int8_candidate(d[n][m][0], sc0[m][0], s2.x),
                                   int8_candidate(d[n][m][1], sc0[m][0], s2.y)));
          rmin[m][1] = fminf(rmin[m][1],
                             fminf(int8_candidate(d[n][m][2], sc0[m][1], s2.x),
                                   int8_candidate(d[n][m][3], sc0[m][1], s2.y)));
        }
      }
    }

    if (nkb2 != kb) {   // the k-block ends: fold its minima into its object
      const int obj = block_obj[kb];
#pragma unroll
      for (int m = 0; m < 2; ++m) {
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          float v = rmin[m][half];
          v = fminf(v, __shfl_xor_sync(0xffffffffu, v, 1));
          v = fminf(v, __shfl_xor_sync(0xffffffffu, v, 2));
          if (t == 0) {
            float* cell = &acc[warp * MMA_ROWS + m * 16 + g + half * 8][obj];
            *cell = fminf(*cell, v);
          }
          rmin[m][half] = manet::kBig;
        }
      }
    }
    __syncthreads();   // the tile is consumed before its buffer refills
    kb = nkb2;
    kt = nkt;
    buf ^= 1;
  }

  // s_q^2 |q^|^2 per row (the integer sum is exact), then the finalize
#pragma unroll
  for (int m = 0; m < 2; ++m) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      int v = qsq[m][half];
      v += __shfl_xor_sync(0xffffffffu, v, 1);
      v += __shfl_xor_sync(0xffffffffu, v, 2);
      const int local = warp * MMA_ROWS + m * 16 + g + half * 8;
      const int64_t row = q0 + local;
      if (t == 0)
        qn[local] = row < nq ? __fmul_rn(static_cast<float>(v), scales[row * 2 + 1]) : 0.f;
    }
  }
  __syncthreads();
  for (int i = tid; i < MMA_TQ * num_obj; i += MMA_WARPS * 32) {
    const int row = i / num_obj, o = i - row * num_obj;
    const int64_t gq = q0 + row;
    if (gq < nq) {
      const float d = fminf(fmaxf(__fadd_rn(acc[row][o], qn[row]), 0.f), manet::kBig);
      out[gq * num_obj + o] = manet::normalize_distance(d);
    }
  }
}

// ------------------------------------------------------------- CUDA cores

constexpr int FMA_TQ = 64;       // queries per block
constexpr int FMA_CK = 32;       // channels per staged key chunk
constexpr int FMA_C_MAX = 128;   // channels held for the query tile
constexpr int FMA_PAD = 4;       // keeps float4 rows aligned, spreads banks
constexpr int FMA_THREADS = 256; // 16 x 16 threads, 4 x 4 outputs each

template <bool ARGMIN>
__global__ void __launch_bounds__(FMA_THREADS)
global_matching_fma(const float* __restrict__ query,
                    const float* __restrict__ neg2,
                    const float* __restrict__ sqnorm,
                    const int* __restrict__ block_obj,
                    float* __restrict__ out, int* __restrict__ idx,
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
    for (int i = tid; i < FMA_TQ * O_MAX; i += FMA_THREADS) (&acc[0][0])[i] = manet::kBig;
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

template <bool ARGMIN>
int launch(const void* query, const void* neg2, const void* sqnorm,
           const void* block_obj, void* out, void* idx, long long nq, int c,
           int nkb, int block_k, int num_obj, int is_bf16, void* stream) {
  if (nq <= 0 || c <= 0 || c > FMA_C_MAX || c % FMA_CK != 0 || block_k <= 0 ||
      block_k % TILE_K != 0 || num_obj <= 0 || num_obj > O_MAX || nkb < 0 ||
      (is_bf16 && c != MMA_C) || (ARGMIN && idx == nullptr) ||
      (ARGMIN && static_cast<long long>(nkb) * block_k > 0x7fffffffLL))
    return static_cast<int>(cudaErrorInvalidValue);
  auto s = static_cast<cudaStream_t>(stream);
  const auto* bo = static_cast<const int*>(block_obj);
  const auto* sq = static_cast<const float*>(sqnorm);
  auto* o = static_cast<float*>(out);
  auto* ix = static_cast<int*>(idx);
  if (is_bf16) {
    const dim3 grid(static_cast<unsigned>((nq + MMA_TQ - 1) / MMA_TQ));
    global_matching_mma_bf16<ARGMIN><<<grid, MMA_WARPS * 32, 0, s>>>(
        static_cast<const __nv_bfloat16*>(query),
        static_cast<const __nv_bfloat16*>(neg2), sq, bo, o, ix, nq, nkb,
        block_k, num_obj);
  } else {
    const dim3 grid(static_cast<unsigned>((nq + FMA_TQ - 1) / FMA_TQ));
    global_matching_fma<ARGMIN><<<grid, FMA_THREADS, 0, s>>>(
        static_cast<const float*>(query), static_cast<const float*>(neg2), sq,
        bo, o, ix, nq, c, nkb, block_k, num_obj);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// query (nq, c) and neg2 (nkb * block_k, c) in f32 (is_bf16 = 0) or in
// bf16 with c = 128 (is_bf16 = 1); sqnorm (nkb, block_k) f32; block_obj
// (nkb,) int32; out (nq, num_obj) f32. All contiguous on the current
// device, query and neg2 16-byte aligned.
extern "C" int manet_global_matching(const void* query, const void* neg2,
                                     const void* sqnorm, const void* block_obj,
                                     void* out, long long nq, int c, int nkb,
                                     int block_k, int num_obj, int is_bf16,
                                     void* stream) {
  return launch<false>(query, neg2, sqnorm, block_obj, out, nullptr, nq, c,
                       nkb, block_k, num_obj, is_bf16, stream);
}

// As manet_global_matching, plus idx (nq, num_obj) int32: the bucketed
// row of each minimum, -1 for an object without rows.
extern "C" int manet_global_matching_argmin(
    const void* query, const void* neg2, const void* sqnorm,
    const void* block_obj, void* out, void* idx, long long nq, int c, int nkb,
    int block_k, int num_obj, int is_bf16, void* stream) {
  return launch<true>(query, neg2, sqnorm, block_obj, out, idx, nq, c, nkb,
                      block_k, num_obj, is_bf16, stream);
}

// The int8 kernel: query (nq, 128) and keys (nkb * block_k, 128) int8,
// sqnorm (nkb, block_k) f32 = s_k^2 |k^|^2 (1e8 on padding rows), block_obj
// (nkb,) int32, scales (nq, 2) f32 = [-2 s_q s_k, s_q^2] per query row; out
// (nq, num_obj) f32. All contiguous on the current device, query and keys
// 16-byte aligned.
extern "C" int manet_global_matching_int8(
    const void* query, const void* keys, const void* sqnorm,
    const void* block_obj, const void* scales, void* out, long long nq, int c,
    int nkb, int block_k, int num_obj, void* stream) {
  if (nq <= 0 || c != MMA_C || block_k <= 0 || block_k % I8_TILE_K != 0 ||
      num_obj <= 0 || num_obj > O_MAX || nkb < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(static_cast<unsigned>((nq + MMA_TQ - 1) / MMA_TQ));
  global_matching_mma_int8<<<grid, MMA_WARPS * 32, 0,
                             static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(query), static_cast<const int8_t*>(keys),
      static_cast<const float*>(sqnorm), static_cast<const int*>(block_obj),
      static_cast<const float*>(scales), static_cast<float*>(out), nq, nkb,
      block_k, num_obj);
  return static_cast<int>(cudaGetLastError());
}
