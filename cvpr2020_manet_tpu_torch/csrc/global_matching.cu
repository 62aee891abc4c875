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
// folded into a running row-min right away and, at the end of its object
// (or, in the f32 kernel, of its k-block), into the query's result. The
// distance matrix never reaches device memory.
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
// object's blocks are consecutive, and the row's owner thread writes it
// when the object's last block is done (over the prefilled empty-object
// answer); no (queries, O) accumulator in shared memory is needed.
//
// Key splits. Where the query tiles alone would leave most of the card
// idle (kernel 4 at the training shape, Nq = Nk = 10,816; kernel 3 in the
// batch, Nq = 25,920), the wrapper launches a 2-D grid of query tiles x S
// splits (`splits`, from the SM count by `plan_splits` in
// ops/global_matching_cuda.py: one wave of blocks where the query tiles
// leave room for two splits or more, else two blocks per resident slot),
// each split owning a contiguous run of the live k-blocks (live ordinals
// [s L / S, (s + 1) L / S), L counted on the device). A split writes one partial minimum (with
// ARGMIN, (min, row)) per (query, object) into the scratch buffer, 1e8
// (and -1) for an object it does not touch, and `merge_splits` folds the
// S partials in ascending split order with a strict <, so that the lowest
// bucketed row wins ties across splits as within one (the TPU kernel's
// `dmin < acc` over its k-blocks), then adds |q|^2, clamps and
// normalizes. With S = 1 the kernel writes `out` (/ `idx`) itself.
//
// Five variants, the first three on one `wgmma` template
// (`global_matching_wgmma<ARGMIN, INT8>`: a block of two warpgroups owns
// 128 queries held as A fragments in registers, a cp.async ring of key
// tiles in the 128-byte swizzle that the B descriptor reads, the running
// minimum of the current object in registers, two resident blocks per SM
// so that one block's epilogue overlaps the other's products):
// - bf16 with C = 128 (the model's path, kernel 1): the min epilogue
//   (`<false, false>`) on 128-key tiles (`wgmma.m64n128k16`, a 3-stage
//   ring), no key split (the round's 388,800 queries give some 3,000
//   query tiles). Bound: the products (989 TFLOP/s bf16); the min
//   epilogue (an add and a min per pair on the CUDA cores) comes to about
//   a quarter of it. At the round's shape it reaches about half of the
//   bf16 peak: the products, the key tiles' loads through L2 (Nq / 128
//   passes over the keys, 20 GB) and the epilogue each take a large share
//   of the time and overlap only in part.
// - bf16 argmin (kernel 4): the argmin epilogue (`<true, false>`) on
//   64-key tiles (`wgmma.m64n64k16`, 4 stages), split key range. Bound:
//   the products, with the argmin epilogue (about 4-5 lane operations per
//   candidate: add, compare, two selects) close behind.
// - int8 (kernel 3, `<false, true>`, entry `manet_global_matching_int8`):
//   replaces the TPU kernel `_matching_kernel_int8` (called by
//   `global_matching_prepared_int8`, the opt-in int8 serving mode). Query
//   rows q^ and keys k^ are symmetric int8 (per-row query scales s_q, one
//   key scale s_k); `sqnorm` holds s_k^2 |k^|^2, so
//
//     e = float(q^.k^) * (-2 s_q s_k) + sqnorm,   d = min_k e + float(|q^|^2) * s_q^2
//
//   is the exact f32 distance between the dequantized vectors. The launch
//   takes the float query (bf16 or f32, C <= 128): the prologue quantizes
//   each row as `quantize_rows_int8` does, bit for bit (the row's amax over
//   the quad's lanes, s_q = max(amax, 1e-6) / 127 and x / s_q by IEEE
//   division, ties to even, clamped to +-127, zeros past channel C), forms
//   the A fragments and |q^|^2 (dp4a) in registers, and rounds the scales
//   -2 s_q s_k and s_q^2 in the plain version's order. A 128-channel int8
//   key row is 128 bytes, so a 128-key tile is one swizzle atom, and the
//   descriptor steps 32 bytes per `wgmma.m64n128k32.s32.s8.s8` (4 steps, a
//   4-stage ring). The cross term is exact in int32 and below
//   128 * 127^2 = 2,064,512 < 2^22 in magnitude, so adding the bits of the
//   float 1.5 * 2^23 to it (an integer add) gives the bits of the float
//   1.5 * 2^23 + cross, and one exact subtraction gives float(cross)
//   without the slower int-to-float conversion. (Preloading the
//   accumulators with those bits and accumulating from the first step is
//   the same arithmetic; its 64 moves a tile timed slower.) The
//   epilogue's multiply and add are rounded separately (__fmul_rn,
//   __fadd_rn, no FMA contraction), in the order of the plain version, so
//   kernel and plain version differ only in the exp of the normalization.
//   Bound: the int8 products (1,979 TOP/s dense), with the epilogue (add,
//   subtract, multiply, add, min per pair: 5 lane operations) on the CUDA
//   cores a little longer; the two overlap only in part across the SM's
//   two blocks (products alone and epilogue alone each take about half of
//   the kernel's time).
// - f32 (the f32 stream's memory, the tiny test config): 3xTF32 on the
//   tensor cores through `wgmma` (matching_tf32.cuh, shared with the ring
//   step of ring_matching.cu).
// - f32 argmin (f32 test configurations only): FMA on the CUDA cores, 64
//   queries x 64 keys per tile, 4 x 4 outputs per thread.

#include <stdint.h>

#include <type_traits>

#include "common.cuh"
#include "matching_tf32.cuh"

namespace {

using manet::argmin_xor;
using manet::keep_min;
using manet::O_MAX;

constexpr int C_PAD = 128;                 // channels of a key row (the padded embedding)

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// First block at or after kb that holds an object (slack blocks skipped).
__device__ __forceinline__ int next_block(const int* __restrict__ block_obj,
                                          int kb, int nkb, int num_obj) {
  while (kb < nkb && static_cast<unsigned>(block_obj[kb]) >= static_cast<unsigned>(num_obj)) ++kb;
  return kb;
}

// The k-blocks [lo, hi) of split s of S: the live blocks of ordinals
// [s L / S, (s + 1) L / S), L the number of live blocks (slack blocks
// inside the range are skipped by the walk).
__device__ void split_range(const int* __restrict__ block_obj, int nkb,
                            int num_obj, int s, int splits, int& lo, int& hi) {
  int live = 0;
  for (int kb = 0; kb < nkb; ++kb)
    live += static_cast<unsigned>(block_obj[kb]) < static_cast<unsigned>(num_obj);
  const int first = s * live / splits, last = (s + 1) * live / splits;
  lo = hi = nkb;
  for (int kb = 0, ord = 0; kb < nkb; ++kb) {
    if (static_cast<unsigned>(block_obj[kb]) >= static_cast<unsigned>(num_obj)) continue;
    if (ord == first) lo = kb;
    if (ord == last) {
      hi = kb;
      break;
    }
    ++ord;
  }
}

// ------------ wgmma: kernels 1 (bf16 min), 4 (bf16 argmin), 3 (int8 min)

// Warpgroups per block, m64 each: 2, two blocks an SM. (A block of 4
// warpgroups, one an SM, halves the keys' L2 traffic but timed no faster
// for kernel 1 at the round's shape.)
constexpr int AW_WG = 2;
constexpr int AW_BM = 64 * AW_WG;          // queries per block
constexpr int AW_THREADS = 128 * AW_WG;
// Keys per tile (divides block_k): kernel 4 64, kernels 1 and 3 128, which
// halves the tile's fixed costs (barrier, walk, waits) per key.
__host__ __device__ constexpr int aw_bn(bool argmin) { return argmin ? 64 : 128; }

// The constants of one variant. The ring sits in shared memory from a
// 1024-byte aligned base: each stage's ROW / 128 swizzle atoms (BN keys x
// 128 bytes each: 64 bf16 or 128 int8 channels), then each stage's |k|^2.
template <bool ARGMIN, bool INT8>
struct Aw {
  static constexpr int BN = aw_bn(ARGMIN);
  static constexpr int ROW = INT8 ? C_PAD : 2 * C_PAD;   // bytes of a key row
  static constexpr int KSTEPS = ROW / 32;                 // k-steps of 32 bytes
  static constexpr int STAGES = BN == 64 || INT8 ? 4 : 3; // key tiles in flight
  static constexpr int ATOM = BN * 128;
  static constexpr int STAGE = ROW / 128 * ATOM;
  static constexpr int OFF_SQ = STAGES * STAGE;
  static constexpr int SMEM = OFF_SQ + STAGES * BN * 4 + 1024;   // + alignment
  using Acc = std::conditional_t<INT8, int, float>;
};

// The template's arguments.
struct AwArgs {
  const void* query;      // kernels 1, 4: bf16 (nq, 128); kernel 3: bf16 or f32 (nq, c)
  const void* keys;       // -2k bf16 or k^ int8, (nkb * block_k, 128)
  const float* sqnorm;    // (nkb, block_k)
  const int* block_obj;   // (nkb,)
  const float* key_scale; // kernel 3: s_k, ()
  float* out;             // (nq, num_obj)
  int* idx;               // ARGMIN: (nq, num_obj)
  float* part_v;          // key splits (nullptr: none): (gridDim.y, nq, num_obj)
  int* part_i;            // partial minima, with ARGMIN their rows, and the
  float* part_qn;         // (nq,) |q|^2 from split 0
  int64_t nq;
  int nkb, block_k, num_obj;
  int c, q_bf16, q_vec;   // kernel 3's query: channels, bf16 (else f32), rows of
                          // 128 channels on a 16-byte aligned base
};

// d = A (64 x 16, registers) * B (64 x 16)^T (+ d if `accumulate`), bf16
// in, f32 sums; B K-major in the 128-byte swizzle
__device__ __forceinline__ void tile_mma(float (&d)[32], const uint32_t (&a)[4],
                                         uint64_t b, int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, "
      "%29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(accumulate));
}

// As above with B 128 keys wide (m64n128k16)
__device__ __forceinline__ void tile_mma(float (&d)[64], const uint32_t (&a)[4],
                                         uint64_t b, int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, "
      "%29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, "
      "%43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, "
      "%57, %58, %59, %60, %61, %62, %63}, {%64, %65, %66, %67}, %68, p, 1, 1, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(accumulate));
}

// d = A (64 x 32, registers) * B (128 x 32)^T (+ d if `accumulate`), int8
// in, int32 sums (m64n128k32; the integer form has no scale or transpose)
__device__ __forceinline__ void tile_mma(int (&d)[64], const uint32_t (&a)[4],
                                         uint64_t b, int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, "
      "%29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, "
      "%43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, "
      "%57, %58, %59, %60, %61, %62, %63}, {%64, %65, %66, %67}, %68, p;\n"
      "}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]),
        "+r"(d[5]), "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]),
        "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]),
        "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
        "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]),
        "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]),
        "+r"(d[30]), "+r"(d[31]), "+r"(d[32]), "+r"(d[33]), "+r"(d[34]),
        "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]),
        "+r"(d[45]), "+r"(d[46]), "+r"(d[47]), "+r"(d[48]), "+r"(d[49]),
        "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]),
        "+r"(d[55]), "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]),
        "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(accumulate));
}

// Keep the compiler from moving accumulator accesses across the
// asynchronous products.
template <int N>
__device__ __forceinline__ void fence_acc(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
template <int N>
__device__ __forceinline__ void fence_acc(int (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

constexpr int I8_MAGIC = 0x4B400000;        // the bits of the float 1.5 * 2^23
constexpr float I8_MAGIC_F = 12582912.f;    // 1.5 * 2^23

// A pair's candidate from its accumulator: bf16, the cross term (of -2k)
// plus |k|^2; int8, e = float(cross) * sc + kn from the int32 cross term
__device__ __forceinline__ float candidate(float acc, float, float kn) { return acc + kn; }
__device__ __forceinline__ float candidate(int acc, float sc, float kn) {
  const float cross = __fsub_rn(__int_as_float(acc + I8_MAGIC), I8_MAGIC_F);
  return __fadd_rn(__fmul_rn(cross, sc), kn);
}

// Kernels 1 and 4: the A fragments of this thread's rows (g, g + 8 of its
// warp's 16; the mma.m16n8k16 layout, 16 channels a k-step) straight from
// the bf16 query, and their |q|^2 over the quad.
__device__ __forceinline__ void bf16_fragments(const AwArgs& p, const int64_t (&rows)[2],
                                               int t, uint32_t (&a)[8][4], float (&qn)[2]) {
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const uint32_t* src = static_cast<const uint32_t*>(p.query) + rows[half] * C_PAD / 2;
    qn[half] = 0.f;
#pragma unroll
    for (int s = 0; s < 8; ++s) {
      const uint32_t lo = rows[half] < p.nq ? src[s * 8 + t] : 0u;       // cols 2t, 2t+1
      const uint32_t hi = rows[half] < p.nq ? src[s * 8 + 4 + t] : 0u;   // cols 2t+8, 2t+9
      a[s][half] = lo;
      a[s][2 + half] = hi;
      const float2 lf = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&lo));
      const float2 hf = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&hi));
      qn[half] += lf.x * lf.x + lf.y * lf.y + hf.x * hf.x + hf.y * hf.y;
    }
    qn[half] += __shfl_xor_sync(0xffffffffu, qn[half], 1);
    qn[half] += __shfl_xor_sync(0xffffffffu, qn[half], 2);
  }
}

// Channels ch .. ch + 3 of query row `row` of kernel 3 as floats (zeros
// past the row's c channels and past the last row).
__device__ __forceinline__ void query4(const AwArgs& p, int64_t row, int ch, float (&x)[4]) {
  x[0] = x[1] = x[2] = x[3] = 0.f;
  if (row >= p.nq) return;
  if (p.q_vec && p.q_bf16) {
    const uint2 u = *reinterpret_cast<const uint2*>(
        static_cast<const __nv_bfloat16*>(p.query) + row * C_PAD + ch);
    const float2 lo = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
    const float2 hi = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
    x[0] = lo.x, x[1] = lo.y, x[2] = hi.x, x[3] = hi.y;
  } else if (p.q_vec) {
    const float4 f = *reinterpret_cast<const float4*>(
        static_cast<const float*>(p.query) + row * C_PAD + ch);
    x[0] = f.x, x[1] = f.y, x[2] = f.z, x[3] = f.w;
  } else {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      if (ch + i >= p.c) break;
      const int64_t at = row * p.c + ch + i;
      x[i] = p.q_bf16 ? __bfloat162float(static_cast<const __nv_bfloat16*>(p.query)[at])
                      : static_cast<const float*>(p.query)[at];
    }
  }
}

// Kernel 3's prologue: this thread's rows (g, g + 8) quantized as
// `quantize_rows_int8` (ops/global_matching_cuda.py) quantizes them, bit
// for bit, into the A fragments (the mma.m16n8k32 layout: 32 channels a
// k-step; the quad's 4 lanes hold a row's 128 channels), the cross-term
// scale sc = (-2 s_q) s_k and qn = float(|q^|^2) s_q^2.
__device__ __forceinline__ void int8_fragments(const AwArgs& p, const int64_t (&rows)[2],
                                               int t, uint32_t (&a)[4][4], float (&sc)[2],
                                               float (&qn)[2]) {
  const float s_k = *p.key_scale;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    float x[4][2][4];   // [k-step][bytes 4t.., 16 + 4t..][channel]
    float amax = 0.f;
#pragma unroll
    for (int s = 0; s < 4; ++s)
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        query4(p, rows[half], s * 32 + j * 16 + 4 * t, x[s][j]);
#pragma unroll
        for (int i = 0; i < 4; ++i) amax = fmaxf(amax, fabsf(x[s][j][i]));
      }
    amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, 1));
    amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, 2));
    const float s_q = __fdiv_rn(fmaxf(amax, 1e-6f), 127.f);
    int sq = 0;
#pragma unroll
    for (int s = 0; s < 4; ++s)
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        uint32_t word = 0;
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int v = __float2int_rn(__fdiv_rn(x[s][j][i], s_q));   // ties to even
          word |= static_cast<uint32_t>(min(127, max(-127, v)) & 0xff) << (8 * i);
        }
        a[s][2 * j + half] = word;
        sq = __dp4a(static_cast<int>(word), static_cast<int>(word), sq);
      }
    sq += __shfl_xor_sync(0xffffffffu, sq, 1);
    sq += __shfl_xor_sync(0xffffffffu, sq, 2);
    sc[half] = __fmul_rn(__fmul_rn(-2.f, s_q), s_k);
    qn[half] = __fmul_rn(static_cast<float>(sq), __fmul_rn(s_q, s_q));
  }
}

// The wgmma kernel's walk over its BN-key tiles: the live k-blocks of
// [kb, kb_end) in order, slack blocks skipped.
template <int BN>
struct TileWalk {
  const int* block_obj;
  int kb_end, block_k, num_obj;
  int kb, kt;

  __device__ void skip_slack() { kb = next_block(block_obj, kb, kb_end, num_obj); }
  __device__ bool done() const { return kb >= kb_end; }
  __device__ void next() {
    kt += BN;
    if (kt < block_k) return;
    kt = 0;
    ++kb;
    skip_slack();
  }
};

// Kernels 1 (bf16 min: ARGMIN false, INT8 false), 4 (bf16 argmin: ARGMIN)
// and 3 (int8 min: INT8). A block of two warpgroups owns 128 queries, held
// as wgmma A fragments in registers (each warp 16 rows x 128 channels),
// and walks its split's live k-blocks in BN-key tiles: cp.async streams
// each tile of keys (in the 128-byte swizzle that the B descriptor reads)
// and its |k|^2 through a ring of STAGES stages, which all warpgroups read,
// KSTEPS `wgmma.m64nBNk16` (bf16) or `wgmma.m64n128k32` (int8) per
// warpgroup form the tile's cross terms, and the epilogue folds the candidates into the running minimum of
// the object (with ARGMIN: in ascending row order, the running (min,
// row)), held in registers because an object's blocks are consecutive; at
// the object's last tile the quad reduces it and its lane 0 writes it.
// With `part_v` set, the block is split blockIdx.y of gridDim.y and writes
// its partial minimum (with ARGMIN, (min, row)) per (query, object) to
// part_v (/ part_i) (gridDim.y, nq, num_obj), 1e8 (and -1) for an object
// it does not touch, and split 0 writes |q|^2 to `part_qn` (nq,); without,
// it writes `out` (/ `idx`). Two blocks share an SM, so one block's
// epilogue overlaps the other's products; a key tile feeds 128 queries,
// which halves the keys' traffic from L2 against 64.
template <bool ARGMIN, bool INT8>
__global__ void __launch_bounds__(AW_THREADS, 2)
global_matching_wgmma(const AwArgs p) {
  static_assert(!(ARGMIN && INT8), "the int8 kernel has no argmin variant");
  using K = Aw<ARGMIN, INT8>;
  constexpr int BN = K::BN;
  using Walk = TileWalk<BN>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = static_cast<uint32_t>(__cvta_generic_to_shared(smem_raw));
  const uint32_t base = (raw + 1023u) & ~1023u;
  uint8_t* smem = smem_raw + (base - raw);

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;   // warp w: rows 16 w .. 16 w + 15
  const int g = lane >> 2, t = lane & 3;
  const int64_t q0 = static_cast<int64_t>(blockIdx.x) * AW_BM;
  const int64_t rows[2] = {q0 + warp * 16 + g, q0 + warp * 16 + g + 8};
  const int64_t nq = p.nq;
  const int num_obj = p.num_obj;

  // A fragments of this warp's 16 queries, their |q|^2 (int8: s_q^2
  // |q^|^2) and, for int8, their cross-term scales
  uint32_t a[K::KSTEPS][4];
  float qn[2], sc[2] = {0.f, 0.f};
  if constexpr (INT8)
    int8_fragments(p, rows, t, a, sc, qn);
  else
    bf16_fragments(p, rows, t, a, qn);

  // this block's k-blocks, and the empty-object answer (or partial)
  // prefilled by the quad's lane 0, which also writes the row's results
  // later (same thread, program order)
  int kb_lo = 0, kb_hi = p.nkb;
  float* part_v = p.part_v;
  int* part_i = p.part_i;
  if (part_v != nullptr) {
    split_range(p.block_obj, p.nkb, num_obj, blockIdx.y, gridDim.y, kb_lo, kb_hi);
    const int64_t off = static_cast<int64_t>(blockIdx.y) * nq * num_obj;
    part_v += off;
    if (ARGMIN) part_i += off;
  }
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int64_t row = rows[half];
    if (t != 0 || row >= nq) continue;
    if (part_v != nullptr) {
      if (blockIdx.y == 0) p.part_qn[row] = qn[half];
      for (int o = 0; o < num_obj; ++o) {
        part_v[row * num_obj + o] = manet::kBig;
        if (ARGMIN) part_i[row * num_obj + o] = -1;
      }
    } else {
      for (int o = 0; o < num_obj; ++o) {
        p.out[row * num_obj + o] = manet::finish_distance(manet::kBig, qn[half]);
        if (ARGMIN) p.idx[row * num_obj + o] = -1;
      }
    }
  }

  // stage tile `w` into `stage`: BN rows x ROW / 16 chunks of 16 bytes,
  // and its BN |k|^2
  auto load = [&](int stage, const Walk& w) {
    const int64_t k0 = static_cast<int64_t>(w.kb) * p.block_k + w.kt;
    const uint8_t* src = static_cast<const uint8_t*>(p.keys) + k0 * K::ROW;
    uint8_t* dst = smem + stage * K::STAGE;
#pragma unroll
    for (int i = 0; i < BN * (K::ROW / 16) / AW_THREADS; ++i) {
      const int c = tid + i * AW_THREADS, r = c / (K::ROW / 16), j = c % (K::ROW / 16);
      cp_async16(dst + (j >> 3) * K::ATOM + manet::swizzle128(r, j & 7),
                 src + r * K::ROW + j * 16);
    }
    if (tid < BN / 4)
      cp_async16(smem + K::OFF_SQ + (stage * BN + tid * 4) * 4, p.sqnorm + k0 + tid * 4);
  };

  Walk cur{p.block_obj, kb_hi, p.block_k, num_obj, kb_lo, 0};
  cur.skip_slack();
  Walk ahead = cur;
  for (int i = 0; i < K::STAGES - 1; ++i) {
    if (!ahead.done()) {
      load(i, ahead);
      ahead.next();
    }
    cp_async_commit();
  }
  typename K::Acc d[BN / 2] = {};
  float rmin[2] = {manet::kBig, manet::kBig};
  int rarg[2] = {-1, -1};
  for (int it = 0; !cur.done(); ++it) {
    const int stage = it % K::STAGES;
    asm volatile("cp.async.wait_group %0;\n" ::"n"(K::STAGES - 2));   // this tile landed
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();   // and every thread is done with the stage refilled here
    if (!ahead.done()) {
      load((it + K::STAGES - 1) % K::STAGES, ahead);
      ahead.next();
    }
    cp_async_commit();

    const uint32_t b = base + stage * K::STAGE;
    fence_acc(d);
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
    for (int s = 0; s < K::KSTEPS; ++s)   // 32 bytes a step
      tile_mma(d, a[s], manet::sw128_desc(b + (s >> 2) * K::ATOM + (s & 3) * 32), s > 0);
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
    asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
    fence_acc(d);

    // candidates of columns 8i + 2t, 8i + 2t + 1 (with ARGMIN in
    // ascending row order)
    const float* sq = reinterpret_cast<const float*>(smem + K::OFF_SQ) + stage * BN;
    const int col = cur.kb * p.block_k + cur.kt + 2 * t;
#pragma unroll
    for (int i = 0; i < BN / 8; ++i) {
      const float2 s2 = *reinterpret_cast<const float2*>(sq + i * 8 + 2 * t);
      const float e00 = candidate(d[4 * i], sc[0], s2.x);
      const float e01 = candidate(d[4 * i + 1], sc[0], s2.y);
      const float e10 = candidate(d[4 * i + 2], sc[1], s2.x);
      const float e11 = candidate(d[4 * i + 3], sc[1], s2.y);
      if constexpr (ARGMIN) {
        keep_min(rmin[0], rarg[0], e00, col + i * 8);
        keep_min(rmin[0], rarg[0], e01, col + i * 8 + 1);
        keep_min(rmin[1], rarg[1], e10, col + i * 8);
        keep_min(rmin[1], rarg[1], e11, col + i * 8 + 1);
      } else {
        rmin[0] = fminf(rmin[0], fminf(e00, e01));
        rmin[1] = fminf(rmin[1], fminf(e10, e11));
      }
    }

    const int obj = p.block_obj[cur.kb];
    cur.next();
    // the object's last tile (in this split): its blocks are consecutive
    if (!cur.done() && p.block_obj[cur.kb] == obj) continue;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      float v = rmin[half];
      int i = rarg[half];
      if constexpr (ARGMIN) {
        argmin_xor(v, i, 1);
        argmin_xor(v, i, 2);
      } else {
        v = fminf(v, __shfl_xor_sync(0xffffffffu, v, 1));
        v = fminf(v, __shfl_xor_sync(0xffffffffu, v, 2));
      }
      const int64_t row = rows[half];
      if (t == 0 && row < nq) {
        if (part_v != nullptr) {
          part_v[row * num_obj + obj] = v;
          if (ARGMIN) part_i[row * num_obj + obj] = i;
        } else {
          p.out[row * num_obj + obj] = manet::finish_distance(v, qn[half]);
          if (ARGMIN) p.idx[row * num_obj + obj] = i;
        }
      }
      rmin[half] = manet::kBig;
      rarg[half] = -1;
    }
  }
}

// Fold the S partials of each (query, object) of a split kernel in
// ascending split order (strict <: of equal minima the earlier split,
// whose rows are lower, keeps its row; without ARGMIN this is a plain
// min), then |q|^2, clamp and normalize.
template <bool ARGMIN>
__global__ void merge_splits(const float* __restrict__ part_v,
                             const int* __restrict__ part_i,
                             const float* __restrict__ part_qn,
                             float* __restrict__ out, int* __restrict__ idx,
                             int64_t n, int num_obj, int splits) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float v = part_v[i];
  int r = ARGMIN ? part_i[i] : -1;
  for (int s = 1; s < splits; ++s) {
    const float w = part_v[s * n + i];
    if (w < v) {
      v = w;
      if (ARGMIN) r = part_i[s * n + i];
    }
  }
  out[i] = manet::finish_distance(v, part_qn[i / num_obj]);
  if (ARGMIN) idx[i] = r;
}

// Launch one wgmma variant on a grid of query tiles x `splits`, then (S >
// 1) the merge of its partials from `scratch`: splits * nq * num_obj f32
// (and, with ARGMIN, as many int32) partials, then nq f32 |q|^2.
template <bool ARGMIN, bool INT8>
int launch_wgmma(AwArgs p, void* scratch, int splits, cudaStream_t s) {
  using K = Aw<ARGMIN, INT8>;
  const long long n = p.nq * p.num_obj;
  if (splits > 1) {
    p.part_v = static_cast<float*>(scratch);
    p.part_i = ARGMIN ? reinterpret_cast<int*>(p.part_v + splits * n) : nullptr;
    p.part_qn = p.part_v + (ARGMIN ? 2 : 1) * splits * n;
  }
  cudaError_t err = cudaFuncSetAttribute(global_matching_wgmma<ARGMIN, INT8>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, K::SMEM);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(static_cast<unsigned>((p.nq + AW_BM - 1) / AW_BM),
                  static_cast<unsigned>(splits));
  global_matching_wgmma<ARGMIN, INT8><<<grid, AW_THREADS, K::SMEM, s>>>(p);
  if (splits > 1) {
    const int threads = 256;
    merge_splits<ARGMIN><<<static_cast<unsigned>((n + threads - 1) / threads), threads, 0, s>>>(
        p.part_v, p.part_i, p.part_qn, p.out, p.idx, n, p.num_obj, splits);
  }
  return static_cast<int>(cudaGetLastError());
}

// ------------------------------------------- f32 argmin on the CUDA cores

constexpr int FMA_TQ = 64;       // queries per block
constexpr int FMA_TK = 64;       // keys per tile; divides block_k
constexpr int FMA_CK = 32;       // channels per staged key chunk
constexpr int FMA_C_MAX = 128;   // channels held for the query tile
constexpr int FMA_PAD = 4;       // keeps float4 rows aligned, spreads banks
constexpr int FMA_THREADS = 256; // 16 x 16 threads, 4 x 4 outputs each

// The f32 argmin kernel: 64 queries x 64 keys per tile, the key chunks
// staged through shared memory, the cross term one fmaf chain per pair.
__global__ void __launch_bounds__(FMA_THREADS)
global_matching_fma_argmin(const float* __restrict__ query,
                           const float* __restrict__ neg2,
                           const float* __restrict__ sqnorm,
                           const int* __restrict__ block_obj,
                           float* __restrict__ out, int* __restrict__ idx,
                           int64_t nq, int c, int nkb, int block_k, int num_obj) {
  __shared__ __align__(16) float qs[FMA_C_MAX][FMA_TQ + FMA_PAD];  // transposed
  __shared__ __align__(16) float kc[FMA_CK][FMA_TK + FMA_PAD];     // transposed
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

  // running minima and rows of this thread's queries, per object, whose
  // blocks are consecutive
  float bmin[4] = {manet::kBig, manet::kBig, manet::kBig, manet::kBig};
  int barg[4] = {-1, -1, -1, -1};
  for (int kb = 0; kb < nkb; ++kb) {
    const int obj = block_obj[kb];
    if (obj < 0 || obj >= num_obj) continue;  // slack block (uniform branch)
    for (int kt = 0; kt < block_k; kt += FMA_TK) {
      const int64_t k0 = static_cast<int64_t>(kb) * block_k + kt;
      float r[4][4] = {};
      for (int c0 = 0; c0 < c; c0 += FMA_CK) {
        __syncthreads();  // the previous chunk is consumed
        for (int i = tid; i < FMA_TK * FMA_CK; i += FMA_THREADS) {
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
        for (int jj = 0; jj < 4; ++jj)
          keep_min(bmin[i], barg[i], r[i][jj] + sq[jj],
                   static_cast<int>(k0) + tx * 4 + jj);
    }
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
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      bmin[i] = manet::kBig;
      barg[i] = -1;
    }
  }
}
// The launch's arguments are valid: f32 needs c a multiple of 32 up to 128
// (and, without argmin, block_k a multiple of 128), bf16 c = 128.
bool shape_ok(long long nq, int c, int nkb, int block_k, int num_obj,
              bool bf16, bool argmin) {
  if (nq <= 0 || nkb < 0 || num_obj <= 0 || num_obj > O_MAX || block_k <= 0 ||
      block_k % aw_bn(argmin) != 0)
    return false;
  if (argmin && static_cast<long long>(nkb) * block_k > 0x7fffffffLL) return false;
  if (bf16) return c == C_PAD;
  return argmin ? c > 0 && c <= FMA_C_MAX && c % FMA_CK == 0
                : manet::tf32_shape_ok(nq, c, nkb, block_k, num_obj);
}

}  // namespace

// query (nq, c) and neg2 (nkb * block_k, c) in f32 (is_bf16 = 0; c a
// multiple of 32 up to 128, block_k a multiple of 128) or in bf16 with
// c = 128 (is_bf16 = 1); sqnorm (nkb, block_k) f32; block_obj (nkb,) int32;
// out (nq, num_obj) f32. All contiguous on the current device, query and
// neg2 16-byte aligned.
extern "C" int manet_global_matching(const void* query, const void* neg2,
                                     const void* sqnorm, const void* block_obj,
                                     void* out, long long nq, int c, int nkb,
                                     int block_k, int num_obj, int is_bf16,
                                     void* stream) {
  if (!shape_ok(nq, c, nkb, block_k, num_obj, is_bf16, false))
    return static_cast<int>(cudaErrorInvalidValue);
  auto s = static_cast<cudaStream_t>(stream);
  if (!is_bf16)
    return manet::launch_tf32(
        static_cast<const float*>(query), static_cast<const float*>(neg2),
        static_cast<const float*>(sqnorm), static_cast<const int*>(block_obj),
        static_cast<float*>(out), nullptr, nullptr, nq, c, nkb, block_k,
        num_obj, s);
  AwArgs p{};
  p.query = query;
  p.keys = neg2;
  p.sqnorm = static_cast<const float*>(sqnorm);
  p.block_obj = static_cast<const int*>(block_obj);
  p.out = static_cast<float*>(out);
  p.nq = nq;
  p.nkb = nkb;
  p.block_k = block_k;
  p.num_obj = num_obj;
  return launch_wgmma<false, false>(p, nullptr, 1, s);
}

// As manet_global_matching, plus idx (nq, num_obj) int32: the bucketed
// row of each minimum, -1 for an object without rows. bf16 splits the
// key range `splits` ways (f32 takes 1); with splits > 1, `scratch` holds
// splits * nq * num_obj f32 and as many int32 partials, then nq f32.
extern "C" int manet_global_matching_argmin(
    const void* query, const void* neg2, const void* sqnorm,
    const void* block_obj, void* out, void* idx, void* scratch, long long nq,
    int c, int nkb, int block_k, int num_obj, int is_bf16, int splits,
    void* stream) {
  if (!shape_ok(nq, c, nkb, block_k, num_obj, is_bf16, true) ||
      idx == nullptr || splits < 1 || splits > 65535 ||
      (splits > 1 && (!is_bf16 || scratch == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  auto s = static_cast<cudaStream_t>(stream);
  if (!is_bf16) {
    const dim3 grid(static_cast<unsigned>((nq + FMA_TQ - 1) / FMA_TQ));
    global_matching_fma_argmin<<<grid, FMA_THREADS, 0, s>>>(
        static_cast<const float*>(query), static_cast<const float*>(neg2),
        static_cast<const float*>(sqnorm), static_cast<const int*>(block_obj),
        static_cast<float*>(out), static_cast<int*>(idx), nq, c, nkb, block_k,
        num_obj);
    return static_cast<int>(cudaGetLastError());
  }
  AwArgs p{};
  p.query = query;
  p.keys = neg2;
  p.sqnorm = static_cast<const float*>(sqnorm);
  p.block_obj = static_cast<const int*>(block_obj);
  p.out = static_cast<float*>(out);
  p.idx = static_cast<int*>(idx);
  p.nq = nq;
  p.nkb = nkb;
  p.block_k = block_k;
  p.num_obj = num_obj;
  return launch_wgmma<true, false>(p, scratch, splits, s);
}

// The int8 kernel: the float query (nq, c) (bf16 if q_bf16, else f32; c
// <= 128, quantized in the kernel; q_vec: c = 128 on a 16-byte aligned
// base), keys (nkb * block_k, 128) int8 (16-byte aligned), sqnorm (nkb,
// block_k) f32 = s_k^2 |k^|^2 (1e8 on padding rows), block_obj (nkb,)
// int32, key_scale () f32 = s_k; out (nq, num_obj) f32. The key range is
// split `splits` ways; with splits > 1, `scratch` holds splits * nq *
// num_obj f32 partials, then nq f32. All contiguous on the current device.
extern "C" int manet_global_matching_int8(
    const void* query, const void* keys, const void* sqnorm,
    const void* block_obj, const void* key_scale, void* out, void* scratch,
    long long nq, int c, int nkb, int block_k, int num_obj, int q_bf16,
    int q_vec, int splits, void* stream) {
  if (nq <= 0 || c <= 0 || c > C_PAD || (q_vec && c != C_PAD) || block_k <= 0 ||
      block_k % aw_bn(false) != 0 || num_obj <= 0 || num_obj > O_MAX || nkb < 0 ||
      splits < 1 || splits > 65535 || (splits > 1 && scratch == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  AwArgs p{};
  p.query = query;
  p.keys = keys;
  p.sqnorm = static_cast<const float*>(sqnorm);
  p.block_obj = static_cast<const int*>(block_obj);
  p.key_scale = static_cast<const float*>(key_scale);
  p.out = static_cast<float*>(out);
  p.nq = nq;
  p.nkb = nkb;
  p.block_k = block_k;
  p.num_obj = num_obj;
  p.c = c;
  p.q_bf16 = q_bf16;
  p.q_vec = q_vec;
  return launch_wgmma<false, true>(p, scratch, splits, static_cast<cudaStream_t>(stream));
}

// The dynamic shared memory of the f32 kernel (matching_tf32.cuh), in bytes.
extern "C" int manet_global_matching_tf32_smem() { return manet::TF_SMEM; }
