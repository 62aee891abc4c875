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
// (or, in the f32 and int8 kernels, of its k-block), into the query's
// result. The distance matrix never reaches device memory.
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
// The bf16 argmin kernel (kernel 4, training) splits the key range and
// runs on `wgmma`. At the training shape (Nq = Nk = 10,816) one block per
// query tile would leave most of the card idle and walk 24 live k-blocks
// one after another, so the wrapper launches a 2-D grid of query tiles x S
// splits (`splits`, chosen from the SM count), each split owning a
// contiguous run of the live k-blocks (live ordinals [s L / S, (s + 1) L /
// S), L counted on the device). A split writes one partial (min, row) per
// (query, object) into the scratch buffer, (1e8, -1) for an object it does
// not touch, and `argmin_merge` folds the S partials in ascending split
// order with a strict <, so that the lowest bucketed row wins ties across
// splits as within one (the TPU kernel's `dmin < acc` over its k-blocks),
// then adds |q|^2, clamps and normalizes. With S = 1 the kernel writes
// `out` / `idx` itself. Bound on an H100: the tensor cores' products (989
// TFLOP/s bf16), with the argmin epilogue (about 4-5 lane operations per
// candidate: add, compare, two selects) on the CUDA cores close behind;
// two resident blocks of two warpgroups per SM overlap one block's
// epilogue with the other's products.
//
// Four variants:
// - bf16 with C = 128 (the model's path, kernel 1): the kernel-4 mainloop
//   below with a min-only epilogue (`global_matching_wgmma<false>`) and
//   128-key tiles (`wgmma.m64n128k16`, a 3-stage ring), the queries' A
//   fragments in registers: the running minimum of the current object
//   stays in registers, one block per query tile, no key split (the
//   round's 388,800 queries give some 3,000 query tiles). Bound: the products (989 TFLOP/s bf16); the min epilogue (an
//   add and a min per pair on the CUDA cores) comes to about a quarter of
//   it. Its earlier route, `mma.sync.m16n8k16`, stays near 30% of the
//   bf16 peak however many warps an SM holds; this one reaches about half
//   of it at the round's shape, where the products, the key tiles' loads
//   through L2 (Nq / 128 passes over the keys, 20 GB) and the epilogue
//   each take a large share of the time and overlap only in part.
// - bf16 argmin (kernel 4): the same mainloop with the argmin epilogue
//   (`global_matching_wgmma<true>`), split key range, merge in key order
//   (above).
// - f32 (the f32 stream's memory, the tiny test config): 3xTF32 on the
//   tensor cores through `wgmma` (matching_tf32.cuh, shared with the ring
//   step of ring_matching.cu).
// - f32 argmin (f32 test configurations only): FMA on the CUDA cores, 64
//   queries x 64 keys per tile, 4 x 4 outputs per thread.
//
// The int8 kernel (entry `manet_global_matching_int8`) replaces the TPU
// kernel `_matching_kernel_int8` (called by `global_matching_prepared_int8`,
// the opt-in int8 serving mode). Query rows q^ and keys k^ are symmetric
// int8 (per-row query scales s_q, one key scale s_k); `sqnorm` holds
// s_k^2 |k^|^2 and `scales` per query row [-2 s_q s_k, s_q^2], so
//
//   e = float(q^.k^) * scales[0] + sqnorm,   d = min_k e + float(|q^|^2) * scales[1]
//
// is the exact f32 distance between the dequantized vectors. It runs on
// `mma.sync.m16n8k32` (int8 in, int32 accumulate): a block of 4 warps owns
// 128 queries, each warp the A fragments of 32 in registers, and 128-key
// tiles (an int8 row of 128 channels is 128 bytes) stream through shared
// memory with cp.async, double-buffered. The cross term is
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
#include "matching_tf32.cuh"

namespace {

using manet::argmin_xor;
using manet::keep_min;
using manet::O_MAX;

// ------------------------------------------------------------ tensor cores

constexpr int MMA_C = 128;                 // channels (the padded embedding)
constexpr int MMA_WARPS = 4;
constexpr int MMA_ROWS = 32;               // queries per warp (2 m16 tiles)
constexpr int MMA_TQ = MMA_WARPS * MMA_ROWS;
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

// ------------------- bf16 on wgmma: kernel 1 (min) and kernel 4 (argmin)

// Warpgroups per block, m64 each: 2, two blocks an SM. (A block of 4
// warpgroups, one an SM, halves the keys' L2 traffic but timed no faster
// for kernel 1 at the round's shape.)
constexpr int AW_WG = 2;
constexpr int AW_BM = 64 * AW_WG;          // queries per block
constexpr int AW_THREADS = 128 * AW_WG;
// Keys per tile (divides block_k): kernel 4 64, kernel 1 128, which halves
// the tile's fixed costs (barrier, walk, waits) per key.
__host__ __device__ constexpr int aw_bn(bool argmin) { return argmin ? 64 : 128; }

// The ring of a BN-key tile width, in shared memory from a 1024-byte
// aligned base: each stage's two swizzle atoms (128 channels), then each
// stage's |k|^2.
template <int BN>
struct AwRing {
  static constexpr int STAGES = BN == 64 ? 4 : 3;   // key tiles in flight
  static constexpr int ATOM = BN * 128;             // BN keys x 64 channels (128 B rows)
  static constexpr int OFF_SQ = STAGES * 2 * ATOM;
  static constexpr int SMEM = OFF_SQ + STAGES * BN * 4 + 1024;   // + alignment
};

// d = A (64 x 16, registers) * B (64 x 16)^T (+ d if `accumulate`), bf16
// in, f32 sums; B K-major in the 128-byte swizzle
__device__ __forceinline__ void wgmma_bf16_rs(float (&d)[32], const uint32_t (&a)[4],
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

// As wgmma_bf16_rs with B 128 keys wide (m64n128k16)
__device__ __forceinline__ void wgmma_bf16_rs_n128(float (&d)[64], const uint32_t (&a)[4],
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

// The tile's product for one k16 step, B BN keys wide
__device__ __forceinline__ void tile_mma(float (&d)[32], const uint32_t (&a)[4],
                                         uint64_t b, int accumulate) {
  wgmma_bf16_rs(d, a, b, accumulate);
}
__device__ __forceinline__ void tile_mma(float (&d)[64], const uint32_t (&a)[4],
                                         uint64_t b, int accumulate) {
  wgmma_bf16_rs_n128(d, a, b, accumulate);
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

// Kernels 1 (bf16, ARGMIN false) and 4 (ARGMIN true). A block of
// two warpgroups owns 128 queries, held as wgmma A fragments
// in registers (each warp 16 rows x 128 channels, the mma.m16n8k16
// layout), and walks its split's live k-blocks in BN-key tiles (64 for
// kernel 4, 128 for kernel 1): cp.async streams each tile of -2k (in the
// 128-byte swizzle that the B descriptor reads) and its |k|^2 through a
// ring of 4 (3) stages, which all warpgroups read, 8 `wgmma.m64nBNk16`
// per warpgroup form the tile's cross terms,
// and the epilogue folds the candidates into the running minimum of the
// object (with ARGMIN: in ascending row order, the running (min, row)),
// held in registers because an object's blocks are consecutive; at the
// object's last tile the quad reduces it and its lane 0 writes it. With
// `part_v` set (ARGMIN only), the block is split blockIdx.y of gridDim.y
// and writes its partial (min, row) per (query, object) to part_v /
// part_i (gridDim.y, nq, num_obj), (1e8, -1) for an object it does not
// touch, and split 0 writes |q|^2 to `part_qn` (nq,); without, it writes
// `out` (/ `idx`). Two blocks share an SM, so one block's epilogue
// overlaps the other's products; a key tile feeds 128 queries, which
// halves the keys' traffic from L2 against 64.
template <bool ARGMIN>
__global__ void __launch_bounds__(AW_THREADS, 2)
global_matching_wgmma(const __nv_bfloat16* __restrict__ query,
                             const __nv_bfloat16* __restrict__ neg2,
                             const float* __restrict__ sqnorm,
                             const int* __restrict__ block_obj,
                             float* __restrict__ out, int* __restrict__ idx,
                             float* __restrict__ part_v, int* __restrict__ part_i,
                             float* __restrict__ part_qn, int64_t nq, int nkb,
                             int block_k, int num_obj) {
  constexpr int BN = aw_bn(ARGMIN);
  using Ring = AwRing<BN>;
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

  // A fragments of this warp's 16 queries, and their |q|^2
  uint32_t a[MMA_KSTEPS][4];
  float qsq[2] = {0.f, 0.f};
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const uint32_t* src = reinterpret_cast<const uint32_t*>(query + rows[half] * MMA_C);
#pragma unroll
    for (int s = 0; s < MMA_KSTEPS; ++s) {
      const uint32_t lo = rows[half] < nq ? src[s * 8 + t] : 0u;       // cols 2t, 2t+1
      const uint32_t hi = rows[half] < nq ? src[s * 8 + 4 + t] : 0u;   // cols 2t+8, 2t+9
      a[s][half] = lo;
      a[s][2 + half] = hi;
      const float2 lf = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&lo));
      const float2 hf = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&hi));
      qsq[half] += lf.x * lf.x + lf.y * lf.y + hf.x * hf.x + hf.y * hf.y;
    }
    qsq[half] += __shfl_xor_sync(0xffffffffu, qsq[half], 1);
    qsq[half] += __shfl_xor_sync(0xffffffffu, qsq[half], 2);
  }

  // this block's k-blocks, and the empty-object answer (or partial)
  // prefilled by the quad's lane 0, which also writes the row's results
  // later (same thread, program order)
  int kb_lo = 0, kb_hi = nkb;
  if (ARGMIN && part_v != nullptr) {
    split_range(block_obj, nkb, num_obj, blockIdx.y, gridDim.y, kb_lo, kb_hi);
    const int64_t off = static_cast<int64_t>(blockIdx.y) * nq * num_obj;
    part_v += off;
    part_i += off;
  }
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int64_t row = rows[half];
    if (t != 0 || row >= nq) continue;
    if (ARGMIN && part_v != nullptr) {
      if (blockIdx.y == 0) part_qn[row] = qsq[half];
      for (int o = 0; o < num_obj; ++o) {
        part_v[row * num_obj + o] = manet::kBig;
        part_i[row * num_obj + o] = -1;
      }
    } else {
      for (int o = 0; o < num_obj; ++o) {
        out[row * num_obj + o] = manet::finish_distance(manet::kBig, qsq[half]);
        if (ARGMIN) idx[row * num_obj + o] = -1;
      }
    }
  }

  // stage tile `w` into `stage`: BN rows x 16 chunks of 16 bytes, and its
  // BN |k|^2
  auto load = [&](int stage, const Walk& w) {
    const int64_t k0 = static_cast<int64_t>(w.kb) * block_k + w.kt;
    uint8_t* dst = smem + stage * 2 * Ring::ATOM;
#pragma unroll
    for (int i = 0; i < BN * 16 / AW_THREADS; ++i) {
      const int p = tid + i * AW_THREADS, r = p >> 4, j = p & 15;
      cp_async16(dst + (j >> 3) * Ring::ATOM + manet::swizzle128(r, j & 7),
                 neg2 + (k0 + r) * MMA_C + j * 8);
    }
    if (tid < BN / 4)
      cp_async16(smem + Ring::OFF_SQ + (stage * BN + tid * 4) * 4, sqnorm + k0 + tid * 4);
  };

  Walk cur{block_obj, kb_hi, block_k, num_obj, kb_lo, 0};
  cur.skip_slack();
  Walk ahead = cur;
  for (int i = 0; i < Ring::STAGES - 1; ++i) {
    if (!ahead.done()) {
      load(i, ahead);
      ahead.next();
    }
    cp_async_commit();
  }
  float d[BN / 2] = {};
  float rmin[2] = {manet::kBig, manet::kBig};
  int rarg[2] = {-1, -1};
  for (int it = 0; !cur.done(); ++it) {
    const int stage = it % Ring::STAGES;
    asm volatile("cp.async.wait_group %0;\n" ::"n"(Ring::STAGES - 2));   // this tile landed
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();   // and every thread is done with the stage refilled here
    if (!ahead.done()) {
      load((it + Ring::STAGES - 1) % Ring::STAGES, ahead);
      ahead.next();
    }
    cp_async_commit();

    const uint32_t b = base + stage * 2 * Ring::ATOM;
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) asm volatile("" : "+f"(d[i])::"memory");
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
    for (int s = 0; s < MMA_KSTEPS; ++s)   // 16 channels = 32 bytes a step
      tile_mma(d, a[s], manet::sw128_desc(b + (s >> 2) * Ring::ATOM + (s & 3) * 32), s > 0);
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
    asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) asm volatile("" : "+f"(d[i])::"memory");

    // candidates cross + |k|^2 of columns 8i + 2t, 8i + 2t + 1 (with
    // ARGMIN in ascending row order)
    const float* sq = reinterpret_cast<const float*>(smem + Ring::OFF_SQ) + stage * BN;
    const int col = cur.kb * block_k + cur.kt + 2 * t;
#pragma unroll
    for (int i = 0; i < BN / 8; ++i) {
      const float2 s2 = *reinterpret_cast<const float2*>(sq + i * 8 + 2 * t);
      if constexpr (ARGMIN) {
        keep_min(rmin[0], rarg[0], d[4 * i] + s2.x, col + i * 8);
        keep_min(rmin[0], rarg[0], d[4 * i + 1] + s2.y, col + i * 8 + 1);
        keep_min(rmin[1], rarg[1], d[4 * i + 2] + s2.x, col + i * 8);
        keep_min(rmin[1], rarg[1], d[4 * i + 3] + s2.y, col + i * 8 + 1);
      } else {
        rmin[0] = fminf(rmin[0], fminf(d[4 * i] + s2.x, d[4 * i + 1] + s2.y));
        rmin[1] = fminf(rmin[1], fminf(d[4 * i + 2] + s2.x, d[4 * i + 3] + s2.y));
      }
    }

    const int obj = block_obj[cur.kb];
    cur.next();
    // the object's last tile (in this split): its blocks are consecutive
    if (!cur.done() && block_obj[cur.kb] == obj) continue;
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
        if (!ARGMIN) {
          out[row * num_obj + obj] = manet::finish_distance(v, qsq[half]);
        } else if (part_v != nullptr) {
          part_v[row * num_obj + obj] = v;
          part_i[row * num_obj + obj] = i;
        } else {
          out[row * num_obj + obj] = manet::finish_distance(v, qsq[half]);
          idx[row * num_obj + obj] = i;
        }
      }
      rmin[half] = manet::kBig;
      rarg[half] = -1;
    }
  }
}

// Fold the S partials of each (query, object) of the split argmin kernel in
// ascending split order (strict <: of equal minima the earlier split, whose
// rows are lower, keeps its row), then |q|^2, clamp and normalize.
__global__ void argmin_merge(const float* __restrict__ part_v,
                             const int* __restrict__ part_i,
                             const float* __restrict__ part_qn,
                             float* __restrict__ out, int* __restrict__ idx,
                             int64_t n, int num_obj, int splits) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float v = part_v[i];
  int r = part_i[i];
  for (int s = 1; s < splits; ++s) {
    const float w = part_v[s * n + i];
    if (w < v) {
      v = w;
      r = part_i[s * n + i];
    }
  }
  out[i] = manet::finish_distance(v, part_qn[i / num_obj]);
  idx[i] = r;
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

// The launch's arguments are valid: f32 needs c a multiple of 32 up to 128
// (and, without argmin, block_k a multiple of 128), bf16 c = 128.
bool shape_ok(long long nq, int c, int nkb, int block_k, int num_obj,
              bool bf16, bool argmin) {
  if (nq <= 0 || nkb < 0 || num_obj <= 0 || num_obj > O_MAX || block_k <= 0 ||
      block_k % aw_bn(argmin) != 0)
    return false;
  if (argmin && static_cast<long long>(nkb) * block_k > 0x7fffffffLL) return false;
  if (bf16) return c == MMA_C;
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
  cudaError_t err = cudaFuncSetAttribute(
      global_matching_wgmma<false>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      AwRing<aw_bn(false)>::SMEM);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(static_cast<unsigned>((nq + AW_BM - 1) / AW_BM));
  global_matching_wgmma<false><<<grid, AW_THREADS, AwRing<aw_bn(false)>::SMEM, s>>>(
      static_cast<const __nv_bfloat16*>(query),
      static_cast<const __nv_bfloat16*>(neg2),
      static_cast<const float*>(sqnorm), static_cast<const int*>(block_obj),
      static_cast<float*>(out), nullptr, nullptr, nullptr, nullptr, nq, nkb,
      block_k, num_obj);
  return static_cast<int>(cudaGetLastError());
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
  const auto* bo = static_cast<const int*>(block_obj);
  const auto* sq = static_cast<const float*>(sqnorm);
  auto* o = static_cast<float*>(out);
  auto* ix = static_cast<int*>(idx);
  if (!is_bf16) {
    const dim3 grid(static_cast<unsigned>((nq + FMA_TQ - 1) / FMA_TQ));
    global_matching_fma_argmin<<<grid, FMA_THREADS, 0, s>>>(
        static_cast<const float*>(query), static_cast<const float*>(neg2), sq,
        bo, o, ix, nq, c, nkb, block_k, num_obj);
    return static_cast<int>(cudaGetLastError());
  }
  const long long n = nq * num_obj;
  float* part_v = splits > 1 ? static_cast<float*>(scratch) : nullptr;
  int* part_i = splits > 1 ? reinterpret_cast<int*>(part_v + splits * n) : nullptr;
  float* part_qn = splits > 1 ? reinterpret_cast<float*>(part_i + splits * n) : nullptr;
  cudaError_t err = cudaFuncSetAttribute(
      global_matching_wgmma<true>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      AwRing<aw_bn(true)>::SMEM);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(static_cast<unsigned>((nq + AW_BM - 1) / AW_BM),
                  static_cast<unsigned>(splits));
  global_matching_wgmma<true><<<grid, AW_THREADS, AwRing<aw_bn(true)>::SMEM, s>>>(
      static_cast<const __nv_bfloat16*>(query),
      static_cast<const __nv_bfloat16*>(neg2), sq, bo, o, ix, part_v, part_i,
      part_qn, nq, nkb, block_k, num_obj);
  if (splits > 1) {
    const int threads = 256;
    argmin_merge<<<static_cast<unsigned>((n + threads - 1) / threads), threads, 0, s>>>(
        part_v, part_i, part_qn, o, ix, n, num_obj, splits);
  }
  return static_cast<int>(cudaGetLastError());
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

// The dynamic shared memory of the f32 kernel (matching_tf32.cuh), in bytes.
extern "C" int manet_global_matching_tf32_smem() { return manet::TF_SMEM; }
