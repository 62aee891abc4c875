// Global matching of f32 queries and keys on the TF32 tensor cores with
// f32 accuracy (3xTF32), shared by kernel 1's f32 variant
// (global_matching.cu) and the ring step (ring_matching.cu, kernel 6).
//
// Replaces, for f32 inputs, the TPU kernels
// cvpr2020_manet_tpu/ops/matching_pallas.py:274 `_matching_kernel` and
// cvpr2020_manet_tpu/ops/ring_matching_pallas.py:55 `_ring_kernel`.
//
// Arithmetic. Every operand is split as x = hi + lo with
// hi = cvt.rna.tf32(x) and lo = cvt.rna.tf32(x - hi) (x - hi is exact).
// The cross term of a (query, key) pair is
//
//   cross = sum_chunks (sum_k hi_q hi_k)  +  sum_k (lo_q hi_k + hi_q lo_k)
//
// with the small products accumulated apart from the large ones, so that
// the tensor cores' f32 accumulation of the small terms runs at their own
// magnitude (CUTLASS's 3xTF32 keeps them first for the same reason). The
// tensor cores do not round their f32 sums to nearest: with every product
// of a near pair of one sign, a sum carried over all 128 channels drifted
// by ~16 ulps (1.5e-5 in a normalized distance), so the large products are
// summed per 32-channel chunk and the chunks added in f32 on the CUDA
// cores; the two sums meet once at the end. The candidate is cross + |k|^2,
// every fold is an exact min, and |q|^2 is one fmaf chain over the
// channels in order. A pair's candidate therefore depends only on its
// query and key rows, not on the tile, block, shard or ring step that
// holds the key, so the ring is bit-identical to kernel 1's f32 variant
// over all rows.
//
// Design. A block of 256 threads owns 64 queries and walks every live
// k-block in 128-key tiles. Warpgroup 0 consumes: `wgmma.mma_async
// .m64n128k8.f32.tf32.tf32`, both operands K-major in shared memory in the
// 128-byte-swizzled layout that its descriptors read (a 128-byte row holds
// 32 channels; 16-byte chunk j of row r sits at chunk j ^ (r % 8)), into
// two register accumulators (large and small products) of 64 floats each;
// after the last chunk of a tile it folds the 64 x 128 candidates into a
// running row-min, and at the end of a k-block into the block's
// (queries, O) minima in shared memory. Warpgroup 1 produces: it loads
// each 128-key x 32-channel chunk of -2k with 16-byte loads (the next
// chunk's loads are in flight while it waits for a free stage), splits it
// into hi / lo once, and stores both into a ring of 4 stages, with one
// full and one empty `mbarrier` per stage; a tile's last chunk carries the
// tile's |k|^2, which the consumer reads before it frees the stage. The query tile is split into
// hi / lo once, at the start, and stays resident (64 KB). 199 KB of
// dynamic shared memory: one block per SM.
//
// Bound on an H100: 3 TF32 products per pair, 3 x 2 Nq Nk C operations at
// 495 TFLOP/s (dense TF32), against Nq C + Nk C f32 inputs: bound by
// operations, 7.4x less time than the same pairs in f32 FMA (67 TFLOP/s).
//
// The ring step carries the block's minima between launches: `acc_in`
// (nullptr: start at kBig) seeds them with the running minima of the
// shards folded so far, and `acc_out` (nullptr: finalize into `out`) takes
// them back un-normalized instead of the finish. Kernel 1 passes nullptr
// for both.
#pragma once

#include <stdint.h>

#include "common.cuh"

namespace manet {

constexpr int TF_BM = 64;            // queries per block (one m64 warpgroup)
constexpr int TF_BN = 128;           // keys per tile; divides block_k
constexpr int TF_CK = 32;            // channels per chunk: one 128-byte row
constexpr int TF_C_MAX = 128;        // channels held for the query tile
constexpr int TF_STAGES = 4;         // key chunks in flight
constexpr int TF_THREADS = 256;      // warpgroup 0 consumes, 1 produces
constexpr int TF_A_BYTES = TF_BM * TF_CK * 4;   // a query chunk, hi or lo
constexpr int TF_B_BYTES = TF_BN * TF_CK * 4;   // a key chunk, hi or lo
// dynamic shared memory, from a 1024-byte aligned base
constexpr int TF_OFF_B = (TF_C_MAX / TF_CK) * 2 * TF_A_BYTES;
constexpr int TF_OFF_ACC = TF_OFF_B + TF_STAGES * 2 * TF_B_BYTES;
constexpr int TF_OFF_QN = TF_OFF_ACC + TF_BM * O_MAX * 4;
constexpr int TF_OFF_SQ = TF_OFF_QN + TF_BM * 4;                  // per stage
constexpr int TF_OFF_BAR = TF_OFF_SQ + TF_STAGES * TF_BN * 4;
constexpr int TF_SMEM = TF_OFF_BAR + 2 * TF_STAGES * 8 + 1024;  // + alignment

// The launch's arguments are valid for global_matching_tf32.
inline bool tf32_shape_ok(long long nq, int c, int nkb, int block_k,
                          int num_obj) {
  return nq > 0 && c > 0 && c <= TF_C_MAX && c % TF_CK == 0 &&
         block_k > 0 && block_k % TF_BN == 0 && num_obj > 0 &&
         num_obj <= O_MAX && nkb >= 0;
}

// byte offset of 16-byte chunk `j` of row `r` in a 128-byte-swizzled tile
__device__ __forceinline__ uint32_t swizzle128(int r, int j) {
  return static_cast<uint32_t>(r * 128 + ((j ^ (r & 7)) << 4));
}

// x = hi + lo, both TF32 (f32 bit patterns with the low 13 bits zero)
__device__ __forceinline__ void split_tf32(const float4& x, uint4& hi, uint4& lo) {
  hi = make_uint4(tf32_rna(x.x), tf32_rna(x.y), tf32_rna(x.z), tf32_rna(x.w));
  lo = make_uint4(tf32_rna(__fsub_rn(x.x, __uint_as_float(hi.x))),
                  tf32_rna(__fsub_rn(x.y, __uint_as_float(hi.y))),
                  tf32_rna(__fsub_rn(x.z, __uint_as_float(hi.z))),
                  tf32_rna(__fsub_rn(x.w, __uint_as_float(hi.w))));
}

__device__ __forceinline__ void st_shared(uint32_t addr, const uint4& v) {
  asm volatile("st.shared.v4.u32 [%0], {%1, %2, %3, %4};\n"
               ::"r"(addr), "r"(v.x), "r"(v.y), "r"(v.z), "r"(v.w) : "memory");
}

// wgmma descriptor of a K-major operand in the 128-byte swizzle: rows of
// 128 bytes, 8-row groups 1024 bytes apart (the leading offset is unused)
__device__ __forceinline__ uint64_t sw128_desc(uint32_t saddr) {
  return static_cast<uint64_t>((saddr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(1) << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) |
         (static_cast<uint64_t>(1) << 62);
}

// d = A (64 x 8) * B (128 x 8)^T (+ d if `accumulate`), TF32 in, f32 sums
__device__ __forceinline__ void wgmma_tf32(float (&d)[64], uint64_t a, uint64_t b,
                                           int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, "
      "%29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, "
      "%43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, "
      "%57, %58, %59, %60, %61, %62, %63}, %64, %65, p, 1, 1;\n"
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
      : "l"(a), "l"(b), "r"(accumulate));
}

// keep the accumulators in place across the asynchronous wgmma
__device__ __forceinline__ void fence_operands(float (&d)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

// wait until the phase of parity `parity` of the barrier has completed
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
  } while (!done);
}

// The walk over the key chunks, in the same order for both warpgroups:
// live k-blocks (slack blocks skipped), 128-key tiles, 32-channel chunks.
struct ChunkWalk {
  const int* block_obj;
  int nkb, block_k, num_obj, nch;
  int kb, kt, cc;

  __device__ void skip_slack() {
    while (kb < nkb && static_cast<unsigned>(block_obj[kb]) >= static_cast<unsigned>(num_obj)) ++kb;
  }
  __device__ bool done() const { return kb >= nkb; }
  __device__ void next() {
    if (++cc < nch) return;
    cc = 0;
    kt += TF_BN;
    if (kt < block_k) return;
    kt = 0;
    ++kb;
    skip_slack();
  }
};

__global__ void __launch_bounds__(TF_THREADS, 1)
global_matching_tf32(const float* __restrict__ query,
                     const float* __restrict__ neg2,
                     const float* __restrict__ sqnorm,
                     const int* __restrict__ block_obj,
                     float* __restrict__ out, const float* acc_in,
                     float* acc_out, int64_t nq, int c, int nkb, int block_k,
                     int num_obj) {
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = static_cast<uint32_t>(__cvta_generic_to_shared(smem_raw));
  const uint32_t base = (raw + 1023u) & ~1023u;
  uint8_t* smem = smem_raw + (base - raw);
  float (*acc)[O_MAX] = reinterpret_cast<float (*)[O_MAX]>(smem + TF_OFF_ACC);
  float* qn = reinterpret_cast<float*>(smem + TF_OFF_QN);
  const uint32_t sa = base, sb = base + TF_OFF_B;
  const uint32_t full = base + TF_OFF_BAR, empty = full + TF_STAGES * 8;

  const int tid = threadIdx.x;
  const int nch = c / TF_CK;
  const int64_t q0 = static_cast<int64_t>(blockIdx.x) * TF_BM;

  if (tid == 0) {
    for (int s = 0; s < TF_STAGES; ++s) {
      mbar_init(full + s * 8, 128);
      mbar_init(empty + s * 8, 128);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  // the query tile, split into hi / lo once: [chunk][hi, lo][64 rows]
  for (int f = tid; f < TF_BM * nch * 8; f += TF_THREADS) {
    const int row = f / (nch * 8), rest = f - row * nch * 8;
    const int cc = rest >> 3, j = rest & 7;
    const int64_t gq = q0 + row;
    const float4 x = gq < nq
        ? *reinterpret_cast<const float4*>(query + gq * c + cc * TF_CK + j * 4)
        : make_float4(0.f, 0.f, 0.f, 0.f);
    uint4 hi, lo;
    split_tf32(x, hi, lo);
    const uint32_t at = sa + cc * 2 * TF_A_BYTES + swizzle128(row, j);
    st_shared(at, hi);
    st_shared(at + TF_A_BYTES, lo);
  }
  // the running minima of the shards folded before (ring step) or none
  for (int i = tid; i < TF_BM * O_MAX; i += TF_THREADS) {
    const int row = i / O_MAX, o = i - row * O_MAX;
    const int64_t gq = q0 + row;
    (&acc[0][0])[i] = (acc_in == nullptr || o >= num_obj || gq >= nq)
                          ? kBig : acc_in[gq * num_obj + o];
  }
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  __syncthreads();

  ChunkWalk walk{block_obj, nkb, block_k, num_obj, nch, 0, 0, 0};
  walk.skip_slack();

  if (tid >= 128) {
    // ---- producer: key chunks -> hi / lo stages
    const int ptid = tid - 128;
    float4 x[8], xs;                        // a chunk, and its tile's |k|^2
    auto load = [&](const ChunkWalk& w) {
      const int64_t k0 = static_cast<int64_t>(w.kb) * block_k + w.kt;
      const float* src = neg2 + k0 * c + w.cc * TF_CK;
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int f = ptid + i * 128, row = f >> 3, j = f & 7;
        x[i] = __ldg(reinterpret_cast<const float4*>(src + static_cast<int64_t>(row) * c + j * 4));
      }
      if (w.cc == nch - 1 && ptid < TF_BN / 4)
        xs = __ldg(reinterpret_cast<const float4*>(sqnorm + k0) + ptid);
    };
    if (!walk.done()) load(walk);
    for (uint32_t it = 0; !walk.done(); ++it) {
      const uint32_t slot = it % TF_STAGES, parity = (it / TF_STAGES) & 1;
      mbar_wait(empty + slot * 8, parity ^ 1);
      const uint32_t hi_at = sb + slot * 2 * TF_B_BYTES;
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int f = ptid + i * 128, row = f >> 3, j = f & 7;
        uint4 hi, lo;
        split_tf32(x[i], hi, lo);
        st_shared(hi_at + swizzle128(row, j), hi);
        st_shared(hi_at + TF_B_BYTES + swizzle128(row, j), lo);
      }
      // the tile's |k|^2 rides with its last chunk
      if (walk.cc == nch - 1 && ptid < TF_BN / 4)
        st_shared(base + TF_OFF_SQ + (slot * TF_BN + ptid * 4) * 4,
                  make_uint4(__float_as_uint(xs.x), __float_as_uint(xs.y),
                             __float_as_uint(xs.z), __float_as_uint(xs.w)));
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      mbar_arrive(full + slot * 8);
      walk.next();
      if (!walk.done()) load(walk);
    }
    return;
  }

  // ---- consumer: wgmma over the stages, candidates folded per tile
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int r0 = warp * 16 + g;            // rows r0 and r0 + 8 of the block
  float big[64], small[64], cross[64];   // a chunk's large products, a
#pragma unroll                           // tile's small ones, its large sum
  for (int i = 0; i < 64; ++i) big[i] = small[i] = cross[i] = 0.f;
  float rmin0 = kBig, rmin1 = kBig;
  for (uint32_t it = 0; !walk.done(); ++it) {
    const uint32_t slot = it % TF_STAGES, parity = (it / TF_STAGES) & 1;
    mbar_wait(full + slot * 8, parity);
    __syncwarp();                          // the wgmma calls below are .aligned
    const int cc = walk.cc;
    const uint32_t a_hi = sa + cc * 2 * TF_A_BYTES, a_lo = a_hi + TF_A_BYTES;
    const uint32_t b_hi = sb + slot * 2 * TF_B_BYTES, b_lo = b_hi + TF_B_BYTES;
    fence_operands(big);
    fence_operands(small);
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
    for (int ks = 0; ks < TF_CK / 8; ++ks) {     // 8 channels = 32 bytes
      const uint32_t off = ks * 32;
      // the small sum starts with the tile, the large one with the chunk
      wgmma_tf32(small, sw128_desc(a_lo + off), sw128_desc(b_hi + off), cc > 0 || ks > 0);
      wgmma_tf32(small, sw128_desc(a_hi + off), sw128_desc(b_lo + off), 1);
      wgmma_tf32(big, sw128_desc(a_hi + off), sw128_desc(b_hi + off), ks > 0);
    }
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
    asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
    fence_operands(big);
    fence_operands(small);
    // the chunk's large products join the tile's sum in f32 (round to
    // nearest): the tensor cores' accumulation then spans 32 channels
#pragma unroll
    for (int i = 0; i < 64; ++i) cross[i] = cc == 0 ? big[i] : __fadd_rn(cross[i], big[i]);

    const int kb = walk.kb;
    walk.next();
    if (walk.cc != 0) {                             // the tile goes on
      mbar_arrive(empty + slot * 8);
      continue;
    }

    // the tile's candidates, cross + |k|^2, into the running row-minima
    const float* sq = reinterpret_cast<const float*>(smem + TF_OFF_SQ) + slot * TF_BN;
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      const float2 s2 = *reinterpret_cast<const float2*>(sq + i * 8 + 2 * t);
      const float e0 = __fadd_rn(__fadd_rn(cross[4 * i], small[4 * i]), s2.x);
      const float e1 = __fadd_rn(__fadd_rn(cross[4 * i + 1], small[4 * i + 1]), s2.y);
      const float e2 = __fadd_rn(__fadd_rn(cross[4 * i + 2], small[4 * i + 2]), s2.x);
      const float e3 = __fadd_rn(__fadd_rn(cross[4 * i + 3], small[4 * i + 3]), s2.y);
      rmin0 = fminf(rmin0, fminf(e0, e1));
      rmin1 = fminf(rmin1, fminf(e2, e3));
    }
    mbar_arrive(empty + slot * 8);
    if (walk.kb == kb && !walk.done()) continue;   // the k-block goes on
    // the k-block ends: fold its minima into its object
    rmin0 = fminf(rmin0, __shfl_xor_sync(0xffffffffu, rmin0, 1));
    rmin0 = fminf(rmin0, __shfl_xor_sync(0xffffffffu, rmin0, 2));
    rmin1 = fminf(rmin1, __shfl_xor_sync(0xffffffffu, rmin1, 1));
    rmin1 = fminf(rmin1, __shfl_xor_sync(0xffffffffu, rmin1, 2));
    if (t == 0) {
      const int obj = block_obj[kb];
      acc[r0][obj] = fminf(acc[r0][obj], rmin0);
      acc[r0 + 8][obj] = fminf(acc[r0 + 8][obj], rmin1);
    }
    rmin0 = rmin1 = kBig;
  }

  asm volatile("bar.sync 1, 128;\n" ::: "memory");   // the consumer warpgroup
  if (acc_out != nullptr) {  // hand the minima to the next ring step
    for (int i = tid; i < TF_BM * num_obj; i += 128) {
      const int row = i / num_obj, o = i - row * num_obj;
      const int64_t gq = q0 + row;
      if (gq < nq) acc_out[gq * num_obj + o] = acc[row][o];
    }
    return;
  }
  if (tid < TF_BM) {
    const int64_t gq = q0 + tid;
    float s = 0.f;
    if (gq < nq)
      for (int col = 0; col < c; ++col) s = fmaf(query[gq * c + col], query[gq * c + col], s);
    qn[tid] = s;
  }
  asm volatile("bar.sync 1, 128;\n" ::: "memory");
  for (int i = tid; i < TF_BM * num_obj; i += 128) {
    const int row = i / num_obj, o = i - row * num_obj;
    const int64_t gq = q0 + row;
    if (gq < nq) out[gq * num_obj + o] = finish_distance(acc[row][o], qn[row]);
  }
}

// Launch global_matching_tf32 on `stream`; returns the cudaError_t.
inline int launch_tf32(const float* query, const float* neg2,
                       const float* sqnorm, const int* block_obj, float* out,
                       const float* acc_in, float* acc_out, long long nq,
                       int c, int nkb, int block_k, int num_obj,
                       cudaStream_t stream) {
  if (!tf32_shape_ok(nq, c, nkb, block_k, num_obj))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(
      global_matching_tf32, cudaFuncAttributeMaxDynamicSharedMemorySize, TF_SMEM);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(static_cast<unsigned>((nq + TF_BM - 1) / TF_BM));
  global_matching_tf32<<<grid, TF_THREADS, TF_SMEM, stream>>>(
      query, neg2, sqnorm, block_obj, out, acc_in, acc_out, nq, c, nkb,
      block_k, num_obj);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace manet
