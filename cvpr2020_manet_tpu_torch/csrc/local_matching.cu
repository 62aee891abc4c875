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
// Design (`local_matching_tf32`). The TPU kernel multiplies a strip of
// rows and masks the band; here a block owns a patch of up to 4 query
// rows x 16 query columns and does the same, tiled for this card:
// - The patch's key rows [y0 - w, y1 + w] (clamped to the image) stream
//   through a double-buffered cp.async ring in shared memory, a stage
//   holding 2 key rows x 64 channels of the 16 + 2w keys that the patch's
//   columns can reach, rounded up to n8 tiles (48 keys at w = 15), zeros
//   outside the image, with the key rows' kno riding on their last chunk.
//   The whole window union of a patch does not fit: an 8 x 16 patch would
//   need 38 x 46 keys x 512 B = 895 KB.
// - The cross term runs on the tensor cores in 3xTF32 with
//   `mma.sync.m16n8k8` (TF32 in, f32 sums), as matching_tf32.cuh does it:
//   x = hi + lo, the large products hi.hi summed per 32 channels and those
//   sums added in f32 (round to nearest), the small products lo.hi + hi.lo in
//   their own accumulator (one TF32 accumulator over 128 channels misses
//   an f32 tolerance). The query patch is split once and stays in shared
//   memory; a key is split as its B fragment is read.
// - A query row's 16 queries are one m16 tile; its n8 key tiles are shared
//   by the row's warps, 3 tiles each (2 warps at w = 15), and each stage's
//   2 key rows by 2 sets of those warps: 16 warps a block. A warp
//   multiplies only the key rows within w of its query row (31 of the
//   patch's 34 at w = 15); 31 of every 48 keys of a row are inside a
//   query's window.
// - The epilogue folds each candidate kno[key, o] - 2 cross, masked to
//   |dx| <= w and in-image keys, into a running minimum per (query,
//   object) in registers (templated on the object bound: 4, 8, 16 or 32);
//   at the end the quad's lanes and the warps of each query row reduce
//   it, and `manet::finish_distance` adds |q|^2 (4 partial sums per
//   thread, 4 threads a query) and writes it.
// Why this shape (timed on the H100 at the main path's 60 x 108): the
// kernel is bound by latency, not by the tensor cores (a warp's stage of
// mma.sync is a fraction of its time) nor by L2 (the 4-row patches read
// 85 MB), so what counted was fewer, larger stages (64 channels timed
// well under 16 or 32) and more warps per key row. 4 rows give 15 x 7 =
// 105 blocks of 16 warps (one an SM at 125 KB of shared memory), which
// timed at or below 2 rows (210 blocks) and 3 rows. With C = 512 (or a
// wide window) the patch shrinks to 2 or 1 rows to fit the shared memory.
//
// Bound on an H100: the in-window pairs' 2 (h w) (window pairs) C f32
// operations over a few MB of inputs, bound by operations: 67 TFLOP/s in
// f32 FMA, or 3 TF32 products per pair at 495 TFLOP/s on the tensor
// cores. The tensor cores also multiply the out-of-window keys of each
// n8 tile (48 of 31 keys a row at w = 15).
//
// With ARGMIN (entry `manet_local_matching_argmin`) the same template
// also returns the winner's flat index y * w + x into the previous frame:
// this replaces the TPU kernel `_kernel_argmin` (called by
// `local_matching_pallas_argmin`), the forward of the training path's
// argmin-routed local matching (kernel 5). Its epilogue folds each masked
// candidate into a running (min, flat index) per (query, object) with a
// strict <, and a thread visits its keys in ascending flat order (key rows
// in order, columns in order within a row), so it keeps the lowest index
// of equal minima; the quad's lanes and then the warps of each query row
// (which saw other n8 tiles and key rows) reduce by (value, lower index),
// a total order. So among equal minima the lowest flat index wins,
// whichever warp or tile saw it, as `jnp.argmin` over the strip does; -1
// stays where no key beats the 1e8 sentinel. Where no key of the object
// lies in the window the TPU kernel may name another pixel or a padding
// key, but there the output saturates at 1.0 and the routed gradient is
// gated to 0 either way. The (min, index) pairs double the running state:
// the argmin instances take at most 256 threads a block (lm_max_threads),
// so that ptxas can hold them without spills (170 registers at OB = 16),
// and the patch's query rows come from the wrapper (4, 2 or 1), which
// takes fewer rows on a small frame: the training crop's 52 x 52 gives
// only 4 x 13 patches of 4 rows, 52 blocks for 132 SMs; 2 rows (104
// blocks) timed fastest there, 1 row (208 blocks of 4 warps) between.

#include <stdint.h>

#include "common.cuh"

namespace {

// ------------------------------------------- kernel 2: 3xTF32 on mma.sync

constexpr int LM_COLS = 16;        // query columns of a patch: one m16 tile
constexpr int LM_PATCH_ROWS = 4;   // query rows of a patch, at most (see the header)
constexpr int LM_TILES = 3;        // n8 key tiles per warp
constexpr int LM_CK = 64;          // channels per stage
constexpr int LM_PITCH = LM_CK + 4;  // floats per staged row: conflict-free
constexpr int LM_SUB_KS = 4;       // k8 steps per large-product sum (32 channels)
constexpr int LM_STAGES = 2;       // stages in flight
constexpr int LM_DY = 2;           // key rows per stage, at most
constexpr int LM_C_MAX = 512;
constexpr int SMEM_MAX = 232448;   // dynamic shared memory of a block

// The most threads a block of object bound OB takes (its launch bound):
// the running minima of OB = 32, and the running (min, index) pairs of the
// argmin instances, need more than 128 registers a thread.
__host__ __device__ constexpr int lm_max_threads(int ob, bool argmin) {
  return ob <= 16 && !argmin ? 512 : 256;
}

// x = hi + lo, both TF32 (f32 bit patterns with the low 13 bits zero)
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi, uint32_t& lo) {
  hi = manet::tf32_rna(x);
  lo = manet::tf32_rna(__fsub_rn(x, __uint_as_float(hi)));
}

// 16 bytes global -> shared, zero-filled where `valid` is false
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               ::"r"(s), "l"(gmem), "r"(valid ? 16 : 0));
}
__device__ __forceinline__ void cp_async4(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(gmem));
}

// d += A (16 x 8) * B (8 x 8), TF32 in, f32 sums
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// The launch geometry of one (c, window, object bound).
struct LocalPlan {
  int nch;        // LM_CK-channel chunks
  int row_warps;  // warps per query row and key row: LM_TILES n8 tiles each
  int keys;       // keys of a staged row: row_warps * LM_TILES * 8
  int rows;       // query rows of a patch: max_rows, fewer to fit, 0
                  // where not even one row fits
  int dy;         // key rows per stage, one per warp of a (query row, tiles)
  int threads;    // dy * rows * row_warps * 32
  int stage;      // bytes of a stage: dy x keys x LM_PITCH f32, then the
                  // key rows' kno, dy x keys x OB
  // dynamic shared memory: the query patch [row][chunk][hi, lo][16][pitch],
  // |q|^2 of the patch, then the ring of stages
  int off_qn, off_ring, smem;
};

__host__ __device__ inline LocalPlan local_plan(int c, int window, int obj_bound,
                                                bool argmin, int max_rows) {
  LocalPlan p;
  p.nch = c / LM_CK;
  const int tiles = (LM_COLS + 2 * window + 7) / 8;
  p.row_warps = (tiles + LM_TILES - 1) / LM_TILES;
  p.keys = p.row_warps * LM_TILES * 8;
  // the most query rows whose patch, |q|^2 and ring fit the block
  const int max_threads = lm_max_threads(obj_bound, argmin);
  for (p.rows = max_rows; p.rows >= 1; p.rows /= 2) {
    const int base = p.rows * p.row_warps * 32;
    if (base > max_threads) continue;
    const int dy = max_threads / base;
    p.dy = dy < LM_DY ? dy : LM_DY;
    p.threads = p.dy * base;
    p.stage = p.dy * p.keys * (LM_PITCH + obj_bound) * 4;
    p.off_qn = p.rows * p.nch * 2 * LM_COLS * LM_PITCH * 4;
    p.off_ring = p.off_qn + p.rows * LM_COLS * 4;
    p.smem = p.off_ring + LM_STAGES * p.stage;
    if (p.smem <= SMEM_MAX) break;
  }
  return p;
}

// Kernels 2 and 5 (ARGMIN: also `idx`). Grid: (column tiles, row
// patches of up to max_rows rows). OB bounds num_obj. Warp (d, r, part):
// query row r of the patch, key tiles `part`, and key row d of each stage.
template <int OB, bool ARGMIN>
__global__ void __launch_bounds__(lm_max_threads(OB, ARGMIN))
local_matching_tf32(const float* __restrict__ q, const float* __restrict__ k,
                    const float* __restrict__ kno, float* __restrict__ out,
                    int* __restrict__ idx, int h, int w, int c, int num_obj,
                    int window, int max_rows) {
  extern __shared__ __align__(16) float smem[];
  const LocalPlan plan = local_plan(c, window, OB, ARGMIN, max_rows);
  float* sa = smem;                                      // query patch
  float* qn = smem + plan.off_qn / 4;                    // its |q|^2
  uint8_t* ring = reinterpret_cast<uint8_t*>(smem) + plan.off_ring;
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int rw = plan.row_warps;
  const int wd = warp / (plan.rows * rw);                // key row of a stage
  const int prow = warp / rw % plan.rows;                // query row of the patch
  const int wpart = warp % rw;                           // its key-tile share
  const int x0 = blockIdx.x * LM_COLS;
  const int y0 = blockIdx.y * plan.rows;
  const int qy = y0 + prow;
  const int nch = plan.nch;
  const int a_stride = 2 * LM_COLS * LM_PITCH;           // one chunk, hi + lo
  const int row_floats = plan.keys * LM_PITCH;           // a staged key row

  // the patch's key rows, walked in stages of (dy key rows, chunk); the
  // staged keys of a row start at column x0 - window
  const int ky0 = max(0, y0 - window);
  const int ky1 = min(h - 1, y0 + plan.rows - 1 + window);
  const int stages = (ky1 - ky0 + plan.dy) / plan.dy * nch;
  const int kx0 = x0 - window;

  // stage s into its ring slot: the chunk's keys (zeros outside the
  // image) and, with the last chunk, the key rows' kno
  auto load = [&](int s) {
    const int ky_first = ky0 + s / nch * plan.dy, cc = s % nch;
    float* dst = reinterpret_cast<float*>(ring + (s % LM_STAGES) * plan.stage);
    const int per_row = plan.keys * (LM_CK / 4);
    for (int f = tid; f < plan.dy * per_row; f += plan.threads) {
      const int d = f / per_row, rest = f - d * per_row;
      const int key = rest / (LM_CK / 4), j = rest % (LM_CK / 4);
      const int ky = ky_first + d, kx = kx0 + key;
      const bool in = ky <= ky1 && kx >= 0 && kx < w;
      cp_async16(dst + d * row_floats + key * LM_PITCH + j * 4,
                 in ? k + (static_cast<int64_t>(ky) * w + kx) * c + cc * LM_CK + j * 4 : k,
                 in);
    }
    if (cc == nch - 1) {
      float* kd = dst + plan.dy * row_floats;
      const int per_kn = plan.keys * num_obj;
      for (int f = tid; f < plan.dy * per_kn; f += plan.threads) {
        const int d = f / per_kn, rest = f - d * per_kn;
        const int key = rest / num_obj, o = rest % num_obj;
        const int ky = ky_first + d, kx = kx0 + key;
        if (ky <= ky1 && kx >= 0 && kx < w)
          cp_async4(kd + (d * plan.keys + key) * OB + o,
                    kno + (static_cast<int64_t>(ky) * w + kx) * num_obj + o);
      }
    }
  };
  for (int i = 0; i < LM_STAGES - 1; ++i) {
    if (i < stages) load(i);
    asm volatile("cp.async.commit_group;\n" ::);
  }

  // meanwhile the query patch, split into hi / lo once (zeros outside the
  // image), and its |q|^2 (4 threads a query, 4 partial sums each)
#pragma unroll 4
  for (int f = tid; f < plan.rows * LM_COLS * c / 4; f += plan.threads) {
    const int j = f % (LM_CK / 4), rest = f / (LM_CK / 4);
    const int cc = rest % nch, rest2 = rest / nch;
    const int col = rest2 % LM_COLS, row = rest2 / LM_COLS;
    const int y = y0 + row, x = x0 + col;
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (y < h && x < w)
      v = __ldg(reinterpret_cast<const float4*>(
          q + (static_cast<int64_t>(y) * w + x) * c + cc * LM_CK + j * 4));
    uint4 hi, lo;
    split_tf32(v.x, hi.x, lo.x);
    split_tf32(v.y, hi.y, lo.y);
    split_tf32(v.z, hi.z, lo.z);
    split_tf32(v.w, hi.w, lo.w);
    float* at = sa + (row * nch + cc) * a_stride + col * LM_PITCH + j * 4;
    *reinterpret_cast<uint4*>(at) = hi;
    *reinterpret_cast<uint4*>(at + LM_COLS * LM_PITCH) = lo;
  }
  for (int qi = tid / 4; qi < plan.rows * LM_COLS;
       qi += plan.threads / 4) {   // uniform over each warp
    const int y = y0 + qi / LM_COLS, x = x0 + qi % LM_COLS;
    float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
    if (y < h && x < w) {
      const float4* qr = reinterpret_cast<const float4*>(
          q + (static_cast<int64_t>(y) * w + x) * c);
#pragma unroll 4
      for (int j = tid % 4; j < c / 4; j += 4) {
        const float4 v = __ldg(qr + j);
        acc.x = fmaf(v.x, v.x, acc.x);
        acc.y = fmaf(v.y, v.y, acc.y);
        acc.z = fmaf(v.z, v.z, acc.z);
        acc.w = fmaf(v.w, v.w, acc.w);
      }
    }
    float v = (acc.x + acc.y) + (acc.z + acc.w);
    v += __shfl_xor_sync(0xffffffffu, v, 1);
    v += __shfl_xor_sync(0xffffffffu, v, 2);
    if (tid % 4 == 0) qn[qi] = v;
  }

  float run[2][OB];
  int arg[2][ARGMIN ? OB : 1];   // ARGMIN: the flat index of each minimum
#pragma unroll
  for (int o = 0; o < OB; ++o) {
    run[0][o] = run[1][o] = manet::kBig;
    if constexpr (ARGMIN) arg[0][o] = arg[1][o] = -1;
  }
  float big[LM_TILES][4], small[LM_TILES][4], cross[LM_TILES][4];

  for (int s = 0; s < stages; ++s) {
    asm volatile("cp.async.wait_group %0;\n" ::"n"(LM_STAGES - 2));   // stage s landed
    __syncthreads();   // and every warp is done with the slot refilled here
    if (s + LM_STAGES - 1 < stages) load(s + LM_STAGES - 1);
    asm volatile("cp.async.commit_group;\n" ::);

    const int ky = ky0 + s / nch * plan.dy + wd, cc = s % nch;
    // uniform over the warp
    if (ky > ky1 || qy >= h || abs(ky - qy) > window) continue;
    const float* ah = sa + (prow * nch + cc) * a_stride;
    const float* al = ah + LM_COLS * LM_PITCH;
    const float* slot = reinterpret_cast<const float*>(ring + (s % LM_STAGES) * plan.stage);
    const float* bk = slot + wd * row_floats + wpart * LM_TILES * 8 * LM_PITCH;
#pragma unroll
    for (int ks = 0; ks < LM_CK / 8; ++ks) {
      const int c0 = ks * 8 + t;
      uint32_t a_hi[4], a_lo[4];
      a_hi[0] = __float_as_uint(ah[g * LM_PITCH + c0]);
      a_hi[1] = __float_as_uint(ah[(g + 8) * LM_PITCH + c0]);
      a_hi[2] = __float_as_uint(ah[g * LM_PITCH + c0 + 4]);
      a_hi[3] = __float_as_uint(ah[(g + 8) * LM_PITCH + c0 + 4]);
      a_lo[0] = __float_as_uint(al[g * LM_PITCH + c0]);
      a_lo[1] = __float_as_uint(al[(g + 8) * LM_PITCH + c0]);
      a_lo[2] = __float_as_uint(al[g * LM_PITCH + c0 + 4]);
      a_lo[3] = __float_as_uint(al[(g + 8) * LM_PITCH + c0 + 4]);
#pragma unroll
      for (int n = 0; n < LM_TILES; ++n) {
        const int kr = (n * 8 + g) * LM_PITCH + c0;
        uint32_t bh0, bl0, bh1, bl1;
        split_tf32(bk[kr], bh0, bl0);
        split_tf32(bk[kr + 4], bh1, bl1);
        if (ks % LM_SUB_KS == 0) {   // the large sum starts with 32 channels
#pragma unroll
          for (int i = 0; i < 4; ++i) big[n][i] = 0.f;
          if (cc == 0 && ks == 0) {   // the small one with the key row
#pragma unroll
            for (int i = 0; i < 4; ++i) small[n][i] = 0.f;
          }
        }
        mma_tf32(small[n], a_lo, bh0, bh1);
        mma_tf32(small[n], a_hi, bl0, bl1);
        mma_tf32(big[n], a_hi, bh0, bh1);
      }
      if (ks % LM_SUB_KS == LM_SUB_KS - 1) {
        // 32 channels' large products join the row's sum in f32
#pragma unroll
        for (int n = 0; n < LM_TILES; ++n)
#pragma unroll
          for (int i = 0; i < 4; ++i)
            cross[n][i] = cc == 0 && ks < LM_SUB_KS ? big[n][i]
                                                    : __fadd_rn(cross[n][i], big[n][i]);
      }
    }
    if (cc != nch - 1) continue;

    // the key row is done: fold its candidates, masked to the window and
    // the image (outside, the candidate is -2 * -inf + kno = +inf), in
    // ascending flat index (with ARGMIN the first of equal minima stays)
    const float* kr = slot + plan.dy * row_floats + wd * plan.keys * OB;
#pragma unroll
    for (int n = 0; n < LM_TILES; ++n) {
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int key = (wpart * LM_TILES + n) * 8 + 2 * t + j;
        const bool in = static_cast<unsigned>(kx0 + key) < static_cast<unsigned>(w);
        const float* kn = kr + key * OB;
        const int flat = ky * w + kx0 + key;
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int qc = g + 8 * half;       // dx = key - window - qc
          const float e = __fadd_rn(cross[n][2 * half + j], small[n][2 * half + j]);
          const float x = (in && key >= qc && key <= qc + 2 * window)
                              ? e : -__int_as_float(0x7f800000);
#pragma unroll
          for (int o = 0; o < OB; o += 4) {
            const float4 kv = *reinterpret_cast<const float4*>(kn + o);
            const float cand[4] = {fmaf(-2.f, x, kv.x), fmaf(-2.f, x, kv.y),
                                   fmaf(-2.f, x, kv.z), fmaf(-2.f, x, kv.w)};
#pragma unroll
            for (int i = 0; i < 4; ++i) {
              if constexpr (ARGMIN)
                manet::keep_min(run[half][o + i], arg[half][o + i], cand[i], flat);
              else
                run[half][o + i] = fminf(run[half][o + i], cand[i]);
            }
          }
        }
      }
    }
  }

  // minima (with ARGMIN, (min, index) by value, then the lower index) over
  // the quad, then over the warps of each query row (through the ring, free
  // now), then the finish
#pragma unroll
  for (int half = 0; half < 2; ++half)
#pragma unroll
    for (int o = 0; o < OB; ++o) {
      if constexpr (ARGMIN) {
        manet::argmin_xor(run[half][o], arg[half][o], 1);
        manet::argmin_xor(run[half][o], arg[half][o], 2);
      } else {
        float v = run[half][o];
        v = fminf(v, __shfl_xor_sync(0xffffffffu, v, 1));
        v = fminf(v, __shfl_xor_sync(0xffffffffu, v, 2));
        run[half][o] = v;
      }
    }
  asm volatile("cp.async.wait_group 0;\n" ::);
  __syncthreads();
  float* part = reinterpret_cast<float*>(ring);   // [d][row][part][16][OB]
  int* part_arg = reinterpret_cast<int*>(part + plan.threads / 32 * LM_COLS * OB);
  if (t == 0) {
#pragma unroll
    for (int half = 0; half < 2; ++half)
#pragma unroll
      for (int o = 0; o < OB; ++o) {
        part[(warp * LM_COLS + g + 8 * half) * OB + o] = run[half][o];
        if constexpr (ARGMIN) part_arg[(warp * LM_COLS + g + 8 * half) * OB + o] = arg[half][o];
      }
  }
  __syncthreads();
  for (int i = tid; i < plan.rows * LM_COLS * num_obj; i += plan.threads) {
    const int o = i % num_obj, rest = i / num_obj;
    const int col = rest % LM_COLS, row = rest / LM_COLS;
    const int y = y0 + row, x = x0 + col;
    if (y >= h || x >= w) continue;
    float v = manet::kBig;
    int a = -1;
    for (int d = 0; d < plan.dy; ++d)
      for (int r = 0; r < rw; ++r) {
        const int at = (((d * plan.rows + row) * rw + r) * LM_COLS + col) * OB + o;
        if constexpr (ARGMIN)
          manet::argmin_fold(v, a, part[at], part_arg[at]);
        else
          v = fminf(v, part[at]);
      }
    const int64_t px = (static_cast<int64_t>(y) * w + x) * num_obj + o;
    out[px] = manet::finish_distance(v, qn[rest]);
    if (ARGMIN) idx[px] = a;
  }
}

template <int OB, bool ARGMIN>
int launch_tf32(const float* q, const float* k, const float* kno, float* out, int* idx,
                int h, int w, int c, int num_obj, int window, int max_rows,
                cudaStream_t stream) {
  const LocalPlan plan = local_plan(c, window, OB, ARGMIN, max_rows);
  // a (query row, tiles) per warp, two stages, and the warps' partial
  // minima (and their indices) in the freed ring
  if (plan.rows == 0 ||
      (ARGMIN ? 2 : 1) * plan.threads / 32 * LM_COLS * OB * 4 > LM_STAGES * plan.stage)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(
      local_matching_tf32<OB, ARGMIN>, cudaFuncAttributeMaxDynamicSharedMemorySize, plan.smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((w + LM_COLS - 1) / LM_COLS, (h + plan.rows - 1) / plan.rows);
  local_matching_tf32<OB, ARGMIN><<<grid, plan.threads, plan.smem, stream>>>(
      q, k, kno, out, idx, h, w, c, num_obj, window, max_rows);
  return static_cast<int>(cudaGetLastError());
}

// Both entries: the object bound's instance.
template <bool ARGMIN>
int launch_bucketed(const void* q, const void* k, const void* kno, void* out, void* idx,
                    int h, int w, int c, int num_obj, int window, int max_rows,
                    void* stream) {
  const auto* qf = static_cast<const float*>(q);
  const auto* kf = static_cast<const float*>(k);
  const auto* nf = static_cast<const float*>(kno);
  auto* of = static_cast<float*>(out);
  auto* ix = static_cast<int*>(idx);
  auto s = static_cast<cudaStream_t>(stream);
  if (num_obj <= 4)
    return launch_tf32<4, ARGMIN>(qf, kf, nf, of, ix, h, w, c, num_obj, window, max_rows, s);
  if (num_obj <= 8)
    return launch_tf32<8, ARGMIN>(qf, kf, nf, of, ix, h, w, c, num_obj, window, max_rows, s);
  if (num_obj <= 16)
    return launch_tf32<16, ARGMIN>(qf, kf, nf, of, ix, h, w, c, num_obj, window, max_rows, s);
  return launch_tf32<32, ARGMIN>(qf, kf, nf, of, ix, h, w, c, num_obj, window, max_rows, s);
}

bool shape_ok(int h, int w, int c, int num_obj, int window) {
  return h > 0 && w > 0 && c > 0 && c % 128 == 0 && c <= LM_C_MAX &&
         num_obj > 0 && num_obj <= 32 && window >= 0;
}

}  // namespace

// q, k (h, w, c) f32 with c a multiple of 128 (at most 512); kno and out
// (h, w, num_obj) f32, num_obj <= 32. All contiguous on the current device,
// 16-byte aligned.
extern "C" int manet_local_matching(const void* q, const void* k,
                                    const void* kno, void* out, int h, int w,
                                    int c, int num_obj, int window,
                                    void* stream) {
  if (!shape_ok(h, w, c, num_obj, window))
    return static_cast<int>(cudaErrorInvalidValue);
  return launch_bucketed<false>(q, k, kno, out, nullptr, h, w, c, num_obj, window,
                                LM_PATCH_ROWS, stream);
}

// As manet_local_matching, plus idx (h, w, num_obj) int32: the flat index
// of each minimum's key in the (h, w) previous frame. The patches take up
// to `rows` query rows (1, 2 or 4).
extern "C" int manet_local_matching_argmin(const void* q, const void* k,
                                           const void* kno, void* out,
                                           void* idx, int h, int w, int c,
                                           int num_obj, int window, int rows,
                                           void* stream) {
  if (!shape_ok(h, w, c, num_obj, window) || idx == nullptr ||
      (rows != 1 && rows != 2 && rows != LM_PATCH_ROWS))
    return static_cast<int>(cudaErrorInvalidValue);
  return launch_bucketed<true>(q, k, kno, out, idx, h, w, c, num_obj, window, rows,
                               stream);
}

// The dynamic shared memory of kernel 2 at (c, window, num_obj), in bytes.
extern "C" int manet_local_matching_smem(int c, int window, int num_obj) {
  const int ob = num_obj <= 4 ? 4 : num_obj <= 8 ? 8 : num_obj <= 16 ? 16 : 32;
  return local_plan(c, window, ob, false, LM_PATCH_ROWS).smem;
}
