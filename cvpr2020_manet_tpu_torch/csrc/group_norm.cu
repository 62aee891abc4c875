// Kernel 7: GroupNorm on NCHW bf16 activations, with the call sites'
// residual add and ReLU in its epilogue (ops/group_norm_cuda.py).
//
// It replaces no TPU kernel: the JAX model's Flax `nn.GroupNorm` is left
// to XLA, which fuses the statistics and the affine into their neighbours.
// On the H100 the norm does a few operations a byte, far below the ridge,
// so bytes bound it: each bf16 element is read and its result written, 4
// bytes (6 with a residual). The chain it replaces (an f32 upcast, aten's
// statistics over one block a (sample, group) row, an f32 apply, a bf16
// cast, ReLU, a bf16 add) moved about 28 bytes an element, and its
// statistics kernel ran 32 blocks on 132 SMs at 1080p.
//
// Two launches on the caller's stream, no atomics, no synchronize:
//
//   group_norm_stats: each (n, g) row of Cg * H * W contiguous elements is
//     cut into `splits` chunks, one block each, so that rows x splits
//     fills the card. 16-byte loads (a scalar head and tail where a chunk
//     does not start or end on 16 bytes: Cg * H * W odd), four in flight
//     a thread. Moments in f32: a thread takes each group of loaded values
//     as one block (its mean and sum of squared deviations) and merges it
//     into its running (count, mean, M2) with Chan's formula; threads and
//     warps merge the same way. A block writes its chunk's (mean, M2).
//   group_norm_apply: each block covers a chunk of one (n, c) plane, so
//     scale and shift are scalars of the block. Warp 0 merges the row's
//     partials (in split order, the same in every block of the row) into
//     mean and rstd = rsqrt(M2 / count + eps), while every thread's first
//     loads are already in flight; then the block streams x (and the
//     residual) and writes y, 16 bytes a thread at a time: ReLU, the
//     residual then ReLU, or neither, the three tails of the model's
//     sites (a residual without ReLU is refused). Its
//     blocks take the planes from the last, so that they first read what
//     the statistics read last: a tensor under about 40 MB is still in the
//     50 MB L2, and of a larger one its tail.
//
// Rounding as the plain version (F.group_norm on x.float(), the result
// cast to bf16, the bf16 residual add, ReLU): y = x * scale + shift in
// f32 rounded to bf16; plus the residual in f32, rounded to bf16 again;
// ReLU last. Only the order of the f32 sums of the statistics differs.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kVec = 8;        // bf16 elements in a 16-byte vector
constexpr int kUnroll = 4;     // vectors in flight a thread

struct Moments {
  float n, mean, m2;
};

// Chan's merge of a block (nb, mb, m2b) into `a`.
__device__ __forceinline__ void merge(Moments& a, float nb, float mb,
                                      float m2b) {
  if (nb == 0.f) return;
  const float n = a.n + nb;
  const float delta = mb - a.mean;
  const float wb = nb / n;          // 1 exactly where `a` is empty
  a.mean = fmaf(delta, wb, a.mean);
  a.m2 += m2b + delta * delta * a.n * wb;
  a.n = n;
}

__device__ __forceinline__ void warp_merge(Moments& a) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float n = __shfl_xor_sync(0xffffffffu, a.n, off);
    const float m = __shfl_xor_sync(0xffffffffu, a.mean, off);
    const float q = __shfl_xor_sync(0xffffffffu, a.m2, off);
    merge(a, n, m, q);
  }
}

// The block's moments, in thread 0.
__device__ __forceinline__ Moments block_merge(Moments a) {
  __shared__ float sh[3][kWarps];
  warp_merge(a);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (lane == 0) {
    sh[0][warp] = a.n;
    sh[1][warp] = a.mean;
    sh[2][warp] = a.m2;
  }
  __syncthreads();
  Moments r{0.f, 0.f, 0.f};
  if (warp == 0) {
    if (lane < kWarps) r = Moments{sh[0][lane], sh[1][lane], sh[2][lane]};
    warp_merge(r);
  }
  return r;
}

__device__ __forceinline__ void unpack(const uint4& v, float f[kVec]) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
  for (int i = 0; i < kVec / 2; ++i) {
    const float2 t = __bfloat1622float2(h[i]);
    f[2 * i] = t.x;
    f[2 * i + 1] = t.y;
  }
}

__device__ __forceinline__ uint4 pack(const float f[kVec]) {
  uint4 v;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&v);
#pragma unroll
  for (int i = 0; i < kVec / 2; ++i)
    h[i] = __floats2bfloat162_rn(f[2 * i], f[2 * i + 1]);
  return v;
}

__device__ __forceinline__ int64_t lmin(int64_t a, int64_t b) {
  return a < b ? a : b;
}

__device__ __forceinline__ int64_t lmax(int64_t a, int64_t b) {
  return a > b ? a : b;
}

// The range [a, b) of element indices (from a 16-byte aligned base) as a
// scalar head [a, va), whole vectors [va, vb) and a scalar tail [vb, b).
__device__ __forceinline__ void vector_span(int64_t a, int64_t b,
                                            int64_t& va, int64_t& vb) {
  va = lmin(b, (a + kVec - 1) / kVec * kVec);
  vb = lmax(va, b / kVec * kVec);
}

__global__ void __launch_bounds__(kThreads) group_norm_stats(
    const __nv_bfloat16* __restrict__ x, float2* __restrict__ partial,
    int64_t row_len, int splits, int64_t chunk) {
  const int64_t row = blockIdx.x / splits;
  const int64_t split = blockIdx.x % splits;
  const int64_t a = row * row_len + split * chunk;
  const int64_t b = row * row_len + lmin(row_len, (split + 1) * chunk);
  int64_t va, vb;
  vector_span(a, b, va, vb);
  Moments acc{0.f, 0.f, 0.f};
  for (int64_t i = a + threadIdx.x; i < va; i += kThreads)
    merge(acc, 1.f, __bfloat162float(x[i]), 0.f);
  for (int64_t i = vb + threadIdx.x; i < b; i += kThreads)
    merge(acc, 1.f, __bfloat162float(x[i]), 0.f);
  // groups of up to kUnroll vectors a thread, their loads in flight
  // together; a group's moments merge into the thread's as one block
  const uint4* xv = reinterpret_cast<const uint4*>(x);
  const int64_t v_end = vb / kVec;
  for (int64_t v = va / kVec + threadIdx.x; v < v_end;
       v += kUnroll * kThreads) {
    uint4 r[kUnroll];
    int k = 0;
#pragma unroll
    for (int u = 0; u < kUnroll; ++u)
      if (v + u * kThreads < v_end) {
        r[u] = __ldg(xv + v + u * kThreads);
        k = u + 1;
      }
    float s = 0.f;
#pragma unroll
    for (int u = 0; u < kUnroll; ++u)
      if (u < k) {
        float f[kVec];
        unpack(r[u], f);
#pragma unroll
        for (int e = 0; e < kVec; ++e) s += f[e];
      }
    const float m = s / float(k * kVec);
    float q = 0.f;
#pragma unroll
    for (int u = 0; u < kUnroll; ++u)
      if (u < k) {
        float f[kVec];
        unpack(r[u], f);
#pragma unroll
        for (int e = 0; e < kVec; ++e) {
          const float d = f[e] - m;
          q = fmaf(d, d, q);
        }
      }
    merge(acc, float(k * kVec), m, q);
  }
  const Moments tot = block_merge(acc);
  if (threadIdx.x == 0) partial[blockIdx.x] = make_float2(tot.mean, tot.m2);
}

// One output element: the affine rounded to bf16, the residual added in
// f32 and rounded again, ReLU; the result is exact in bf16.
template <bool RES, bool RELU>
__device__ __forceinline__ float finish(float x, float r, float scale,
                                        float shift) {
  float v = __bfloat162float(__float2bfloat16_rn(fmaf(x, scale, shift)));
  if (RES) v = __bfloat162float(__float2bfloat16_rn(v + r));
  if (RELU) v = v < 0.f ? 0.f : v;
  return v;
}

template <bool RES, bool RELU>
__global__ void __launch_bounds__(kThreads) group_norm_apply(
    const __nv_bfloat16* __restrict__ x,
    const __nv_bfloat16* __restrict__ res, __nv_bfloat16* __restrict__ y,
    const float* __restrict__ weight, const float* __restrict__ bias,
    const float2* __restrict__ partial, int channels, int cpg, int64_t hw,
    int splits, int64_t chunk, int plane_splits, int64_t plane_chunk,
    float eps) {
  // blocks walk the planes from the last: the statistics pass read x
  // from the first, so its tail is the part still in L2
  const int64_t blk = gridDim.x - 1 - blockIdx.x;
  const int64_t plane = blk / plane_splits;     // n * C + c
  const int64_t part = blk % plane_splits;
  const int c = static_cast<int>(plane % channels);
  const int64_t row = plane / channels * (channels / cpg) + c / cpg;
  const int64_t row_len = cpg * hw;
  const int64_t a = plane * hw + part * plane_chunk;
  const int64_t b = plane * hw + lmin(hw, (part + 1) * plane_chunk);
  int64_t va, vb;
  vector_span(a, b, va, vb);
  const uint4* xv = reinterpret_cast<const uint4*>(x);
  const uint4* rv = reinterpret_cast<const uint4*>(res);
  uint4* yv = reinterpret_cast<uint4*>(y);
  const int64_t v_end = vb / kVec;
  // groups of up to kUnroll vectors a thread (x and the residual), their
  // loads in flight together
  uint4 xr[kUnroll], rr[kUnroll];
  auto load = [&](int64_t v) {
#pragma unroll
    for (int u = 0; u < kUnroll; ++u)
      if (v + u * kThreads < v_end) {
        xr[u] = __ldg(xv + v + u * kThreads);
        if (RES) rr[u] = __ldg(rv + v + u * kThreads);
      }
  };
  int64_t v = va / kVec + threadIdx.x;
  load(v);       // the first group's loads overlap the merge below
  __shared__ float2 affine;
  if (threadIdx.x < 32) {
    Moments acc{0.f, 0.f, 0.f};
    for (int s = threadIdx.x; s < splits; s += 32) {
      const float2 p = partial[row * splits + s];
      merge(acc, float(lmin(chunk, row_len - s * chunk)), p.x, p.y);
    }
    warp_merge(acc);
    if (threadIdx.x == 0) {
      const float rstd = rsqrtf(fmaxf(acc.m2 / acc.n, 0.f) + eps);
      const float scale = rstd * weight[c];
      affine = make_float2(scale, fmaf(-scale, acc.mean, bias[c]));
    }
  }
  __syncthreads();
  const float scale = affine.x, shift = affine.y;
  for (int64_t i = a + threadIdx.x; i < va; i += kThreads)
    y[i] = __float2bfloat16_rn(finish<RES, RELU>(
        __bfloat162float(x[i]), RES ? __bfloat162float(res[i]) : 0.f,
        scale, shift));
  for (int64_t i = vb + threadIdx.x; i < b; i += kThreads)
    y[i] = __float2bfloat16_rn(finish<RES, RELU>(
        __bfloat162float(x[i]), RES ? __bfloat162float(res[i]) : 0.f,
        scale, shift));
  while (v < v_end) {
#pragma unroll
    for (int u = 0; u < kUnroll; ++u)
      if (v + u * kThreads < v_end) {
        float f[kVec], g[kVec];
        unpack(xr[u], f);
        if (RES) unpack(rr[u], g);
#pragma unroll
        for (int e = 0; e < kVec; ++e)
          f[e] = finish<RES, RELU>(f[e], RES ? g[e] : 0.f, scale, shift);
        yv[v + u * kThreads] = pack(f);
      }
    v += kUnroll * kThreads;
    load(v);
  }
}

template <bool RES, bool RELU>
void launch_apply(dim3 grid, cudaStream_t stream, const __nv_bfloat16* x,
                  const __nv_bfloat16* res, __nv_bfloat16* y,
                  const float* weight, const float* bias,
                  const float2* partial, int channels, int cpg, int64_t hw,
                  int splits, int64_t chunk, int plane_splits,
                  int64_t plane_chunk, float eps) {
  group_norm_apply<RES, RELU><<<grid, kThreads, 0, stream>>>(
      x, res, y, weight, bias, partial, channels, cpg, hw, splits, chunk,
      plane_splits, plane_chunk, eps);
}

}  // namespace

// x, residual (may be null; then `relu` must be set: the apply adds a
// residual only before ReLU), y: (n, channels, hw) bf16, 16-byte aligned;
// weight, bias: (channels,) f32; partial: n * groups * splits float2.
// Row (n, g) is cut into `splits` chunks of `chunk` elements (a multiple
// of 8; the last may be shorter), plane (n, c) into `plane_splits` chunks
// of `plane_chunk`. Returns the cudaError_t of the launches.
extern "C" int manet_group_norm(
    const void* x, const void* residual, void* y, const void* weight,
    const void* bias, void* partial, long long n, int channels,
    long long hw, int groups, int splits, long long chunk, int plane_splits,
    long long plane_chunk, float eps, int relu, void* stream) {
  if (residual != nullptr && !relu) return cudaErrorInvalidValue;
  const int cpg = channels / groups;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* xb = static_cast<const __nv_bfloat16*>(x);
  const auto* rb = static_cast<const __nv_bfloat16*>(residual);
  auto* yb = static_cast<__nv_bfloat16*>(y);
  const auto* w = static_cast<const float*>(weight);
  const auto* bi = static_cast<const float*>(bias);
  auto* p = static_cast<float2*>(partial);
  group_norm_stats<<<static_cast<unsigned>(n * groups * splits), kThreads,
                     0, s>>>(xb, p, static_cast<int64_t>(cpg) * hw, splits,
                             chunk);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const dim3 grid(static_cast<unsigned>(n * channels * plane_splits));
  if (rb != nullptr)
    launch_apply<true, true>(grid, s, xb, rb, yb, w, bi, p, channels, cpg,
                             hw, splits, chunk, plane_splits, plane_chunk,
                             eps);
  else if (relu)
    launch_apply<false, true>(grid, s, xb, rb, yb, w, bi, p, channels, cpg,
                              hw, splits, chunk, plane_splits, plane_chunk,
                              eps);
  else
    launch_apply<false, false>(grid, s, xb, rb, yb, w, bi, p, channels, cpg,
                               hw, splits, chunk, plane_splits, plane_chunk,
                               eps);
  return cudaGetLastError();
}
