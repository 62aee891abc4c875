// Ring global matching: one member's step of the context ring, for Hopper
// (sm_90a).
//
// Replaces the TPU kernel cvpr2020_manet_tpu/ops/ring_matching_pallas.py
// `_ring_kernel` (called by `ring_matching_shard`). On the TPU the
// memory shards, bucketed by `prepare_ref`, rotate around the ring inside
// the kernel (inter-chip RDMA) while an un-normalized accumulator folds
//
//   acc[q, o] = min over the shards seen so far of min_{k in o} (|k|^2 - 2 q.k)
//
// and only the last step adds |q|^2, clamps to [0, 1e8] and normalizes.
// A Hopper kernel cannot reach another card's memory in flight the way the
// TPU's remote DMA does, and members that share one card have nothing to
// send, so the rotation lives outside the kernel (parallel/ring.py: copy
// streams and events, overlapped with this kernel as the RDMA was). This
// kernel is one step: launched once per member per step, it loads the
// block's running minima from `acc` (kBig at the first step), folds the
// current shard, and stores them back, or at the last step writes the
// normalized distances to `out`.
//
// The step is kernel 1's f32 variant itself (matching_tf32.cuh
// `global_matching_tf32`: 3xTF32 on the tensor cores, with its accumulator
// carried in `acc`), so a pair's candidate does not depend on which shard
// or block holds the key, and the ring's output is bit-identical across
// ring sizes, across runs and to kernel 1's f32 variant over all rows.
//
// Bound on an H100: 3 x 2 Nq Nk C TF32 operations for the whole ring (each
// member on one card: n times that) against Nq C + Nk C inputs, so the
// step is bound by operations (495 TFLOP/s dense TF32).

#include "matching_tf32.cuh"

// One ring step. query (nq, c) and neg2 (nkb * block_k, c) f32, c <= 128 a
// multiple of 32, 16-byte aligned; sqnorm (nkb, block_k) f32 (1e8 on
// padding rows), block_k a multiple of 128; block_obj (nkb,) int32
// (>= num_obj on slack blocks); acc (nq, num_obj) f32, read unless
// `first`, written unless `last`; out (nq, num_obj) f32, written at the
// `last` step. All contiguous on the current device.
extern "C" int manet_ring_matching_step(const void* query, const void* neg2,
                                        const void* sqnorm,
                                        const void* block_obj, void* acc,
                                        void* out, long long nq, int c,
                                        int nkb, int block_k, int num_obj,
                                        int first, int last, void* stream) {
  auto* a = static_cast<float*>(acc);
  return manet::launch_tf32(
      static_cast<const float*>(query), static_cast<const float*>(neg2),
      static_cast<const float*>(sqnorm), static_cast<const int*>(block_obj),
      static_cast<float*>(out), first ? nullptr : a, last ? nullptr : a, nq,
      c, nkb, block_k, num_obj, static_cast<cudaStream_t>(stream));
}
