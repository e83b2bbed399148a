// One (row, head) of single-token decode attention, computed by a whole
// block: the attention of decode_layer.cu (the flat cache of the fused
// decode step).
#pragma once

#include "common.cuh"

namespace vct {

constexpr int kAttendHeadDim = 64;

// Shared memory an attend_head call needs, in floats, for a cache of L rows.
__host__ __device__ constexpr int attend_smem_floats(int L, int threads) {
  return L + (threads / kAttendHeadDim) * kAttendHeadDim + 32;
}

// out[d] = sum_j p_j v_j[d], p = softmax_j(q . k_j * scale), for the cache
// rows j < L of one (row, head): row j's 64 K values at k + j * k_stride, its
// V values at v + j * v_stride. Row j is visible when j <= last and
// valid[j] > 0; invisible rows get the logit -1e30, as in the TPU kernels,
// so they weigh exactly 0 (and their V is not read) unless every row is
// invisible. Logits and softmax in f32, the probabilities rounded to T
// before the product with V (as the fused decode step of the TPU rounds
// them); the product accumulates in f32 and the output is rounded to T.
//
// Work split: warps take cache rows (lanes split the head dim, one shuffle
// reduction per row); the block normalises in shared memory; then each group
// of 64 threads sums every (threads / 64)-th row for one output dimension per
// thread, and the groups' sums are added in shared memory. blockDim.x is a
// multiple of 64. `smem` holds attend_smem_floats(L, blockDim.x) floats.
// Pointers are not __restrict__: in the fused step the cache and q were
// written by other blocks of the same grid.
template <typename T>
__device__ void attend_head(const T* q, const T* k, long k_stride, const T* v, long v_stride,
                            const int* valid, int L, int last, float scale, float* smem,
                            T* out) {
  float* ps = smem;                                   // [L] logits, then probabilities
  float* part = smem + L;                             // [groups * 64] partial outputs
  float* scratch = part + (blockDim.x / kAttendHeadDim) * kAttendHeadDim;  // [32]
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nwarps = blockDim.x >> 5;

  const float q0 = to_f32(q[lane]), q1 = to_f32(q[lane + 32]);
  for (int j = warp; j < L; j += nwarps) {
    const bool visible = j <= last && valid[j] > 0;   // uniform over the warp
    float s = 0.f;
    if (visible) {
      const T* kr = k + (long)j * k_stride;
      s = warp_sum(q0 * to_f32(kr[lane]) + q1 * to_f32(kr[lane + 32]));
    }
    if (lane == 0) ps[j] = visible ? s * scale : -1e30f;
  }
  __syncthreads();

  float mx = -INFINITY;
  for (int j = tid; j < L; j += blockDim.x) mx = fmaxf(mx, ps[j]);
  mx = block_max(mx, scratch);
  float se = 0.f;
  for (int j = tid; j < L; j += blockDim.x) se += expf(ps[j] - mx);
  se = block_sum(se, scratch);
  for (int j = tid; j < L; j += blockDim.x) {
    const float p = expf(ps[j] - mx) / se;
    ps[j] = round_to<T>(p);
  }
  __syncthreads();

  const int d = tid % kAttendHeadDim, group = tid / kAttendHeadDim;
  const int groups = blockDim.x / kAttendHeadDim;
  float acc = 0.f;
  for (int j = group; j < L; j += groups) {
    const float p = ps[j];
    if (p != 0.f) acc = fmaf(p, to_f32(v[(long)j * v_stride + d]), acc);
  }
  part[group * kAttendHeadDim + d] = acc;
  __syncthreads();
  if (tid < kAttendHeadDim) {
    float s = 0.f;
    for (int g = 0; g < groups; ++g) s += part[g * kAttendHeadDim + tid];
    out[tid] = from_f32<T>(s);
  }
  __syncthreads();   // smem is reused by the caller's next unit
}

}  // namespace vct
