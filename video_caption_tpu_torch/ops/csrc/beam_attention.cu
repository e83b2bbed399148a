// One layer of beam-search decode attention over the split KV cache.
//
// Replaces: video_caption_tpu/ops/pallas/beam_attention.py, _run (Pallas
//   body _kernel), non-deferred mode.
// Computes, for query row r (video b = r / K) and head h:
//   - the prefill part: the prefill K/V [B, S0, H] of video b, on the
//     columns whose left-pad flag valid[b, s] > 0;
//   - the generated part: for every step nn <= t, exactly the one cache
//     column written by row anc[r, nn] (gen cache [N, 2, R, H], K at index 0,
//     V at index 1).
//   Logits (q . k) * hd^-0.5 in f32 (masked prefill columns at -1e30), one
//   f32 softmax over both parts, probabilities rounded to the compute dtype,
//   AV accumulated in f32, output [R, H] in the compute dtype, heads merged.
//   The dense masked form of the TPU kernel and of gpt2._beam_attend leaves
//   exactly one unmasked column per step nn (every other column gets
//   exp(-1e30 - m) = 0), so reading the ancestor's column directly computes
//   the same sum up to summation order. The hi/lo index split of the TPU
//   kernel works around a Mosaic limit and is not needed here: row indices
//   are compared as integers.
//
// What bounds it on the H100: per layer and step it reads S0 + t + 1 K/V rows
//   of one head per (row, head), a few hundred KB at single-request size;
//   the call is bound by launch latency, not by bytes or FLOPs.
// Design: one block of 64 threads (two warps) per (row, head). The query is
//   staged in shared memory; each warp computes whole column logits with
//   lanes splitting the head dim and a shuffle reduction; the block then
//   normalises in shared memory and each thread accumulates one output
//   dimension over all columns. Any row count R = B * K is taken (the TPU
//   kernel needs (vb * K) % 8 == 0, so single-request shapes went to XLA).
#include "common.cuh"

namespace {

constexpr int kHeadDim = 64;
constexpr int kThreads = 64;  // = head dim: one output dimension per thread

template <typename T>
__global__ void __launch_bounds__(kThreads)
beam_attention_kernel(const T* __restrict__ q, int q_stride, const T* __restrict__ gkv,
                      const T* __restrict__ pk, const T* __restrict__ pv,
                      const int* __restrict__ valid, const int* __restrict__ anc,
                      T* __restrict__ out, int r, int h, int k_beams, int s0, int n, int t,
                      float scale) {
  extern __shared__ __align__(16) float smem[];
  __shared__ float scratch[32];
  float* qs = smem;              // [64]
  float* ps = smem + kHeadDim;   // [s0 + t + 1] logits, then probabilities
  const int row = blockIdx.x, head = blockIdx.y;
  const int b = row / k_beams;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int col_off = head * kHeadDim;
  const int ncol = s0 + t + 1;

  qs[tid] = vct::to_f32(q[(size_t)row * q_stride + col_off + tid]);
  __syncthreads();

  for (int c = warp; c < ncol; c += kThreads / 32) {
    const T* kp;
    bool visible = true;
    if (c < s0) {
      visible = valid[b * s0 + c] > 0;
      kp = pk + ((size_t)b * s0 + c) * h + col_off;
    } else {
      const int nn = c - s0;
      kp = gkv + ((size_t)nn * 2 * r + anc[(size_t)row * n + nn]) * h + col_off;
    }
    float part = qs[lane] * vct::to_f32(kp[lane]) + qs[lane + 32] * vct::to_f32(kp[lane + 32]);
    part = vct::warp_sum(part);
    if (lane == 0) ps[c] = visible ? part * scale : -1e30f;
  }
  __syncthreads();

  float mx = -INFINITY;
  for (int c = tid; c < ncol; c += kThreads) mx = fmaxf(mx, ps[c]);
  mx = vct::block_max(mx, scratch);
  float se = 0.f;
  for (int c = tid; c < ncol; c += kThreads) se += expf(ps[c] - mx);
  se = vct::block_sum(se, scratch);
  for (int c = tid; c < ncol; c += kThreads) ps[c] = vct::round_to<T>(expf(ps[c] - mx) / se);
  __syncthreads();

  float acc = 0.f;
  for (int c = 0; c < s0; ++c)
    acc = fmaf(ps[c], vct::to_f32(pv[((size_t)b * s0 + c) * h + col_off + tid]), acc);
  for (int nn = 0; nn <= t; ++nn) {
    const size_t v_row = ((size_t)nn * 2 + 1) * r + anc[(size_t)row * n + nn];
    acc = fmaf(ps[s0 + nn], vct::to_f32(gkv[v_row * h + col_off + tid]), acc);
  }
  out[(size_t)row * h + col_off + tid] = vct::from_f32<T>(acc);
}

template <typename T>
int launch(const void* q, int q_stride, const void* gkv, const void* pk, const void* pv,
           const void* valid, const void* anc, void* out, int r, int h, int nh, int k_beams,
           int s0, int n, int t, cudaStream_t stream) {
  const size_t smem = (kHeadDim + (size_t)s0 + t + 1) * sizeof(float);
  auto kernel = beam_attention_kernel<T>;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const dim3 grid(r, nh);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), q_stride, static_cast<const T*>(gkv),
      static_cast<const T*>(pk), static_cast<const T*>(pv), static_cast<const int*>(valid),
      static_cast<const int*>(anc), static_cast<T*>(out), r, h, k_beams, s0, n, t,
      1.0f / sqrtf((float)kHeadDim));
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int vct_beam_attention(const void* q, int q_stride, const void* gkv,
                                  const void* pk, const void* pv, const void* valid,
                                  const void* anc, void* out, int r, int h, int nh,
                                  int k_beams, int s0, int n, int t, int dtype,
                                  void* stream) {
  if (r <= 0 || nh <= 0 || h != nh * kHeadDim || k_beams <= 0 || r % k_beams || s0 < 0 ||
      n <= 0 || t < 0 || t >= n || q_stride < h)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == vct::kBFloat16)
    return launch<__nv_bfloat16>(q, q_stride, gkv, pk, pv, valid, anc, out, r, h, nh,
                                 k_beams, s0, n, t, st);
  if (dtype == vct::kFloat32)
    return launch<float>(q, q_stride, gkv, pk, pv, valid, anc, out, r, h, nh, k_beams, s0,
                         n, t, st);
  return (int)cudaErrorInvalidValue;
}
