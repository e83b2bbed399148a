// Single-token decode attention over the contiguous KV cache.
//
// Replaces: video_caption_tpu/ops/pallas/decode_attention.py, _decode_attention
//   (Pallas body _attn_kernel).
// Computes, for batch row b and head h: softmax over the L cache columns of
//   q[b,h] . k[b,l,h] * hd^-0.5, masked to -1e30 where valid[b,l] == 0, then
//   the probability-weighted sum of v[b,l,h]. Logits, softmax and the product
//   with V in f32 (the probabilities are not rounded, as in the TPU kernel);
//   the output [B, nh, hd] in the compute dtype.
//   q and the caches arrive as strided views: q [B, nh, 64] with batch stride
//   q_stride (a slice of the fused QKV output), K and V [B, L, nh, 64] with
//   their own batch and row strides (the K and V halves of one layer of the
//   interleaved [B, max_len, 2, nh, hd] cache), so the caller copies nothing.
//
// What bounds it on the H100: it reads the visible K and V rows once
//   (2 * L * 768 * 2 bytes per batch row at bf16, ~200 KB at L = 64) and does
//   ~4 * L * 768 FLOPs per row: bytes, and at single-request size the launch
//   latency (12 blocks).
// Design: one block of 128 threads per (row, head) (decode_attend.cuh): warps
//   take cache rows with lanes splitting the head dim, the logits of all L
//   rows sit in shared memory for the f32 softmax, and two groups of 64
//   threads sum the weighted V rows. Any B and L are taken.
#include "decode_attend.cuh"

namespace {

constexpr int kThreads = 128;

template <typename T>
__global__ void __launch_bounds__(kThreads)
decode_attention_kernel(const T* __restrict__ q, int q_stride, const T* __restrict__ k,
                        int k_bstride, int k_lstride, const T* __restrict__ v, int v_bstride,
                        int v_lstride, const int* __restrict__ valid, T* __restrict__ out,
                        int nh, int L, float scale) {
  extern __shared__ __align__(16) float smem[];
  const int b = blockIdx.x, head = blockIdx.y;
  const long hoff = (long)head * vct::kAttendHeadDim;
  vct::attend_head<T, false>(q + (long)b * q_stride + hoff, k + (long)b * k_bstride + hoff,
                             k_lstride, v + (long)b * v_bstride + hoff, v_lstride,
                             valid + (long)b * L, L, L - 1, scale, smem,
                             out + ((long)b * nh + head) * vct::kAttendHeadDim);
}

template <typename T>
int launch(const void* q, int q_stride, const void* k, int k_bstride, int k_lstride,
           const void* v, int v_bstride, int v_lstride, const void* valid, void* out, int b,
           int nh, int L, cudaStream_t stream) {
  const size_t smem = (size_t)vct::attend_smem_floats(L, kThreads) * sizeof(float);
  auto kernel = decode_attention_kernel<T>;
  if (smem > 48 * 1024) {
    cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  kernel<<<dim3(b, nh), kThreads, smem, stream>>>(
      static_cast<const T*>(q), q_stride, static_cast<const T*>(k), k_bstride, k_lstride,
      static_cast<const T*>(v), v_bstride, v_lstride, static_cast<const int*>(valid),
      static_cast<T*>(out), nh, L, 1.0f / sqrtf((float)vct::kAttendHeadDim));
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int vct_decode_attention(const void* q, int q_stride, const void* k, int k_bstride,
                                    int k_lstride, const void* v, int v_bstride,
                                    int v_lstride, const void* valid, void* out, int b, int nh,
                                    int L, int dtype, void* stream) {
  if (b <= 0 || nh <= 0 || L <= 0 || q_stride < nh * vct::kAttendHeadDim ||
      k_lstride < nh * vct::kAttendHeadDim || v_lstride < nh * vct::kAttendHeadDim)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == vct::kBFloat16)
    return launch<__nv_bfloat16>(q, q_stride, k, k_bstride, k_lstride, v, v_bstride, v_lstride,
                                 valid, out, b, nh, L, st);
  if (dtype == vct::kFloat32)
    return launch<float>(q, q_stride, k, k_bstride, k_lstride, v, v_bstride, v_lstride, valid,
                         out, b, nh, L, st);
  return (int)cudaErrorInvalidValue;
}
