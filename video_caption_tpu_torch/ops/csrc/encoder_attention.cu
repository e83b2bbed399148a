// ViT encoder attention over the raw fused-QKV activation.
//
// Replaces: video_caption_tpu/ops/pallas/encoder_attention.py,
//   _batched_attention (Pallas body _attn_qkv_kernel).
// Computes: qkv [N, S, 3H] -> out [N, S, H]; per head h, q/k/v are the
//   columns h*hd, H + h*hd and 2H + h*hd of the fused activation (read
//   through strides, no split copies), logits = (q . k) * hd^-0.5 in f32,
//   softmax in f32 normalised BEFORE the cast to the compute dtype, AV
//   accumulated in f32, output cast to the compute dtype with heads merged.
//
// What bounds it on the H100: at S = 197, hd = 64 the whole head sequence
//   fits on chip, so device-memory traffic is one read of qkv and one write of
//   out (~4.6 MB per 16 frames in bf16). The work is 4*S*S*hd FLOPs per
//   (frame, head), which this first version runs on the CUDA cores in f32,
//   not the tensor cores: it is bound by FMA issue (and the shared-memory
//   reads that feed it), not by memory.
// Design: one block per (frame, head, tile of 128 queries), one thread per
//   query. The head's K and V are staged once per block in shared memory as
//   f32 (2 * S * 64 * 4 B = 101 KB at S = 197, dynamic shared memory). Each
//   thread keeps its query and its output row in registers; every warp reads
//   the same K/V row at the same time, so the shared-memory loads are
//   broadcasts of 16 bytes. Pass 1 computes the row max and the softmax
//   denominator online; pass 2 recomputes the logits, normalises, rounds the
//   probability to the compute dtype (the TPU kernel's cast point) and
//   accumulates AV. Recomputing the logits costs 1.5x the FMAs of a stored
//   logit row but keeps the normalise-then-cast order without a 197-float
//   buffer per query.
#include "common.cuh"

namespace {

constexpr int kHeadDim = 64;
constexpr int kQueries = 128;  // queries (threads) per block

template <typename T>
__global__ void __launch_bounds__(kQueries)
encoder_attention_kernel(const T* __restrict__ qkv, T* __restrict__ out,
                         int s, int h, float scale) {
  extern __shared__ __align__(16) float smem[];
  float* ks = smem;                          // [s][64]
  float* vs = smem + (size_t)s * kHeadDim;   // [s][64]
  const int frame = blockIdx.x, head = blockIdx.y;
  const int query = blockIdx.z * kQueries + threadIdx.x;
  const size_t row_stride = 3 * (size_t)h;
  const T* base = qkv + (size_t)frame * s * row_stride;

  for (int i = threadIdx.x; i < s * kHeadDim; i += kQueries) {
    const T* row = base + (size_t)(i / kHeadDim) * row_stride + head * kHeadDim + i % kHeadDim;
    ks[i] = vct::to_f32(row[h]);
    vs[i] = vct::to_f32(row[2 * h]);
  }
  __syncthreads();
  if (query >= s) return;

  float q[kHeadDim];
  const T* qp = base + (size_t)query * row_stride + head * kHeadDim;
#pragma unroll
  for (int d = 0; d < kHeadDim; ++d) q[d] = vct::to_f32(qp[d]);

  // pass 1: row max and softmax denominator (online rescale)
  float m = -INFINITY, l = 0.f;
  for (int key = 0; key < s; ++key) {
    const float4* kr = reinterpret_cast<const float4*>(ks + key * kHeadDim);
    float dot = 0.f;
#pragma unroll
    for (int d4 = 0; d4 < kHeadDim / 4; ++d4) {
      const float4 kv = kr[d4];
      dot = fmaf(q[4 * d4 + 0], kv.x, dot);
      dot = fmaf(q[4 * d4 + 1], kv.y, dot);
      dot = fmaf(q[4 * d4 + 2], kv.z, dot);
      dot = fmaf(q[4 * d4 + 3], kv.w, dot);
    }
    const float x = dot * scale;
    const float m_new = fmaxf(m, x);
    l = l * expf(m - m_new) + expf(x - m_new);
    m = m_new;
  }

  // pass 2: normalised probabilities, rounded to T, times V
  float acc[kHeadDim];
#pragma unroll
  for (int d = 0; d < kHeadDim; ++d) acc[d] = 0.f;
  for (int key = 0; key < s; ++key) {
    const float4* kr = reinterpret_cast<const float4*>(ks + key * kHeadDim);
    float dot = 0.f;
#pragma unroll
    for (int d4 = 0; d4 < kHeadDim / 4; ++d4) {
      const float4 kv = kr[d4];
      dot = fmaf(q[4 * d4 + 0], kv.x, dot);
      dot = fmaf(q[4 * d4 + 1], kv.y, dot);
      dot = fmaf(q[4 * d4 + 2], kv.z, dot);
      dot = fmaf(q[4 * d4 + 3], kv.w, dot);
    }
    const float p = vct::round_to<T>(expf(dot * scale - m) / l);
    const float4* vr = reinterpret_cast<const float4*>(vs + key * kHeadDim);
#pragma unroll
    for (int d4 = 0; d4 < kHeadDim / 4; ++d4) {
      const float4 vv = vr[d4];
      acc[4 * d4 + 0] = fmaf(p, vv.x, acc[4 * d4 + 0]);
      acc[4 * d4 + 1] = fmaf(p, vv.y, acc[4 * d4 + 1]);
      acc[4 * d4 + 2] = fmaf(p, vv.z, acc[4 * d4 + 2]);
      acc[4 * d4 + 3] = fmaf(p, vv.w, acc[4 * d4 + 3]);
    }
  }
  T* op = out + ((size_t)frame * s + query) * h + head * kHeadDim;
#pragma unroll
  for (int d = 0; d < kHeadDim; ++d) op[d] = vct::from_f32<T>(acc[d]);
}

template <typename T>
int launch(const void* qkv, void* out, int n, int s, int h, int nh, cudaStream_t stream) {
  const size_t smem = 2 * (size_t)s * kHeadDim * sizeof(float);
  auto kernel = encoder_attention_kernel<T>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(n, nh, (s + kQueries - 1) / kQueries);
  kernel<<<grid, kQueries, smem, stream>>>(
      static_cast<const T*>(qkv), static_cast<T*>(out), s, h, 1.0f / sqrtf((float)kHeadDim));
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int vct_encoder_attention(const void* qkv, void* out, int n, int s, int h,
                                     int nh, int dtype, void* stream) {
  if (n <= 0 || s <= 0 || nh <= 0 || h != nh * kHeadDim) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == vct::kBFloat16) return launch<__nv_bfloat16>(qkv, out, n, s, h, nh, st);
  if (dtype == vct::kFloat32) return launch<float>(qkv, out, n, s, h, nh, st);
  return (int)cudaErrorInvalidValue;
}
