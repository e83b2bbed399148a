// ViT encoder attention over the raw fused-QKV activation, on the tensor
// cores.
//
// Replaces: video_caption_tpu/ops/pallas/encoder_attention.py,
//   _batched_attention (Pallas body _attn_qkv_kernel).
// Computes: qkv [N, S, 3H] -> out [N, S, H]; per head h, q/k/v are the
//   columns h*64, H + h*64 and 2H + h*64 of the fused activation (read in
//   place, no split copies), logits = (q . k) * 64^-0.5 in f32, softmax in
//   f32 normalised BEFORE the cast to the compute dtype, AV accumulated in
//   f32, output cast to the compute dtype with heads merged.
//
// What bounds it on the H100: at S = 197 the work is 4*S*S*64 operations per
//   (frame, head), 1.9 GFLOP at 16 frames, ~2 us on the bf16 tensor cores,
//   while reading qkv and writing out (19 MB in bf16) takes 5.8 us at 3.35
//   TB/s: the bound is bytes. What a kernel has to avoid is running the
//   products on the CUDA cores and leaving the tensor cores waiting on serial
//   chains of loads and products with few warps per SM.
// Design: grid (query groups, heads, frames), one block of four warps per
//   (group, head, frame). The block stages the head's K and V once, in the
//   input dtype, with 16-byte cp.async, the keys zero-filled up to 16 * KT
//   (KT = 13 or 16 tiles of 16 keys: S <= 208 or 256). The 16-row query
//   tiles of the head go round the warps of its blocks; there is one group
//   per head unless the heads leave SMs idle (two at 16 frames in bf16).
//   A warp holds the logits of its 16 rows against all 16 * KT keys in
//   registers (2*KT m16n8 f32 accumulator tiles, 104 floats a thread at S =
//   197), so the softmax takes the exact row max and sum (quad shuffles)
//   with no online rescale and no second pass over the logits: p = 2^((x -
//   max) * 64^-0.5 * log2 e) in one FMA and one ex2.approx, times one
//   reciprocal of the row sum; pad keys are masked to -inf and pad queries
//   never stored. Every key tile is computed with no test against S inside
//   the product loops (a test per tile would put each load and its products
//   in a basic block of their own, behind a warp sync, and serialise them);
//   Q.K^T runs k-step outer so each step issues 2*KT independent products,
//   and the warp's next Q tile loads from global memory behind it.
//   bf16: mma.sync m16n8k16 (bf16 -> f32). Q's A fragments come straight from
//   global memory; K's B fragments through ldmatrix, V's through
//   ldmatrix.trans, both from rows swizzled by 16-byte chunk (chunk ^ row % 8)
//   so the eight rows of a matrix hit distinct banks. p is rounded to bf16
//   (the TPU kernel's cast point) and repacked in registers as the A fragment
//   of P.V: the accumulator layout of two m16n8 tiles is the A layout of one
//   m16n8k16. K + V take 53 KB at S = 197; 168 registers, 3 blocks per SM.
//   f32 (the stage-1 joint step; TF32 is off in the port's reference
//   setting): 3xTF32 on mma.sync m16n8k8, each operand split into a TF32 high
//   part (its top 19 bits) and the rest truncated to TF32 (two masks and a
//   subtract; x = hi + lo to ~2^-20), hi*hi + hi*lo + lo*hi with f32
//   accumulation. Chosen over a register-tiled SIMT kernel because it keeps
//   the bf16 kernel's tile structure and its logits-in-registers softmax at
//   f32 accuracy, and three TF32 products still run faster than one f32 FMA
//   on the CUDA cores. K and V stay f32 in shared memory, rows padded to 68
//   floats so the fragment loads hit distinct banks (113 KB at S = 197, 2
//   blocks per SM). The accumulator layout is not the tf32 A layout, so P.V
//   permutes the reduction index of each 8-key step (k = t <-> key 2t,
//   k = t + 4 <-> key 2t + 1) in both P and V, which leaves the sum unchanged.
#include <type_traits>

#include "common.cuh"
#include "mma.cuh"

namespace {

constexpr int kHeadDim = 64;
constexpr int kWarps = 4;
constexpr int kF32Stride = kHeadDim + 4;  // floats per K/V row in shared memory (f32)
constexpr float kScaleLog2e = 0.125f * 1.4426950408889634f;   // 64^-0.5 * log2(e)

// The softmax of a warp's 16 rows over its accumulator tiles (NT tiles of 8
// keys): rows g (c0, c1) and g + 8 (c2, c3), each spread over 4 neighbouring
// lanes. p = 2^((x - max x) * 64^-0.5 * log2 e) / sum, the scale folded into
// one FMA, the division one reciprocal per row.
template <int NT>
__device__ __forceinline__ void softmax_rows(float (&sacc)[NT][4], int s, int t) {
  float m0 = -INFINITY, m1 = -INFINITY;
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    if (8 * j + 8 > s) {                 // a tile that holds pad keys
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (8 * j + 2 * t + (e & 1) >= s) sacc[j][e] = -INFINITY;
    }
    m0 = fmaxf(m0, fmaxf(sacc[j][0], sacc[j][1]));
    m1 = fmaxf(m1, fmaxf(sacc[j][2], sacc[j][3]));
  }
#pragma unroll
  for (int o = 1; o < 4; o <<= 1) {
    m0 = fmaxf(m0, __shfl_xor_sync(0xffffffffu, m0, o));
    m1 = fmaxf(m1, __shfl_xor_sync(0xffffffffu, m1, o));
  }
  const float mc0 = m0 * kScaleLog2e, mc1 = m1 * kScaleLog2e;
  float l0 = 0.f, l1 = 0.f;
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    sacc[j][0] = vct::exp2_approx(fmaf(sacc[j][0], kScaleLog2e, -mc0));
    sacc[j][1] = vct::exp2_approx(fmaf(sacc[j][1], kScaleLog2e, -mc0));
    sacc[j][2] = vct::exp2_approx(fmaf(sacc[j][2], kScaleLog2e, -mc1));
    sacc[j][3] = vct::exp2_approx(fmaf(sacc[j][3], kScaleLog2e, -mc1));
    l0 += sacc[j][0] + sacc[j][1];
    l1 += sacc[j][2] + sacc[j][3];
  }
#pragma unroll
  for (int o = 1; o < 4; o <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, o);
    l1 += __shfl_xor_sync(0xffffffffu, l1, o);
  }
  const float i0 = 1.f / l0, i1 = 1.f / l1;
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    sacc[j][0] *= i0;
    sacc[j][1] *= i0;
    sacc[j][2] *= i1;
    sacc[j][3] *= i1;
  }
}

// ---------------------------------------------------------------- bf16

// A fragments of Q for the 16-row tile `tile` (zero past S)
__device__ __forceinline__ void load_q_bf16(uint32_t (&qf)[4][4], const __nv_bfloat16* base,
                                            size_t rs, int tile, int s, int g, int t) {
  const int r0 = 16 * tile + g, r1 = r0 + 8;
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int row = (e & 1) ? r1 : r0;
      const int col = 16 * kk + 2 * t + ((e & 2) ? 8 : 0);
      qf[kk][e] = row < s ? *reinterpret_cast<const uint32_t*>(base + row * rs + col) : 0u;
    }
  }
}

template <int KT>
__global__ void __launch_bounds__(32 * kWarps, KT <= 13 ? 3 : 1)   // 3 blocks: <= 168 registers
attention_bf16_kernel(const __nv_bfloat16* __restrict__ qkv, __nv_bfloat16* __restrict__ out,
                      int s, int h) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  constexpr int kp = 16 * KT;                         // keys staged, zero past S
  __nv_bfloat16* ks = reinterpret_cast<__nv_bfloat16*>(smem_raw);  // [kp][64], swizzled
  __nv_bfloat16* vs = ks + kp * kHeadDim;
  const int head = blockIdx.y, frame = blockIdx.z;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int mi = lane >> 3, rr = lane & 7;            // ldmatrix: matrix and row of this lane
  const size_t rs = 3 * (size_t)h;                    // row stride of qkv
  const __nv_bfloat16* base = qkv + (size_t)frame * s * rs + head * kHeadDim;

  // K and V: row `key` holds 8 chunks of 16 bytes, chunk c stored at
  // c ^ (key % 8); rows from S to 16 * KT zero-filled
  for (int part = 1; part <= 2; ++part) {
    __nv_bfloat16* dst = part == 1 ? ks : vs;
    for (int i = threadIdx.x; i < kp * 8; i += blockDim.x) {
      const int key = i >> 3, c = i & 7;
      const bool valid = key < s;
      vct::cp_async16(dst + key * kHeadDim + ((c ^ (key & 7)) << 3),
                      valid ? base + key * rs + part * h + c * 8 : base, valid);
    }
  }
  vct::cp_async_commit();

  // the 16-row query tiles of this head go round the warps of its blocks
  const int tiles = (s + 15) >> 4, step = kWarps * gridDim.x;
  int tile = warp * gridDim.x + blockIdx.x;
  uint32_t qf[4][4];
  load_q_bf16(qf, base, rs, tile, s, g, t);
  float sacc[2 * KT][4];

  // Q.K^T (k-step outer: 2*KT independent accumulators per step), the next
  // tile's Q in flight behind it, then the softmax
  auto logits = [&]() {
#pragma unroll
    for (int j = 0; j < 2 * KT; ++j) sacc[j][0] = sacc[j][1] = sacc[j][2] = sacc[j][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
      for (int kt = 0; kt < KT; ++kt) {
        // matrices: keys 0-7 / dims lo, keys 0-7 / dims hi, keys 8-15 / lo, 8-15 / hi
        const int key = 16 * kt + (mi >> 1) * 8 + rr;
        const int c = 2 * kk + (mi & 1);
        uint32_t b[4];
        vct::ldmatrix_x4(b, ks + key * kHeadDim + ((c ^ (key & 7)) << 3));
        vct::mma_bf16(sacc[2 * kt], qf[kk], b[0], b[1]);
        vct::mma_bf16(sacc[2 * kt + 1], qf[kk], b[2], b[3]);
      }
    }
    load_q_bf16(qf, base, rs, tile + step, s, g, t);
    softmax_rows<2 * KT>(sacc, s, t);
  };

  vct::cp_async_wait<0>();
  __syncthreads();                       // K and V have landed
  for (; tile < tiles; tile += step) {
    logits();
    float oacc[kHeadDim / 8][4];
#pragma unroll
    for (int j = 0; j < kHeadDim / 8; ++j) oacc[j][0] = oacc[j][1] = oacc[j][2] = oacc[j][3] = 0.f;
#pragma unroll
    for (int kt = 0; kt < KT; ++kt) {
      // p rounded to bf16 (the TPU kernel's cast point), repacked as A
      const uint32_t pa[4] = {vct::pack_bf16x2(sacc[2 * kt][0], sacc[2 * kt][1]),
                              vct::pack_bf16x2(sacc[2 * kt][2], sacc[2 * kt][3]),
                              vct::pack_bf16x2(sacc[2 * kt + 1][0], sacc[2 * kt + 1][1]),
                              vct::pack_bf16x2(sacc[2 * kt + 1][2], sacc[2 * kt + 1][3])};
#pragma unroll
      for (int dp = 0; dp < kHeadDim / 16; ++dp) {
        // matrices (transposed): keys 0-7 / dims lo, 8-15 / lo, 0-7 / hi, 8-15 / hi
        const int key = 16 * kt + (mi & 1) * 8 + rr;
        const int c = 2 * dp + (mi >> 1);
        uint32_t b[4];
        vct::ldmatrix_x4_trans(b, vs + key * kHeadDim + ((c ^ (key & 7)) << 3));
        vct::mma_bf16(oacc[2 * dp], pa, b[0], b[1]);
        vct::mma_bf16(oacc[2 * dp + 1], pa, b[2], b[3]);
      }
    }
    const int r0 = 16 * tile + g, r1 = r0 + 8;
    __nv_bfloat16* ob = out + (size_t)frame * s * h + head * kHeadDim + 2 * t;
#pragma unroll
    for (int j = 0; j < kHeadDim / 8; ++j) {
      if (r0 < s)
        *reinterpret_cast<uint32_t*>(ob + (size_t)r0 * h + 8 * j) = vct::pack_bf16x2(oacc[j][0], oacc[j][1]);
      if (r1 < s)
        *reinterpret_cast<uint32_t*>(ob + (size_t)r1 * h + 8 * j) = vct::pack_bf16x2(oacc[j][2], oacc[j][3]);
    }
  }
}

// ---------------------------------------------------------------- f32 (3xTF32)

__device__ __forceinline__ void load_q_f32(float (&qf)[8][4], const float* base, size_t rs,
                                           int tile, int s, int g, int t) {
  const int r0 = 16 * tile + g, r1 = r0 + 8;
#pragma unroll
  for (int kk = 0; kk < 8; ++kk) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int row = (e & 1) ? r1 : r0;
      const int col = 8 * kk + t + ((e & 2) ? 4 : 0);
      qf[kk][e] = row < s ? base[row * rs + col] : 0.f;
    }
  }
}

template <int KT>
__global__ void __launch_bounds__(32 * kWarps)
attention_f32_kernel(const float* __restrict__ qkv, float* __restrict__ out, int s, int h) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  constexpr int kp = 16 * KT;
  float* ks = reinterpret_cast<float*>(smem_raw);     // [kp][68]
  float* vs = ks + kp * kF32Stride;
  const int head = blockIdx.y, frame = blockIdx.z;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const size_t rs = 3 * (size_t)h;
  const float* base = qkv + (size_t)frame * s * rs + head * kHeadDim;

  for (int part = 1; part <= 2; ++part) {
    float* dst = part == 1 ? ks : vs;
    for (int i = threadIdx.x; i < kp * 16; i += blockDim.x) {
      const int key = i >> 4, c = i & 15;
      const bool valid = key < s;
      vct::cp_async16(dst + key * kF32Stride + 4 * c,
                      valid ? base + key * rs + part * h + 4 * c : base, valid);
    }
  }
  vct::cp_async_commit();

  const int tiles = (s + 15) >> 4, step = kWarps * gridDim.x;
  int tile = warp * gridDim.x + blockIdx.x;
  float qf[8][4];
  load_q_f32(qf, base, rs, tile, s, g, t);
  float sacc[2 * KT][4];

  auto logits = [&]() {
#pragma unroll
    for (int j = 0; j < 2 * KT; ++j) sacc[j][0] = sacc[j][1] = sacc[j][2] = sacc[j][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < 8; ++kk) {
      uint32_t ahi[4], alo[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) vct::split_tf32(qf[kk][e], ahi[e], alo[e]);
#pragma unroll
      for (int kt = 0; kt < KT; ++kt) {
        // two 8-key tiles; the three products of each interleaved
        uint32_t bh[2][2], bl[2][2];
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          const float* kr = ks + (16 * kt + 8 * u + g) * kF32Stride + 8 * kk + t;
          vct::split_tf32(kr[0], bh[u][0], bl[u][0]);
          vct::split_tf32(kr[4], bh[u][1], bl[u][1]);
        }
#pragma unroll
        for (int u = 0; u < 2; ++u) vct::mma_tf32(sacc[2 * kt + u], alo, bh[u][0], bh[u][1]);
#pragma unroll
        for (int u = 0; u < 2; ++u) vct::mma_tf32(sacc[2 * kt + u], ahi, bl[u][0], bl[u][1]);
#pragma unroll
        for (int u = 0; u < 2; ++u) vct::mma_tf32(sacc[2 * kt + u], ahi, bh[u][0], bh[u][1]);
      }
    }
    load_q_f32(qf, base, rs, tile + step, s, g, t);
    softmax_rows<2 * KT>(sacc, s, t);
  };

  vct::cp_async_wait<0>();
  __syncthreads();                       // K and V have landed
  for (; tile < tiles; tile += step) {
    logits();
    float oacc[kHeadDim / 8][4];
#pragma unroll
    for (int j = 0; j < kHeadDim / 8; ++j) oacc[j][0] = oacc[j][1] = oacc[j][2] = oacc[j][3] = 0.f;
#pragma unroll
    for (int j = 0; j < 2 * KT; ++j) {
      // reduction index k = t <-> key 8j + 2t, k = t + 4 <-> key 8j + 2t + 1
      uint32_t phi[4], plo[4];
      vct::split_tf32(sacc[j][0], phi[0], plo[0]);
      vct::split_tf32(sacc[j][2], phi[1], plo[1]);
      vct::split_tf32(sacc[j][1], phi[2], plo[2]);
      vct::split_tf32(sacc[j][3], phi[3], plo[3]);
      const float* vr = vs + (8 * j + 2 * t) * kF32Stride + g;
      uint32_t bh[kHeadDim / 8][2], bl[kHeadDim / 8][2];
#pragma unroll
      for (int nd = 0; nd < kHeadDim / 8; ++nd) {
        vct::split_tf32(vr[8 * nd], bh[nd][0], bl[nd][0]);
        vct::split_tf32(vr[kF32Stride + 8 * nd], bh[nd][1], bl[nd][1]);
      }
#pragma unroll
      for (int nd = 0; nd < kHeadDim / 8; ++nd) vct::mma_tf32(oacc[nd], plo, bh[nd][0], bh[nd][1]);
#pragma unroll
      for (int nd = 0; nd < kHeadDim / 8; ++nd) vct::mma_tf32(oacc[nd], phi, bl[nd][0], bl[nd][1]);
#pragma unroll
      for (int nd = 0; nd < kHeadDim / 8; ++nd) vct::mma_tf32(oacc[nd], phi, bh[nd][0], bh[nd][1]);
    }
    const int r0 = 16 * tile + g, r1 = r0 + 8;
    float* ob = out + (size_t)frame * s * h + head * kHeadDim + 2 * t;
#pragma unroll
    for (int j = 0; j < kHeadDim / 8; ++j) {
      if (r0 < s) *reinterpret_cast<float2*>(ob + (size_t)r0 * h + 8 * j) = make_float2(oacc[j][0], oacc[j][1]);
      if (r1 < s) *reinterpret_cast<float2*>(ob + (size_t)r1 * h + 8 * j) = make_float2(oacc[j][2], oacc[j][3]);
    }
  }
}

template <typename T, int KT>
int launch(const void* qkv, void* out, int n, int s, int h, int nh, cudaStream_t stream) {
  constexpr int kp = 16 * KT;
  constexpr int row_bytes = std::is_same<T, float>::value ? kF32Stride * sizeof(float)
                                                          : kHeadDim * sizeof(T);
  constexpr int smem = 2 * kp * row_bytes;
  constexpr auto kernel = [] {
    if constexpr (std::is_same<T, float>::value) return attention_f32_kernel<KT>;
    else return attention_bf16_kernel<KT>;
  }();
  // split a head's query tiles over more blocks only while the heads leave
  // SMs idle: each block stages the head's K and V once
  int resident = 0;
  const cudaError_t err = vct::resident_blocks<kernel>(32 * kWarps, smem, &resident);
  if (err != cudaSuccess) return (int)err;
  const int tiles = (s + 15) / 16;
  long groups = resident / ((long)n * nh);
  groups = groups < (tiles + kWarps - 1) / kWarps ? groups : (tiles + kWarps - 1) / kWarps;
  groups = groups > 1 ? groups : 1;
  const dim3 grid((unsigned)groups, nh, n);
  kernel<<<grid, 32 * kWarps, smem, stream>>>(static_cast<const T*>(qkv), static_cast<T*>(out),
                                              s, h);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(const void* qkv, void* out, int n, int s, int h, int nh, cudaStream_t stream) {
  if (s <= 16 * 13) return launch<T, 13>(qkv, out, n, s, h, nh, stream);
  return launch<T, 16>(qkv, out, n, s, h, nh, stream);
}

}  // namespace

extern "C" int vct_encoder_attention(const void* qkv, void* out, int n, int s, int h,
                                     int nh, int dtype, void* stream) {
  // S <= 256: the logits of 16 keys per tile, 16 tiles held in registers
  if (n <= 0 || s <= 0 || s > 256 || nh <= 0 || h != nh * kHeadDim || n > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == vct::kBFloat16) return dispatch<__nv_bfloat16>(qkv, out, n, s, h, nh, st);
  if (dtype == vct::kFloat32) return dispatch<float>(qkv, out, n, s, h, nh, st);
  return (int)cudaErrorInvalidValue;
}
