// LayerNorm and GELU that read and write bf16 and compute in f32.
//
// Replaces no TPU kernel. Added to remove the f32 round trips around every
//   LayerNorm and f32 GELU of the inference path: the plain versions
//   (ops/norm_act.py::layer_norm_ref, gelu_ref; the JAX package's rounding
//   points) cast x, the weight and the bias to f32, run the f32 operator and
//   cast the result back, five kernels and four f32 tensors in device memory
//   for a LayerNorm, three kernels for a GELU. Here the upcast and the
//   rounding happen in registers: one kernel, one read of x, one write of y.
// Computes:
//   layer_norm: x [rows, H] bf16, w, b [H] (bf16 or f32) -> y [rows, H] bf16:
//     mean = sum(x) / H, var = sum((x - mean)^2) / H over the row in f32,
//     y = w * (rsqrt(var + eps) * (x - mean)) + b in f32 (the expression of
//     PyTorch's vectorized_layer_norm_kernel), rounded once to bf16. PyTorch
//     takes the mean and variance by Welford's updates, this kernel in two
//     passes over the registers: the two differ only in the order of the f32
//     sums.
//   gelu: y = GELU(x) elementwise for bf16 x of any size, tanh or erf, in f32
//     with the formulas of PyTorch's CUDA GELU (kBeta = sqrt(2) * 2/sqrt(pi)
//     * 0.5, kKappa = 0.044715, 0.5x(1 + tanh(kBeta(x + kKappa x^3)));
//     x * 0.5 * (1 + erf(x / sqrt(2)))), rounded once.
// What bounds it on the H100: bytes. Both read x once and write y once (the
//   LayerNorm's weights come from L1/L2): the ViT's [25216, 768] LayerNorm of
//   a batch of 8 videos x 16 frames moves 77.5 MB (23 us at 3.35 TB/s), its
//   [25216, 3072] GELU 310 MB (93 us). In decode the rows are 8-48, and a
//   launch's fixed cost is the time.
// Design:
//   - layer_norm: one warp a row, kLnWarps rows a block. Where H is a
//     multiple of 8 and at most 8 x 32 x kLnChunks = 768 (every width of the
//     ViT-B/16 and GPT-2 124M configurations is 768) and every pointer is
//     16-byte aligned, each lane loads its (up to three) 8-element chunks of
//     the row with 16-byte loads, and the weight's and bias's beside them
//     before the reductions, and keeps them in registers for both sums and
//     the output: x is read from memory once. Otherwise (odd or wider rows,
//     views off 16 bytes) each lane strides the row element by element, three
//     passes that find the row in L1.
//   - gelu: 16-byte groups (8 values) where both pointers are 16-byte
//     aligned. Where one group a thread would take more than one resident
//     wave of blocks (the ViT's tensors), a 256-thread block takes 4 x 256
//     neighbouring groups, each thread 4 of them, 256 apart, all four loads
//     in flight before the math (0.129 ms at [25216, 3072] with one or two
//     a thread, 0.109 with four); otherwise (the decode's few rows) one
//     group a thread, so the blocks spread over more SMs. Then the elements
//     past the last whole group (all of them where a pointer is not
//     aligned) one by one, strided over the grid.
#include "common.cuh"

#include <stdint.h>

namespace {

constexpr int kLnWarps = 4;         // rows (one a warp) of a layer_norm block
constexpr int kLnChunks = 3;        // 8-element chunks a lane holds: H <= 768
constexpr int kGeluThreads = 256;
constexpr int kGeluUnroll = 4;      // 16-byte groups a GELU thread takes on large tensors

using bf16 = __nv_bfloat16;

__device__ __forceinline__ void unpack8(uint4 u, float* v) {
  const __nv_bfloat162* p = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(p[i]);
    v[2 * i] = f.x;
    v[2 * i + 1] = f.y;
  }
}

__device__ __forceinline__ uint4 pack8(const float* v) {
  uint4 u;
  __nv_bfloat162* p = reinterpret_cast<__nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) p[i] = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
  return u;
}

// 8 consecutive values of V from a 16-byte aligned address, kept as loaded
// until unpacked to f32
template <typename V>
struct Raw8 {
  uint4 u;
  __device__ __forceinline__ void load(const V* p) { u = *reinterpret_cast<const uint4*>(p); }
  __device__ __forceinline__ void unpack(float* v) const { unpack8(u, v); }
};
template <>
struct Raw8<float> {
  float4 a, b;
  __device__ __forceinline__ void load(const float* p) {
    a = reinterpret_cast<const float4*>(p)[0];
    b = reinterpret_cast<const float4*>(p)[1];
  }
  __device__ __forceinline__ void unpack(float* v) const {
    v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
    v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
  }
};

template <typename W>
__global__ void __launch_bounds__(kLnWarps * 32)
layer_norm_vec_kernel(const bf16* __restrict__ x, const W* __restrict__ w,
                      const W* __restrict__ b, bf16* __restrict__ y, int rows, int h, float eps) {
  const int row = blockIdx.x * kLnWarps + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= rows) return;                 // the whole warp: a row is a warp's
  const int chunks = h >> 3;
  const bf16* xr = x + static_cast<size_t>(row) * h;
  // every load first: the weights' latency hides behind the row's reductions
  Raw8<bf16> xv[kLnChunks];
  Raw8<W> wv[kLnChunks], bv[kLnChunks];
#pragma unroll
  for (int c = 0; c < kLnChunks; ++c) {
    const int i = 8 * (lane + 32 * c);
    if (lane + 32 * c < chunks) {
      xv[c].load(xr + i);
      wv[c].load(w + i);
      bv[c].load(b + i);
    }
  }
  float v[kLnChunks][8];
  float sum = 0.f;
#pragma unroll
  for (int c = 0; c < kLnChunks; ++c) {
    if (lane + 32 * c < chunks) {
      xv[c].unpack(v[c]);
#pragma unroll
      for (int k = 0; k < 8; ++k) sum += v[c][k];
    }
  }
  const float mean = vct::warp_sum(sum) / h;
  float sq = 0.f;
#pragma unroll
  for (int c = 0; c < kLnChunks; ++c) {
    if (lane + 32 * c < chunks) {
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        const float d = v[c][k] - mean;
        sq += d * d;
      }
    }
  }
  const float rstd = rsqrtf(vct::warp_sum(sq) / h + eps);
  bf16* yr = y + static_cast<size_t>(row) * h;
#pragma unroll
  for (int c = 0; c < kLnChunks; ++c) {
    if (lane + 32 * c < chunks) {
      float wf[8], bf[8], o[8];
      wv[c].unpack(wf);
      bv[c].unpack(bf);
#pragma unroll
      for (int k = 0; k < 8; ++k) o[k] = wf[k] * (rstd * (v[c][k] - mean)) + bf[k];
      *reinterpret_cast<uint4*>(yr + 8 * (lane + 32 * c)) = pack8(o);
    }
  }
}

template <typename W>
__global__ void __launch_bounds__(kLnWarps * 32)
layer_norm_kernel(const bf16* __restrict__ x, const W* __restrict__ w, const W* __restrict__ b,
                  bf16* __restrict__ y, int rows, int h, float eps) {
  const int row = blockIdx.x * kLnWarps + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= rows) return;
  const bf16* xr = x + static_cast<size_t>(row) * h;
  float sum = 0.f;
  for (int i = lane; i < h; i += 32) sum += vct::to_f32(xr[i]);
  const float mean = vct::warp_sum(sum) / h;
  float sq = 0.f;
  for (int i = lane; i < h; i += 32) {
    const float d = vct::to_f32(xr[i]) - mean;
    sq += d * d;
  }
  const float rstd = rsqrtf(vct::warp_sum(sq) / h + eps);
  bf16* yr = y + static_cast<size_t>(row) * h;
  for (int i = lane; i < h; i += 32)
    yr[i] = vct::from_f32<bf16>(vct::to_f32(w[i]) * (rstd * (vct::to_f32(xr[i]) - mean)) +
                                vct::to_f32(b[i]));
}

template <bool kTanh>
__device__ __forceinline__ float gelu_f32(float x) {
  if constexpr (kTanh) {
    constexpr float kBeta = M_SQRT2 * M_2_SQRTPI * 0.5;
    constexpr float kKappa = 0.044715;
    const float x_cube = x * x * x;
    const float inner = kBeta * (x + kKappa * x_cube);
    return 0.5f * x * (1.f + tanhf(inner));
  } else {
    constexpr float kAlpha = M_SQRT1_2;
    return x * 0.5f * (1.f + erff(x * kAlpha));
  }
}

// kUnroll: the 16-byte groups a thread takes, all loaded before the math
template <bool kTanh, int kUnroll>
__global__ void __launch_bounds__(kGeluThreads)
gelu_kernel(const bf16* __restrict__ x, bf16* __restrict__ y, long long n, long long groups) {
  const uint4* xg = reinterpret_cast<const uint4*>(x);
  uint4* yg = reinterpret_cast<uint4*>(y);
  const long long base = static_cast<long long>(blockIdx.x) * kGeluThreads * kUnroll +
                         threadIdx.x;
  uint4 u[kUnroll];
#pragma unroll
  for (int j = 0; j < kUnroll; ++j)
    if (base + j * kGeluThreads < groups) u[j] = xg[base + j * kGeluThreads];
#pragma unroll
  for (int j = 0; j < kUnroll; ++j) {
    if (base + j * kGeluThreads < groups) {
      float v[8];
      unpack8(u[j], v);
#pragma unroll
      for (int k = 0; k < 8; ++k) v[k] = gelu_f32<kTanh>(v[k]);
      yg[base + j * kGeluThreads] = pack8(v);
    }
  }
  const long long stride = static_cast<long long>(gridDim.x) * kGeluThreads;
  for (long long i = 8 * groups + static_cast<long long>(blockIdx.x) * kGeluThreads + threadIdx.x;
       i < n; i += stride)
    y[i] = vct::from_f32<bf16>(gelu_f32<kTanh>(vct::to_f32(x[i])));
}

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

template <typename W>
cudaError_t launch_layer_norm(const void* x, const void* w, const void* b, void* y, int rows,
                              int h, float eps, cudaStream_t stream) {
  const dim3 grid((rows + kLnWarps - 1) / kLnWarps);
  const bf16* xt = static_cast<const bf16*>(x);
  const W *wt = static_cast<const W*>(w), *bt = static_cast<const W*>(b);
  bf16* yt = static_cast<bf16*>(y);
  if (h % 8 == 0 && h <= 8 * 32 * kLnChunks && aligned16(x) && aligned16(w) && aligned16(b) &&
      aligned16(y))
    layer_norm_vec_kernel<W><<<grid, kLnWarps * 32, 0, stream>>>(xt, wt, bt, yt, rows, h, eps);
  else
    layer_norm_kernel<W><<<grid, kLnWarps * 32, 0, stream>>>(xt, wt, bt, yt, rows, h, eps);
  return cudaGetLastError();
}

template <bool kTanh, int kUnroll>
cudaError_t launch_gelu_unrolled(const bf16* x, bf16* y, long long n, long long groups,
                                 cudaStream_t stream) {
  const long long by_groups = (groups + kGeluThreads * kUnroll - 1) / (kGeluThreads * kUnroll);
  const long long by_rest = (n - 8 * groups + kGeluThreads - 1) / kGeluThreads;
  gelu_kernel<kTanh, kUnroll><<<static_cast<unsigned>(by_groups > by_rest ? by_groups : by_rest),
                                kGeluThreads, 0, stream>>>(x, y, n, groups);
  return cudaGetLastError();
}

// kGeluUnroll groups a thread where one group a thread would take more than
// one resident wave of blocks, one otherwise (more blocks, more SMs)
template <bool kTanh>
cudaError_t launch_gelu(const void* x, void* y, long long n, cudaStream_t stream) {
  int resident = 0;
  const cudaError_t err = vct::resident_blocks<gelu_kernel<kTanh, 1>>(kGeluThreads, 0, &resident);
  if (err != cudaSuccess) return err;
  const long long groups = aligned16(x) && aligned16(y) ? n / 8 : 0;
  const bf16* xt = static_cast<const bf16*>(x);
  bf16* yt = static_cast<bf16*>(y);
  if (groups > static_cast<long long>(resident) * kGeluThreads)
    return launch_gelu_unrolled<kTanh, kGeluUnroll>(xt, yt, n, groups, stream);
  return launch_gelu_unrolled<kTanh, 1>(xt, yt, n, groups, stream);
}

}  // namespace

// x, y [rows, h] bf16, w, b [h] of `w_dtype` (bf16 or f32), all contiguous.
extern "C" int vct_layer_norm(const void* x, const void* w, const void* b, void* y, int rows,
                              int h, float eps, int w_dtype, void* stream) {
  if (rows <= 0 || h <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (w_dtype == vct::kFloat32) return launch_layer_norm<float>(x, w, b, y, rows, h, eps, st);
  if (w_dtype == vct::kBFloat16) return launch_layer_norm<bf16>(x, w, b, y, rows, h, eps, st);
  return (int)cudaErrorInvalidValue;
}

// y = GELU(x) over n contiguous bf16 values; tanh approximation where
// `tanh_approx`, erf otherwise.
extern "C" int vct_gelu(const void* x, void* y, long long n, int tanh_approx, void* stream) {
  if (n <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return tanh_approx ? launch_gelu<true>(x, y, n, st) : launch_gelu<false>(x, y, n, st);
}
