// Prefix mapper projection y = x @ W + b.
//
// Replaces: video_caption_tpu/ops/pallas/prefix_projector.py,
//   _prefix_project_pallas (Pallas body _proj_kernel).
// Computes: x [B, din] f32, W [din, dout] (f32 or bf16, converted to f32 in
//   registers, as the TPU wrapper casts W to x's dtype), b [dout] -> y [B, dout]
//   f32, with f32 accumulation and the bias added in the epilogue.
//
// What bounds it on the H100: at the mapper's 256 -> 3072 and B <= 64 the
//   product is ~0.1 GFLOP while W is 1.5 MB in bf16, so the kernel is bound
//   by reading W once (and by launch latency at single-request size).
// Design: one block per tile of 128 output columns and 8 rows; each thread
//   owns one column and streams its W column once per row tile (coalesced:
//   neighbouring threads read neighbouring columns), with the 8 rows of x
//   staged in shared memory and broadcast. The TPU kernel's 8-row padding and
//   128-lane gates are TPU tiling rules and do not carry over: any B, din and
//   dout are taken.
#include "common.cuh"

namespace {

constexpr int kCols = 128;   // output columns (threads) per block
constexpr int kRows = 8;     // rows of x per block
constexpr int kChunk = 256;  // din elements staged per round

template <typename W>
__global__ void __launch_bounds__(kCols)
prefix_projector_kernel(const float* __restrict__ x, const W* __restrict__ w,
                        const W* __restrict__ b, float* __restrict__ y,
                        int rows, int din, int dout) {
  __shared__ float xs[kRows][kChunk];
  const int col = blockIdx.x * kCols + threadIdx.x;
  const int row0 = blockIdx.y * kRows;
  float acc[kRows];
#pragma unroll
  for (int r = 0; r < kRows; ++r) acc[r] = 0.f;

  for (int k0 = 0; k0 < din; k0 += kChunk) {
    const int kc = min(kChunk, din - k0);
    __syncthreads();
    for (int i = threadIdx.x; i < kRows * kChunk; i += kCols) {
      const int r = i / kChunk, k = i % kChunk;
      xs[r][k] = (row0 + r < rows && k < kc) ? x[(size_t)(row0 + r) * din + k0 + k] : 0.f;
    }
    __syncthreads();
    if (col < dout) {
      const W* wp = w + (size_t)k0 * dout + col;
#pragma unroll 4
      for (int k = 0; k < kc; ++k) {
        const float wv = vct::to_f32(wp[(size_t)k * dout]);
#pragma unroll
        for (int r = 0; r < kRows; ++r) acc[r] = fmaf(xs[r][k], wv, acc[r]);
      }
    }
  }
  if (col >= dout) return;
  const float bias = vct::to_f32(b[col]);
#pragma unroll
  for (int r = 0; r < kRows; ++r)
    if (row0 + r < rows) y[(size_t)(row0 + r) * dout + col] = acc[r] + bias;
}

template <typename W>
int launch(const void* x, const void* w, const void* b, void* y, int rows, int din,
           int dout, cudaStream_t stream) {
  const dim3 grid((dout + kCols - 1) / kCols, (rows + kRows - 1) / kRows);
  prefix_projector_kernel<W><<<grid, kCols, 0, stream>>>(
      static_cast<const float*>(x), static_cast<const W*>(w), static_cast<const W*>(b),
      static_cast<float*>(y), rows, din, dout);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int vct_prefix_project(const void* x, const void* w, const void* b, void* y,
                                  int rows, int din, int dout, int w_dtype, void* stream) {
  if (rows <= 0 || din <= 0 || dout <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (w_dtype == vct::kBFloat16) return launch<__nv_bfloat16>(x, w, b, y, rows, din, dout, st);
  if (w_dtype == vct::kFloat32) return launch<float>(x, w, b, y, rows, din, dout, st);
  return (int)cudaErrorInvalidValue;
}
