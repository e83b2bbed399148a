// Fused spatial pool + temporal mean of the ViT token stream.
//
// Replaces: video_caption_tpu/ops/pallas/fused_pool.py, _fused_pool (Pallas
//   body _pool_kernel).
// Computes: tokens [B*T, S, H] (f32 or bf16) -> y [B, H] in the tokens'
//   dtype, with f32 accumulation:
//     gap: y[b, h] = mean over t < T, 1 <= s < S of x[b*T + t, s, h]
//     cls: y[b, h] = mean over t < T of x[b*T + t, 0, h]
//   Summation order: the TPU kernel's, one f32 sum over all T*(S-1) (or T)
//   rows of a video divided once by their count (its jnp.mean over axes
//   (0, 1)). The plain version (ops/fused_pool.py::fused_pool_ref, the JAX
//   package's _xla_pool) takes each frame's mean first and then the mean over
//   frames; the two differ only in rounding.
//
// What bounds it on the H100: bytes. It reads every pooled token once and
//   does one add per element read; the output is 1/(T*(S-1)) of the input.
// Design: grid (B, ceil(H / 256)); a block owns one video and 256 columns,
//   as 256 x 4 threads. Thread (c, r) sums rows r, r + 4, ... of column c in
//   f32, so a warp reads 32 neighbouring columns of one row (coalesced along
//   H); the 4 partial sums of a column meet in shared memory and one thread
//   writes the result. Any H is taken: the TPU kernel's H % 128 gate is a
//   lane rule of the TPU and does not carry over.
#include "common.cuh"

namespace {

constexpr int kCols = 256;   // columns per block (threadIdx.x)
constexpr int kLanes = 4;    // row lanes per column (threadIdx.y)

template <typename T>
__global__ void __launch_bounds__(kCols * kLanes)
fused_pool_kernel(const T* __restrict__ x, T* __restrict__ y, int frames, int seq, int h,
                  int gap) {
  __shared__ float part[kLanes][kCols];
  const int col = blockIdx.y * kCols + threadIdx.x;
  const int first = gap ? 1 : 0;               // token 0 is the CLS token
  const int per_frame = gap ? seq - 1 : 1;     // pooled rows of each frame
  const int rows = frames * per_frame;
  float acc = 0.f;
  if (col < h) {
    const T* video = x + (size_t)blockIdx.x * frames * seq * h + col;
#pragma unroll 4
    for (int i = threadIdx.y; i < rows; i += kLanes) {
      const int t = i / per_frame, s = first + i % per_frame;
      acc += vct::to_f32(video[((size_t)t * seq + s) * h]);
    }
  }
  part[threadIdx.y][threadIdx.x] = acc;
  __syncthreads();
  if (threadIdx.y == 0 && col < h) {
    float sum = 0.f;
#pragma unroll
    for (int r = 0; r < kLanes; ++r) sum += part[r][threadIdx.x];
    y[(size_t)blockIdx.x * h + col] = vct::from_f32<T>(sum / (float)rows);
  }
}

template <typename T>
int launch(const void* x, void* y, int batch, int frames, int seq, int h, int gap,
           cudaStream_t stream) {
  const dim3 grid(batch, (h + kCols - 1) / kCols), block(kCols, kLanes);
  fused_pool_kernel<T><<<grid, block, 0, stream>>>(static_cast<const T*>(x), static_cast<T*>(y),
                                                   frames, seq, h, gap);
  return (int)cudaGetLastError();
}

}  // namespace

// tokens [batch * frames, seq, h] -> y [batch, h]; gap = 1 pools tokens
// 1..seq-1 of every frame, gap = 0 the CLS token.
extern "C" int vct_fused_pool(const void* x, void* y, int batch, int frames, int seq, int h,
                              int gap, int dtype, void* stream) {
  if (batch <= 0 || frames <= 0 || h <= 0 || seq < (gap ? 2 : 1)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == vct::kBFloat16) return launch<__nv_bfloat16>(x, y, batch, frames, seq, h, gap, st);
  if (dtype == vct::kFloat32) return launch<float>(x, y, batch, frames, seq, h, gap, st);
  return (int)cudaErrorInvalidValue;
}
