// LM head with the decode step's selection statistics.
//
// Replaces: video_caption_tpu/ops/pallas/lm_head.py, _run (Pallas body
//   _kernel).
// Computes: x [R, H] @ wte_t [H, Vp] (both in the compute dtype) ->
//   logits [R, Vp] f32 with the pad columns (>= vocab) at -inf,
//   wmax [R, Vp/128] the max of every 128-column window, and the row
//   statistics m [R] (row max) and l [R] (row sum of exp(logit - m)).
//
// What bounds it on the H100: at single-request row counts (R = 1 to 12) the
//   product is ~1 GFLOP while wte_t is 77 MB in bf16 (768 x 50304), so every
//   call is bound by reading the LM head once: ~23 us at 3.35 TB/s.
// Design: one block per 128-column window (and per tile of 16 rows), one
//   thread per column. Each thread streams its column of wte_t once per row
//   tile, with the tile's rows of x staged in shared memory and broadcast,
//   and keeps 16 f32 accumulators in registers. The block's column tile IS
//   one selection window, so the window max is a block reduction with no
//   cross-block step. The TPU kernel carries m/l across its sequential grid;
//   blocks here run in no order, so each block also writes the window's
//   partial sum exp(logit - wmax) to scratch, and a second small kernel
//   combines the windows of a row with the same rescale,
//   l = sum_w lpart_w * exp(wmax_w - m). Row counts above 16 take more row
//   tiles and re-read wte_t once per tile (from L2 where it fits).
#include "common.cuh"

namespace {

constexpr int kWindow = 128;  // columns (threads) per block = one selection window
constexpr int kRows = 16;     // rows of x per block
constexpr int kChunk = 128;   // H elements staged per round

template <typename T>
__global__ void __launch_bounds__(kWindow)
lm_head_window_kernel(const T* __restrict__ x, const T* __restrict__ w,
                      float* __restrict__ logits, float* __restrict__ wmax,
                      float* __restrict__ lpart, int r, int h, int vp, int vocab) {
  __shared__ float xs[kRows][kChunk];
  __shared__ float red[kWindow / 32][kRows];
  __shared__ float win_max[kRows];
  const int win = blockIdx.x, nwin = gridDim.x;
  const int col = win * kWindow + threadIdx.x;
  const int row0 = blockIdx.y * kRows;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;

  float acc[kRows];
#pragma unroll
  for (int i = 0; i < kRows; ++i) acc[i] = 0.f;
  for (int h0 = 0; h0 < h; h0 += kChunk) {
    const int hc = min(kChunk, h - h0);
    __syncthreads();
    for (int i = threadIdx.x; i < kRows * kChunk; i += kWindow) {
      const int rr = i / kChunk, k = i % kChunk;
      xs[rr][k] = (row0 + rr < r && k < hc) ? vct::to_f32(x[(size_t)(row0 + rr) * h + h0 + k]) : 0.f;
    }
    __syncthreads();
    const T* wp = w + (size_t)h0 * vp + col;
#pragma unroll 8
    for (int k = 0; k < hc; ++k) {
      const float wv = vct::to_f32(wp[(size_t)k * vp]);
#pragma unroll
      for (int i = 0; i < kRows; ++i) acc[i] = fmaf(xs[i][k], wv, acc[i]);
    }
  }

  // logits with the pad columns masked, then the window max per row
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    acc[i] = col < vocab ? acc[i] : -INFINITY;
    if (row0 + i < r) logits[(size_t)(row0 + i) * vp + col] = acc[i];
    const float v = vct::warp_max(acc[i]);
    if (lane == 0) red[warp][i] = v;
  }
  __syncthreads();
  if (threadIdx.x < kRows) {
    float v = red[0][threadIdx.x];
#pragma unroll
    for (int j = 1; j < kWindow / 32; ++j) v = fmaxf(v, red[j][threadIdx.x]);
    win_max[threadIdx.x] = v;
  }
  __syncthreads();
  // the window's partial sum-exp against its own max
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const float wm = win_max[i];
    const float e = wm == -INFINITY ? 0.f : expf(acc[i] - wm);
    const float s = vct::warp_sum(e);
    if (lane == 0) red[warp][i] = s;
  }
  __syncthreads();
  if (threadIdx.x < kRows && row0 + threadIdx.x < r) {
    float s = red[0][threadIdx.x];
#pragma unroll
    for (int j = 1; j < kWindow / 32; ++j) s += red[j][threadIdx.x];
    const size_t o = (size_t)(row0 + threadIdx.x) * nwin + win;
    wmax[o] = win_max[threadIdx.x];
    lpart[o] = s;
  }
}

// Second pass: combine a row's windows into m and l (one block per row).
__global__ void __launch_bounds__(256)
lm_head_row_stats_kernel(const float* __restrict__ wmax, const float* __restrict__ lpart,
                         float* __restrict__ m, float* __restrict__ l, int nwin) {
  __shared__ float scratch[32];
  const size_t base = (size_t)blockIdx.x * nwin;
  float mx = -INFINITY;
  for (int i = threadIdx.x; i < nwin; i += blockDim.x) mx = fmaxf(mx, wmax[base + i]);
  mx = vct::block_max(mx, scratch);
  float s = 0.f;
  for (int i = threadIdx.x; i < nwin; i += blockDim.x) {
    const float wm = wmax[base + i];
    if (wm != -INFINITY) s += lpart[base + i] * expf(wm - mx);
  }
  s = vct::block_sum(s, scratch);
  if (threadIdx.x == 0) {
    m[blockIdx.x] = mx;
    l[blockIdx.x] = s;
  }
}

template <typename T>
int launch(const void* x, const void* w, void* logits, void* wmax, void* lpart, void* m,
           void* l, int r, int h, int vp, int vocab, cudaStream_t stream) {
  const int nwin = vp / kWindow;
  const dim3 grid(nwin, (r + kRows - 1) / kRows);
  lm_head_window_kernel<T><<<grid, kWindow, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w), static_cast<float*>(logits),
      static_cast<float*>(wmax), static_cast<float*>(lpart), r, h, vp, vocab);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  lm_head_row_stats_kernel<<<r, 256, 0, stream>>>(
      static_cast<const float*>(wmax), static_cast<const float*>(lpart),
      static_cast<float*>(m), static_cast<float*>(l), nwin);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int vct_lm_head_stats(const void* x, const void* w, void* logits, void* wmax,
                                 void* lpart, void* m, void* l, int r, int h, int vp,
                                 int vocab, int dtype, void* stream) {
  if (r <= 0 || h <= 0 || vp <= 0 || vp % kWindow || vocab <= 0 || vocab > vp)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == vct::kBFloat16)
    return launch<__nv_bfloat16>(x, w, logits, wmax, lpart, m, l, r, h, vp, vocab, st);
  if (dtype == vct::kFloat32)
    return launch<float>(x, w, logits, wmax, lpart, m, l, r, h, vp, vocab, st);
  return (int)cudaErrorInvalidValue;
}
