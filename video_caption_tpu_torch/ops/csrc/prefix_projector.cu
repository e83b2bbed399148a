// Prefix mapper projection y = x @ W + b.
//
// Replaces: video_caption_tpu/ops/pallas/prefix_projector.py,
//   _prefix_project_pallas (Pallas body _proj_kernel).
// Computes: x [R, din] f32, W [din, dout] (f32 or bf16, converted to f32 in
//   registers, as the TPU wrapper casts W to x's dtype), b [dout] -> y [R, dout]
//   f32; products and sums in f32, the bias added in the epilogue. Any R, din
//   and dout are taken.
//
// What bounds it on the H100: bytes and launch latency. At the mapper's
//   256 -> 3072 and R <= 64 the product is below 0.1 GFLOP while W is 1.5 MB
//   in bf16 (0.48 us at 3.35 TB/s), so the kernel has to put all of W in
//   flight at once and read it once for every row. No tensor cores: the work
//   is too small to feed them, and the 1e-4 f32 tolerance rules out bf16
//   products (TF32 would need the 3-product split for the same accuracy).
// Design (the geometry comes from ops/prefix_projector.py::plan and is
//   checked here):
//   - One block of 256 threads per slab of kCols (32) output columns: 96
//     blocks at dout 3072. A thread loads 16 bytes of a W row at a time (8
//     bf16 or 4 f32 columns); the block's threads cover every K row of the
//     slab at once, issue all their loads before the first FMA (together with
//     the first rows of x), and keep the slab in shared memory as f32 (K in
//     chunks of at most 256 rows). W is read once, whatever R.
//   - Threads are (column group, K lane, row group). Rows of x pass through
//     shared memory in chunks of rows_per_thread x row groups (each thread's
//     loads of a chunk in flight together); a thread sums its K lane's rows
//     k = lane, lane + klanes, ... in order for rows q, q + rowgroups, ...
//     (rows_per_thread of them, a template constant: 1, 2, 4 or 8) of its
//     row group q. More rows take more row groups and fewer K lanes (plan).
//   - The K lanes' partial sums meet in shared memory in a fixed order: the
//     `sub` threads of an output (as many as the block has to spare, up to
//     8) each add klanes / sub neighbouring lanes in order, then a butterfly
//     of warp shuffles adds those sums pairwise. Over K chunks the sums
//     collect in y (each output owned by one thread), the bias (staged at
//     the start) added last. No atomics: two calls give the same bits.
//   - The columns of a slab past dout, and a W or x whose pointer (or row
//     length) breaks 16-byte alignment, take scalar loads in the same kernel.
#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kCols = 32;             // output columns per block
constexpr int kRows = 8;              // rows of x per thread per pass
constexpr int kMaxKc = 256;           // K rows of W staged at once
constexpr int kPad = 4;               // floats of padding per shared row (bank spread)
constexpr int kMaxSmem = 200 * 1024;  // bytes (plan keeps every launch below)
constexpr int kBatch = 8;             // x loads a thread has in flight while staging

template <typename W>
__host__ __device__ constexpr int group_cols() { return 16 / (int)sizeof(W); }   // columns of one 16-byte load

// dynamic shared memory in floats: bias, W chunk, x chunk, K lanes' partial sums
__host__ __device__ constexpr int smem_floats(int kc, int row_chunk, int klanes) {
  return kCols + kc * (kCols + kPad) + row_chunk * kc + klanes * (row_chunk * kCols + kPad);
}

__device__ __forceinline__ void store_group(float* dst, const uint4& v, float) {
  *reinterpret_cast<float4*>(dst) = make_float4(__uint_as_float(v.x), __uint_as_float(v.y),
                                                __uint_as_float(v.z), __uint_as_float(v.w));
}
__device__ __forceinline__ void store_group(float* dst, const uint4& v, __nv_bfloat16) {
  const unsigned w[4] = {v.x, v.y, v.z, v.w};   // the low half of each word is the first bf16
  float f[8];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    f[2 * i] = __uint_as_float(w[i] << 16);
    f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
  reinterpret_cast<float4*>(dst)[0] = make_float4(f[0], f[1], f[2], f[3]);
  reinterpret_cast<float4*>(dst)[1] = make_float4(f[4], f[5], f[6], f[7]);
}

template <typename W, int kRows>
__global__ void __launch_bounds__(kThreads)
prefix_projector_kernel(const float* __restrict__ x, const W* __restrict__ w,
                        const W* __restrict__ b, float* __restrict__ y, int rows, int din,
                        int dout, int rowgroups, int kc, int x_vec, int w_vec) {
  constexpr int V = group_cols<W>(), kGroups = kCols / V;
  constexpr int kPieces = kMaxKc * kGroups / kThreads;   // 16-byte W loads per thread
  extern __shared__ __align__(16) float smem[];
  const int klanes = kThreads / (kGroups * rowgroups), row_chunk = rowgroups * kRows;
  const int part_stride = row_chunk * kCols + kPad;
  float* bs = smem;                                  // [kCols] the slab's bias
  float* ws = bs + kCols;                            // [kc][kCols + kPad]
  float* xs = ws + kc * (kCols + kPad);              // [row_chunk][kc]
  float* part = xs + row_chunk * kc;                 // [klanes][part_stride]
  const int t = threadIdx.x;
  const int g = t % kGroups, kl = (t / kGroups) % klanes, rg = t / (kGroups * klanes);
  const int col0 = blockIdx.x * kCols;
  const bool w_full = w_vec && col0 + kCols <= dout;   // 16-byte loads of the whole slab
  const float bias = t < kCols && col0 + t < dout ? vct::to_f32(b[col0 + t]) : 0.f;
  // x staging: float4 (or float) pieces of a row; thread t takes piece t % per_row
  // of rows t / per_row, + step, ... (no division inside the loops)
  const bool x4 = x_vec && kc % 4 == 0;
  const int per_row_max = x4 ? kc / 4 : kc;
  const int xr = t / per_row_max, xc = t % per_row_max, step = kThreads / per_row_max;
  // `sub` threads add the K lanes of one output (a power of two, up to 8)
  int sub_log2 = 0;
  while (sub_log2 < 3 && (2 << sub_log2) <= klanes && (2 << sub_log2) * row_chunk * kCols <= kThreads)
    ++sub_log2;

  for (int k0 = 0; k0 < din; k0 += kc) {
    const int kn = min(kc, din - k0);
    uint4 wv[kPieces];
    if (w_full) {                                    // issue every W load of the chunk
#pragma unroll
      for (int j = 0; j < kPieces; ++j) {
        const int p = t + j * kThreads;
        if (p < kn * kGroups)
          wv[j] = __ldg(reinterpret_cast<const uint4*>(
              w + (size_t)(k0 + p / kGroups) * dout + col0 + (p % kGroups) * V));
      }
    }
    for (int r0 = 0; r0 < rows; r0 += row_chunk) {
      const int rn = min(row_chunk, rows - r0);
      // x rows [r0, r0 + rn), K [k0, k0 + kn) -> xs, kBatch loads in flight
      const int per_row = x4 ? kn / 4 : kn;
      if (xc < per_row && xr < step) {
        for (int r = xr; r < rn; r += kBatch * step) {
          if (x4) {
            float4 v[kBatch];
#pragma unroll
            for (int j = 0; j < kBatch; ++j)
              if (r + j * step < rn)
                v[j] = __ldg(reinterpret_cast<const float4*>(
                    x + (size_t)(r0 + r + j * step) * din + k0 + xc * 4));
#pragma unroll
            for (int j = 0; j < kBatch; ++j)
              if (r + j * step < rn) *reinterpret_cast<float4*>(xs + (r + j * step) * kc + xc * 4) = v[j];
          } else {
            float v[kBatch];
#pragma unroll
            for (int j = 0; j < kBatch; ++j)
              if (r + j * step < rn) v[j] = x[(size_t)(r0 + r + j * step) * din + k0 + xc];
#pragma unroll
            for (int j = 0; j < kBatch; ++j)
              if (r + j * step < rn) xs[(r + j * step) * kc + xc] = v[j];
          }
        }
      }
      if (r0 == 0) {                                 // the W chunk -> ws, as f32
        if (k0 == 0 && t < kCols) bs[t] = bias;
        if (w_full) {
#pragma unroll
          for (int j = 0; j < kPieces; ++j) {
            const int p = t + j * kThreads;
            if (p < kn * kGroups)
              store_group(ws + (p / kGroups) * (kCols + kPad) + (p % kGroups) * V, wv[j], W());
          }
        } else {
          for (int p = t; p < kn * kCols; p += kThreads) {
            const int k = p / kCols, c = p % kCols;
            ws[k * (kCols + kPad) + c] =
                col0 + c < dout ? vct::to_f32(w[(size_t)(k0 + k) * dout + col0 + c]) : 0.f;
          }
        }
      }
      __syncthreads();

      // rows rg + i * rowgroups; those past rn read stale xs and are not stored
      float acc[kRows][V];
#pragma unroll
      for (int i = 0; i < kRows; ++i)
#pragma unroll
        for (int e = 0; e < V; ++e) acc[i][e] = 0.f;
      const float* xrow = xs + rg * kc;
      for (int k = kl; k < kn; k += klanes) {
        float wk[V];
#pragma unroll
        for (int e = 0; e < V; e += 4) {
          const float4 f = *reinterpret_cast<const float4*>(ws + k * (kCols + kPad) + g * V + e);
          wk[e] = f.x, wk[e + 1] = f.y, wk[e + 2] = f.z, wk[e + 3] = f.w;
        }
#pragma unroll
        for (int i = 0; i < kRows; ++i) {
          const float xv = xrow[i * rowgroups * kc + k];
#pragma unroll
          for (int e = 0; e < V; ++e) acc[i][e] = fmaf(xv, wk[e], acc[i][e]);
        }
      }
#pragma unroll
      for (int i = 0; i < kRows; ++i) {
        const int r = rg + i * rowgroups;
        if (r < rn) {
#pragma unroll
          for (int e = 0; e < V; e += 4)
            *reinterpret_cast<float4*>(part + kl * part_stride + r * kCols + g * V + e) =
                make_float4(acc[i][e], acc[i][e + 1], acc[i][e + 2], acc[i][e + 3]);
        }
      }
      __syncthreads();
      // the K lanes: `sub` threads an output, each klanes / sub lanes in
      // order, then pairwise; over K chunks the sums collect in y, bias last
      const int sub = 1 << sub_log2, span = klanes >> sub_log2;
      for (int u = t; u < (rn * kCols) << sub_log2; u += kThreads) {
        const int o = u >> sub_log2, j = u & (sub - 1);
        float s = 0.f;
        for (int l = j * span; l < (j + 1) * span; ++l) s += part[l * part_stride + o];
        for (int m = 1; m < sub; m <<= 1) s += __shfl_xor_sync(0xffffffffu, s, m);
        const int col = col0 + o % kCols;
        if (j == 0 && col < dout) {
          float* out = y + (size_t)(r0 + o / kCols) * dout + col;
          if (k0 > 0) s = *out + s;
          if (k0 + kn == din) s += bs[o % kCols];
          *out = s;
        }
      }
      __syncthreads();                               // xs, part (and ws) are written again
    }
  }
}

template <typename W, int kRows>
int launch(const void* x, const void* w, const void* b, void* y, int rows, int din, int dout,
           int rowgroups, int kc, int x_vec, int w_vec, cudaStream_t stream) {
  constexpr int V = group_cols<W>(), kGroups = kCols / V;
  if (rowgroups != 1 && rowgroups != 2 && rowgroups != 4 && rowgroups != 8) return (int)cudaErrorInvalidValue;
  const int klanes = kThreads / (kGroups * rowgroups);
  const int smem = 4 * smem_floats(kc, rowgroups * kRows, klanes);
  if (kc < 1 || kc > kMaxKc || smem > kMaxSmem) return (int)cudaErrorInvalidValue;
  if ((x_vec && (reinterpret_cast<uintptr_t>(x) % 16 != 0 || din % 4 != 0)) ||
      (w_vec && (reinterpret_cast<uintptr_t>(w) % 16 != 0 || dout % V != 0)))
    return (int)cudaErrorInvalidValue;
  int resident = 0;   // sets the kernel's shared-memory limit, once per device
  cudaError_t err = vct::resident_blocks<prefix_projector_kernel<W, kRows>>(kThreads, kMaxSmem, &resident);
  if (err != cudaSuccess) return (int)err;
  const int blocks = (dout + kCols - 1) / kCols;
  prefix_projector_kernel<W, kRows><<<blocks, kThreads, smem, stream>>>(
      static_cast<const float*>(x), static_cast<const W*>(w), static_cast<const W*>(b),
      static_cast<float*>(y), rows, din, dout, rowgroups, kc, x_vec, w_vec);
  return (int)cudaGetLastError();
}

template <typename W>
int dispatch(const void* x, const void* w, const void* b, void* y, int rows, int din, int dout,
             int rowgroups, int rows_per_thread, int kc, int x_vec, int w_vec, cudaStream_t st) {
  switch (rows_per_thread) {
    case 1: return launch<W, 1>(x, w, b, y, rows, din, dout, rowgroups, kc, x_vec, w_vec, st);
    case 2: return launch<W, 2>(x, w, b, y, rows, din, dout, rowgroups, kc, x_vec, w_vec, st);
    case 4: return launch<W, 4>(x, w, b, y, rows, din, dout, rowgroups, kc, x_vec, w_vec, st);
    case 8: return launch<W, 8>(x, w, b, y, rows, din, dout, rowgroups, kc, x_vec, w_vec, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// y [rows, dout] = x [rows, din] @ w [din, dout] + b; rowgroups,
// rows_per_thread and kc are ops/prefix_projector.py::plan's; x_vec / w_vec
// = 1 take 16-byte loads of x / W, which need a 16-byte aligned pointer and a
// row length of whole 16-byte groups.
extern "C" int vct_prefix_project(const void* x, const void* w, const void* b, void* y,
                                  int rows, int din, int dout, int w_dtype, int rowgroups,
                                  int rows_per_thread, int kc, int x_vec, int w_vec, void* stream) {
  if (rows <= 0 || din <= 0 || dout <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (w_dtype == vct::kBFloat16)
    return dispatch<__nv_bfloat16>(x, w, b, y, rows, din, dout, rowgroups, rows_per_thread, kc,
                                   x_vec, w_vec, st);
  if (w_dtype == vct::kFloat32)
    return dispatch<float>(x, w, b, y, rows, din, dout, rowgroups, rows_per_thread, kc, x_vec,
                           w_vec, st);
  return (int)cudaErrorInvalidValue;
}
