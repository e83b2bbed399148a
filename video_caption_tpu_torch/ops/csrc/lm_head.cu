// LM head with the decode step's selection statistics.
//
// Replaces: video_caption_tpu/ops/pallas/lm_head.py, _run (Pallas body
//   _kernel).
// Computes: x [R, H] @ wte_t [H, Vp] (both in the compute dtype) ->
//   logits [R, Vp] f32 with the pad columns (>= vocab) at -inf,
//   wmax [R, Vp/128] the max of every 128-column window, and the row
//   statistics m [R] (row max) and l [R] (row sum of exp(logit - m)).
//
// What bounds it on the H100: wte_t is 77 MB in bf16 (768 x 50304) and the
//   product is 2*R*768*50304 operations, 77 MFLOP a row: up to R of a few
//   hundred every call is bound by reading the LM head once, ~23 us at 3.35
//   TB/s. That needs tens of KB in flight per SM, and wte_t must not be read
//   more than once (it does not fit the 50 MB L2).
// Design (bf16): one block of 8 warps per 128-column window (393 blocks at Vp = 50304),
//   the window being the unit of exact_topk's first stage. The block streams
//   the window's [H, 128] slab through a ring of shared-memory stages of 64
//   k-rows (16 KB of slab plus the same 64 columns of every row of x),
//   filled with 16-byte cp.async, `stages - 1` stages in flight. Every row of
//   x meets each stage while it is resident, so wte_t is read from device
//   memory once per call for R up to 256 (R above 256 runs as slices of 256
//   rows, one read per slice); x is staged again by every block, from L2.
//   The ring depth leaves room for 3 blocks per SM up to R = 64 (all 393
//   blocks in one wave, ~144 KB in flight per SM), 2 up to 128 and 1 (four
//   48 KB stages) up to 256. mma.sync m16n8k16 (bf16 -> f32) with x as A
//   through ldmatrix and the slab as B through ldmatrix.trans, both stored
//   with 16-byte chunks swizzled by row (chunk ^ row % 8) so a matrix's eight
//   rows hit distinct banks. The warps split the rows and the window's
//   columns (template WM warps along the rows, MT m16 tiles a warp): 16
//   columns a warp against all rows at R <= 16 up to 64 rows x 64 columns at
//   R <= 256; rows past R are zero-filled, computed with no test (a test per
//   tile would put each load and its products behind a branch and serialise
//   them) and never stored. The
//   epilogue masks the pad columns, stores the f32 logits, and takes each
//   row's window max and the window's partial sum exp(logit - wmax) from the
//   accumulators (quad shuffles, then the column warps through shared
//   memory). The TPU kernel carries m/l across its sequential grid; blocks
//   here run in no order, so a second small kernel combines the windows of a
//   row with the same rescale, l = sum_w lpart_w * exp(wmax_w - m).
// f32 inputs keep the SIMT path (one thread per column, 16 rows a block,
//   wte_t re-read per 16 rows): no f32 run on the card goes through lm_head
//   on a hot path (the trainers' logits are a plain matmul).
#include "common.cuh"
#include "mma.cuh"

namespace {

constexpr int kWindow = 128;  // columns per block = one selection window

// ---------------------------------------------------------------- bf16, tensor cores

constexpr int kWarps = 8;
constexpr int kChunk = 64;                     // k rows per ring stage
constexpr int kSlab = kChunk * kWindow;        // slab elements per stage
constexpr int kMaxRows = 256;                  // rows per launch (the largest WM * MT * 16)

// Warp layout: WM warps along the rows times 8 / WM along the window's
// columns; a warp holds MT m16 tiles (rows 16 * (i * WM + warp_m), i < MT)
// times NT = 16 / (8 / WM) n8 tiles. 16 * WM * MT rows per launch.
template <int WM, int MT>
constexpr int blocks_per_sm() { return WM * MT <= 4 ? 3 : (WM * MT <= 8 ? 2 : 1); }

template <int WM, int MT>
__global__ void __launch_bounds__(32 * kWarps, (WM * MT <= 4 ? 3 : (WM * MT <= 8 ? 2 : 1)))
lm_head_mma_kernel(const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ w,
                   float* __restrict__ logits, float* __restrict__ wmax,
                   float* __restrict__ lpart, int r, int h, int vp, int vocab, int stages) {
  constexpr int WN = kWarps / WM;                      // warps along the columns
  constexpr int NT = kWindow / 8 / WN;                 // n8 tiles a warp holds
  constexpr int kRows = 16 * WM * MT;
  constexpr int kStage = kSlab + kRows * kChunk;       // elements per stage
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* ring = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  const int win = blockIdx.x, nwin = gridDim.x;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int warp_m = warp / WN, warp_n = warp % WN;
  const int g = lane >> 2, t = lane & 3, mi = lane >> 3, rr = lane & 7;
  const int nk = (h + kChunk - 1) / kChunk;
  const __nv_bfloat16* wwin = w + (size_t)win * kWindow;

  // stage c: slab rows k0..k0+63 (16 chunks of 16 B a row) and x's columns
  // k0..k0+63 (8 chunks a row); chunk cc of row q stored at cc ^ (q % 8)
  auto load = [&](int c) {
    __nv_bfloat16* slab = ring + (c % stages) * kStage;
    __nv_bfloat16* xs = slab + kSlab;
    const int k0 = c * kChunk;
    for (int i = tid; i < kChunk * 16; i += 32 * kWarps) {
      const int kr = i >> 4, cc = i & 15;
      const bool valid = k0 + kr < h;
      vct::cp_async16(slab + kr * kWindow + ((cc ^ (kr & 7)) << 3),
                      valid ? wwin + (size_t)(k0 + kr) * vp + cc * 8 : wwin, valid);
    }
    for (int i = tid; i < kRows * 8; i += 32 * kWarps) {
      const int row = i >> 3, cc = i & 7;
      const bool valid = row < r && k0 + cc * 8 < h;
      vct::cp_async16(xs + row * kChunk + ((cc ^ (row & 7)) << 3),
                      valid ? x + (size_t)row * h + k0 + cc * 8 : x, valid);
    }
  };

  float acc[MT][NT][4];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j) acc[i][j][0] = acc[i][j][1] = acc[i][j][2] = acc[i][j][3] = 0.f;

  for (int c = 0; c < stages - 1; ++c) {
    if (c < nk) load(c);
    vct::cp_async_commit();
  }
  for (int c = 0; c < nk; ++c) {
    vct::cp_async_wait_dyn(stages - 2);   // stage c has landed
    __syncthreads();                      // ... for every thread; stage c - 1 is free
    if (c + stages - 1 < nk) load(c + stages - 1);
    vct::cp_async_commit();
    const __nv_bfloat16* slab = ring + (c % stages) * kStage;
    const __nv_bfloat16* xs = slab + kSlab;
#pragma unroll
    for (int kk = 0; kk < kChunk / 16; ++kk) {
      // B (transposed), two n8 tiles a load: k 0-7 / cols 0-7, k 8-15 / 0-7, k 0-7 / 8-15, k 8-15 / 8-15
      uint32_t b[NT / 2][4];
      const int kr = 16 * kk + (mi & 1) * 8 + rr;
#pragma unroll
      for (int jp = 0; jp < NT / 2; ++jp) {
        const int bc = warp_n * NT + 2 * jp + (mi >> 1);
        vct::ldmatrix_x4_trans(b[jp], slab + kr * kWindow + ((bc ^ (kr & 7)) << 3));
      }
#pragma unroll
      for (int i = 0; i < MT; ++i) {
        // A: rows 0-7 / k lo, rows 8-15 / k lo, rows 0-7 / k hi, rows 8-15 / k hi
        // (no test against R here: a branch per tile would serialise the loads
        // and products; rows past R are zero)
        uint32_t a[4];
        const int row = 16 * (i * WM + warp_m) + (mi & 1) * 8 + rr;
        const int ac = 2 * kk + (mi >> 1);
        vct::ldmatrix_x4(a, xs + row * kChunk + ((ac ^ (row & 7)) << 3));
#pragma unroll
        for (int jp = 0; jp < NT / 2; ++jp) {
          vct::mma_bf16(acc[i][2 * jp], a, b[jp][0], b[jp][1]);
          vct::mma_bf16(acc[i][2 * jp + 1], a, b[jp][2], b[jp][3]);
        }
      }
    }
  }
  vct::cp_async_wait<0>();
  __syncthreads();                        // the ring is free: reuse it for the reductions

  float* red = reinterpret_cast<float*>(smem_raw);   // [WN][kRows]
  float* wmx = red + WN * kRows;                     // [kRows]
  const int col = win * kWindow + warp_n * 8 * NT + 2 * t;   // + 8j (+1)
#pragma unroll
  for (int i = 0; i < MT; ++i) {
    const int ra = 16 * (i * WM + warp_m) + g, rb = ra + 8;
    float ma = -INFINITY, mb = -INFINITY;
#pragma unroll
    for (int j = 0; j < NT; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e)
        acc[i][j][e] = col + 8 * j + (e & 1) < vocab ? acc[i][j][e] : -INFINITY;
      if (ra < r)
        *reinterpret_cast<float2*>(logits + (size_t)ra * vp + col + 8 * j) =
            make_float2(acc[i][j][0], acc[i][j][1]);
      if (rb < r)
        *reinterpret_cast<float2*>(logits + (size_t)rb * vp + col + 8 * j) =
            make_float2(acc[i][j][2], acc[i][j][3]);
      ma = fmaxf(ma, fmaxf(acc[i][j][0], acc[i][j][1]));
      mb = fmaxf(mb, fmaxf(acc[i][j][2], acc[i][j][3]));
    }
#pragma unroll
    for (int o = 1; o < 4; o <<= 1) {
      ma = fmaxf(ma, __shfl_xor_sync(0xffffffffu, ma, o));
      mb = fmaxf(mb, __shfl_xor_sync(0xffffffffu, mb, o));
    }
    if (t == 0) {
      red[warp_n * kRows + ra] = ma;
      red[warp_n * kRows + rb] = mb;
    }
  }
  __syncthreads();
  for (int i = tid; i < kRows; i += 32 * kWarps) {
    float v = red[i];
#pragma unroll
    for (int k = 1; k < WN; ++k) v = fmaxf(v, red[k * kRows + i]);
    wmx[i] = v;
  }
  __syncthreads();
  // the window's partial sum-exp against its own max
#pragma unroll
  for (int i = 0; i < MT; ++i) {
    const int ra = 16 * (i * WM + warp_m) + g, rb = ra + 8;
    const float wa = wmx[ra], wb = wmx[rb];
    float sa = 0.f, sb = 0.f;
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      if (wa != -INFINITY) sa += expf(acc[i][j][0] - wa) + expf(acc[i][j][1] - wa);
      if (wb != -INFINITY) sb += expf(acc[i][j][2] - wb) + expf(acc[i][j][3] - wb);
    }
#pragma unroll
    for (int o = 1; o < 4; o <<= 1) {
      sa += __shfl_xor_sync(0xffffffffu, sa, o);
      sb += __shfl_xor_sync(0xffffffffu, sb, o);
    }
    if (t == 0) {
      red[warp_n * kRows + ra] = sa;
      red[warp_n * kRows + rb] = sb;
    }
  }
  __syncthreads();
  for (int i = tid; i < kRows && i < r; i += 32 * kWarps) {
    float s = red[i];
#pragma unroll
    for (int k = 1; k < WN; ++k) s += red[k * kRows + i];
    const size_t o = (size_t)i * nwin + win;
    wmax[o] = wmx[i];
    lpart[o] = s;
  }
}

template <int WM, int MT>
int launch_mma(const __nv_bfloat16* x, const __nv_bfloat16* w, float* logits, float* wmax,
               float* lpart, int r, int h, int vp, int vocab, cudaStream_t stream) {
  constexpr int stage_bytes = (kSlab + 16 * WM * MT * kChunk) * (int)sizeof(__nv_bfloat16);
  // as many stages as leave room for blocks_per_sm blocks (228 KB per SM,
  // 1 KB of it reserved per block), at least 2
  constexpr int fit = (233472 / blocks_per_sm<WM, MT>() - 1024) / stage_bytes;
  constexpr int max_stages = fit > 2 ? fit : 2;
  const int nk = (h + kChunk - 1) / kChunk;
  const int stages = max_stages < nk ? max_stages : (nk > 2 ? nk : 2);
  constexpr auto kernel = lm_head_mma_kernel<WM, MT>;
  int resident = 0;   // only the shared-memory limit, raised once, is wanted here
  const cudaError_t err = vct::resident_blocks<kernel>(32 * kWarps, max_stages * stage_bytes,
                                                       &resident);
  if (err != cudaSuccess) return (int)err;
  kernel<<<vp / kWindow, 32 * kWarps, stages * stage_bytes, stream>>>(x, w, logits, wmax, lpart,
                                                                      r, h, vp, vocab, stages);
  return (int)cudaGetLastError();
}

int launch_bf16(const __nv_bfloat16* x, const __nv_bfloat16* w, float* logits, float* wmax,
                float* lpart, int r, int h, int vp, int vocab, cudaStream_t stream) {
  if (r <= 16) return launch_mma<1, 1>(x, w, logits, wmax, lpart, r, h, vp, vocab, stream);
  if (r <= 32) return launch_mma<2, 1>(x, w, logits, wmax, lpart, r, h, vp, vocab, stream);
  if (r <= 64) return launch_mma<4, 1>(x, w, logits, wmax, lpart, r, h, vp, vocab, stream);
  if (r <= 128) return launch_mma<4, 2>(x, w, logits, wmax, lpart, r, h, vp, vocab, stream);
  return launch_mma<4, 4>(x, w, logits, wmax, lpart, r, h, vp, vocab, stream);
}

// ---------------------------------------------------------------- f32, CUDA cores

constexpr int kRowsF32 = 16;   // rows of x per block
constexpr int kChunkF32 = 128; // H elements staged per round

__global__ void __launch_bounds__(kWindow)
lm_head_window_f32_kernel(const float* __restrict__ x, const float* __restrict__ w,
                          float* __restrict__ logits, float* __restrict__ wmax,
                          float* __restrict__ lpart, int r, int h, int vp, int vocab) {
  __shared__ float xs[kRowsF32][kChunkF32];
  __shared__ float red[kWindow / 32][kRowsF32];
  __shared__ float win_max[kRowsF32];
  const int win = blockIdx.x, nwin = gridDim.x;
  const int col = win * kWindow + threadIdx.x;
  const int row0 = blockIdx.y * kRowsF32;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;

  float acc[kRowsF32];
#pragma unroll
  for (int i = 0; i < kRowsF32; ++i) acc[i] = 0.f;
  for (int h0 = 0; h0 < h; h0 += kChunkF32) {
    const int hc = min(kChunkF32, h - h0);
    __syncthreads();
    for (int i = threadIdx.x; i < kRowsF32 * kChunkF32; i += kWindow) {
      const int rr = i / kChunkF32, k = i % kChunkF32;
      xs[rr][k] = (row0 + rr < r && k < hc) ? x[(size_t)(row0 + rr) * h + h0 + k] : 0.f;
    }
    __syncthreads();
    const float* wp = w + (size_t)h0 * vp + col;
#pragma unroll 8
    for (int k = 0; k < hc; ++k) {
      const float wv = wp[(size_t)k * vp];
#pragma unroll
      for (int i = 0; i < kRowsF32; ++i) acc[i] = fmaf(xs[i][k], wv, acc[i]);
    }
  }

  // logits with the pad columns masked, then the window max per row
#pragma unroll
  for (int i = 0; i < kRowsF32; ++i) {
    acc[i] = col < vocab ? acc[i] : -INFINITY;
    if (row0 + i < r) logits[(size_t)(row0 + i) * vp + col] = acc[i];
    const float v = vct::warp_max(acc[i]);
    if (lane == 0) red[warp][i] = v;
  }
  __syncthreads();
  if (threadIdx.x < kRowsF32) {
    float v = red[0][threadIdx.x];
#pragma unroll
    for (int j = 1; j < kWindow / 32; ++j) v = fmaxf(v, red[j][threadIdx.x]);
    win_max[threadIdx.x] = v;
  }
  __syncthreads();
  // the window's partial sum-exp against its own max
#pragma unroll
  for (int i = 0; i < kRowsF32; ++i) {
    const float wm = win_max[i];
    const float e = wm == -INFINITY ? 0.f : expf(acc[i] - wm);
    const float s = vct::warp_sum(e);
    if (lane == 0) red[warp][i] = s;
  }
  __syncthreads();
  if (threadIdx.x < kRowsF32 && row0 + threadIdx.x < r) {
    float s = red[0][threadIdx.x];
#pragma unroll
    for (int j = 1; j < kWindow / 32; ++j) s += red[j][threadIdx.x];
    const size_t o = (size_t)(row0 + threadIdx.x) * nwin + win;
    wmax[o] = win_max[threadIdx.x];
    lpart[o] = s;
  }
}

// ---------------------------------------------------------------- row statistics

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

}  // namespace

extern "C" int vct_lm_head_stats(const void* x, const void* w, void* logits, void* wmax,
                                 void* lpart, void* m, void* l, int r, int h, int vp,
                                 int vocab, int dtype, void* stream) {
  if (r <= 0 || h <= 0 || vp <= 0 || vp % kWindow || vocab <= 0 || vocab > vp)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int nwin = vp / kWindow;
  auto* lg = static_cast<float*>(logits);
  auto* wm = static_cast<float*>(wmax);
  auto* lp = static_cast<float*>(lpart);
  cudaError_t err = cudaSuccess;
  if (dtype == vct::kBFloat16) {
    if (h % 8) return (int)cudaErrorInvalidValue;      // rows of x in 16-byte chunks
    auto* xb = static_cast<const __nv_bfloat16*>(x);
    for (int r0 = 0; r0 < r; r0 += kMaxRows) {          // one read of wte_t per 256 rows
      const int rows = r - r0 < kMaxRows ? r - r0 : kMaxRows;
      const int rc = launch_bf16(xb + (size_t)r0 * h, static_cast<const __nv_bfloat16*>(w),
                                 lg + (size_t)r0 * vp, wm + (size_t)r0 * nwin,
                                 lp + (size_t)r0 * nwin, rows, h, vp, vocab, st);
      if (rc != 0) return rc;
    }
  } else if (dtype == vct::kFloat32) {
    const dim3 grid(nwin, (r + kRowsF32 - 1) / kRowsF32);
    lm_head_window_f32_kernel<<<grid, kWindow, 0, st>>>(
        static_cast<const float*>(x), static_cast<const float*>(w), lg, wm, lp, r, h, vp, vocab);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  } else {
    return (int)cudaErrorInvalidValue;
  }
  lm_head_row_stats_kernel<<<r, 256, 0, st>>>(wm, lp, static_cast<float*>(m),
                                              static_cast<float*>(l), nwin);
  return (int)cudaGetLastError();
}
