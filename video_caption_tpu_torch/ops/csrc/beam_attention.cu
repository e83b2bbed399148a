// One layer of beam-search decode attention over the split KV cache, in both
// modes of the TPU kernel.
//
// Replaces: video_caption_tpu/ops/pallas/beam_attention.py, _run (Pallas
//   body _kernel), the non-deferred and the deferred (k_new / v_new) mode.
// Computes, for query row r = b * K + kq (video b, beam kq) and head h:
//   - the prefill part: the prefill K/V [B, S0, H] of video b, on the
//     columns whose left-pad flag valid[b, s] > 0;
//   - the generated part: for every step nn < steps, exactly the one cache
//     column written by row anc[r, nn] (gen cache [N, 2, R, H], K at index
//     0, V at index 1), where steps = t + 1, or t in deferred mode (column t
//     of the cache is stale there);
//   - deferred mode only: the step's own K/V (k_new, v_new [R, H]) as one
//     extra "self" column, last.
//   Logits (q . k) * hd^-0.5 in f32 (masked columns at -1e30), one f32
//   softmax per row over all its columns, probabilities rounded to the
//   compute dtype, AV accumulated in f32 (prefill, generated steps, then the
//   self column), output [R, H] in the compute dtype. The dense masked form
//   of the TPU kernel and of gpt2._beam_attend leaves exactly one unmasked
//   column per step (every other gets exp(-1e30 - m) = 0), so reading the
//   ancestor's column computes the same sum up to summation order; an
//   ancestor outside the row's video matches no column there and is masked
//   here too.
//
// What bounds it on the H100: per (video, head) it reads S0 + K * steps K/V
//   rows of 64 values (~22 KB in bf16 at S0 = 48, K = 3, t = 12) and does a
//   few thousand FMAs; bytes and FLOPs are negligible, so a call waits on
//   memory round trips and the launch.
// Design: one block of 256 threads per (video, head) serves the video's K
//   beam rows, so the prefill K/V is read once per video, not once per beam.
//   All loads are issued before the first wait, as cp.async into shared
//   memory: the q rows of the K beams, k_new / v_new, valid[b, :], the anc
//   rows, and every K and V row the block can need: the S0 prefill rows and,
//   for each step, the rows of all K writers of the video (which of them is
//   a beam's ancestor is looked up later in shared memory, so no address
//   waits on anc). That is one dependent round trip whatever S0 and t are.
//   Staged rows are padded by 16 bytes (no bank conflicts between
//   neighbouring rows). Then, from shared memory: a thread per (beam,
//   column) logit, a 64-value dot in eight interleaved sums; a warp per
//   beam row for the softmax; for AV, a thread owns 8 dims of one beam row
//   over one group of columns (l = g mod groups, groups = 256 / (8 K)), and
//   the groups' partial sums are added in order. Above the plan's staging limit
//   (STAGE_BYTES of K and V rows, ops/beam_attention.py::plan) the columns
//   go in chunks: K chunks for the logits, the exact softmax, then V chunks
//   for AV, one round trip per chunk. SIMT, not tensor cores: K <= 8 query
//   rows per head are far below an MMA tile, and the FMAs are not what the
//   call waits on.
#include "common.cuh"
#include "mma.cuh"

namespace {

constexpr int kHeadDim = 64;
constexpr int kThreads = 256;
constexpr int kDims = 8;             // dims of one beam row a thread accumulates in AV
constexpr int kMaxBeams = 8;
constexpr int kMaxPrefill = 1024;
constexpr int kStageBytes = 96 * 1024;   // K and V rows staged at once
constexpr int kMaxSmem = 232448;         // 227 KB, the most a block can take
constexpr int kPartialBytes = kThreads * kDims * 4;   // AV partial sums of the column groups
constexpr float kNeg = -1e30f;

__host__ __device__ constexpr int align16(int x) { return (x + 15) & ~15; }

// A staged K or V row: 64 values and 16 bytes of padding, so that the 16-byte
// loads of neighbouring rows fall in different banks.
__host__ __device__ constexpr int stage_row_bytes(int esize) { return kHeadDim * esize + 16; }

// Byte offsets of the regions of dynamic shared memory; `total` is what the
// plan (ops/beam_attention.py::plan, the same formula) passes as `smem`.
struct Layout {
  int k, v, q, kn, vn, logits, rows, valid, anc, partial, total;
};

__host__ __device__ inline Layout layout(int stage_rows, int beams, int s0, int steps,
                                         int deferred, int esize) {
  const int row = kHeadDim * esize;
  const int per_beam = align16(4 * beams * (s0 + steps + 1));
  Layout l;
  l.k = 0;
  l.v = l.k + stage_rows * stage_row_bytes(esize);
  l.q = l.v + stage_rows * stage_row_bytes(esize);
  l.kn = l.q + beams * row;
  l.vn = l.kn + (deferred ? beams * row : 0);
  l.logits = l.vn + (deferred ? beams * row : 0);
  l.rows = l.logits + per_beam;
  l.valid = l.rows + per_beam;
  l.anc = l.valid + align16(4 * s0);
  l.partial = l.anc + align16(4 * beams * steps);
  l.total = l.partial + kPartialBytes;
  return l;
}

// The end of the chunk of logical columns that starts at l0: prefill columns
// take one staged row each, a generated step K rows (all writers of the
// video), at most `cap` rows in all.
__device__ __forceinline__ int chunk_end(int l0, int s0, int lcols, int beams, int cap) {
  int l1 = l0;
  if (l1 < s0) {
    const int np = min(s0 - l1, cap);
    l1 += np;
    cap -= np;
  }
  if (l1 >= s0) l1 += min(lcols - l1, cap / beams);
  return l1;
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(vct::smem_addr(dst)), "l"(src));
}

// 8 values of T from shared memory (one 16-byte load in bf16, two in f32).
__device__ __forceinline__ void load8(const __nv_bfloat16* p, float (&f)[8]) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h2 = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 v = __bfloat1622float2(h2[i]);
    f[2 * i] = v.x;
    f[2 * i + 1] = v.y;
  }
}

__device__ __forceinline__ void load8(const float* p, float (&f)[8]) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  const float4 b = *reinterpret_cast<const float4*>(p + 4);
  f[0] = a.x; f[1] = a.y; f[2] = a.z; f[3] = a.w;
  f[4] = b.x; f[5] = b.y; f[6] = b.z; f[7] = b.w;
}

// a . b over one 64-value row: eight sums (value j goes to sum j mod 8, in
// order of the values), so no chain is longer than 8 FMAs, then added
// pairwise: ((s0 + s1) + (s2 + s3)) + ((s4 + s5) + (s6 + s7)).
template <typename T>
__device__ __forceinline__ float dot64(const T* a, const T* b) {
  float acc[8] = {};
#pragma unroll
  for (int c = 0; c < kHeadDim; c += 8) {
    float x[8], y[8];
    load8(a + c, x);
    load8(b + c, y);
#pragma unroll
    for (int e = 0; e < 8; ++e) acc[e] = fmaf(x[e], y[e], acc[e]);
  }
  return ((acc[0] + acc[1]) + (acc[2] + acc[3])) + ((acc[4] + acc[5]) + (acc[6] + acc[7]));
}

struct Args {
  const void* q;
  const void* gkv;
  const void* pk;
  const void* pv;
  const int* valid;
  const int* anc;
  const void* k_new;
  const void* v_new;
  void* out;
  int q_stride, new_stride, r, h, k_beams, s0, n, t, deferred, stage_rows;
};

template <typename T>
__global__ void __launch_bounds__(kThreads) beam_attention_kernel(const Args a) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int kVec = 16 / sizeof(T), kChunks = kHeadDim / kVec;
  constexpr int kRow = stage_row_bytes(sizeof(T)) / sizeof(T);   // staged row stride, in T
  const int b = blockIdx.x, head = blockIdx.y, tid = threadIdx.x;
  const int K = a.k_beams, s0 = a.s0, h = a.h, r = a.r;
  const int steps = a.deferred ? a.t : a.t + 1;
  const int lcols = s0 + steps;                 // logical columns of a beam row
  const int lw = lcols + 1;                     // a beam's logits: the self column last
  const int row0 = b * K;                       // the video's first query row
  const Layout lay = layout(a.stage_rows, K, s0, steps, a.deferred, sizeof(T));
  T* kbuf = reinterpret_cast<T*>(smem + lay.k);
  T* vbuf = reinterpret_cast<T*>(smem + lay.v);
  T* qs = reinterpret_cast<T*>(smem + lay.q);
  T* kns = reinterpret_cast<T*>(smem + lay.kn);
  T* vns = reinterpret_cast<T*>(smem + lay.vn);
  float* lg = reinterpret_cast<float*>(smem + lay.logits);
  int* rows_s = reinterpret_cast<int*>(smem + lay.rows);
  int* valid_s = reinterpret_cast<int*>(smem + lay.valid);
  int* anc_s = reinterpret_cast<int*>(smem + lay.anc);
  float* partial = reinterpret_cast<float*>(smem + lay.partial);
  const T* gkv = static_cast<const T*>(a.gkv) + head * kHeadDim;
  const T* pk = static_cast<const T*>(a.pk) + ((size_t)b * s0) * h + head * kHeadDim;
  const T* pv = static_cast<const T*>(a.pv) + ((size_t)b * s0) * h + head * kHeadDim;
  const bool single = s0 + K * steps <= a.stage_rows;

  // Issue the K (which = 0) or V (1) rows of logical columns [l0, l1).
  auto stage = [&](T* dst, int which, int l0, int l1) {
    const int np = max(0, min(s0, l1) - l0);
    const int g0 = max(l0, s0) - s0;
    const int total = (np + (l1 - l0 - np) * K) * kChunks;
    const T* pre = which ? pv : pk;
    for (int i = tid; i < total; i += kThreads) {
      const int row = i / kChunks, c = (i % kChunks) * kVec;
      const T* src;
      if (row < np) {
        src = pre + (size_t)(l0 + row) * h;
      } else {
        const int rr = row - np, nn = g0 + rr / K;
        src = gkv + ((size_t)(nn * 2 + which) * r + row0 + rr % K) * h;
      }
      vct::cp_async16(dst + row * kRow + c, src + c, true);
    }
  };

  // ---- one round trip: every load the block needs (the first chunk of K/V)
  for (int i = tid; i < K * kChunks; i += kThreads) {
    const int kq = i / kChunks, c = (i % kChunks) * kVec;
    const size_t src = (size_t)(row0 + kq) * a.q_stride + head * kHeadDim + c;
    vct::cp_async16(qs + kq * kHeadDim + c, static_cast<const T*>(a.q) + src, true);
    if (a.deferred) {
      const size_t nsrc = (size_t)(row0 + kq) * a.new_stride + head * kHeadDim + c;
      vct::cp_async16(kns + kq * kHeadDim + c, static_cast<const T*>(a.k_new) + nsrc, true);
      vct::cp_async16(vns + kq * kHeadDim + c, static_cast<const T*>(a.v_new) + nsrc, true);
    }
  }
  for (int i = tid; i < s0; i += kThreads) cp_async4(valid_s + i, a.valid + (size_t)b * s0 + i);
  for (int i = tid; i < K * steps; i += kThreads)
    cp_async4(anc_s + i, a.anc + (size_t)(row0 + i / steps) * a.n + i % steps);
  int l0 = 0, l1 = chunk_end(0, s0, lcols, K, a.stage_rows);
  stage(kbuf, 0, l0, l1);
  if (single) stage(vbuf, 1, l0, l1);
  vct::cp_async_commit();
  vct::cp_async_wait<0>();
  __syncthreads();

  // ---- logits: a thread per (beam, column) pair (the self pairs with the
  // first chunk); each pair's staged row is kept for AV
  const float scale = 1.0f / sqrtf((float)kHeadDim);
  for (bool first = true;; first = false) {
    const int cols = l1 - l0, pairs = K * cols;
    for (int p = tid; p < pairs + (first && a.deferred ? K : 0); p += kThreads) {
      if (p >= pairs) {
        const int kq = p - pairs;
        lg[kq * lw + lcols] = dot64(qs + kq * kHeadDim, kns + kq * kHeadDim) * scale;
        continue;
      }
      const int kq = p / cols, l = l0 + p % cols;
      bool vis;
      int row;
      if (l < s0) {
        vis = valid_s[l] > 0;
        row = l - l0;
      } else {
        const int nn = l - s0, kv = anc_s[kq * steps + nn] - row0;
        vis = kv >= 0 && kv < K;   // an ancestor outside the video: no column
        row = max(0, min(s0, l1) - l0) + (nn - (max(l0, s0) - s0)) * K + (vis ? kv : 0);
      }
      rows_s[kq * lw + l] = row;
      lg[kq * lw + l] = vis ? dot64(qs + kq * kHeadDim, kbuf + row * kRow) * scale : kNeg;
    }
    if (l1 >= lcols) break;
    __syncthreads();                              // kbuf is staged again
    l0 = l1;
    l1 = chunk_end(l0, s0, lcols, K, a.stage_rows);
    stage(kbuf, 0, l0, l1);
    vct::cp_async_commit();
    vct::cp_async_wait<0>();
    __syncthreads();
  }
  __syncthreads();

  // ---- softmax: a warp per beam row, probabilities rounded to T
  const int lane = tid & 31, ncols = lcols + (a.deferred ? 1 : 0);
  for (int kq = tid >> 5; kq < K; kq += kThreads / 32) {
    float* row = lg + kq * lw;
    float mx = -INFINITY;
    for (int c = lane; c < ncols; c += 32) mx = fmaxf(mx, row[c]);
    mx = vct::warp_max(mx);
    float se = 0.f;
    for (int c = lane; c < ncols; c += 32) {
      const float e = expf(row[c] - mx);
      row[c] = e;
      se += e;
    }
    se = vct::warp_sum(se);
    for (int c = lane; c < ncols; c += 32) row[c] = vct::round_to<T>(row[c] / se);
  }
  __syncthreads();

  // ---- AV: thread (group g, beam kq, dims 8dg..8dg+7) sums the columns
  // l = g (mod groups) in order; the groups' partial sums are then added in
  // group order and the self column last
  const int groups = kThreads / (kHeadDim / kDims * K);
  const int dg = tid % (kHeadDim / kDims), kq = tid / (kHeadDim / kDims) % K;
  const int g = tid / (kHeadDim / kDims * K);
  float acc[kDims] = {};
  for (l0 = 0; l0 < lcols; l0 = l1) {
    l1 = chunk_end(l0, s0, lcols, K, a.stage_rows);
    if (!single) {
      stage(vbuf, 1, l0, l1);
      vct::cp_async_commit();
      vct::cp_async_wait<0>();
      __syncthreads();
    }
    if (g < groups) {
#pragma unroll 2
      for (int l = l0 + (g - l0 % groups + groups) % groups; l < l1; l += groups) {
        const float p = lg[kq * lw + l];
        float v[kDims];
        load8(vbuf + rows_s[kq * lw + l] * kRow + dg * kDims, v);
#pragma unroll
        for (int e = 0; e < kDims; ++e) acc[e] = fmaf(p, v[e], acc[e]);
      }
    }
    if (!single) __syncthreads();                 // vbuf is staged again
  }
  if (g < groups) {
#pragma unroll
    for (int e = 0; e < kDims; ++e)
      partial[g * K * kHeadDim + kq * kHeadDim + dg * kDims + e] = acc[e];
  }
  __syncthreads();
  for (int o = tid; o < K * kHeadDim; o += kThreads) {
    float s = 0.f;
    for (int gg = 0; gg < groups; ++gg) s += partial[gg * K * kHeadDim + o];
    const int oq = o / kHeadDim, d = o % kHeadDim;
    if (a.deferred) s = fmaf(lg[oq * lw + lcols], vct::to_f32(vns[oq * kHeadDim + d]), s);
    static_cast<T*>(a.out)[(size_t)(row0 + oq) * h + head * kHeadDim + d] = vct::from_f32<T>(s);
  }
}

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

template <typename T>
int launch(const Args& a, int nh, int smem, cudaStream_t stream) {
  if (!aligned16(a.q) || !aligned16(a.gkv) || !aligned16(a.pk) || !aligned16(a.pv) ||
      (a.q_stride * sizeof(T)) % 16 ||
      (a.deferred && (!aligned16(a.k_new) || !aligned16(a.v_new) ||
                      (a.new_stride * sizeof(T)) % 16)))
    return (int)cudaErrorInvalidValue;
  const int steps = a.deferred ? a.t : a.t + 1;
  const int rows = a.s0 + a.k_beams * steps;
  const int limit = kStageBytes / (2 * stage_row_bytes(sizeof(T)));
  // the plan stages min(rows, limit) rows; fewer (cli/sweep_plans.py) are
  // taken as long as a chunk holds a whole step
  if (a.stage_rows > (rows < limit ? rows : limit) ||
      a.stage_rows < (rows < a.k_beams ? rows : a.k_beams) ||
      smem != layout(a.stage_rows, a.k_beams, a.s0, steps, a.deferred, sizeof(T)).total ||
      smem > kMaxSmem)
    return (int)cudaErrorInvalidValue;
  int resident = 0;   // sets the kernel's shared-memory limit, once per device
  cudaError_t err = vct::resident_blocks<beam_attention_kernel<T>>(kThreads, kMaxSmem, &resident);
  if (err != cudaSuccess) return (int)err;
  beam_attention_kernel<T><<<dim3(a.r / a.k_beams, nh), kThreads, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

// out [R, H] = one layer of beam attention; k_new / v_new (rows new_stride
// apart) only with deferred = 1. stage_rows and smem are
// ops/beam_attention.py::plan's; anything else the kernel does not take
// returns cudaErrorInvalidValue.
extern "C" int vct_beam_attention(const void* q, int q_stride, const void* gkv, const void* pk,
                                  const void* pv, const void* valid, const void* anc,
                                  const void* k_new, const void* v_new, int new_stride,
                                  void* out, int r, int h, int nh, int k_beams, int s0, int n,
                                  int t, int deferred, int stage_rows, int smem, int dtype,
                                  void* stream) {
  if (r <= 0 || nh <= 0 || h != nh * kHeadDim || k_beams <= 0 || k_beams > kMaxBeams ||
      r % k_beams || s0 < 0 || s0 > kMaxPrefill || n <= 0 || t < 0 || t >= n || q_stride < h ||
      (deferred != 0 && deferred != 1) ||
      (deferred && (k_new == nullptr || v_new == nullptr || new_stride < h)))
    return (int)cudaErrorInvalidValue;
  const Args a{q, gkv, pk, pv, static_cast<const int*>(valid), static_cast<const int*>(anc),
               k_new, v_new, out, q_stride, new_stride, r, h, k_beams, s0, n, t, deferred,
               stage_rows};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == vct::kBFloat16) return launch<__nv_bfloat16>(a, nh, smem, st);
  if (dtype == vct::kFloat32) return launch<float>(a, nh, smem, st);
  return (int)cudaErrorInvalidValue;
}
