// A whole K=1 GPT-2 decode step (every layer) in one cooperative launch.
//
// Replaces: video_caption_tpu/ops/pallas/decode_layer.py, gpt2_decode_step
//   (Pallas body _decode_step_kernel, one grid step per layer).
// Computes, for each layer l of n_layer, on the residual stream x [B, H]:
//   xn  = LN1(x) in f32, rounded to T
//   qkv = round(xn @ attn_w) + attn_b                 (product accumulated in f32)
//   kvf[l, offset, b, :] = qkv[b, H:3H]               (in-place cache-row write)
//   a   = per head: softmax over the rows r < max_len with
//         (r <= offset) & valid[b, r] > 0 of q . k_r * hd^-0.5 (f32), the
//         probabilities rounded to T, the product with V accumulated in f32
//   x1  = x + (round(a @ proj_w) + proj_b)            (residual add in T)
//   m   = gelu_tanh(round(LN2(x1) @ fc_w) + fc_b) computed in f32, rounded to T
//   x   = x1 + (round(m @ out_w) + out_b)
//   with the flat cache kvf [n_layer, max_len, B, 2H] (K in [..., :H], V in
//   [..., H:]), LN weights in f32 and every other weight in T, [in, out].
//   This is the TPU kernel's rounding order (decode_layer.py:104-145).
//
// What bounds it on the H100: at small B every layer reads its 14.2 MB of
//   bf16 weights once (170 MB for 12 layers: 51 us at 3.35 TB/s) and does
//   2 * B FLOPs per weight: bytes. What it waits on besides: the 59 grid
//   barriers of a step (~1.1 us each) and the chain of each phase after its
//   barrier (input rows, the slab copies, LayerNorm, the sums).
// Design (the geometry is ops/decode_layer.py::plan, checked here):
//   - One cooperative launch, one 256-thread block an SM, looping over the
//     layers with a grid barrier between the five phases of a layer, whose
//     data crosses blocks: 1. LN1 + QKV + cache-row write; 2. attention, one
//     block per (row, head); 3. proj + residual; 4. LN2 + fc + GELU; 5. out
//     + residual.
//   - Products: a unit is (tile of 32 output columns, split of the input
//     dim); a block takes units blockIdx.x, + grid, ... The plan splits K
//     where that shortens the busiest block's chain (at B=1 in bf16 only
//     out, 4 ways) and sizes the grid to the most units a phase has.
//   - The unit's slab (rows x 32 weights, the tile's biases, the split's
//     LayerNorm scale and shift) arrives by 16-byte cp.async in one of two
//     shared-memory buffers. A block issues its next unit's slab (the next
//     phase's, or the next layer's QKV) before it waits for the current
//     unit's inputs: the weights depend on no activation, so a slab is in
//     flight across the barriers and the attention phase.
//   - The unit's input rows (the whole row for the LayerNorm phases, which
//     recompute the row's statistics, else the split's slice), and the
//     residual's tile for proj and out, arrive by cp.async, up to RC rows a
//     pass; later passes reuse the slab. LayerNorm statistics in f32 by a
//     warp a row.
//   - In a unit, 16 bytes of columns a thread (4 threads across the tile in
//     bf16, 8 in f32), the rest of the threads split the rows; f32 sums,
//     reduced by shuffles in a warp, then over the warps in order. With one
//     split the unit runs the phase's epilogue; else it writes f32 partials
//     to scratch, and the block that arrives last at the tile (an atomic
//     ticket after __threadfence) adds the splits in split order and runs
//     the epilogue once, then resets the ticket for the next layer and step.
//     No extra barrier, and two launches give the same bits.
//   - Attention: q, the valid flags and every K and V row the step can see
//     (rows <= offset) of a (row, head) arrive as cp.async before one wait,
//     rows padded by 16 bytes; past the stage (48 KB of K and V) the K rows
//     go in chunks and the V rows in a second pass. Logits by 4 lanes a
//     row, the f32 softmax over the whole row, the probabilities rounded to
//     T, AV by 32 column groups of 8-dim threads adding p * v only where
//     p != 0 (a select: invisible and stale rows weigh exactly 0). A row
//     with no visible column gives the mean of its V rows over all max_len.
//   - Data written by other blocks of the launch (x, q, the attention
//     output, the hidden, the cache row, the partials) is read through L2
//     (cp.async.cg, ld.global.cg), never the non-coherent path.
//   - The launcher reads the device once: the shared-memory limit, the
//     cooperative-launch support and the resident blocks are kept per
//     device and instantiation.
//   - With a trace buffer, thread 0 of each block stamps %globaltimer at
//     every phase end and barrier exit (ops/decode_layer.py::trace_step).
#include <cooperative_groups.h>
#include <stdint.h>

#include <atomic>

#include "common.cuh"
#include "mma.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTile = 32;                          // output columns of a unit
constexpr int kHeadDim = 64;
constexpr int kMaxRows = 8;                        // input rows of a pass, at most
constexpr int kMaxSmem = 232448;                   // 227 KB, the most a block can take
constexpr int kAttStageBytes = 48 * 1024;          // K and V rows staged at once
constexpr int kRowLanes = 4;                       // attention: lanes of one row's dot
constexpr int kRowDims = kHeadDim / kRowLanes;
constexpr int kRowsPerPass = kThreads / kRowLanes;
constexpr int kDims = 8;                           // AV: output dims of a thread
constexpr int kDimGroups = kHeadDim / kDims;
constexpr int kColGroups = kThreads / kDimGroups;  // AV: column groups
constexpr int kPartFloats = kHeadDim + 4;
constexpr float kNeg = -1e30f;

enum Phase { kQKV, kProj, kFc, kOut, kPhases };

__host__ __device__ constexpr int align16(int x) { return (x + 15) & ~15; }
__host__ __device__ constexpr int stage_row_bytes(int es) { return kHeadDim * es + 16; }
__host__ __device__ inline int phase_k(int phase, int h) { return phase == kOut ? 4 * h : h; }
__host__ __device__ inline int phase_n(int phase, int h) {
  return phase == kQKV ? 3 * h : phase == kFc ? 4 * h : h;
}
// Rows of a split: ceil(K / splits) rounded up to 8 (16-byte slices of x).
__host__ __device__ inline int split_rows(int k, int splits) {
  return ((k + splits - 1) / splits + 7) / 8 * 8;
}
__host__ __device__ inline int rows_per_pass(int b) { return b <= 1 ? 1 : b <= 2 ? 2 : b <= 4 ? 4 : 8; }

// Byte offsets of the dynamic shared memory (ops/decode_layer.py::smem_bytes
// is the same formula): two slab buffers, then either the product's region
// (input rows, the warps' sums, LayerNorm statistics, the ticket flag, the
// residual's tile) or
// the attention's (K and V stages, q, valid flags, the row's logits, block
// scratch, the warps' AV sums).
struct Layout {
  int slab1, xt, red, stats, flag, res, ak, av, aq, avalid, alogit, ared, apart, total;
};

__host__ __device__ inline Layout layout(int es, int b, int rc, int slab, int xlen,
                                         int stage_rows, int max_len) {
  Layout l;
  l.slab1 = slab;
  const int region = 2 * slab;
  l.xt = region;
  l.red = l.xt + align16(rc * xlen * es);
  l.stats = l.red + 4 * kWarps * rc * kTile;
  l.flag = l.stats + align16(8 * rc);
  l.res = l.flag + 16;
  const int gemv_end = l.res + align16(b * kTile * es);
  l.ak = region;
  l.av = l.ak + stage_rows * stage_row_bytes(es);
  l.aq = l.av + stage_rows * stage_row_bytes(es);
  l.avalid = l.aq + kHeadDim * es;
  l.alogit = l.avalid + align16(4 * stage_rows);
  l.ared = l.alogit + align16(4 * max_len);
  l.apart = l.ared + 4 * 32;
  const int att_end = l.apart + 4 * kWarps * kPartFloats;
  l.total = gemv_end > att_end ? gemv_end : att_end;
  return l;
}

template <typename T>
struct Params {
  const T* x_in;     // [B, H] the step's input (embedding + position)
  T* x;              // [B, H] the residual stream; the step's output
  T* kvf;            // [n_layer, max_len, B, 2H]
  const int* valid;  // [B, max_len]
  const float* ln1_s;
  const float* ln1_b;
  const T* attn_w;   // [n_layer, H, 3H]
  const T* attn_b;
  const T* proj_w;   // [n_layer, H, H]
  const T* proj_b;
  const float* ln2_s;
  const float* ln2_b;
  const T* fc_w;     // [n_layer, H, 4H]
  const T* fc_b;
  const T* out_w;    // [n_layer, 4H, H]
  const T* out_b;
  T* q;              // [B, H] scratch
  T* attn;           // [B, H] scratch
  T* hid;            // [B, 4H] scratch
  float* part;       // f32 partial sums of the split phases
  int* tickets;      // [4H / 32] zero between phases
  long long* trace;  // nullptr, or [1 + 10 n_layer, grid] %globaltimer stamps (trace_step)
  int B, H, nh, n_layer, max_len, offset;
  int splits[kPhases];
  int slab, xlen, stage_rows;
  float eps;
};

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(vct::smem_addr(dst)), "l"(src));
}

// 8 values of T from 16-byte-aligned shared memory.
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
// 16 bytes of T from shared memory -> f32 (8 values bf16, 4 f32).
__device__ __forceinline__ void load16(const __nv_bfloat16* p, float* f) {
  float t[8];
  load8(p, t);
#pragma unroll
  for (int i = 0; i < 8; ++i) f[i] = t[i];
}
__device__ __forceinline__ void load16(const float* p, float* f) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  f[0] = a.x; f[1] = a.y; f[2] = a.z; f[3] = a.w;
}

__device__ __forceinline__ float gelu_tanh(float x) {
  return 0.5f * x * (1.f + tanhf(0.7978845608028654f * (x + 0.044715f * x * x * x)));
}

// The residual stream entering `layer`: the step's input for layer 0.
template <typename T>
__device__ __forceinline__ const T* layer_input(const Params<T>& p, int layer) {
  return layer == 0 ? p.x_in : p.x;
}

template <typename T>
struct PhaseArgs {
  const T* w;        // this layer's weights [K, N]
  const T* bias;     // [N]
  const T* src;      // input rows [B, K]
  const float* ln_s; // LayerNorm of the input (nullptr: none)
  const float* ln_b;
  int k, n, tiles, splits, rows;
};

template <typename T>
__device__ PhaseArgs<T> phase_args(const Params<T>& p, int layer, int phase) {
  PhaseArgs<T> a;
  const int h = p.H;
  a.k = phase_k(phase, h);
  a.n = phase_n(phase, h);
  a.tiles = a.n / kTile;
  a.splits = p.splits[phase];
  a.rows = split_rows(a.k, a.splits);
  a.ln_s = a.ln_b = nullptr;
  switch (phase) {
    case kQKV:
      a.w = p.attn_w; a.bias = p.attn_b; a.src = layer_input(p, layer);
      a.ln_s = p.ln1_s + (size_t)layer * h; a.ln_b = p.ln1_b + (size_t)layer * h;
      break;
    case kProj:
      a.w = p.proj_w; a.bias = p.proj_b; a.src = p.attn;
      break;
    case kFc:
      a.w = p.fc_w; a.bias = p.fc_b; a.src = p.x;
      a.ln_s = p.ln2_s + (size_t)layer * h; a.ln_b = p.ln2_b + (size_t)layer * h;
      break;
    default:
      a.w = p.out_w; a.bias = p.out_b; a.src = p.hid;
      break;
  }
  a.w += (size_t)layer * a.k * a.n;
  a.bias += (size_t)layer * a.n;
  return a;
}

// A block's place in its sequence of product units: (layer, phase, unit).
struct Item {
  int layer, phase, unit;
};

template <typename T>
__device__ __forceinline__ int phase_units(const Params<T>& p, int phase) {
  return phase_n(phase, p.H) / kTile * p.splits[phase];
}

// Move `it` to the block's first unit at or after it (units blockIdx.x, +
// grid, ... of each phase); false past the step's last.
template <typename T>
__device__ bool settle(const Params<T>& p, Item& it) {
  while (it.unit >= phase_units(p, it.phase)) {
    it.unit = blockIdx.x;
    if (++it.phase == kPhases) {
      it.phase = 0;
      if (++it.layer == p.n_layer) return false;
    }
  }
  return true;
}

// Bytes of a unit's slab: kn rows x 32 columns of T (64 or 128 bytes a
// row), the tile's 32 biases, and for a LayerNorm phase the f32 scale and
// shift over the split's kn columns.
__host__ __device__ inline int slab_bytes(int kn, int es, bool ln) {
  return (kn + 1) * kTile * es + (ln ? 8 * kn : 0);
}

// Issue the cp.async copies of a unit's slab (slab_bytes) into `slab`, as
// one group: the weights depend on no activation.
template <typename T>
__device__ void issue_slab(const Params<T>& p, const Item& it, T* slab) {
  const PhaseArgs<T> a = phase_args(p, it.layer, it.phase);
  constexpr int kVec = 16 / sizeof(T);
  constexpr int kCopies = kTile / kVec;   // 16-byte copies of a slab row
  const int tile = it.unit % a.tiles, split = it.unit / a.tiles;
  const int k0 = split * a.rows, kn = min(a.rows, a.k - k0);
  const T* w = a.w + (size_t)k0 * a.n + tile * kTile;
  const int t = threadIdx.x;
  for (int i = t; i < kn * kCopies; i += kThreads) {
    const int r = i / kCopies, c = (i % kCopies) * kVec;
    vct::cp_async16(slab + r * kTile + c, w + (size_t)r * a.n + c, true);
  }
  T* bias = slab + kn * kTile;
  if (t < kCopies)
    vct::cp_async16(bias + t * kVec, a.bias + tile * kTile + t * kVec, true);
  if (a.ln_s != nullptr) {
    float* ln = reinterpret_cast<float*>(bias + kTile);
    for (int c = 4 * t; c < kn; c += 4 * kThreads) {   // 4 floats a copy
      vct::cp_async16(ln + c, a.ln_s + k0 + c, true);
      vct::cp_async16(ln + kn + c, a.ln_b + k0 + c, true);
    }
  }
  vct::cp_async_commit();
}

// Issue the input rows b0 .. b0 + rc of a unit into xt (row stride xlen):
// the whole row for a LayerNorm phase, else columns [k0, k0 + kn); with
// `res`, also the tile of the residual stream [B, 32] the epilogue adds.
template <typename T>
__device__ void issue_rows(const PhaseArgs<T>& a, int b0, int rc, int k0, int kn, int xlen,
                           T* xt, const T* residual, int B, int H, int tile, T* res) {
  constexpr int kVec = 16 / sizeof(T);
  const int first = a.ln_s != nullptr ? 0 : k0;
  const int len = a.ln_s != nullptr ? a.k : kn;
  for (int r = 0; r < rc; ++r) {
    const T* src = a.src + (size_t)(b0 + r) * a.k + first;
    for (int c = threadIdx.x * kVec; c < len; c += kThreads * kVec)
      vct::cp_async16(xt + r * xlen + c, src + c, true);
  }
  if (residual != nullptr) {
    constexpr int kCopies = kTile / kVec;
    for (int i = threadIdx.x; i < B * kCopies; i += kThreads) {
      const int b = i / kCopies, c = (i % kCopies) * kVec;
      vct::cp_async16(res + b * kTile + c, residual + (size_t)b * H + tile * kTile + c, true);
    }
  }
  vct::cp_async_commit();
}

// The LayerNorm of the staged rows, rounded to T in place over the split's
// columns: row r's statistics in f32 over the whole row by warp r (mean,
// then the mean squared deviation, four sums in flight); ln holds the
// scale, then the shift, of the split's columns.
template <typename T>
__device__ void layer_norm_rows(int K, int rc, int k0, int kn, int xlen, T* xt, const float* ln,
                                float* stats, float eps) {
  const int r = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (r < rc) {
    const T* row = xt + r * xlen;
    float s0 = 0.f, s1 = 0.f, s2 = 0.f, s3 = 0.f;
    int k = lane;
    for (; k + 96 < K; k += 128) {
      s0 += vct::to_f32(row[k]);
      s1 += vct::to_f32(row[k + 32]);
      s2 += vct::to_f32(row[k + 64]);
      s3 += vct::to_f32(row[k + 96]);
    }
    for (; k < K; k += 32) s0 += vct::to_f32(row[k]);
    const float mean = vct::warp_sum((s0 + s1) + (s2 + s3)) / K;
    s0 = s1 = s2 = s3 = 0.f;
    for (k = lane; k + 96 < K; k += 128) {
      const float d0 = vct::to_f32(row[k]) - mean, d1 = vct::to_f32(row[k + 32]) - mean;
      const float d2 = vct::to_f32(row[k + 64]) - mean, d3 = vct::to_f32(row[k + 96]) - mean;
      s0 += d0 * d0;
      s1 += d1 * d1;
      s2 += d2 * d2;
      s3 += d3 * d3;
    }
    for (; k < K; k += 32) {
      const float d = vct::to_f32(row[k]) - mean;
      s0 += d * d;
    }
    const float var = vct::warp_sum((s0 + s1) + (s2 + s3)) / K;
    if (lane == 0) {
      stats[2 * r] = mean;
      stats[2 * r + 1] = rsqrtf(var + eps);
    }
  }
  __syncthreads();
  for (int c = threadIdx.x; c < kn; c += kThreads) {
    const float scale = ln[c], shift = ln[kn + c];
    for (int rr = 0; rr < rc; ++rr) {
      T* v = xt + rr * xlen + k0 + c;
      *v = vct::from_f32<T>((vct::to_f32(*v) - stats[2 * rr]) * stats[2 * rr + 1] * scale + shift);
    }
  }
}

// The phase's epilogue on the f32 sum of column j of row b: round, add the
// bias in T, then the phase's store; `res` is the residual's value there
// (proj and out).
template <typename T>
__device__ __forceinline__ void epilogue(const Params<T>& p, int layer, int phase, int b, int j,
                                         float acc, float bias, float res) {
  const int H = p.H;
  const float y = vct::round_to<T>(vct::round_to<T>(acc) + bias);
  switch (phase) {
    case kQKV:
      if (j < H) {
        p.q[(size_t)b * H + j] = vct::from_f32<T>(y);
      } else {
        const size_t row = ((size_t)layer * p.max_len + p.offset) * p.B + b;
        p.kvf[row * 2 * H + (j - H)] = vct::from_f32<T>(y);
      }
      break;
    case kFc:
      p.hid[(size_t)b * 4 * H + j] = vct::from_f32<T>(gelu_tanh(y));
      break;
    default:   // proj and out: the residual add
      p.x[(size_t)b * H + j] = vct::from_f32<T>(res + y);
      break;
  }
}

// One unit: out[b, tile] (+)= in[b, split] @ W[split, tile] for every row
// b, from the slab in shared memory. The slab of the block's next unit
// (`next`, if `more`) is issued after the first pass's input rows.
template <typename T, int RC>
__device__ void run_unit(const Params<T>& p, const Item& it, const T* slab, bool more,
                         const Item& next, T* next_slab, unsigned char* smem, const Layout& lay) {
  constexpr int kVec = 16 / sizeof(T);
  constexpr int kColThreads = kTile / kVec;
  constexpr int kGroups = kThreads / kColThreads;
  const PhaseArgs<T> a = phase_args(p, it.layer, it.phase);
  const int tile = it.unit % a.tiles, split = it.unit / a.tiles;
  const int k0 = split * a.rows, kn = min(a.rows, a.k - k0);
  const bool ln = a.ln_s != nullptr;
  const int xoff = ln ? k0 : 0;
  T* xt = reinterpret_cast<T*>(smem + lay.xt);
  float* red = reinterpret_cast<float*>(smem + lay.red);
  float* stats = reinterpret_cast<float*>(smem + lay.stats);
  int* flag = reinterpret_cast<int*>(smem + lay.flag);
  T* res = reinterpret_cast<T*>(smem + lay.res);
  const T* bias = slab + kn * kTile;
  const float* lnw = reinterpret_cast<const float*>(bias + kTile);
  const T* residual = it.phase == kProj ? layer_input(p, it.layer)
                      : it.phase == kOut ? p.x : nullptr;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int ct = tid % kColThreads, kg = tid / kColThreads;

  for (int b0 = 0; b0 < p.B; b0 += RC) {
    const int rc = min(RC, p.B - b0);
    if (b0 != 0) __syncthreads();   // the previous pass has read xt and red
    issue_rows(a, b0, rc, k0, kn, p.xlen, xt, b0 == 0 ? residual : nullptr, p.B, p.H, tile, res);
    if (b0 == 0 && more) {
      issue_slab(p, next, next_slab);
      vct::cp_async_wait<1>();      // this unit's slab and rows; the next slab may fly
    } else {
      vct::cp_async_wait<0>();
    }
    __syncthreads();
    if (ln) {
      layer_norm_rows<T>(a.k, rc, k0, kn, p.xlen, xt, lnw, stats, p.eps);
      __syncthreads();
    }
    float acc[RC][kVec];
#pragma unroll
    for (int r = 0; r < RC; ++r)
#pragma unroll
      for (int e = 0; e < kVec; ++e) acc[r][e] = 0.f;
    const T* wp = slab + ct * kVec;
    const T* xp = xt + xoff;
#pragma unroll 4
    for (int k = kg; k < kn; k += kGroups) {
      float w[kVec];
      load16(wp + k * kTile, w);
#pragma unroll
      for (int r = 0; r < RC; ++r) {
        const float xv = vct::to_f32(xp[r * p.xlen + k]);
#pragma unroll
        for (int e = 0; e < kVec; ++e) acc[r][e] = fmaf(xv, w[e], acc[r][e]);
      }
    }
    // sum over the groups of a warp (lanes with equal lane % kColThreads) ...
#pragma unroll
    for (int r = 0; r < RC; ++r)
#pragma unroll
      for (int e = 0; e < kVec; ++e) {
        float v = acc[r][e];
#pragma unroll
        for (int o = kColThreads; o < 32; o <<= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
        acc[r][e] = v;
      }
    if (lane < kColThreads) {
#pragma unroll
      for (int r = 0; r < RC; ++r)
#pragma unroll
        for (int e = 0; e < kVec; ++e) red[(warp * RC + r) * kTile + lane * kVec + e] = acc[r][e];
    }
    __syncthreads();
    // ... then over the warps in order: the epilogue, or this split's partial
    for (int i = tid; i < rc * kTile; i += kThreads) {
      const int r = i / kTile, c = i % kTile;
      float s = 0.f;
#pragma unroll
      for (int w2 = 0; w2 < kWarps; ++w2) s += red[(w2 * RC + r) * kTile + c];
      if (a.splits == 1)
        epilogue(p, it.layer, it.phase, b0 + r, tile * kTile + c, s, vct::to_f32(bias[c]),
                 vct::to_f32(res[(b0 + r) * kTile + c]));
      else
        p.part[((size_t)(tile * a.splits + split) * p.B + b0 + r) * kTile + c] = s;
    }
  }
  if (a.splits > 1) {
    // the ticket: the block that arrives last at the tile adds the splits in order
    __threadfence();
    __syncthreads();
    if (tid == 0) {
      const int t = atomicAdd(p.tickets + tile, 1);
      *flag = t == a.splits - 1;
      if (t == a.splits - 1) p.tickets[tile] = 0;   // read again only after a grid barrier
    }
    __syncthreads();
    if (*flag) {
      __threadfence();
      for (int i = tid; i < p.B * kTile; i += kThreads) {
        const int b = i / kTile, c = i % kTile;
        float s = 0.f;
        for (int sp = 0; sp < a.splits; ++sp)
          s += __ldcg(p.part + ((size_t)(tile * a.splits + sp) * p.B + b) * kTile + c);
        epilogue(p, it.layer, it.phase, b, tile * kTile + c, s, vct::to_f32(bias[c]),
                 vct::to_f32(res[b * kTile + c]));
      }
    }
  }
  __syncthreads();   // xt, red and the slab are free
}

// Every unit of `phase` this block owns, each slab issued one unit ahead.
template <typename T, int RC>
__device__ void run_phase(const Params<T>& p, int layer, int phase, Item& cur, bool& have,
                          int& buf, unsigned char* smem, const Layout& lay) {
  while (have && cur.layer == layer && cur.phase == phase) {
    Item next = cur;
    next.unit += gridDim.x;
    const bool more = settle(p, next);
    T* slab = reinterpret_cast<T*>(smem + (buf ? lay.slab1 : 0));
    T* other = reinterpret_cast<T*>(smem + (buf ? 0 : lay.slab1));
    run_unit<T, RC>(p, cur, slab, more, next, other, smem, lay);
    cur = next;
    have = more;
    buf ^= 1;
  }
}

// Attention of one (row, head) over the rows r <= offset of this layer.
template <typename T>
__device__ void attend(const Params<T>& p, int layer, int b, int head, unsigned char* smem,
                       const Layout& lay) {
  constexpr int kVec = 16 / sizeof(T);
  constexpr int kCopies = kHeadDim / kVec;
  constexpr int kPitch = stage_row_bytes(sizeof(T)) / sizeof(T);
  T* kb = reinterpret_cast<T*>(smem + lay.ak);
  T* vb = reinterpret_cast<T*>(smem + lay.av);
  T* qs = reinterpret_cast<T*>(smem + lay.aq);
  int* valid_s = reinterpret_cast<int*>(smem + lay.avalid);
  float* lg = reinterpret_cast<float*>(smem + lay.alogit);
  float* scratch = reinterpret_cast<float*>(smem + lay.ared);
  float* part = reinterpret_cast<float*>(smem + lay.apart);
  const int H = p.H, tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const size_t row_stride = (size_t)p.B * 2 * H;
  const T* k = p.kvf + (size_t)layer * p.max_len * row_stride + (size_t)b * 2 * H +
               (size_t)head * kHeadDim;
  const T* v = k + H;
  const int* valid = p.valid + (size_t)b * p.max_len;
  const int n = p.offset + 1;                 // the rows that can be visible
  const int sr = p.stage_rows;
  const bool single = n <= sr;                // K and V in one round trip
  const int quarter = tid % kRowLanes;
  const float scale = 1.0f / sqrtf((float)kHeadDim);

  // ---- logits of rows [0, n): one round trip a chunk (q, valid, K; V too if single)
  float qf[kRowDims];
  float mx = -INFINITY;
  for (int c0 = 0; c0 < n; c0 += sr) {
    const int nn = min(sr, n - c0);
    if (c0 != 0) __syncthreads();             // the previous chunk is read
    if (c0 == 0 && tid < kCopies)
      vct::cp_async16(qs + tid * kVec, p.q + (size_t)b * H + head * kHeadDim + tid * kVec, true);
    for (int i = tid; i < nn; i += kThreads) cp_async4(valid_s + i, valid + c0 + i);
    for (int i = tid; i < nn * kCopies; i += kThreads) {
      const int r = i / kCopies, c = (i % kCopies) * kVec;
      vct::cp_async16(kb + r * kPitch + c, k + (size_t)(c0 + r) * row_stride + c, true);
      if (single) vct::cp_async16(vb + r * kPitch + c, v + (size_t)(c0 + r) * row_stride + c, true);
    }
    vct::cp_async_commit();
    vct::cp_async_wait<0>();
    __syncthreads();
    if (c0 == 0) {
#pragma unroll
      for (int i = 0; i < kRowDims; i += 8) {
        float f[8];
        load8(qs + quarter * kRowDims + i, f);
#pragma unroll
        for (int e = 0; e < 8; ++e) qf[i + e] = f[e];
      }
    }
    for (int r0 = 0; r0 < nn; r0 += kRowsPerPass) {
      const int r = r0 + tid / kRowLanes;
      float s = 0.f;
      if (r < nn) {
        const T* kr = kb + r * kPitch + quarter * kRowDims;
#pragma unroll
        for (int i = 0; i < kRowDims; i += 8) {
          float f[8];
          load8(kr + i, f);
#pragma unroll
          for (int e = 0; e < 8; ++e) s = fmaf(qf[i + e], f[e], s);
        }
      }
      s += __shfl_xor_sync(0xffffffffu, s, 1);
      s += __shfl_xor_sync(0xffffffffu, s, 2);
      if (r < nn) {
        const float l = valid_s[r] > 0 ? s * scale : kNeg;   // select, whatever K holds
        if (quarter == 0) lg[c0 + r] = l;
        mx = fmaxf(mx, l);
      }
    }
  }
  mx = vct::block_max(mx, scratch);           // its barriers publish lg
  const bool blind = mx == kNeg;              // no visible row: every max_len row weighs 1/L
  const int rows = blind ? p.max_len : n;
  float se = 0.f;
  if (!blind)
    for (int j = tid; j < n; j += kThreads) se += expf(lg[j] - mx);
  se = blind ? (float)p.max_len : vct::block_sum(se, scratch);
  const float uniform = vct::round_to<T>(1.f / se);
  if (!blind)
    for (int j = tid; j < n; j += kThreads) lg[j] = vct::round_to<T>(expf(lg[j] - mx) / se);
  __syncthreads();

  // ---- AV: group g sums rows g, g + 32, ... in order, p * v only where p != 0
  const int dg = tid % kDimGroups, g = tid / kDimGroups;
  float acc[kDims] = {};
  if (single && !blind) {
    for (int r = g; r < n; r += kColGroups) {
      const float pr = lg[r];
      if (pr != 0.f) {
        float vv[kDims];
        load8(vb + r * kPitch + dg * kDims, vv);
#pragma unroll
        for (int e = 0; e < kDims; ++e) acc[e] = fmaf(pr, vv[e], acc[e]);
      }
    }
  } else {
    // V in chunks of the stage (the K stage is free now)
    T* vs = kb;
    for (int c0 = 0; c0 < rows; c0 += sr) {
      const int nn = min(sr, rows - c0);
      for (int i = tid; i < nn * kCopies; i += kThreads) {
        const int r = i / kCopies, c = (i % kCopies) * kVec;
        vct::cp_async16(vs + r * kPitch + c, v + (size_t)(c0 + r) * row_stride + c, true);
      }
      vct::cp_async_commit();
      vct::cp_async_wait<0>();
      __syncthreads();
      for (int r = g; r < nn; r += kColGroups) {
        const float pr = blind ? uniform : lg[c0 + r];
        if (pr != 0.f) {
          float vv[kDims];
          load8(vs + r * kPitch + dg * kDims, vv);
#pragma unroll
          for (int e = 0; e < kDims; ++e) acc[e] = fmaf(pr, vv[e], acc[e]);
        }
      }
      __syncthreads();                        // the chunk is read
    }
  }
  // the 4 groups of a warp pairwise, then the warps in order
#pragma unroll
  for (int e = 0; e < kDims; ++e) {
    acc[e] += __shfl_xor_sync(0xffffffffu, acc[e], 8);
    acc[e] += __shfl_xor_sync(0xffffffffu, acc[e], 16);
  }
  if (lane < kDimGroups) {
#pragma unroll
    for (int e = 0; e < kDims; ++e) part[warp * kPartFloats + dg * kDims + e] = acc[e];
  }
  __syncthreads();
  if (tid < kHeadDim) {
    float o = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) o += part[w * kPartFloats + tid];
    p.attn[(size_t)b * H + head * kHeadDim + tid] = vct::from_f32<T>(o);
  }
  __syncthreads();   // shared memory is reused by the next unit
}

// Thread 0's %globaltimer into trace[i][block]: stamp 0 at the start, then
// per layer and phase (QKV, attention, proj, fc, out) the end of the
// block's work and its exit from the grid barrier that follows.
__device__ __forceinline__ void stamp(long long* trace, int i) {
  if (trace != nullptr && threadIdx.x == 0) {
    long long t;
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
    trace[(size_t)i * gridDim.x + blockIdx.x] = t;
  }
}

template <typename T, int RC>
__global__ void __launch_bounds__(kThreads, 1) decode_layer_kernel(const Params<T> p) {
  extern __shared__ __align__(16) unsigned char smem[];
  cg::grid_group grid = cg::this_grid();
  const Layout lay = layout(sizeof(T), p.B, RC, p.slab, p.xlen, p.stage_rows, p.max_len);
  Item cur{0, 0, (int)blockIdx.x};
  bool have = settle(p, cur);
  int buf = 0;
  if (have) issue_slab(p, cur, reinterpret_cast<T*>(smem));
  stamp(p.trace, 0);
  for (int layer = 0; layer < p.n_layer; ++layer) {
    const int s0 = 1 + 10 * layer;
    run_phase<T, RC>(p, layer, kQKV, cur, have, buf, smem, lay);
    stamp(p.trace, s0);
    grid.sync();
    stamp(p.trace, s0 + 1);
    for (int u = blockIdx.x; u < p.B * p.nh; u += gridDim.x)
      attend<T>(p, layer, u / p.nh, u % p.nh, smem, lay);
    stamp(p.trace, s0 + 2);
    grid.sync();
    stamp(p.trace, s0 + 3);
    run_phase<T, RC>(p, layer, kProj, cur, have, buf, smem, lay);
    stamp(p.trace, s0 + 4);
    grid.sync();
    stamp(p.trace, s0 + 5);
    run_phase<T, RC>(p, layer, kFc, cur, have, buf, smem, lay);
    stamp(p.trace, s0 + 6);
    grid.sync();
    stamp(p.trace, s0 + 7);
    run_phase<T, RC>(p, layer, kOut, cur, have, buf, smem, lay);
    stamp(p.trace, s0 + 8);
    if (layer + 1 < p.n_layer) grid.sync();
    stamp(p.trace, s0 + 9);
  }
}

// Blocks of the kernel device `dev` (the current one) holds at once, 0 if it
// cannot launch cooperatively. Read on the first launch there, with the
// shared-memory limit set then too; later launches make no CUDA call here.
template <typename T, int RC>
cudaError_t cooperative_blocks(int dev, int* blocks) {
  constexpr int kMaxDevices = 64;
  static std::atomic<int> known[kMaxDevices];   // 0 until read; -1: no cooperative launch
  const int seen = dev >= 0 && dev < kMaxDevices ? known[dev].load(std::memory_order_relaxed) : 0;
  if (seen != 0) {
    *blocks = seen > 0 ? seen : 0;
    return cudaSuccess;
  }
  int coop = 0;
  cudaError_t err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (err != cudaSuccess) return err;
  *blocks = 0;
  if (coop && (err = vct::resident_blocks<decode_layer_kernel<T, RC>>(kThreads, kMaxSmem,
                                                                         blocks)))
    return err;
  if (dev >= 0 && dev < kMaxDevices)
    known[dev].store(*blocks > 0 ? *blocks : -1, std::memory_order_relaxed);
  return cudaSuccess;
}

template <typename T, int RC>
int launch_rows(const Params<T>& p, int grid, int smem, int dev, cudaStream_t stream) {
  int resident = 0;
  const cudaError_t err = cooperative_blocks<T, RC>(dev, &resident);
  if (err != cudaSuccess) return (int)err;
  if (resident == 0) return (int)cudaErrorNotSupported;
  if (grid > resident) return (int)cudaErrorCooperativeLaunchTooLarge;
  void* args[] = {const_cast<Params<T>*>(&p)};
  return (int)cudaLaunchCooperativeKernel((const void*)decode_layer_kernel<T, RC>, dim3(grid),
                                          dim3(kThreads), args, smem, stream);
}

template <typename T>
int run(Params<T>& p, int grid, int rc, int smem, int dev, cudaStream_t stream) {
  constexpr int es = sizeof(T);
  // the plan's geometry, checked: splits that leave no split empty and fit
  // the slab, rows of x that hold every slice, the stage, the layout
  if (rc != rows_per_pass(p.B) || grid < 1 || p.slab < 16 || p.slab % 16) {
    return (int)cudaErrorInvalidValue;
  }
  int xlen = p.H;
  for (int ph = 0; ph < kPhases; ++ph) {
    const int k = phase_k(ph, p.H), s = p.splits[ph];
    if (s < 1 || s > k / 8) return (int)cudaErrorInvalidValue;
    const int rows = split_rows(k, s);
    if ((s - 1) * rows >= k || slab_bytes(rows, es, ph == kQKV || ph == kFc) > p.slab)
      return (int)cudaErrorInvalidValue;
    xlen = rows > xlen ? rows : xlen;
  }
  p.xlen = xlen;
  const int limit = kAttStageBytes / (2 * stage_row_bytes(es));
  if (p.stage_rows < 1 || p.stage_rows > limit || p.stage_rows > p.max_len)
    return (int)cudaErrorInvalidValue;
  if (smem != layout(es, p.B, rc, p.slab, xlen, p.stage_rows, p.max_len).total ||
      smem > kMaxSmem)
    return (int)cudaErrorInvalidValue;
  if (rc == 1) return launch_rows<T, 1>(p, grid, smem, dev, stream);
  if (rc == 2) return launch_rows<T, 2>(p, grid, smem, dev, stream);
  if (rc == 4) return launch_rows<T, 4>(p, grid, smem, dev, stream);
  return launch_rows<T, kMaxRows>(p, grid, smem, dev, stream);
}

template <typename T>
int dispatch(const void* const* ptrs, int b, int h, int nh, int n_layer, int max_len, int offset,
             float eps, const int* splits, int slab, int stage_rows, int grid, int rc, int smem,
             int dev, cudaStream_t stream) {
  Params<T> p{static_cast<const T*>(ptrs[0]), (T*)ptrs[1], (T*)ptrs[2],
              static_cast<const int*>(ptrs[3]), static_cast<const float*>(ptrs[4]),
              static_cast<const float*>(ptrs[5]), static_cast<const T*>(ptrs[6]),
              static_cast<const T*>(ptrs[7]), static_cast<const T*>(ptrs[8]),
              static_cast<const T*>(ptrs[9]), static_cast<const float*>(ptrs[10]),
              static_cast<const float*>(ptrs[11]), static_cast<const T*>(ptrs[12]),
              static_cast<const T*>(ptrs[13]), static_cast<const T*>(ptrs[14]),
              static_cast<const T*>(ptrs[15]), (T*)ptrs[16], (T*)ptrs[17], (T*)ptrs[18],
              (float*)ptrs[19], (int*)ptrs[20], (long long*)ptrs[21], b, h, nh, n_layer,
              max_len, offset,
              {splits[0], splits[1], splits[2], splits[3]}, slab, 0, stage_rows, eps};
  // what arrives by 16-byte cp.async: x_in, x, kvf, the LayerNorm and product
  // weights, q, attn, hid
  for (int i : {0, 1, 2, 4, 5, 6, 8, 10, 11, 12, 14, 16, 17, 18})
    if (reinterpret_cast<uintptr_t>(ptrs[i]) % 16) return (int)cudaErrorInvalidValue;
  return run<T>(p, grid, rc, smem, dev, stream);
}

}  // namespace

// One decode step over every layer. part is f32 scratch of
// ops/decode_layer.py::Plan.part_floats, tickets int32 [4h / 32] of zeros
// (they are zero again when the launch ends), trace nullptr or int64
// [1 + 10 n_layer, grid] (stamp); splits_*, slab, stage_rows,
// grid, rows and smem are the plan's; device is the current device's index. x_in, x, kvf, the weights and the
// scratch rows on 16 bytes. Anything
// the kernel does not take returns cudaErrorInvalidValue.
extern "C" int vct_decode_layer(const void* x_in, void* x, void* kvf, const void* valid,
                                const void* ln1_s, const void* ln1_b, const void* attn_w,
                                const void* attn_b, const void* proj_w, const void* proj_b,
                                const void* ln2_s, const void* ln2_b, const void* fc_w,
                                const void* fc_b, const void* out_w, const void* out_b,
                                void* q, void* attn, void* hid, void* part, void* tickets,
                                void* trace, int b,
                                int h, int nh, int n_layer, int max_len, int offset, float eps,
                                int dtype, int splits_qkv, int splits_proj, int splits_fc,
                                int splits_out, int slab, int stage_rows, int grid, int rows,
                                int smem, int device, void* stream) {
  if (b <= 0 || nh <= 0 || h != nh * kHeadDim || n_layer <= 0 || max_len <= 0 || offset < 0 ||
      offset >= max_len)
    return (int)cudaErrorInvalidValue;
  const void* ptrs[22] = {x_in, x,     kvf,  valid, ln1_s, ln1_b, attn_w, attn_b,
                          proj_w, proj_b, ln2_s, ln2_b, fc_w, fc_b, out_w, out_b,
                          q,     attn,  hid,  part, tickets, trace};
  const int splits[kPhases] = {splits_qkv, splits_proj, splits_fc, splits_out};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == vct::kBFloat16)
    return dispatch<__nv_bfloat16>(ptrs, b, h, nh, n_layer, max_len, offset, eps, splits, slab,
                                   stage_rows, grid, rows, smem, device, st);
  if (dtype == vct::kFloat32)
    return dispatch<float>(ptrs, b, h, nh, n_layer, max_len, offset, eps, splits, slab,
                           stage_rows, grid, rows, smem, device, st);
  return (int)cudaErrorInvalidValue;
}
