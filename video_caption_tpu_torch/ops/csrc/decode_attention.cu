// Single-token decode attention over the contiguous KV cache.
//
// Replaces: video_caption_tpu/ops/pallas/decode_attention.py, _decode_attention
//   (Pallas body _attn_kernel).
// Computes, for batch row b and head h: softmax over the L cache columns of
//   q[b,h] . k[b,l,h] * hd^-0.5, masked to -1e30 where valid[b,l] == 0, then
//   the probability-weighted sum of v[b,l,h]. Logits, softmax and the product
//   with V in f32 (the probabilities are not rounded, as in the TPU kernel);
//   the output [B, nh, hd] in the compute dtype.
//   q and the caches arrive as strided views: q [B, nh, 64] with batch stride
//   q_stride (a slice of the fused QKV output), K and V [B, L, nh, 64] with
//   their own batch and row strides (the K and V halves of one layer of the
//   interleaved [B, max_len, 2, nh, hd] cache), so the caller copies nothing.
//
// What bounds it on the H100: not bytes. A (row, head) reads L K and V rows
//   of 128 B (bf16), 16 KB at L = 64, and does ~4 * 64 FLOPs per row; the
//   call's bound is tens of nanoseconds at B = 1. What a call waits on is
//   the launch and the chain of dependent memory round trips and block
//   barriers inside a block; at B = 1 only 12 blocks run on 132 SMs, so the
//   rows of one (row, head) should not queue behind each other either.
// Design (the launch geometry is ops/decode_attention.py::plan, checked here):
//   - Grid (splits, heads, rows) of 128-thread blocks. The `splits` blocks of
//     one (row, head) split its L columns into runs of `cols` and form one
//     thread block cluster (at most 8, the portable size); one block per
//     (row, head) at short caches, where a cluster buys nothing.
//   - One dependent round trip per chunk: q, the chunk's valid flags and all
//     of its K and V rows are issued as cp.async (16 bytes a copy; valid 4)
//     before a single wait, so no K load waits on valid and no row on
//     another. A block stages its whole run at once up to kStageBytes of K
//     and V (341 rows bf16, 180 f32), else in chunks with an online softmax
//     (the running max rescales the sums, one round trip per chunk). Staged
//     rows are padded by 16 bytes, so neighbouring rows' 16-byte reads fall
//     in different banks.
//   - Logits: 4 lanes per row, 16 dims each from 16-byte shared reads, two
//     shuffles; each warp keeps the max of its rows, and one barrier gives
//     the block's max.
//   - AV: a thread owns 8 output dims over one of 16 column groups (row r of
//     the chunk in group r mod 16); it forms p = exp(l - m) itself and adds
//     p * v only where p != 0 (a select: an invisible column weighs exactly
//     0 and its V, stale or not, never enters the sum). The groups are added
//     by two warp shuffles, then the 4 warps in order in shared memory, with
//     the sum of the p's beside them.
//   - Clusters: each block writes its (acc[64], max, sum) into rank 0's
//     shared memory (distributed shared memory, after a start barrier that
//     every block arrives at on entry), one cluster barrier, and rank 0
//     rescales them by exp(m_r - M) (again a select: a block with no
//     visible column contributes nothing once any column is visible), adds
//     them in rank order and divides once. No atomics: two calls give the
//     same bits.
//   - A row with no visible column: every logit is -1e30, every p is 1, and
//     the output is the mean of its V rows, as the -1e30 softmax of the TPU
//     kernel gives.
//   - SIMT, not tensor cores: one query row per head is far below an MMA
//     tile, and the FMAs are not what the call waits on.
#include <cooperative_groups.h>
#include <stdint.h>

#include "common.cuh"
#include "mma.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kHeadDim = 64;
constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kRowLanes = 4;                           // lanes of one row's dot
constexpr int kRowDims = kHeadDim / kRowLanes;         // dims of a lane's share of a dot
constexpr int kRowsPerPass = kThreads / kRowLanes;     // rows of one pass of the logits
constexpr int kDims = 8;                               // output dims a thread accumulates
constexpr int kDimGroups = kHeadDim / kDims;           // threads of one column in AV
constexpr int kGroups = kThreads / kDimGroups;         // column groups in AV
constexpr int kMaxSplits = 8;                          // blocks of a cluster: the portable maximum
constexpr int kStageBytes = 96 * 1024;                 // K and V rows staged at once
constexpr int kMaxSmem = 232448;                       // 227 KB, the most a block can take
constexpr int kPartFloats = kHeadDim + 4;              // a warp's (acc[64], sum), padded
constexpr int kStatFloats = kHeadDim + 4;              // a block's (acc[64], max, sum), padded
constexpr float kNeg = -1e30f;

static_assert(kWarps * 32 == kThreads && kGroups % 4 == 0, "AV groups: 4 a warp");

__host__ __device__ constexpr int align16(int x) { return (x + 15) & ~15; }

// A staged K or V row: 64 values and 16 bytes of padding.
__host__ __device__ constexpr int stage_row_bytes(int esize) { return kHeadDim * esize + 16; }

// Byte offsets of the regions of dynamic shared memory; `total` is what the
// plan (ops/decode_attention.py::plan, the same formula) passes as `smem`.
struct Layout {
  int k, v, q, valid, logits, wmax, part, stats, total;
};

__host__ __device__ inline Layout layout(int stage_rows, int splits, int esize) {
  Layout l;
  l.k = 0;
  l.v = l.k + stage_rows * stage_row_bytes(esize);
  l.q = l.v + stage_rows * stage_row_bytes(esize);
  l.valid = l.q + kHeadDim * esize;
  l.logits = l.valid + align16(4 * stage_rows);
  l.wmax = l.logits + align16(4 * stage_rows);
  l.part = l.wmax + 4 * kWarps;
  l.stats = l.part + 4 * kWarps * kPartFloats;
  l.total = l.stats + (splits > 1 ? 4 * splits * kStatFloats : 0);
  return l;
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

struct Args {
  const void* q;
  const void* k;
  const void* v;
  const int* valid;
  void* out;
  int q_stride, k_bstride, k_lstride, v_bstride, v_lstride;   // in elements
  int nh, L, cols, stage_rows;
};

template <typename T>
__global__ void __launch_bounds__(kThreads) decode_attention_kernel(const Args a) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int kVec = 16 / sizeof(T);                 // values of one 16-byte copy
  constexpr int kCopies = kHeadDim / kVec;             // 16-byte copies of a row
  constexpr int kPitch = stage_row_bytes(sizeof(T)) / sizeof(T);   // staged row stride, in T
  const int split = blockIdx.x, head = blockIdx.y, b = blockIdx.z, tid = threadIdx.x;
  const int splits = gridDim.x;
  if (splits > 1)   // the start barrier: rank 0's memory is written only after its wait
    asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
  const Layout lay = layout(a.stage_rows, splits, sizeof(T));
  T* kbuf = reinterpret_cast<T*>(smem + lay.k);
  T* vbuf = reinterpret_cast<T*>(smem + lay.v);
  T* qs = reinterpret_cast<T*>(smem + lay.q);
  int* valid_s = reinterpret_cast<int*>(smem + lay.valid);
  float* lg = reinterpret_cast<float*>(smem + lay.logits);
  float* wmax = reinterpret_cast<float*>(smem + lay.wmax);
  float* part = reinterpret_cast<float*>(smem + lay.part);
  float* stats = reinterpret_cast<float*>(smem + lay.stats);
  const size_t hoff = (size_t)head * kHeadDim;
  const T* q = static_cast<const T*>(a.q) + (size_t)b * a.q_stride + hoff;
  const T* k = static_cast<const T*>(a.k) + (size_t)b * a.k_bstride + hoff;
  const T* v = static_cast<const T*>(a.v) + (size_t)b * a.v_bstride + hoff;
  const int* valid = a.valid + (size_t)b * a.L;
  const int begin = split * a.cols, end = min(a.L, begin + a.cols);
  const int lane = tid & 31, warp = tid >> 5;
  const int quarter = tid % kRowLanes;                  // logits: this lane's dims of a row
  const int dg = tid % kDimGroups, g = tid / kDimGroups;   // AV: dims dg*8.., column group g
  const float scale = 1.0f / sqrtf((float)kHeadDim);

  float qf[kRowDims];
  float acc[kDims] = {};
  float psum = 0.f, m_run = -INFINITY;
  for (int c0 = begin; c0 < end; c0 += a.stage_rows) {
    const int n = min(a.stage_rows, end - c0);
    if (c0 != begin) __syncthreads();                  // the previous chunk is read
    // ---- one round trip: q (first chunk), the chunk's valid flags, K and V rows
    if (c0 == begin && tid < kCopies) vct::cp_async16(qs + tid * kVec, q + tid * kVec, true);
    for (int i = tid; i < n; i += kThreads) cp_async4(valid_s + i, valid + c0 + i);
    for (int i = tid; i < n * kCopies; i += kThreads) {
      const int r = i / kCopies, c = (i % kCopies) * kVec;
      vct::cp_async16(kbuf + r * kPitch + c, k + (size_t)(c0 + r) * a.k_lstride + c, true);
      vct::cp_async16(vbuf + r * kPitch + c, v + (size_t)(c0 + r) * a.v_lstride + c, true);
    }
    vct::cp_async_commit();
    vct::cp_async_wait<0>();
    __syncthreads();
    if (c0 == begin) {
#pragma unroll
      for (int i = 0; i < kRowDims; i += 8) {
        float f[8];
        load8(qs + quarter * kRowDims + i, f);
#pragma unroll
        for (int e = 0; e < 8; ++e) qf[i + e] = f[e];
      }
    }

    // ---- logits: 4 lanes a row; each warp's max of its rows
    float mx = -INFINITY;
    for (int r0 = 0; r0 < n; r0 += kRowsPerPass) {
      const int r = r0 + tid / kRowLanes;
      float s = 0.f;
      if (r < n) {
        const T* kr = kbuf + r * kPitch + quarter * kRowDims;
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
      if (r < n) {
        const float l = valid_s[r] > 0 ? s * scale : kNeg;   // select, whatever K holds
        if (quarter == 0) lg[r] = l;
        mx = fmaxf(mx, l);
      }
    }
    mx = vct::warp_max(mx);
    if (lane == 0) wmax[warp] = mx;
    __syncthreads();
    float m_new = m_run;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) m_new = fmaxf(m_new, wmax[w]);
    // the online rescale; a factor of 0 drops what came before, whatever it holds
    const float f = expf(m_run - m_new);
#pragma unroll
    for (int e = 0; e < kDims; ++e) acc[e] = f != 0.f ? acc[e] * f : 0.f;
    psum = f != 0.f ? psum * f : 0.f;
    m_run = m_new;

    // ---- AV: group g sums rows g, g + 16, ... of the chunk, in order
    for (int r = g; r < n; r += kGroups) {
      const float p = expf(lg[r] - m_new);
      if (p != 0.f) {                                   // an invisible column adds nothing
        float vv[kDims];
        load8(vbuf + r * kPitch + dg * kDims, vv);
#pragma unroll
        for (int e = 0; e < kDims; ++e) acc[e] = fmaf(p, vv[e], acc[e]);
        psum += p;
      }
    }
  }

  // ---- the block's sums: the 4 groups of a warp pairwise, then the warps in order
#pragma unroll
  for (int e = 0; e < kDims; ++e) {
    acc[e] += __shfl_xor_sync(0xffffffffu, acc[e], 8);
    acc[e] += __shfl_xor_sync(0xffffffffu, acc[e], 16);
  }
  psum += __shfl_xor_sync(0xffffffffu, psum, 8);
  psum += __shfl_xor_sync(0xffffffffu, psum, 16);
  if (lane < kDimGroups) {
#pragma unroll
    for (int e = 0; e < kDims; ++e) part[warp * kPartFloats + dg * kDims + e] = acc[e];
    if (dg == 0) part[warp * kPartFloats + kHeadDim] = psum;
  }
  __syncthreads();
  float o = 0.f, s = 0.f;
  if (tid < kHeadDim) {
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      o += part[w * kPartFloats + tid];
      s += part[w * kPartFloats + kHeadDim];
    }
  }
  T* out = static_cast<T*>(a.out) + ((size_t)b * a.nh + head) * kHeadDim;
  if (splits == 1) {
    if (tid < kHeadDim) out[tid] = vct::from_f32<T>(o / s);
    return;
  }

  // ---- the cluster: every block's (acc, max, sum) into rank 0, combined there
  cg::cluster_group cluster = cg::this_cluster();
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");   // every block has started
  if (tid < kHeadDim) {
    float* dst = cluster.map_shared_rank(stats, 0) + split * kStatFloats;
    dst[tid] = o;
    if (tid == 0) {
      dst[kHeadDim] = m_run;
      dst[kHeadDim + 1] = s;
    }
  }
  cluster.sync();   // releases the writes, and rank 0 acquires them
  if (split != 0 || tid >= kHeadDim) return;
  float big = -INFINITY;
  for (int r = 0; r < splits; ++r) big = fmaxf(big, stats[r * kStatFloats + kHeadDim]);
  o = 0.f;
  s = 0.f;
  for (int r = 0; r < splits; ++r) {
    const float w = expf(stats[r * kStatFloats + kHeadDim] - big);
    if (w != 0.f) {   // a block whose columns all weigh 0 adds nothing
      o = fmaf(stats[r * kStatFloats + tid], w, o);
      s = fmaf(stats[r * kStatFloats + kHeadDim + 1], w, s);
    }
  }
  out[tid] = vct::from_f32<T>(o / s);
}

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

template <typename T>
int launch(const Args& a, int b, int splits, int smem, cudaStream_t stream) {
  int resident = 0;   // sets the kernel's shared-memory limit, once per device
  cudaError_t err =
      vct::resident_blocks<decode_attention_kernel<T>>(kThreads, kMaxSmem, &resident);
  if (err != cudaSuccess) return (int)err;
  if (splits == 1) {
    decode_attention_kernel<T><<<dim3(1, a.nh, b), kThreads, smem, stream>>>(a);
    return (int)cudaGetLastError();
  }
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3(splits, a.nh, b);
  config.blockDim = dim3(kThreads);
  config.dynamicSmemBytes = smem;
  config.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = splits;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  config.attrs = attr;
  config.numAttrs = 1;
  return (int)cudaLaunchKernelEx(&config, decode_attention_kernel<T>, a);
}

template <typename T>
int dispatch(const Args& a, int b, int splits, int stage_rows, int smem, cudaStream_t stream) {
  constexpr int es = sizeof(T);
  if (!aligned16(a.q) || !aligned16(a.k) || !aligned16(a.v) || (a.q_stride * es) % 16 ||
      (b > 1 && ((a.k_bstride * es) % 16 || (a.v_bstride * es) % 16)) ||
      (a.L > 1 && ((a.k_lstride * es) % 16 || (a.v_lstride * es) % 16)))
    return (int)cudaErrorInvalidValue;
  const int limit = kStageBytes / (2 * stage_row_bytes(es));
  const int most = a.cols < limit ? a.cols : limit;
  if (stage_rows < 1 || stage_rows > most || smem != layout(stage_rows, splits, es).total ||
      smem > kMaxSmem)
    return (int)cudaErrorInvalidValue;
  return launch<T>(a, b, splits, smem, stream);
}

}  // namespace

// out [B, nh, 64] = decode attention of q over the L cache rows. splits,
// stage_rows and smem are ops/decode_attention.py::plan's (the `splits`
// blocks of a (row, head) take runs of ceil(L / splits) columns, each staged
// stage_rows at a time); q, k and v must start on 16-byte boundaries and
// their strides be multiples of 16 bytes. Anything else the kernel does not
// take returns cudaErrorInvalidValue.
extern "C" int vct_decode_attention(const void* q, int q_stride, const void* k, int k_bstride,
                                    int k_lstride, const void* v, int v_bstride,
                                    int v_lstride, const void* valid, void* out, int b, int nh,
                                    int L, int splits, int stage_rows, int smem, int dtype,
                                    void* stream) {
  if (b <= 0 || b > 65535 || nh <= 0 || nh > 65535 || L <= 0 || q_stride < nh * kHeadDim ||
      k_lstride < nh * kHeadDim || v_lstride < nh * kHeadDim || splits < 1 ||
      splits > kMaxSplits)
    return (int)cudaErrorInvalidValue;
  const int cols = (L + splits - 1) / splits;
  if ((splits - 1) * cols >= L) return (int)cudaErrorInvalidValue;   // a block with no column
  const Args a{q, k, v, static_cast<const int*>(valid), out, q_stride, k_bstride, k_lstride,
               v_bstride, v_lstride, nh, L, cols, stage_rows};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == vct::kBFloat16)
    return dispatch<__nv_bfloat16>(a, b, splits, stage_rows, smem, st);
  if (dtype == vct::kFloat32) return dispatch<float>(a, b, splits, stage_rows, smem, st);
  return (int)cudaErrorInvalidValue;
}
