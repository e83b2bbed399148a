// Fused spatial pool + temporal mean of the ViT token stream.
//
// Replaces: video_caption_tpu/ops/pallas/fused_pool.py, _fused_pool (Pallas
//   body _pool_kernel).
// Computes: tokens [B*T, S, H] (f32 or bf16) -> y [B, H] in the tokens'
//   dtype, with f32 accumulation:
//     gap: y[b, h] = mean over t < T, 1 <= s < S of x[b*T + t, s, h]
//     cls: y[b, h] = mean over t < T of x[b*T + t, 0, h]
//   One f32 sum over all T*(S-1) (or T) rows of a video, divided once by
//   their count, as the TPU kernel's jnp.mean over axes (0, 1). The plain
//   version (ops/fused_pool.py::fused_pool_ref, the JAX package's _xla_pool)
//   takes each frame's mean first and then the mean over frames; the two
//   differ only in rounding.
//
// What bounds it on the H100: bytes. It reads every pooled token once and
//   does one add per element read; the output is 1/(T*(S-1)) of the input.
//   At the joint step's 4 videos x 8 frames that is 19.3 MB, 5.8 us at
//   3.35 TB/s, so the card needs every SM busy with several 16-byte loads in
//   flight per thread.
// Design (the launch geometry comes from ops/fused_pool.py::plan and is
//   checked here):
//   - Grid (splits, column tiles, B) of 256-thread blocks. A block owns
//     `tile_vecs` 16-byte column groups (4 f32 or 8 bf16 columns each) of one
//     video and one slice of `rows_per_split` of its pooled rows; its threads
//     are tile_vecs groups x (256 / tile_vecs) row lanes, so a warp reads
//     whole 16-byte groups of neighbouring columns of one or two rows.
//   - Each thread issues up to kUnroll (8) 16-byte loads, one per row, before
//     its first add (the last group masked), and sums its rows in order in
//     f32. Where the tokens' pointer is not 16-byte aligned or H is not a
//     multiple of the group, the same kernel loads each group element by
//     element, the columns past H masked.
//   - Each block adds its row lanes in shared memory in a fixed order: the
//     threads of a column each add V (the group's columns) neighbouring
//     lanes in order, then a butterfly of warp shuffles adds those sums
//     pairwise.
//   - The `splits` blocks of one (video, column tile) form a thread block
//     cluster (at most 8 blocks, the portable size). Rank 0 reads every
//     block's sums through distributed shared memory, adds them in rank
//     order, divides once by the row count and writes. No atomics: two calls
//     give the same bits. cls reads T rows per video and runs with
//     splits = 1.
//   - CUDA C++ rather than Triton: the reduction rests on cluster distributed
//     shared memory, which Triton does not expose.
#include <cooperative_groups.h>
#include <stdint.h>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;    // column groups x row lanes
constexpr int kMaxSplits = 8;    // blocks of a cluster: the portable maximum
constexpr int kUnroll = 8;       // loads a thread has in flight before its first add
constexpr int kMaxTileCols = 256;

template <typename T>
__host__ __device__ constexpr int group_cols() { return 16 / (int)sizeof(T); }   // columns of one 16-byte load

// add the values of one 16-byte group (4 f32 or 8 bf16) to acc in f32
__device__ __forceinline__ void add_group(float (&acc)[4], const uint4& v) {
  acc[0] += __uint_as_float(v.x);
  acc[1] += __uint_as_float(v.y);
  acc[2] += __uint_as_float(v.z);
  acc[3] += __uint_as_float(v.w);
}
__device__ __forceinline__ void add_group(float (&acc)[8], const uint4& v) {
  const unsigned w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {       // the low half of each word is the first bf16
    acc[2 * i] += __uint_as_float(w[i] << 16);
    acc[2 * i + 1] += __uint_as_float(w[i] & 0xffff0000u);
  }
}

template <typename T, bool kVector>
__global__ void __launch_bounds__(kThreads)
fused_pool_kernel(const T* __restrict__ x, T* __restrict__ y, int frames, int seq, int h,
                  int gap, int tile_vecs, int rows_per_split) {
  constexpr int V = group_cols<T>();
  __shared__ __align__(16) float part[kThreads * V];    // [lanes][tile_cols]
  __shared__ float total[kMaxTileCols];                 // this block's sums of its columns
  cg::cluster_group cluster = cg::this_cluster();
  const int split = (int)cluster.block_rank();         // the cluster spans grid x
  const int splits = (int)gridDim.x;
  const int lanes = kThreads / tile_vecs, tile_cols = tile_vecs * V;
  const int cv = threadIdx.x % tile_vecs, lane = threadIdx.x / tile_vecs;
  const int col0 = blockIdx.y * tile_cols + cv * V;     // this thread's first column
  const int per_frame = gap ? seq - 1 : 1;              // pooled rows of each frame
  const int rows = frames * per_frame;
  const int begin = split * rows_per_split, end = min(rows, begin + rows_per_split);
  const T* video = x + (size_t)blockIdx.z * frames * seq * h + col0;
  // pooled row i of the video -> its token row (gap skips each frame's CLS token)
  auto row = [&](int i) { return video + (size_t)(gap ? i + i / per_frame + 1 : i * seq) * h; };

  float acc[V];
#pragma unroll
  for (int e = 0; e < V; ++e) acc[e] = 0.f;
  if (col0 < h) {
    if constexpr (kVector) {
      for (int i = begin + lane; i < end; i += kUnroll * lanes) {
        uint4 v[kUnroll];
#pragma unroll
        for (int u = 0; u < kUnroll; ++u)
          if (i + u * lanes < end) v[u] = __ldg(reinterpret_cast<const uint4*>(row(i + u * lanes)));
#pragma unroll
        for (int u = 0; u < kUnroll; ++u)
          if (i + u * lanes < end) add_group(acc, v[u]);
      }
    } else {
      const int n = min(V, h - col0);                   // the last group may be partial
      for (int i = begin + lane; i < end; i += kUnroll * lanes) {
        float v[kUnroll][V];
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          const T* p = row(i + u * lanes);
#pragma unroll
          for (int e = 0; e < V; ++e) v[u][e] = i + u * lanes < end && e < n ? vct::to_f32(p[e]) : 0.f;
        }
#pragma unroll
        for (int u = 0; u < kUnroll; ++u)
          if (i + u * lanes < end)
#pragma unroll
            for (int e = 0; e < V; ++e) acc[e] += v[u][e];
      }
    }
  }
#pragma unroll
  for (int e = 0; e < V; ++e) part[lane * tile_cols + cv * V + e] = acc[e];
  __syncthreads();
  {  // the row lanes: `sub` threads a column, each V lanes in order, then pairwise
    const int sub = lanes / V, c = threadIdx.x / sub, j = threadIdx.x % sub;
    float s = 0.f;
#pragma unroll
    for (int l = 0; l < V; ++l) s += part[(j * V + l) * tile_cols + c];
    for (int m = 1; m < sub; m <<= 1) s += __shfl_xor_sync(0xffffffffu, s, m);
    if (j == 0) total[c] = s;
  }
  cluster.sync();                                       // every block's sums are in place
  if (split == 0 && threadIdx.x < tile_cols) {
    const int col = blockIdx.y * tile_cols + threadIdx.x;
    float s = 0.f;
    for (int r = 0; r < splits; ++r) s += *cluster.map_shared_rank(&total[threadIdx.x], r);
    if (col < h) y[(size_t)blockIdx.z * h + col] = vct::from_f32<T>(s / (float)rows);
  }
  // rank 0 has read the peers' sums: only then may they exit (no memory to order)
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
}

template <typename T, bool kVector>
int launch(const void* x, void* y, int batch, int frames, int seq, int h, int gap, int tile_vecs,
           int splits, int rows_per_split, cudaStream_t stream) {
  constexpr int V = group_cols<T>();
  const int tiles = ((h + V - 1) / V + tile_vecs - 1) / tile_vecs;
  if (tiles > 65535 || batch > 65535) return (int)cudaErrorInvalidValue;
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3(splits, tiles, batch);
  config.blockDim = dim3(kThreads);
  config.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = splits;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  config.attrs = attr;
  config.numAttrs = splits > 1 ? 1 : 0;     // one block: a plain launch (a cluster of one)
  return (int)cudaLaunchKernelEx(&config, fused_pool_kernel<T, kVector>, static_cast<const T*>(x),
                                 static_cast<T*>(y), frames, seq, h, gap, tile_vecs, rows_per_split);
}

template <typename T>
int dispatch(const void* x, void* y, int batch, int frames, int seq, int h, int gap, int tile_vecs,
             int splits, int rows_per_split, int vector, cudaStream_t stream) {
  if (vector) {
    if (reinterpret_cast<uintptr_t>(x) % 16 != 0 || h % group_cols<T>() != 0)
      return (int)cudaErrorInvalidValue;
    return launch<T, true>(x, y, batch, frames, seq, h, gap, tile_vecs, splits, rows_per_split,
                           stream);
  }
  return launch<T, false>(x, y, batch, frames, seq, h, gap, tile_vecs, splits, rows_per_split,
                          stream);
}

}  // namespace

// tokens [batch * frames, seq, h] -> y [batch, h]; gap = 1 pools tokens
// 1..seq-1 of every frame, gap = 0 the CLS token. The geometry (tile_vecs
// 16-byte column groups per block, splits blocks per cluster, rows_per_split
// pooled rows per block) is ops/fused_pool.py::plan's; vector = 1 takes the
// 16-byte loads, which need a 16-byte aligned x and H a multiple of 16 bytes.
extern "C" int vct_fused_pool(const void* x, void* y, int batch, int frames, int seq, int h,
                              int gap, int dtype, int tile_vecs, int splits, int rows_per_split,
                              int vector, void* stream) {
  if (batch <= 0 || frames <= 0 || h <= 0 || seq < (gap ? 2 : 1)) return (int)cudaErrorInvalidValue;
  if (tile_vecs != 4 && tile_vecs != 8 && tile_vecs != 16 && tile_vecs != 32)
    return (int)cudaErrorInvalidValue;
  const long long rows = (long long)frames * (gap ? seq - 1 : 1);
  if ((long long)frames * seq > (1LL << 31) - 1 || splits < 1 || splits > kMaxSplits ||
      rows_per_split < 1 || (long long)rows_per_split * splits < rows ||
      (long long)rows_per_split * (splits - 1) >= rows)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == vct::kBFloat16)
    return dispatch<__nv_bfloat16>(x, y, batch, frames, seq, h, gap, tile_vecs, splits,
                                   rows_per_split, vector, st);
  if (dtype == vct::kFloat32)
    return dispatch<float>(x, y, batch, frames, seq, h, gap, tile_vecs, splits, rows_per_split,
                           vector, st);
  return (int)cudaErrorInvalidValue;
}
