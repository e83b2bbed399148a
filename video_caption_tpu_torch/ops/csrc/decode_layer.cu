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
//   2 * B FLOPs per weight: bytes.
// Design (simple and right first): one cooperative persistent launch per
//   decode step (cudaLaunchCooperativeKernel; the grid is at most what
//   cudaOccupancyMaxActiveBlocksPerMultiprocessor allows on every SM, so all
//   blocks are resident), looping over the layers with a grid-wide barrier
//   (cooperative_groups::this_grid().sync()) between the five phases of a
//   layer, whose data crosses blocks:
//     1. LN1 + QKV + cache-row write; 2. attention, one block per (row, head)
//     (decode_attend.cuh); 3. proj + residual; 4. LN2 + fc + GELU;
//     5. out + residual.
//   The products are GEMVs written here, not library calls: a block owns a
//   tile of output columns (4 threads x one 16-byte load of columns; 64
//   groups of threads split the input dimension), stages up to RC rows of
//   the input vector in shared memory as f32, keeps RC x 8 f32 sums per
//   thread, and reduces over the groups with shuffles and shared memory. A
//   block recomputes the LayerNorm statistics of its rows from device memory
//   (a warp per row), which saves a barrier. Rows beyond RC take further
//   passes over the same tile. Between phases every intermediate lives in
//   device memory (scratch allocated by the caller): x, q, the attention
//   output and the 4H hidden.
#include <cooperative_groups.h>

#include "decode_attend.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kColThreads = 4;                    // threads across a column tile
constexpr int kGroups = kThreads / kColThreads;   // groups splitting the input dim
constexpr int kMaxRows = 8;                       // rows of the input per pass

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
  int B, H, nh, n_layer, max_len, offset;
  float eps;
};

enum Phase { kQKV, kProj, kFc, kOut };

template <typename T>
__host__ __device__ constexpr int vec_of() { return 16 / (int)sizeof(T); }

// 16 bytes of read-only weights -> f32.
__device__ __forceinline__ void load16(const float* p, float* out) {
  const float4 v = __ldg(reinterpret_cast<const float4*>(p));
  out[0] = v.x; out[1] = v.y; out[2] = v.z; out[3] = v.w;
}
__device__ __forceinline__ void load16(const __nv_bfloat16* p, float* out) {
  const uint4 v = __ldg(reinterpret_cast<const uint4*>(p));
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    out[2 * i] = f.x;
    out[2 * i + 1] = f.y;
  }
}

__device__ __forceinline__ float gelu_tanh(float x) {
  return 0.5f * x * (1.f + tanhf(0.7978845608028654f * (x + 0.044715f * x * x * x)));
}

template <typename T, int RC>
int smem_floats(int H, int max_len) {
  const int gemv = RC * 4 * H + kWarps * RC * kColThreads * vec_of<T>();
  const int attend = vct::attend_smem_floats(max_len, kThreads);
  return gemv > attend ? gemv : attend;
}

// The residual stream entering `layer`: the step's input for layer 0.
template <typename T>
__device__ __forceinline__ const T* layer_input(const Params<T>& p, int layer) {
  return layer == 0 ? p.x_in : p.x;
}

// xs[r][k] for the rows b0 + r (r < rc; zeros for rc <= r < RC): the
// LayerNorm of the row rounded to T, or the row itself.
template <typename T, int RC>
__device__ void stage_rows(const T* src, int K, int b0, int rc, const float* ln_s,
                           const float* ln_b, float eps, float* xs) {
  if (ln_s != nullptr) {
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    for (int r = warp; r < RC; r += kWarps) {
      float* out = xs + r * K;
      if (r >= rc) {
        for (int k = lane; k < K; k += 32) out[k] = 0.f;
        continue;
      }
      const T* row = src + (long)(b0 + r) * K;
      float s = 0.f;
      for (int k = lane; k < K; k += 32) s += vct::to_f32(row[k]);
      const float mean = vct::warp_sum(s) / K;
      float ss = 0.f;
      for (int k = lane; k < K; k += 32) {
        const float d = vct::to_f32(row[k]) - mean;
        ss += d * d;
      }
      const float rstd = rsqrtf(vct::warp_sum(ss) / K + eps);
      for (int k = lane; k < K; k += 32)
        out[k] = vct::round_to<T>((vct::to_f32(row[k]) - mean) * rstd * ln_s[k] + ln_b[k]);
    }
  } else {
    for (int i = threadIdx.x; i < RC * K; i += kThreads) {
      const int r = i / K;
      xs[i] = r < rc ? vct::to_f32(src[(long)(b0 + r) * K + i % K]) : 0.f;
    }
  }
}

template <typename T>
__device__ __forceinline__ void epilogue(const Params<T>& p, int layer, Phase phase, int b,
                                         int j, float acc, const T* bias) {
  const int H = p.H;
  const float y = vct::round_to<T>(vct::round_to<T>(acc) + vct::to_f32(bias[j]));
  switch (phase) {
    case kQKV:
      if (j < H) {
        p.q[(long)b * H + j] = vct::from_f32<T>(y);
      } else {
        const long row = ((long)layer * p.max_len + p.offset) * p.B + b;
        p.kvf[row * 2 * H + (j - H)] = vct::from_f32<T>(y);
      }
      break;
    case kProj: {
      const T* src = layer_input(p, layer);
      p.x[(long)b * H + j] = vct::from_f32<T>(vct::to_f32(src[(long)b * H + j]) + y);
      break;
    }
    case kFc:
      p.hid[(long)b * 4 * H + j] = vct::from_f32<T>(gelu_tanh(y));
      break;
    case kOut:
      p.x[(long)b * H + j] = vct::from_f32<T>(vct::to_f32(p.x[(long)b * H + j]) + y);
      break;
  }
}

// One product phase: out[b, :] = epilogue(in[b, :] @ W) for every row b.
template <typename T, int RC>
__device__ void gemv_phase(const Params<T>& p, int layer, Phase phase, float* smem) {
  constexpr int VEC = vec_of<T>();
  constexpr int TW = kColThreads * VEC;
  const int H = p.H;
  const int K = phase == kOut ? 4 * H : H;
  const int N = phase == kQKV ? 3 * H : phase == kFc ? 4 * H : H;
  const int ntiles = N / TW;
  if (blockIdx.x >= ntiles) return;   // uniform over the block

  const T* W;
  const T* bias;
  const T* src;
  const float* ln_s = nullptr;
  const float* ln_b = nullptr;
  switch (phase) {
    case kQKV:
      W = p.attn_w; bias = p.attn_b; src = layer_input(p, layer);
      ln_s = p.ln1_s + (long)layer * H; ln_b = p.ln1_b + (long)layer * H;
      break;
    case kProj:
      W = p.proj_w; bias = p.proj_b; src = p.attn;
      break;
    case kFc:
      W = p.fc_w; bias = p.fc_b; src = p.x;
      ln_s = p.ln2_s + (long)layer * H; ln_b = p.ln2_b + (long)layer * H;
      break;
    default:
      W = p.out_w; bias = p.out_b; src = p.hid;
      break;
  }
  W += (long)layer * K * N;
  bias += (long)layer * N;

  float* xs = smem;               // [RC][K]
  float* red = smem + RC * K;     // [kWarps][RC][TW]
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int ct = tid % kColThreads, kg = tid / kColThreads;

  for (int b0 = 0; b0 < p.B; b0 += RC) {
    const int rc = min(RC, p.B - b0);
    stage_rows<T, RC>(src, K, b0, rc, ln_s, ln_b, p.eps, xs);
    __syncthreads();
    for (int tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
      float acc[RC][VEC];
#pragma unroll
      for (int r = 0; r < RC; ++r)
#pragma unroll
        for (int e = 0; e < VEC; ++e) acc[r][e] = 0.f;
      const T* wp = W + tile * TW + ct * VEC;
#pragma unroll 4
      for (int k = kg; k < K; k += kGroups) {
        float w[VEC];
        load16(wp + (long)k * N, w);
#pragma unroll
        for (int r = 0; r < RC; ++r) {
          const float xv = xs[r * K + k];
#pragma unroll
          for (int e = 0; e < VEC; ++e) acc[r][e] = fmaf(xv, w[e], acc[r][e]);
        }
      }
      // sum over the groups of a warp (lanes with equal lane % kColThreads) ...
#pragma unroll
      for (int r = 0; r < RC; ++r)
#pragma unroll
        for (int e = 0; e < VEC; ++e) {
          float v = acc[r][e];
#pragma unroll
          for (int o = kColThreads; o < 32; o <<= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
          acc[r][e] = v;
        }
      if (lane < kColThreads) {
#pragma unroll
        for (int r = 0; r < RC; ++r)
#pragma unroll
          for (int e = 0; e < VEC; ++e) red[(warp * RC + r) * TW + lane * VEC + e] = acc[r][e];
      }
      __syncthreads();
      // ... then over the warps, and the phase's epilogue
      for (int i = tid; i < RC * TW; i += kThreads) {
        const int r = i / TW, c = i % TW;
        if (r < rc) {
          float s = 0.f;
#pragma unroll
          for (int w2 = 0; w2 < kWarps; ++w2) s += red[(w2 * RC + r) * TW + c];
          epilogue(p, layer, phase, b0 + r, tile * TW + c, s, bias);
        }
      }
      __syncthreads();
    }
  }
}

template <typename T>
__device__ void attention_phase(const Params<T>& p, int layer, float* smem) {
  const int H = p.H;
  const long row_stride = (long)p.B * 2 * H;
  const T* kvf_l = p.kvf + (long)layer * p.max_len * row_stride;
  const float scale = 1.0f / sqrtf((float)vct::kAttendHeadDim);
  for (int u = blockIdx.x; u < p.B * p.nh; u += gridDim.x) {
    const int b = u / p.nh, head = u % p.nh;
    const long hoff = (long)head * vct::kAttendHeadDim;
    const T* k = kvf_l + (long)b * 2 * H + hoff;
    vct::attend_head<T>(p.q + (long)b * H + hoff, k, row_stride, k + H, row_stride,
                        p.valid + (long)b * p.max_len, p.max_len, p.offset, scale, smem,
                        p.attn + (long)b * H + hoff);
  }
}

template <typename T, int RC>
__global__ void __launch_bounds__(kThreads) decode_layer_kernel(const Params<T> p) {
  extern __shared__ __align__(16) float smem[];
  cg::grid_group grid = cg::this_grid();
  for (int layer = 0; layer < p.n_layer; ++layer) {
    gemv_phase<T, RC>(p, layer, kQKV, smem);
    grid.sync();
    attention_phase<T>(p, layer, smem);
    grid.sync();
    gemv_phase<T, RC>(p, layer, kProj, smem);
    grid.sync();
    gemv_phase<T, RC>(p, layer, kFc, smem);
    grid.sync();
    gemv_phase<T, RC>(p, layer, kOut, smem);
    if (layer + 1 < p.n_layer) grid.sync();
  }
}

template <typename T, int RC>
int launch_rows(const Params<T>& p, cudaStream_t stream) {
  auto kernel = decode_layer_kernel<T, RC>;
  const size_t smem = (size_t)smem_floats<T, RC>(p.H, p.max_len) * sizeof(float);
  cudaError_t err;
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  int dev, sms, coop, per_sm;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return (int)err;
  if ((err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev)) != cudaSuccess)
    return (int)err;
  if (!coop) return (int)cudaErrorNotSupported;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return (int)err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, smem);
  if (err != cudaSuccess) return (int)err;
  if (per_sm < 1) return (int)cudaErrorCooperativeLaunchTooLarge;
  // enough blocks for the widest phase (the fc tiles or the (row, head)
  // units), and never more than can be resident at once
  const int tiles = 4 * p.H / (kColThreads * vec_of<T>());
  const int want = tiles > p.B * p.nh ? tiles : p.B * p.nh;
  const int grid = want < per_sm * sms ? want : per_sm * sms;
  void* args[] = {const_cast<Params<T>*>(&p)};
  err = cudaLaunchCooperativeKernel((const void*)kernel, dim3(grid), dim3(kThreads), args, smem,
                                    stream);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

template <typename T>
int launch(const Params<T>& p, cudaStream_t stream) {
  if (p.B <= 1) return launch_rows<T, 1>(p, stream);
  if (p.B <= 2) return launch_rows<T, 2>(p, stream);
  if (p.B <= 4) return launch_rows<T, 4>(p, stream);
  return launch_rows<T, kMaxRows>(p, stream);
}

template <typename T>
int run(const void* x_in, void* x, void* kvf, const void* valid, const void* ln1_s,
        const void* ln1_b, const void* attn_w, const void* attn_b, const void* proj_w,
        const void* proj_b, const void* ln2_s, const void* ln2_b, const void* fc_w,
        const void* fc_b, const void* out_w, const void* out_b, void* q, void* attn, void* hid,
        int b, int h, int nh, int n_layer, int max_len, int offset, float eps,
        cudaStream_t stream) {
  if (h % (kColThreads * vec_of<T>())) return (int)cudaErrorInvalidValue;
  const Params<T> p{static_cast<const T*>(x_in), static_cast<T*>(x), static_cast<T*>(kvf),
                    static_cast<const int*>(valid), static_cast<const float*>(ln1_s),
                    static_cast<const float*>(ln1_b), static_cast<const T*>(attn_w),
                    static_cast<const T*>(attn_b), static_cast<const T*>(proj_w),
                    static_cast<const T*>(proj_b), static_cast<const float*>(ln2_s),
                    static_cast<const float*>(ln2_b), static_cast<const T*>(fc_w),
                    static_cast<const T*>(fc_b), static_cast<const T*>(out_w),
                    static_cast<const T*>(out_b), static_cast<T*>(q), static_cast<T*>(attn),
                    static_cast<T*>(hid), b, h, nh, n_layer, max_len, offset, eps};
  return launch<T>(p, stream);
}

}  // namespace

extern "C" int vct_decode_layer(const void* x_in, void* x, void* kvf, const void* valid,
                                const void* ln1_s, const void* ln1_b, const void* attn_w,
                                const void* attn_b, const void* proj_w, const void* proj_b,
                                const void* ln2_s, const void* ln2_b, const void* fc_w,
                                const void* fc_b, const void* out_w, const void* out_b,
                                void* q, void* attn, void* hid, int b, int h, int nh,
                                int n_layer, int max_len, int offset, float eps, int dtype,
                                void* stream) {
  if (b <= 0 || nh <= 0 || h != nh * vct::kAttendHeadDim || n_layer <= 0 || max_len <= 0 ||
      offset < 0 || offset >= max_len)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == vct::kBFloat16)
    return run<__nv_bfloat16>(x_in, x, kvf, valid, ln1_s, ln1_b, attn_w, attn_b, proj_w,
                              proj_b, ln2_s, ln2_b, fc_w, fc_b, out_w, out_b, q, attn, hid, b, h,
                              nh, n_layer, max_len, offset, eps, st);
  if (dtype == vct::kFloat32)
    return run<float>(x_in, x, kvf, valid, ln1_s, ln1_b, attn_w, attn_b, proj_w, proj_b, ln2_s,
                      ln2_b, fc_w, fc_b, out_w, out_b, q, attn, hid, b, h, nh, n_layer, max_len,
                      offset, eps, st);
  return (int)cudaErrorInvalidValue;
}
