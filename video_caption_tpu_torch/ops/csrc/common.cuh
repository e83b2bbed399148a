// Helpers shared by the hand-written Hopper kernels of the caption path.
//
// Every kernel file exports plain C entry points (loaded with ctypes by
// ops/build.py). An entry point launches on the stream it is given, never
// synchronises, allocates nothing, and returns the cudaError_t of its launch
// as an int (0 = success).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

#include <atomic>

namespace vct {

// dtype codes passed from Python (ops/build.py::dtype_code)
constexpr int kFloat32 = 0;
constexpr int kBFloat16 = 1;

// Raise Kernel's dynamic shared-memory limit to `smem` bytes and set
// *blocks to how many of its blocks of `threads` threads the current device
// holds at once (blocks per SM x SMs). Both are done once per device and
// kept: the calls cost host time on every launch otherwise, and the serving
// path is bound by the host. `threads` and `smem` must be the same on every
// call for one Kernel (`smem` the most any launch of it uses).
template <auto Kernel>
cudaError_t resident_blocks(int threads, int smem, int* blocks) {
  constexpr int kMaxDevices = 64;
  static std::atomic<int> known[kMaxDevices];   // 0 until the first launch there
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < kMaxDevices && (*blocks = known[dev].load(std::memory_order_relaxed)) > 0)
    return cudaSuccess;
  int sms = 0, per_sm = 0;
  if ((err = cudaFuncSetAttribute(Kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem)) ||
      (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) ||
      (err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, Kernel, threads, smem)))
    return err;
  *blocks = sms * per_sm;
  if (dev < kMaxDevices) known[dev].store(*blocks, std::memory_order_relaxed);
  return cudaSuccess;
}

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// Round an f32 value through the compute dtype and back: the point where the
// TPU kernels cast attention probabilities before the AV product.
template <typename T>
__device__ __forceinline__ float round_to(float x) { return to_f32(from_f32<T>(x)); }

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Block-wide max / sum for blockDim.x a multiple of 32 (<= 1024). `scratch`
// holds 32 floats of shared memory; every thread receives the result.
__device__ __forceinline__ float block_max(float v, float* scratch) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  v = warp_max(v);
  __syncthreads();
  if (lane == 0) scratch[warp] = v;
  __syncthreads();
  float r = lane < nwarps ? scratch[lane] : -INFINITY;
  return warp_max(r);
}

__device__ __forceinline__ float block_sum(float v, float* scratch) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  v = warp_sum(v);
  __syncthreads();
  if (lane == 0) scratch[warp] = v;
  __syncthreads();
  float r = lane < nwarps ? scratch[lane] : 0.f;
  return warp_sum(r);
}

}  // namespace vct
