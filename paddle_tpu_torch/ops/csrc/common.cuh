// Shared helpers for the port's hand-written Hopper kernels (sm_90a).
//
// Every kernel in this directory has a plain C entry point (extern "C",
// bound with ctypes from ops/cuda_kernels.py) that launches on the stream
// it is given and returns cudaGetLastError(). Element types are float32
// and bfloat16; bf16 converts through the round-to-nearest-even
// intrinsics, as torch and XLA round.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>

namespace ptt {

// dtype codes shared with ops/cuda_kernels.py (_DTYPE_CODES)
enum DType : int { kF32 = 0, kBF16 = 1 };

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);  // round to nearest even
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// Block-wide sum / max, broadcast to every thread. Every thread of the
// block must call it; blockDim.x is a multiple of 32; `scratch` is 32
// floats of shared memory. The leading barrier lets back-to-back calls
// reuse the same scratch.
__device__ __forceinline__ float block_sum(float v, float* scratch) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  v = warp_sum(v);
  __syncthreads();
  if (lane == 0) scratch[warp] = v;
  __syncthreads();
  if (warp == 0) {
    v = warp_sum(lane < nwarps ? scratch[lane] : 0.f);
    if (lane == 0) scratch[0] = v;
  }
  __syncthreads();
  return scratch[0];
}

__device__ __forceinline__ float block_max(float v, float* scratch) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  v = warp_max(v);
  __syncthreads();
  if (lane == 0) scratch[warp] = v;
  __syncthreads();
  if (warp == 0) {
    v = warp_max(lane < nwarps ? scratch[lane] : -CUDART_INF_F);
    if (lane == 0) scratch[0] = v;
  }
  __syncthreads();
  return scratch[0];
}

}  // namespace ptt
