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

template <typename T>
__device__ __forceinline__ T zero_of() {
  return from_f32<T>(0.f);
}
template <>
__device__ __forceinline__ unsigned char zero_of<unsigned char>() {
  return 0;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// kK sums over the warp in one pass, their shuffles interleaved.
template <int kK>
__device__ __forceinline__ void warp_sum_n(float (&v)[kK]) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    float t[kK];
#pragma unroll
    for (int k = 0; k < kK; ++k) t[k] = __shfl_xor_sync(0xffffffffu, v[k], o);
#pragma unroll
    for (int k = 0; k < kK; ++k) v[k] += t[k];
  }
}

// kW elements of T as one aligned unit: copying one is one vector load or
// store (16 bytes for 8 bf16 or 4 float32; 8 or 4 bytes for bool masks).
template <typename T, int kW>
struct alignas(sizeof(T) * kW) Pack {
  T e[kW];
};

// The columns a lane holds of a row of D on a warp-a-row path, in chunks
// of kW elements. kVec: chunk j is the kW consecutive columns from
// (j * 32 + lane) * kW, one vector access (D % kW == 0, rows aligned);
// else element i of chunk j is column (j * kW + i) * 32 + lane, one
// coalesced scalar access an element. Either way, when column(j, 0) is
// at or past D so is the whole chunk.
template <bool kVec, int kW>
struct LaneCols {
  int lane, D;
  __device__ __forceinline__ int col(int j, int i) const {
    return kVec ? (j * 32 + lane) * kW + i : (j * kW + i) * 32 + lane;
  }
  __device__ __forceinline__ bool in(int j, int i) const {
    return col(j, i) < D;
  }
};

// Chunk j of row p (of type T: the row's elements or its bool mask).
// Call only where c.in(j, 0); elements past D read as zero.
template <bool kVec, typename T, int kW>
__device__ __forceinline__ Pack<T, kW> load_chunk(const T* __restrict__ p,
                                                  LaneCols<kVec, kW> c,
                                                  int j) {
  if (kVec) return *reinterpret_cast<const Pack<T, kW>*>(p + c.col(j, 0));
  Pack<T, kW> pk;
#pragma unroll
  for (int i = 0; i < kW; ++i)
    pk.e[i] = c.in(j, i) ? p[c.col(j, i)] : zero_of<T>();
  return pk;
}

// Chunk j of a float32 [D] vector (scale, bias): kW / 4 16-byte loads
// when kVec. Call only where c.in(j, 0).
template <bool kVec, int kW>
__device__ __forceinline__ void load_chunk_f32(const float* __restrict__ p,
                                               LaneCols<kVec, kW> c, int j,
                                               float (&v)[kW]) {
  if (kVec) {
#pragma unroll
    for (int u = 0; u < kW / 4; ++u) {
      const float4 f = reinterpret_cast<const float4*>(p + c.col(j, 0))[u];
      v[4 * u] = f.x;
      v[4 * u + 1] = f.y;
      v[4 * u + 2] = f.z;
      v[4 * u + 3] = f.w;
    }
  } else {
#pragma unroll
    for (int i = 0; i < kW; ++i) v[i] = c.in(j, i) ? p[c.col(j, i)] : 0.f;
  }
}

// v rounded to T, stored as chunk j of row p. Call only where c.in(j, 0).
template <bool kVec, typename T, int kW>
__device__ __forceinline__ void store_chunk(T* __restrict__ p,
                                            LaneCols<kVec, kW> c, int j,
                                            const float (&v)[kW]) {
  Pack<T, kW> pk;
#pragma unroll
  for (int i = 0; i < kW; ++i) pk.e[i] = from_f32<T>(v[i]);
  if (kVec) {
    *reinterpret_cast<Pack<T, kW>*>(p + c.col(j, 0)) = pk;
  } else {
#pragma unroll
    for (int i = 0; i < kW; ++i)
      if (c.in(j, i)) p[c.col(j, i)] = pk.e[i];
  }
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
