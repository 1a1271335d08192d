// Fused layernorm, backward.
//
// Replaces: _ln_bwd_kernel, paddle_tpu/ops/pallas_kernels.py:931 (called
// through _fused_ln_vjp_bwd :1046-1103). Per row, with s the forward's
// pre-norm sum (or x itself for the plain form) and its float32 mu, rstd:
//   xhat = (s - mu) * rstd,  g = dy * scale
//   ds   = rstd * (g - mean(g) - xhat * mean(g * xhat))  (+ dsx, the
//          cotangent of the returned s)          stored in s's dtype
//   dx   = ds * mask * inv_keep                  (dropout form only)
// and, per block of rows, float32 partial sums of dy * xhat (dscale) and
// dy (dbias) over the block's rows, one [D] row each. The caller adds the
// partials, as the reference sums its (ngrid, D) partials outside the
// kernel; no atomics, so the result does not depend on block order.
//
// What bounds it on the card: HBM. At the training shape ([16384, 768]
// bf16, with dsx) it reads s, dy and dsx and writes ds, ~100 MB, with a
// few tens of operations an element. Design: a block of 256 threads walks
// a tile of rows; each thread keeps its columns of the row in registers
// (D <= 2048: eight columns a thread), one two-value block reduction gives
// both row means, and the per-column dscale/dbias sums stay in registers
// across the tile until one store of the partials at the end.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMaxCols = 8;  // columns a thread holds: D <= 2048

// (a, b) summed over the block, broadcast to every thread; `scratch` is 64
// floats of shared memory.
__device__ __forceinline__ float2 block_sum2(float a, float b,
                                             float* scratch) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  a = ptt::warp_sum(a);
  b = ptt::warp_sum(b);
  __syncthreads();
  if (lane == 0) {
    scratch[warp] = a;
    scratch[32 + warp] = b;
  }
  __syncthreads();
  if (warp == 0) {
    a = ptt::warp_sum(lane < nwarps ? scratch[lane] : 0.f);
    b = ptt::warp_sum(lane < nwarps ? scratch[32 + lane] : 0.f);
    if (lane == 0) {
      scratch[0] = a;
      scratch[32] = b;
    }
  }
  __syncthreads();
  return make_float2(scratch[0], scratch[32]);
}

template <typename T, bool kDsx, bool kMask>
__global__ void __launch_bounds__(kThreads)
    ln_bwd_kernel(const T* __restrict__ sx, const float* __restrict__ mu,
                  const float* __restrict__ rstd,
                  const float* __restrict__ scale, const T* __restrict__ dy,
                  const T* __restrict__ dsx,
                  const unsigned char* __restrict__ mask,
                  T* __restrict__ ds_out, T* __restrict__ dx_out,
                  float* __restrict__ dscale_part,
                  float* __restrict__ dbias_part, int R, int D,
                  int rows_per_block, float inv_keep) {
  __shared__ float scratch[64];
  float dsc[kMaxCols], dbi[kMaxCols], g[kMaxCols], xh[kMaxCols];
#pragma unroll
  for (int c = 0; c < kMaxCols; ++c) dsc[c] = dbi[c] = 0.f;
  const float inv_d = 1.f / static_cast<float>(D);
  const int r0 = blockIdx.x * rows_per_block;
  const int r1 = min(R, r0 + rows_per_block);
  for (int r = r0; r < r1; ++r) {
    const size_t off = static_cast<size_t>(r) * D;
    const float m = mu[r], rs = rstd[r];
    float sg = 0.f, sgx = 0.f;
#pragma unroll
    for (int c = 0; c < kMaxCols; ++c) {
      const int i = threadIdx.x + c * kThreads;
      if (i < D) {
        const float d = ptt::to_f32(dy[off + i]);
        xh[c] = (ptt::to_f32(sx[off + i]) - m) * rs;
        g[c] = d * scale[i];
        sg += g[c];
        sgx += g[c] * xh[c];
        dsc[c] += d * xh[c];
        dbi[c] += d;
      }
    }
    const float2 sums = block_sum2(sg, sgx, scratch);
    const float gm = sums.x * inv_d, gxm = sums.y * inv_d;
#pragma unroll
    for (int c = 0; c < kMaxCols; ++c) {
      const int i = threadIdx.x + c * kThreads;
      if (i < D) {
        float ds = rs * (g[c] - gm - xh[c] * gxm);
        if (kDsx) ds += ptt::to_f32(dsx[off + i]);
        ds_out[off + i] = ptt::from_f32<T>(ds);
        if (kMask)
          dx_out[off + i] = ptt::from_f32<T>(__fmul_rn(
              __fmul_rn(ds, mask[off + i] ? 1.f : 0.f), inv_keep));
      }
    }
  }
  const size_t poff = static_cast<size_t>(blockIdx.x) * D;
#pragma unroll
  for (int c = 0; c < kMaxCols; ++c) {
    const int i = threadIdx.x + c * kThreads;
    if (i < D) {
      dscale_part[poff + i] = dsc[c];
      dbias_part[poff + i] = dbi[c];
    }
  }
}

struct Args {
  const void *sx, *mu, *rstd, *scale, *dy, *dsx, *mask;
  void *ds, *dx, *dscale_part, *dbias_part;
  int R, D, rows_per_block, blocks;
  float inv_keep;
};

template <typename T, bool kDsx, bool kMask>
int launch(const Args& a, cudaStream_t stream) {
  ln_bwd_kernel<T, kDsx, kMask><<<a.blocks, kThreads, 0, stream>>>(
      static_cast<const T*>(a.sx), static_cast<const float*>(a.mu),
      static_cast<const float*>(a.rstd), static_cast<const float*>(a.scale),
      static_cast<const T*>(a.dy), static_cast<const T*>(a.dsx),
      static_cast<const unsigned char*>(a.mask), static_cast<T*>(a.ds),
      static_cast<T*>(a.dx), static_cast<float*>(a.dscale_part),
      static_cast<float*>(a.dbias_part), a.R, a.D, a.rows_per_block,
      a.inv_keep);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch(const Args& a, cudaStream_t st) {
  if (a.dsx && a.mask) return launch<T, true, true>(a, st);
  if (a.dsx) return launch<T, true, false>(a, st);
  if (a.mask) return launch<T, false, true>(a, st);
  return launch<T, false, false>(a, st);
}

}  // namespace

// sx, dy, ds: [R, D] contiguous, dtype `dtype`; mu, rstd: [R] float32;
// scale: [D] float32; dscale_part, dbias_part: [blocks, D] float32 with
// blocks = ceil(R / rows_per_block). Optional (null when absent): dsx
// [R, D] in sx's dtype; mask [R, D] bool, and then dx [R, D] is written.
// inv_keep is 1/keep in float32. D must not exceed 2048.
extern "C" int ptt_ln_bwd(const void* sx, const void* mu, const void* rstd,
                          const void* scale, const void* dy, const void* dsx,
                          const void* mask, void* ds, void* dx,
                          void* dscale_part, void* dbias_part, int R, int D,
                          int rows_per_block, float inv_keep, int dtype,
                          void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (D > kThreads * kMaxCols || rows_per_block < 1 ||
      (mask != nullptr) != (dx != nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const int blocks = (R + rows_per_block - 1) / rows_per_block;
  const Args a{sx, mu, rstd, scale, dy, dsx, mask, ds, dx, dscale_part,
               dbias_part, R, D, rows_per_block, blocks, inv_keep};
  switch (dtype) {
    case ptt::kF32:
      return dispatch<float>(a, st);
    case ptt::kBF16:
      return dispatch<__nv_bfloat16>(a, st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
