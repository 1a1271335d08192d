// What the two FlashAttention-2 backward kernels (flash_bwd_dq.cu,
// flash_bwd_dkv.cu) share: the argument block, the cp.async loaders of the
// ring (16-byte rows of [rows, hd] tiles padded by 16 bytes, float32
// vectors and tiles through 4-byte copies), the mma.sync fragment products
// over those tiles, the exponential, and the float32 instances' CUDA-core
// product and plain tile copy.
//
// What both compute, as the Pallas kernels do (pallas_kernels.py:205-323):
// s = q.k^T * scale + bias, with causal entries then replaced by
// -0.7*FLT_MAX (so their p is exactly 0); P = exp(s - lse) from the
// forward's lse; dP = dO.V^T; D = rowsum(dO*o) in float32, once a query
// row (dQ computes it and hands it to dK/dV); dS = P*(dP - D)*scale.
#pragma once

#include <cstdint>
#include <type_traits>

#include "common.cuh"
#include "mma.cuh"

namespace fbwd {

constexpr float kNegInf = -0.7f * 3.402823466e38f;   // _NEG_INF
constexpr float kLog2e = 1.4426950408889634f;

using bf16 = __nv_bfloat16;

struct Args {
  const void *q, *k, *v;
  const void* o;                // dQ only: D = rowsum(dO * o)
  const void *dout, *lse;
  float* di;                    // D [B, nh, T] f32: dQ writes it (if set),
                                // dK/dV reads it
  const float* bias;            // [BB, bias_rows, T] float32 or nullptr
  void *out0, *out1;            // dq: dq; dkv: dk, dv
  int T, nh;
  long long sb, st, sh;         // q/k/v strides (elements)
  float scale;
  int causal;
  int bias_heads, bias_rows;
};

// this head's bias: row bh / bias_heads of [BB, bias_rows, T]
__device__ __forceinline__ const float* head_bias(const Args& a) {
  return a.bias + static_cast<long long>(blockIdx.y / a.bias_heads) *
                      a.bias_rows * a.T;
}

// o/dO/dq/dk/dv offset of (b, row, h) in a contiguous [B, T, nh, HD]
template <int HD>
__device__ __forceinline__ long long packed_off(int b, int row, int h,
                                                const Args& a) {
  return ((static_cast<long long>(b) * a.T + row) * a.nh + h) * HD;
}

// rows [row0, row0 + n) of a [T, HD] slice (row stride ld) into shared
// memory with row stride LD, through 16-byte cp.async; rows >= T zeros
template <typename T, int HD, int LD, int NT>
__device__ __forceinline__ void load_rows(T* __restrict__ s,
                                          const T* __restrict__ g,
                                          long long ld, int row0, int n,
                                          int T_len) {
  constexpr int kVec = 16 / sizeof(T);
  constexpr int kPerRow = HD / kVec;
  for (int i = threadIdx.x; i < n * kPerRow; i += NT) {
    const int r = i / kPerRow, c = (i % kPerRow) * kVec;
    const bool in = row0 + r < T_len;
    ptt::cp_async16(s + r * LD + c,
                    g + (in ? static_cast<long long>(row0 + r) * ld + c : 0),
                    in ? 16 : 0);
  }
}

// float32 g[i0 .. i0 + n) into s[0 .. n) through 4-byte cp.async (any
// alignment); entries at i >= T zeros
template <int NT>
__device__ __forceinline__ void load_vec(float* __restrict__ s,
                                         const float* __restrict__ g, int i0,
                                         int n, int T_len) {
  for (int i = threadIdx.x; i < n; i += NT) {
    const bool in = i0 + i < T_len;
    ptt::cp_async4(s + i, g + (in ? i0 + i : 0), in ? 4 : 0);
  }
}

// the [rows, cols] float32 tile at (row0, col0) of a [T, T] matrix into s
// with row stride ld; entries outside [0, T) zeros
template <int NT>
__device__ __forceinline__ void load_ftile(float* __restrict__ s, int ld,
                                           const float* __restrict__ g,
                                           int row0, int rows, int col0,
                                           int cols, int T_len) {
  for (int i = threadIdx.x; i < rows * cols; i += NT) {
    const int r = i / cols, c = i % cols;
    const bool in = row0 + r < T_len && col0 + c < T_len;
    ptt::cp_async4(
        s + r * ld + c,
        g + (in ? static_cast<long long>(row0 + r) * T_len + col0 + c : 0),
        in ? 4 : 0);
  }
}

// 2^x, flushing subnormal results to zero (p <= 1 here)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// Sum over the 4 lanes that hold one row's accumulator columns.
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

template <typename T>
__device__ __forceinline__ void store2(T* p, float a, float b);
template <>
__device__ __forceinline__ void store2<float>(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
template <>
__device__ __forceinline__ void store2<bf16>(bf16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

// ---------------------------------------------------------------------------
// bf16 fragment products of one warp (mma.sync m16n8k16, fragment layout in
// mma.cuh); every tile lives in shared memory with row stride ld elements
// ---------------------------------------------------------------------------

// A fragments of the 16 x 16*KS row-major block at s (rows of a tile)
template <int KS>
__device__ __forceinline__ void load_a(uint32_t (&a)[KS][4], const bf16* s,
                                       int ld, int lane) {
#pragma unroll
  for (int kd = 0; kd < KS; ++kd)
    ptt::ldmatrix_x4(a[kd], s + ptt::ldm_row_a(lane) * ld + kd * 16 +
                                ptt::ldm_col_a(lane));
}

// acc[n] += A . B^T over two 8-column C tiles: A 16 x 16*KS in registers,
// B the 16 rows (n) at b of an [n][k] tile, 16*KS columns (k) (K for S =
// Q.K^T, Q for S^T = K.Q^T)
template <int KS>
__device__ __forceinline__ void mma_abt(float (&acc)[2][4],
                                        const uint32_t (&a)[KS][4],
                                        const bf16* b, int ld, int lane) {
#pragma unroll
  for (int kd = 0; kd < KS; ++kd) {
    uint32_t f[4];
    ptt::ldmatrix_x4(f, b + ptt::ldm_row_b(lane) * ld + kd * 16 +
                            ptt::ldm_col_b(lane));
    ptt::mma_bf16(acc[0], a[kd], f[0], f[1]);
    ptt::mma_bf16(acc[1], a[kd], f[2], f[3]);
  }
}

// The same with A's fragments read from shared memory at sa, one 16-column
// slice at a time (head_dim 128, where the registers cannot hold them).
template <int KS>
__device__ __forceinline__ void mma_abt_s(float (&acc)[2][4], const bf16* sa,
                                          int lda, const bf16* b, int ld,
                                          int lane) {
#pragma unroll
  for (int kd = 0; kd < KS; ++kd) {
    uint32_t a[4], f[4];
    ptt::ldmatrix_x4(a, sa + ptt::ldm_row_a(lane) * lda + kd * 16 +
                            ptt::ldm_col_a(lane));
    ptt::ldmatrix_x4(f, b + ptt::ldm_row_b(lane) * ld + kd * 16 +
                            ptt::ldm_col_b(lane));
    ptt::mma_bf16(acc[0], a, f[0], f[1]);
    ptt::mma_bf16(acc[1], a, f[2], f[3]);
  }
}

// The A fragment of a product over the 16 columns of two neighbouring
// 8-column C tiles: their f32 C fragments, packed to bf16 pairs (rounded
// to nearest even).
__device__ __forceinline__ void c_to_a(uint32_t (&a)[4],
                                       const float (&c)[2][4]) {
  a[0] = ptt::pack_bf16(c[0][0], c[0][1]);
  a[1] = ptt::pack_bf16(c[0][2], c[0][3]);
  a[2] = ptt::pack_bf16(c[1][0], c[1][1]);
  a[3] = ptt::pack_bf16(c[1][2], c[1][3]);
}

// As c_to_a, split in two bf16 parts: hi = round(c), lo = round(c - hi),
// which carry c to about 2^-17 of itself.
__device__ __forceinline__ void split2(uint32_t& hi, uint32_t& lo, float x,
                                       float y) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
  const float2 hf = __bfloat1622float2(h);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = ptt::pack_bf16(x - hf.x, y - hf.y);
}
__device__ __forceinline__ void c_to_a_split(uint32_t (&hi)[4],
                                             uint32_t (&lo)[4],
                                             const float (&c)[2][4]) {
  split2(hi[0], lo[0], c[0][0], c[0][1]);
  split2(hi[1], lo[1], c[0][2], c[0][3]);
  split2(hi[2], lo[2], c[1][0], c[1][1]);
  split2(hi[3], lo[3], c[1][2], c[1][3]);
}

// acc[n] += A . B over k = the 16 rows of B at b: B stored [k][8*NN] row-
// major (dO or Q rows for dV / dK, K rows for dQ); its B fragments come by
// ldmatrix.trans
template <int NN>
__device__ __forceinline__ void mma_ab(float (&acc)[NN][4],
                                       const uint32_t (&a)[4], const bf16* b,
                                       int ld, int lane) {
#pragma unroll
  for (int np = 0; np < NN / 2; ++np) {
    uint32_t f[4];
    ptt::ldmatrix_x4_trans(f, b + ptt::ldm_row_a(lane) * ld + np * 16 +
                                  ptt::ldm_col_a(lane));
    ptt::mma_bf16(acc[2 * np], a, f[0], f[1]);
    ptt::mma_bf16(acc[2 * np + 1], a, f[2], f[3]);
  }
}

// The same with A in two parts, hi + lo, over one load of B's fragments.
template <int NN>
__device__ __forceinline__ void mma_ab2(float (&acc)[NN][4],
                                        const uint32_t (&hi)[4],
                                        const uint32_t (&lo)[4],
                                        const bf16* b, int ld, int lane) {
#pragma unroll
  for (int np = 0; np < NN / 2; ++np) {
    uint32_t f[4];
    ptt::ldmatrix_x4_trans(f, b + ptt::ldm_row_a(lane) * ld + np * 16 +
                                  ptt::ldm_col_a(lane));
    ptt::mma_bf16(acc[2 * np], hi, f[0], f[1]);
    ptt::mma_bf16(acc[2 * np], lo, f[0], f[1]);
    ptt::mma_bf16(acc[2 * np + 1], hi, f[2], f[3]);
    ptt::mma_bf16(acc[2 * np + 1], lo, f[2], f[3]);
  }
}

// ---------------------------------------------------------------------------
// float32 instances (the parity configurations): 4 warps of 16 rows over
// 64-row tiles staged by plain 16-byte copies, products on the CUDA cores
// ---------------------------------------------------------------------------

constexpr int kF32Rows = 64;
constexpr int kF32Threads = 128;

// rows [row0, row0 + 64) of a [T, HD] float32 slice (row stride ld) into
// shared memory with row stride LD; rows >= T read zero
template <int HD, int LD>
__device__ __forceinline__ void load_tile_f32(float* __restrict__ s,
                                              const float* __restrict__ g,
                                              long long ld, int row0,
                                              int T_len) {
  constexpr int kPerRow = HD / 4;
  for (int i = threadIdx.x; i < kF32Rows * kPerRow; i += kF32Threads) {
    const int r = i / kPerRow, c = (i % kPerRow) * 4;
    float4 val = make_float4(0.f, 0.f, 0.f, 0.f);
    if (row0 + r < T_len)
      val = *reinterpret_cast<const float4*>(
          g + static_cast<long long>(row0 + r) * ld + c);
    *reinterpret_cast<float4*>(s + r * LD + c) = val;
  }
}

// One warp: acc[n] += A[16 x K] . B[K x 8*NT], both in shared memory, with
// A(m, k) = A[m*ASM + k*ASK] and B(k, n) = B[k*BSK + n*BSN]; acc[n] holds
// (g, 8n+2t), (g, 8n+2t+1), (g+8, 8n+2t), (g+8, 8n+2t+1) (lane = 4g + t).
template <int NT, int K, int ASM, int ASK, int BSK, int BSN>
__device__ __forceinline__ void warp_mma_f32(float (&acc)[NT][4],
                                             const float* __restrict__ A,
                                             const float* __restrict__ B) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll 4
  for (int k = 0; k < K; ++k) {
    const float a0 = A[g * ASM + k * ASK];
    const float a1 = A[(g + 8) * ASM + k * ASK];
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      const float b0 = B[k * BSK + (8 * n + 2 * t) * BSN];
      const float b1 = B[k * BSK + (8 * n + 2 * t + 1) * BSN];
      acc[n][0] += a0 * b0;
      acc[n][1] += a0 * b1;
      acc[n][2] += a1 * b0;
      acc[n][3] += a1 * b1;
    }
  }
}

// head_dim -> a kernel instance (launch<HD>), or cudaErrorInvalidValue
template <typename F>
int by_head_dim(int hd, F&& f) {
  switch (hd) {
    case 16:
      return f(std::integral_constant<int, 16>());
    case 32:
      return f(std::integral_constant<int, 32>());
    case 64:
      return f(std::integral_constant<int, 64>());
    case 128:
      return f(std::integral_constant<int, 128>());
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// set the dynamic shared memory a kernel needs (and the SM's split of
// shared memory and L1 to the most shared, so that 3 or 4 blocks of 55-75
// KB fit an SM), launch it, and return the launch's error code
template <typename K>
int launch_kernel(K kern, dim3 grid, int threads, size_t smem,
                  cudaStream_t stream, const Args& a) {
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(kern,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return static_cast<int>(err);
  kern<<<grid, threads, smem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace fbwd
