// The split route of the three flash kernels: every head dim past 128.
//
// Replaces, for hd > 128: _fwd_kernel, _bwd_dq_kernel and _bwd_dkv_kernel
// (paddle_tpu/ops/pallas_kernels.py:74, :205, :261), whose blocks span the
// whole head dim (past 128 they take whole multiples of 128: _bcast_lanes
// :55; this route takes any hd). Head dims up to 128 keep their instances
// in flash_fwd.cu, flash_bwd_dq.cu and flash_bwd_dkv.cu; those files send
// hd > 128 here, in both forms (bias-free and bias).
//
// What bounds it on the card: at [16, 1024, 8, 256] causal the forward
// moves 269 MB and does 68.8 GFLOP, so the bytes bound it (0.080 ms; the
// products 0.070 ms at 989 TFLOP/s). This first design runs on the CUDA
// cores, its products held by shared-memory reads (18 words a lane for 32
// FMAs a k-step): on an H100 at 700 W, 10.5 ms forward, 20.9 dQ, 29.6
// dK/dV against SDPA's 0.153 forward and 0.739 backward (PERF.md).
//
// What they compute is what the narrow instances compute (and what the
// plain versions in ops/flash_attention.py compute): s = q.k^T * scale
// (+ bias), causal entries and keys past T replaced by -0.7*FLT_MAX, an
// online softmax in float32, P rounded to v's dtype before P.V; dQ from
// dS = P*(dP - D)*scale rounded to k's dtype; dK from dS in float32 (the
// narrow bf16 instance carries dS as two bf16 parts, about 2^-17 of it;
// here it stays float32, as the plain version keeps it), dV from P
// rounded to dO's dtype. Exponentials are expf in natural units.
//
// Design: split the head dim. A grid dimension (z) walks the output
// columns in blocks of kC = 64; each block computes the reductions over
// hd (S = q.k^T, dP = dO.v^T, D = rowsum(dO*o)) in a loop over 64-column
// slabs of its operands, staged through shared memory as float32, and
// accumulates only its own output columns (o; dQ; dK and dV). S and dP
// are recomputed once a column block. Registers and shared memory do not
// depend on hd, so one instance a dtype serves every hd, and any hd (not
// only multiples of 16) is taken as it is: columns past hd load zeros.
// Products run on the CUDA cores in float32 (4 warps of 16 rows, 64-row
// tiles), one tile at a time with no copy ring: this route is right and
// simple first; its times at hd 256 are in PERF.md.
#pragma once

#include "common.cuh"

namespace fwide {
namespace {   // each source that includes this instantiates its own kernel

constexpr int kB = 64;          // rows of a query or key tile
constexpr int kC = 64;          // columns of a slab and of a column block
constexpr int kL = kC + 4;      // row stride of every staged tile (floats)
constexpr int kTile = kB * kL;  // floats of one staged tile
constexpr int kThreads = 128;   // 4 warps of 16 rows
constexpr float kNegInf = -0.7f * 3.402823466e38f;   // _NEG_INF

struct Args {
  const void *q, *k, *v;        // [B, T, nh, hd] through (sb, st, sh)
  const void *o, *dout;         // contiguous [B, T, nh, hd]
  const float* lse;             // [B, nh, T]
  float* di;                    // D [B, nh, T]: dQ writes it if set,
                                // dK/dV reads it
  const float* bias;            // [BB, bias_rows, T] float32 or nullptr
  void *out0, *out1;            // fwd: o, lse; dq: dq; dkv: dk, dv
  int T, nh, hd;
  long long sb, st, sh;         // q/k/v strides (elements)
  float scale;
  int causal, bias_heads, bias_rows;
};

// A [T, hd] matrix of one (batch, head): element (r, c) at p[r * ld + c].
template <typename T>
struct Mat {
  const T* p;
  long long ld;
};

template <typename T>
__device__ __forceinline__ Mat<T> strided(const void* base, const Args& a,
                                          int b, int h) {
  return {static_cast<const T*>(base) + b * a.sb + h * a.sh, a.st};
}

template <typename T>
__device__ __forceinline__ Mat<T> packed(const void* base, const Args& a,
                                         int b, int h) {
  return {static_cast<const T*>(base) +
              (static_cast<long long>(b) * a.T * a.nh + h) * a.hd,
          static_cast<long long>(a.nh) * a.hd};
}

// rows [row0, row0 + kB) x columns [col0, col0 + kC) of m into s (row
// stride kL) as float32; entries at rows >= T or columns >= hd are zeros
template <typename T>
__device__ __forceinline__ void load_tile(float* __restrict__ s, Mat<T> m,
                                          int row0, int col0,
                                          const Args& a) {
  for (int i = threadIdx.x; i < kB * kC; i += kThreads) {
    const int r = i / kC, c = i % kC;
    const bool in = row0 + r < a.T && col0 + c < a.hd;
    s[r * kL + c] =
        in ? ptt::to_f32(m.p[static_cast<long long>(row0 + r) * m.ld + col0 +
                             c])
           : 0.f;
  }
}

// One warp: acc[n] += A[16 x kC] . B[kC x 64] from shared memory, with
// A(m, k) = A[m * kL + k] and B(k, n) = B[k * BSK + n * BSN]; acc[n][e]
// holds row g + 8 (e >> 1), column 8 n + 2 t + (e & 1) (lane = 4 g + t).
template <int BSK, int BSN>
__device__ __forceinline__ void warp_mma(float (&acc)[8][4],
                                         const float* __restrict__ A,
                                         const float* __restrict__ B) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll 4
  for (int k = 0; k < kC; ++k) {
    const float a0 = A[g * kL + k];
    const float a1 = A[(g + 8) * kL + k];
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      const float b0 = B[k * BSK + (8 * n + 2 * t) * BSN];
      const float b1 = B[k * BSK + (8 * n + 2 * t + 1) * BSN];
      acc[n][0] = fmaf(a0, b0, acc[n][0]);
      acc[n][1] = fmaf(a0, b1, acc[n][1]);
      acc[n][2] = fmaf(a1, b0, acc[n][2]);
      acc[n][3] = fmaf(a1, b1, acc[n][3]);
    }
  }
}

// acc = X[x0 .. x0+63] . Y[y0 .. y0+63]^T over all hd columns, in slabs of
// kC through sx and sy; each warp takes its 16 rows of X. Block-wide: every
// thread calls it (it holds the barriers).
template <typename T>
__device__ __forceinline__ void slab_product(float (&acc)[8][4], float* sx,
                                             float* sy, Mat<T> x, int x0,
                                             Mat<T> y, int y0,
                                             const Args& a) {
  const int warp = threadIdx.x >> 5;
#pragma unroll
  for (int n = 0; n < 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
  for (int c0 = 0; c0 < a.hd; c0 += kC) {
    __syncthreads();            // the previous readers of sx, sy are done
    load_tile<T>(sx, x, x0, c0, a);
    load_tile<T>(sy, y, y0, c0, a);
    __syncthreads();
    warp_mma<1, kL>(acc, sx + warp * 16 * kL, sy);
  }
}

template <typename T>
__device__ __forceinline__ float round_to(float x) {
  return ptt::to_f32(ptt::from_f32<T>(x));
}

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// s * scale + bias at (query row, key col), then the mask: causal entries
// and keys past T -> kNegInf. The bias row is clamped into [0, T) for the
// padding rows of the last tile (their results are never stored).
__device__ __forceinline__ float logit(float s, int row, int col,
                                       const float* bias, const Args& a) {
  float x = s * a.scale;
  if (bias != nullptr && col < a.T)
    x += __ldg(bias + (a.bias_rows == 1 ? 0LL
                                        : static_cast<long long>(
                                              min(row, a.T - 1)) *
                                              a.T) +
               col);
  if ((a.causal && col > row) || col >= a.T) x = kNegInf;
  return x;
}

__device__ __forceinline__ const float* head_bias(const Args& a) {
  return a.bias == nullptr
             ? nullptr
             : a.bias + static_cast<long long>(blockIdx.y / a.bias_heads) *
                            a.bias_rows * a.T;
}

// stores acc (a warp's 16 rows x 64 columns of the block's column block)
// into a contiguous [B, T, nh, hd] output, rows < T and columns < hd
template <typename T>
__device__ __forceinline__ void store_rows(void* out, const float (&acc)[8][4],
                                           int row0, int col0, int b, int h,
                                           const Args& a, float mul0 = 1.f,
                                           float mul1 = 1.f) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  T* o = static_cast<T*>(out);
#pragma unroll
  for (int n = 0; n < 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int row = row0 + g + 8 * (e >> 1);
      const int col = col0 + 8 * n + 2 * t + (e & 1);
      if (row < a.T && col < a.hd)
        o[((static_cast<long long>(b) * a.T + row) * a.nh + h) * a.hd + col] =
            ptt::from_f32<T>(acc[n][e] * (e >> 1 ? mul1 : mul0));
    }
}

// ---------------------------------------------------------------------------
// forward: grid (query tiles, B*nh, column blocks); o's columns of this
// block's column block, and lse from column block 0
// ---------------------------------------------------------------------------
template <typename T>
__global__ void __launch_bounds__(kThreads) fwd_kernel(Args a) {
  extern __shared__ __align__(16) float sm[];
  float *sx = sm, *sy = sx + kTile, *sp = sy + kTile, *sc = sp + kTile;
  const int qi = gridDim.x - 1 - blockIdx.x;   // diagonal-heavy first
  const int b = blockIdx.y / a.nh, h = blockIdx.y % a.nh;
  const int col0 = blockIdx.z * kC;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int q0 = qi * kB, w0 = q0 + warp * 16;
  const Mat<T> q = strided<T>(a.q, a, b, h), k = strided<T>(a.k, a, b, h),
               v = strided<T>(a.v, a, b, h);
  const float* bias = head_bias(a);
  const int nk_all = (a.T + kB - 1) / kB;
  const int nk = a.causal ? min(nk_all, qi + 1) : nk_all;
  float* pw = sp + warp * 16 * kL;

  float acc[8][4] = {}, m[2] = {-CUDART_INF_F, -CUDART_INF_F},
        l[2] = {0.f, 0.f};
  for (int j = 0; j < nk; ++j) {
    const int k0 = j * kB;
    float s[8][4];
    slab_product<T>(s, sx, sy, q, q0, k, k0, a);
    float mc[2] = {-CUDART_INF_F, -CUDART_INF_F};
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[n][e] = logit(s[n][e], w0 + g + 8 * (e >> 1),
                        k0 + 8 * n + 2 * t + (e & 1), bias, a);
        mc[e >> 1] = fmaxf(mc[e >> 1], s[n][e]);
      }
    float alpha[2], rs[2] = {0.f, 0.f};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float mn = fmaxf(m[r], quad_max(mc[r]));
      alpha[r] = expf(m[r] - mn);            // 0 while m is -inf
      m[r] = mn;
    }
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = expf(s[n][e] - m[e >> 1]);
        rs[e >> 1] += p;
        pw[(g + 8 * (e >> 1)) * kL + 8 * n + 2 * t + (e & 1)] =
            round_to<T>(p);
      }
#pragma unroll
    for (int r = 0; r < 2; ++r) l[r] = alpha[r] * l[r] + quad_sum(rs[r]);
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[n][e] *= alpha[e >> 1];
    __syncthreads();            // every warp is done with the last V block
    load_tile<T>(sc, v, k0, col0, a);
    __syncthreads();            // and this warp's P rows are written
    warp_mma<kL, 1>(acc, pw, sc);
  }
  const float inv0 = l[0] == 0.f ? 1.f : 1.f / l[0];
  const float inv1 = l[1] == 0.f ? 1.f : 1.f / l[1];
  store_rows<T>(a.out0, acc, w0, col0, b, h, a, inv0, inv1);
  if (blockIdx.z == 0 && t == 0) {
    float* lse = static_cast<float*>(a.out1);
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = w0 + g + 8 * r;
      if (row < a.T)
        lse[static_cast<long long>(blockIdx.y) * a.T + row] =
            m[r] + logf(l[r] == 0.f ? 1.f : l[r]);
    }
  }
}

// D = rowsum(dO * o) over all hd, and lse, for the 64 query rows at q0
// into sd, sl (0 past T); with dst, D is also stored there (rows < T)
template <typename T>
__device__ __forceinline__ void row_stats(float* sd, float* sl, Mat<T> o,
                                          Mat<T> dout, int q0, float* dst,
                                          const Args& a) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int r = warp; r < kB; r += kThreads / 32) {
    const int row = q0 + r;
    float d = 0.f;
    if (row < a.T) {
      const long long ro = static_cast<long long>(row) * o.ld;
      const long long rd = static_cast<long long>(row) * dout.ld;
      for (int c = lane; c < a.hd; c += 32)
        d = fmaf(ptt::to_f32(dout.p[rd + c]), ptt::to_f32(o.p[ro + c]), d);
    }
    d = ptt::warp_sum(d);
    if (lane == 0) {
      const long long at = static_cast<long long>(blockIdx.y) * a.T + row;
      sd[r] = d;
      sl[r] = row < a.T ? a.lse[at] : 0.f;
      if (dst != nullptr && row < a.T) dst[at] = d;
    }
  }
}

// ---------------------------------------------------------------------------
// dQ: grid (query tiles, B*nh, column blocks); dq's columns of this block's
// column block; with di set, column block 0 also writes D
// ---------------------------------------------------------------------------
template <typename T>
__global__ void __launch_bounds__(kThreads) dq_kernel(Args a) {
  extern __shared__ __align__(16) float sm[];
  float *sx = sm, *sy = sx + kTile, *sp = sy + kTile, *sc = sp + kTile;
  float *sd = sc + kTile, *sl = sd + kB;
  const int qi = gridDim.x - 1 - blockIdx.x;
  const int b = blockIdx.y / a.nh, h = blockIdx.y % a.nh;
  const int col0 = blockIdx.z * kC;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int q0 = qi * kB, w0 = q0 + warp * 16;
  const Mat<T> q = strided<T>(a.q, a, b, h), k = strided<T>(a.k, a, b, h),
               v = strided<T>(a.v, a, b, h);
  const Mat<T> o = packed<T>(a.o, a, b, h), dout = packed<T>(a.dout, a, b, h);
  const float* bias = head_bias(a);
  const int nk_all = (a.T + kB - 1) / kB;
  const int nk = a.causal ? min(nk_all, qi + 1) : nk_all;
  float* pw = sp + warp * 16 * kL;

  row_stats<T>(sd, sl, o, dout, q0, blockIdx.z == 0 ? a.di : nullptr, a);
  // (slab_product's first barrier makes sd, sl visible)
  float acc[8][4] = {};
  for (int j = 0; j < nk; ++j) {
    const int k0 = j * kB;
    float s[8][4], dp[8][4];
    slab_product<T>(s, sx, sy, q, q0, k, k0, a);
    slab_product<T>(dp, sx, sy, dout, q0, v, k0, a);
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = warp * 16 + g + 8 * (e >> 1);
        const float x = logit(s[n][e], q0 + r, k0 + 8 * n + 2 * t + (e & 1),
                              bias, a);
        const float p = expf(x - sl[r]);
        pw[(g + 8 * (e >> 1)) * kL + 8 * n + 2 * t + (e & 1)] =
            round_to<T>(p * (dp[n][e] - sd[r]) * a.scale);
      }
    __syncthreads();
    load_tile<T>(sc, k, k0, col0, a);
    __syncthreads();
    warp_mma<kL, 1>(acc, pw, sc);
  }
  store_rows<T>(a.out0, acc, w0, col0, b, h, a);
}

// ---------------------------------------------------------------------------
// dK/dV: grid (key tiles, B*nh, column blocks); each warp holds 16 key rows
// of S^T and dP^T over a query tile, and accumulates dK's and dV's columns
// of this block's column block
// ---------------------------------------------------------------------------
template <typename T>
__global__ void __launch_bounds__(kThreads) dkv_kernel(Args a) {
  extern __shared__ __align__(16) float sm[];
  float *sx = sm, *sy = sx + kTile, *sp = sy + kTile, *ss = sp + kTile;
  float *sq = ss + kTile, *sdo = sq + kTile, *sd = sdo + kTile,
        *sl = sd + kB;
  const int kb = blockIdx.x;
  const int b = blockIdx.y / a.nh, h = blockIdx.y % a.nh;
  const int col0 = blockIdx.z * kC;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int k0 = kb * kB, w0 = k0 + warp * 16;
  const Mat<T> q = strided<T>(a.q, a, b, h), k = strided<T>(a.k, a, b, h),
               v = strided<T>(a.v, a, b, h);
  const Mat<T> dout = packed<T>(a.dout, a, b, h);
  const float* bias = head_bias(a);
  const int nq = (a.T + kB - 1) / kB;
  float* pw = sp + warp * 16 * kL;
  float* dsw = ss + warp * 16 * kL;

  float dk[8][4] = {}, dv[8][4] = {};
  for (int i = a.causal ? kb : 0; i < nq; ++i) {
    const int q0 = i * kB;
    // D and lse of this query tile (the previous readers passed the
    // barrier before the last Q/dO block load)
    for (int r = threadIdx.x; r < kB; r += kThreads) {
      const bool in = q0 + r < a.T;
      const long long at = static_cast<long long>(blockIdx.y) * a.T + q0 + r;
      sd[r] = in ? a.di[at] : 0.f;
      sl[r] = in ? a.lse[at] : 0.f;
    }
    float st[8][4], dpt[8][4];
    slab_product<T>(st, sx, sy, k, k0, q, q0, a);
    slab_product<T>(dpt, sx, sy, v, k0, dout, q0, a);
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = 8 * n + 2 * t + (e & 1);   // query of the tile
        const int key = w0 + g + 8 * (e >> 1);
        const float x = logit(st[n][e], q0 + c, key, bias, a);
        const float p = q0 + c < a.T ? expf(x - sl[c]) : 0.f;
        const int at = (g + 8 * (e >> 1)) * kL + c;
        pw[at] = round_to<T>(p);
        dsw[at] = p * (dpt[n][e] - sd[c]) * a.scale;
      }
    __syncthreads();
    load_tile<T>(sq, q, q0, col0, a);
    load_tile<T>(sdo, dout, q0, col0, a);
    __syncthreads();
    warp_mma<kL, 1>(dv, pw, sdo);
    warp_mma<kL, 1>(dk, dsw, sq);
  }
  store_rows<T>(a.out0, dk, w0, col0, b, h, a);
  store_rows<T>(a.out1, dv, w0, col0, b, h, a);
}

constexpr size_t kFwdSmem = 4 * kTile * sizeof(float);
constexpr size_t kDqSmem = (4 * kTile + 2 * kB) * sizeof(float);
constexpr size_t kDkvSmem = (6 * kTile + 2 * kB) * sizeof(float);

template <typename K>
int launch(K kern, int tiles, int bh, const Args& a, size_t smem,
           cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(tiles, bh, (a.hd + kC - 1) / kC);
  kern<<<grid, kThreads, smem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// kWhich: 0 forward, 1 dQ, 2 dK/dV; dtype: ptt::kF32 or ptt::kBF16
template <int kWhich>
int run(int dtype, const Args& a, int B, cudaStream_t stream) {
  if (a.hd < 1 || a.hd > 65535 * kC || B < 1 || a.T < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const int tiles = (a.T + kB - 1) / kB, bh = B * a.nh;
  const auto go = [&](auto tag) -> int {
    using T = decltype(tag);
    if constexpr (kWhich == 0)
      return launch(fwd_kernel<T>, tiles, bh, a, kFwdSmem, stream);
    else if constexpr (kWhich == 1)
      return launch(dq_kernel<T>, tiles, bh, a, kDqSmem, stream);
    else
      return launch(dkv_kernel<T>, tiles, bh, a, kDkvSmem, stream);
  };
  if (dtype == ptt::kF32) return go(float{});
  if (dtype == ptt::kBF16) return go(__nv_bfloat16{});
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace
}  // namespace fwide
