// Vocab-chunked cross-entropy, forward statistics.
//
// Replaces: _ce_fwd_kernel, paddle_tpu/ops/pallas_kernels.py:537 (called
// through _ce_fwd_pallas :586-630 for each row chunk of chunked_lm_loss).
// For hidden rows x [n, D] and a projection head (layout "dv": [D, Vp];
// "vd": [Vp, D], e.g. a tied embedding), per row r:
//   logits = x[r] . head (+ bias), float32; columns >= vocab masked out
//   lse[r]  = log(sum_c exp(logits_c))       (online, over vocab tiles)
//   gold[r] = logits[labels[r]]              (the bias term included)
// The product is computed inside this kernel: the bf16 instance on the
// tensor cores (WMMA 16x16x16, bf16 inputs, float32 accumulation), the
// float32 instance on the CUDA cores (float32 fused multiply-adds).
//
// What bounds it on the card: operations. At the training shape (2048
// rows of D = 768 against 51,200 columns, bf16) it does 2 * 2048 * 768 *
// 51200 = 1.61e11 operations on ~82 MB of inputs; the 989 TFLOP/s bf16
// peak bounds it, not HBM.
//
// Design. The TPU grid walks the vocab as its sequential axis, carrying
// (max, sum, gold) in VMEM scratch. Here a block takes a 64-row tile and
// walks a contiguous range of 128-column vocab tiles in order, keeping
// the running (max, sum, gold) of each row in registers (four threads a
// row, replicated); for each vocab tile the product runs over D in
// 32-deep slices staged in shared memory, the 64 x 128 float32 tile is
// written to shared memory, and the online-logsumexp update reads it
// there. Blocks run in parallel, and 2048 rows make only 32 row tiles
// for 132 SMs, so the vocab is split into `nsplit` ranges, one block per
// (row tile, range): each writes its partial (max, sum, gold) and a
// second kernel merges the ranges row by row, in order. Simple and right
// first: no cp.async pipeline, no wgmma/TMA yet.
#include <mma.h>

#include <type_traits>

#include "common.cuh"

namespace {

using namespace nvcuda;

constexpr int kThreads = 256;  // 8 warps
constexpr int BM = 64, BN = 128, BK = 32;
constexpr int kLdC = BN + 4;   // float32 tile row stride (floats)

template <typename T, bool kVD>
struct Tile {
  static constexpr int kVec = 16 / sizeof(T);  // elements a 16-byte load
  static constexpr int kLdA = BK + kVec;       // 16 bytes of row padding
  static constexpr int kLdB = kVD ? BK + kVec : BN + kVec;
  static constexpr int kABytes = BM * kLdA * sizeof(T);
  static constexpr int kBBytes = (kVD ? BN : BK) * kLdB * sizeof(T);
  static constexpr int kCBytes = BM * kLdC * sizeof(float);
  static constexpr int kBytes =
      kABytes + kBBytes > kCBytes ? kABytes + kBBytes : kCBytes;
};

// x rows [row0, row0 + BM) x depth [k0, k0 + BK) -> As[BM][kLdA]; head
// depth [k0, k0 + BK) x columns [n0, n0 + BN) -> Bs, row-major [BK][kLdB]
// ("dv") or column-major [BN][kLdB] ("vd"). Out-of-range vectors are zero.
template <typename T, bool kVD>
__device__ __forceinline__ void load_tiles(const T* __restrict__ x,
                                           const T* __restrict__ head,
                                           T* As, T* Bs, int row0, int n0,
                                           int k0, int n, int D, int Vp,
                                           int ldh) {
  using TL = Tile<T, kVD>;
  constexpr int V = TL::kVec;
  const uint4 zero = make_uint4(0u, 0u, 0u, 0u);
  for (int v = threadIdx.x; v < BM * BK / V; v += kThreads) {
    const int r = v / (BK / V), kv = (v % (BK / V)) * V;
    const int gr = row0 + r, gk = k0 + kv;
    *reinterpret_cast<uint4*>(As + r * TL::kLdA + kv) =
        (gr < n && gk < D)
            ? *reinterpret_cast<const uint4*>(x + static_cast<size_t>(gr) * D
                                              + gk)
            : zero;
  }
  if (!kVD) {
    for (int v = threadIdx.x; v < BK * BN / V; v += kThreads) {
      const int kr = v / (BN / V), cv = (v % (BN / V)) * V;
      const int gk = k0 + kr, gc = n0 + cv;
      *reinterpret_cast<uint4*>(Bs + kr * TL::kLdB + cv) =
          (gk < D && gc < Vp)
              ? *reinterpret_cast<const uint4*>(
                    head + static_cast<size_t>(gk) * ldh + gc)
              : zero;
    }
  } else {
    for (int v = threadIdx.x; v < BN * BK / V; v += kThreads) {
      const int c = v / (BK / V), kv = (v % (BK / V)) * V;
      const int gc = n0 + c, gk = k0 + kv;
      *reinterpret_cast<uint4*>(Bs + c * TL::kLdB + kv) =
          (gc < Vp && gk < D)
              ? *reinterpret_cast<const uint4*>(
                    head + static_cast<size_t>(gc) * ldh + gk)
              : zero;
    }
  }
}

// The [BM, BN] float32 product of row tile row0 and vocab tile n0, left in
// Cs[BM][kLdC] (which aliases the A/B staging buffers).
template <typename T, bool kVD>
__device__ __forceinline__ void tile_product(const T* __restrict__ x,
                                             const T* __restrict__ head,
                                             unsigned char* smem, int row0,
                                             int n0, int n, int D, int Vp,
                                             int ldh) {
  using TL = Tile<T, kVD>;
  T* As = reinterpret_cast<T*>(smem);
  T* Bs = reinterpret_cast<T*>(smem + TL::kABytes);
  float* Cs = reinterpret_cast<float*>(smem);
  const int warp = threadIdx.x >> 5;
  if constexpr (sizeof(T) == 2) {
    // 8 warps as 2 x 4, each a 32 x 32 block of four 16 x 16 fragments
    const int wm = warp >> 2, wn = warp & 3;
    using BLayout =
        typename std::conditional<kVD, wmma::col_major, wmma::row_major>::type;
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][2];
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.f);
    for (int k0 = 0; k0 < D; k0 += BK) {
      load_tiles<T, kVD>(x, head, As, Bs, row0, n0, k0, n, D, Vp, ldh);
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < BK; kk += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                       wmma::row_major> a[2];
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, BLayout>
            b[2];
#pragma unroll
        for (int i = 0; i < 2; ++i)
          wmma::load_matrix_sync(a[i], As + (wm * 32 + i * 16) * TL::kLdA + kk,
                                 TL::kLdA);
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int c = wn * 32 + j * 16;
          wmma::load_matrix_sync(
              b[j], kVD ? Bs + c * TL::kLdB + kk : Bs + kk * TL::kLdB + c,
              TL::kLdB);
        }
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int j = 0; j < 2; ++j)
            wmma::mma_sync(acc[i][j], a[i], b[j], acc[i][j]);
      }
      __syncthreads();
    }
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j)
        wmma::store_matrix_sync(
            Cs + (wm * 32 + i * 16) * kLdC + wn * 32 + j * 16, acc[i][j],
            kLdC, wmma::mem_row_major);
  } else {
    // float32 on the CUDA cores: warp w owns rows 8w..8w+7, lane l the
    // columns l, l + 32, l + 64, l + 96
    const int lane = threadIdx.x & 31;
    float acc[8][4];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
    for (int k0 = 0; k0 < D; k0 += BK) {
      load_tiles<T, kVD>(x, head, As, Bs, row0, n0, k0, n, D, Vp, ldh);
      __syncthreads();
      for (int kk = 0; kk < BK; ++kk) {
        float a[8], b[4];
#pragma unroll
        for (int i = 0; i < 8; ++i) a[i] = As[(warp * 8 + i) * TL::kLdA + kk];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int c = lane + 32 * j;
          b[j] = kVD ? Bs[c * TL::kLdB + kk] : Bs[kk * TL::kLdB + c];
        }
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
      }
      __syncthreads();
    }
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        Cs[(warp * 8 + i) * kLdC + lane + 32 * j] = acc[i][j];
  }
  __syncthreads();
}

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

template <typename T, bool kVD>
__global__ void __launch_bounds__(kThreads)
    ce_fwd_kernel(const T* __restrict__ x, const T* __restrict__ head,
                  const float* __restrict__ bias,
                  const int* __restrict__ labels, float* __restrict__ m_part,
                  float* __restrict__ s_part, float* __restrict__ g_part,
                  int n, int D, int Vp, int ldh, int vocab,
                  int tiles_per_split) {
  __shared__ __align__(128) unsigned char smem[Tile<T, kVD>::kBytes];
  const float* Cs = reinterpret_cast<const float*>(smem);
  const int row0 = blockIdx.x * BM, split = blockIdx.y;
  const int ntiles = (Vp + BN - 1) / BN;
  const int t0 = split * tiles_per_split;
  const int t1 = min(ntiles, t0 + tiles_per_split);
  // four threads a row: thread q of row r reads columns q, q + 4, ...
  const int r = threadIdx.x >> 2, q = threadIdx.x & 3;
  const int grow = row0 + r;
  const int lab = grow < n ? labels[grow] : -1;
  float m = -CUDART_INF_F, s = 0.f, gold = 0.f;
  for (int t = t0; t < t1; ++t) {
    const int n0 = t * BN;
    tile_product<T, kVD>(x, head, smem, row0, n0, n, D, Vp, ldh);
    float c[BN / 4];
    float tmax = -CUDART_INF_F;
#pragma unroll
    for (int j = 0; j < BN / 4; ++j) {
      const int col = n0 + q + 4 * j;
      c[j] = -CUDART_INF_F;
      if (col < vocab) {
        c[j] = Cs[r * kLdC + q + 4 * j] + (bias ? bias[col] : 0.f);
        tmax = fmaxf(tmax, c[j]);
        if (col == lab) gold += c[j];
      }
    }
    const float m_new = fmaxf(m, quad_max(tmax));
    float p = 0.f;
    if (m_new != -CUDART_INF_F) {
#pragma unroll
      for (int j = 0; j < BN / 4; ++j) p += expf(c[j] - m_new);
    }
    p = quad_sum(p);
    s = (m == -CUDART_INF_F ? 0.f : s * expf(m - m_new)) + p;
    m = m_new;
    __syncthreads();  // Cs is the next tile's staging buffer
  }
  gold = quad_sum(gold);
  if (q == 0 && grow < n) {
    const size_t o = static_cast<size_t>(split) * n + grow;
    m_part[o] = m;
    s_part[o] = s;
    g_part[o] = gold;
  }
}

// Merge the vocab ranges of each row in order: lse = M + log(sum_j s_j *
// exp(m_j - M)) with M the largest m_j; gold = sum_j gold_j.
__global__ void ce_fwd_merge_kernel(const float* __restrict__ m_part,
                                    const float* __restrict__ s_part,
                                    const float* __restrict__ g_part,
                                    float* __restrict__ lse,
                                    float* __restrict__ gold, int n,
                                    int nsplit) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= n) return;
  float M = -CUDART_INF_F;
  for (int j = 0; j < nsplit; ++j) M = fmaxf(M, m_part[j * n + r]);
  float S = 0.f, G = 0.f;
  for (int j = 0; j < nsplit; ++j) {
    const float mj = m_part[j * n + r];
    if (mj != -CUDART_INF_F) S += s_part[j * n + r] * expf(mj - M);
    G += g_part[j * n + r];
  }
  lse[r] = M + logf(S);
  gold[r] = G;
}

template <typename T, bool kVD>
int launch(const void* x, const void* head, const void* bias,
           const void* labels, void* lse, void* gold, void* scratch, int n,
           int D, int Vp, int ldh, int vocab, int nsplit,
           cudaStream_t stream) {
  const int ntiles = (Vp + BN - 1) / BN;
  const int per = (ntiles + nsplit - 1) / nsplit;
  float* part = static_cast<float*>(scratch);
  const size_t np = static_cast<size_t>(nsplit) * n;
  const dim3 grid((n + BM - 1) / BM, nsplit);
  ce_fwd_kernel<T, kVD><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(head),
      static_cast<const float*>(bias), static_cast<const int*>(labels), part,
      part + np, part + 2 * np, n, D, Vp, ldh, vocab, per);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  ce_fwd_merge_kernel<<<(n + 255) / 256, 256, 0, stream>>>(
      part, part + np, part + 2 * np, static_cast<float*>(lse),
      static_cast<float*>(gold), n, nsplit);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x: [n, D] contiguous; head: "dv" (vd = 0) [D, Vp] with row stride ldh,
// or "vd" (vd = 1) [Vp, D] with row stride ldh; both in `dtype`, 16-byte
// aligned, with D and ldh multiples of 16 bytes' worth of elements. bias:
// [Vp] float32 or null; labels: [n] int32 in [0, vocab); lse, gold: [n]
// float32; scratch: [3, nsplit, n] float32. Columns >= vocab are masked.
extern "C" int ptt_ce_fwd(const void* x, const void* head, const void* bias,
                          const void* labels, void* lse, void* gold,
                          void* scratch, int n, int D, int Vp, int ldh,
                          int vocab, int vd, int nsplit, int dtype,
                          void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (n < 1 || D < 1 || Vp < 1 || nsplit < 1 || vocab > Vp)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto a = [&](auto tag, auto layout) {
    using T = decltype(tag);
    return launch<T, decltype(layout)::value>(x, head, bias, labels, lse,
                                              gold, scratch, n, D, Vp, ldh,
                                              vocab, nsplit, st);
  };
  using DV = std::false_type;
  using VD = std::true_type;
  switch (dtype) {
    case ptt::kF32:
      return vd ? a(float{}, VD{}) : a(float{}, DV{});
    case ptt::kBF16:
      return vd ? a(__nv_bfloat16{}, VD{}) : a(__nv_bfloat16{}, DV{});
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
