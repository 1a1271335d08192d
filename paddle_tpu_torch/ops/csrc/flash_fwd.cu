// FlashAttention-2 forward for training, laid out for Hopper.
//
// Replaces: _fwd_kernel (paddle_tpu/ops/pallas_kernels.py:74, called at
// :176) in both its forms, causal or full: bias-free (the GPT training
// step) and with an additive float32 bias (:103-105, ERNIE's padding
// mask). dQ and dK/dV live in flash_bwd_dq.cu and flash_bwd_dkv.cu and
// read this kernel's o and lse.
//
// What it computes, as the Pallas kernel does: s = q.k^T * scale with f32
// sums, plus the bias; causal entries -> -0.7*FLT_MAX (replaced, not
// added); an online softmax in f32; P rounded to v's dtype before P.V;
// o = acc * (1/l) in q's dtype; lse = m + log(l) in natural-log units,
// with l == 0 -> 1. Bias-free, the exponentials are ex2.approx of one FMA,
// score * scale*log2(e) - m, with m carried in log2 units and turned back
// into natural units for lse. With a bias, s * scale + bias comes first,
// one FMA in natural units, and m stays in natural units: a padding bias
// of -0.5*FLT_MAX would overflow to -inf divided by the scale, and
// carried in log2 units a fully padded row's m and lse would differ from
// the scores they must cancel by more than exp takes.
//
// Layout: q, k, v are read in the public [B, T, nh, hd] layout through
// their strides (batch, seq, head; unit stride on hd); o is contiguous
// [B, T, nh, hd], lse [B, nh, T] float32.
//
// What bounds it on the card: at the training path's shape ([16, 1024,
// 12, 64], causal) it does 25.8 GFLOP on 100 MB, so the tensor cores
// bound it (about 0.026 ms at 989 TFLOP/s; the bytes 0.030 ms). Design:
//   - 128 query rows a block; bf16 at head_dim <= 64: 4 warps of 32 rows
//     (two m-tiles, so every K/V fragment read from shared memory feeds
//     two products; 5-7% faster on the H100 than 8 warps of 16 rows);
//     otherwise 8 warps of 16 rows; heaviest (diagonal-rich) blocks
//     launch first;
//   - Q is staged once through cp.async and each warp's A fragments are
//     loaded by ldmatrix into registers for the whole key loop;
//   - 64-row K/V tiles arrive through a cp.async ring of 3 stages (bf16,
//     head_dim <= 64; else 2): the copy of tile j+S-1 starts right
//     after the one barrier of tile j and overlaps the math of tiles
//     j..j+S-2;
//   - K's B fragments come by ldmatrix, V's by ldmatrix.trans, from rows
//     padded by 16 bytes (free of bank conflicts);
//   - P stays in registers: the f32 C fragments of S over two 8-key tiles,
//     packed to bf16 pairs, are the A fragment of P.V over those 16 keys;
//   - the causal mask is applied only on tiles that cross a warp's
//     diagonal or the sequence end; a tile wholly above a warp's rows is
//     skipped by that warp (its p would be exactly 0).
// float32 inputs (the parity configuration) keep the ring and the tiling
// on the CUDA cores: S from shared memory, P.V with P broadcast across
// the 4 lanes of a row by shuffles.
//
// The bias is float32 [BB, SQ, T], contiguous: head bh reads bias row
// bh / bias_heads (bias_heads = nh when one bias serves all of a batch
// row's heads, else 1), and SQ (bias_rows) is 1, a row-broadcast padding
// mask, or T. It is added on every tile. With SQ = 1 a tile's 64 values
// ride the cp.async ring with its K and V, so their latency hides under
// the math of earlier tiles, and every row of the block reads them from
// shared memory; with SQ = T each value is read from global memory where
// it is added (off ERNIE's path). The bias is
// a template flag (16 instances): as a runtime test it cost the bias-free
// form 57% on the H100 at [16, 1024, 12, 64] causal (254 registers a
// thread; PERF.md).
#include <cstdint>
#include <type_traits>

#include "common.cuh"
#include "flash_wide.cuh"
#include "mma.cuh"

namespace {

constexpr int kBM = 128;              // query rows a block
constexpr int kBN = 64;               // key rows a tile
constexpr float kNegInf = -0.7f * 3.402823466e38f;   // _NEG_INF
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

using bf16 = __nv_bfloat16;

struct Args {
  const void *q, *k, *v;
  void *o, *lse;
  const float* bias;            // [BB, bias_rows, T] float32 or nullptr
  int T, nh;
  long long sb, st, sh;         // q/k/v strides (elements)
  float scale;
  int causal;
  int bias_heads, bias_rows;
};

// Per instance: MT 16-row m-tiles a warp (bf16 hd <= 64: 2, so each K/V
// fragment read from shared memory feeds two products; else 1) and the
// ring's depth.
template <typename T, int HD>
struct Lay {
  static constexpr bool kBF16 = std::is_same<T, bf16>::value;
  static constexpr int MT = kBF16 && HD <= 64 ? 2 : 1;
  static constexpr int kWarps = kBM / (16 * MT);
  static constexpr int kThreads = kWarps * 32;
  static constexpr int kStages = kBF16 && HD <= 64 ? 3 : 2;
  static constexpr int kPad = 16 / sizeof(T);   // 16 bytes a row
  static constexpr int LD = HD + kPad;
  static constexpr int kQ = kBM * LD;
  static constexpr int kKV = kBN * LD;          // one of K, V
  // the ring's stages, then one [kBN] float32 bias row a stage (SQ = 1)
  static constexpr size_t kSmem = (kQ + kStages * 2 * kKV) * sizeof(T) +
                                  kStages * kBN * sizeof(float);
};

// bias columns [col0, col0 + kBN) of one row into shared memory through
// 4-byte cp.async (any T, any alignment); columns >= T zeros
__device__ __forceinline__ void load_bias_row(float* __restrict__ s,
                                              const float* __restrict__ g,
                                              int col0, int T_len) {
  if (threadIdx.x < kBN) {
    const bool in = col0 + threadIdx.x < T_len;
    ptt::cp_async4(s + threadIdx.x, g + (in ? col0 + threadIdx.x : 0),
                   in ? 4 : 0);
  }
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

// 2^x, flushing subnormal results to zero (p <= 1 here)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}
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

// Register tiles: m-tile mt of a warp holds rows w0 + 16 mt + g and
// w0 + 16 mt + g + 8 (r = 0, 1 below, the C fragment's e >> 1).
template <typename T, int HD, bool kBias>
__global__ void __launch_bounds__(Lay<T, HD>::kThreads,
                                  HD <= 64 ? 2 : 1)
    flash_fwd_kernel(Args a) {
  using L = Lay<T, HD>;
  constexpr int MT = L::MT, NT = L::kThreads, S = L::kStages;
  extern __shared__ __align__(16) unsigned char smem[];
  T* sQ = reinterpret_cast<T*>(smem);
  T* sKV = sQ + L::kQ;        // stage s: K at s * 2 * kKV, V kKV after it
  float* sBias = reinterpret_cast<float*>(sKV + S * 2 * L::kKV);
  const int nq = gridDim.x;
  const int qi = nq - 1 - blockIdx.x;   // diagonal-heavy blocks first
  const int b = blockIdx.y / a.nh, h = blockIdx.y % a.nh;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const long long base = b * a.sb + h * a.sh;
  const T* q = static_cast<const T*>(a.q) + base;
  const T* k = static_cast<const T*>(a.k) + base;
  const T* v = static_cast<const T*>(a.v) + base;
  const int q0 = qi * kBM;
  const int w0 = q0 + warp * 16 * MT;          // this warp's first row
  const int nk_all = (a.T + kBN - 1) / kBN;
  const int nk = a.causal ? min(nk_all, (q0 + kBM + kBN - 1) / kBN)
                          : nk_all;
  const float* bias = kBias ? a.bias + static_cast<long long>(
                                           blockIdx.y / a.bias_heads) *
                                           a.bias_rows * a.T
                            : nullptr;
  const bool bias_row = kBias && a.bias_rows == 1;   // staged in the ring

  // prologue: Q and K/V tiles 0..S-2, one group each tile (Q with tile 0)
  load_rows<T, HD, L::LD, NT>(sQ, q, a.st, q0, kBM, a.T);
#pragma unroll
  for (int j = 0; j < S - 1; ++j) {
    if (j < nk) {
      T* stage = sKV + j * 2 * L::kKV;
      load_rows<T, HD, L::LD, NT>(stage, k, a.st, j * kBN, kBN, a.T);
      load_rows<T, HD, L::LD, NT>(stage + L::kKV, v, a.st, j * kBN, kBN,
                                  a.T);
      if (bias_row) load_bias_row(sBias + j * kBN, bias, j * kBN, a.T);
    }
    ptt::cp_async_commit();
  }

  uint32_t qf[L::kBF16 ? MT : 1][L::kBF16 ? HD / 16 : 1][4];  // Q, A frags
  float acc[MT][HD / 8][4] = {};
  float m[MT][2], l[MT][2];   // m in log2 units (natural with a bias)
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      m[mt][r] = -CUDART_INF_F;
      l[mt][r] = 0.f;
    }
  const float sl2 = a.scale * kLog2e;
  const T* sQw = sQ + warp * 16 * MT * L::LD;

  for (int j = 0; j < nk; ++j) {
    ptt::cp_async_wait<S - 2>();
    __syncthreads();            // tile j landed; tile j-1's stage is free
    {
      const int jn = j + S - 1;
      if (jn < nk) {
        T* stage = sKV + (jn % S) * 2 * L::kKV;
        load_rows<T, HD, L::LD, NT>(stage, k, a.st, jn * kBN, kBN, a.T);
        load_rows<T, HD, L::LD, NT>(stage + L::kKV, v, a.st, jn * kBN, kBN,
                                    a.T);
        if (bias_row)
          load_bias_row(sBias + (jn % S) * kBN, bias, jn * kBN, a.T);
      }
      ptt::cp_async_commit();
    }
    if constexpr (L::kBF16) {
      if (j == 0) {
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
#pragma unroll
          for (int kd = 0; kd < HD / 16; ++kd)
            ptt::ldmatrix_x4(
                qf[mt][kd], sQw + (mt * 16 + ptt::ldm_row_a(lane)) * L::LD +
                                kd * 16 + ptt::ldm_col_a(lane));
      }
    }
    const int k0 = j * kBN;
    if (a.causal && k0 > w0 + 16 * MT - 1) continue;   // wholly above
    const T* sK = sKV + (j % S) * 2 * L::kKV;
    const T* sV = sK + L::kKV;

    // S = Q.K^T over this tile's 64 keys: s[mt][n] covers keys 8n..8n+7
    float s[MT][8][4] = {};
    if constexpr (L::kBF16) {
#pragma unroll
      for (int kd = 0; kd < HD / 16; ++kd)
#pragma unroll
        for (int np = 0; np < 4; ++np) {
          uint32_t kf[4];
          ptt::ldmatrix_x4(kf, sK + (np * 16 + ptt::ldm_row_b(lane)) * L::LD +
                                   kd * 16 + ptt::ldm_col_b(lane));
#pragma unroll
          for (int mt = 0; mt < MT; ++mt) {
            ptt::mma_bf16(s[mt][2 * np], qf[mt][kd], kf[0], kf[1]);
            ptt::mma_bf16(s[mt][2 * np + 1], qf[mt][kd], kf[2], kf[3]);
          }
        }
    } else {
#pragma unroll 4
      for (int d = 0; d < HD; ++d) {
        const float a0 = ptt::to_f32(sQw[g * L::LD + d]);
        const float a1 = ptt::to_f32(sQw[(g + 8) * L::LD + d]);
#pragma unroll
        for (int n = 0; n < 8; ++n) {
          const float b0 = ptt::to_f32(sK[(8 * n + 2 * t) * L::LD + d]);
          const float b1 = ptt::to_f32(sK[(8 * n + 2 * t + 1) * L::LD + d]);
          s[0][n][0] += a0 * b0;
          s[0][n][1] += a0 * b1;
          s[0][n][2] += a1 * b0;
          s[0][n][3] += a1 * b1;
        }
      }
    }

    // with a bias, on every tile: s * scale + bias, in natural units; the
    // mask only where the tile crosses this warp's diagonal or the end of
    // the sequence; bias-free, the scale into log2 units rides in the
    // exponent's FMA
    const float* sb = sBias + (j % S) * kBN;
    const bool edge = (a.causal && k0 + kBN - 1 > w0) || k0 + kBN > a.T;
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      float mc[2] = {-CUDART_INF_F, -CUDART_INF_F};
#pragma unroll
      for (int n = 0; n < 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float x = s[mt][n][e];
          if constexpr (kBias) {
            float b;
            if (bias_row) {
              b = sb[8 * n + 2 * t + (e & 1)];
            } else {
              const int col = k0 + 8 * n + 2 * t + (e & 1);
              const int row = min(w0 + 16 * mt + g + 8 * (e >> 1), a.T - 1);
              b = col < a.T ? __ldg(bias + static_cast<long long>(row) * a.T +
                                    col)
                            : 0.f;
            }
            x = fmaf(x, a.scale, b);
          }
          if (edge) {
            const int col = k0 + 8 * n + 2 * t + (e & 1);
            const int row = w0 + 16 * mt + g + 8 * (e >> 1);
            if ((a.causal && col > row) || col >= a.T) x = kNegInf;
          }
          s[mt][n][e] = x;
          mc[e >> 1] = fmaxf(mc[e >> 1], x);
        }
      float alpha[2], rs[2] = {0.f, 0.f};
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        // with a bias, natural units: the difference first, then log2(e)
        const float qm = quad_max(mc[r]);
        const float mn = fmaxf(m[mt][r], kBias ? qm : qm * sl2);
        alpha[r] = ex2(kBias ? (m[mt][r] - mn) * kLog2e : m[mt][r] - mn);
        m[mt][r] = mn;
      }
#pragma unroll
      for (int n = 0; n < 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float mr = m[mt][e >> 1];
          const float p = kBias ? ex2((s[mt][n][e] - mr) * kLog2e)
                             : ex2(fmaf(s[mt][n][e], sl2, -mr));
          rs[e >> 1] += p;
          s[mt][n][e] = p;
        }
#pragma unroll
      for (int r = 0; r < 2; ++r)
        l[mt][r] = alpha[r] * l[mt][r] + quad_sum(rs[r]);
#pragma unroll
      for (int n = 0; n < HD / 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[mt][n][e] *= alpha[e >> 1];
    }

    // O += P.V
    if constexpr (L::kBF16) {
#pragma unroll
      for (int kk = 0; kk < kBN / 16; ++kk) {
        uint32_t pa[MT][4];
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          pa[mt][0] = ptt::pack_bf16(s[mt][2 * kk][0], s[mt][2 * kk][1]);
          pa[mt][1] = ptt::pack_bf16(s[mt][2 * kk][2], s[mt][2 * kk][3]);
          pa[mt][2] =
              ptt::pack_bf16(s[mt][2 * kk + 1][0], s[mt][2 * kk + 1][1]);
          pa[mt][3] =
              ptt::pack_bf16(s[mt][2 * kk + 1][2], s[mt][2 * kk + 1][3]);
        }
#pragma unroll
        for (int np = 0; np < HD / 16; ++np) {
          uint32_t vf[4];
          ptt::ldmatrix_x4_trans(
              vf, sV + (kk * 16 + ptt::ldm_row_a(lane)) * L::LD + np * 16 +
                      ptt::ldm_col_a(lane));
#pragma unroll
          for (int mt = 0; mt < MT; ++mt) {
            ptt::mma_bf16(acc[mt][2 * np], pa[mt], vf[0], vf[1]);
            ptt::mma_bf16(acc[mt][2 * np + 1], pa[mt], vf[2], vf[3]);
          }
        }
      }
    } else {
#pragma unroll
      for (int kk = 0; kk < kBN; ++kk) {
        const int src = (lane & ~3) | ((kk & 7) >> 1);
        const float p0 =
            __shfl_sync(0xffffffffu, s[0][kk >> 3][kk & 1], src);
        const float p1 =
            __shfl_sync(0xffffffffu, s[0][kk >> 3][2 + (kk & 1)], src);
        const T* vr = sV + kk * L::LD + 2 * t;
#pragma unroll
        for (int n = 0; n < HD / 8; ++n) {
          const float v0 = ptt::to_f32(vr[8 * n]);
          const float v1 = ptt::to_f32(vr[8 * n + 1]);
          acc[0][n][0] += p0 * v0;
          acc[0][n][1] += p0 * v1;
          acc[0][n][2] += p1 * v0;
          acc[0][n][3] += p1 * v1;
        }
      }
    }
  }

  T* o = static_cast<T*>(a.o);
  float* lse = static_cast<float*>(a.lse);
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = w0 + 16 * mt + g + 8 * r;
      if (row >= a.T) continue;
      const float lr = l[mt][r];
      const float linv = lr == 0.f ? 1.f : 1.f / lr;
      T* orow = o + ((static_cast<long long>(b) * a.T + row) * a.nh + h) *
                        HD + 2 * t;
#pragma unroll
      for (int n = 0; n < HD / 8; ++n)
        store2<T>(orow + 8 * n, acc[mt][n][2 * r] * linv,
                  acc[mt][n][2 * r + 1] * linv);
      if (t == 0)
        lse[static_cast<long long>(blockIdx.y) * a.T + row] =
            (kBias ? m[mt][r] : m[mt][r] * kLn2) + logf(lr == 0.f ? 1.f : lr);
    }
}

template <typename T, int HD>
int launch(const Args& a, int B, cudaStream_t stream) {
  using L = Lay<T, HD>;
  const dim3 grid((a.T + kBM - 1) / kBM, B * a.nh);
  void (*kern)(Args) = a.bias != nullptr ? flash_fwd_kernel<T, HD, true>
                                         : flash_fwd_kernel<T, HD, false>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(L::kSmem));
  if (err != cudaSuccess) return static_cast<int>(err);
  kern<<<grid, L::kThreads, L::kSmem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_hd(const Args& a, int B, int hd, cudaStream_t s) {
  switch (hd) {
    case 16:
      return launch<T, 16>(a, B, s);
    case 32:
      return launch<T, 32>(a, B, s);
    case 64:
      return launch<T, 64>(a, B, s);
    case 128:
      return launch<T, 128>(a, B, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// q, k, v: [B, T, nh, hd] with element strides (sb, st, sh, 1), 16-byte
// aligned; o: contiguous [B, T, nh, hd]; lse: [B, nh, T] float32; bias:
// nullptr or a contiguous float32 [B * nh / bias_heads, bias_rows, T].
// hd 16, 32, 64 and 128 run their instances; any hd past 128 the split
// route (flash_wide.cuh), which needs no alignment.
extern "C" int ptt_flash_fwd(const void* q, const void* k, const void* v,
                             void* o, void* lse, const float* bias, int B,
                             int T, int nh, int hd, long long sb,
                             long long st, long long sh, float scale,
                             int causal, int bias_heads, int bias_rows,
                             int dtype, void* stream) {
  const Args a{q,  k,  v,  o,     lse,    bias,       T,        nh,
               sb, st, sh, scale, causal, bias_heads, bias_rows};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (hd > 128) {
    const fwide::Args w{q,    k,      v,          nullptr,   nullptr,
                        nullptr, nullptr, bias,   o,         lse,
                        T,    nh,     hd,         sb,        st,
                        sh,   scale,  causal,     bias_heads, bias_rows};
    return fwide::run<0>(dtype, w, B, s);
  }
  switch (dtype) {
    case ptt::kF32:
      return launch_hd<float>(a, B, hd, s);
    case ptt::kBF16:
      return launch_hd<bf16>(a, B, hd, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
