// FlashAttention-2 for training: forward, dQ and dK/dV kernels.
//
// Replaces: _fwd_kernel (paddle_tpu/ops/pallas_kernels.py:74, called at
// :176), _bwd_dq_kernel (:205, called at :349) and _bwd_dkv_kernel (:261,
// called at :381), in the causal-or-full, bias-free forms the GPT training
// step runs. The additive-bias form belongs to the ERNIE slice.
//
// What it computes, as the Pallas kernels do:
//   forward  s = q.k^T * scale (f32 sums), causal entries -> -0.7*FLT_MAX,
//            online softmax in f32, P rounded to v's dtype before P.V,
//            o = acc * (1/l) in q's dtype, lse = m + log(l) (l == 0 -> 1);
//   dQ       P = exp(s - lse), dP = dO.V^T, D = rowsum(dO*o) in f32,
//            dS = P*(dP - D)*scale rounded to k's dtype, dQ = dS.K;
//   dK/dV    dV = round(P).dO, dK = dS^T.Q. The reference keeps dS in f32
//            for dK; here dS is rounded to q's dtype so that the product
//            runs on the tensor cores in bf16. That rounding adds about as
//            much error to dk as dk's own rounding to bf16 on output
//            (tools/flash_precision.py measures both). In float32 nothing
//            is rounded.
//
// Layout: q, k, v are read in the public [B, T, nh, hd] layout through
// their strides (batch, seq, head; unit stride on hd), so slices of one
// packed qkv tensor need no copy. o, dO, dq, dk, dv are contiguous
// [B, T, nh, hd]; lse is [B, nh, T] float32.
//
// What bounds it on the card: at the training path's shape ([16, 1024,
// 12, 64], causal) each kernel does 26-52 GFLOP on ~100-180 MB, so the
// tensor cores bound it (about 0.03-0.05 ms at 989 TFLOP/s). Design, a
// simple one first: the TPU grid's sequential axis becomes a loop inside
// one block; 4 warps own 16 rows each of a 64-row tile (Q rows for the
// forward and dQ, K rows for dK/dV, so no atomics are needed and the
// result is the same every run); the walked 64-row tiles are staged in
// padded shared memory; bf16 products are mma.sync m16n8k16 with f32
// accumulators, fragments loaded from shared memory; float32 products use
// the same fragment layout on the CUDA cores. The (bq, 128) lane-
// replicated m/l/lse scratch of the TPU kernel is one float per row held
// by the 4 lanes that share it. Causal tiles above the diagonal are
// skipped exactly (64-row tiles on both axes); the heaviest tiles launch
// first. wgmma/TMA pipelines are later work.
#include <cstdint>
#include <type_traits>

#include "common.cuh"

namespace {

constexpr int kRows = 64;             // rows of every tile
constexpr int kWarps = 4;             // each warp owns 16 rows
constexpr int kThreads = kWarps * 32;
constexpr float kNegInf = -0.7f * 3.402823466e38f;  // _NEG_INF

using bf16 = __nv_bfloat16;

template <typename T, int HD>
struct Tile {
  static constexpr int kPad = 16 / sizeof(T);  // 16 bytes per row
  static constexpr int LD = HD + kPad;         // row of a [64, HD] tile
  static constexpr int LDP = kRows + kPad;     // row of a [64, 64] tile
  static constexpr int kElems = kRows * LD;
  static constexpr int kPElems = kRows * LDP;
};

// Copy rows [row0, row0 + 64) of a [T, HD] slice (row stride ld, in
// elements) into shared memory with row stride LD; rows >= T read zero.
template <typename T, int HD, int LD>
__device__ __forceinline__ void load_tile(T* __restrict__ s,
                                          const T* __restrict__ g,
                                          long long ld, int row0, int T_len) {
  constexpr int kVec = 16 / sizeof(T);
  constexpr int kPerRow = HD / kVec;
  for (int i = threadIdx.x; i < kRows * kPerRow; i += kThreads) {
    const int r = i / kPerRow, c = (i % kPerRow) * kVec;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (row0 + r < T_len)
      val = *reinterpret_cast<const uint4*>(
          g + static_cast<long long>(row0 + r) * ld + c);
    *reinterpret_cast<uint4*>(s + r * LD + c) = val;
  }
}

// Two bf16 values p[0] (low half) and p[S] (high half) as one register.
template <int S>
__device__ __forceinline__ uint32_t ld_pair(const bf16* p) {
  if constexpr (S == 1) {
    return *reinterpret_cast<const uint32_t*>(p);
  } else {
    const unsigned short* u = reinterpret_cast<const unsigned short*>(p);
    return static_cast<uint32_t>(u[0]) | (static_cast<uint32_t>(u[S]) << 16);
  }
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// One warp: acc[n] += A[16 x K] . B[K x 8*NT], both in shared memory, with
// A(m, k) = A[m*ASM + k*ASK] and B(k, n) = B[k*BSK + n*BSN]. Accumulator
// layout of mma.m16n8k16 (lane = 4g + t): acc[n] holds (g, 8n+2t),
// (g, 8n+2t+1), (g+8, 8n+2t), (g+8, 8n+2t+1).
template <int NT, int K, int ASM, int ASK, int BSK, int BSN, typename T>
__device__ __forceinline__ void warp_mma(float (&acc)[NT][4],
                                         const T* __restrict__ A,
                                         const T* __restrict__ B) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  if constexpr (std::is_same<T, bf16>::value) {
#pragma unroll
    for (int k0 = 0; k0 < K; k0 += 16) {
      const T* ap = A + g * ASM + (k0 + 2 * t) * ASK;
      uint32_t a[4];
      a[0] = ld_pair<ASK>(ap);
      a[1] = ld_pair<ASK>(ap + 8 * ASM);
      a[2] = ld_pair<ASK>(ap + 8 * ASK);
      a[3] = ld_pair<ASK>(ap + 8 * ASM + 8 * ASK);
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        const T* bp = B + (k0 + 2 * t) * BSK + (8 * n + g) * BSN;
        mma_bf16(acc[n], a, ld_pair<BSK>(bp), ld_pair<BSK>(bp + 8 * BSK));
      }
    }
  } else {
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
}

// Reduce over the 4 lanes that hold one row's accumulator columns.
__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

struct Args {
  const void *q, *k, *v, *o, *dout, *lse;
  void *out0, *out1;            // fwd: o, lse; dq: dq; dkv: dk, dv
  int T, nh;
  long long sb, st, sh;         // q/k/v strides (elements)
  float scale;
  int causal;
};

// o/dO/dq/dk/dv offset of (b, row, h) in a contiguous [B, T, nh, HD]
template <int HD>
__device__ __forceinline__ long long packed_off(int b, int row, int h,
                                                const Args& a) {
  return ((static_cast<long long>(b) * a.T + row) * a.nh + h) * HD;
}

// ---------------------------------------------------------------------------
// forward
// ---------------------------------------------------------------------------

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads) flash_fwd_kernel(Args a) {
  using S = Tile<T, HD>;
  extern __shared__ __align__(16) unsigned char smem[];
  T* sQ = reinterpret_cast<T*>(smem);
  T* sK = sQ + S::kElems;
  T* sV = sK + S::kElems;
  T* sP = sV + S::kElems;
  const int nq = gridDim.x;
  const int qi = nq - 1 - blockIdx.x;  // diagonal-heavy tiles first
  const int b = blockIdx.y / a.nh, h = blockIdx.y % a.nh;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const long long base = b * a.sb + h * a.sh;
  const T* q = static_cast<const T*>(a.q) + base;
  const T* k = static_cast<const T*>(a.k) + base;
  const T* v = static_cast<const T*>(a.v) + base;
  const int q0 = qi * kRows;
  const int row[2] = {q0 + warp * 16 + g, q0 + warp * 16 + g + 8};

  load_tile<T, HD, S::LD>(sQ, q, a.st, q0, a.T);
  float acc[HD / 8][4] = {};
  float m[2] = {-CUDART_INF_F, -CUDART_INF_F}, l[2] = {0.f, 0.f};
  T* pw = sP + warp * 16 * S::LDP;
  const int nk = a.causal ? qi + 1 : nq;
  for (int kj = 0; kj < nk; ++kj) {
    __syncthreads();
    load_tile<T, HD, S::LD>(sK, k, a.st, kj * kRows, a.T);
    load_tile<T, HD, S::LD>(sV, v, a.st, kj * kRows, a.T);
    __syncthreads();
    float s[8][4] = {};
    warp_mma<8, HD, S::LD, 1, 1, S::LD>(s, sQ + warp * 16 * S::LD, sK);
    float mc[2] = {-CUDART_INF_F, -CUDART_INF_F};
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = kj * kRows + 8 * n + 2 * t + (e & 1);
        float x = s[n][e] * a.scale;
        if ((a.causal && col > row[e >> 1]) || col >= a.T) x = kNegInf;
        s[n][e] = x;
        mc[e >> 1] = fmaxf(mc[e >> 1], x);
      }
    float alpha[2], mn[2], rs[2] = {0.f, 0.f};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mn[r] = fmaxf(m[r], quad_max(mc[r]));
      alpha[r] = expf(m[r] - mn[r]);
    }
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = expf(s[n][e] - mn[e >> 1]);
        rs[e >> 1] += p;
        pw[(g + 8 * (e >> 1)) * S::LDP + 8 * n + 2 * t + (e & 1)] =
            ptt::from_f32<T>(p);
      }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l[r] = alpha[r] * l[r] + quad_sum(rs[r]);
      m[r] = mn[r];
    }
#pragma unroll
    for (int n = 0; n < HD / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[n][e] *= alpha[e >> 1];
    __syncwarp();
    warp_mma<HD / 8, kRows, S::LDP, 1, S::LD, 1>(acc, pw, sV);
  }
  T* o = static_cast<T*>(a.out0);
  float* lse = static_cast<float*>(a.out1);
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (row[r] >= a.T) continue;
    const float linv = l[r] == 0.f ? 1.f : 1.f / l[r];
    T* orow = o + packed_off<HD>(b, row[r], h, a);
#pragma unroll
    for (int n = 0; n < HD / 8; ++n)
#pragma unroll
      for (int c = 0; c < 2; ++c)
        orow[8 * n + 2 * t + c] = ptt::from_f32<T>(acc[n][2 * r + c] * linv);
    if (t == 0)
      lse[static_cast<long long>(blockIdx.y) * a.T + row[r]] =
          m[r] + logf(l[r] == 0.f ? 1.f : l[r]);
  }
}

// ---------------------------------------------------------------------------
// dQ: one block per 64 query rows, walking the key tiles
// ---------------------------------------------------------------------------

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads) flash_bwd_dq_kernel(Args a) {
  using S = Tile<T, HD>;
  extern __shared__ __align__(16) unsigned char smem[];
  T* sQ = reinterpret_cast<T*>(smem);
  T* sdO = sQ + S::kElems;
  T* sK = sdO + S::kElems;
  T* sV = sK + S::kElems;
  T* sdS = sV + S::kElems;
  const int nq = gridDim.x;
  const int qi = nq - 1 - blockIdx.x;
  const int b = blockIdx.y / a.nh, h = blockIdx.y % a.nh;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const long long base = b * a.sb + h * a.sh;
  const T* k = static_cast<const T*>(a.k) + base;
  const T* v = static_cast<const T*>(a.v) + base;
  const T* o = static_cast<const T*>(a.o);
  const long long ldo = static_cast<long long>(a.nh) * HD;
  const T* dout_h = static_cast<const T*>(a.dout) + packed_off<HD>(b, 0, h, a);
  const int q0 = qi * kRows;
  const int row[2] = {q0 + warp * 16 + g, q0 + warp * 16 + g + 8};

  load_tile<T, HD, S::LD>(sQ, static_cast<const T*>(a.q) + base, a.st, q0,
                          a.T);
  load_tile<T, HD, S::LD>(sdO, dout_h, ldo, q0, a.T);
  __syncthreads();
  // D = rowsum(dO * o) in f32; each of the 4 lanes of a row takes HD/4
  float di[2], lse[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float part = 0.f;
    if (row[r] < a.T) {
      const T* orow = o + packed_off<HD>(b, row[r], h, a);
      const T* drow = sdO + (warp * 16 + g + 8 * r) * S::LD;
      for (int d = t * (HD / 4); d < (t + 1) * (HD / 4); ++d)
        part += ptt::to_f32(drow[d]) * ptt::to_f32(orow[d]);
    }
    di[r] = quad_sum(part);
    lse[r] = row[r] < a.T
                 ? static_cast<const float*>(a.lse)[
                       static_cast<long long>(blockIdx.y) * a.T + row[r]]
                 : 0.f;
  }
  float dq[HD / 8][4] = {};
  T* dsw = sdS + warp * 16 * S::LDP;
  const int nk = a.causal ? qi + 1 : nq;
  for (int kj = 0; kj < nk; ++kj) {
    __syncthreads();
    load_tile<T, HD, S::LD>(sK, k, a.st, kj * kRows, a.T);
    load_tile<T, HD, S::LD>(sV, v, a.st, kj * kRows, a.T);
    __syncthreads();
    float s[8][4] = {}, dp[8][4] = {};
    warp_mma<8, HD, S::LD, 1, 1, S::LD>(s, sQ + warp * 16 * S::LD, sK);
    warp_mma<8, HD, S::LD, 1, 1, S::LD>(dp, sdO + warp * 16 * S::LD, sV);
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1;
        const int col = kj * kRows + 8 * n + 2 * t + (e & 1);
        float x = s[n][e] * a.scale;
        if ((a.causal && col > row[r]) || col >= a.T) x = kNegInf;
        const float p = row[r] < a.T ? expf(x - lse[r]) : 0.f;
        const float ds = p * (dp[n][e] - di[r]) * a.scale;
        dsw[(g + 8 * r) * S::LDP + 8 * n + 2 * t + (e & 1)] =
            ptt::from_f32<T>(ds);
      }
    __syncwarp();
    warp_mma<HD / 8, kRows, S::LDP, 1, S::LD, 1>(dq, dsw, sK);
  }
  T* out = static_cast<T*>(a.out0);
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (row[r] >= a.T) continue;
    T* drow = out + packed_off<HD>(b, row[r], h, a);
#pragma unroll
    for (int n = 0; n < HD / 8; ++n)
#pragma unroll
      for (int c = 0; c < 2; ++c)
        drow[8 * n + 2 * t + c] = ptt::from_f32<T>(dq[n][2 * r + c]);
  }
}

// ---------------------------------------------------------------------------
// dK/dV: one block per 64 key rows, walking the query tiles
// ---------------------------------------------------------------------------

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads) flash_bwd_dkv_kernel(Args a) {
  using S = Tile<T, HD>;
  extern __shared__ __align__(16) unsigned char smem[];
  float* sLse = reinterpret_cast<float*>(smem);
  float* sDi = sLse + kRows;
  T* sK = reinterpret_cast<T*>(sDi + kRows);
  T* sV = sK + S::kElems;
  T* sQ = sV + S::kElems;
  T* sdO = sQ + S::kElems;
  T* sPt = sdO + S::kElems;
  T* sdS = sPt + S::kPElems;
  const int nq = gridDim.x;
  const int kj = blockIdx.x;    // low tiles see the most query tiles
  const int b = blockIdx.y / a.nh, h = blockIdx.y % a.nh;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const long long base = b * a.sb + h * a.sh;
  const T* q = static_cast<const T*>(a.q) + base;
  const T* o = static_cast<const T*>(a.o);
  const long long ldo = static_cast<long long>(a.nh) * HD;
  const T* dout_h = static_cast<const T*>(a.dout) + packed_off<HD>(b, 0, h, a);
  const float* lse_g = static_cast<const float*>(a.lse) +
                       static_cast<long long>(blockIdx.y) * a.T;
  const int k0 = kj * kRows;
  const int krow[2] = {k0 + warp * 16 + g, k0 + warp * 16 + g + 8};

  load_tile<T, HD, S::LD>(sK, static_cast<const T*>(a.k) + base, a.st, k0,
                          a.T);
  load_tile<T, HD, S::LD>(sV, static_cast<const T*>(a.v) + base, a.st, k0,
                          a.T);
  float dk[HD / 8][4] = {}, dv[HD / 8][4] = {};
  const int wrow = warp * 16 * S::LDP;
  for (int qi = a.causal ? kj : 0; qi < nq; ++qi) {
    const int q0 = qi * kRows;
    __syncthreads();
    load_tile<T, HD, S::LD>(sQ, q, a.st, q0, a.T);
    load_tile<T, HD, S::LD>(sdO, dout_h, ldo, q0, a.T);
    __syncthreads();
    {  // lse and D = rowsum(dO * o) of the 64 query rows: 2 lanes a row
      const int r = threadIdx.x >> 1, half = threadIdx.x & 1;
      float part = 0.f;
      if (q0 + r < a.T) {
        const T* orow = o + packed_off<HD>(b, q0 + r, h, a);
        const T* drow = sdO + r * S::LD;
        for (int d = half * (HD / 2); d < (half + 1) * (HD / 2); ++d)
          part += ptt::to_f32(drow[d]) * ptt::to_f32(orow[d]);
      }
      part += __shfl_xor_sync(0xffffffffu, part, 1);
      if (half == 0) {
        sDi[r] = part;
        sLse[r] = q0 + r < a.T ? lse_g[q0 + r] : 0.f;
      }
    }
    __syncthreads();
    float st[8][4] = {}, dpt[8][4] = {};  // S^T and dP^T: rows = keys
    warp_mma<8, HD, S::LD, 1, 1, S::LD>(st, sK + warp * 16 * S::LD, sQ);
    warp_mma<8, HD, S::LD, 1, 1, S::LD>(dpt, sV + warp * 16 * S::LD, sdO);
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int ci = 8 * n + 2 * t + (e & 1);  // query row in the tile
        const int qcol = q0 + ci;
        float x = st[n][e] * a.scale;
        if ((a.causal && qcol < krow[e >> 1]) || qcol >= a.T) x = kNegInf;
        const float p = expf(x - sLse[ci]);
        const float ds = p * (dpt[n][e] - sDi[ci]) * a.scale;
        const int at = wrow + (g + 8 * (e >> 1)) * S::LDP + ci;
        sPt[at] = ptt::from_f32<T>(p);
        sdS[at] = ptt::from_f32<T>(ds);
      }
    __syncwarp();
    warp_mma<HD / 8, kRows, S::LDP, 1, S::LD, 1>(dv, sPt + wrow, sdO);
    warp_mma<HD / 8, kRows, S::LDP, 1, S::LD, 1>(dk, sdS + wrow, sQ);
  }
  T* dk_out = static_cast<T*>(a.out0);
  T* dv_out = static_cast<T*>(a.out1);
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (krow[r] >= a.T) continue;
    const long long off = packed_off<HD>(b, krow[r], h, a);
#pragma unroll
    for (int n = 0; n < HD / 8; ++n)
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        dk_out[off + 8 * n + 2 * t + c] = ptt::from_f32<T>(dk[n][2 * r + c]);
        dv_out[off + 8 * n + 2 * t + c] = ptt::from_f32<T>(dv[n][2 * r + c]);
      }
  }
}

enum Which { kFwd = 0, kDq = 1, kDkv = 2 };

template <typename T, int HD>
size_t smem_bytes(int which) {
  using S = Tile<T, HD>;
  switch (which) {
    case kFwd:
      return (3 * S::kElems + S::kPElems) * sizeof(T);
    case kDq:
      return (4 * S::kElems + S::kPElems) * sizeof(T);
    default:
      return 2 * kRows * sizeof(float) +
             (4 * S::kElems + 2 * S::kPElems) * sizeof(T);
  }
}

template <typename T, int HD>
int launch(int which, const Args& a, int B, cudaStream_t stream) {
  const dim3 grid((a.T + kRows - 1) / kRows, B * a.nh);
  const size_t smem = smem_bytes<T, HD>(which);
  void (*kern)(Args) = which == kFwd  ? flash_fwd_kernel<T, HD>
                       : which == kDq ? flash_bwd_dq_kernel<T, HD>
                                      : flash_bwd_dkv_kernel<T, HD>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  kern<<<grid, kThreads, smem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_hd(int which, const Args& a, int B, int hd, cudaStream_t s) {
  switch (hd) {
    case 32:
      return launch<T, 32>(which, a, B, s);
    case 64:
      return launch<T, 64>(which, a, B, s);
    case 128:
      return launch<T, 128>(which, a, B, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

int dispatch(int which, const Args& a, int B, int hd, int dtype,
             void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case ptt::kF32:
      return launch_hd<float>(which, a, B, hd, s);
    case ptt::kBF16:
      return launch_hd<bf16>(which, a, B, hd, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// q, k, v: [B, T, nh, hd] with element strides (sb, st, sh, 1), 16-byte
// aligned; o: contiguous [B, T, nh, hd]; lse: [B, nh, T] float32.
extern "C" int ptt_flash_fwd(const void* q, const void* k, const void* v,
                             void* o, void* lse, int B, int T, int nh,
                             int hd, long long sb, long long st,
                             long long sh, float scale, int causal,
                             int dtype, void* stream) {
  Args a{q, k, v, nullptr, nullptr, nullptr, o, lse,
         T, nh, sb, st, sh, scale, causal};
  return dispatch(kFwd, a, B, hd, dtype, stream);
}

// o, dout, dq: contiguous [B, T, nh, hd]; the rest as ptt_flash_fwd.
extern "C" int ptt_flash_bwd_dq(const void* q, const void* k, const void* v,
                                const void* o, const void* dout,
                                const void* lse, void* dq, int B, int T,
                                int nh, int hd, long long sb, long long st,
                                long long sh, float scale, int causal,
                                int dtype, void* stream) {
  Args a{q, k, v, o, dout, lse, dq, nullptr,
         T, nh, sb, st, sh, scale, causal};
  return dispatch(kDq, a, B, hd, dtype, stream);
}

// dk, dv: contiguous [B, T, nh, hd]; the rest as ptt_flash_bwd_dq.
extern "C" int ptt_flash_bwd_dkv(const void* q, const void* k, const void* v,
                                 const void* o, const void* dout,
                                 const void* lse, void* dk, void* dv, int B,
                                 int T, int nh, int hd, long long sb,
                                 long long st, long long sh, float scale,
                                 int causal, int dtype, void* stream) {
  Args a{q, k, v, o, dout, lse, dk, dv,
         T, nh, sb, st, sh, scale, causal};
  return dispatch(kDkv, a, B, hd, dtype, stream);
}
