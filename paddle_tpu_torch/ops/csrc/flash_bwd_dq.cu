// FlashAttention-2 backward for training: the dQ kernel, laid out for
// Hopper. It also computes D = rowsum(dO*o), once a query row, and hands it
// to the dK/dV kernel (flash_bwd_dkv.cu) through a [B, nh, T] buffer.
//
// Replaces: _bwd_dq_kernel (paddle_tpu/ops/pallas_kernels.py:205, called
// at :349), causal or full, in both its forms: bias-free (the GPT training
// step) and with the additive float32 bias (:236-238; ERNIE's padding
// mask). The forward is flash_fwd.cu.
//
// What it computes (flash_bwd.cuh has the shared arithmetic): dQ =
// round(dS).K with float32 sums, dS rounded to k's dtype as the reference
// rounds it, in q's dtype.
//
// Layout: q, k, v are read in the public [B, T, nh, hd] layout through
// their strides (batch, seq, head; unit stride on hd); o, dO, dq are
// contiguous [B, T, nh, hd]; lse and D are [B, nh, T] float32.
//
// What bounds it on the card: at the training path's shape ([16, 1024,
// 12, 64], causal) it does 3 products over the 100.7M causal (q, k) pairs,
// 38.7 GFLOP (0.039 ms at 989 TFLOP/s), on 152 MB (q, k, v, o, dO read, dq
// written, lse; 0.045 ms at 3.35 TB/s), so the bytes bound it, the tensor
// cores close behind. Design (FlashAttention-2's backward on mma.sync):
//   - one block per 64 query rows (4 warps of 16), so each block owns its
//     dq rows: no atomics, the same bits every run; the heaviest
//     (diagonal-rich) blocks launch first;
//   - Q and dO are staged once through cp.async, and each warp loads their
//     A fragments into registers by ldmatrix for the whole key loop
//     (head_dim <= 64; at 128 they are read from shared memory each tile);
//     D is summed from dO in shared memory and o loaded by 16-byte reads
//     issued before the first wait, 2 lanes a row;
//   - 64-row K/V tiles arrive through a cp.async ring of 2 stages (3
//     measured no faster, PERF.md); with SQ = 1 the key tile's bias row
//     rides the ring with them, with SQ = T its [query, key] tile, so no
//     load waits behind the products;
//   - a tile is walked 16 keys at a time (one k-slice): S = Q.K^T and dP =
//     dO.V^T over them take their B fragments by ldmatrix from the
//     [key][hd] tiles; dS, rounded to bf16, is packed from its C fragments
//     into A fragments in registers with no shared-memory tile; dQ +=
//     dS.K takes B by ldmatrix.trans from the same 16 K rows. Only 16
//     columns of S and dP are live, so the hd 64 instances take 124
//     (bias-free) and 160 registers with no spill, and 4 (bias-free) or 3
//     blocks fit an SM;
//   - p = ex2 of one FMA, s*scale*log2(e) - lse*log2(e), bias-free; with a
//     bias s*scale + bias comes first, one FMA in natural units, and then
//     (x - lse)*log2(e) (see flash_fwd.cu for why);
//   - the masks only on tiles that cross a warp's diagonal or the sequence
//     end; a key tile wholly after a warp's rows is skipped by that warp.
// The bias is float32 [BB, SQ, T], contiguous; head bh reads row bh /
// bias_heads; SQ (bias_rows) is 1 or T. It is a template flag, as in
// flash_fwd.cu: a runtime test costs the bias-free form.
// float32 inputs (the parity configurations) run on the CUDA cores:
// 64-row tiles staged by plain copies, dS through shared memory.
#include <cstdint>

#include "flash_bwd.cuh"
#include "flash_wide.cuh"

namespace {

using fbwd::Args;
using fbwd::bf16;

// Tuning constants, one value each: flash_bwd_bench --define times a
// copy with one rewritten (PERF.md has what the others measured).
#define PTT_DQ_WARPS 4
#define PTT_DQ_STAGES 2
#define PTT_DQ_MIN_BLOCKS 4       // blocks an SM, bias-free, hd <= 64
#define PTT_DQ_MIN_BLOCKS_BIAS 3  // the same with a bias
#define PTT_DQ_UNROLL 1           // 16-column chunks unrolled

template <int HD>
struct Lay {
  static constexpr int kWarps = PTT_DQ_WARPS;
  static constexpr int kThreads = 32 * kWarps;
  static constexpr int kBM = 16 * kWarps;        // query rows a block
  static constexpr int kBN = 64;                 // key rows a tile
  static constexpr bool kKeepQ = HD <= 64;       // Q, dO A frags in registers
  static constexpr int kStages = HD <= 64 ? PTT_DQ_STAGES : 2;
  static constexpr int LD = HD + 8;              // 16 bytes of pad a row
  static constexpr int LDB = kBN + 8;            // row of the SQ = T bias tile
  static constexpr int kTile = kBN * LD;         // one of K, V (elements)
  // a stage: K, V, then the bias (bias_kind 1: SQ = 1, one [kBN] row;
  // 2: SQ = T, a [kBM, kBN] tile)
  __host__ __device__ static constexpr int stage_bytes(int bias_kind) {
    return 2 * kTile * 2 +
           (bias_kind == 0 ? 0 : bias_kind == 1 ? kBN * 4 : kBM * LDB * 4);
  }
  __host__ __device__ static constexpr int smem(int bias_kind) {
    return 2 * kBM * LD * 2 + kStages * stage_bytes(bias_kind);
  }
};

// Register tiles: warp w holds query rows w0 + g and w0 + g + 8 (w0 = q0 +
// 16 w; r = 0, 1 below, the C fragment's e >> 1) and, of a key tile,
// columns 8n + 2t and 8n + 2t + 1.
template <int HD, bool kBias>
__global__ void __launch_bounds__(
    Lay<HD>::kThreads,
    Lay<HD>::kWarps != 4 ? 1
    : HD > 64            ? 2
    : kBias              ? PTT_DQ_MIN_BLOCKS_BIAS
                         : PTT_DQ_MIN_BLOCKS)
    flash_bwd_dq_kernel(Args a) {
  using L = Lay<HD>;
  constexpr int NT = L::kThreads, S = L::kStages, BN = L::kBN;
  constexpr int KS = HD / 16, NH = HD / 8, kUnroll = PTT_DQ_UNROLL;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* sQ = reinterpret_cast<bf16*>(smem);
  bf16* sdO = sQ + L::kBM * L::LD;
  unsigned char* ring =
      reinterpret_cast<unsigned char*>(sdO + L::kBM * L::LD);
  const int bias_kind = kBias ? (a.bias_rows == 1 ? 1 : 2) : 0;
  const int stage_bytes = L::stage_bytes(bias_kind);
  const int nq = gridDim.x;
  const int qi = nq - 1 - blockIdx.x;   // diagonal-heavy blocks first
  const int b = blockIdx.y / a.nh, h = blockIdx.y % a.nh;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const long long base = b * a.sb + h * a.sh;
  const bf16* k = static_cast<const bf16*>(a.k) + base;
  const bf16* v = static_cast<const bf16*>(a.v) + base;
  const long long ldo = static_cast<long long>(a.nh) * HD;
  const long long hoff = fbwd::packed_off<HD>(b, 0, h, a);
  const float* bias = kBias ? fbwd::head_bias(a) : nullptr;
  const int q0 = qi * L::kBM;
  const int w0 = q0 + warp * 16;                  // this warp's first row
  const int nk_all = (a.T + BN - 1) / BN;
  const int nk = a.causal ? min(nk_all, (q0 + L::kBM + BN - 1) / BN)
                          : nk_all;

  // key tile j into stage j % S
  auto load_stage = [&](int j) {
    unsigned char* st = ring + (j % S) * stage_bytes;
    const int k0 = j * BN;
    bf16* sK = reinterpret_cast<bf16*>(st);
    float* sB = reinterpret_cast<float*>(sK + 2 * L::kTile);
    fbwd::load_rows<bf16, HD, L::LD, NT>(sK, k, a.st, k0, BN, a.T);
    fbwd::load_rows<bf16, HD, L::LD, NT>(sK + L::kTile, v, a.st, k0, BN,
                                         a.T);
    if (bias_kind == 1)
      fbwd::load_vec<NT>(sB, bias, k0, BN, a.T);
    else if (bias_kind == 2)
      fbwd::load_ftile<NT>(sB, L::LDB, bias, q0, L::kBM, k0, BN, a.T);
  };

  // prologue: Q, dO with key tile 0, then tiles 1..S-2, one group each
  fbwd::load_rows<bf16, HD, L::LD, NT>(sQ, static_cast<const bf16*>(a.q) +
                                               base, a.st, q0, L::kBM, a.T);
  fbwd::load_rows<bf16, HD, L::LD, NT>(sdO, static_cast<const bf16*>(a.dout) +
                                                hoff, ldo, q0, L::kBM, a.T);
#pragma unroll
  for (int j = 0; j < S - 1; ++j) {
    if (j < nk) load_stage(j);
    ptt::cp_async_commit();
  }

  // o for D: lane l reads half of row w0 + l/2 (HD/2 values, 16 bytes at
  // a time) while the copies fly
  constexpr int kOV = HD / 16;                    // uint4 a lane
  const int orow = w0 + (lane >> 1), ocol = (lane & 1) * (HD / 2);
  uint4 ov[kOV];
#pragma unroll
  for (int i = 0; i < kOV; ++i)
    ov[i] = orow < a.T
                ? __ldg(reinterpret_cast<const uint4*>(
                      static_cast<const bf16*>(a.o) + hoff +
                      static_cast<long long>(orow) * ldo + ocol) + i)
                : make_uint4(0u, 0u, 0u, 0u);

  const float* lse_g = static_cast<const float*>(a.lse) +
                       static_cast<long long>(blockIdx.y) * a.T;
  float lse[2], di[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = w0 + g + 8 * r;
    lse[r] = row < a.T ? lse_g[row] : 0.f;
    if (!kBias) lse[r] *= fbwd::kLog2e;           // log2 units
  }
  uint32_t qf[L::kKeepQ ? KS : 1][4], dof[L::kKeepQ ? KS : 1][4];
  float dq[NH][4] = {};
  const float sl2 = a.scale * fbwd::kLog2e;
  const bf16* sQw = sQ + warp * 16 * L::LD;
  const bf16* sdOw = sdO + warp * 16 * L::LD;

  // Q, dO and key tile 0 landed: Q's and dO's fragments, and D =
  // rowsum(dO * o) in float32 (the 2 lanes of a row, then to the lanes
  // that hold rows g and g + 8), before the loop so that o's registers
  // are free in it
  ptt::cp_async_wait<S - 2>();
  __syncthreads();
  if constexpr (L::kKeepQ) {
    fbwd::load_a<KS>(qf, sQw, L::LD, lane);
    fbwd::load_a<KS>(dof, sdOw, L::LD, lane);
  }
  {
    const bf16* drow = sdOw + (lane >> 1) * L::LD + ocol;
    float part = 0.f;
#pragma unroll
    for (int i = 0; i < kOV; ++i) {
      const uint4 dv4 = *reinterpret_cast<const uint4*>(drow + 8 * i);
      const __nv_bfloat162* d2 =
          reinterpret_cast<const __nv_bfloat162*>(&dv4);
      const __nv_bfloat162* o2 =
          reinterpret_cast<const __nv_bfloat162*>(&ov[i]);
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const float2 df = __bfloat1622float2(d2[c]);
        const float2 of = __bfloat1622float2(o2[c]);
        part = fmaf(df.x, of.x, part);
        part = fmaf(df.y, of.y, part);
      }
    }
    part += __shfl_xor_sync(0xffffffffu, part, 1);
    if (a.di != nullptr && (lane & 1) == 0 && orow < a.T)
      a.di[static_cast<long long>(blockIdx.y) * a.T + orow] = part;
    di[0] = __shfl_sync(0xffffffffu, part, 2 * g);
    di[1] = __shfl_sync(0xffffffffu, part, 2 * g + 16);
  }

  for (int j = 0; j < nk; ++j) {
    if (j > 0) {
      ptt::cp_async_wait<S - 2>();
      __syncthreads();          // tile j landed; tile j-1's stage is free
    }
    if (j + S - 1 < nk) load_stage(j + S - 1);
    ptt::cp_async_commit();
    const int k0 = j * BN;
    if (a.causal && k0 > w0 + 15) continue;       // wholly after our rows
    const unsigned char* st = ring + (j % S) * stage_bytes;
    const bf16* sK = reinterpret_cast<const bf16*>(st);
    const bf16* sV = sK + L::kTile;
    const float* sB = reinterpret_cast<const float*>(sK + 2 * L::kTile);

    // 16 keys at a time (k-slice kk): S = Q.K^T and dP = dO.V^T over
    // them, dS, then dQ += round(dS).K, so that only 16 columns of S and
    // dP are live; the masks only where the tile crosses this warp's
    // diagonal or the end of the sequence
    const bool edge = (a.causal && k0 + BN - 1 > w0) || k0 + BN > a.T;
#pragma unroll kUnroll
    for (int kk = 0; kk < BN / 16; ++kk) {
      const bf16* sKk = sK + kk * 16 * L::LD;
      float s[2][4] = {}, dp[2][4] = {};
      if constexpr (L::kKeepQ) {
        fbwd::mma_abt<KS>(s, qf, sKk, L::LD, lane);
        fbwd::mma_abt<KS>(dp, dof, sV + kk * 16 * L::LD, L::LD, lane);
      } else {
        fbwd::mma_abt_s<KS>(s, sQw, L::LD, sKk, L::LD, lane);
        fbwd::mma_abt_s<KS>(dp, sdOw, L::LD, sV + kk * 16 * L::LD, L::LD,
                               lane);
      }
#pragma unroll
      for (int n = 0; n < 2; ++n) {
        const int c = 2 * kk + n;          // 8-key column tile in the tile
        float2 b2[2] = {};
        if constexpr (kBias) {   // SQ = 1: one value a key, both rows
          const float* bc = sB + 8 * c + 2 * t;
          if (bias_kind == 1) {
            b2[0] = b2[1] = *reinterpret_cast<const float2*>(bc);
          } else {
#pragma unroll
            for (int r = 0; r < 2; ++r)
              b2[r] = *reinterpret_cast<const float2*>(
                  bc + (warp * 16 + g + 8 * r) * L::LDB);
          }
        }
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = e >> 1;
          float p;
          if constexpr (kBias) {
            const float bb = (e & 1) ? b2[r].y : b2[r].x;
            p = fbwd::ex2((fmaf(s[n][e], a.scale, bb) - lse[r]) *
                          fbwd::kLog2e);
          } else {
            p = fbwd::ex2(fmaf(s[n][e], sl2, -lse[r]));
          }
          if (edge) {
            const int col = k0 + 8 * c + 2 * t + (e & 1);
            if ((a.causal && col > w0 + g + 8 * r) || col >= a.T) p = 0.f;
          }
          s[n][e] = p * (dp[n][e] - di[r]) * a.scale;
        }
      }
      uint32_t da[4];
      fbwd::c_to_a(da, s);
      fbwd::mma_ab<NH>(dq, da, sKk, L::LD, lane);
    }
  }
  ptt::cp_async_wait<0>();

  bf16* out = static_cast<bf16*>(a.out0);
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = w0 + g + 8 * r;
    if (row >= a.T) continue;
    bf16* drow = out + fbwd::packed_off<HD>(b, row, h, a) + 2 * t;
#pragma unroll
    for (int c = 0; c < NH; ++c)
      fbwd::store2<bf16>(drow + 8 * c, dq[c][2 * r], dq[c][2 * r + 1]);
  }
}

// ---------------------------------------------------------------------------
// float32: one block per 64 query rows, 4 warps, tiles staged by plain copies
// ---------------------------------------------------------------------------

template <int HD>
struct LayF32 {
  static constexpr int kRows = fbwd::kF32Rows;
  static constexpr int LD = HD + 4;          // row of a [64, HD] tile
  static constexpr int LDP = kRows + 4;      // row of a [64, 64] tile
  static constexpr int LDB = kRows + 8;      // row of the staged bias tile
  static constexpr int kElems = kRows * LD;
  static constexpr int kPElems = kRows * LDP;
  __host__ __device__ static constexpr int smem(int bias_kind) {
    return (4 * kElems + kPElems) * 4 +
           (bias_kind == 0 ? 0 : (bias_kind == 1 ? 1 : kRows) * LDB * 4);
  }
};

template <int HD, bool kBias>
__global__ void __launch_bounds__(fbwd::kF32Threads)
    flash_bwd_dq_kernel_f32(Args a) {
  using L = LayF32<HD>;
  constexpr int kRows = L::kRows, NT = fbwd::kF32Threads;
  extern __shared__ __align__(16) unsigned char smem[];
  float* sQ = reinterpret_cast<float*>(smem);
  float* sdO = sQ + L::kElems;
  float* sK = sdO + L::kElems;
  float* sV = sK + L::kElems;
  float* sdS = sV + L::kElems;
  float* sBq = sdS + L::kPElems;          // with a bias
  const int nq = gridDim.x;
  const int qi = nq - 1 - blockIdx.x;
  const int b = blockIdx.y / a.nh, h = blockIdx.y % a.nh;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const long long base = b * a.sb + h * a.sh;
  const float* k = static_cast<const float*>(a.k) + base;
  const float* v = static_cast<const float*>(a.v) + base;
  const float* o = static_cast<const float*>(a.o);
  const long long ldo = static_cast<long long>(a.nh) * HD;
  const float* dout_h =
      static_cast<const float*>(a.dout) + fbwd::packed_off<HD>(b, 0, h, a);
  const int q0 = qi * kRows;
  const int row[2] = {q0 + warp * 16 + g, q0 + warp * 16 + g + 8};

  fbwd::load_tile_f32<HD, L::LD>(sQ, static_cast<const float*>(a.q) + base,
                                 a.st, q0, a.T);
  fbwd::load_tile_f32<HD, L::LD>(sdO, dout_h, ldo, q0, a.T);
  __syncthreads();
  // D = rowsum(dO * o) in f32; each of the 4 lanes of a row takes HD/4
  float di[2], lse[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float part = 0.f;
    if (row[r] < a.T) {
      const float* orow = o + fbwd::packed_off<HD>(b, row[r], h, a);
      const float* drow = sdO + (warp * 16 + g + 8 * r) * L::LD;
      for (int d = t * (HD / 4); d < (t + 1) * (HD / 4); ++d)
        part += drow[d] * orow[d];
    }
    di[r] = fbwd::quad_sum(part);
    if (a.di != nullptr && t == 0 && row[r] < a.T)
      a.di[static_cast<long long>(blockIdx.y) * a.T + row[r]] = di[r];
    lse[r] = row[r] < a.T
                 ? static_cast<const float*>(a.lse)[
                       static_cast<long long>(blockIdx.y) * a.T + row[r]]
                 : 0.f;
  }
  float dq[HD / 8][4] = {};
  float* dsw = sdS + warp * 16 * L::LDP;
  const int nk = a.causal ? qi + 1 : nq;
  const float* bias = kBias ? fbwd::head_bias(a) : nullptr;
  // this thread's rows in the staged bias (SQ = 1: the one row)
  const int boff[2] = {a.bias_rows == 1 ? 0 : (warp * 16 + g) * L::LDB,
                       a.bias_rows == 1 ? 0 : (warp * 16 + g + 8) * L::LDB};
  for (int kj = 0; kj < nk; ++kj) {
    const int k0 = kj * kRows;
    __syncthreads();
    fbwd::load_tile_f32<HD, L::LD>(sK, k, a.st, k0, a.T);
    fbwd::load_tile_f32<HD, L::LD>(sV, v, a.st, k0, a.T);
    if constexpr (kBias) {   // bias[q0 + i, k0 + j] by row; i = 0 for SQ = 1
      const int nrows = a.bias_rows == 1 ? 1 : kRows;
      for (int i = threadIdx.x; i < nrows * kRows; i += NT) {
        const int r = i / kRows, c = i % kRows;
        const long long qrow = a.bias_rows == 1 ? 0 : q0 + r;
        sBq[r * L::LDB + c] = qrow < a.T && k0 + c < a.T
                                  ? __ldg(bias + qrow * a.T + k0 + c)
                                  : 0.f;
      }
    }
    __syncthreads();
    float s[8][4] = {}, dp[8][4] = {};
    fbwd::warp_mma_f32<8, HD, L::LD, 1, 1, L::LD>(s, sQ + warp * 16 * L::LD,
                                                  sK);
    fbwd::warp_mma_f32<8, HD, L::LD, 1, 1, L::LD>(dp,
                                                  sdO + warp * 16 * L::LD, sV);
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1;
        const int col = k0 + 8 * n + 2 * t + (e & 1);
        float x = kBias ? fmaf(s[n][e], a.scale,
                               sBq[boff[r] + 8 * n + 2 * t + (e & 1)])
                        : s[n][e] * a.scale;
        if ((a.causal && col > row[r]) || col >= a.T) x = fbwd::kNegInf;
        const float p = row[r] < a.T ? expf(x - lse[r]) : 0.f;
        dsw[(g + 8 * r) * L::LDP + 8 * n + 2 * t + (e & 1)] =
            p * (dp[n][e] - di[r]) * a.scale;
      }
    __syncwarp();
    fbwd::warp_mma_f32<HD / 8, kRows, L::LDP, 1, L::LD, 1>(dq, dsw, sK);
  }
  float* out = static_cast<float*>(a.out0);
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (row[r] >= a.T) continue;
    float* drow = out + fbwd::packed_off<HD>(b, row[r], h, a) + 2 * t;
#pragma unroll
    for (int n = 0; n < HD / 8; ++n)
      fbwd::store2<float>(drow + 8 * n, dq[n][2 * r], dq[n][2 * r + 1]);
  }
}

template <int HD>
int launch_bf16(const Args& a, int B, cudaStream_t stream) {
  using L = Lay<HD>;
  const dim3 grid((a.T + L::kBM - 1) / L::kBM, B * a.nh);
  const bool hb = a.bias != nullptr;
  return fbwd::launch_kernel(
      hb ? flash_bwd_dq_kernel<HD, true> : flash_bwd_dq_kernel<HD, false>,
      grid, L::kThreads, L::smem(hb ? (a.bias_rows == 1 ? 1 : 2) : 0),
      stream, a);
}

template <int HD>
int launch_f32(const Args& a, int B, cudaStream_t stream) {
  using L = LayF32<HD>;
  const dim3 grid((a.T + L::kRows - 1) / L::kRows, B * a.nh);
  const bool hb = a.bias != nullptr;
  return fbwd::launch_kernel(
      hb ? flash_bwd_dq_kernel_f32<HD, true>
         : flash_bwd_dq_kernel_f32<HD, false>,
      grid, fbwd::kF32Threads,
      L::smem(hb ? (a.bias_rows == 1 ? 1 : 2) : 0), stream, a);
}

}  // namespace

// q, k, v: [B, T, nh, hd] with element strides (sb, st, sh, 1), 16-byte
// aligned; o, dout, dq: contiguous [B, T, nh, hd]; lse: [B, nh, T] float32;
// di: nullptr or a [B, nh, T] float32 buffer that receives D = rowsum(dO *
// o) for ptt_flash_bwd_dkv; bias: nullptr or a contiguous float32
// [B * nh / bias_heads, bias_rows, T].
extern "C" int ptt_flash_bwd_dq(const void* q, const void* k, const void* v,
                                const void* o, const void* dout,
                                const void* lse, const float* bias, void* dq,
                                float* di, int B, int T, int nh, int hd,
                                long long sb, long long st, long long sh,
                                float scale, int causal, int bias_heads,
                                int bias_rows, int dtype, void* stream) {
  const Args a{q,  k,  v,  o,  dout,  lse,    di,         bias,     dq,
               nullptr, T, nh, sb, st, sh, scale, causal, bias_heads,
               bias_rows};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (hd > 128) {   // the split route (flash_wide.cuh)
    const fwide::Args w{q,  k,     v,      o,          dout,
                        static_cast<const float*>(lse), di, bias, dq,
                        nullptr, T, nh, hd, sb, st, sh, scale, causal,
                        bias_heads, bias_rows};
    return fwide::run<1>(dtype, w, B, s);
  }
  switch (dtype) {
    case ptt::kF32:
      return fbwd::by_head_dim(hd, [&](auto H) {
        return launch_f32<decltype(H)::value>(a, B, s);
      });
    case ptt::kBF16:
      return fbwd::by_head_dim(hd, [&](auto H) {
        return launch_bf16<decltype(H)::value>(a, B, s);
      });
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
