// FlashAttention-2 backward for training: the dK/dV kernel, laid out for
// Hopper.
//
// Replaces: _bwd_dkv_kernel (paddle_tpu/ops/pallas_kernels.py:261, called
// at :381), causal or full, in both its forms: bias-free (the GPT training
// step) and with the additive float32 bias (:294-296; ERNIE's padding
// mask). dQ is flash_bwd_dq.cu, the forward flash_fwd.cu.
//
// What it computes (flash_bwd.cuh has the shared arithmetic): dV =
// round(P)^T.dO and dK = dS^T.Q with dS in float32, as the reference keeps
// it. In bf16, dS is carried as two bf16 parts, hi = round(dS) and lo =
// round(dS - hi), and dK = hi^T.Q + lo^T.Q on the tensor cores, which holds
// dS to about 2^-17 of itself (one bf16 part alone, 2^-9, put single
// elements of dk past two bf16 ulps of the plain version's). D =
// rowsum(dO*o) is not recomputed here: dQ computed it once a query row and
// this kernel reads it, beside lse, so it never touches o.
//
// Layout: q, k, v are read in the public [B, T, nh, hd] layout through
// their strides (batch, seq, head; unit stride on hd); dO, dk, dv are
// contiguous [B, T, nh, hd]; lse and D are [B, nh, T] float32.
//
// What bounds it on the card: at the training path's shape ([16, 1024,
// 12, 64], causal) it does 4 products over the 100.7M causal (q, k) pairs
// of the batch, 51.6 GFLOP (0.052 ms at 989 TFLOP/s), on 153 MB (q, k, v,
// dO read, dk, dv written, lse, D: 0.046 ms at 3.35 TB/s), so the tensor
// cores bound it; the reference's form, which reads o for D, moves 177 MB
// (0.053 ms). Design (FlashAttention-2's backward on mma.sync):
//   - one block per 64 key rows (4 warps of 16; 8 warps measured slower,
//     PERF.md), so each block owns its dk and dv rows: no atomics, the same
//     bits every run; the heaviest blocks (low keys, causal) launch first;
//   - each warp loads the A fragments of its K and V rows into registers
//     once, by ldmatrix (head_dim <= 64; at 128 they are read from shared
//     memory each tile);
//   - the walked query tiles (Q, dO and their lse and D; with a full SQ = T
//     bias, its tile) arrive through a cp.async ring of 3 stages (head_dim
//     <= 64; else 2): the copy of tile j+S-1 starts right after the one
//     barrier of tile j and overlaps the math of tiles j..j+S-2;
//   - a tile is walked 16 queries at a time (one k-slice): S^T = K.Q^T and
//     dP^T = V.dO^T over them take their B fragments by ldmatrix from the
//     [query][hd] tiles; P^T, dS^T_hi and dS^T_lo are packed from their C
//     fragments into A fragments in registers (rows = keys, k = queries),
//     with no shared-memory tile; dV += P^T.dO and dK += (hi + lo)^T.Q take
//     B by ldmatrix.trans from the same 16 rows. Only 16 columns of S^T and
//     dP^T are live, so the hd 64 instances take 162 (bias-free) and 168
//     registers with no spill and 3 blocks fit an SM (PERF.md: 2 blocks of
//     the whole tile's 236 registers measured slower);
//   - p = ex2 of one FMA, s*scale*log2(e) - lse*log2(e), bias-free; with a
//     bias s*scale + bias comes first, one FMA in natural units, and then
//     (x - lse)*log2(e) (a -0.5*FLT_MAX padding bias must not be scaled
//     into log2 units before lse cancels it: flash_fwd.cu);
//   - the masks only on tiles that cross a warp's diagonal or the sequence
//     end; a tile wholly before a warp's keys is skipped by that warp.
// The bias is float32 [BB, SQ, T], contiguous; head bh reads row bh /
// bias_heads. With SQ = 1 it is one value a key row, read once a block;
// with SQ = T its [query, key] tile rides the ring at a row stride of
// 64 + 4 floats, which makes the transposed reads free of bank conflicts.
// The bias is a template flag, as in flash_fwd.cu: a runtime test costs
// the bias-free form.
// float32 inputs (the parity configurations) run on the CUDA cores:
// 64-row tiles staged by plain copies, P^T and dS^T through shared memory.
#include <cstdint>

#include "flash_bwd.cuh"
#include "flash_wide.cuh"

namespace {

using fbwd::Args;
using fbwd::bf16;

// Tuning constants, one value each: flash_bwd_bench --define times a
// copy with one rewritten (PERF.md has what the others measured).
#define PTT_DKV_WARPS 4
#define PTT_DKV_STAGES 3
#define PTT_DKV_MIN_BLOCKS 3       // blocks an SM, bias-free, hd <= 64
#define PTT_DKV_MIN_BLOCKS_BIAS 3  // the same with a bias
#define PTT_DKV_UNROLL 1           // 16-column chunks unrolled

template <int HD>
struct Lay {
  static constexpr int kWarps = PTT_DKV_WARPS;
  static constexpr int kThreads = 32 * kWarps;
  static constexpr int kBK = 16 * kWarps;        // key rows a block
  static constexpr int kBQ = HD <= 64 ? 64 : 32;  // query rows a tile
  static constexpr bool kKeepKV = HD <= 64;      // K, V A frags in registers
  static constexpr int kStages = HD <= 64 ? PTT_DKV_STAGES : 2;
  static constexpr int LD = HD + 8;              // 16 bytes of pad a row
  static constexpr int LDB = kBK + 4;            // row of the SQ = T bias tile
  static constexpr int kTile = kBQ * LD;         // one of Q, dO (elements)
  // a stage: Q, dO, then lse and D [kBQ] f32, then (SQ = T) the bias tile
  __host__ __device__ static constexpr int stage_bytes(bool bias_tile) {
    return 2 * kTile * 2 + 2 * kBQ * 4 + (bias_tile ? kBQ * LDB * 4 : 0);
  }
  __host__ __device__ static constexpr int smem(bool bias_tile) {
    return 2 * kBK * LD * 2 + kStages * stage_bytes(bias_tile);
  }
};

// Register tiles: warp w holds key rows kw + g and kw + g + 8 (kw = k0 +
// 16 w; r = 0, 1 below, the C fragment's e >> 1) and, of a query tile,
// columns 8n + 2t and 8n + 2t + 1.
template <int HD, bool kBias>
__global__ void __launch_bounds__(
    Lay<HD>::kThreads,
    Lay<HD>::kWarps != 4 || HD > 64 ? 1
    : kBias                         ? PTT_DKV_MIN_BLOCKS_BIAS
                                    : PTT_DKV_MIN_BLOCKS)
    flash_bwd_dkv_kernel(Args a) {
  using L = Lay<HD>;
  constexpr int NT = L::kThreads, S = L::kStages, BQ = L::kBQ;
  constexpr int KS = HD / 16, NH = HD / 8, kUnroll = PTT_DKV_UNROLL;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* sK = reinterpret_cast<bf16*>(smem);
  bf16* sV = sK + L::kBK * L::LD;
  unsigned char* ring = reinterpret_cast<unsigned char*>(sV + L::kBK * L::LD);
  const bool bias_tile = kBias && a.bias_rows != 1;
  const int stage_bytes = L::stage_bytes(bias_tile);
  const int k0 = blockIdx.x * L::kBK;   // low keys see the most query tiles
  const int b = blockIdx.y / a.nh, h = blockIdx.y % a.nh;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const long long base = b * a.sb + h * a.sh;
  const bf16* q = static_cast<const bf16*>(a.q) + base;
  const bf16* dout =
      static_cast<const bf16*>(a.dout) + fbwd::packed_off<HD>(b, 0, h, a);
  const long long ldo = static_cast<long long>(a.nh) * HD;
  const float* lse_g = static_cast<const float*>(a.lse) +
                       static_cast<long long>(blockIdx.y) * a.T;
  const float* di_g = a.di + static_cast<long long>(blockIdx.y) * a.T;
  const float* bias = kBias ? fbwd::head_bias(a) : nullptr;
  const int kw = k0 + warp * 16;                  // this warp's first key
  const int nq = (a.T + BQ - 1) / BQ;
  const int qt0 = a.causal ? k0 / BQ : 0;         // first tile that sees k0
  const int n = nq - qt0;                         // tiles walked

  // query tile qt0 + j into stage j % S
  auto load_stage = [&](int j) {
    unsigned char* st = ring + (j % S) * stage_bytes;
    const int q0 = (qt0 + j) * BQ;
    bf16* sQ = reinterpret_cast<bf16*>(st);
    bf16* sdO = sQ + L::kTile;
    float* sL = reinterpret_cast<float*>(sdO + L::kTile);
    fbwd::load_rows<bf16, HD, L::LD, NT>(sQ, q, a.st, q0, BQ, a.T);
    fbwd::load_rows<bf16, HD, L::LD, NT>(sdO, dout, ldo, q0, BQ, a.T);
    fbwd::load_vec<NT>(sL, lse_g, q0, BQ, a.T);
    fbwd::load_vec<NT>(sL + BQ, di_g, q0, BQ, a.T);
    if (bias_tile)
      fbwd::load_ftile<NT>(sL + 2 * BQ, L::LDB, bias, q0, BQ, k0, L::kBK,
                           a.T);
  };

  // prologue: K, V with tile 0, then tiles 1..S-2, one group each
  fbwd::load_rows<bf16, HD, L::LD, NT>(sK, static_cast<const bf16*>(a.k) +
                                               base, a.st, k0, L::kBK, a.T);
  fbwd::load_rows<bf16, HD, L::LD, NT>(sV, static_cast<const bf16*>(a.v) +
                                               base, a.st, k0, L::kBK, a.T);
#pragma unroll
  for (int j = 0; j < S - 1; ++j) {
    if (j < n) load_stage(j);
    ptt::cp_async_commit();
  }

  float bk[2] = {0.f, 0.f};     // SQ = 1: the bias of this thread's keys
  if (kBias && a.bias_rows == 1)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int krow = kw + g + 8 * r;
      if (krow < a.T) bk[r] = __ldg(bias + krow);
    }
  uint32_t kf[L::kKeepKV ? KS : 1][4], vf[L::kKeepKV ? KS : 1][4];
  float dk[NH][4] = {}, dv[NH][4] = {};
  const float sl2 = a.scale * fbwd::kLog2e;
  const bf16* sKw = sK + warp * 16 * L::LD;
  const bf16* sVw = sV + warp * 16 * L::LD;

  for (int j = 0; j < n; ++j) {
    ptt::cp_async_wait<S - 2>();
    __syncthreads();            // tile j landed; tile j-1's stage is free
    if (j + S - 1 < n) load_stage(j + S - 1);
    ptt::cp_async_commit();
    if constexpr (L::kKeepKV) {
      if (j == 0) {
        fbwd::load_a<KS>(kf, sKw, L::LD, lane);
        fbwd::load_a<KS>(vf, sVw, L::LD, lane);
      }
    }
    const int q0 = (qt0 + j) * BQ;
    if (a.causal && q0 + BQ - 1 < kw) continue;   // wholly before our keys
    const unsigned char* st = ring + (j % S) * stage_bytes;
    const bf16* sQ = reinterpret_cast<const bf16*>(st);
    const bf16* sdO = sQ + L::kTile;
    const float* sL = reinterpret_cast<const float*>(sdO + L::kTile);
    const float* sD = sL + BQ;
    const float* sB = sL + 2 * BQ;

    // 16 queries at a time (k-slice kk): S^T = K.Q^T and dP^T = V.dO^T
    // over them, P^T and dS^T, then dV += P^T.dO (P rounded to bf16) and
    // dK += dS^T_hi.Q + dS^T_lo.Q, so that only 16 columns of S^T and
    // dP^T are live; the masks only where the tile crosses this warp's
    // diagonal or the end of the sequence
    const bool edge = (a.causal && q0 < kw + 15) || q0 + BQ > a.T;
#pragma unroll kUnroll
    for (int kk = 0; kk < BQ / 16; ++kk) {
      const bf16* sQk = sQ + kk * 16 * L::LD;
      const bf16* sdOk = sdO + kk * 16 * L::LD;
      float s[2][4] = {}, dp[2][4] = {};
      if constexpr (L::kKeepKV) {
        fbwd::mma_abt<KS>(s, kf, sQk, L::LD, lane);
        fbwd::mma_abt<KS>(dp, vf, sdOk, L::LD, lane);
      } else {
        fbwd::mma_abt_s<KS>(s, sKw, L::LD, sQk, L::LD, lane);
        fbwd::mma_abt_s<KS>(dp, sVw, L::LD, sdOk, L::LD, lane);
      }
#pragma unroll
      for (int n = 0; n < 2; ++n) {
        const int c = 2 * kk + n;          // 8-query column tile
        const float2 l2 = *reinterpret_cast<const float2*>(sL + 8 * c + 2 * t);
        const float2 d2 = *reinterpret_cast<const float2*>(sD + 8 * c + 2 * t);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = e >> 1, ci = 8 * c + 2 * t + (e & 1);
          const float lse = (e & 1) ? l2.y : l2.x;
          const float di = (e & 1) ? d2.y : d2.x;
          float p;
          if constexpr (kBias) {
            const float bb = a.bias_rows == 1
                                 ? bk[r]
                                 : sB[ci * L::LDB + warp * 16 + g + 8 * r];
            p = fbwd::ex2((fmaf(s[n][e], a.scale, bb) - lse) * fbwd::kLog2e);
          } else {
            p = fbwd::ex2(fmaf(s[n][e], sl2, -lse * fbwd::kLog2e));
          }
          if (edge) {
            const int qrow = q0 + ci, krow = kw + g + 8 * r;
            if ((a.causal && qrow < krow) || qrow >= a.T) p = 0.f;
          }
          s[n][e] = p;
          dp[n][e] = p * (dp[n][e] - di) * a.scale;
        }
      }
      uint32_t pa[4], hi[4], lo[4];
      fbwd::c_to_a(pa, s);
      fbwd::c_to_a_split(hi, lo, dp);
      fbwd::mma_ab<NH>(dv, pa, sdOk, L::LD, lane);
      fbwd::mma_ab2<NH>(dk, hi, lo, sQk, L::LD, lane);
    }
  }
  ptt::cp_async_wait<0>();

  bf16* dk_out = static_cast<bf16*>(a.out0);
  bf16* dv_out = static_cast<bf16*>(a.out1);
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int krow = kw + g + 8 * r;
    if (krow >= a.T) continue;
    const long long off = fbwd::packed_off<HD>(b, krow, h, a) + 2 * t;
#pragma unroll
    for (int c = 0; c < NH; ++c) {
      fbwd::store2<bf16>(dk_out + off + 8 * c, dk[c][2 * r],
                         dk[c][2 * r + 1]);
      fbwd::store2<bf16>(dv_out + off + 8 * c, dv[c][2 * r],
                         dv[c][2 * r + 1]);
    }
  }
}

// ---------------------------------------------------------------------------
// float32: one block per 64 key rows, 4 warps, tiles staged by plain copies
// ---------------------------------------------------------------------------

template <int HD>
struct LayF32 {
  static constexpr int kRows = fbwd::kF32Rows;
  static constexpr int LD = HD + 4;          // row of a [64, HD] tile
  static constexpr int LDP = kRows + 4;      // row of a [64, 64] tile
  static constexpr int LDB = kRows + 4;      // row of the staged bias tile
  static constexpr int kElems = kRows * LD;
  static constexpr int kPElems = kRows * LDP;
  __host__ __device__ static constexpr int smem(bool bias_tile) {
    return (2 * kRows + 4 * kElems + 2 * kPElems +
            (bias_tile ? kRows * LDB : 0)) * 4;
  }
};

template <int HD, bool kBias>
__global__ void __launch_bounds__(fbwd::kF32Threads)
    flash_bwd_dkv_kernel_f32(Args a) {
  using L = LayF32<HD>;
  constexpr int kRows = L::kRows, NT = fbwd::kF32Threads;
  extern __shared__ __align__(16) unsigned char smem[];
  float* sLse = reinterpret_cast<float*>(smem);
  float* sDi = sLse + kRows;
  float* sK = sDi + kRows;
  float* sV = sK + L::kElems;
  float* sQ = sV + L::kElems;
  float* sdO = sQ + L::kElems;
  float* sPt = sdO + L::kElems;
  float* sdS = sPt + L::kPElems;
  float* sB = sdS + L::kPElems;           // SQ = T bias tile
  const int nq = gridDim.x;
  const int kj = blockIdx.x;    // low tiles see the most query tiles
  const int b = blockIdx.y / a.nh, h = blockIdx.y % a.nh;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const long long base = b * a.sb + h * a.sh;
  const float* q = static_cast<const float*>(a.q) + base;
  const long long ldo = static_cast<long long>(a.nh) * HD;
  const float* dout_h =
      static_cast<const float*>(a.dout) + fbwd::packed_off<HD>(b, 0, h, a);
  const float* lse_g = static_cast<const float*>(a.lse) +
                       static_cast<long long>(blockIdx.y) * a.T;
  const float* di_g = a.di + static_cast<long long>(blockIdx.y) * a.T;
  const int k0 = kj * kRows;
  const int krow[2] = {k0 + warp * 16 + g, k0 + warp * 16 + g + 8};

  fbwd::load_tile_f32<HD, L::LD>(sK, static_cast<const float*>(a.k) + base,
                                 a.st, k0, a.T);
  fbwd::load_tile_f32<HD, L::LD>(sV, static_cast<const float*>(a.v) + base,
                                 a.st, k0, a.T);
  float dk[HD / 8][4] = {}, dv[HD / 8][4] = {};
  const int wrow = warp * 16 * L::LDP;
  const float* bias = kBias ? fbwd::head_bias(a) : nullptr;
  float bk[2] = {0.f, 0.f};     // SQ = 1: the bias of this thread's keys
  if (kBias && a.bias_rows == 1)
#pragma unroll
    for (int r = 0; r < 2; ++r)
      if (krow[r] < a.T) bk[r] = __ldg(bias + krow[r]);
  for (int qi = a.causal ? kj : 0; qi < nq; ++qi) {
    const int q0 = qi * kRows;
    __syncthreads();
    fbwd::load_tile_f32<HD, L::LD>(sQ, q, a.st, q0, a.T);
    fbwd::load_tile_f32<HD, L::LD>(sdO, dout_h, ldo, q0, a.T);
    if (kBias && a.bias_rows != 1)   // SQ = T: bias[q0 + i, k0 + j], by row
      for (int i = threadIdx.x; i < kRows * kRows; i += NT) {
        const int r = i / kRows, c = i % kRows;
        sB[r * L::LDB + c] =
            q0 + r < a.T && k0 + c < a.T
                ? __ldg(bias + static_cast<long long>(q0 + r) * a.T + k0 + c)
                : 0.f;
      }
    if (threadIdx.x < kRows) {     // lse and D of the 64 query rows
      const bool in = q0 + threadIdx.x < a.T;
      sLse[threadIdx.x] = in ? lse_g[q0 + threadIdx.x] : 0.f;
      sDi[threadIdx.x] = in ? di_g[q0 + threadIdx.x] : 0.f;
    }
    __syncthreads();
    float st[8][4] = {}, dpt[8][4] = {};  // S^T and dP^T: rows = keys
    fbwd::warp_mma_f32<8, HD, L::LD, 1, 1, L::LD>(st, sK + warp * 16 * L::LD,
                                                  sQ);
    fbwd::warp_mma_f32<8, HD, L::LD, 1, 1, L::LD>(dpt,
                                                  sV + warp * 16 * L::LD, sdO);
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int ci = 8 * n + 2 * t + (e & 1);  // query row in the tile
        const int qcol = q0 + ci;
        float x = kBias ? fmaf(st[n][e], a.scale,
                               a.bias_rows == 1
                                   ? bk[e >> 1]
                                   : sB[ci * L::LDB + warp * 16 + g +
                                        8 * (e >> 1)])
                        : st[n][e] * a.scale;
        if ((a.causal && qcol < krow[e >> 1]) || qcol >= a.T)
          x = fbwd::kNegInf;
        const float p = expf(x - sLse[ci]);
        const float ds = p * (dpt[n][e] - sDi[ci]) * a.scale;
        const int at = wrow + (g + 8 * (e >> 1)) * L::LDP + ci;
        sPt[at] = p;
        sdS[at] = ds;
      }
    __syncwarp();
    fbwd::warp_mma_f32<HD / 8, kRows, L::LDP, 1, L::LD, 1>(dv, sPt + wrow,
                                                           sdO);
    fbwd::warp_mma_f32<HD / 8, kRows, L::LDP, 1, L::LD, 1>(dk, sdS + wrow,
                                                           sQ);
  }
  float* dk_out = static_cast<float*>(a.out0);
  float* dv_out = static_cast<float*>(a.out1);
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (krow[r] >= a.T) continue;
    const long long off = fbwd::packed_off<HD>(b, krow[r], h, a) + 2 * t;
#pragma unroll
    for (int n = 0; n < HD / 8; ++n) {
      fbwd::store2<float>(dk_out + off + 8 * n, dk[n][2 * r],
                          dk[n][2 * r + 1]);
      fbwd::store2<float>(dv_out + off + 8 * n, dv[n][2 * r],
                          dv[n][2 * r + 1]);
    }
  }
}

template <int HD>
int launch_bf16(const Args& a, int B, cudaStream_t stream) {
  using L = Lay<HD>;
  const dim3 grid((a.T + L::kBK - 1) / L::kBK, B * a.nh);
  const bool hb = a.bias != nullptr;
  return fbwd::launch_kernel(hb ? flash_bwd_dkv_kernel<HD, true>
                                : flash_bwd_dkv_kernel<HD, false>,
                             grid, L::kThreads,
                             L::smem(hb && a.bias_rows != 1), stream, a);
}

template <int HD>
int launch_f32(const Args& a, int B, cudaStream_t stream) {
  using L = LayF32<HD>;
  const dim3 grid((a.T + L::kRows - 1) / L::kRows, B * a.nh);
  const bool hb = a.bias != nullptr;
  return fbwd::launch_kernel(hb ? flash_bwd_dkv_kernel_f32<HD, true>
                                : flash_bwd_dkv_kernel_f32<HD, false>,
                             grid, fbwd::kF32Threads,
                             L::smem(hb && a.bias_rows != 1), stream, a);
}

}  // namespace

// q, k, v: [B, T, nh, hd] with element strides (sb, st, sh, 1), 16-byte
// aligned; dout, dk, dv: contiguous [B, T, nh, hd]; lse and di (D =
// rowsum(dO * o), from ptt_flash_bwd_dq): [B, nh, T] float32; bias: nullptr
// or a contiguous float32 [B * nh / bias_heads, bias_rows, T].
extern "C" int ptt_flash_bwd_dkv(const void* q, const void* k, const void* v,
                                 const void* dout, const void* lse,
                                 const float* di, const float* bias, void* dk,
                                 void* dv, int B, int T, int nh, int hd,
                                 long long sb, long long st, long long sh,
                                 float scale, int causal, int bias_heads,
                                 int bias_rows, int dtype, void* stream) {
  const Args a{q,  k,  v,  nullptr, dout,  lse, const_cast<float*>(di),
               bias, dk, dv, T, nh, sb, st, sh, scale, causal, bias_heads,
               bias_rows};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (hd > 128) {   // the split route (flash_wide.cuh)
    const fwide::Args w{q,  k,     v,      nullptr,    dout,
                        static_cast<const float*>(lse),
                        const_cast<float*>(di), bias, dk, dv, T, nh, hd,
                        sb, st, sh, scale, causal, bias_heads, bias_rows};
    return fwide::run<2>(dtype, w, B, s);
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
