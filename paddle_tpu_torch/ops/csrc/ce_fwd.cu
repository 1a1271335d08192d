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
// tensor cores (mma.sync m16n8k16, bf16 inputs, float32 accumulation),
// the float32 instance on the CUDA cores (float32 fused multiply-adds, so
// it stays true float32).
//
// What bounds it on the card: operations. At the training shape (2048
// rows of D = 768 against 51,200 columns, bf16) it does 2 * 2048 * 768 *
// 50304 = 1.58e11 useful operations on ~82 MB of inputs; the 989 TFLOP/s
// bf16 peak bounds it, not HBM. Next after the tensor cores: the L2
// traffic of re-reading x and the head once for every tile of the other
// (48 KB a 64-deep slab a block: about 1.8 GB at that shape).
//
// Design. The TPU grid walks the vocab as its sequential axis, carrying
// (max, sum, gold) in VMEM scratch. Here a block of 8 warps takes 128
// rows and walks a contiguous range of N-column vocab tiles in order:
//   - bf16 (N = 256): two warpgroups, warpgroup v the rows
//     64v..64v+63 against all N columns, one m64nNk16 wgmma a 16-deep
//     step with both operands from shared memory (x K-major; the head
//     K-major for "vd", MN-major for "dv"), the float32 accumulators in
//     registers (128 a thread at N = 256). A 4-stage cp.async ring of
//     64-deep slabs (x [128][64], the head's [N][64] or [64][N]) in the
//     128-byte swizzle the products read, filled by all 256 threads with
//     16-byte copies (zero fill past n, D and Vp; rows that are not
//     16-byte aligned — any D, any head row stride — go through element
//     copies into the same places); the ring streams every (vocab tile,
//     slab) back to back, one barrier a slab; each warpgroup leaves one
//     slab's products running while the next barrier and copies proceed
//     (wgmma.wait_group 1), so a stage is refilled two slabs after it was
//     read;
//   - float32 (N = 128): thread (ty, tx) owns 8 rows x 8 columns of a tile
//     on the CUDA cores (float32 fused multiply-adds: it stays true
//     float32), from a 3-stage ring of 32-deep slabs with padded rows;
//   - after a tile's last slab, the online logsumexp runs on the
//     accumulators in registers: each thread keeps its own running (m, s,
//     gold) for each of its rows over its own columns of every tile (no
//     float32 tile in shared memory, no shuffle and no barrier a tile),
//     exp2 of log2e-scaled logits; gold is added where the column is the
//     label (checked only where the label falls in the thread's span);
//   - at the end of the block's vocab range the threads that share a row
//     (4 lanes at bf16, 16 at float32) merge by a butterfly of shuffles.
// The grid is (row tiles, vocab splits) with the row tile the fast axis,
// so the blocks that read one head slab run side by side and all but the
// first read it from L2: the head crosses HBM about once. The wrapper's
// plan (ops/chunked_ce.py ce_fwd_plan) sizes the splits to about one wave
// of blocks, one a multiprocessor; a second kernel merges each row's
// splits in order. Earlier designs on the same card (PERF.md): the WMMA
// kernel this one replaces (plain loads, a [64, 128] float32 tile in
// shared memory) 2.23 ms; mma.sync m16n8k16 with ldmatrix fragments,
// double-buffered, the same ring unswizzled, 0.66 ms.
#include <cstdint>
#include <type_traits>

#include "common.cuh"
#include "mma.cuh"
#include "wgmma.cuh"

namespace {

constexpr int kThreads = 256;   // 8 warps
constexpr int kBM = 128;        // rows a block
constexpr float kLog2e = 1.4426950408889634f;

// 2^x, one MUFU instruction (flush to zero: a term under 2^-126 of the
// running maximum's is lost in the float32 sum anyway)
__device__ __forceinline__ float exp2_fast(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// kVec elements of row `row` (valid when row_ok), from column col, into
// dst: one 16-byte cp.async when the rows are 16-byte aligned (vec) and
// the chunk lies wholly inside [0, limit) or wholly outside it (zero
// fill); else element by element, zeros past limit.
template <typename T>
__device__ __forceinline__ void copy_chunk(T* dst, const T* __restrict__ base,
                                           bool row_ok, int row, int col,
                                           int limit, int stride, bool vec) {
  constexpr int kVec = 16 / sizeof(T);
  const T* src = base + static_cast<size_t>(row_ok ? row : 0) * stride;
  if (vec && (!row_ok || col >= limit || col + kVec <= limit)) {
    const bool in = row_ok && col < limit;
    ptt::cp_async16(dst, src + (in ? col : 0), in ? 16 : 0);
  } else {
#pragma unroll
    for (int e = 0; e < kVec; ++e)
      dst[e] = row_ok && col + e < limit ? src[col + e]
                                         : ptt::from_f32<T>(0.f);
  }
}


// The running (m, s, gold) of kLanes neighbouring lanes (a power of two)
// merged into each of them by a butterfly of shuffles: every lane ends
// with the same bits.
template <int kLanes>
__device__ __forceinline__ void merge_lanes(float& m, float& s, float& g) {
#pragma unroll
  for (int off = 1; off < kLanes; off <<= 1) {
    const float mo = __shfl_xor_sync(0xffffffffu, m, off);
    const float so = __shfl_xor_sync(0xffffffffu, s, off);
    const float go = __shfl_xor_sync(0xffffffffu, g, off);
    const float M = fmaxf(m, mo);
    s = (m == -CUDART_INF_F ? 0.f : s * exp2_fast((m - M) * kLog2e)) +
        (mo == -CUDART_INF_F ? 0.f : so * exp2_fast((mo - M) * kLog2e));
    m = M;
    g += go;
  }
}


// ---------------------------------------------------------------------------
// float32: CUDA-core products from a cp.async ring
// ---------------------------------------------------------------------------

// A ring stage of the float32 kernel: the x slab [128][32 + 4] and the
// head slab, [32][128 + 4] ("dv") or [128][32 + 4] ("vd"), rows padded
// by 16 bytes.
template <bool kVD>
struct F32Cfg {
  static constexpr int BN = 128, BK = 32, kStages = 3;
  static constexpr int kLdA = BK + 4;
  static constexpr int kLdB = kVD ? BK + 4 : BN + 4;
  static constexpr int kA = kBM * kLdA;                  // floats
  static constexpr int kStage = kA + (kVD ? BN : BK) * kLdB;
  static constexpr size_t kSmem = kStages * kStage * sizeof(float);
};

// x rows [row0, row0 + 128) x depth [k0, k0 + 32) -> A; head depth
// [k0, k0 + 32) x columns [n0, n0 + 128) -> B; zeros past n, D, Vp.
template <bool kVD>
__device__ __forceinline__ void load_stage_f32(
    float* st, const float* __restrict__ x, const float* __restrict__ head,
    int row0, int n0, int k0, int n, int D, int Vp, int ldh, bool a_vec,
    bool b_vec) {
  using C = F32Cfg<kVD>;
  constexpr int kPer = C::BK / 4;                 // 16-byte chunks a row
#pragma unroll
  for (int i = threadIdx.x; i < kBM * kPer; i += kThreads) {
    const int r = i / kPer, c = (i % kPer) * 4;
    copy_chunk(st + r * C::kLdA + c, x, row0 + r < n, row0 + r, k0 + c, D, D,
               a_vec);
  }
  float* B = st + C::kA;
  if constexpr (!kVD) {
    constexpr int kPerRow = C::BN / 4;
#pragma unroll
    for (int i = threadIdx.x; i < C::BK * kPerRow; i += kThreads) {
      const int r = i / kPerRow, c = (i % kPerRow) * 4;
      copy_chunk(B + r * C::kLdB + c, head, k0 + r < D, k0 + r, n0 + c, Vp,
                 ldh, b_vec);
    }
  } else {
#pragma unroll
    for (int i = threadIdx.x; i < C::BN * kPer; i += kThreads) {
      const int r = i / kPer, c = (i % kPer) * 4;
      copy_chunk(B + r * C::kLdB + c, head, n0 + r < Vp, n0 + r, k0 + c, D,
                 ldh, b_vec);
    }
  }
}

// The float32 kernel: thread (ty, tx) of 16 x 16 owns rows 8ty..8ty+7
// and columns tx, tx + 16, ..., tx + 112 of each 128-column tile, with
// its running (m, s, gold) for its rows in registers; the 16 threads of a
// row (16 neighbouring lanes) merge by shuffles at the end. The ring's
// rhythm: slab q - 1's stage, freed by the barrier that ends slab q - 1,
// takes slab q + 2 while slab q's products run.
template <bool kVD>
__global__ void __launch_bounds__(kThreads)
    ce_fwd_f32_kernel(const float* __restrict__ x,
                      const float* __restrict__ head,
                      const float* __restrict__ bias,
                      const int* __restrict__ labels,
                      float* __restrict__ m_part, float* __restrict__ s_part,
                      float* __restrict__ g_part, int n, int D, int Vp,
                      int ldh, int vocab, int tiles_per_split, int a_vec,
                      int b_vec) {
  using C = F32Cfg<kVD>;
  constexpr int BN = C::BN, kStages = C::kStages;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* ring = reinterpret_cast<float*>(smem_raw);
  const int row0 = blockIdx.x * kBM, split = blockIdx.y;
  const int ntiles = (Vp + BN - 1) / BN;
  const int t0 = split * tiles_per_split;
  const int t1 = min(ntiles, t0 + tiles_per_split);
  const int nk = (D + C::BK - 1) / C::BK;
  const int total = max(0, t1 - t0) * nk;
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
  int lab[8];
  float m[8], s[8], gold[8], acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int r = row0 + ty * 8 + i;
    lab[i] = r < n ? labels[r] : -1;
    m[i] = -CUDART_INF_F;
    s[i] = gold[i] = 0.f;
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
  }
  int lq = 0, lk = 0, lt = t0;
  const auto fetch_next = [&]() {
    if (lq < total)
      load_stage_f32<kVD>(ring + (lq % kStages) * C::kStage, x, head, row0,
                          lt * BN, lk * C::BK, n, D, Vp, ldh, a_vec, b_vec);
    ptt::cp_async_commit();
    ++lq;
    if (++lk == nk) {
      lk = 0;
      ++lt;
    }
  };
#pragma unroll
  for (int q = 0; q < kStages - 1; ++q) fetch_next();
  ptt::cp_async_wait<kStages - 2>();
  __syncthreads();
  int kt = 0, tile = t0;
  for (int q = 0; q < total; ++q) {
    fetch_next();                        // slab q + S - 1
    const float* As = ring + (q % kStages) * C::kStage;
    const float* Bs = As + C::kA;
#pragma unroll 4
    for (int k = 0; k < C::BK; ++k) {
      float av[8], bv[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) av[i] = As[(ty * 8 + i) * C::kLdA + k];
#pragma unroll
      for (int j = 0; j < 8; ++j)
        bv[j] = kVD ? Bs[(tx + 16 * j) * C::kLdB + k]
                    : Bs[k * C::kLdB + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    ptt::cp_async_wait<kStages - 2>();   // slab q + 1 landed
    __syncthreads();                     // every thread done with slab q
    if (++kt < nk) continue;

    // the tile's last slab: the online logsumexp over its columns
    const int c0 = tile * BN;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int col = c0 + tx + 16 * j;
      const bool ok = col < vocab;
      const float b = ok && bias != nullptr ? __ldg(bias + col) : 0.f;
#pragma unroll
      for (int i = 0; i < 8; ++i) acc[i][j] = ok ? acc[i][j] + b : -CUDART_INF_F;
    }
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      float mx = -CUDART_INF_F;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        mx = fmaxf(mx, acc[i][j]);
        if (lab[i] == c0 + tx + 16 * j) gold[i] += acc[i][j];
      }
      if (mx != -CUDART_INF_F) {
        const float mn = fmaxf(m[i], mx);
        const float mL = mn * kLog2e;
        float p = 0.f;
#pragma unroll
        for (int j = 0; j < 8; ++j) p += exp2_fast(fmaf(acc[i][j], kLog2e, -mL));
        s[i] = s[i] * exp2_fast((m[i] - mn) * kLog2e) + p;   // 0: m is -inf
        m[i] = mn;
      }
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
    }
    kt = 0;
    ++tile;
  }
  ptt::cp_async_wait<0>();

  // the 16 threads of a row merge (a butterfly); tx = 0 writes
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    merge_lanes<16>(m[i], s[i], gold[i]);
    const int r = row0 + ty * 8 + i;
    if (tx == 0 && r < n) {
      const size_t o = static_cast<size_t>(split) * n + r;
      m_part[o] = m[i];
      s_part[o] = s[i];
      g_part[o] = gold[i];
    }
  }
}

// ---------------------------------------------------------------------------
// bf16: warpgroup products (wgmma) from a 128-byte-swizzled ring
// ---------------------------------------------------------------------------

// N: the vocab tile (256). A block of 2 warpgroups takes 128 rows,
// warpgroup v rows 64v..64v+63 against all N columns; a ring stage holds
// the x slab [128][64] (K-major) and the head slab, [N][64] ("vd",
// K-major) or [64][N] ("dv", MN-major: atoms of 8 depth rows x 64
// columns), each 128-byte swizzled (wgmma.cuh).
// tuning: the ring's stages
#define PTT_CE_WG_STAGES 4

template <bool kVD, int N>
struct WCfg {
  static constexpr int BK = 64;                   // 128 bytes of bf16
  static constexpr int kABytes = kBM * 128;
  static constexpr int kStageBytes = kABytes + N * 128;
  static constexpr int kStages = PTT_CE_WG_STAGES;
  static_assert(kStages >= 3, "a stage read, one landing, one refilled");
  // the ring, 1024-byte aligned for the swizzle atoms
  static constexpr size_t kSmem = kStages * kStageBytes + 1024;
  static_assert(kSmem <= 227 * 1024, "a block's shared memory");
};

// One ring stage of the wgmma kernel (byte address `st`, 1024-aligned):
// x rows [row0, row0 + 128) x depth [k0, k0 + 64) and the head's depth
// [k0, k0 + 64) x columns [n0, n0 + N), swizzled; zeros past n, D, Vp.
template <bool kVD, int N>
__device__ __forceinline__ void load_stage_sw(
    unsigned char* st, const __nv_bfloat16* __restrict__ x,
    const __nv_bfloat16* __restrict__ head, int row0, int n0, int k0, int n,
    int D, int Vp, int ldh, bool a_vec, bool b_vec) {
  using W = WCfg<kVD, N>;
  const auto at = [&](int off) {
    return reinterpret_cast<__nv_bfloat16*>(st + off);
  };
#pragma unroll
  for (int i = threadIdx.x; i < kBM * 8; i += kThreads) {
    const int r = i >> 3, c = i & 7;
    copy_chunk(at(r * 128 + ((c ^ (r & 7)) << 4)), x, row0 + r < n, row0 + r,
               k0 + 8 * c, D, D, a_vec);
  }
  if constexpr (kVD) {
#pragma unroll
    for (int i = threadIdx.x; i < N * 8; i += kThreads) {
      const int r = i >> 3, c = i & 7;
      copy_chunk(at(W::kABytes + r * 128 + ((c ^ (r & 7)) << 4)), head,
                 n0 + r < Vp, n0 + r, k0 + 8 * c, D, ldh, b_vec);
    }
  } else {
    constexpr int kPerRow = N / 8;                // chunks a depth row
#pragma unroll
    for (int i = threadIdx.x; i < 64 * kPerRow; i += kThreads) {
      const int k = i / kPerRow, c = i % kPerRow;
      const int off = ((c >> 3) * 8 + (k >> 3)) * 1024 + (k & 7) * 128 +
                      (((c & 7) ^ (k & 7)) << 4);
      copy_chunk(at(W::kABytes + off), head, k0 + k < D, k0 + k, n0 + 8 * c,
                 Vp, ldh, b_vec);
    }
  }
}

// The same stage where it lies inside the depth D and the head's Vp
// columns and every row is 16-byte aligned (the block-uniform common
// case): thread tid's chunks sit at fixed offsets that step by a
// constant, so each copy is an add and a cp.async, with no swizzle to
// compute. kRowEdge: the block's rows pass n, and x's rows past n are
// zero-filled (a test a copy, which costs the full tiles a fifth of their
// time on an H100, so they go without).
template <bool kVD, int N, bool kRowEdge>
__device__ __forceinline__ void load_stage_sw_interior(
    unsigned char* st, const __nv_bfloat16* __restrict__ x,
    const __nv_bfloat16* __restrict__ head, int row0, int n0, int k0, int n,
    int D, int ldh) {
  using W = WCfg<kVD, N>;
  const int tid = threadIdx.x;
  {  // x: row (tid >> 3) + 32u, chunk tid & 7 (its swizzle: (tid >> 3) & 7)
    const int r = tid >> 3, c = tid & 7;
    unsigned char* dst = st + r * 128 + ((c ^ (r & 7)) << 4);
    const __nv_bfloat16* src =
        x + static_cast<size_t>(row0 + r) * D + k0 + 8 * c;
#pragma unroll
    for (int u = 0; u < kBM / 32; ++u) {
      const bool in = !kRowEdge || row0 + r + 32 * u < n;
      ptt::cp_async16(dst + u * 32 * 128,
                      in ? src + static_cast<size_t>(u) * 32 * D : x,
                      in ? 16 : 0);
    }
  }
  if constexpr (kVD) {   // head row (tid >> 3) + 32u, chunk tid & 7
    const int r = tid >> 3, c = tid & 7;
    unsigned char* dst = st + W::kABytes + r * 128 + ((c ^ (r & 7)) << 4);
    const __nv_bfloat16* src =
        head + static_cast<size_t>(n0 + r) * ldh + k0 + 8 * c;
#pragma unroll
    for (int u = 0; u < N / 32; ++u)
      ptt::cp_async16(dst + u * 32 * 128,
                      src + static_cast<size_t>(u) * 32 * ldh);
  } else {               // depth row (tid >> 5) + 8u, chunk tid & 31
    constexpr int kPerRow = N / 8;
    constexpr int kRows = kThreads / kPerRow;     // depth rows a pass
    const int k = tid / kPerRow, c = tid % kPerRow;
    const int off = ((c >> 3) * 8 + (k >> 3)) * 1024 + (k & 7) * 128 +
                    (((c & 7) ^ (k & 7)) << 4);
    unsigned char* dst = st + W::kABytes + off;
    const __nv_bfloat16* src =
        head + static_cast<size_t>(k0 + k) * ldh + n0 + 8 * c;
    // kRows is a multiple of 8, so the pass moves whole 8-row groups
#pragma unroll
    for (int u = 0; u < 64 / kRows; ++u)
      ptt::cp_async16(dst + u * (kRows / 8) * 1024,
                      src + static_cast<size_t>(u) * kRows * ldh);
  }
}

// The bf16 kernel: the ring streams every (vocab tile, 64-deep slab) of
// the block; each warpgroup issues a slab's four m64nNk16 products
// asynchronously, waits only for the slab before (so one slab's products
// run while the next slab's barrier and copies proceed), and after a
// tile's last slab runs the online logsumexp on its accumulators. A
// thread holds 2 rows x N/4 columns of each tile: its running (m, s,
// gold) stay in registers, and the 4 threads of a row merge by shuffles
// at the end.
template <bool kVD, int N>
__global__ void __launch_bounds__(kThreads, 1)
    ce_fwd_wgmma_kernel(const __nv_bfloat16* __restrict__ x,
                        const __nv_bfloat16* __restrict__ head,
                        const float* __restrict__ bias,
                        const int* __restrict__ labels,
                        float* __restrict__ m_part, float* __restrict__ s_part,
                        float* __restrict__ g_part, int n, int D, int Vp,
                        int ldh, int vocab, int tiles_per_split, int a_vec,
                        int b_vec) {
  using W = WCfg<kVD, N>;
  constexpr int kStages = W::kStages, kR = N / 2;   // accumulators a thread
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const uint32_t raw = ptt::smem_u32(smem_raw);
  unsigned char* ring = smem_raw + (((raw + 1023u) & ~1023u) - raw);
  const uint32_t ring_u32 = ptt::smem_u32(ring);
  const int row0 = blockIdx.x * kBM, split = blockIdx.y;
  const int ntiles = (Vp + N - 1) / N;
  const int t0 = split * tiles_per_split;
  const int t1 = min(ntiles, t0 + tiles_per_split);
  const int nk = (D + W::BK - 1) / W::BK;
  const int total = max(0, t1 - t0) * nk;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int v = warp >> 2;                     // warpgroup: rows 64v..
  // this thread's two rows of the block's 128
  const int r0 = v * 64 + (warp & 3) * 16 + g;
  int lab[2];
  float m[2], s[2], gold[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = row0 + r0 + 8 * h;
    lab[h] = r < n ? labels[r] : -1;
    m[h] = -CUDART_INF_F;
    s[h] = gold[h] = 0.f;
  }

  int lq = 0, lk = 0, lt = t0;
  const bool vec = a_vec && b_vec;
  const bool rows_full = row0 + kBM <= n;
  const auto fetch_next = [&]() {
    if (lq < total) {
      unsigned char* st = ring + (lq % kStages) * W::kStageBytes;
      const int n0 = lt * N, k0 = lk * W::BK;
      if (vec && k0 + W::BK <= D && n0 + N <= Vp && rows_full)
        load_stage_sw_interior<kVD, N, false>(st, x, head, row0, n0, k0, n,
                                              D, ldh);
      else if (vec && k0 + W::BK <= D && n0 + N <= Vp)
        load_stage_sw_interior<kVD, N, true>(st, x, head, row0, n0, k0, n, D,
                                             ldh);
      else
        load_stage_sw<kVD, N>(st, x, head, row0, n0, k0, n, D, Vp, ldh,
                              a_vec, b_vec);
    }
    ptt::cp_async_commit();
    ++lq;
    if (++lk == nk) {
      lk = 0;
      ++lt;
    }
  };

  float acc[kR];
#pragma unroll
  for (int q = 0; q < kStages - 2; ++q) fetch_next();   // slabs 0..S-3
  int kt = 0, tile = t0;
  for (int q = 0; q < total; ++q) {
    // slab q landed (every thread's copies, made visible to the
    // products' reads); every warpgroup done with slab q - 2
    ptt::cp_async_wait<kStages - 3>();
    ptt::fence_proxy_async();
    __syncthreads();
    const uint32_t sa = ring_u32 + (q % kStages) * W::kStageBytes;
    const uint64_t da = ptt::wgmma_desc_sw128(sa + v * 64 * 128, 16, 1024);
    const uint64_t db =
        kVD ? ptt::wgmma_desc_sw128(sa + W::kABytes, 16, 1024)
            : ptt::wgmma_desc_sw128(sa + W::kABytes, 8 * 1024, 1024);
    ptt::wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < W::BK / 16; ++ks) {
      // 16 deep: 32 bytes along a K-major row, two 8-row groups MN-major
      const uint64_t b_step = kVD ? 2 * ks : 128 * ks;
      ptt::wgmma_m64n256k16<kVD ? 0 : 1>(acc, da + 2 * ks, db + b_step,
                                        kt > 0 || ks > 0);
    }
    ptt::wgmma_commit();
    ptt::wgmma_wait<1>();      // this warpgroup's slab q - 1 products done
    fetch_next();              // slab q + S - 2 into slab q - 2's stage
    if (++kt < nk) continue;

    // the tile's last slab: the online logsumexp over its N columns
    ptt::wgmma_wait<0>();
#pragma unroll
    for (int i = 0; i < kR; ++i) ptt::fence_operand(acc[i]);
    const int c0 = tile * N;
    float mx[2] = {-CUDART_INF_F, -CUDART_INF_F};
#pragma unroll
    for (int j = 0; j < N / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = c0 + 8 * j + 2 * t + e;
        const bool ok = col < vocab;
        const float b = ok && bias != nullptr ? __ldg(bias + col) : 0.f;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          float& val = acc[4 * j + 2 * h + e];
          val = ok ? val + b : -CUDART_INF_F;
          mx[h] = fmaxf(mx[h], val);
        }
      }
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int rel = lab[h] - c0 - 2 * t;
      if (rel >= 0 && rel < N && (rel & 6) == 0) {   // rare: the label
        float gd = 0.f;
#pragma unroll
        for (int j = 0; j < N / 8; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e)
            if (rel == 8 * j + e) gd = acc[4 * j + 2 * h + e];
        gold[h] += gd;
      }
      if (mx[h] == -CUDART_INF_F) continue;          // no column of its own
      const float mn = fmaxf(m[h], mx[h]);
      const float mL = mn * kLog2e;
      float p = 0.f;
#pragma unroll
      for (int j = 0; j < N / 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e)
          p += exp2_fast(fmaf(acc[4 * j + 2 * h + e], kLog2e, -mL));
      s[h] = s[h] * exp2_fast((m[h] - mn) * kLog2e) + p;   // 0: m is -inf
      m[h] = mn;
    }
    kt = 0;
    ++tile;
  }
  ptt::cp_async_wait<0>();     // the trailing (empty) groups
  ptt::wgmma_wait<0>();

  // the 4 threads of each row merge (a butterfly: every one ends with the
  // same bits), thread t = 0 writes the row's partial
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    merge_lanes<4>(m[h], s[h], gold[h]);
    const int r = row0 + r0 + 8 * h;
    if (t == 0 && r < n) {
      const size_t o = static_cast<size_t>(split) * n + r;
      m_part[o] = m[h];
      s_part[o] = s[h];
      g_part[o] = gold[h];
    }
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

// The kernel (with its dynamic shared memory and vocab tile) over the
// grid (row tiles, nsplit), then the merge of each row's splits.
template <typename T, typename Kernel>
int launch(Kernel kernel, size_t smem, int bn, const void* x,
           const void* head, const void* bias, const void* labels, void* lse,
           void* gold, void* scratch, int n, int D, int Vp, int ldh,
           int vocab, int nsplit, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int ntiles = (Vp + bn - 1) / bn;
  const int per = (ntiles + nsplit - 1) / nsplit;
  float* part = static_cast<float*>(scratch);
  const size_t np = static_cast<size_t>(nsplit) * n;
  // 16-byte copies where every row of the operand starts 16-byte aligned
  const int a_vec = (static_cast<size_t>(D) * sizeof(T)) % 16 == 0 &&
                    reinterpret_cast<uintptr_t>(x) % 16 == 0;
  const int b_vec = (static_cast<size_t>(ldh) * sizeof(T)) % 16 == 0 &&
                    reinterpret_cast<uintptr_t>(head) % 16 == 0;
  const dim3 grid((n + kBM - 1) / kBM, nsplit);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(head),
      static_cast<const float*>(bias), static_cast<const int*>(labels), part,
      part + np, part + 2 * np, n, D, Vp, ldh, vocab, per, a_vec, b_vec);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  ce_fwd_merge_kernel<<<(n + 255) / 256, 256, 0, stream>>>(
      part, part + np, part + 2 * np, static_cast<float*>(lse),
      static_cast<float*>(gold), n, nsplit);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x: [n, D] contiguous; head: "dv" (vd = 0) [D, Vp] with row stride ldh,
// or "vd" (vd = 1) [Vp, D] with row stride ldh (>= the row's width); both
// in `dtype`, any D, any ldh, any alignment of the element type. bias:
// [Vp] float32 or null; labels: [n] int32 in [0, vocab); lse, gold: [n]
// float32; scratch: [3, nsplit, n] float32. bn: the vocab tile, 256 at
// bf16 and 128 at float32; nsplit the vocab ranges (grid y), each
// a whole number of tiles, none empty (ce_fwd_plan). Columns >= vocab are
// masked.
extern "C" int ptt_ce_fwd(const void* x, const void* head, const void* bias,
                          const void* labels, void* lse, void* gold,
                          void* scratch, int n, int D, int Vp, int ldh,
                          int vocab, int vd, int nsplit, int bn, int dtype,
                          void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (n < 1 || D < 1 || Vp < 1 || nsplit < 1 || nsplit > 65535 ||
      vocab > Vp || ldh < (vd ? D : Vp))
    return static_cast<int>(cudaErrorInvalidValue);
  const auto f32 = [&](auto layout) {
    constexpr bool kVD = decltype(layout)::value;
    return launch<float>(ce_fwd_f32_kernel<kVD>, F32Cfg<kVD>::kSmem,
                         F32Cfg<kVD>::BN, x, head, bias, labels, lse, gold,
                         scratch, n, D, Vp, ldh, vocab, nsplit, st);
  };
  const auto bf16 = [&](auto layout) {
    constexpr bool kVD = decltype(layout)::value;
    return launch<__nv_bfloat16>(ce_fwd_wgmma_kernel<kVD, 256>,
                                 WCfg<kVD, 256>::kSmem, 256, x, head, bias,
                                 labels, lse, gold, scratch, n, D, Vp, ldh,
                                 vocab, nsplit, st);
  };
  using DV = std::false_type;
  using VD = std::true_type;
  switch (dtype) {
    case ptt::kF32:
      if (bn != 128) return static_cast<int>(cudaErrorInvalidValue);
      return vd ? f32(VD{}) : f32(DV{});
    case ptt::kBF16:
      if (bn != 256) return static_cast<int>(cudaErrorInvalidValue);
      return vd ? bf16(VD{}) : bf16(DV{});
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
