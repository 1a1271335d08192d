// The one-query decode step shared by the slab and the paged KV layouts:
// the new K/V row written IN PLACE (cast to the cache dtype), then masked
// one-query attention over rows 0..pos, per (lane, head).
//
// The two layouts differ only in where row j of lane b lives, so the body
// is one kernel template over a row-address policy `Rows`:
//
//   int rows() const             rows a lane can address (pos must be
//                                below); host and device
//   bool bind(b, pos, c0, chunk, int* sh)
//                                block-wide, every thread calls it once the
//                                position is known in range: checks the
//                                lane's addressing (the paged policy checks
//                                every table entry 0..pos / page, whichever
//                                chunk the block holds) and resolves the
//                                rows [c0, c0 + chunk) of the block's chunk
//                                (the paged policy stages their physical
//                                rows in shared memory, one table read per
//                                page); false = refuse the lane
//   bool writes(b) const         whether lane b writes its new row
//   size_t row(r) const          element offset of chunk row r, head 0
//   size_t wrow                  set by bind: element offset of row pos
//   static size_t smem_bytes(chunk)  the staging bind() needs
//
// A refused lane (pos outside [0, rows()) or a bad table entry) answers
// zeros and writes nothing; no address outside the caches is formed.
//
// Attention sees exactly the value that lands at row pos: every block
// substitutes the new row, rounded through the cache dtype, wherever a
// row's address is the write address (as the TPU kernel substitutes it,
// pallas_kernels.py:1455-1461), and the block whose chunk holds pos
// writes it. Reading the row back after a barrier would not do once a
// lane's rows are split across blocks: a dead paged lane's rows all
// alias scratch page 0, so its other blocks would race with the write.
// Scores and softmax run in float32 with the guards of
// ops/decode_attention.py (the max made finite, the sum floored at
// 1e-30); the output is in q's dtype.
//
// Design (flash-decoding). What bounds the step is HBM bytes: per (b, h)
// it reads pos+1 rows of K and of V, hd elements each, and does 4*hd
// operations a row, far below the card's ridge. So the design is about
// bytes in flight and parallelism:
//
// - Pass 1, grid (nsplit, nh, B), 128 threads: lane b's rows are cut into
//   chunks of `chunk` rows (from the shapes alone, so the host never reads
//   positions), one block per (chunk, head, lane); a block whose chunk
//   starts past pos returns at once. A block walks its chunk in tiles of
//   4 * 128 / (hd / V) rows, V = 16 bytes of cache elements: every thread
//   issues its 4 rows' 16-byte K and V loads together, hd / V neighbouring
//   threads cover a row (bf16, hd 64: 8 threads x 16 bytes), each scores
//   its slice and a log2(hd / V)-step shuffle adds them. Each warp keeps
//   an online softmax in float32 over its rows (no score buffer), the four
//   warps merge in shared memory, and the block writes its partial
//   (m, l, o[hd]) to a float32 workspace. The block whose chunk holds pos
//   writes row pos, and is the only one to touch it.
// - Pass 2, grid (nh, B), hd threads: merges lane b's partials 0..pos /
//   chunk (M = their max made finite, L = sum l_i e^(m_i - M), o = sum o_i
//   e^(m_i - M) / max(L, 1e-30)) and writes out in q's dtype. Block 0 of a
//   refused lane marks its partial (l = -1), so the merge answers zeros.
//
// What still bounds it: the two launches and their tails (at B = 8, S =
// 1024 the grid is 1,536 blocks, of which only those whose chunk starts
// at or before pos load rows), and the merge's serial loop over the
// splits; the workspace traffic is (hd + 2) floats a chunk.
//
// Head dims past 128 (the reference's kernels take hd from the cache
// shape) take the split route, decode_wide_kernel: the head dim is split
// into column blocks of kWideCols = 128, a grid dimension (folded into x
// beside the chunks) walks them, and each block scores its rows over the
// whole hd (a warp a row, lanes over the columns, one shuffle sum) but
// accumulates only its own 128 output columns; the scores are computed
// again in every column block. Registers and shared memory stay at the
// size of the HD-128 instance, so one instance a dtype pair serves every
// hd. The merge runs one block per (head, lane, column block).
#pragma once

#include <type_traits>

#include "common.cuh"

namespace ptt {
namespace decode {

constexpr int kThreads = 128;            // 4 warps a block
constexpr int kWarps = kThreads / 32;
constexpr int kRowsAThread = 4;          // K and V rows a thread loads a tile

// 16 bytes of cache elements as floats
template <typename TC>
struct Vec16;

template <>
struct Vec16<float> {
  static constexpr int kN = 4;
  __device__ __forceinline__ static void to_f32(const uint4& u, float* f) {
    f[0] = __uint_as_float(u.x);
    f[1] = __uint_as_float(u.y);
    f[2] = __uint_as_float(u.z);
    f[3] = __uint_as_float(u.w);
  }
};

template <>
struct Vec16<__nv_bfloat16> {
  static constexpr int kN = 8;
  // a bf16 is the top half of its float32: element 2i is the low half of
  // word i (little-endian)
  __device__ __forceinline__ static void to_f32(const uint4& u, float* f) {
    const unsigned w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      f[2 * i] = __uint_as_float(w[i] << 16);
      f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
  }
};

struct Args {
  const void* q;
  const void* new_k;
  const void* new_v;
  long long row_stride;   // elements between lanes of q/new_k/new_v
  void* k_cache;
  void* v_cache;
  const int* positions;
  float* part;            // [B, nh, nsplit, hd + 2] float32 workspace
  void* out;
  int B, nh, hd, chunk, nsplit;
  float sm_scale;
};

// HD is the instance's width (a power of two); the head has hd <= HD
// elements, and lanes past hd load zeros and store nothing. kVec: every
// head row is whole 16-byte vectors of cache elements (hd * sizeof(TC) a
// multiple of 16), else the rows load one element at a time.
template <typename TQ, typename TC, int HD, bool kVec, typename Rows>
__global__ void __launch_bounds__(kThreads)
    decode_split_kernel(const TQ* __restrict__ q, const TQ* __restrict__ new_k,
                        const TQ* __restrict__ new_v, long long row_stride,
                        TC* k_cache, TC* v_cache,
                        const int* __restrict__ positions, const Rows rows_in,
                        float* __restrict__ part, int nh, int hd, int chunk,
                        int nsplit, float sm_scale) {
  using V16 = Vec16<TC>;
  constexpr int VEC = V16::kN;
  constexpr int TPR = HD / VEC;          // threads a row
  static_assert(HD % VEC == 0 && TPR <= 32 && (TPR & (TPR - 1)) == 0,
                "HD / (16 bytes of cache elements) must be a power of two "
                "up to 32");
  constexpr int R = kThreads / TPR;      // rows a pass of the block
  const int W = hd + 2;                  // floats a partial
  extern __shared__ int staged[];
  __shared__ float wm[kWarps], wl[kWarps], wo[kWarps][HD];

  const int s = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int pos = positions[b];
  const int c0 = s * chunk;
  Rows rows = rows_in;
  // pos is uniform over the block: every thread returns, or reaches bind()
  if (pos < 0 || pos >= rows.rows() || c0 > pos) return;
  float* pp = part + ((static_cast<size_t>(b) * nh + h) * nsplit + s) * W;
  if (!rows.bind(b, pos, c0, chunk, staged)) {
    if (s == 0 && threadIdx.x == 0) pp[1] = -1.f;   // the merge answers 0
    return;
  }
  const size_t head = static_cast<size_t>(h) * hd;
  const size_t in_off = static_cast<size_t>(b) * row_stride + head;
  const int end = min(chunk, pos + 1 - c0);          // rows attended
  const bool wr = rows.writes(b);

  // 1. the block whose chunk holds pos writes the new row; no block reads
  //    it back (step 2 substitutes it), so no barrier is needed
  if (wr && pos - c0 < chunk) {
    const size_t w = rows.wrow + head;
    for (int d = threadIdx.x; d < hd; d += kThreads) {
      k_cache[w + d] = ptt::from_f32<TC>(ptt::to_f32(new_k[in_off + d]));
      v_cache[w + d] = ptt::from_f32<TC>(ptt::to_f32(new_v[in_off + d]));
    }
  }

  // 2. thread (rr, c): columns [c * VEC, c * VEC + VEC) of rows rr, rr + R,
  //    ... of each tile, and of q and the new row (rounded through the
  //    cache dtype: the value that lands); columns past hd are zeros
  const int c = threadIdx.x % TPR, rr = threadIdx.x / TPR;
  const bool mine = c * VEC < hd;        // any of the columns is the head's
  float qf[VEC];
  alignas(16) TC nk[VEC], nv[VEC];
#pragma unroll
  for (int v = 0; v < VEC; ++v) {
    const bool in = c * VEC + v < hd;
    qf[v] = in ? ptt::to_f32(q[in_off + c * VEC + v]) : 0.f;
    nk[v] = ptt::from_f32<TC>(
        in ? ptt::to_f32(new_k[in_off + c * VEC + v]) : 0.f);
    nv[v] = ptt::from_f32<TC>(
        in ? ptt::to_f32(new_v[in_off + c * VEC + v]) : 0.f);
  }
  const uint4 nk16 = *reinterpret_cast<const uint4*>(nk);
  const uint4 nv16 = *reinterpret_cast<const uint4*>(nv);
  const TC* kh = k_cache + head + c * VEC;
  const TC* vh = v_cache + head + c * VEC;

  // 3. online softmax per warp over its rows of each tile
  float m = -CUDART_INF_F, l = 0.f, o[VEC];
#pragma unroll
  for (int v = 0; v < VEC; ++v) o[v] = 0.f;
  for (int t0 = 0; t0 < end; t0 += R * kRowsAThread) {
    uint4 kv[kRowsAThread], vv[kRowsAThread];
#pragma unroll
    for (int i = 0; i < kRowsAThread; ++i) {
      const int r = t0 + rr + R * i;
      kv[i] = vv[i] = make_uint4(0u, 0u, 0u, 0u);
      if (r < end) {
        const size_t off = rows.row(r);
        if (wr && off == rows.wrow) {   // row pos, or a row aliasing it
          kv[i] = nk16;
          vv[i] = nv16;
        } else if (kVec) {
          if (mine) {
            kv[i] = *reinterpret_cast<const uint4*>(kh + off);
            vv[i] = *reinterpret_cast<const uint4*>(vh + off);
          }
        } else {
          alignas(16) TC ke[VEC], ve[VEC];
#pragma unroll
          for (int v = 0; v < VEC; ++v) {
            const bool in = c * VEC + v < hd;
            ke[v] = in ? kh[off + v] : ptt::from_f32<TC>(0.f);
            ve[v] = in ? vh[off + v] : ptt::from_f32<TC>(0.f);
          }
          kv[i] = *reinterpret_cast<const uint4*>(ke);
          vv[i] = *reinterpret_cast<const uint4*>(ve);
        }
      }
    }
    float sc[kRowsAThread];
    float mt = -CUDART_INF_F;
#pragma unroll
    for (int i = 0; i < kRowsAThread; ++i) {
      float kf[VEC];
      V16::to_f32(kv[i], kf);
      float acc = 0.f;
#pragma unroll
      for (int v = 0; v < VEC; ++v) acc = fmaf(qf[v], kf[v], acc);
#pragma unroll
      for (int off = TPR / 2; off > 0; off >>= 1)
        acc += __shfl_xor_sync(0xffffffffu, acc, off);
      sc[i] = t0 + rr + R * i < end ? acc * sm_scale : -CUDART_INF_F;
      mt = fmaxf(mt, sc[i]);
    }
#pragma unroll
    for (int off = TPR; off < 32; off <<= 1)
      mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, off));
    if (mt == -CUDART_INF_F) continue;   // warp-uniform: no row of its own
    const float mn = fmaxf(m, mt);
    const float corr = expf(m - mn);     // 0 while m is -inf
    l *= corr;
#pragma unroll
    for (int v = 0; v < VEC; ++v) o[v] *= corr;
#pragma unroll
    for (int i = 0; i < kRowsAThread; ++i) {
      const float p = expf(sc[i] - mn);  // 0 for a masked row
      float vf[VEC];
      V16::to_f32(vv[i], vf);
      l += p;
#pragma unroll
      for (int v = 0; v < VEC; ++v) o[v] = fmaf(p, vf[v], o[v]);
    }
    m = mn;
  }

  // 4. add the warp's row groups (lanes with the same c), then merge the
  //    four warps and write the partial
#pragma unroll
  for (int off = TPR; off < 32; off <<= 1) {
    l += __shfl_xor_sync(0xffffffffu, l, off);
#pragma unroll
    for (int v = 0; v < VEC; ++v)
      o[v] += __shfl_xor_sync(0xffffffffu, o[v], off);
  }
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane < TPR) {
#pragma unroll
    for (int v = 0; v < VEC; ++v) wo[warp][lane * VEC + v] = o[v];
  }
  if (lane == 0) {
    wm[warp] = m;
    wl[warp] = l;
  }
  __syncthreads();
  for (int d = threadIdx.x; d < hd; d += kThreads) {
    float M = -CUDART_INF_F;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) M = fmaxf(M, wm[w]);
    float L = 0.f, O = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      if (wm[w] == -CUDART_INF_F) continue;   // a warp without rows
      const float e = expf(wm[w] - M);
      L = fmaf(wl[w], e, L);
      O = fmaf(wo[w][d], e, O);
    }
    pp[2 + d] = O;
    if (d == 0) {
      pp[0] = M;
      pp[1] = L;
    }
  }
}

// The split route for hd > 128: grid (nsplit * ncb, nh, B), block
// (chunk s, column block cb) = blockIdx.x / ncb, % ncb. Every block of a
// chunk scores the chunk's rows over all hd; warp w takes rows w, w + 4,
// ..., its lanes columns lane, lane + 32, ... (one element each, any hd,
// no alignment), and keeps an online softmax in float32 with the
// accumulators of its column block's 128 columns (4 a lane). Column block
// 0 writes the new row (every block substitutes it, rounded through the
// cache dtype, wherever a row's address is the write address) and the
// partial's (m, l); each block writes its columns of o.
constexpr int kWideCols = 128;

template <typename TQ, typename TC, typename Rows>
__global__ void __launch_bounds__(kThreads)
    decode_wide_kernel(const TQ* __restrict__ q, const TQ* __restrict__ new_k,
                       const TQ* __restrict__ new_v, long long row_stride,
                       TC* k_cache, TC* v_cache,
                       const int* __restrict__ positions, const Rows rows_in,
                       float* __restrict__ part, int nh, int hd, int chunk,
                       int nsplit, int ncb, float sm_scale) {
  constexpr int kPer = kWideCols / 32;   // output columns a lane
  extern __shared__ int staged[];
  __shared__ float wm[kWarps], wl[kWarps], wo[kWarps][kWideCols];

  const int s = blockIdx.x / ncb, cb = blockIdx.x % ncb;
  const int h = blockIdx.y, b = blockIdx.z;
  const int pos = positions[b];
  const int c0 = s * chunk;
  Rows rows = rows_in;
  if (pos < 0 || pos >= rows.rows() || c0 > pos) return;
  const int W = hd + 2;
  float* pp = part + ((static_cast<size_t>(b) * nh + h) * nsplit + s) * W;
  if (!rows.bind(b, pos, c0, chunk, staged)) {
    if (s == 0 && cb == 0 && threadIdx.x == 0) pp[1] = -1.f;
    return;
  }
  const size_t head = static_cast<size_t>(h) * hd;
  const size_t in_off = static_cast<size_t>(b) * row_stride + head;
  const int end = min(chunk, pos + 1 - c0);
  const bool wr = rows.writes(b);
  if (wr && pos - c0 < chunk && cb == 0) {
    const size_t w = rows.wrow + head;
    for (int d = threadIdx.x; d < hd; d += kThreads) {
      k_cache[w + d] = ptt::from_f32<TC>(ptt::to_f32(new_k[in_off + d]));
      v_cache[w + d] = ptt::from_f32<TC>(ptt::to_f32(new_v[in_off + d]));
    }
  }
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int d0 = cb * kWideCols;
  const TC* kh = k_cache + head;
  const TC* vh = v_cache + head;
  float m = -CUDART_INF_F, l = 0.f, o[kPer];
#pragma unroll
  for (int i = 0; i < kPer; ++i) o[i] = 0.f;
  for (int r = warp; r < end; r += kWarps) {
    const size_t off = rows.row(r);
    const bool sub = wr && off == rows.wrow;   // row pos, or an alias
    float acc = 0.f;
    for (int d = lane; d < hd; d += 32) {
      const float kd =
          sub ? ptt::to_f32(ptt::from_f32<TC>(ptt::to_f32(new_k[in_off + d])))
              : ptt::to_f32(kh[off + d]);
      acc = fmaf(ptt::to_f32(q[in_off + d]), kd, acc);
    }
    const float sc = ptt::warp_sum(acc) * sm_scale;
    const float mn = fmaxf(m, sc);
    const float corr = expf(m - mn);           // 0 while m is -inf
    const float p = expf(sc - mn);
    l = fmaf(l, corr, p);
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const int d = d0 + lane + 32 * i;
      float vd = 0.f;
      if (d < hd)
        vd = sub ? ptt::to_f32(
                       ptt::from_f32<TC>(ptt::to_f32(new_v[in_off + d])))
                 : ptt::to_f32(vh[off + d]);
      o[i] = fmaf(p, vd, o[i] * corr);
    }
    m = mn;
  }
#pragma unroll
  for (int i = 0; i < kPer; ++i) wo[warp][lane + 32 * i] = o[i];
  if (lane == 0) {
    wm[warp] = m;
    wl[warp] = l;
  }
  __syncthreads();
  const int d = d0 + threadIdx.x;
  if (threadIdx.x < kWideCols && d < hd) {
    float M = -CUDART_INF_F;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) M = fmaxf(M, wm[w]);
    float L = 0.f, O = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      if (wm[w] == -CUDART_INF_F) continue;   // a warp without rows
      const float e = expf(wm[w] - M);
      L = fmaf(wl[w], e, L);
      O = fmaf(wo[w][threadIdx.x], e, O);
    }
    pp[2 + d] = O;
    if (cb == 0 && threadIdx.x == 0) {
      pp[0] = M;
      pp[1] = L;
    }
  }
}

// One block per (head, lane), HD threads of which the first hd work: lane
// b's partials 0..pos / chunk merged into out. The row policy rides along
// for rows() and so that a profile can tell the slab's merge from the
// paged one by name.
template <typename TQ, int HD, typename Rows>
__global__ void __launch_bounds__(HD)
    decode_merge_kernel(const float* __restrict__ part,
                        const int* __restrict__ positions, const Rows rows,
                        TQ* __restrict__ out, int nh, int hd, int chunk,
                        int nsplit) {
  const int W = hd + 2;
  const int h = blockIdx.x, b = blockIdx.y;
  const int d = blockIdx.z * HD + threadIdx.x;   // z: the wide route's
                                                 // column blocks
  if (d >= hd) return;
  const int pos = positions[b];
  TQ* ob = out + (static_cast<size_t>(b) * nh + h) * hd;
  const float* pp = part + (static_cast<size_t>(b) * nh + h) * nsplit * W;
  if (pos < 0 || pos >= rows.rows() || pp[1] < 0.f) {
    ob[d] = ptt::from_f32<TQ>(0.f);
    return;
  }
  const int n = pos / chunk + 1;
  float M = -CUDART_INF_F;
  for (int i = 0; i < n; ++i) M = fmaxf(M, pp[i * W]);
  if (!isfinite(M)) M = 0.f;
  float L = 0.f, O = 0.f;
  for (int i = 0; i < n; ++i) {
    const float mi = pp[i * W];
    if (mi == -CUDART_INF_F) continue;
    const float e = expf(mi - M);
    L = fmaf(pp[i * W + 1], e, L);
    O = fmaf(pp[i * W + 2 + d], e, O);
  }
  ob[d] = ptt::from_f32<TQ>(O / fmaxf(L, 1e-30f));
}

template <typename TQ, typename TC, int HD, bool kVec, typename Rows>
int launch_typed(const Args& a, const Rows& rows, cudaStream_t stream) {
  decode_split_kernel<TQ, TC, HD, kVec, Rows>
      <<<dim3(a.nsplit, a.nh, a.B), kThreads, Rows::smem_bytes(a.chunk),
         stream>>>(static_cast<const TQ*>(a.q),
                   static_cast<const TQ*>(a.new_k),
                   static_cast<const TQ*>(a.new_v), a.row_stride,
                   static_cast<TC*>(a.k_cache), static_cast<TC*>(a.v_cache),
                   a.positions, rows, a.part, a.nh, a.hd, a.chunk,
                   a.nsplit, a.sm_scale);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  decode_merge_kernel<TQ, HD, Rows><<<dim3(a.nh, a.B), HD, 0, stream>>>(
      a.part, a.positions, rows, static_cast<TQ*>(a.out), a.nh, a.hd,
      a.chunk, a.nsplit);
  return static_cast<int>(cudaGetLastError());
}

// The split route for hd > 128 (decode_wide_kernel, then the merge at
// HD 128 over the column blocks); returns the CUDA error.
template <typename Rows>
int launch_wide(const Args& a, const Rows& rows, int q_dtype, int c_dtype,
                cudaStream_t stream) {
  const int ncb = (a.hd + kWideCols - 1) / kWideCols;
  if (static_cast<long long>(a.nsplit) * ncb > 0x7fffffffLL || ncb > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto go = [&](auto tq, auto tc) -> int {
    using TQ = decltype(tq);
    using TC = decltype(tc);
    decode_wide_kernel<TQ, TC, Rows>
        <<<dim3(a.nsplit * ncb, a.nh, a.B), kThreads,
           Rows::smem_bytes(a.chunk), stream>>>(
            static_cast<const TQ*>(a.q), static_cast<const TQ*>(a.new_k),
            static_cast<const TQ*>(a.new_v), a.row_stride,
            static_cast<TC*>(a.k_cache), static_cast<TC*>(a.v_cache),
            a.positions, rows, a.part, a.nh, a.hd, a.chunk, a.nsplit, ncb,
            a.sm_scale);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    decode_merge_kernel<TQ, kWideCols, Rows>
        <<<dim3(a.nh, a.B, ncb), kWideCols, 0, stream>>>(
            a.part, a.positions, rows, static_cast<TQ*>(a.out), a.nh, a.hd,
            a.chunk, a.nsplit);
    return static_cast<int>(cudaGetLastError());
  };
  using BF = __nv_bfloat16;
  if (q_dtype == kF32 && c_dtype == kF32) return go(float{}, float{});
  if (q_dtype == kBF16 && c_dtype == kBF16) return go(BF{}, BF{});
  if (q_dtype == kF32 && c_dtype == kBF16) return go(float{}, BF{});
  if (q_dtype == kBF16 && c_dtype == kF32) return go(BF{}, float{});
  return static_cast<int>(cudaErrorInvalidValue);
}

// The most shared memory a block's row staging may take (the static
// arrays of the split kernel stay within the 48 KB default beside it).
constexpr size_t kMaxStagingBytes = 32 * 1024;

// Launch pass 1 and the merge for the four q-dtype / cache-dtype pairs and
// any hd: in 1..128 the instance HD is the power of two at or above hd (8
// at least), with 16-byte row loads where hd fills whole vectors of cache
// elements and scalar loads elsewhere; past 128 the split route
// (launch_wide); returns the CUDA error.
template <typename Rows>
int launch(const Args& a, const Rows& rows, int q_dtype, int c_dtype,
           void* stream) {
  if (a.B < 1 || a.B > 65535 || a.nh < 1 || a.nh > 65535 || a.chunk < 1 ||
      a.nsplit < 1 ||
      static_cast<long long>(a.chunk) * a.nsplit < rows.rows() ||
      Rows::smem_bytes(a.chunk) > kMaxStagingBytes)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (a.hd < 1) return static_cast<int>(cudaErrorInvalidValue);
  if (a.hd > 128) return launch_wide(a, rows, q_dtype, c_dtype, st);
  int inst = 8;
  while (inst < a.hd) inst *= 2;
  const auto by_hd = [&](auto tq, auto tc) -> int {
    using TQ = decltype(tq);
    using TC = decltype(tc);
    const bool vec = (a.hd * sizeof(TC)) % 16 == 0;
    const auto go = [&](auto hd_tag) -> int {
      constexpr int HD = decltype(hd_tag)::value;
      return vec ? launch_typed<TQ, TC, HD, true>(a, rows, st)
                 : launch_typed<TQ, TC, HD, false>(a, rows, st);
    };
    switch (inst) {
      case 8: return go(std::integral_constant<int, 8>{});
      case 16: return go(std::integral_constant<int, 16>{});
      case 32: return go(std::integral_constant<int, 32>{});
      case 64: return go(std::integral_constant<int, 64>{});
      default: return go(std::integral_constant<int, 128>{});
    }
  };
  using BF = __nv_bfloat16;
  if (q_dtype == kF32 && c_dtype == kF32) return by_hd(float{}, float{});
  if (q_dtype == kBF16 && c_dtype == kBF16) return by_hd(BF{}, BF{});
  if (q_dtype == kF32 && c_dtype == kBF16) return by_hd(float{}, BF{});
  if (q_dtype == kBF16 && c_dtype == kF32) return by_hd(BF{}, float{});
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace decode
}  // namespace ptt
