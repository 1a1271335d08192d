// Fused layernorm, backward.
//
// Replaces: _ln_bwd_kernel, paddle_tpu/ops/pallas_kernels.py:931 (called
// through _fused_ln_vjp_bwd :1046-1103). Per row, with s the forward's
// pre-norm sum (or x itself for the plain form) and its float32 mu, rstd:
//   xhat = (s - mu) * rstd,  g = dy * scale
//   ds   = rstd * (g - mean(g) - xhat * mean(g * xhat))  (+ dsx, the
//          cotangent of the returned s)          stored in s's dtype
//   dx   = ds * mask * inv_keep                  (dropout form only)
// and dscale = sum over rows of dy * xhat, dbias = sum of dy, float32,
// summed in an order fixed by the launch shape: no float atomics, so two
// launches give the same bits (the reference sums its (ngrid, D) partials
// outside the kernel).
//
// What bounds it on the card: HBM. At the training shape ([16384, 768]
// bf16, with dsx) it reads s, dy and dsx and writes ds, ~100 MB, with a
// few tens of operations an element.
//
// Design: one warp a row, four warps a block, and a grid of one wave: the
// SMs times the blocks an SM holds at the kernel's registers (the
// occupancy API, through ptt_ln_bwd_blocks_per_sm; ops/fused_ln.py
// ln_bwd_plan / ln_bwd_grid). Warp w of W walks rows w, w + W, w + 2W,
// ...; each lane holds its columns of a row in registers as the forward
// does (chunks of one 16-byte vector: s, dy and dsx as 16-byte loads, the
// mask as 8- or 4-byte loads, all of a row's loads issued together),
// scale once for all its rows, and its dscale/dbias partials across the
// rows. Both row means come from one paired warp-shuffle reduction; ds
// (+ dsx) and dx go out as 16-byte stores; no block barrier until the
// end, where the block's warps add their partials through shared memory
// in warp order and the block writes one [D] row. A second small kernel
// (ln_bwd_kernel_finalize) adds the blocks' rows in a fixed order (on an
// H100, about 2 us where a torch sum over the same rows took 9). Rows of D
// not a multiple of the vector, or operands not aligned to it, take the
// same kernel with one coalesced scalar access an element; D past the
// register path's 1024 (up to 2048) the block-a-row kernel below, and
// past 2048 its looped form, which holds no row in registers: it walks
// the row in chunks twice, reading s and dy again (mostly from L2) in
// the second pass, and keeps its dscale/dbias partials in the block's
// own partial row in device memory. The
// design before this one walked 32 rows a 256-thread block, each row one
// dependent chain of 2-byte loads, three block barriers and 2-byte
// stores, at 3.9 blocks an SM. Registers bound this one (168 at 24
// elements a lane with dsx: 3 blocks, 12 warps an SM); loading the next
// row before this row's reduction, two rows a warp at once, partials in
// shared memory and reading s and dy again in the second pass each cost
// registers or shared-memory traffic and ran slower on the card
// (PERF.md).
#include <cstdint>

#include "common.cuh"

namespace {

constexpr int kWarps = 4;           // warps a block on the warp-a-row path
constexpr int kRowThreads = 256;    // the block-a-row path
constexpr int kRowCols = 8;         // columns a thread there: D <= 2048

// One row's operands as a lane loads them.
template <typename T, int kW, int kN, bool kDsx, bool kMask>
struct RowIn {
  ptt::Pack<T, kW> s[kN], dy[kN], dsx[kDsx ? kN : 1];
  ptt::Pack<unsigned char, kW> mask[kMask ? kN : 1];
  float mu, rstd;
};

template <bool kVec, typename T, int kW, int kN, bool kDsx, bool kMask>
__device__ __forceinline__ void load_row(
    RowIn<T, kW, kN, kDsx, kMask>& in, const T* __restrict__ sx,
    const T* __restrict__ dy, const T* __restrict__ dsx,
    const unsigned char* __restrict__ mask, const float* __restrict__ mu,
    const float* __restrict__ rstd, ptt::LaneCols<kVec, kW> c, int r) {
  const size_t off = static_cast<size_t>(r) * c.D;
#pragma unroll
  for (int j = 0; j < kN; ++j) {
    if (!c.in(j, 0)) continue;
    in.s[j] = ptt::load_chunk(sx + off, c, j);
    in.dy[j] = ptt::load_chunk(dy + off, c, j);
    if (kDsx) in.dsx[j] = ptt::load_chunk(dsx + off, c, j);
    if (kMask) in.mask[j] = ptt::load_chunk(mask + off, c, j);
  }
  in.mu = mu[r];
  in.rstd = rstd[r];
}

template <typename T, bool kDsx, bool kMask, bool kVec, int kE>
__global__ void __launch_bounds__(kWarps * 32)
    ln_bwd_kernel(const T* __restrict__ sx, const float* __restrict__ mu,
                  const float* __restrict__ rstd,
                  const float* __restrict__ scale, const T* __restrict__ dy,
                  const T* __restrict__ dsx,
                  const unsigned char* __restrict__ mask,
                  T* __restrict__ ds_out, T* __restrict__ dx_out,
                  float* __restrict__ dscale_part,
                  float* __restrict__ dbias_part, int R, int D,
                  float inv_keep) {
  extern __shared__ float acc[];  // 2 * D: the block's dscale, dbias
  constexpr int kW = 16 / sizeof(T);
  constexpr int kN = kE / kW;
  const int warp = threadIdx.x >> 5;
  const ptt::LaneCols<kVec, kW> c{static_cast<int>(threadIdx.x & 31), D};
  const float inv_d = 1.f / static_cast<float>(D);
  float sc[kN][kW], dsc[kN][kW], dbi[kN][kW];
#pragma unroll
  for (int j = 0; j < kN; ++j) {
    if (c.in(j, 0)) ptt::load_chunk_f32(scale, c, j, sc[j]);
#pragma unroll
    for (int i = 0; i < kW; ++i) dsc[j][i] = dbi[j][i] = 0.f;
  }
  // warp w of the grid's W walks rows w, w + W, w + 2W, ...
  for (int r = blockIdx.x * kWarps + warp; r < R;
       r += gridDim.x * kWarps) {
    RowIn<T, kW, kN, kDsx, kMask> in;
    load_row(in, sx, dy, dsx, mask, mu, rstd, c, r);
    const float m = in.mu, rs = in.rstd;
    float sums[2] = {0.f, 0.f};   // sum of g, of g * xhat
#pragma unroll
    for (int j = 0; j < kN; ++j) {
#pragma unroll
      for (int i = 0; i < kW; ++i) {
        if (!c.in(j, i)) continue;
        const float d = ptt::to_f32(in.dy[j].e[i]);
        const float xh = (ptt::to_f32(in.s[j].e[i]) - m) * rs;
        const float g = d * sc[j][i];
        sums[0] += g;
        sums[1] += g * xh;
        dsc[j][i] += d * xh;
        dbi[j][i] += d;
      }
    }
    ptt::warp_sum_n(sums);
    const float gm = sums[0] * inv_d, gxm = sums[1] * inv_d;
    const size_t off = static_cast<size_t>(r) * D;
#pragma unroll
    for (int j = 0; j < kN; ++j) {
      if (!c.in(j, 0)) continue;
      float ds[kW], dx[kW];
#pragma unroll
      for (int i = 0; i < kW; ++i) {
        const float xh = (ptt::to_f32(in.s[j].e[i]) - m) * rs;
        const float g = ptt::to_f32(in.dy[j].e[i]) * sc[j][i];
        ds[i] = rs * (g - gm - xh * gxm);
        if (kDsx) ds[i] += ptt::to_f32(in.dsx[j].e[i]);
        if (kMask)
          dx[i] = __fmul_rn(__fmul_rn(ds[i], in.mask[j].e[i] ? 1.f : 0.f),
                            inv_keep);
      }
      ptt::store_chunk(ds_out + off, c, j, ds);
      if (kMask) ptt::store_chunk(dx_out + off, c, j, dx);
    }
  }
  // the block's partials: warp 0's, then each next warp's added in order
#pragma unroll 1
  for (int w = 0; w < kWarps; ++w) {
    if (warp == w) {
#pragma unroll
      for (int j = 0; j < kN; ++j) {
#pragma unroll
        for (int i = 0; i < kW; ++i) {
          if (!c.in(j, i)) continue;
          const int col = c.col(j, i);
          acc[col] = w == 0 ? dsc[j][i] : acc[col] + dsc[j][i];
          acc[D + col] = w == 0 ? dbi[j][i] : acc[D + col] + dbi[j][i];
        }
      }
    }
    __syncthreads();
  }
  const size_t poff = static_cast<size_t>(blockIdx.x) * D;
  for (int i = threadIdx.x; i < D; i += blockDim.x) {
    dscale_part[poff + i] = acc[i];
    dbias_part[poff + i] = acc[D + i];
  }
}

// (a, b) summed over the block, broadcast to every thread; `scratch` is 64
// floats of shared memory.
__device__ __forceinline__ float2 block_sum2(float a, float b,
                                             float* scratch) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  float v[2] = {a, b};
  ptt::warp_sum_n(v);
  __syncthreads();
  if (lane == 0) {
    scratch[warp] = v[0];
    scratch[32 + warp] = v[1];
  }
  __syncthreads();
  if (warp == 0) {
    v[0] = lane < nwarps ? scratch[lane] : 0.f;
    v[1] = lane < nwarps ? scratch[32 + lane] : 0.f;
    ptt::warp_sum_n(v);
    if (lane == 0) {
      scratch[0] = v[0];
      scratch[32] = v[1];
    }
  }
  __syncthreads();
  return make_float2(scratch[0], scratch[32]);
}

// The block-a-row path, for rows past the register path's 1024 columns:
// block b of G walks rows b, b + G, ...; each thread keeps its columns of
// the row in registers (eight a thread) and its dscale/dbias sums across
// the rows; one two-value block reduction a row.
template <typename T, bool kDsx, bool kMask>
__global__ void __launch_bounds__(kRowThreads)
    ln_bwd_kernel_rowblock(const T* __restrict__ sx,
                           const float* __restrict__ mu,
                           const float* __restrict__ rstd,
                           const float* __restrict__ scale,
                           const T* __restrict__ dy,
                           const T* __restrict__ dsx,
                           const unsigned char* __restrict__ mask,
                           T* __restrict__ ds_out, T* __restrict__ dx_out,
                           float* __restrict__ dscale_part,
                           float* __restrict__ dbias_part, int R, int D,
                           float inv_keep) {
  __shared__ float scratch[64];
  float dsc[kRowCols], dbi[kRowCols], g[kRowCols], xh[kRowCols];
#pragma unroll
  for (int c = 0; c < kRowCols; ++c) dsc[c] = dbi[c] = 0.f;
  const float inv_d = 1.f / static_cast<float>(D);
  for (int r = blockIdx.x; r < R; r += gridDim.x) {
    const size_t off = static_cast<size_t>(r) * D;
    const float m = mu[r], rs = rstd[r];
    float sg = 0.f, sgx = 0.f;
#pragma unroll
    for (int c = 0; c < kRowCols; ++c) {
      const int i = threadIdx.x + c * kRowThreads;
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
    for (int c = 0; c < kRowCols; ++c) {
      const int i = threadIdx.x + c * kRowThreads;
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
  for (int c = 0; c < kRowCols; ++c) {
    const int i = threadIdx.x + c * kRowThreads;
    if (i < D) {
      dscale_part[poff + i] = dsc[c];
      dbias_part[poff + i] = dbi[c];
    }
  }
}

// The block-a-row path past 2048 columns: block b of G walks rows b, b +
// G, ...; thread t takes columns t, t + 256, ... of every row. Pass 1
// reads s and dy for the two row sums and adds dy * xhat and dy to the
// block's partial rows (each column only ever touched by its one thread,
// so the adds need no atomics and keep the row order); pass 2, after the
// block reduction, reads s and dy (and dsx, the mask) again and writes
// ds (and dx).
template <typename T, bool kDsx, bool kMask>
__global__ void __launch_bounds__(kRowThreads)
    ln_bwd_kernel_rowloop(const T* __restrict__ sx,
                          const float* __restrict__ mu,
                          const float* __restrict__ rstd,
                          const float* __restrict__ scale,
                          const T* __restrict__ dy,
                          const T* __restrict__ dsx,
                          const unsigned char* __restrict__ mask,
                          T* __restrict__ ds_out, T* __restrict__ dx_out,
                          float* __restrict__ dscale_part,
                          float* __restrict__ dbias_part, int R, int D,
                          float inv_keep) {
  __shared__ float scratch[64];
  const size_t poff = static_cast<size_t>(blockIdx.x) * D;
  float* dsc = dscale_part + poff;
  float* dbi = dbias_part + poff;
  for (int i = threadIdx.x; i < D; i += kRowThreads) dsc[i] = dbi[i] = 0.f;
  const float inv_d = 1.f / static_cast<float>(D);
  for (int r = blockIdx.x; r < R; r += gridDim.x) {
    const size_t off = static_cast<size_t>(r) * D;
    const float m = mu[r], rs = rstd[r];
    float sg = 0.f, sgx = 0.f;
    for (int i = threadIdx.x; i < D; i += kRowThreads) {
      const float d = ptt::to_f32(dy[off + i]);
      const float xh = (ptt::to_f32(sx[off + i]) - m) * rs;
      const float g = d * scale[i];
      sg += g;
      sgx += g * xh;
      dsc[i] += d * xh;
      dbi[i] += d;
    }
    const float2 sums = block_sum2(sg, sgx, scratch);
    const float gm = sums.x * inv_d, gxm = sums.y * inv_d;
    for (int i = threadIdx.x; i < D; i += kRowThreads) {
      const float xh = (ptt::to_f32(sx[off + i]) - m) * rs;
      const float g = ptt::to_f32(dy[off + i]) * scale[i];
      float ds = rs * (g - gm - xh * gxm);
      if (kDsx) ds += ptt::to_f32(dsx[off + i]);
      ds_out[off + i] = ptt::from_f32<T>(ds);
      if (kMask)
        dx_out[off + i] = ptt::from_f32<T>(__fmul_rn(
            __fmul_rn(ds, mask[off + i] ? 1.f : 0.f), inv_keep));
    }
  }
}

// The second pass: dscale and dbias [D] as the sums of the G blocks'
// partial rows, in one fixed order. Block b takes 32 of the 2D columns
// (dscale's, then dbias's); thread (ty, tx) adds rows ty, ty + 32, ... of
// column 32b + tx, then thread (0, tx) adds the 32 sums in ty order.
constexpr int kFinCols = 32, kFinWalkers = 32;

__global__ void __launch_bounds__(kFinCols * kFinWalkers)
    ln_bwd_kernel_finalize(const float* __restrict__ dscale_part,
                           const float* __restrict__ dbias_part,
                           float* __restrict__ dscale,
                           float* __restrict__ dbias, int G, int D) {
  __shared__ float sums[kFinWalkers][kFinCols + 1];
  const int tx = threadIdx.x % kFinCols, ty = threadIdx.x / kFinCols;
  const int col = blockIdx.x * kFinCols + tx;
  const bool is_bias = col >= D;
  const int dcol = is_bias ? col - D : col;
  const float* p = (is_bias ? dbias_part : dscale_part) + dcol;
  float a = 0.f;
  if (col < 2 * D) {
#pragma unroll 4
    for (int b = ty; b < G; b += kFinWalkers)
      a += p[static_cast<size_t>(b) * D];
  }
  sums[ty][tx] = a;
  __syncthreads();
  if (ty == 0 && col < 2 * D) {
    float t = 0.f;
#pragma unroll
    for (int k = 0; k < kFinWalkers; ++k) t += sums[k][tx];
    (is_bias ? dbias : dscale)[dcol] = t;
  }
}

struct Args {
  const void *sx, *mu, *rstd, *scale, *dy, *dsx, *mask;
  void *ds, *dx, *dscale_part, *dbias_part, *dscale, *dbias;
  int R, D, blocks;
  float inv_keep;
};

// Launches `kernel` (threads a block, dynamic shared memory smem) or, with
// `bps`, asks the occupancy API how many of its blocks an SM holds.
template <typename T, typename Kernel>
int run(Kernel kernel, int threads, size_t smem, const Args& a, int* bps,
        cudaStream_t st) {
  if (bps != nullptr)
    return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        bps, kernel, threads, smem));
  kernel<<<a.blocks, threads, smem, st>>>(
      static_cast<const T*>(a.sx), static_cast<const float*>(a.mu),
      static_cast<const float*>(a.rstd), static_cast<const float*>(a.scale),
      static_cast<const T*>(a.dy), static_cast<const T*>(a.dsx),
      static_cast<const unsigned char*>(a.mask), static_cast<T*>(a.ds),
      static_cast<T*>(a.dx), static_cast<float*>(a.dscale_part),
      static_cast<float*>(a.dbias_part), a.R, a.D, a.inv_keep);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  ln_bwd_kernel_finalize<<<(2 * a.D + kFinCols - 1) / kFinCols,
                           kFinCols * kFinWalkers, 0, st>>>(
      static_cast<const float*>(a.dscale_part),
      static_cast<const float*>(a.dbias_part), static_cast<float*>(a.dscale),
      static_cast<float*>(a.dbias), a.blocks, a.D);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, bool kDsx, bool kMask, bool kVec, int kE>
int run_warp(const Args& a, int* bps, cudaStream_t st) {
  return run<T>(ln_bwd_kernel<T, kDsx, kMask, kVec, kE>, kWarps * 32,
                2 * static_cast<size_t>(a.D) * sizeof(float), a, bps, st);
}

// lane_elems as ops/fused_ln.py ln_bwd_plan gives it (8, 16, 24 or 32; 0
// for a block a row, -1 for its looped form past 2048 columns); vec:
// 16-byte vectors, else scalar accesses
template <typename T, bool kDsx, bool kMask>
int by_instance(const Args& a, int lane_elems, bool vec, int* bps,
                cudaStream_t st) {
  if (lane_elems == 0)
    return run<T>(ln_bwd_kernel_rowblock<T, kDsx, kMask>, kRowThreads, 0, a,
                  bps, st);
  if (lane_elems == -1)
    return run<T>(ln_bwd_kernel_rowloop<T, kDsx, kMask>, kRowThreads, 0, a,
                  bps, st);
  switch (lane_elems + vec) {
    case 8: return run_warp<T, kDsx, kMask, false, 8>(a, bps, st);
    case 9: return run_warp<T, kDsx, kMask, true, 8>(a, bps, st);
    case 16: return run_warp<T, kDsx, kMask, false, 16>(a, bps, st);
    case 17: return run_warp<T, kDsx, kMask, true, 16>(a, bps, st);
    case 24: return run_warp<T, kDsx, kMask, false, 24>(a, bps, st);
    case 25: return run_warp<T, kDsx, kMask, true, 24>(a, bps, st);
    case 32: return run_warp<T, kDsx, kMask, false, 32>(a, bps, st);
    case 33: return run_warp<T, kDsx, kMask, true, 32>(a, bps, st);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

template <typename T>
int dispatch(const Args& a, int lane_elems, bool vec, int* bps,
             cudaStream_t st) {
  if (a.dsx && a.mask)
    return by_instance<T, true, true>(a, lane_elems, vec, bps, st);
  if (a.dsx) return by_instance<T, true, false>(a, lane_elems, vec, bps, st);
  if (a.mask) return by_instance<T, false, true>(a, lane_elems, vec, bps, st);
  return by_instance<T, false, false>(a, lane_elems, vec, bps, st);
}

// Runs (or, with bps, sizes) the instance lane_elems, with 16-byte
// vectors where every operand is aligned to them and D is a multiple of
// the vector.
int entry(const Args& a, int lane_elems, int dtype, int* bps,
          cudaStream_t st) {
  const int vw = dtype == ptt::kF32 ? 4 : 8;
  const uintptr_t any16 = reinterpret_cast<uintptr_t>(a.sx) |
                          reinterpret_cast<uintptr_t>(a.dy) |
                          reinterpret_cast<uintptr_t>(a.dsx) |
                          reinterpret_cast<uintptr_t>(a.ds) |
                          reinterpret_cast<uintptr_t>(a.dx) |
                          reinterpret_cast<uintptr_t>(a.scale);
  const bool vec = a.D % vw == 0 && any16 % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(a.mask) % vw == 0;
  if (lane_elems < -1 ||
      (lane_elems == 0 ? a.D > kRowThreads * kRowCols
                       : lane_elems > 0 && 32 * lane_elems < a.D))
    return static_cast<int>(cudaErrorInvalidValue);
  switch (dtype) {
    case ptt::kF32:
      return dispatch<float>(a, lane_elems, vec, bps, st);
    case ptt::kBF16:
      return dispatch<__nv_bfloat16>(a, lane_elems, vec, bps, st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// sx, dy, ds: [R, D] contiguous, dtype `dtype`; mu, rstd: [R] float32;
// scale: [D] float32; dscale_part, dbias_part: [blocks, D] float32
// scratch; dscale, dbias: [D] float32, written by the second pass.
// Optional (null when absent): dsx [R, D] in sx's dtype; mask [R, D] bool,
// and then dx [R, D] is written. inv_keep is 1/keep in float32.
// lane_elems and blocks: the instance and grid, as ln_bwd_plan and
// ln_bwd_grid pick them.
extern "C" int ptt_ln_bwd(const void* sx, const void* mu, const void* rstd,
                          const void* scale, const void* dy, const void* dsx,
                          const void* mask, void* ds, void* dx,
                          void* dscale_part, void* dbias_part, void* dscale,
                          void* dbias, int R, int D, int lane_elems,
                          int blocks, float inv_keep, int dtype,
                          void* stream) {
  if (blocks < 1 || (mask != nullptr) != (dx != nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const Args a{sx, mu, rstd, scale, dy, dsx, mask, ds, dx, dscale_part,
               dbias_part, dscale, dbias, R, D, blocks, inv_keep};
  return entry(a, lane_elems, dtype, nullptr,
               static_cast<cudaStream_t>(stream));
}

// The blocks an SM holds of the instance lane_elems (16-byte vectors) of
// the form (has_dsx, has_mask) at row width D, into *out: the occupancy
// API at the kernel's registers and shared memory.
extern "C" int ptt_ln_bwd_blocks_per_sm(int D, int lane_elems, int has_dsx,
                                        int has_mask, int dtype, int* out) {
  // any 16-byte aligned pointer stands in for the operands
  static __align__(16) char dummy[16];
  const void* p = has_dsx ? dummy : nullptr;
  const void* m = has_mask ? dummy : nullptr;
  const Args a{dummy, dummy, dummy, dummy, dummy, p, m, dummy,
               has_mask ? dummy : nullptr, dummy, dummy, dummy, dummy,
               0, D, 1, 1.f};
  return entry(a, lane_elems, dtype, out, nullptr);
}
