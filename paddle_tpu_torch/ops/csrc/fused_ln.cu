// Fused layernorm, forward, every form.
//
// Replaces: _ln_fwd_kernel, paddle_tpu/ops/pallas_kernels.py:894 (through
// _ln_fwd :974 and fused_ln :1109):
//   s = dropout(x) + residual + bias_add   in x's dtype, rounded after each
//                                          step: x * mask, * inv_keep (in
//                                          x's dtype), residual + that,
//                                          + bias_add — the "(x + o) + b"
//                                          association of the GPT block
//   y = (s - mu) * rsqrt(var + eps) * scale + bias
// with float32 statistics (two-pass population variance) and y in x's
// dtype. The form is a compile-time bit set (residual, bias_add, mask);
// any of them makes the kernel also write s; mu and rstd (one float32 a
// row; the TPU kept 128 replicated lanes) are written unless the caller
// passes no buffer for them (serving's decode tick).
//
// What bounds it on the card: HBM. At the training shape ([16384, 768]
// bf16) the ln2 form reads x and the residual and writes y and s, ~100 MB,
// the plain form half that, against ~10 operations an element; at the
// decode tick (8 rows) the launch itself.
//
// Design: one warp a row, four rows a block, no shared memory and no block
// barrier. Each lane holds its columns of the row in registers, in chunks
// of one 16-byte vector (8 bf16 or 4 float32): x, the residual and the
// bias_add come as 16-byte loads and the bool mask as 8- or 4-byte loads,
// all of them issued before the first reduction. s is built in registers
// with round-to-nearest intrinsics (__fmul_rn, __fadd_rn), so nvcc cannot
// contract them into a multiply-add that rounds differently, and is
// stored (16-byte stores) before the statistics; the mean and then the
// centred second moment are warp shuffles over the register copy; scale
// and bias (float4 loads, L1 hits after the first rows) load after the
// reductions, which keeps 2 x kE registers free across them (89 against
// 128 registers for the ln2 form at D = 768, and faster on the card:
// PERF.md); y goes out as 16-byte stores and lane 0 writes mu and rstd.
// The instance is a template on the elements a lane holds (kE, from 8 to
// 64: D up to 2048 on the register path), chosen on the host from D and
// the operands' alignment (ops/fused_ln.py fused_ln_plan). A row of D not
// a multiple of the vector, or an operand not aligned to it, takes the
// same kernel with one coalesced scalar access an element; D past 2048
// the block-a-row kernel below, its float32 row in shared memory (opted
// in past 48 KB, up to about 57,000 columns); past that the two-pass
// block-a-row kernel, which keeps no row and recomputes s from its inputs
// with the same rounded steps in each pass, so s and the statistics are
// bitwise those of the one-pass kernel. The design before this one ran a
// 256-thread block a row through shared memory: 2-byte scalar accesses,
// six block barriers a row and at most 8 rows in flight an SM.
#include <cstdint>

#include "common.cuh"

namespace {

// form bits, also the order of the optional operands
constexpr int kRes = 1, kBadd = 2, kMask = 4;
// rows a block on the warp-a-row path (2 and 8 ran no faster on an H100)
constexpr int kWarps = 4;
constexpr int kRowThreads = 256;   // threads a row on the block-a-row path

// x rounded to T and back: the reference rounds s to x's dtype each step
template <typename T>
__device__ __forceinline__ float rnd(float v) {
  return ptt::to_f32(ptt::from_f32<T>(v));
}

template <typename T, int kForm, bool kVec, int kE>
__global__ void __launch_bounds__(kWarps * 32)
    fused_ln_fwd_kernel(const T* __restrict__ x, const T* __restrict__ res,
                        const T* __restrict__ badd,
                        const unsigned char* __restrict__ mask,
                        const float* __restrict__ scale,
                        const float* __restrict__ bias, T* __restrict__ y,
                        T* __restrict__ s_out, float* __restrict__ mu_out,
                        float* __restrict__ rstd_out, int R, int D,
                        float eps, float inv_keep) {
  constexpr int kW = 16 / sizeof(T);   // elements a chunk
  constexpr int kN = kE / kW;          // chunks a lane
  const int r = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (r >= R) return;                  // the whole warp: no shuffle waits
  const ptt::LaneCols<kVec, kW> c{static_cast<int>(threadIdx.x & 31), D};
  const size_t off = static_cast<size_t>(r) * D;
  ptt::Pack<T, kW> xv[kN], rv[kN], bv[kN];
  ptt::Pack<unsigned char, kW> mv[kN];
#pragma unroll
  for (int j = 0; j < kN; ++j) {
    if (!c.in(j, 0)) continue;
    xv[j] = ptt::load_chunk(x + off, c, j);
    if (kForm & kRes) rv[j] = ptt::load_chunk(res + off, c, j);
    if (kForm & kMask) mv[j] = ptt::load_chunk(mask + off, c, j);
    if (kForm & kBadd) bv[j] = ptt::load_chunk(badd, c, j);
  }
  float v[kN][kW];
  float sum = 0.f;
#pragma unroll
  for (int j = 0; j < kN; ++j) {
#pragma unroll
    for (int i = 0; i < kW; ++i) {
      float e = ptt::to_f32(xv[j].e[i]);
      if (kForm & kMask) {
        e = rnd<T>(__fmul_rn(e, mv[j].e[i] ? 1.f : 0.f));
        e = rnd<T>(__fmul_rn(e, inv_keep));
      }
      if (kForm & kRes) e = rnd<T>(__fadd_rn(ptt::to_f32(rv[j].e[i]), e));
      if (kForm & kBadd) e = rnd<T>(__fadd_rn(e, ptt::to_f32(bv[j].e[i])));
      v[j][i] = c.in(j, i) ? e : 0.f;
      sum += v[j][i];
    }
    if (kForm && c.in(j, 0)) ptt::store_chunk(s_out + off, c, j, v[j]);
  }
  const float mu = ptt::warp_sum(sum) / static_cast<float>(D);
  float ss = 0.f;
#pragma unroll
  for (int j = 0; j < kN; ++j) {
#pragma unroll
    for (int i = 0; i < kW; ++i) {
      const float d = v[j][i] - mu;
      if (c.in(j, i)) ss += d * d;
    }
  }
  const float rstd =
      rsqrtf(ptt::warp_sum(ss) / static_cast<float>(D) + eps);
#pragma unroll
  for (int j = 0; j < kN; ++j) {
    if (!c.in(j, 0)) continue;
    // scale and bias load here, not with the row: [D] vectors every row
    // reads (L1 and L2 hits), and 2 x kE registers fewer across the
    // reductions
    float sc[kW], bi[kW], o[kW];
    ptt::load_chunk_f32(scale, c, j, sc);
    ptt::load_chunk_f32(bias, c, j, bi);
#pragma unroll
    for (int i = 0; i < kW; ++i)
      o[i] = __fadd_rn(__fmul_rn(__fmul_rn(v[j][i] - mu, rstd), sc[i]),
                       bi[i]);
    ptt::store_chunk(y + off, c, j, o);
  }
  if (mu_out != nullptr && c.lane == 0) {
    mu_out[r] = mu;
    rstd_out[r] = rstd;
  }
}

// Element i of s for the row at off: the forward's rounded steps.
template <typename T, int kForm>
__device__ __forceinline__ float s_elem(const T* __restrict__ x,
                                        const T* __restrict__ res,
                                        const T* __restrict__ badd,
                                        const unsigned char* __restrict__ mask,
                                        size_t off, int i, float inv_keep) {
  float e = ptt::to_f32(x[off + i]);
  if (kForm & kMask) {
    e = rnd<T>(__fmul_rn(e, mask[off + i] ? 1.f : 0.f));
    e = rnd<T>(__fmul_rn(e, inv_keep));
  }
  if (kForm & kRes) e = rnd<T>(__fadd_rn(ptt::to_f32(res[off + i]), e));
  if (kForm & kBadd) e = rnd<T>(__fadd_rn(e, ptt::to_f32(badd[i])));
  return e;
}

// The block-a-row path, for rows past the register path's 2048 columns:
// one block of 256 threads a row, the row in shared memory as float32 (s
// built on the way in), two block reductions.
template <typename T, int kForm>
__global__ void __launch_bounds__(kRowThreads)
    fused_ln_fwd_kernel_rowblock(
        const T* __restrict__ x, const T* __restrict__ res,
        const T* __restrict__ badd, const unsigned char* __restrict__ mask,
        const float* __restrict__ scale, const float* __restrict__ bias,
        T* __restrict__ y, T* __restrict__ s_out, float* __restrict__ mu_out,
        float* __restrict__ rstd_out, int R, int D, float eps,
        float inv_keep) {
  extern __shared__ float row[];  // D floats
  __shared__ float scratch[32];
  const size_t off = static_cast<size_t>(blockIdx.x) * D;
  float s = 0.f;
  for (int i = threadIdx.x; i < D; i += blockDim.x) {
    const float e = s_elem<T, kForm>(x, res, badd, mask, off, i, inv_keep);
    if (kForm) s_out[off + i] = ptt::from_f32<T>(e);
    row[i] = e;
    s += e;
  }
  const float mu = ptt::block_sum(s, scratch) / static_cast<float>(D);
  float ss = 0.f;
  for (int i = threadIdx.x; i < D; i += blockDim.x) {
    const float d = row[i] - mu;
    ss += d * d;
  }
  const float var = ptt::block_sum(ss, scratch) / static_cast<float>(D);
  const float rstd = rsqrtf(var + eps);
  T* yr = y + off;
  for (int i = threadIdx.x; i < D; i += blockDim.x) {
    const float n = __fmul_rn(row[i] - mu, rstd);
    yr[i] = ptt::from_f32<T>(__fadd_rn(__fmul_rn(n, scale[i]), bias[i]));
  }
  if (mu_out != nullptr && threadIdx.x == 0) {
    mu_out[blockIdx.x] = mu;
    rstd_out[blockIdx.x] = rstd;
  }
}

// The two-pass block-a-row path, for rows whose float32 copy does not fit
// a block's shared memory: the same block and reductions as above, with s
// recomputed from x (and the residual, mask, bias_add) in each pass
// instead of kept: pass 1 writes s and sums it, pass 2 sums the centred
// squares, pass 3 writes y. Each thread walks the same columns in the same
// order as the one-pass kernel, so the statistics match it bitwise.
template <typename T, int kForm>
__global__ void __launch_bounds__(kRowThreads)
    fused_ln_fwd_kernel_twopass(
        const T* __restrict__ x, const T* __restrict__ res,
        const T* __restrict__ badd, const unsigned char* __restrict__ mask,
        const float* __restrict__ scale, const float* __restrict__ bias,
        T* __restrict__ y, T* __restrict__ s_out, float* __restrict__ mu_out,
        float* __restrict__ rstd_out, int R, int D, float eps,
        float inv_keep) {
  __shared__ float scratch[32];
  const size_t off = static_cast<size_t>(blockIdx.x) * D;
  float s = 0.f;
  for (int i = threadIdx.x; i < D; i += blockDim.x) {
    const float e = s_elem<T, kForm>(x, res, badd, mask, off, i, inv_keep);
    if (kForm) s_out[off + i] = ptt::from_f32<T>(e);
    s += e;
  }
  const float mu = ptt::block_sum(s, scratch) / static_cast<float>(D);
  float ss = 0.f;
  for (int i = threadIdx.x; i < D; i += blockDim.x) {
    const float d =
        s_elem<T, kForm>(x, res, badd, mask, off, i, inv_keep) - mu;
    ss += d * d;
  }
  const float var = ptt::block_sum(ss, scratch) / static_cast<float>(D);
  const float rstd = rsqrtf(var + eps);
  T* yr = y + off;
  for (int i = threadIdx.x; i < D; i += blockDim.x) {
    const float e = s_elem<T, kForm>(x, res, badd, mask, off, i, inv_keep);
    const float n = __fmul_rn(e - mu, rstd);
    yr[i] = ptt::from_f32<T>(__fadd_rn(__fmul_rn(n, scale[i]), bias[i]));
  }
  if (mu_out != nullptr && threadIdx.x == 0) {
    mu_out[blockIdx.x] = mu;
    rstd_out[blockIdx.x] = rstd;
  }
}

struct Args {
  const void *x, *res, *badd, *mask, *scale, *bias;
  void *y, *s, *mu, *rstd;
  int R, D;
  float eps, inv_keep;
};

template <typename T, int kForm, bool kVec, int kE>
int launch_warp(const Args& a, cudaStream_t stream) {
  const int blocks = (a.R + kWarps - 1) / kWarps;
  fused_ln_fwd_kernel<T, kForm, kVec, kE><<<blocks, kWarps * 32, 0,
                                            stream>>>(
      static_cast<const T*>(a.x), static_cast<const T*>(a.res),
      static_cast<const T*>(a.badd),
      static_cast<const unsigned char*>(a.mask),
      static_cast<const float*>(a.scale), static_cast<const float*>(a.bias),
      static_cast<T*>(a.y), static_cast<T*>(a.s),
      static_cast<float*>(a.mu), static_cast<float*>(a.rstd), a.R, a.D,
      a.eps, a.inv_keep);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int kForm>
int launch_rowblock(const Args& a, cudaStream_t stream) {
  const size_t smem = static_cast<size_t>(a.D) * sizeof(float);
  // the row and the 128-byte scratch may pass the 48 KB a block takes
  // without the opt-in
  if (smem > 47 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        fused_ln_fwd_kernel_rowblock<T, kForm>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  fused_ln_fwd_kernel_rowblock<T, kForm><<<a.R, kRowThreads, smem,
                                           stream>>>(
      static_cast<const T*>(a.x), static_cast<const T*>(a.res),
      static_cast<const T*>(a.badd),
      static_cast<const unsigned char*>(a.mask),
      static_cast<const float*>(a.scale), static_cast<const float*>(a.bias),
      static_cast<T*>(a.y), static_cast<T*>(a.s),
      static_cast<float*>(a.mu), static_cast<float*>(a.rstd), a.R, a.D,
      a.eps, a.inv_keep);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int kForm>
int launch_twopass(const Args& a, cudaStream_t stream) {
  fused_ln_fwd_kernel_twopass<T, kForm><<<a.R, kRowThreads, 0, stream>>>(
      static_cast<const T*>(a.x), static_cast<const T*>(a.res),
      static_cast<const T*>(a.badd),
      static_cast<const unsigned char*>(a.mask),
      static_cast<const float*>(a.scale), static_cast<const float*>(a.bias),
      static_cast<T*>(a.y), static_cast<T*>(a.s),
      static_cast<float*>(a.mu), static_cast<float*>(a.rstd), a.R, a.D,
      a.eps, a.inv_keep);
  return static_cast<int>(cudaGetLastError());
}

// lane_elems as ops/fused_ln.py fused_ln_plan gives it (8, 16, 24, 32 or
// 64; 0 for a block a row with the row in shared memory, -1 for the
// two-pass block a row); vec: 16-byte vectors, else scalar accesses
template <typename T, int kForm>
int launch(const Args& a, int lane_elems, bool vec, cudaStream_t st) {
  if (lane_elems == 0) return launch_rowblock<T, kForm>(a, st);
  if (lane_elems == -1) return launch_twopass<T, kForm>(a, st);
  switch (lane_elems + vec) {
    case 8: return launch_warp<T, kForm, false, 8>(a, st);
    case 9: return launch_warp<T, kForm, true, 8>(a, st);
    case 16: return launch_warp<T, kForm, false, 16>(a, st);
    case 17: return launch_warp<T, kForm, true, 16>(a, st);
    case 24: return launch_warp<T, kForm, false, 24>(a, st);
    case 25: return launch_warp<T, kForm, true, 24>(a, st);
    case 32: return launch_warp<T, kForm, false, 32>(a, st);
    case 33: return launch_warp<T, kForm, true, 32>(a, st);
    case 64: return launch_warp<T, kForm, false, 64>(a, st);
    case 65: return launch_warp<T, kForm, true, 64>(a, st);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

template <typename T>
int dispatch(int form, const Args& a, int lane_elems, bool vec,
             cudaStream_t st) {
  switch (form) {
    case 0: return launch<T, 0>(a, lane_elems, vec, st);
    case 1: return launch<T, 1>(a, lane_elems, vec, st);
    case 2: return launch<T, 2>(a, lane_elems, vec, st);
    case 3: return launch<T, 3>(a, lane_elems, vec, st);
    case 4: return launch<T, 4>(a, lane_elems, vec, st);
    case 5: return launch<T, 5>(a, lane_elems, vec, st);
    case 6: return launch<T, 6>(a, lane_elems, vec, st);
    case 7: return launch<T, 7>(a, lane_elems, vec, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// Whether every operand suits the vector instances: each [R, D] and [D]
// operand 16-byte aligned with D a multiple of the vector, the mask aligned
// to a chunk's bytes.
bool vectorizable(const Args& a, int vw) {
  const uintptr_t any16 =
      reinterpret_cast<uintptr_t>(a.x) | reinterpret_cast<uintptr_t>(a.res) |
      reinterpret_cast<uintptr_t>(a.badd) |
      reinterpret_cast<uintptr_t>(a.scale) |
      reinterpret_cast<uintptr_t>(a.bias) |
      reinterpret_cast<uintptr_t>(a.y) | reinterpret_cast<uintptr_t>(a.s);
  return a.D % vw == 0 && any16 % 16 == 0 &&
         reinterpret_cast<uintptr_t>(a.mask) % vw == 0;
}

}  // namespace

// x, y: [R, D] contiguous, dtype `dtype`; scale, bias: [D] float32.
// Optional (null when absent): res [R, D] and badd [D] in x's dtype, mask
// [R, D] bool (one byte an element), and then s [R, D] is written; mu and
// rstd [R] float32 are written when mu is not null. inv_keep is 1/keep
// already rounded to x's dtype. lane_elems: the instance, as
// fused_ln_plan picks it from D (0: a block a row, its row in shared
// memory; -1: the two-pass block a row); the operands' alignment picks
// 16-byte vectors or scalar accesses here.
extern "C" int ptt_fused_ln(const void* x, const void* res, const void* badd,
                            const void* mask, const void* scale,
                            const void* bias, void* y, void* s, void* mu,
                            void* rstd, int R, int D, float eps,
                            float inv_keep, int lane_elems, int dtype,
                            void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int form = (res ? kRes : 0) | (badd ? kBadd : 0) |
                   (mask ? kMask : 0);
  if ((form != 0) != (s != nullptr) || (mu == nullptr) != (rstd == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  // the one-pass block-a-row row and its 128-byte scratch within a
  // block's 227 KB of shared memory
  if (lane_elems < -1 ||
      (lane_elems == 0 ? D * sizeof(float) > 226 * 1024
                       : lane_elems > 0 && 32 * lane_elems < D))
    return static_cast<int>(cudaErrorInvalidValue);
  const Args a{x, res, badd, mask, scale, bias, y, s, mu, rstd, R, D, eps,
               inv_keep};
  switch (dtype) {
    case ptt::kF32:
      return dispatch<float>(form, a, lane_elems, vectorizable(a, 4), st);
    case ptt::kBF16:
      return dispatch<__nv_bfloat16>(form, a, lane_elems,
                                     vectorizable(a, 8), st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
