// Final layernorm + LM-head projection, one launch.
//
// Replaces: _logits_head_kernel, paddle_tpu/ops/pallas_kernels.py:1544
// (through fused_logits_head, :1556). logits[b, j] = sum_d y[b, d] *
// w[d, j], where y = LN(x) is recomputed per vocab tile with float32
// statistics and rounded to x's dtype before the product (as the TPU
// kernel rounds it), products accumulate in float32, and the result is
// rounded to x's dtype.
//
// What bounds it on the card: reading the weight. At GPT_SMALL, lm_head
// is 768 x 50304 bf16 = 77 MB, read once, against 2*B*D*V operations —
// with B = 8 that is 8 operations per weight byte, far under the card's
// ridge, so HBM bandwidth sets the floor (about 23 us at 3.35 TB/s).
//
// Design: one block per tile of 128 vocab columns, one thread per column.
// Each block recomputes the LN of the B rows into shared memory (B*D
// elements of x's dtype; B*D*elem <= 227 KB, so up to B = 64 at D = 768
// in either dtype), then each thread walks d and reads w[d, j] — the
// neighbouring threads of a warp read neighbouring columns of the
// row-major [D, V] weight, so every weight load is coalesced and each
// weight element is read exactly once — and keeps NB float32 sums in
// registers (NB >= B, a compile-time 8/16/32/64). The last tile masks
// the columns past V. No tensor cores yet: at B = 8 the HBM floor is
// what a later PR has to chase first.
#include "common.cuh"

namespace {

constexpr int kCols = 128;

template <typename T, int NB>
__global__ void __launch_bounds__(kCols)
    logits_head_kernel(const T* __restrict__ x,
                       const float* __restrict__ scale,
                       const float* __restrict__ bias,
                       const T* __restrict__ w, T* __restrict__ out, int B,
                       int D, int V, float eps) {
  extern __shared__ unsigned char smem_raw[];
  T* ys = reinterpret_cast<T*>(smem_raw);  // [B, D] normalised rows

  // 1. LN of the B rows, one warp per row
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  for (int b = warp; b < B; b += nwarps) {
    const T* xr = x + static_cast<size_t>(b) * D;
    float s = 0.f;
    for (int i = lane; i < D; i += 32) s += ptt::to_f32(xr[i]);
    const float mu = ptt::warp_sum(s) / static_cast<float>(D);
    float ss = 0.f;
    for (int i = lane; i < D; i += 32) {
      const float d = ptt::to_f32(xr[i]) - mu;
      ss += d * d;
    }
    const float var = ptt::warp_sum(ss) / static_cast<float>(D);
    const float rstd = rsqrtf(var + eps);
    T* yr = ys + static_cast<size_t>(b) * D;
    for (int i = lane; i < D; i += 32) {
      const float n = __fmul_rn(ptt::to_f32(xr[i]) - mu, rstd);
      yr[i] = ptt::from_f32<T>(__fadd_rn(__fmul_rn(n, scale[i]), bias[i]));
    }
  }
  __syncthreads();

  // 2. column j of the product
  const int j = blockIdx.x * kCols + threadIdx.x;
  if (j >= V) return;  // ragged last tile; no barrier follows
  float acc[NB];
#pragma unroll
  for (int b = 0; b < NB; ++b) acc[b] = 0.f;
  const T* wj = w + j;
  for (int d = 0; d < D; ++d) {
    const float wv = ptt::to_f32(wj[static_cast<size_t>(d) * V]);
#pragma unroll
    for (int b = 0; b < NB; ++b)
      if (b < B) acc[b] += ptt::to_f32(ys[b * D + d]) * wv;
  }
#pragma unroll
  for (int b = 0; b < NB; ++b)
    if (b < B) out[static_cast<size_t>(b) * V + j] = ptt::from_f32<T>(acc[b]);
}

template <typename T, int NB>
int run(const T* x, const float* scale, const float* bias, const T* w,
        T* out, int B, int D, int V, float eps, cudaStream_t stream) {
  const size_t smem = static_cast<size_t>(B) * D * sizeof(T);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        logits_head_kernel<T, NB>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const int tiles = (V + kCols - 1) / kCols;
  logits_head_kernel<T, NB><<<tiles, kCols, smem, stream>>>(
      x, scale, bias, w, out, B, D, V, eps);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch(const void* xv, const void* scalev, const void* biasv,
           const void* wv, void* outv, int B, int D, int V, float eps,
           cudaStream_t st) {
  const T* x = static_cast<const T*>(xv);
  const float* scale = static_cast<const float*>(scalev);
  const float* bias = static_cast<const float*>(biasv);
  const T* w = static_cast<const T*>(wv);
  T* out = static_cast<T*>(outv);
  if (B <= 8) return run<T, 8>(x, scale, bias, w, out, B, D, V, eps, st);
  if (B <= 16) return run<T, 16>(x, scale, bias, w, out, B, D, V, eps, st);
  if (B <= 32) return run<T, 32>(x, scale, bias, w, out, B, D, V, eps, st);
  if (B <= 64) return run<T, 64>(x, scale, bias, w, out, B, D, V, eps, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// x: [B, D], w: [D, V], out: [B, V], all contiguous in dtype `dtype`;
// scale, bias: [D] float32. 1 <= B <= 64 and B * D * elem <= 227 KB.
extern "C" int ptt_logits_head(const void* x, const void* scale,
                               const void* bias, const void* w, void* out,
                               int B, int D, int V, float eps, int dtype,
                               void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case ptt::kF32:
      return launch<float>(x, scale, bias, w, out, B, D, V, eps, st);
    case ptt::kBF16:
      return launch<__nv_bfloat16>(x, scale, bias, w, out, B, D, V, eps, st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
