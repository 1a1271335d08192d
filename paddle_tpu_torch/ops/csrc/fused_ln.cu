// Fused layernorm, forward, plain form.
//
// Replaces: _ln_fwd_kernel, paddle_tpu/ops/pallas_kernels.py:894 (through
// fused_ln, :1109) in the form the serving decode tick uses — no residual,
// no bias-add, no dropout mask: y = (x - mu) * rsqrt(var + eps) * scale +
// bias, statistics in float32 (population variance), y in x's dtype.
//
// What bounds it on the card: at the decode tick's shape (R = 8 rows of
// D = 768) the work is ~30 KB of bytes and a few thousand operations, so
// the launch itself (a few microseconds) is the bound, not HBM or the
// ALUs. Design: one block per row, 256 threads; the row is read once from
// HBM into shared memory as float32, then two block reductions give the
// mean and the centred second moment (the two-pass variance jnp.var
// computes), and the normalised row is written once. The final affine
// step uses round-to-nearest multiply and add, not a fused multiply-add,
// so it rounds where the plain PyTorch version rounds.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;

template <typename T>
__global__ void __launch_bounds__(kThreads)
    fused_ln_fwd_kernel(const T* __restrict__ x,
                        const float* __restrict__ scale,
                        const float* __restrict__ bias, T* __restrict__ y,
                        int D, float eps) {
  extern __shared__ float row[];  // D floats
  __shared__ float scratch[32];
  const size_t off = static_cast<size_t>(blockIdx.x) * D;
  const T* xr = x + off;
  float s = 0.f;
  for (int i = threadIdx.x; i < D; i += blockDim.x) {
    const float v = ptt::to_f32(xr[i]);
    row[i] = v;
    s += v;
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
}

template <typename T>
int launch(const void* x, const void* scale, const void* bias, void* y,
           int R, int D, float eps, cudaStream_t stream) {
  const size_t smem = static_cast<size_t>(D) * sizeof(float);
  fused_ln_fwd_kernel<T><<<R, kThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(scale),
      static_cast<const float*>(bias), static_cast<T*>(y), D, eps);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x, y: [R, D] contiguous, dtype `dtype`; scale, bias: [D] float32.
extern "C" int ptt_fused_ln(const void* x, const void* scale,
                            const void* bias, void* y, int R, int D,
                            float eps, int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case ptt::kF32:
      return launch<float>(x, scale, bias, y, R, D, eps, st);
    case ptt::kBF16:
      return launch<__nv_bfloat16>(x, scale, bias, y, R, D, eps, st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
