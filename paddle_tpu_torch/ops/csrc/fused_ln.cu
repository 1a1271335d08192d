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
// with float32 statistics (population variance) and y in x's dtype. The
// form is a compile-time bit set (residual, bias_add, mask); any of them
// makes the kernel also write s, and every training call writes mu and
// rstd (one float32 a row; the TPU kept 128 replicated lanes). The plain
// form (serving's decode tick) computes exactly what it always did.
//
// What bounds it on the card: HBM. At the training shape ([16384, 768]
// bf16, the ln2 form) it reads x and the residual and writes y and s,
// ~100 MB, against a few operations a byte; at the decode tick (8 rows)
// the launch itself. Design: one block per row, 256 threads; the row is
// read once from HBM into shared memory as float32 (s built on the way
// in), then two block reductions give the mean and the centred second
// moment (the two-pass variance jnp.var computes), and the normalised row
// is written once. Products and sums that the reference rounds are
// round-to-nearest intrinsics (__fmul_rn, __fadd_rn), so nvcc cannot fuse
// them into a multiply-add that would round differently.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
// form bits, also the order of the optional operands
constexpr int kRes = 1, kBadd = 2, kMask = 4;

template <typename T, int kForm>
__global__ void __launch_bounds__(kThreads)
    fused_ln_fwd_kernel(const T* __restrict__ x, const T* __restrict__ res,
                        const T* __restrict__ badd,
                        const unsigned char* __restrict__ mask,
                        const float* __restrict__ scale,
                        const float* __restrict__ bias, T* __restrict__ y,
                        T* __restrict__ s_out, float* __restrict__ mu_out,
                        float* __restrict__ rstd_out, int D, float eps,
                        float inv_keep) {
  extern __shared__ float row[];  // D floats
  __shared__ float scratch[32];
  const size_t off = static_cast<size_t>(blockIdx.x) * D;
  float s = 0.f;
  for (int i = threadIdx.x; i < D; i += blockDim.x) {
    T e = x[off + i];
    if (kForm & kMask) {
      e = ptt::from_f32<T>(
          __fmul_rn(ptt::to_f32(e), mask[off + i] ? 1.f : 0.f));
      e = ptt::from_f32<T>(__fmul_rn(ptt::to_f32(e), inv_keep));
    }
    if (kForm & kRes)
      e = ptt::from_f32<T>(__fadd_rn(ptt::to_f32(res[off + i]),
                                     ptt::to_f32(e)));
    if (kForm & kBadd)
      e = ptt::from_f32<T>(__fadd_rn(ptt::to_f32(e), ptt::to_f32(badd[i])));
    if (kForm) s_out[off + i] = e;
    const float v = ptt::to_f32(e);
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

template <typename T, int kForm>
int launch(const Args& a, cudaStream_t stream) {
  const size_t smem = static_cast<size_t>(a.D) * sizeof(float);
  fused_ln_fwd_kernel<T, kForm><<<a.R, kThreads, smem, stream>>>(
      static_cast<const T*>(a.x), static_cast<const T*>(a.res),
      static_cast<const T*>(a.badd),
      static_cast<const unsigned char*>(a.mask),
      static_cast<const float*>(a.scale), static_cast<const float*>(a.bias),
      static_cast<T*>(a.y), static_cast<T*>(a.s),
      static_cast<float*>(a.mu), static_cast<float*>(a.rstd), a.D, a.eps,
      a.inv_keep);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch(int form, const Args& a, cudaStream_t st) {
  switch (form) {
    case 0: return launch<T, 0>(a, st);
    case 1: return launch<T, 1>(a, st);
    case 2: return launch<T, 2>(a, st);
    case 3: return launch<T, 3>(a, st);
    case 4: return launch<T, 4>(a, st);
    case 5: return launch<T, 5>(a, st);
    case 6: return launch<T, 6>(a, st);
    case 7: return launch<T, 7>(a, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// x, y: [R, D] contiguous, dtype `dtype`; scale, bias: [D] float32.
// Optional (null when absent): res [R, D] and badd [D] in x's dtype, mask
// [R, D] bool (one byte an element), and then s [R, D] is written; mu and
// rstd [R] float32 are written when mu is not null. inv_keep is 1/keep
// already rounded to x's dtype.
extern "C" int ptt_fused_ln(const void* x, const void* res, const void* badd,
                            const void* mask, const void* scale,
                            const void* bias, void* y, void* s, void* mu,
                            void* rstd, int R, int D, float eps,
                            float inv_keep, int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int form = (res ? kRes : 0) | (badd ? kBadd : 0) |
                   (mask ? kMask : 0);
  if ((form != 0) != (s != nullptr) || (mu == nullptr) != (rstd == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const Args a{x, res, badd, mask, scale, bias, y, s, mu, rstd, R, D, eps,
               inv_keep};
  switch (dtype) {
    case ptt::kF32:
      return dispatch<float>(form, a, st);
    case ptt::kBF16:
      return dispatch<__nv_bfloat16>(form, a, st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
