// Flat AdamW sweep over the optimizer megabuffers, in place.
//
// Replaces: _opt_kernel, kind "adamw_mask" (paddle_tpu/ops/pallas_kernels.py
// :1174, the branch at :1209-1219, called at :1253 through
// megakernel_adamw_flat :1299) — the elementwise part of
// parallel/parallelize.py _adamw_update_fused:
//   g' = g * scale
//   m' = b1 * m + (1 - b1) * g'
//   v' = b2 * v + ((1 - b2) * g') * g'
//   u  = (m' / c1) / (sqrt(v' / c2) + eps)
//   p' = p - lr * (u + (wd * mask) * p)
// with m and v stored back in their own dtype (float32 or bfloat16, round
// to nearest even). The grad-norm reduction and the clip scale stay
// outside; lr, scale, c1 and c2 arrive as four float32 values in device
// memory, so the step needs no host sync.
//
// The reference claims bitwise parity at float32, so every operation is a
// round-to-nearest intrinsic (__fmul_rn, __fadd_rn, __fdiv_rn, __fsqrt_rn):
// nvcc may not contract any of them into a fused multiply-add. The Python
// constants b1, 1 - b1, b2, 1 - b2, eps and wd are rounded to float32 once
// by the caller, as JAX's weak types round them.
//
// What bounds it on the card: 24 bytes an element with bf16 moments (p
// read and written, g, mask, m and v read and written) and ~20 operations,
// far below the card's operations-per-byte line: HBM bounds it. Design: a
// grid-stride loop, one element a thread an iteration, every access
// coalesced; a simple kernel that is right.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;

template <typename M>
__global__ void __launch_bounds__(kThreads)
    adamw_flat_kernel(float* __restrict__ p, const float* __restrict__ g,
                      M* __restrict__ m, M* __restrict__ v,
                      const float* __restrict__ wd_mask,
                      const float* __restrict__ scal, long long n, float b1,
                      float omb1, float b2, float omb2, float eps,
                      float wd) {
  const float lr = scal[0], scale = scal[1], c1 = scal[2], c2 = scal[3];
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       i < n; i += stride) {
    const float gf = __fmul_rn(g[i], scale);
    const float mf =
        __fadd_rn(__fmul_rn(b1, ptt::to_f32(m[i])), __fmul_rn(omb1, gf));
    const float vf = __fadd_rn(__fmul_rn(b2, ptt::to_f32(v[i])),
                               __fmul_rn(__fmul_rn(omb2, gf), gf));
    const float u = __fdiv_rn(__fdiv_rn(mf, c1),
                              __fadd_rn(__fsqrt_rn(__fdiv_rn(vf, c2)), eps));
    const float pf = p[i];
    p[i] = __fsub_rn(
        pf, __fmul_rn(lr, __fadd_rn(u, __fmul_rn(__fmul_rn(wd, wd_mask[i]),
                                                  pf))));
    m[i] = ptt::from_f32<M>(mf);
    v[i] = ptt::from_f32<M>(vf);
  }
}

template <typename M>
int launch(void* p, const void* g, void* m, void* v, const void* wd_mask,
           const void* scal, long long n, float b1, float omb1, float b2,
           float omb2, float eps, float wd, cudaStream_t stream) {
  long long blocks = (n + kThreads - 1) / kThreads;
  if (blocks > 132LL * 64) blocks = 132LL * 64;  // grid-stride beyond this
  adamw_flat_kernel<M><<<static_cast<int>(blocks), kThreads, 0, stream>>>(
      static_cast<float*>(p), static_cast<const float*>(g),
      static_cast<M*>(m), static_cast<M*>(v),
      static_cast<const float*>(wd_mask), static_cast<const float*>(scal), n,
      b1, omb1, b2, omb2, eps, wd);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// p, g, wd_mask: [n] float32; m, v: [n] in `moment_dtype`; scal: float32
// [4] = (lr, scale, c1, c2) in device memory. p, m, v are updated in place.
extern "C" int ptt_adamw_flat(void* p, const void* g, void* m, void* v,
                              const void* wd_mask, const void* scal,
                              long long n, float b1, float omb1, float b2,
                              float omb2, float eps, float wd,
                              int moment_dtype, void* stream) {
  if (n <= 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (moment_dtype) {
    case ptt::kF32:
      return launch<float>(p, g, m, v, wd_mask, scal, n, b1, omb1, b2, omb2,
                           eps, wd, st);
    case ptt::kBF16:
      return launch<__nv_bfloat16>(p, g, m, v, wd_mask, scal, n, b1, omb1,
                                   b2, omb2, eps, wd, st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
