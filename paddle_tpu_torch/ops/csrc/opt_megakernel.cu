// The optimizer megakernel's four kinds, each a flat sweep over the
// optimizer megabuffers, in place.
//
// Replaces: _opt_kernel (paddle_tpu/ops/pallas_kernels.py:1174, called at
// :1253 by _opt_megakernel), one entry a kind:
//   ptt_adamw_flat   kind "adamw_mask" (:1209-1219, via
//                    megakernel_adamw_flat :1299) — the elementwise part of
//                    parallel/parallelize.py _adamw_update_fused:
//                      g' = g * scale
//                      m' = b1 * m + (1 - b1) * g'
//                      v' = b2 * v + ((1 - b2) * g') * g'
//                      u  = (m' / c1) / (sqrt(v' / c2) + eps)
//                      p' = p - lr * (u + (wd * mask) * p)
//                    m and v stored back in their own dtype (float32 or
//                    bfloat16, round to nearest even);
//   ptt_opt_sgd      kind "sgd" (:1178-1182, via megakernel_sgd :1268),
//                    fluid fused_sgd: p' = p - bf(lr) * g, in p's dtype
//                    (float32 or bfloat16: lr, the product and the
//                    difference each rounded to it);
//   ptt_opt_momentum kind "momentum" (:1183-1193, via megakernel_momentum
//                    :1277), fluid fused_momentum, float32:
//                      v' = mu * v + g
//                      p' = p - lr * v'  (Nesterov: p - (g + mu * v') * lr)
//   ptt_opt_adam     kind "adam" (:1194-1208, via megakernel_adam :1286),
//                    fluid fused_adam / fused_adamw, float32:
//                      m' = b1 * m + (1 - b1) * g
//                      v' = b2 * v + ((1 - b2) * g) * g
//                      lr_t = (lr * sqrt(1 - b2p * b2)) / (1 - b1p * b1)
//                      p' = p - (lr_t * m') / (sqrt(v') + eps)
//                           [ - (lr * coeff) * p   when coeff != 0: AdamW ]
// The reductions (grad norm, clip scale) stay outside; the scalars that
// change a step (lr, scale, c1, c2; lr, b1p, b2p) arrive in device memory,
// so a step needs no host sync.
//
// The reference claims bitwise parity at float32, so every operation is a
// round-to-nearest intrinsic (__fmul_rn, __fadd_rn, __fsub_rn, __fdiv_rn,
// __fsqrt_rn): nvcc may not contract any of them into a fused
// multiply-add, which is what eager PyTorch, one rounding an operation,
// computes too. The Python constants (b1, 1 - b1, b2, 1 - b2, mu, eps,
// wd, coeff) are rounded to float32 once by the caller, as JAX's weak
// types and PyTorch's Python scalars round them.
//
// What bounds them on the card: HBM. Per element, sgd moves 12 bytes at
// float32 (p read and written, g read), momentum 20 (v too), adam 28 (m
// and v read and written), adamw_mask 24 with bf16 moments, against at
// most ~20 operations. Design: a grid-stride loop over a grid of one or
// two waves; each kind loads and stores 16 bytes a thread an operand
// when every buffer is 16-byte aligned (sgd, momentum, adam: 4 float32 or
// 8 bf16 elements; adamw_mask 8 elements an iteration: p, g and the mask
// as two float4 each, bf16 m and v as one 16-byte vector each, float32
// ones as two), then sweeps the tail one element a thread, so any n and
// any alignment works. The adamw_mask sweep before this one took one
// element a thread an iteration (4- and 2-byte accesses), at 1.35x its
// bound on an H100; its siblings' vector sweeps ran at 1.22-1.25x.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMaxBlocks = 132 * 8;   // grid-stride beyond this

template <typename T>
constexpr int kVec = 16 / static_cast<int>(sizeof(T));

inline int grid_for(long long items) {
  long long blocks = (items + kThreads - 1) / kThreads;
  if (blocks < 1) blocks = 1;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  return static_cast<int>(blocks);
}

struct AdamWMaskConsts {
  float lr, scale, c1, c2, b1, omb1, b2, omb2, eps, wd;
};

// One element of the adamw_mask sweep, in the reference's order.
__device__ __forceinline__ void adamw_mask_elem(float& p, float g, float& m,
                                                float& v, float mask,
                                                const AdamWMaskConsts& c) {
  const float gf = __fmul_rn(g, c.scale);
  const float mf = __fadd_rn(__fmul_rn(c.b1, m), __fmul_rn(c.omb1, gf));
  const float vf =
      __fadd_rn(__fmul_rn(c.b2, v), __fmul_rn(__fmul_rn(c.omb2, gf), gf));
  const float u = __fdiv_rn(__fdiv_rn(mf, c.c1),
                            __fadd_rn(__fsqrt_rn(__fdiv_rn(vf, c.c2)), c.eps));
  p = __fsub_rn(
      p, __fmul_rn(c.lr, __fadd_rn(u, __fmul_rn(__fmul_rn(c.wd, mask), p))));
  m = mf;
  v = vf;
}

// 8 elements at element 8i of a float32 or bf16 buffer as floats, and
// back (rounded to the buffer's type).
__device__ __forceinline__ void load8(float (&d)[8], const float* src,
                                      long long i) {
  const float4 a = reinterpret_cast<const float4*>(src)[2 * i];
  const float4 b = reinterpret_cast<const float4*>(src)[2 * i + 1];
  d[0] = a.x; d[1] = a.y; d[2] = a.z; d[3] = a.w;
  d[4] = b.x; d[5] = b.y; d[6] = b.z; d[7] = b.w;
}
__device__ __forceinline__ void load8(float (&d)[8], const __nv_bfloat16* src,
                                      long long i) {
  const uint4 u = reinterpret_cast<const uint4*>(src)[i];
  const unsigned w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    d[2 * k] = __uint_as_float(w[k] << 16);
    d[2 * k + 1] = __uint_as_float(w[k] & 0xffff0000u);
  }
}
__device__ __forceinline__ void store8(float* dst, long long i,
                                       const float (&d)[8]) {
  reinterpret_cast<float4*>(dst)[2 * i] = make_float4(d[0], d[1], d[2], d[3]);
  reinterpret_cast<float4*>(dst)[2 * i + 1] =
      make_float4(d[4], d[5], d[6], d[7]);
}
__device__ __forceinline__ void store8(__nv_bfloat16* dst, long long i,
                                       const float (&d)[8]) {
  uint4 u;
  unsigned* w = reinterpret_cast<unsigned*>(&u);
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(d[2 * k], d[2 * k + 1]);
    w[k] = *reinterpret_cast<const unsigned*>(&h);
  }
  reinterpret_cast<uint4*>(dst)[i] = u;
}

template <typename M>
__global__ void __launch_bounds__(kThreads)
    adamw_flat_kernel(float* __restrict__ p, const float* __restrict__ g,
                      M* __restrict__ m, M* __restrict__ v,
                      const float* __restrict__ wd_mask,
                      const float* __restrict__ scal, long long n, float b1,
                      float omb1, float b2, float omb2, float eps, float wd,
                      int vec) {
  const AdamWMaskConsts c{scal[0], scal[1], scal[2], scal[3], b1,
                          omb1,    b2,      omb2,    eps,     wd};
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  const long long i0 =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  long long tail = 0;
  if (vec) {
    const long long nv = n / 8;
    for (long long i = i0; i < nv; i += stride) {
      float pv[8], gv[8], mv[8], vv[8], kv[8];
      load8(pv, p, i);
      load8(gv, g, i);
      load8(kv, wd_mask, i);
      load8(mv, m, i);
      load8(vv, v, i);
#pragma unroll
      for (int k = 0; k < 8; ++k)
        adamw_mask_elem(pv[k], gv[k], mv[k], vv[k], kv[k], c);
      store8(p, i, pv);
      store8(m, i, mv);
      store8(v, i, vv);
    }
    tail = nv * 8;
  }
  for (long long i = tail + i0; i < n; i += stride) {
    float pi = p[i], mi = ptt::to_f32(m[i]), vi = ptt::to_f32(v[i]);
    adamw_mask_elem(pi, g[i], mi, vi, wd_mask[i], c);
    p[i] = pi;
    m[i] = ptt::from_f32<M>(mi);
    v[i] = ptt::from_f32<M>(vi);
  }
}

template <typename M>
int launch(void* p, const void* g, void* m, void* v, const void* wd_mask,
           const void* scal, long long n, float b1, float omb1, float b2,
           float omb2, float eps, float wd, int vec, cudaStream_t stream) {
  adamw_flat_kernel<M><<<grid_for(vec ? n / 8 : n), kThreads, 0, stream>>>(
      static_cast<float*>(p), static_cast<const float*>(g),
      static_cast<M*>(m), static_cast<M*>(v),
      static_cast<const float*>(wd_mask), static_cast<const float*>(scal), n,
      b1, omb1, b2, omb2, eps, wd, vec);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// p, g, wd_mask: [n] float32; m, v: [n] in `moment_dtype`; scal: float32
// [4] = (lr, scale, c1, c2) in device memory; vec: every pointer 16-byte
// aligned. p, m, v are updated in place.
extern "C" int ptt_adamw_flat(void* p, const void* g, void* m, void* v,
                              const void* wd_mask, const void* scal,
                              long long n, float b1, float omb1, float b2,
                              float omb2, float eps, float wd,
                              int moment_dtype, int vec, void* stream) {
  if (n <= 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (moment_dtype) {
    case ptt::kF32:
      return launch<float>(p, g, m, v, wd_mask, scal, n, b1, omb1, b2, omb2,
                           eps, wd, vec, st);
    case ptt::kBF16:
      return launch<__nv_bfloat16>(p, g, m, v, wd_mask, scal, n, b1, omb1,
                                   b2, omb2, eps, wd, vec, st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// ---------------------------------------------------------------------------
// sgd, momentum and adam: 16-byte vector sweeps with a scalar tail
// ---------------------------------------------------------------------------

namespace {

template <typename T>
__device__ __forceinline__ void load16(T (&dst)[kVec<T>], const T* src,
                                       long long i) {
  *reinterpret_cast<uint4*>(dst) = reinterpret_cast<const uint4*>(src)[i];
}

template <typename T>
__device__ __forceinline__ void store16(T* dst, long long i,
                                        const T (&src)[kVec<T>]) {
  reinterpret_cast<uint4*>(dst)[i] = *reinterpret_cast<const uint4*>(src);
}

template <typename P>
__device__ __forceinline__ P sgd_elem(P p, P g, P lr) {
  const P prod = ptt::from_f32<P>(__fmul_rn(ptt::to_f32(lr), ptt::to_f32(g)));
  return ptt::from_f32<P>(__fsub_rn(ptt::to_f32(p), ptt::to_f32(prod)));
}

template <typename P>
__global__ void __launch_bounds__(kThreads)
    sgd_kernel(P* __restrict__ p, const P* __restrict__ g,
               const float* __restrict__ scal, long long n, int vec) {
  constexpr int V = kVec<P>;
  const P lr = ptt::from_f32<P>(scal[0]);
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  const long long i0 =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  long long tail = 0;
  if (vec) {
    const long long nv = n / V;
    for (long long i = i0; i < nv; i += stride) {
      alignas(16) P pv[V];
      alignas(16) P gv[V];
      load16<P>(pv, p, i);
      load16<P>(gv, g, i);
#pragma unroll
      for (int k = 0; k < V; ++k) pv[k] = sgd_elem(pv[k], gv[k], lr);
      store16<P>(p, i, pv);
    }
    tail = nv * V;
  }
  for (long long i = tail + i0; i < n; i += stride)
    p[i] = sgd_elem(p[i], g[i], lr);
}

template <bool kNesterov>
__device__ __forceinline__ void momentum_elem(float& p, float g, float& v,
                                              float lr, float mu) {
  const float vn = __fadd_rn(__fmul_rn(mu, v), g);
  if (kNesterov) {
    p = __fsub_rn(p, __fmul_rn(__fadd_rn(g, __fmul_rn(mu, vn)), lr));
  } else {
    p = __fsub_rn(p, __fmul_rn(lr, vn));
  }
  v = vn;
}

template <bool kNesterov>
__global__ void __launch_bounds__(kThreads)
    momentum_kernel(float* __restrict__ p, const float* __restrict__ g,
                    float* __restrict__ v, const float* __restrict__ scal,
                    long long n, float mu, int vec) {
  constexpr int V = kVec<float>;
  const float lr = scal[0];
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  const long long i0 =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  long long tail = 0;
  if (vec) {
    const long long nv = n / V;
    for (long long i = i0; i < nv; i += stride) {
      alignas(16) float pv[V];
      alignas(16) float gv[V];
      alignas(16) float vv[V];
      load16<float>(pv, p, i);
      load16<float>(gv, g, i);
      load16<float>(vv, v, i);
#pragma unroll
      for (int k = 0; k < V; ++k)
        momentum_elem<kNesterov>(pv[k], gv[k], vv[k], lr, mu);
      store16<float>(p, i, pv);
      store16<float>(v, i, vv);
    }
    tail = nv * V;
  }
  for (long long i = tail + i0; i < n; i += stride) {
    float pi = p[i], vi = v[i];
    momentum_elem<kNesterov>(pi, g[i], vi, lr, mu);
    p[i] = pi;
    v[i] = vi;
  }
}

struct AdamConsts {
  float b1, omb1, b2, omb2, eps;
  float lr_t;  // (lr * sqrt(1 - b2p * b2)) / (1 - b1p * b1)
  float lrc;   // lr * coeff
};

template <bool kDecay>
__device__ __forceinline__ void adam_elem(float& p, float g, float& m,
                                          float& v, const AdamConsts& c) {
  const float mn = __fadd_rn(__fmul_rn(c.b1, m), __fmul_rn(c.omb1, g));
  const float vn =
      __fadd_rn(__fmul_rn(c.b2, v), __fmul_rn(__fmul_rn(c.omb2, g), g));
  float pn = __fsub_rn(
      p, __fdiv_rn(__fmul_rn(c.lr_t, mn), __fadd_rn(__fsqrt_rn(vn), c.eps)));
  if (kDecay) pn = __fsub_rn(pn, __fmul_rn(c.lrc, p));
  p = pn;
  m = mn;
  v = vn;
}

template <bool kDecay>
__global__ void __launch_bounds__(kThreads)
    adam_kernel(float* __restrict__ p, const float* __restrict__ g,
                float* __restrict__ m, float* __restrict__ v,
                const float* __restrict__ scal, long long n, float b1,
                float omb1, float b2, float omb2, float eps, float coeff,
                int vec) {
  constexpr int V = kVec<float>;
  const float lr = scal[0], b1p = scal[1], b2p = scal[2];
  AdamConsts c;
  c.b1 = b1;
  c.omb1 = omb1;
  c.b2 = b2;
  c.omb2 = omb2;
  c.eps = eps;
  c.lr_t = __fdiv_rn(
      __fmul_rn(lr, __fsqrt_rn(__fsub_rn(1.f, __fmul_rn(b2p, b2)))),
      __fsub_rn(1.f, __fmul_rn(b1p, b1)));
  c.lrc = __fmul_rn(lr, coeff);
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  const long long i0 =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  long long tail = 0;
  if (vec) {
    const long long nv = n / V;
    for (long long i = i0; i < nv; i += stride) {
      alignas(16) float pv[V];
      alignas(16) float gv[V];
      alignas(16) float mv[V];
      alignas(16) float vv[V];
      load16<float>(pv, p, i);
      load16<float>(gv, g, i);
      load16<float>(mv, m, i);
      load16<float>(vv, v, i);
#pragma unroll
      for (int k = 0; k < V; ++k)
        adam_elem<kDecay>(pv[k], gv[k], mv[k], vv[k], c);
      store16<float>(p, i, pv);
      store16<float>(m, i, mv);
      store16<float>(v, i, vv);
    }
    tail = nv * V;
  }
  for (long long i = tail + i0; i < n; i += stride) {
    float pi = p[i], mi = m[i], vi = v[i];
    adam_elem<kDecay>(pi, g[i], mi, vi, c);
    p[i] = pi;
    m[i] = mi;
    v[i] = vi;
  }
}

// threads' worth of work: vector items when vectorized (the tail of at
// most V - 1 elements rides the same grid)
inline long long items(long long n, int vec, int V) { return vec ? n / V : n; }

}  // namespace

// p, g: [n] in `dtype` (float32 or bfloat16); scal: float32 [1] = (lr) in
// device memory; vec: every pointer 16-byte aligned. p is updated in place.
extern "C" int ptt_opt_sgd(void* p, const void* g, const void* scal,
                           long long n, int dtype, int vec, void* stream) {
  if (n <= 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case ptt::kF32:
      sgd_kernel<float><<<grid_for(items(n, vec, kVec<float>)), kThreads, 0,
                          st>>>(static_cast<float*>(p),
                                static_cast<const float*>(g),
                                static_cast<const float*>(scal), n, vec);
      break;
    case ptt::kBF16:
      sgd_kernel<__nv_bfloat16>
          <<<grid_for(items(n, vec, kVec<__nv_bfloat16>)), kThreads, 0,
             st>>>(static_cast<__nv_bfloat16*>(p),
                   static_cast<const __nv_bfloat16*>(g),
                   static_cast<const float*>(scal), n, vec);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// p, g, v: [n] float32; scal: float32 [1] = (lr) in device memory. p and v
// are updated in place.
extern "C" int ptt_opt_momentum(void* p, const void* g, void* v,
                                const void* scal, long long n, float mu,
                                int nesterov, int vec, void* stream) {
  if (n <= 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int grid = grid_for(items(n, vec, kVec<float>));
  float* pp = static_cast<float*>(p);
  const float* gp = static_cast<const float*>(g);
  float* vp = static_cast<float*>(v);
  const float* sp = static_cast<const float*>(scal);
  if (nesterov) {
    momentum_kernel<true><<<grid, kThreads, 0, st>>>(pp, gp, vp, sp, n, mu,
                                                     vec);
  } else {
    momentum_kernel<false><<<grid, kThreads, 0, st>>>(pp, gp, vp, sp, n, mu,
                                                      vec);
  }
  return static_cast<int>(cudaGetLastError());
}

// p, g, m, v: [n] float32; scal: float32 [3] = (lr, b1p, b2p) in device
// memory; coeff != 0 adds the decoupled decay (AdamW). p, m and v are
// updated in place.
extern "C" int ptt_opt_adam(void* p, const void* g, void* m, void* v,
                            const void* scal, long long n, float b1,
                            float omb1, float b2, float omb2, float eps,
                            float coeff, int vec, void* stream) {
  if (n <= 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int grid = grid_for(items(n, vec, kVec<float>));
  float* pp = static_cast<float*>(p);
  const float* gp = static_cast<const float*>(g);
  float* mp = static_cast<float*>(m);
  float* vp = static_cast<float*>(v);
  const float* sp = static_cast<const float*>(scal);
  if (coeff != 0.f) {
    adam_kernel<true><<<grid, kThreads, 0, st>>>(pp, gp, mp, vp, sp, n, b1,
                                                 omb1, b2, omb2, eps, coeff,
                                                 vec);
  } else {
    adam_kernel<false><<<grid, kThreads, 0, st>>>(pp, gp, mp, vp, sp, n, b1,
                                                  omb1, b2, omb2, eps, coeff,
                                                  vec);
  }
  return static_cast<int>(cudaGetLastError());
}
