// One-launch slab decode step: write-guarded KV row update + masked
// one-query attention, per (slot, head).
//
// Replaces: _decode_slab_kernel, paddle_tpu/ops/pallas_kernels.py:1338
// (through fused_decode_attention, :1377). For every lane b with
// active[b] != 0 the new K/V row (cast to the cache dtype) is written IN
// PLACE at row positions[b]; an inactive lane leaves its row bit for bit.
// Attention then covers rows 0..positions[b] and reads exactly the value
// that landed in the cache (the rounded new row for an active lane, the
// old row for an inactive one). Scores and softmax run in float32 with
// the guards of ops/decode_attention.py; the output is in q's dtype.
//
// What bounds it on the card: HBM bytes. Per (b, h) it reads pos+1 rows
// of K and of V (hd elements each) and does 4*hd operations per row — far
// below the card's ridge point. The TPU kernel streamed the whole
// [S, hd] slab through VMEM and masked; here each block walks only the
// pos+1 rows it needs, so the work and the bound both scale with the
// sequence's length, not with max_seq.
//
// Design: grid (B, nh), 128 threads. q is staged in shared memory as
// float32; one warp scores one cached row at a time (lanes split hd,
// warp-shuffle sum), the scores stay in shared memory (S floats), two
// block reductions give the max and the sum, and the weighted sum over V
// splits the rows over 128/hd thread groups whose partial sums are added
// in shared memory. Known limit: at B=8, nh=12 the grid is 96 blocks on
// 132 SMs, so 36 SMs idle; splitting rows across blocks (flash-decoding)
// is later work.
#include "common.cuh"

namespace {

constexpr int kThreads = 128;

template <typename TQ, typename TC>
__global__ void __launch_bounds__(kThreads)
    decode_slab_kernel(const TQ* __restrict__ q, const TQ* __restrict__ new_k,
                       const TQ* __restrict__ new_v, long long row_stride,
                       TC* k_cache, TC* v_cache,
                       const int* __restrict__ positions,
                       const int* __restrict__ active, TQ* __restrict__ out,
                       int S, int nh, int hd, float sm_scale) {
  extern __shared__ float smem[];  // hd (q) + S (scores) + kThreads
  float* qs = smem;
  float* sc = qs + hd;
  float* part = sc + S;
  __shared__ float scratch[32];

  const int b = blockIdx.x, h = blockIdx.y;
  const int pos = positions[b];
  const size_t head = static_cast<size_t>(h) * hd;
  TQ* ob = out + (static_cast<size_t>(b) * nh) * hd + head;
  if (pos < 0 || pos >= S) {
    // out-of-range write row: touch no cache row, answer zeros
    for (int d = threadIdx.x; d < hd; d += blockDim.x)
      ob[d] = ptt::from_f32<TQ>(0.f);
    return;
  }
  const size_t in_off = static_cast<size_t>(b) * row_stride + head;
  const size_t rs = static_cast<size_t>(nh) * hd;  // cache row stride
  TC* kb = k_cache + static_cast<size_t>(b) * S * rs + head;
  TC* vb = v_cache + static_cast<size_t>(b) * S * rs + head;

  // 1. write guard + stage q
  const bool act = active[b] != 0;
  for (int d = threadIdx.x; d < hd; d += blockDim.x) {
    if (act) {
      kb[static_cast<size_t>(pos) * rs + d] =
          ptt::from_f32<TC>(ptt::to_f32(new_k[in_off + d]));
      vb[static_cast<size_t>(pos) * rs + d] =
          ptt::from_f32<TC>(ptt::to_f32(new_v[in_off + d]));
    }
    qs[d] = ptt::to_f32(q[in_off + d]);
  }
  __syncthreads();  // the written row and q are visible to the block

  // 2. scores of rows 0..pos, one warp per row
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  const int n = pos + 1;
  for (int j = warp; j < n; j += nwarps) {
    const TC* kr = kb + static_cast<size_t>(j) * rs;
    float acc = 0.f;
    for (int d = lane; d < hd; d += 32) acc += qs[d] * ptt::to_f32(kr[d]);
    acc = ptt::warp_sum(acc);
    if (lane == 0) sc[j] = acc * sm_scale;
  }
  __syncthreads();

  // 3. softmax over the valid rows (the max guard mirrors the reference;
  //    n >= 1 keeps it finite here)
  float m = -CUDART_INF_F;
  for (int j = threadIdx.x; j < n; j += blockDim.x) m = fmaxf(m, sc[j]);
  m = ptt::block_max(m, scratch);
  if (!isfinite(m)) m = 0.f;
  float s = 0.f;
  for (int j = threadIdx.x; j < n; j += blockDim.x) {
    const float e = expf(sc[j] - m);
    sc[j] = e;
    s += e;
  }
  const float denom = fmaxf(ptt::block_sum(s, scratch), 1e-30f);
  for (int j = threadIdx.x; j < n; j += blockDim.x) sc[j] = sc[j] / denom;
  __syncthreads();

  // 4. out[d] = sum_j p_j * v[j, d]; hd divides kThreads
  const int groups = blockDim.x / hd;
  const int g = threadIdx.x / hd, d = threadIdx.x % hd;
  float acc = 0.f;
  for (int j = g; j < n; j += groups)
    acc += sc[j] * ptt::to_f32(vb[static_cast<size_t>(j) * rs + d]);
  part[threadIdx.x] = acc;
  __syncthreads();
  if (g == 0) {
    float o = 0.f;
    for (int k = 0; k < groups; ++k) o += part[k * hd + d];
    ob[d] = ptt::from_f32<TQ>(o);
  }
}

template <typename TQ, typename TC>
int launch(const void* q, const void* new_k, const void* new_v,
           long long row_stride, void* k_cache, void* v_cache,
           const int* positions, const int* active, void* out, int B, int S,
           int nh, int hd, float sm_scale, cudaStream_t stream) {
  const size_t smem = static_cast<size_t>(hd + S + kThreads) * sizeof(float);
  decode_slab_kernel<TQ, TC><<<dim3(B, nh), kThreads, smem, stream>>>(
      static_cast<const TQ*>(q), static_cast<const TQ*>(new_k),
      static_cast<const TQ*>(new_v), row_stride, static_cast<TC*>(k_cache),
      static_cast<TC*>(v_cache), positions, active, static_cast<TQ*>(out),
      S, nh, hd, sm_scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q, new_k, new_v: [B, nh, hd], row b at b * row_stride, heads and head
// dim contiguous, dtype q_dtype; k_cache, v_cache: [B, S, nh, hd]
// contiguous, dtype c_dtype, updated in place; positions, active: [B]
// int32; out: [B, nh, hd] contiguous, dtype q_dtype. hd divides 128.
extern "C" int ptt_decode_slab(const void* q, const void* new_k,
                               const void* new_v, long long row_stride,
                               void* k_cache, void* v_cache,
                               const void* positions, const void* active,
                               void* out, int B, int S, int nh, int hd,
                               float sm_scale, int q_dtype, int c_dtype,
                               void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* pos = static_cast<const int*>(positions);
  const int* act = static_cast<const int*>(active);
  if (q_dtype == ptt::kF32 && c_dtype == ptt::kF32)
    return launch<float, float>(q, new_k, new_v, row_stride, k_cache,
                                v_cache, pos, act, out, B, S, nh, hd,
                                sm_scale, st);
  if (q_dtype == ptt::kBF16 && c_dtype == ptt::kBF16)
    return launch<__nv_bfloat16, __nv_bfloat16>(
        q, new_k, new_v, row_stride, k_cache, v_cache, pos, act, out, B, S,
        nh, hd, sm_scale, st);
  if (q_dtype == ptt::kF32 && c_dtype == ptt::kBF16)
    return launch<float, __nv_bfloat16>(q, new_k, new_v, row_stride,
                                        k_cache, v_cache, pos, act, out, B,
                                        S, nh, hd, sm_scale, st);
  if (q_dtype == ptt::kBF16 && c_dtype == ptt::kF32)
    return launch<__nv_bfloat16, float>(q, new_k, new_v, row_stride,
                                        k_cache, v_cache, pos, act, out, B,
                                        S, nh, hd, sm_scale, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
