// The one-query decode step shared by the slab and the paged KV layouts:
// the new K/V row written IN PLACE (cast to the cache dtype), then masked
// one-query attention over rows 0..pos, per (lane, head).
//
// The two layouts differ only in where row j of lane b lives, so the body
// is one kernel template over a row-address policy `Rows`:
//
//   int rows() const            rows a lane can address (pos must be below)
//   bool bind(b, pos, int* sh)  block-wide, every thread calls it once the
//                               position is known valid: resolves the lane's
//                               addressing (the paged policy stages the
//                               lane's page-table entries in shared memory
//                               and checks each); false = refuse the lane
//   bool writes(b) const        whether lane b writes its new row
//   size_t row(j) const         element offset of row j, head 0
//
// A refused lane (pos outside [0, rows()) or a bad table entry) answers
// zeros and writes nothing; no address outside the caches is formed.
//
// The written row is read back after a barrier, so attention at row pos
// sees exactly the value that landed in the cache (rounded through the
// cache dtype). Scores and softmax run in float32 with the guards of
// ops/decode_attention.py (the max made finite, the sum floored at
// 1e-30); the output is in q's dtype.
//
// Design: grid (B, nh), 128 threads. q is staged in shared memory as
// float32; one warp scores one cached row at a time (lanes split hd,
// warp-shuffle sum), the scores stay in shared memory (rows() floats), two
// block reductions give the max and the sum, and the weighted sum over V
// splits the rows over 128/hd thread groups whose partial sums are added
// in shared memory. HBM bytes bound it: per (b, h) it reads pos+1 rows of
// K and of V and does 4*hd operations per row.
#pragma once

#include "common.cuh"

namespace ptt {
namespace decode {

constexpr int kThreads = 128;

// dynamic shared memory: q (hd) + scores (n_rows) + partial sums
// (kThreads) floats, then `table_ints` ints for the row policy
inline size_t smem_bytes(int hd, int n_rows, int table_ints) {
  return static_cast<size_t>(hd + n_rows + kThreads) * sizeof(float) +
         static_cast<size_t>(table_ints) * sizeof(int);
}

template <typename TQ, typename TC, typename Rows>
__global__ void __launch_bounds__(kThreads)
    decode_kernel(const TQ* __restrict__ q, const TQ* __restrict__ new_k,
                  const TQ* __restrict__ new_v, long long row_stride,
                  TC* k_cache, TC* v_cache, const int* __restrict__ positions,
                  const Rows rows_in, TQ* __restrict__ out, int nh, int hd,
                  float sm_scale) {
  extern __shared__ float smem[];
  Rows rows = rows_in;
  float* qs = smem;
  float* sc = qs + hd;
  float* part = sc + rows.rows();
  int* tbl = reinterpret_cast<int*>(part + kThreads);
  __shared__ float scratch[32];

  const int b = blockIdx.x, h = blockIdx.y;
  const int pos = positions[b];
  const size_t head = static_cast<size_t>(h) * hd;
  TQ* ob = out + (static_cast<size_t>(b) * nh) * hd + head;
  // pos is uniform over the block, so every thread reaches bind()
  const bool ok = pos >= 0 && pos < rows.rows() && rows.bind(b, pos, tbl);
  if (!ok) {
    for (int d = threadIdx.x; d < hd; d += blockDim.x)
      ob[d] = ptt::from_f32<TQ>(0.f);
    return;
  }
  const size_t in_off = static_cast<size_t>(b) * row_stride + head;
  TC* kh = k_cache + head;
  TC* vh = v_cache + head;

  // 1. write the new row + stage q
  const bool wr = rows.writes(b);
  const size_t wrow = rows.row(pos);
  for (int d = threadIdx.x; d < hd; d += blockDim.x) {
    if (wr) {
      kh[wrow + d] = ptt::from_f32<TC>(ptt::to_f32(new_k[in_off + d]));
      vh[wrow + d] = ptt::from_f32<TC>(ptt::to_f32(new_v[in_off + d]));
    }
    qs[d] = ptt::to_f32(q[in_off + d]);
  }
  __syncthreads();  // the written row and q are visible to the block

  // 2. scores of rows 0..pos, one warp per row
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  const int n = pos + 1;
  for (int j = warp; j < n; j += nwarps) {
    const TC* kr = kh + rows.row(j);
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
    acc += sc[j] * ptt::to_f32(vh[rows.row(j) + d]);
  part[threadIdx.x] = acc;
  __syncthreads();
  if (g == 0) {
    float o = 0.f;
    for (int k = 0; k < groups; ++k) o += part[k * hd + d];
    ob[d] = ptt::from_f32<TQ>(o);
  }
}

template <typename TQ, typename TC, typename Rows>
int launch_typed(const void* q, const void* new_k, const void* new_v,
                 long long row_stride, void* k_cache, void* v_cache,
                 const int* positions, const Rows& rows, void* out, int B,
                 int nh, int hd, float sm_scale, size_t smem,
                 cudaStream_t stream) {
  decode_kernel<TQ, TC, Rows><<<dim3(B, nh), kThreads, smem, stream>>>(
      static_cast<const TQ*>(q), static_cast<const TQ*>(new_k),
      static_cast<const TQ*>(new_v), row_stride, static_cast<TC*>(k_cache),
      static_cast<TC*>(v_cache), positions, rows, static_cast<TQ*>(out), nh,
      hd, sm_scale);
  return static_cast<int>(cudaGetLastError());
}

// Launch over the four q-dtype / cache-dtype pairs; returns the CUDA error.
template <typename Rows>
int launch(const void* q, const void* new_k, const void* new_v,
           long long row_stride, void* k_cache, void* v_cache,
           const void* positions, const Rows& rows, void* out, int B, int nh,
           int hd, float sm_scale, int q_dtype, int c_dtype, size_t smem,
           void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* pos = static_cast<const int*>(positions);
  if (q_dtype == kF32 && c_dtype == kF32)
    return launch_typed<float, float>(q, new_k, new_v, row_stride, k_cache,
                                      v_cache, pos, rows, out, B, nh, hd,
                                      sm_scale, smem, st);
  if (q_dtype == kBF16 && c_dtype == kBF16)
    return launch_typed<__nv_bfloat16, __nv_bfloat16>(
        q, new_k, new_v, row_stride, k_cache, v_cache, pos, rows, out, B, nh,
        hd, sm_scale, smem, st);
  if (q_dtype == kF32 && c_dtype == kBF16)
    return launch_typed<float, __nv_bfloat16>(q, new_k, new_v, row_stride,
                                              k_cache, v_cache, pos, rows,
                                              out, B, nh, hd, sm_scale, smem,
                                              st);
  if (q_dtype == kBF16 && c_dtype == kF32)
    return launch_typed<__nv_bfloat16, float>(q, new_k, new_v, row_stride,
                                              k_cache, v_cache, pos, rows,
                                              out, B, nh, hd, sm_scale, smem,
                                              st);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace decode
}  // namespace ptt
