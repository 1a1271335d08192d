// One-launch paged decode step: the new KV row written into the lane's
// page, then masked one-query attention walking the page table, per
// (lane, head).
//
// Replaces: _decode_paged_kernel, paddle_tpu/ops/pallas_kernels.py:1431
// (through fused_paged_decode_attention, :1478). Lane b writes its new K/V
// row (cast to the pool dtype) IN PLACE at page tables[b, pos / page], row
// pos % page — a dead lane's all-zero table row lands it on scratch page
// 0, which no valid row ever reads — and attends over logical rows
// 0..pos, row j at pool[tables[b, j / page], j % page]. The current row is
// read back from the pool after a barrier, so attention sees exactly the
// value that landed (rounded through the pool dtype), as the reference
// substitutes it (:1455-1461). Several blocks may write page 0 at once
// (dead lanes); that is benign because page 0 is never read for a valid
// row. Shared prefix pages are never written: a slot's write page is its
// own (the prefix cache publishes full pages only).
//
// What bounds it on the card: HBM bytes, (sum_b (pos_b + 1)) * nh * hd * 2
// elements of K and V, plus the rows written, q and out, and the table:
// one table read per page-sized run of rows (16 rows at page 16). The TPU
// kernel streamed all M pages of the table through VMEM and masked; here
// each block stages only the pos / page + 1 table entries it needs in
// shared memory (checking each lies in [0, P)) and reads only rows
// 0..pos, so the work scales with the sequence's length.
//
// Design: the kernel body is shared with decode_slab.cu
// (decode_attention.cuh); only the row policy below differs.
#include "decode_attention.cuh"

namespace {

struct PagedRows {
  const int* tables;  // [B, M] int32
  int M, page, P;
  size_t rs;          // elements per pool row (nh * hd)
  const int* tbl;     // set by bind: the lane's staged table entries

  __device__ int rows() const { return M * page; }
  __device__ bool bind(int b, int pos, int* sh) {
    const int n = pos / page + 1;
    bool bad = false;
    for (int i = threadIdx.x; i < n; i += blockDim.x) {
      const int p = tables[static_cast<size_t>(b) * M + i];
      bad |= p < 0 || p >= P;
      sh[i] = p;
    }
    tbl = sh;
    return !__syncthreads_or(bad);  // also publishes sh to the block
  }
  __device__ bool writes(int /*b*/) const { return true; }
  __device__ size_t row(int j) const {
    return (static_cast<size_t>(tbl[j / page]) * page + j % page) * rs;
  }
};

}  // namespace

// q, new_k, new_v: [B, nh, hd], row b at b * row_stride, heads and head
// dim contiguous, dtype q_dtype; k_pool, v_pool: [P, page, nh, hd]
// contiguous, dtype c_dtype, updated in place; tables: [B, M] int32
// contiguous; positions: [B] int32; out: [B, nh, hd] contiguous, dtype
// q_dtype. hd divides 128.
extern "C" int ptt_decode_paged(const void* q, const void* new_k,
                                const void* new_v, long long row_stride,
                                void* k_pool, void* v_pool,
                                const void* tables, const void* positions,
                                void* out, int B, int M, int page, int P,
                                int nh, int hd, float sm_scale, int q_dtype,
                                int c_dtype, void* stream) {
  const PagedRows rows{static_cast<const int*>(tables), M, page, P,
                       static_cast<size_t>(nh) * hd, nullptr};
  return ptt::decode::launch(q, new_k, new_v, row_stride, k_pool, v_pool,
                             positions, rows, out, B, nh, hd, sm_scale,
                             q_dtype, c_dtype,
                             ptt::decode::smem_bytes(hd, M * page, M),
                             stream);
}
