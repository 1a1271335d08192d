// One-call paged decode step: the new KV row written into the lane's
// page, then masked one-query attention walking the page table, per
// (lane, head).
//
// Replaces: _decode_paged_kernel, paddle_tpu/ops/pallas_kernels.py:1431
// (through fused_paged_decode_attention, :1478). Lane b writes its new K/V
// row (cast to the pool dtype) IN PLACE at page tables[b, pos / page], row
// pos % page — a dead lane's all-zero table row lands it on scratch page
// 0, which no valid row ever reads — and attends over logical rows
// 0..pos, row j at pool[tables[b, j / page], j % page]. Attention sees
// exactly the value that lands (rounded through the pool dtype): each
// block substitutes it for every row at the write address, as the
// reference substitutes it (:1455-1461), so a dead lane, whose rows all
// alias page 0, reads its own new row wherever it aliases. Several dead
// lanes may write page 0 at once; that is benign because page 0 is never
// read for a valid row. Shared prefix pages are never written: a slot's
// write page is its own (the prefix cache publishes full pages only).
//
// What bounds it on the card: HBM bytes, (sum_b (pos_b + 1)) * nh * hd * 2
// elements of K and V, plus the rows written, q and out, and the table.
// The TPU kernel streamed all M pages of the table through VMEM and
// masked; here only the chunks that hold rows 0..pos do any work.
//
// Design: the flash-decoding body and its merge are shared with
// decode_slab.cu (decode_attention.cuh); only the row policy below
// differs. Chunks are whole pages (the wrapper picks chunk % page == 0),
// so a block resolves one table entry per page of its chunk and stages
// the chunk's physical rows in shared memory: no division per row. Every
// block of a lane checks the lane's whole prefix tables[b, 0..pos / page]
// (pos / page + 1 ints, 64 at most at max_seq 1024, page 16), so every
// split refuses a lane with a bad entry, wherever the entry lies.
#include "decode_attention.cuh"

namespace {

struct PagedRows {
  const int* tables;  // [B, M] int32
  int M, page, P;
  size_t rs;          // elements per pool row (nh * hd)
  const int* phys;    // set by bind: the chunk's staged physical rows
  size_t wrow;        // set by bind: row pos (its page, pos % page)

  __host__ __device__ int rows() const { return M * page; }
  static size_t smem_bytes(int chunk) {
    return static_cast<size_t>(chunk) * sizeof(int);
  }
  __device__ bool bind(int b, int pos, int c0, int chunk, int* sh) {
    const int* tb = tables + static_cast<size_t>(b) * M;
    const int last = pos / page;
    bool bad = false;
    for (int i = threadIdx.x; i <= last; i += blockDim.x) {
      const int p = tb[i];
      bad |= p < 0 || p >= P;
    }
    if (__syncthreads_or(bad)) return false;
    // the chunk's pages up to pos, each a run of `page` physical rows
    const int first = c0 / page;
    const int npg = min(chunk / page, last - first + 1);
    for (int k = 0; k < npg; ++k) {
      const int row0 = tb[first + k] * page;
      for (int w = threadIdx.x; w < page; w += blockDim.x)
        sh[k * page + w] = row0 + w;
    }
    __syncthreads();
    phys = sh;
    wrow = static_cast<size_t>(tb[last] * page + pos - last * page) * rs;
    return true;
  }
  __device__ bool writes(int /*b*/) const { return true; }
  __device__ size_t row(int r) const {
    return static_cast<size_t>(phys[r]) * rs;
  }
};

}  // namespace

// q, new_k, new_v: [B, nh, hd], row b at b * row_stride, heads and head
// dim contiguous, dtype q_dtype; k_pool, v_pool: [P, page, nh, hd]
// contiguous and 16-byte aligned, dtype c_dtype, updated in place, P *
// page < 2^31; tables: [B, M] int32 contiguous; positions: [B] int32;
// out: [B, nh, hd] contiguous, dtype q_dtype; workspace: [B, nh, nsplit,
// hd + 2] float32 with chunk a multiple of page, chunk * nsplit >= M *
// page and chunk * 4 bytes of staging within 32 KB. hd is any of 1..128
// (an instance) or past 128 (the split route). Enqueues the split pass
// and the merge.
extern "C" int ptt_decode_paged(const void* q, const void* new_k,
                                const void* new_v, long long row_stride,
                                void* k_pool, void* v_pool,
                                const void* tables, const void* positions,
                                void* out, void* workspace, int B, int M,
                                int page, int P, int nh, int hd, int chunk,
                                int nsplit, float sm_scale, int q_dtype,
                                int c_dtype, void* stream) {
  if (page < 1 || chunk % page != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const PagedRows rows{static_cast<const int*>(tables), M, page, P,
                       static_cast<size_t>(nh) * hd, nullptr, 0};
  const ptt::decode::Args a{q, new_k, new_v, row_stride, k_pool, v_pool,
                            static_cast<const int*>(positions),
                            static_cast<float*>(workspace), out, B, nh, hd,
                            chunk, nsplit, sm_scale};
  return ptt::decode::launch(a, rows, q_dtype, c_dtype, stream);
}
