// One-call slab decode step: write-guarded KV row update + masked
// one-query attention, per (slot, head).
//
// Replaces: _decode_slab_kernel, paddle_tpu/ops/pallas_kernels.py:1338
// (through fused_decode_attention, :1377). For every lane b with
// active[b] != 0 the new K/V row (cast to the cache dtype) is written IN
// PLACE at row positions[b]; an inactive lane leaves its row bit for bit.
// Attention then covers rows 0..positions[b] and reads exactly the value
// that landed in the cache (the rounded new row for an active lane, the
// old row for an inactive one).
//
// What bounds it on the card: HBM bytes. Per (b, h) it reads pos+1 rows
// of K and of V (hd elements each) and does 4*hd operations per row — far
// below the card's ridge point. The TPU kernel streamed the whole
// [S, hd] slab through VMEM and masked; here only the chunks that hold
// rows 0..pos do any work, so the work and the bound both scale with the
// sequence's length, not with max_seq.
//
// Design: the flash-decoding body and its merge are shared with
// decode_paged.cu (decode_attention.cuh); the slab's row policy addresses
// row j of slot b at (b * S + j) * nh * hd and needs no staging.
#include "decode_attention.cuh"

namespace {

struct SlabRows {
  const int* active;
  int S;
  size_t rs;    // elements per cache row (nh * hd)
  size_t base;  // set by bind: the chunk's first row
  size_t wrow;  // set by bind: row pos

  __host__ __device__ int rows() const { return S; }
  static size_t smem_bytes(int /*chunk*/) { return 0; }
  __device__ bool bind(int b, int pos, int c0, int /*chunk*/, int* /*sh*/) {
    base = (static_cast<size_t>(b) * S + c0) * rs;
    wrow = (static_cast<size_t>(b) * S + pos) * rs;
    return true;
  }
  __device__ bool writes(int b) const { return active[b] != 0; }
  __device__ size_t row(int r) const {
    return base + static_cast<size_t>(r) * rs;
  }
};

}  // namespace

// q, new_k, new_v: [B, nh, hd], row b at b * row_stride, heads and head
// dim contiguous, dtype q_dtype; k_cache, v_cache: [B, S, nh, hd]
// contiguous and 16-byte aligned, dtype c_dtype, updated in place;
// positions, active: [B] int32; out: [B, nh, hd] contiguous, dtype
// q_dtype; workspace: [B, nh, nsplit, hd + 2] float32 with chunk * nsplit
// >= S. hd is any of 1..128 (an instance) or past 128 (the split route).
// Enqueues the split pass and the merge.
extern "C" int ptt_decode_slab(const void* q, const void* new_k,
                               const void* new_v, long long row_stride,
                               void* k_cache, void* v_cache,
                               const void* positions, const void* active,
                               void* out, void* workspace, int B, int S,
                               int nh, int hd, int chunk, int nsplit,
                               float sm_scale, int q_dtype, int c_dtype,
                               void* stream) {
  const SlabRows rows{static_cast<const int*>(active), S,
                      static_cast<size_t>(nh) * hd, 0, 0};
  const ptt::decode::Args a{q, new_k, new_v, row_stride, k_cache, v_cache,
                            static_cast<const int*>(positions),
                            static_cast<float*>(workspace), out, B, nh, hd,
                            chunk, nsplit, sm_scale};
  return ptt::decode::launch(a, rows, q_dtype, c_dtype, stream);
}
