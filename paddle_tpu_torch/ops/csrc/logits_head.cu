// Final layernorm + LM-head projection, one launch.
//
// Replaces: _logits_head_kernel, paddle_tpu/ops/pallas_kernels.py:1544
// (through fused_logits_head, :1556). logits[b, j] = sum_d y[b, d] *
// w[d, j], where y = LN(x) is computed once per block with float32
// statistics and rounded to x's dtype before the product (as the TPU
// kernel rounds it per vocab tile), products accumulate in float32, and
// the result is rounded to x's dtype. Any batch, any vocab.
//
// What bounds it on the card: reading the weight. At GPT_SMALL, lm_head
// is 768 x 50304 bf16 = 77 MB against 2*B*D*V operations — 8 operations
// per weight byte at B = 8, far under the card's ridge, so HBM bandwidth
// sets the floor (about 23 us at 3.35 TB/s); at B = 96 the products are
// 7.4 GFLOP, which the CUDA cores would need ~0.15 ms for.
//
// Design. The vocabulary is cut into tiles of 128 columns. Grid (batch
// groups, gy): block (g, y) serves group g's BM rows against tiles y,
// y + gy, y + 2 gy, ... (the wrapper's plan sizes gy so that one wave of
// blocks covers the vocabulary); the group is the fast grid axis, so the
// blocks of all groups that read one weight tile run side by side and all
// but the first read it from L2. A block of 8 warps:
//   1. copies its group's BM rows of x (a multiple of 16; rows past B
//      zeros) into padded shared memory and starts a 4-stage ring of
//      [32 x 128] weight slabs, all through 16-byte cp.async (rows that
//      are not 16-byte aligned, and a ragged vocab, fall back to plain
//      loads into the same buffers, zero past V and past D); the ring
//      streams every (tile, slab) of the block back to back, so it never
//      drains between tiles;
//   2. while the weight flies, normalises the rows in place, one warp a
//      row, with 16-byte shared loads — once for all of its tiles;
//   3. walks the ring, one barrier a slab: bf16 products are mma.sync
//      m16n8k16 with f32 accumulators, A fragments from the normed rows by
//      ldmatrix, B fragments from the weight slab by ldmatrix.trans (the
//      weight is row-major [D, V], so its k-pairs are strided); warp w
//      owns columns 16w..16w+15 of the tile and every m-tile of the group,
//      so each B fragment feeds 2 MT products. A batch under 16 pads the
//      m-tile, which costs nothing here: the kernel waits on bytes.
//      float32 keeps the same ring on the CUDA cores: a thread owns one
//      column and half of the group's rows;
//   4. after a tile's last slab, rounds and writes its [BM, 128] tile
//      (pairs of columns at a time), masking rows past B and columns past
//      V, and starts the next tile from zero.
// Padding every shared row by 16 bytes keeps ldmatrix free of bank
// conflicts. The wrapper's plan (cuda_kernels.logits_head_plan) picks BM
// and gy; past BM rows the weight is read once per group.
//
// Rows too wide for 16 of them to sit beside the ring in 227 KB (D past
// about 6,000 at bf16) take the streamed instance (kStream): the wrapper
// normalises the rows once into a [B, D] tensor (the fused-LN kernel's
// plain form), and this kernel streams the group's [BM, 32] slab of them
// through each ring stage beside the weight slab, from which its A
// fragments come; steps 1 and 2 drop out.
#include "common.cuh"
#include "mma.cuh"

namespace {

constexpr int kBN = 128;     // vocab columns a tile
constexpr int kBK = 32;      // weight rows a ring slab
constexpr int kStages = 4;
constexpr int kThreads = 256;

template <typename T>
struct Lay {
  static constexpr int kVec = 16 / sizeof(T);   // elements a 16-byte copy
  static constexpr int kPad = kVec;             // 16 bytes a row
  static constexpr int kLdW = kBN + kPad;
  static constexpr int kStage = kBK * kLdW;
};

__host__ __device__ inline int padded_d(int D) {
  return (D + kBK - 1) / kBK * kBK;
}

// Weight rows [d0, d0 + 32) x columns [col0, col0 + 128) into one slab.
template <typename T>
__device__ __forceinline__ void load_slab(T* __restrict__ s,
                                          const T* __restrict__ w, int d0,
                                          int col0, int D, int V,
                                          bool vec_ok) {
  constexpr int kVec = Lay<T>::kVec;
  constexpr int kPerRow = kBN / kVec;
#pragma unroll
  for (int j = 0; j < kBK * kPerRow / kThreads; ++j) {
    const int i = threadIdx.x + j * kThreads;
    const int r = i / kPerRow, c = (i % kPerRow) * kVec;
    const int d = d0 + r, col = col0 + c;
    T* dst = s + r * Lay<T>::kLdW + c;
    const T* src = w + static_cast<size_t>(d < D ? d : 0) * V;
    if (vec_ok && (d >= D || col + kVec <= V)) {
      ptt::cp_async16(dst, src + (d < D ? col : 0), d < D ? 16 : 0);
    } else {
#pragma unroll
      for (int e = 0; e < kVec; ++e)
        dst[e] = (d < D && col + e < V) ? src[col + e] : ptt::from_f32<T>(0.f);
    }
  }
}

// Rows [row0, row0 + BM) x columns [k0, k0 + 32) of y [B, D] into one
// A slab [BM][kBK + pad], zero past B and D.
template <typename T, int BM>
__device__ __forceinline__ void load_rows_slab(T* __restrict__ s,
                                               const T* __restrict__ y,
                                               int row0, int k0, int B,
                                               int D, bool vec_ok) {
  constexpr int kVec = Lay<T>::kVec;
  constexpr int kPerRow = kBK / kVec;
  constexpr int kLdA = kBK + Lay<T>::kPad;
  for (int i = threadIdx.x; i < BM * kPerRow; i += kThreads) {
    const int r = i / kPerRow, c = (i % kPerRow) * kVec;
    const int b = row0 + r, k = k0 + c;
    T* dst = s + r * kLdA + c;
    const T* src = y + static_cast<size_t>(b < B ? b : 0) * D;
    if (vec_ok && (b >= B || k + kVec <= D)) {
      ptt::cp_async16(dst, src + (b < B ? k : 0), b < B ? 16 : 0);
    } else {
#pragma unroll
      for (int e = 0; e < kVec; ++e)
        dst[e] = (b < B && k + e < D) ? src[k + e] : ptt::from_f32<T>(0.f);
    }
  }
}

// the 16 bytes at p as floats
__device__ __forceinline__ void unpack16(const float* p, float (&v)[4]) {
  const float4 u = *reinterpret_cast<const float4*>(p);
  v[0] = u.x;
  v[1] = u.y;
  v[2] = u.z;
  v[3] = u.w;
}
__device__ __forceinline__ void unpack16(const __nv_bfloat16* p,
                                         float (&v)[8]) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(&w[i]));
    v[2 * i] = f.x;
    v[2 * i + 1] = f.y;
  }
}

template <typename T>
__device__ __forceinline__ void store_pair(T* p, float a, float b,
                                           bool pair_ok, bool second);
template <>
__device__ __forceinline__ void store_pair<float>(float* p, float a, float b,
                                                  bool pair_ok, bool second) {
  if (pair_ok) {
    *reinterpret_cast<float2*>(p) = make_float2(a, b);
  } else {
    p[0] = a;
    if (second) p[1] = b;
  }
}
template <>
__device__ __forceinline__ void store_pair<__nv_bfloat16>(
    __nv_bfloat16* p, float a, float b, bool pair_ok, bool second) {
  if (pair_ok) {
    *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
  } else {
    p[0] = __float2bfloat16(a);
    if (second) p[1] = __float2bfloat16(b);
  }
}

// MT m-tiles (16 rows each) a batch group; kStream: x is the normed rows
// y [B, D], streamed through the ring beside the weight
template <typename T, int MT, bool kStream>
__global__ void __launch_bounds__(kThreads)
    logits_head_kernel(const T* __restrict__ x,
                       const float* __restrict__ scale,
                       const float* __restrict__ bias,
                       const T* __restrict__ w, T* __restrict__ out, int B,
                       int D, int V, float eps, int x_vec, int vec_ok) {
  using L = Lay<T>;
  constexpr int BM = MT * 16;
  constexpr int kVec = L::kVec;
  constexpr bool kBF16 = sizeof(T) == 2;
  constexpr int kLdA = kBK + L::kPad;          // streamed A slab row
  constexpr int kStage = L::kStage + (kStream ? BM * kLdA : 0);
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int Dp = padded_d(D);
  const int ldy = kStream ? kLdA : Dp + L::kPad;
  T* ys = reinterpret_cast<T*>(smem_raw);     // [BM, ldy] normed rows
  T* ring = kStream ? ys : ys + BM * ldy;     // [kStages, kStage]
  const int row0 = blockIdx.x * BM;
  const int nk = Dp / kBK;
  const int ntiles = (V + kBN - 1) / kBN;
  const int gy = gridDim.y;
  const int my_tiles = (ntiles - static_cast<int>(blockIdx.y) + gy - 1) / gy;
  const int total = my_tiles * nk;             // slabs this block streams
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;

  // the stream's load cursor: slab q is slab lk of tile lt
  int lq = 0, lk = 0, lt = blockIdx.y;
  auto fetch_next = [&]() {
    if (lq < total) {
      T* st = ring + (lq % kStages) * kStage;
      load_slab<T>(st, w, lk * kBK, lt * kBN, D, V, vec_ok);
      if (kStream)
        load_rows_slab<T, BM>(st + L::kStage, x, row0, lk * kBK, B, D,
                              x_vec);
    }
    ptt::cp_async_commit();
    ++lq;
    if (++lk == nk) {
      lk = 0;
      lt += gy;
    }
  };

  // 1. the group's rows of x (with slab 0's group) and the first slabs of
  // the weight ring, all in flight together
  if (!kStream) {
    const int chunks = Dp / kVec;
    for (int i = threadIdx.x; i < BM * chunks; i += kThreads) {
      const int r = i / chunks, c = (i % chunks) * kVec;
      const int b = row0 + r;
      T* dst = ys + r * ldy + c;
      const T* src = x + static_cast<size_t>(b < B ? b : 0) * D;
      if (x_vec && (b >= B || c + kVec <= D)) {
        ptt::cp_async16(dst, src + (b < B ? c : 0), b < B ? 16 : 0);
      } else {
#pragma unroll
        for (int e = 0; e < kVec; ++e)
          dst[e] = (b < B && c + e < D) ? src[c + e] : ptt::from_f32<T>(0.f);
      }
    }
  }
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) fetch_next();

  // 2. LN of the group's rows in shared memory, in place, one warp a row,
  // 16 bytes a lane a step, while the weight slabs fly; rows past B and
  // columns past D stay zero
  if (!kStream) ptt::cp_async_wait<kStages - 2>();
  __syncthreads();
  for (int r = warp; !kStream && r < BM && row0 + r < B;
       r += kThreads / 32) {
    T* yr = ys + r * ldy;
    float s = 0.f;
    for (int c = lane * kVec; c < Dp; c += 32 * kVec) {
      float v[kVec];
      unpack16(yr + c, v);
#pragma unroll
      for (int e = 0; e < kVec; ++e) s += v[e];
    }
    const float mu = ptt::warp_sum(s) / static_cast<float>(D);
    float ss = 0.f;
    for (int c = lane * kVec; c < Dp; c += 32 * kVec) {
      float v[kVec];
      unpack16(yr + c, v);
#pragma unroll
      for (int e = 0; e < kVec; ++e) {
        const float d = c + e < D ? v[e] - mu : 0.f;
        ss += d * d;
      }
    }
    const float var = ptt::warp_sum(ss) / static_cast<float>(D);
    const float rstd = rsqrtf(var + eps);
    for (int c = lane * kVec; c < Dp; c += 32 * kVec) {
      float v[kVec];
      unpack16(yr + c, v);
#pragma unroll
      for (int e = 0; e < kVec; ++e) {
        const int i = c + e;
        const float n = __fmul_rn(v[e] - mu, rstd);
        yr[i] = ptt::from_f32<T>(
            i < D ? __fadd_rn(__fmul_rn(n, __ldg(scale + i)), __ldg(bias + i))
                  : 0.f);
      }
    }
  }

  // 3. the ring. bf16: acc[mt][n][e] is row 16 mt + g + 8(e>>1), column
  // 16 warp + 8n + 2t + (e&1). float32: acc[mt][j>>2][j&3] is row
  // 16 mt + 8 (tid >> 7) + j, column tid & 127.
  float acc[MT][2][4] = {};
  int kt = 0, tile = blockIdx.y;
  for (int q = 0; q < total; ++q) {
    ptt::cp_async_wait<kStages - 2>();
    __syncthreads();          // slab q landed; slab q-1's stage is free
    fetch_next();             // slab q + kStages - 1
    const T* ws = ring + (q % kStages) * kStage;
    const T* yk = kStream ? ws + L::kStage : ys + kt * kBK;
    if constexpr (kBF16) {
#pragma unroll
      for (int kk = 0; kk < kBK; kk += 16) {
        uint32_t b[4];
        ptt::ldmatrix_x4_trans(b, ws + (kk + ptt::ldm_row_a(lane)) * L::kLdW +
                                      warp * 16 + ptt::ldm_col_a(lane));
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          uint32_t a[4];
          ptt::ldmatrix_x4(a, yk + (mt * 16 + ptt::ldm_row_a(lane)) * ldy +
                                  kk + ptt::ldm_col_a(lane));
          ptt::mma_bf16(acc[mt][0], a, b[0], b[1]);
          ptt::mma_bf16(acc[mt][1], a, b[2], b[3]);
        }
      }
    } else {
      const int c = threadIdx.x & (kBN - 1), h = threadIdx.x >> 7;
#pragma unroll 2
      for (int k = 0; k < kBK; k += 4) {
        float wv[4];
#pragma unroll
        for (int e = 0; e < 4; ++e)
          wv[e] = ptt::to_f32(ws[(k + e) * L::kLdW + c]);
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            const float4 y4 = *reinterpret_cast<const float4*>(
                yk + (mt * 16 + 8 * h + j) * ldy + k);
            float& a = acc[mt][j >> 2][j & 3];
            a += y4.x * wv[0];
            a += y4.y * wv[1];
            a += y4.z * wv[2];
            a += y4.w * wv[3];
          }
      }
    }
    if (++kt < nk) continue;

    // 4. the tile's last slab: round and write it, start the next
    const int col0 = tile * kBN;
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      if constexpr (kBF16) {
#pragma unroll
        for (int n = 0; n < 2; ++n) {
          const int col = col0 + warp * 16 + 8 * n + 2 * t;
#pragma unroll
          for (int hh = 0; hh < 2; ++hh) {
            const int b = row0 + mt * 16 + g + 8 * hh;
            if (b < B && col < V)
              store_pair<T>(out + static_cast<size_t>(b) * V + col,
                            acc[mt][n][2 * hh], acc[mt][n][2 * hh + 1],
                            (V & 1) == 0, col + 1 < V);
          }
        }
      } else {
        const int col = col0 + (threadIdx.x & (kBN - 1));
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int b = row0 + mt * 16 + 8 * (threadIdx.x >> 7) + j;
          if (b < B && col < V)
            out[static_cast<size_t>(b) * V + col] =
                ptt::from_f32<T>(acc[mt][j >> 2][j & 3]);
        }
      }
#pragma unroll
      for (int n = 0; n < 2; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[mt][n][e] = 0.f;
    }
    kt = 0;
    tile += gy;
  }
  ptt::cp_async_wait<0>();    // the trailing (empty) groups
}

template <typename T, int MT, bool kStream>
int run(const T* x, const float* scale, const float* bias, const T* w,
        T* out, int B, int D, int V, int gy, float eps, cudaStream_t stream) {
  const size_t rows =
      kStream ? kStages * static_cast<size_t>(MT * 16) * (kBK + Lay<T>::kPad)
              : static_cast<size_t>(MT * 16) * (padded_d(D) + Lay<T>::kPad);
  const size_t smem = (rows + kStages * Lay<T>::kStage) * sizeof(T);
  const cudaError_t e = cudaFuncSetAttribute(
      logits_head_kernel<T, MT, kStream>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  // 16-byte copies where every row starts 16-byte aligned
  const int x_vec = (static_cast<size_t>(D) * sizeof(T)) % 16 == 0 &&
                    reinterpret_cast<uintptr_t>(x) % 16 == 0;
  const int vec_ok = (static_cast<size_t>(V) * sizeof(T)) % 16 == 0 &&
                     reinterpret_cast<uintptr_t>(w) % 16 == 0;
  const dim3 grid((B + MT * 16 - 1) / (MT * 16), gy);
  logits_head_kernel<T, MT, kStream><<<grid, kThreads, smem, stream>>>(
      x, scale, bias, w, out, B, D, V, eps, x_vec, vec_ok);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, bool kStream>
int by_bm(const T* x, const float* scale, const float* bias, const T* w,
          T* out, int B, int D, int V, int bm, int gy, float eps,
          cudaStream_t st) {
  switch (bm) {
    case 16:
      return run<T, 1, kStream>(x, scale, bias, w, out, B, D, V, gy, eps,
                                st);
    case 32:
      return run<T, 2, kStream>(x, scale, bias, w, out, B, D, V, gy, eps,
                                st);
    case 48:
      return run<T, 3, kStream>(x, scale, bias, w, out, B, D, V, gy, eps,
                                st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <typename T>
int launch(const void* xv, const void* scalev, const void* biasv,
           const void* wv, void* outv, int B, int D, int V, int bm, int gy,
           float eps, int stream_rows, cudaStream_t st) {
  const T* x = static_cast<const T*>(xv);
  const float* scale = static_cast<const float*>(scalev);
  const float* bias = static_cast<const float*>(biasv);
  const T* w = static_cast<const T*>(wv);
  T* out = static_cast<T*>(outv);
  if (gy < 1) return static_cast<int>(cudaErrorInvalidValue);
  return stream_rows
             ? by_bm<T, true>(x, scale, bias, w, out, B, D, V, bm, gy, eps,
                              st)
             : by_bm<T, false>(x, scale, bias, w, out, B, D, V, bm, gy, eps,
                               st);
}

}  // namespace

// x: [B, D], w: [D, V], out: [B, V], all contiguous in dtype `dtype`;
// scale, bias: [D] float32. bm (16, 32 or 48) rows a batch group and gy
// the blocks a group spreads the vocab tiles over, both from
// cuda_kernels.logits_head_plan; the grid is (ceil(B / bm), gy).
// stream_rows (the plan's): x holds the rows already normalised (scale,
// bias and eps unused), streamed through the ring with the weight.
extern "C" int ptt_logits_head(const void* x, const void* scale,
                               const void* bias, const void* w, void* out,
                               int B, int D, int V, int bm, int gy, float eps,
                               int stream_rows, int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case ptt::kF32:
      return launch<float>(x, scale, bias, w, out, B, D, V, bm, gy, eps,
                           stream_rows, st);
    case ptt::kBF16:
      return launch<__nv_bfloat16>(x, scale, bias, w, out, B, D, V, bm, gy,
                                   eps, stream_rows, st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
