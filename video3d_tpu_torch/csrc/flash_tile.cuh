// Tile machinery shared by the flash-style attention kernels: B2 in its
// prefill and GQA-folded forms (flash_attention.cu) and B5
// (shared_prefix_attention.cu).
//
// A 128-thread block owns 64 query rows (4 warps x 16 rows). Each kernel
// says where its query rows live (load_rows / load_tile), which keys it
// walks (stage_kv) and which (row, key) pairs are allowed (the mask given to
// attend_tile). Both products run on the tensor cores through WMMA
// 16x16x16 bf16 fragments with f32 accumulation (S = Q K^T, then O += P V
// with P rounded to bf16). Softmax is the online (flash) form with f32
// running max and sum, two lanes per row; the f32 output accumulator lives
// in shared memory so it can be rescaled by exp(m_old - m_new) between
// tiles. A masked key gets exactly zero weight: exp(-1e30 - m) underflows
// to 0 once a row has a finite max, and a row that has seen no allowed key
// yet takes p = 0 from one per-row guard, so its output stays finite. (A
// per-key select instead cost 11% of B2's prefill time on the H100.)
//
// int8 keys and values (the int8 forms of B2 folded and B5): stage_kv_int8
// converts a tile to bf16 while staging it (exact for |x| <= 127) and puts
// its 64 key and 64 value scales where the Q tile was; stage_kv_int4 does
// the same for int4 keys and values packed two channels per byte (the int4
// forms), each 4-byte word unpacked to 8 exact bf16 values by B8's nibble
// splice (common.cuh), into the same bf16 tile. Q is read only into
// registers (load_q_frags) before the first key tile, so the shared-memory
// budget stays kSmemBytes. attend_tile<true> then scales a score by its
// key's scale after sm_scale, sums l over the unscaled p, and scales p by
// its value's scale before rounding the P tile to bf16, as the TPU kernel
// does. attend_tile<false> compiles to the bf16-only code.
#pragma once

#include <mma.h>

#include "common.cuh"

namespace v3d_flash {

using namespace nvcuda;
typedef __nv_bfloat16 bf16;

constexpr int kHd = 128;
constexpr int kBq = 64;
constexpr int kBk = 64;
constexpr int kThreads = 128;     // 4 warps x 16 query rows
constexpr int kLdq = kHd + 8;     // bf16 row stride of the Q/K/V tiles
constexpr int kLds = kBk + 4;     // f32 row stride of the score tile
constexpr int kLdp = kBk + 8;     // bf16 row stride of the probability tile
constexpr int kLdo = kHd + 4;     // f32 row stride of the output accumulator
constexpr int kSmemBytes = 3 * kBq * kLdq * 2 + kBq * kLds * 4 +
                           kBq * kLdp * 2 + kBq * kLdo * 4;

typedef wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> QFrag;

struct Tiles {
  bf16* q;     // (64, kLdq) query tile
  bf16* k;     // (64, kLdq) key tile
  bf16* v;     // (64, kLdq) value tile
  float* s;    // (64, kLds) scores
  bf16* p;     // (64, kLdp) probabilities
  float* o;    // (64, kLdo) output accumulator
};

// every tile starts on a 32-byte boundary, as WMMA loads and stores need
__device__ __forceinline__ Tiles carve(unsigned char* smem) {
  Tiles t;
  t.q = reinterpret_cast<bf16*>(smem);
  t.k = t.q + kBq * kLdq;
  t.v = t.k + kBk * kLdq;
  t.s = reinterpret_cast<float*>(t.v + kBk * kLdq);
  t.p = reinterpret_cast<bf16*>(t.s + kBq * kLds);
  t.o = reinterpret_cast<float*>(t.p + kBq * kLdp);
  return t;
}

// rows [r0, r0 + 64) of a (nrows, row_stride) bf16 matrix -> shared tile,
// zero rows past nrows
__device__ __forceinline__ void load_tile(bf16* dst, const bf16* src,
                                          long long row_stride, int r0,
                                          int nrows) {
  for (int c = threadIdx.x; c < kBq * (kHd / 8); c += kThreads) {
    const int r = c / (kHd / 8), col = (c % (kHd / 8)) * 8;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (r0 + r < nrows)
      val = *reinterpret_cast<const uint4*>(src + (long long)(r0 + r) * row_stride + col);
    *reinterpret_cast<uint4*>(dst + r * kLdq + col) = val;
  }
}

// 64 query rows, row r read from row_ptr(r) (nullptr: a zero row)
template <class RowPtr>
__device__ __forceinline__ void load_rows(bf16* dst, RowPtr row_ptr) {
  for (int c = threadIdx.x; c < kBq * (kHd / 8); c += kThreads) {
    const int r = c / (kHd / 8), col = (c % (kHd / 8)) * 8;
    const bf16* src = row_ptr(r);
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (src != nullptr) val = *reinterpret_cast<const uint4*>(src + col);
    *reinterpret_cast<uint4*>(dst + r * kLdq + col) = val;
  }
}

__device__ __forceinline__ void zero_output(const Tiles& t) {
  for (int i = threadIdx.x; i < kBq * kLdo; i += kThreads) t.o[i] = 0.f;
}

// this warp's 16 query rows as A fragments (after the Q tile is staged and
// the block has synchronised)
__device__ __forceinline__ void load_q_frags(const Tiles& t, QFrag* qf) {
  const int warp = threadIdx.x / 32;
#pragma unroll
  for (int kk = 0; kk < kHd / 16; ++kk)
    wmma::load_matrix_sync(qf[kk], t.q + warp * 16 * kLdq + kk * 16, kLdq);
}

// Per-thread softmax state: lanes 2r and 2r+1 of a warp share row r of its
// 16 query rows, each owning 32 of a tile's 64 keys.
struct RowState {
  int row;     // query row within the block's tile, 0..63
  int half;    // which 32 keys of each tile this lane owns
  float m;     // running max of the scaled scores
  float l;     // running sum of exp(score - m)
};

__device__ __forceinline__ RowState row_state() {
  const int lane = threadIdx.x % 32;
  RowState st;
  st.row = (threadIdx.x / 32) * 16 + (lane >> 1);
  st.half = lane & 1;
  st.m = V3D_NEG_INF;
  st.l = 0.f;
  return st;
}

// keys [k0, k0 + 64) of a (nkeys, stride) K and V -> the shared K/V tiles
// (zero rows past nkeys); all threads of the block call it
__device__ __forceinline__ void stage_kv(const Tiles& t, const bf16* k,
                                         const bf16* v, long long stride,
                                         int k0, int nkeys) {
  __syncthreads();                       // every warp is done with K/V
  load_tile(t.k, k, stride, k0, nkeys);
  load_tile(t.v, v, stride, k0, nkeys);
  __syncthreads();
}

// rows [r0, r0 + 64) of a (nrows, row_stride) int8 matrix -> shared bf16
// tile, zero rows past nrows
__device__ __forceinline__ void load_tile_int8(bf16* dst, const int8_t* src,
                                               long long row_stride, int r0,
                                               int nrows) {
  for (int c = threadIdx.x; c < kBk * (kHd / 8); c += kThreads) {
    const int r = c / (kHd / 8), col = (c % (kHd / 8)) * 8;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (r0 + r < nrows) {
      const uint2 u = *reinterpret_cast<const uint2*>(
          src + (long long)(r0 + r) * row_stride + col);
      float f[8];
      v3d_int8x4_to_float(u.x, f);
      v3d_int8x4_to_float(u.y, f + 4);
      __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&val);
#pragma unroll
      for (int i = 0; i < 4; ++i) h[i] = __floats2bfloat162_rn(f[2 * i], f[2 * i + 1]);
    }
    *reinterpret_cast<uint4*>(dst + r * kLdq + col) = val;
  }
}

// rows [r0, r0 + 64) of a (nrows, row_stride bytes) int4 matrix, packed
// two channels per byte -> shared bf16 tile, zero rows past nrows
__device__ __forceinline__ void load_tile_int4(bf16* dst, const v3d_nib4* src,
                                               long long row_stride, int r0,
                                               int nrows) {
  for (int c = threadIdx.x; c < kBk * (kHd / 8); c += kThreads) {
    const int r = c / (kHd / 8), col = (c % (kHd / 8)) * 8;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (r0 + r < nrows) {
      const unsigned w = *reinterpret_cast<const unsigned*>(
          src + (long long)(r0 + r) * row_stride + col / 2);
      v3d_nibble_pairs(w, reinterpret_cast<unsigned*>(&val));
    }
    *reinterpret_cast<uint4*>(dst + r * kLdq + col) = val;
  }
}

// the key scales (64 floats) and then the value scales of the staged tile,
// in the Q tile's space
__device__ __forceinline__ float* tile_scales(const Tiles& t) {
  return reinterpret_cast<float*>(t.q);
}

// the per-key scales ks[key * sstride] and vs[key * sstride] of the tile
// being staged (zero past nkeys, where the mask drops the key anyway)
__device__ __forceinline__ void stage_scales(const Tiles& t, const float* ks,
                                             const float* vs,
                                             long long sstride, int k0,
                                             int nkeys) {
  float* sc = tile_scales(t);
  for (int i = threadIdx.x; i < 2 * kBk; i += kThreads) {
    const int key = k0 + i % kBk;
    const float* src = i < kBk ? ks : vs;
    sc[i] = key < nkeys ? src[(long long)key * sstride] : 0.f;
  }
}

// stage_kv for an int8 K and V with per-key scales ks and vs
__device__ __forceinline__ void stage_kv_int8(const Tiles& t, const int8_t* k,
                                              const int8_t* v,
                                              long long stride,
                                              const float* ks,
                                              const float* vs,
                                              long long sstride, int k0,
                                              int nkeys) {
  __syncthreads();                       // every warp is done with K/V
  load_tile_int8(t.k, k, stride, k0, nkeys);
  load_tile_int8(t.v, v, stride, k0, nkeys);
  stage_scales(t, ks, vs, sstride, k0, nkeys);
  __syncthreads();
}

// stage_kv for an int4 K and V (rows of `stride` bytes) with per-key
// scales ks and vs
__device__ __forceinline__ void stage_kv_int4(const Tiles& t,
                                              const v3d_nib4* k,
                                              const v3d_nib4* v,
                                              long long stride,
                                              const float* ks,
                                              const float* vs,
                                              long long sstride, int k0,
                                              int nkeys) {
  __syncthreads();                       // every warp is done with K/V
  load_tile_int4(t.k, k, stride, k0, nkeys);
  load_tile_int4(t.v, v, stride, k0, nkeys);
  stage_scales(t, ks, vs, sstride, k0, nkeys);
  __syncthreads();
}

// One staged 64-key tile (keys k0 .. k0 + 63) of the online softmax.
// ok(col) says whether this thread's row may attend key col. kQuant: the
// tile was staged by stage_kv_int8 or stage_kv_int4 and its scales apply.
template <bool kQuant = false, class Ok>
__device__ __forceinline__ void attend_tile(const Tiles& t, const QFrag* qf,
                                            RowState& st, int k0,
                                            float sm_scale, Ok ok) {
  const int warp = threadIdx.x / 32;
#pragma unroll
  for (int n = 0; n < kBk / 16; ++n) {   // S = Q K^T, this warp's rows
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> sf;
    wmma::fill_fragment(sf, 0.f);
#pragma unroll
    for (int kk = 0; kk < kHd / 16; ++kk) {
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> kf;
      wmma::load_matrix_sync(kf, t.k + n * 16 * kLdq + kk * 16, kLdq);
      wmma::mma_sync(sf, qf[kk], kf, sf);
    }
    wmma::store_matrix_sync(t.s + warp * 16 * kLds + n * 16, sf, kLds,
                            wmma::mem_row_major);
  }
  __syncwarp();

  const float* srow = t.s + st.row * kLds + st.half * 32;
  bf16* prow = t.p + st.row * kLdp + st.half * 32;
  const float* kscale = tile_scales(t) + st.half * 32;
  const float* vscale = kscale + kBk;
  float sv[32];
  float mx = V3D_NEG_INF;
#pragma unroll
  for (int c = 0; c < 32; ++c) {
    if constexpr (kQuant)
      sv[c] = ok(k0 + st.half * 32 + c) ? srow[c] * sm_scale * kscale[c]
                                        : V3D_NEG_INF;
    else
      sv[c] = ok(k0 + st.half * 32 + c) ? srow[c] * sm_scale : V3D_NEG_INF;
    mx = fmaxf(mx, sv[c]);
  }
  mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
  const float m_new = fmaxf(st.m, mx);
  const float alpha = expf(st.m - m_new);
  // 0 while this row has seen no allowed key (m_new still -1e30)
  const float live = m_new > 0.5f * V3D_NEG_INF ? 1.f : 0.f;
  float sum = 0.f;
#pragma unroll
  for (int c = 0; c < 32; ++c) {
    const float p = expf(sv[c] - m_new) * live;
    sum += p;
    if constexpr (kQuant)
      prow[c] = __float2bfloat16(p * vscale[c]);
    else
      prow[c] = __float2bfloat16(p);
  }
  sum += __shfl_xor_sync(0xffffffffu, sum, 1);
  st.l = st.l * alpha + sum;
  st.m = m_new;
  float* orow = t.o + st.row * kLdo + st.half * (kHd / 2);
#pragma unroll 8
  for (int d = 0; d < kHd / 2; ++d) orow[d] *= alpha;
  __syncwarp();

#pragma unroll
  for (int n = 0; n < kHd / 16; ++n) {   // O += P V
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> of;
    float* optr = t.o + warp * 16 * kLdo + n * 16;
    wmma::load_matrix_sync(of, optr, kLdo, wmma::mem_row_major);
#pragma unroll
    for (int kk = 0; kk < kBk / 16; ++kk) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> pf;
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> vf;
      wmma::load_matrix_sync(pf, t.p + warp * 16 * kLdp + kk * 16, kLdp);
      wmma::load_matrix_sync(vf, t.v + kk * 16 * kLdq + n * 16, kLdq);
      wmma::mma_sync(of, pf, vf, of);
    }
    wmma::store_matrix_sync(optr, of, kLdo, wmma::mem_row_major);
  }
  __syncwarp();
}

// this thread's half of its row of the normalised output -> dst (hd bf16);
// the final divide guards l >= 1e-30, as the JAX contract says
__device__ __forceinline__ void store_row(const Tiles& t, const RowState& st,
                                          bf16* dst) {
  const float denom = fmaxf(st.l, 1e-30f);
  const float* orow = t.o + st.row * kLdo + st.half * (kHd / 2);
  bf16* d = dst + st.half * (kHd / 2);
#pragma unroll 8
  for (int i = 0; i < kHd / 2; i += 2)
    *reinterpret_cast<__nv_bfloat162*>(d + i) =
        __floats2bfloat162_rn(orow[i] / denom, orow[i + 1] / denom);
}

}  // namespace v3d_flash
