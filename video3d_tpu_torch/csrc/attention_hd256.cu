// Attention at head width 256 (Gemma), in the five forms of the engine's
// answer and serving paths: B2's prefill, B2 folded, B3, B7 and B5; the
// last four also over an int8 or a packed int4 cache (or B5's prefix).
//
// Replaces, at hd 256:
//   * video3d_tpu/kernels/flash_attention.py::_fwd_kernel (call :283), the
//     prefill form: query row r attends keys s <= r and s < lengths[b];
//   * the same kernel with pos_div = group (:66; entry
//     flash_attention_gqa_folded, :760), the folded form: a suffix chunk
//     whose rows sit at q_offsets[b] + r over one layer of the stacked
//     (layers, B, S, KV*hd) cache;
//   * video3d_tpu/kernels/decode_attention.py::_decode_kernel_blockdiag
//     (call :243), the decode form: one token at kv_len[b] - 1;
//   * video3d_tpu/kernels/paged_attention.py::_ragged_kernel (call :266),
//     the paged form: the decode form with key s of slot b in pool page
//     page_table[b, s / page], row s % page, of one layer's (P, page,
//     KV*hd) pool (the paged batcher's decode step);
//   * video3d_tpu/kernels/flash_attention.py::_sp_fused_kernel (call
//     :910), the shared-prefix form: query r of row b at position P + r
//     attends ONE (P, KV*hd) prefix (no batch stride), then its row's own
//     suffix keys j <= r, j < suffix_lens[b] (the batched answers over a
//     cached scene prefix).
// JAX sends any hd % 128 == 0 to those Pallas kernels, over a bf16 cache
// and over an int8 or int4 one with f32 scales per (position, kv head)
// (attention.py:181, :195, :401; flash_attention.py:813-815, :879-881);
// the port's hd-128 kernels are compiled for 128 only, so hd 256 has this
// kernel of its own.
//
// What bounds it on an H100: the prefill, folded and shared-prefix forms
// are products of 4 * rows * keys * 256 FLOP (causal: about half the
// rectangle), far above the card's ~295 FLOP/byte ridge at prefill
// lengths, so the tensor cores bound them; the decode and paged forms read
// 2 * kv_len * KV * 256 * 2 bytes of K and V (int8: half, int4: a quarter,
// plus 8 bytes of scales per key and kv head) for ~4-16 FLOP per byte, so
// HBM bounds them.
//
// Design (a first, simple form; a wgmma / TMA design is later work): one
// template for all five forms, which differ only in where a query row
// sits and where a key's row lies (kMode). In the paged and shared-prefix
// forms, 64 threads look up each 64-key tile's K and V row addresses into
// shared memory first: a page-table entry per key in the paged form, so
// any page size works; prefix or suffix in the shared-prefix form, whose
// key axis is the prefix padded to whole tiles, then the suffix. A null
// address is a key no row may attend, loaded as zeros and masked. The
// dense forms address their rows by stride. A quantized cache (kCache)
// changes only where a tile's K and V come from: an int8 row is 256 bytes,
// a packed int4 row 128 (channel 2j in byte j's low nibble, 2j + 1 in its
// high, two's complement); each row is converted to bf16 into the same
// tiles (exact: |x| <= 127), and the tile's 64 key and 64 value scales go
// to shared memory beside it. They apply as in the TPU kernel
// (decode_attention.py:105-117): the key scale (times sm_scale) on the
// score column, l summed over the unscaled p, the value scale on p before
// its bf16 rounding. B5's suffix stays bf16 (scale 1), and the prefix's
// padding keeps prefix and suffix keys in separate tiles. The bf16
// instantiations compile as they did before the quantized ones existed.
// A CTA of 8 warps takes 64 folded query rows (row f of a kv head is query
// position f / G of query head g * G + f % G, so the G <= 8 query heads of
// a kv head share its K/V tiles) and walks a range of 64-key tiles. Q, the
// K and V tiles, the f32 score tile, the bf16 probability tile and the f32
// output accumulator all live in shared memory (192 KiB, one CTA per SM);
// the products run on the tensor cores through WMMA bf16 16x16x16
// fragments with f32 sums; the online softmax runs in f32, four threads
// per row. Where the row tiles
// alone do not fill the card, the keys split over CTAs (the plan is the
// host's, from the shapes alone: kv_len, the page table and the suffix
// lengths stay on the device) and each split writes its unnormalised
// output with its row max and sum into an f32 workspace that a second
// kernel merges, row by row. A split whose keys all lie past its rows'
// limits writes an empty partial, so a launch with fewer live positions
// than CTAs merges right.
#include <mma.h>

#include "common.cuh"

namespace {

using namespace nvcuda;
typedef __nv_bfloat16 bf16;
typedef unsigned char u8;

constexpr int kHd = 256;
constexpr int kRows = 64;         // folded query rows per CTA
constexpr int kKeys = 64;         // keys per tile
constexpr int kThreads = 256;     // 8 warps
constexpr int kLdh = kHd + 8;     // bf16 row pitch of Q / K / V tiles
constexpr int kLds = kKeys + 4;   // f32 row pitch of the score tile
constexpr int kLdp = kKeys + 8;   // bf16 row pitch of the probability tile
constexpr int kLdo = kHd + 4;     // f32 row pitch of the output accumulator
constexpr int kPartFloats = kHd + 2;   // one split's O, m and l of a row

constexpr size_t kSmemBytes =
    3 * sizeof(bf16) * kRows * kLdh            // Q, K, V
    + sizeof(float) * kRows * kLds             // scores
    + sizeof(bf16) * kRows * kLdp              // probabilities
    + sizeof(float) * kRows * kLdo             // output accumulator
    + sizeof(float) * 2 * kRows                // m, l per row
    + sizeof(int) * 2 * kRows                  // position, limit per row
    + sizeof(void*) * 2 * kKeys;               // K, V row of each key

enum Mode { kPrefill = 0, kFolded = 1, kDecode = 2, kPaged = 3,
            kSharedPrefix = 4 };
// the cache's storage: bf16, int8, or int4 packed two channels a byte
enum Cache { kBf16 = 0, kInt8 = 1, kInt4 = 2 };

// a quantized form's shared memory: the bf16 form's, then the tile's key
// scales (times sm_scale * log2 e) and value scales
template <int kCache>
constexpr size_t smem_bytes() {
  return kSmemBytes + (kCache == kBf16 ? 0 : sizeof(float) * 2 * kKeys);
}

// the element a cache row is addressed in (a quantized row by bytes)
template <int kCache>
using Elem = typename std::conditional<kCache == kBf16, bf16, u8>::type;

__device__ __forceinline__ float neg_inf() {
  return __int_as_float(0xff800000u);
}

struct Params {
  const bf16* q;      // (B, L, H, 256)
  const void* k;      // (B, S, KV, 256): a prefill's K or a cache layer;
                      // paged: one layer's (P, page, KV*256) pool;
                      // shared prefix: the (P, KV*256) prefix (a quantized
                      // cache: int8, or int4 rows of KV*128 bytes)
  const void* v;
  const bf16* suf_k;  // shared prefix: the (B, L, KV*256) suffix
  const bf16* suf_v;
  const int* lens;    // (B,) keys valid below lens[b] (shared prefix: the
                      // suffix lengths)
  const int* q_off;   // (B,) folded: position of query row 0
  const int* table;   // paged: (B, maxp) pool page of each slot's page
  bf16* out;          // (B, L, H, 256)
  float* ws;          // split partials (splits > 1)
  int B, L, S, H, KV, G, row_tiles, splits, split_keys;
  int page, maxp;     // paged: positions per page, pages per slot
  int P, Pp;          // shared prefix: its length, rounded up to kKeys
  float scale_log2;   // sm_scale * log2(e)
  // a quantized cache's f32 scales of K and V: the layer's (B, S, KV, 1)
  // (dense forms), the layer's (P, KV, 1, page) pool (paged), the prefix's
  // (P, KV, 1) (shared prefix)
  const float* ks;
  const float* vs;
};

// 64 rows of 256 bf16 (row i at row(i)) into a pitched tile; rows whose
// address is null are zero-filled
template <typename RowPtr>
__device__ __forceinline__ void load_tile(bf16* dst, RowPtr row) {
  // 64 rows x 32 16-byte chunks = 2048 chunks, 8 per thread
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int c = threadIdx.x + i * kThreads;
    const int r = c >> 5, col = (c & 31) * 8;
    const bf16* src = row(r);
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (src != nullptr) val = *reinterpret_cast<const uint4*>(src + col);
    *reinterpret_cast<uint4*>(dst + r * kLdh + col) = val;
  }
}

__device__ __forceinline__ unsigned bf16x2(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const unsigned*>(&h);
}

// 64 quantized rows (row i's bytes at row(i): 256 int8, or 128 bytes of
// packed int4) converted exactly to bf16 into a pitched tile; null rows
// are zero-filled
template <int kCache, typename RowPtr>
__device__ __forceinline__ void load_quant_tile(bf16* dst, RowPtr row) {
  // a chunk of 16 bytes: 16 int8 or 32 int4 channels; 64 rows of 16 (int8)
  // or 8 (int4) chunks, 4 or 2 per thread
  constexpr int kChunks = kCache == kInt8 ? 16 : 8;
#pragma unroll
  for (int i = 0; i < kRows * kChunks / kThreads; ++i) {
    const int c = threadIdx.x + i * kThreads;
    const int r = c / kChunks, chunk = c % kChunks;
    const u8* src = row(r);
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (src != nullptr)
      val = *reinterpret_cast<const uint4*>(src + chunk * 16);
    const unsigned w[4] = {val.x, val.y, val.z, val.w};
    if constexpr (kCache == kInt8) {
      uint4* d = reinterpret_cast<uint4*>(dst + r * kLdh + chunk * 16);
      unsigned o[8];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        float f[4];
        v3d_int8x4_to_float(w[j], f);
        o[2 * j] = bf16x2(f[0], f[1]);
        o[2 * j + 1] = bf16x2(f[2], f[3]);
      }
      d[0] = make_uint4(o[0], o[1], o[2], o[3]);
      d[1] = make_uint4(o[4], o[5], o[6], o[7]);
    } else {
      // byte j of a word: channels 2j (low nibble) and 2j + 1 (high)
      uint4* d = reinterpret_cast<uint4*>(dst + r * kLdh + chunk * 32);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        unsigned o[4];
        v3d_nibble_pairs(w[j], o);
        d[j] = make_uint4(o[0], o[1], o[2], o[3]);
      }
    }
  }
}

template <int kMode, int kCache>
__global__ void __launch_bounds__(kThreads, 1)
attention_hd256_kernel(const Params p) {
  using E = Elem<kCache>;
  constexpr int kPer = kCache == kInt4 ? 2 : 1;   // channels per element
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* sq = reinterpret_cast<bf16*>(smem);
  bf16* sk = sq + kRows * kLdh;
  bf16* sv = sk + kRows * kLdh;
  float* ss = reinterpret_cast<float*>(sv + kRows * kLdh);
  bf16* sp = reinterpret_cast<bf16*>(ss + kRows * kLds);
  float* so = reinterpret_cast<float*>(sp + kRows * kLdp);
  float* sm_m = so + kRows * kLdo;
  float* sm_l = sm_m + kRows;
  int* s_pos = reinterpret_cast<int*>(sm_l + kRows);
  int* s_lim = s_pos + kRows;
  const E** s_kr = reinterpret_cast<const E**>(s_lim + kRows);
  const E** s_vr = s_kr + kKeys;
  // a quantized tile's key scales (times scale_log2) and value scales
  float* s_ks = reinterpret_cast<float*>(s_vr + kKeys);
  float* s_vs = s_ks + kKeys;

  // the paged and shared-prefix forms look each tile's rows up first
  constexpr bool kLookup = kMode == kPaged || kMode == kSharedPrefix;
  const int tile = blockIdx.x, split = blockIdx.y;
  const int bkv = blockIdx.z, b = bkv / p.KV, g = bkv % p.KV;
  const int rows_total = p.L * p.G;
  const int f0 = tile * kRows;
  const int tid = threadIdx.x, warp = tid >> 5;

  // each row's position and key limit, on the key axis (shared prefix:
  // the padded prefix's Pp slots, then the suffix); the tile's key range
  int lim_b, pos0 = 0;
  if (kMode == kSharedPrefix) {
    pos0 = p.Pp;
    lim_b = p.Pp + min(max(p.lens[b], 0), p.L);
  } else {
    lim_b = min(max(p.lens[b], 0), p.S);
    if (kMode == kFolded) pos0 = p.q_off[b];
    if (kMode == kDecode || kMode == kPaged) pos0 = p.lens[b] - 1;
  }
  if (tid < kRows) {
    const int f = f0 + tid;
    s_pos[tid] = f < rows_total ? pos0 + f / p.G : -1;
    s_lim[tid] = lim_b;
    sm_m[tid] = neg_inf();
    sm_l[tid] = 0.f;
  }
  const int last_row = min(f0 + kRows, rows_total) - 1;
  const int k_begin = split * p.split_keys;
  const int k_end = min(min(k_begin + p.split_keys, lim_b),
                        pos0 + last_row / p.G + 1);

  for (int i = tid; i < kRows * kLdo; i += kThreads) so[i] = 0.f;

  const long long q_row = static_cast<long long>(p.H) * kHd;
  load_tile(sq, [&](int r) -> const bf16* {
    const int f = f0 + r;
    if (f >= rows_total) return nullptr;
    const int l = f / p.G, h = g * p.G + f % p.G;
    return p.q + (static_cast<long long>(b) * p.L + l) * q_row
        + static_cast<long long>(h) * kHd;
  });

  // row 0 of kv head g: of batch row b's keys (dense forms), of the pool
  // layer (paged), of the prefix (shared prefix); the suffix's row 0. The
  // offsets count channels, a quantized row's elements are bytes.
  const long long kv_row = static_cast<long long>(p.KV) * kHd;
  const long long base = static_cast<long long>(g) * kHd
      + (kMode <= kDecode ? static_cast<long long>(b) * p.S * kv_row : 0);
  const E* kb = static_cast<const E*>(p.k) + base / kPer;
  const E* vb = static_cast<const E*>(p.v) + base / kPer;
  const long long suf = kMode == kSharedPrefix
      ? static_cast<long long>(b) * p.L * kv_row
          + static_cast<long long>(g) * kHd - static_cast<long long>(p.Pp)
          * kv_row
      : 0;

  // the softmax's four threads of one row and its 16 columns
  const int srow = tid >> 2, sq4 = tid & 3;

  for (int kt = k_begin; kt < k_end; kt += kKeys) {
    __syncthreads();   // the previous tile's P, V, rows and scales are
                       // consumed
    if (kLookup) {
      if (tid < kKeys) {
        // key s's K and V rows, or null: past the range, or the padding
        // after the prefix (a quantized form: their scales, or 0)
        const int s = kt + tid;
        const E *kr = nullptr, *vr = nullptr;
        float ksc = 0.f, vsc = 0.f;
        if (s < k_end) {
          if (kMode == kPaged) {
            const long long row = static_cast<long long>(
                p.table[static_cast<long long>(b) * p.maxp + s / p.page])
                * p.page + s % p.page;
            kr = kb + row * kv_row / kPer;
            vr = vb + row * kv_row / kPer;
            if constexpr (kCache != kBf16) {
              // the layer's scale pool is (P, KV, 1, page): page row - r,
              // kv head g, position r
              const int r = s % p.page;
              const long long at = (row - r) * p.KV
                  + static_cast<long long>(g) * p.page + r;
              ksc = p.ks[at] * p.scale_log2;
              vsc = p.vs[at];
            }
          } else if (s < p.P) {
            kr = kb + static_cast<long long>(s) * kv_row / kPer;
            vr = vb + static_cast<long long>(s) * kv_row / kPer;
            if constexpr (kCache != kBf16) {
              const long long at = static_cast<long long>(s) * p.KV + g;
              ksc = p.ks[at] * p.scale_log2;
              vsc = p.vs[at];
            }
          } else if (s >= p.Pp) {
            kr = reinterpret_cast<const E*>(
                p.suf_k + (suf + static_cast<long long>(s) * kv_row));
            vr = reinterpret_cast<const E*>(
                p.suf_v + (suf + static_cast<long long>(s) * kv_row));
            ksc = p.scale_log2;
            vsc = 1.f;
          }
        }
        s_kr[tid] = kr;
        s_vr[tid] = vr;
        if constexpr (kCache != kBf16) {
          s_ks[tid] = ksc;
          s_vs[tid] = vsc;
        }
      }
      __syncthreads();
      if constexpr (kCache == kBf16) {
        load_tile(sk, [&](int r) { return s_kr[r]; });
        load_tile(sv, [&](int r) { return s_vr[r]; });
      } else if (kMode == kSharedPrefix && kt >= p.Pp) {
        // a suffix tile: bf16 rows
        load_tile(sk, [&](int r) {
          return reinterpret_cast<const bf16*>(s_kr[r]); });
        load_tile(sv, [&](int r) {
          return reinterpret_cast<const bf16*>(s_vr[r]); });
      } else {
        load_quant_tile<kCache>(sk, [&](int r) { return s_kr[r]; });
        load_quant_tile<kCache>(sv, [&](int r) { return s_vr[r]; });
      }
    } else {
      auto row = [&](const E* base_ptr, int r) -> const E* {
        const int s = kt + r;
        return s < k_end ? base_ptr + static_cast<long long>(s) * kv_row
                               / kPer
                         : nullptr;
      };
      if constexpr (kCache == kBf16) {
        load_tile(sk, [&](int r) { return row(kb, r); });
        load_tile(sv, [&](int r) { return row(vb, r); });
      } else {
        if (tid < kKeys) {
          // the scales of key s of row b, kv head g: (B, S, KV, 1)
          const int s = kt + tid;
          const long long at = (static_cast<long long>(b) * p.S + s) * p.KV
              + g;
          s_ks[tid] = s < k_end ? p.ks[at] * p.scale_log2 : 0.f;
          s_vs[tid] = s < k_end ? p.vs[at] : 0.f;
        }
        load_quant_tile<kCache>(sk, [&](int r) { return row(kb, r); });
        load_quant_tile<kCache>(sv, [&](int r) { return row(vb, r); });
      }
    }
    __syncthreads();

    // S = Q K^T: 4 x 4 fragments of 16 x 16, two per warp
    {
      const int mi = warp >> 1, nj0 = (warp & 1) * 2;
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2];
      wmma::fill_fragment(acc[0], 0.f);
      wmma::fill_fragment(acc[1], 0.f);
#pragma unroll 4
      for (int kk = 0; kk < kHd; kk += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
        wmma::load_matrix_sync(a, sq + mi * 16 * kLdh + kk, kLdh);
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major>
              bt;
          wmma::load_matrix_sync(bt, sk + (nj0 + j) * 16 * kLdh + kk, kLdh);
          wmma::mma_sync(acc[j], a, bt, acc[j]);
        }
      }
#pragma unroll
      for (int j = 0; j < 2; ++j)
        wmma::store_matrix_sync(ss + mi * 16 * kLds + (nj0 + j) * 16, acc[j],
                                kLds, wmma::mem_row_major);
    }
    __syncthreads();

    // online softmax of row srow over this tile, columns sq4 * 16 + [0, 16)
    {
      const int pos = s_pos[srow], lim = s_lim[srow];
      float x[16];
      float mx = neg_inf();
#pragma unroll
      for (int c = 0; c < 16; ++c) {
        const int col = sq4 * 16 + c, s = kt + col;
        const bool ok = pos >= 0 && s <= pos && s < lim
            && (kLookup ? s_kr[col] != nullptr : s < k_end);
        if constexpr (kCache == kBf16)
          x[c] = ok ? ss[srow * kLds + col] * p.scale_log2 : neg_inf();
        else   // the key scale on the score column
          x[c] = ok ? ss[srow * kLds + col] * s_ks[col] : neg_inf();
        mx = fmaxf(mx, x[c]);
      }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_old = sm_m[srow];
      const float m_new = fmaxf(m_old, mx);
      float sum = 0.f;
#pragma unroll
      for (int c = 0; c < 16; ++c) {
        const float e = m_new == neg_inf() ? 0.f : exp2f(x[c] - m_new);
        sum += e;
        if constexpr (kCache == kBf16)
          sp[srow * kLdp + sq4 * 16 + c] = __float2bfloat16(e);
        else   // l sums the unscaled p; the value scale on p before bf16
          sp[srow * kLdp + sq4 * 16 + c] =
              __float2bfloat16(e * s_vs[sq4 * 16 + c]);
      }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      const float alpha = m_new == neg_inf() ? 1.f : exp2f(m_old - m_new);
      // rescale this row's accumulator: 64 columns per thread
      float* orow = so + srow * kLdo + sq4 * 64;
#pragma unroll 8
      for (int c = 0; c < 64; ++c) orow[c] *= alpha;
      __syncwarp();
      if (sq4 == 0) {
        sm_m[srow] = m_new;
        sm_l[srow] = sm_l[srow] * alpha + sum;
      }
    }
    __syncthreads();

    // O += P V: 4 x 16 fragments, eight per warp (one row of fragments,
    // half its columns)
    {
      const int mi = warp >> 1, n0 = (warp & 1) * 8;
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[8];
#pragma unroll
      for (int j = 0; j < 8; ++j)
        wmma::load_matrix_sync(acc[j], so + mi * 16 * kLdo + (n0 + j) * 16,
                               kLdo, wmma::mem_row_major);
#pragma unroll
      for (int kk = 0; kk < kKeys; kk += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
        wmma::load_matrix_sync(a, sp + mi * 16 * kLdp + kk, kLdp);
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major>
              bv;
          wmma::load_matrix_sync(bv, sv + kk * kLdh + (n0 + j) * 16, kLdh);
          wmma::mma_sync(acc[j], a, bv, acc[j]);
        }
      }
#pragma unroll
      for (int j = 0; j < 8; ++j)
        wmma::store_matrix_sync(so + mi * 16 * kLdo + (n0 + j) * 16, acc[j],
                                kLdo, wmma::mem_row_major);
    }
  }
  __syncthreads();

  // write: the normalised rows (one split), or this split's partials
  for (int i = tid; i < kRows * kHd; i += kThreads) {
    const int r = i / kHd, c = i % kHd;
    const int f = f0 + r;
    if (f >= rows_total) continue;
    const float o = so[r * kLdo + c];
    if (p.splits == 1) {
      const float l = sm_l[r];
      const int lq = f / p.G, h = g * p.G + f % p.G;
      p.out[(static_cast<long long>(b) * p.L + lq) * q_row
            + static_cast<long long>(h) * kHd + c] =
          __float2bfloat16(l > 0.f ? o / l : 0.f);
    } else {
      float* part = p.ws + ((static_cast<long long>(bkv) * rows_total + f)
                            * p.splits + split) * kPartFloats;
      part[c] = o;
      if (c == 0) {
        part[kHd] = sm_m[r];
        part[kHd + 1] = sm_l[r];
      }
    }
  }
}

// merge the splits of each folded row: one CTA of 256 threads per row, a
// thread per channel
__global__ void __launch_bounds__(kHd)
attention_hd256_merge(const Params p) {
  const int f = blockIdx.x, bkv = blockIdx.y;
  const int b = bkv / p.KV, g = bkv % p.KV;
  const int rows_total = p.L * p.G;
  const int c = threadIdx.x;
  const float* part = p.ws + (static_cast<long long>(bkv) * rows_total + f)
      * p.splits * kPartFloats;
  float mx = neg_inf();
  for (int s = 0; s < p.splits; ++s)
    if (part[s * kPartFloats + kHd + 1] > 0.f)
      mx = fmaxf(mx, part[s * kPartFloats + kHd]);
  float o = 0.f, l = 0.f;
  for (int s = 0; s < p.splits; ++s) {
    const float* ps = part + s * kPartFloats;
    const float ls = ps[kHd + 1];
    if (ls > 0.f) {
      const float w = exp2f(ps[kHd] - mx);
      o += w * ps[c];
      l += w * ls;
    }
  }
  const int lq = f / p.G, h = g * p.G + f % p.G;
  p.out[(static_cast<long long>(b) * p.L + lq) * p.H * kHd
        + static_cast<long long>(h) * kHd + c] =
      __float2bfloat16(l > 0.f ? o / l : 0.f);
}

template <int kMode, int kCache>
int launch(const Params& p, cudaStream_t stream) {
  // set once per instantiation: no runtime call beyond the launches runs
  // while a decode step is captured into a CUDA graph
  constexpr size_t smem = smem_bytes<kCache>();
  static const cudaError_t attr = cudaFuncSetAttribute(
      attention_hd256_kernel<kMode, kCache>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (attr != cudaSuccess) return static_cast<int>(attr);
  dim3 grid(p.row_tiles, p.splits, p.B * p.KV);
  attention_hd256_kernel<kMode, kCache><<<grid, kThreads, smem, stream>>>(p);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || p.splits == 1) return static_cast<int>(err);
  attention_hd256_merge<<<dim3(p.L * p.G, p.B * p.KV), kHd, 0, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

// a quantized form's launch: bits 8 (int8) or 4 (packed int4)
template <int kMode>
int launch_quant(const Params& p, int bits, cudaStream_t stream) {
  if (p.ks == nullptr || p.vs == nullptr || (bits != 8 && bits != 4))
    return static_cast<int>(cudaErrorInvalidValue);
  return bits == 8 ? launch<kMode, kInt8>(p, stream)
                   : launch<kMode, kInt4>(p, stream);
}

// the fields every form sets; false where the shapes or the split are
// invalid
bool common_params(Params& p, const void* q, const void* k, const void* v,
                   const void* lens, void* out, void* ws, int B, int L,
                   int S, int H, int KV, int splits, int split_keys,
                   float sm_scale) {
  if (KV <= 0 || H % KV != 0 || B <= 0 || L <= 0 || S <= 0 || splits <= 0
      || split_keys % kKeys != 0 || (splits > 1 && ws == nullptr))
    return false;
  p = Params{};
  p.q = static_cast<const bf16*>(q);
  p.k = k;
  p.v = v;
  p.lens = static_cast<const int*>(lens);
  p.out = static_cast<bf16*>(out);
  p.ws = static_cast<float*>(ws);
  p.B = B;
  p.L = L;
  p.S = S;
  p.H = H;
  p.KV = KV;
  p.G = H / KV;
  p.row_tiles = (L * p.G + kRows - 1) / kRows;
  p.splits = splits;
  p.split_keys = split_keys;
  p.scale_log2 = sm_scale * 1.4426950408889634f;
  return true;
}

// the dense forms' fields; false where invalid (mode 0 prefill, 1 folded,
// 2 decode; folded needs q_off)
bool dense_params(Params& p, const void* q, const void* k, const void* v,
                  const void* lens, const void* q_off, void* out, void* ws,
                  int mode, int B, int L, int S, int H, int KV, int splits,
                  int split_keys, float sm_scale) {
  if (!common_params(p, q, k, v, lens, out, ws, B, L, S, H, KV, splits,
                     split_keys, sm_scale)
      || (mode == kFolded && q_off == nullptr) || mode < 0 || mode > 2)
    return false;
  p.q_off = static_cast<const int*>(q_off);
  return true;
}

// the paged form's fields over ``layer`` of stacked pools whose rows are
// row_bytes wide; false where invalid
bool paged_params(Params& p, const void* q, const void* k_pages,
                  const void* v_pages, const void* table, const void* kv_len,
                  void* out, void* ws, int layer, int B, int P, int page,
                  int maxp, int H, int KV, int splits, int split_keys,
                  float sm_scale, long long row_bytes) {
  if (layer < 0 || P <= 0 || page <= 0 || maxp <= 0 || table == nullptr)
    return false;
  const long long layer_bytes = static_cast<long long>(layer) * P * page
      * row_bytes;
  if (!common_params(p, q, static_cast<const u8*>(k_pages) + layer_bytes,
                     static_cast<const u8*>(v_pages) + layer_bytes, kv_len,
                     out, ws, B, 1, maxp * page, H, KV, splits, split_keys,
                     sm_scale))
    return false;
  p.table = static_cast<const int*>(table);
  p.page = page;
  p.maxp = maxp;
  return true;
}

// the shared-prefix form's fields; false where invalid
bool shared_prefix_params(Params& p, const void* q, const void* pk,
                          const void* pv, const void* sk, const void* sv,
                          const void* suffix_lens, void* out, void* ws,
                          int B, int L, int P, int H, int KV, int splits,
                          int split_keys, float sm_scale) {
  const int Pp = (P + kKeys - 1) / kKeys * kKeys;
  if (P < 0 || sk == nullptr || sv == nullptr
      || !common_params(p, q, pk, pv, suffix_lens, out, ws, B, L, Pp + L, H,
                        KV, splits, split_keys, sm_scale))
    return false;
  p.suf_k = static_cast<const bf16*>(sk);
  p.suf_v = static_cast<const bf16*>(sv);
  p.P = P;
  p.Pp = Pp;
  return true;
}

}  // namespace

// mode 0 prefill, 1 folded, 2 decode. q (B, L, H, 256), k / v (B, S, KV,
// 256) rows (the caller points at a cache layer), lens (B,) int32, q_off
// (B,) int32 (folded only), out (B, L, H, 256); ws holds B * KV * L * G *
// splits * 258 floats when splits > 1. split_keys is a multiple of 64.
extern "C" int v3d_attention_hd256(const void* q, const void* k,
                                   const void* v, const void* lens,
                                   const void* q_off, void* out, void* ws,
                                   int mode, int B, int L, int S, int H,
                                   int KV, int splits, int split_keys,
                                   float sm_scale, void* stream) {
  Params p;
  if (!dense_params(p, q, k, v, lens, q_off, out, ws, mode, B, L, S, H, KV,
                    splits, split_keys, sm_scale))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (mode == kPrefill) return launch<kPrefill, kBf16>(p, st);
  if (mode == kFolded) return launch<kFolded, kBf16>(p, st);
  return launch<kDecode, kBf16>(p, st);
}

// The folded (mode 1) and decode (mode 2) forms over a quantized cache
// layer: k / v (B, S, KV * 256) int8 rows (bits 8) or (B, S, KV * 128)
// packed int4 bytes (bits 4), k_scale / v_scale the layer's (B, S, KV, 1)
// f32 scales; the rest as v3d_attention_hd256.
extern "C" int v3d_attention_hd256_quant(
    const void* q, const void* k, const void* v, const void* k_scale,
    const void* v_scale, const void* lens, const void* q_off, void* out,
    void* ws, int mode, int bits, int B, int L, int S, int H, int KV,
    int splits, int split_keys, float sm_scale, void* stream) {
  Params p;
  if (mode == kPrefill
      || !dense_params(p, q, k, v, lens, q_off, out, ws, mode, B, L, S, H,
                       KV, splits, split_keys, sm_scale))
    return static_cast<int>(cudaErrorInvalidValue);
  p.ks = static_cast<const float*>(k_scale);
  p.vs = static_cast<const float*>(v_scale);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (mode == kFolded) return launch_quant<kFolded>(p, bits, st);
  return launch_quant<kDecode>(p, bits, st);
}

// B7 at hd 256: q (B, 1, H, 256), the stacked (layers, P, page, KV*256)
// pools (layer read by strides), table (B, maxp) int32, kv_len (B,) int32
// (positions after this step's append), out (B, 1, H, 256); the key axis
// is maxp * page positions; ws as above.
extern "C" int v3d_attention_hd256_paged(const void* q, const void* k_pages,
                                         const void* v_pages,
                                         const void* table,
                                         const void* kv_len, void* out,
                                         void* ws, int layer, int B, int P,
                                         int page, int maxp, int H, int KV,
                                         int splits, int split_keys,
                                         float sm_scale, void* stream) {
  Params p;
  if (!paged_params(p, q, k_pages, v_pages, table, kv_len, out, ws, layer, B,
                    P, page, maxp, H, KV, splits, split_keys, sm_scale,
                    static_cast<long long>(KV) * kHd * sizeof(bf16)))
    return static_cast<int>(cudaErrorInvalidValue);
  return launch<kPaged, kBf16>(p, static_cast<cudaStream_t>(stream));
}

// B7 at hd 256 over quantized pools: (layers, P, page, KV * 256) int8
// (bits 8) or (layers, P, page, KV * 128) packed int4 (bits 4), with the
// stacked (layers, P, KV, 1, page) f32 scales; the rest as
// v3d_attention_hd256_paged.
extern "C" int v3d_attention_hd256_paged_quant(
    const void* q, const void* k_pages, const void* v_pages,
    const void* k_scale, const void* v_scale, const void* table,
    const void* kv_len, void* out, void* ws, int bits, int layer, int B,
    int P, int page, int maxp, int H, int KV, int splits, int split_keys,
    float sm_scale, void* stream) {
  Params p;
  if (!paged_params(p, q, k_pages, v_pages, table, kv_len, out, ws, layer, B,
                    P, page, maxp, H, KV, splits, split_keys, sm_scale,
                    static_cast<long long>(KV) * kHd * bits / 8)
      || k_scale == nullptr || v_scale == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long layer_scales = static_cast<long long>(layer) * P * KV
      * page;
  p.ks = static_cast<const float*>(k_scale) + layer_scales;
  p.vs = static_cast<const float*>(v_scale) + layer_scales;
  return launch_quant<kPaged>(p, bits, static_cast<cudaStream_t>(stream));
}

// B5 at hd 256: q (B, L, H, 256), query r of row b at position P + r; pk /
// pv the (P, KV*256) prefix, sk / sv the (B, L, KV*256) suffix,
// suffix_lens (B,) int32, out (B, L, H, 256); the key axis is the prefix
// padded to whole 64-key tiles, then the L suffix keys; ws as above.
extern "C" int v3d_attention_hd256_shared_prefix(
    const void* q, const void* pk, const void* pv, const void* sk,
    const void* sv, const void* suffix_lens, void* out, void* ws, int B,
    int L, int P, int H, int KV, int splits, int split_keys, float sm_scale,
    void* stream) {
  Params p;
  if (!shared_prefix_params(p, q, pk, pv, sk, sv, suffix_lens, out, ws, B, L,
                            P, H, KV, splits, split_keys, sm_scale))
    return static_cast<int>(cudaErrorInvalidValue);
  return launch<kSharedPrefix, kBf16>(p, static_cast<cudaStream_t>(stream));
}

// B5 at hd 256 over a quantized prefix: pk / pv (P, KV * 256) int8 (bits
// 8) or (P, KV * 128) packed int4 (bits 4) with (P, KV, 1) f32 scales
// pk_scale / pv_scale; the suffix stays bf16; the rest as
// v3d_attention_hd256_shared_prefix.
extern "C" int v3d_attention_hd256_shared_prefix_quant(
    const void* q, const void* pk, const void* pv, const void* pk_scale,
    const void* pv_scale, const void* sk, const void* sv,
    const void* suffix_lens, void* out, void* ws, int bits, int B, int L,
    int P, int H, int KV, int splits, int split_keys, float sm_scale,
    void* stream) {
  Params p;
  if (!shared_prefix_params(p, q, pk, pv, sk, sv, suffix_lens, out, ws, B, L,
                            P, H, KV, splits, split_keys, sm_scale))
    return static_cast<int>(cudaErrorInvalidValue);
  p.ks = static_cast<const float*>(pk_scale);
  p.vs = static_cast<const float*>(pv_scale);
  return launch_quant<kSharedPrefix>(p, bits,
                                     static_cast<cudaStream_t>(stream));
}
