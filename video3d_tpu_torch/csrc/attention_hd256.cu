// Attention at head width 256 (Gemma), in the five forms of the engine's
// answer and serving paths: B2's prefill, B2 folded, B3, B7 and B5.
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
// JAX sends any hd % 128 == 0 to those Pallas kernels; the port's hd-128
// kernels are compiled for 128 only, so hd 256 has this kernel of its own.
//
// What bounds it on an H100: the prefill, folded and shared-prefix forms
// are products of 4 * rows * keys * 256 FLOP (causal: about half the
// rectangle), far above the card's ~295 FLOP/byte ridge at prefill
// lengths, so the tensor cores bound them; the decode and paged forms read
// 2 * kv_len * KV * 256 * 2 bytes of K and V for ~4 FLOP per byte, so HBM
// bounds them.
//
// Design (a first, simple form; a wgmma / TMA design is later work): one
// template for all five forms, which differ only in where a query row
// sits and where a key's row lies (kMode). In the paged and shared-prefix
// forms, 64 threads look up each 64-key tile's K and V row addresses into
// shared memory first: a page-table entry per key in the paged form, so
// any page size works; prefix or suffix in the shared-prefix form, whose
// key axis is the prefix padded to whole tiles, then the suffix. A null
// address is a key no row may attend, loaded as zeros and masked. The
// dense forms address their rows by stride, as before. A CTA of 8 warps takes 64 folded
// query rows (row f of a kv head is query position f / G of query head
// g * G + f % G, so the G <= 8 query heads of a kv head share its K/V
// tiles) and walks a range of 64-key tiles. Q, the K and V tiles, the f32
// score tile, the bf16 probability tile and the f32 output accumulator all
// live in shared memory (192 KiB, one CTA per SM); the products run on the
// tensor cores through WMMA bf16 16x16x16 fragments with f32 sums; the
// online softmax runs in f32, four threads per row. Where the row tiles
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

__device__ __forceinline__ float neg_inf() {
  return __int_as_float(0xff800000u);
}

struct Params {
  const bf16* q;      // (B, L, H, 256)
  const bf16* k;      // (B, S, KV, 256): a prefill's K or a cache layer;
                      // paged: one layer's (P, page, KV*256) pool;
                      // shared prefix: the (P, KV*256) prefix
  const bf16* v;
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

template <int kMode>
__global__ void __launch_bounds__(kThreads, 1)
attention_hd256_kernel(const Params p) {
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
  const bf16** s_kr = reinterpret_cast<const bf16**>(s_lim + kRows);
  const bf16** s_vr = s_kr + kKeys;

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
  // layer (paged), of the prefix (shared prefix); the suffix's row 0
  const long long kv_row = static_cast<long long>(p.KV) * kHd;
  const long long base = static_cast<long long>(g) * kHd
      + (kMode <= kDecode ? static_cast<long long>(b) * p.S * kv_row : 0);
  const bf16* kb = p.k + base;
  const bf16* vb = p.v + base;
  const long long suf = kMode == kSharedPrefix
      ? static_cast<long long>(b) * p.L * kv_row
          + static_cast<long long>(g) * kHd - static_cast<long long>(p.Pp)
          * kv_row
      : 0;

  // the softmax's four threads of one row and its 16 columns
  const int srow = tid >> 2, sq4 = tid & 3;

  for (int kt = k_begin; kt < k_end; kt += kKeys) {
    __syncthreads();   // the previous tile's P, V and rows are consumed
    if (kLookup) {
      if (tid < kKeys) {
        // key s's K and V rows, or null: past the range, or the padding
        // after the prefix
        const int s = kt + tid;
        const bf16 *kr = nullptr, *vr = nullptr;
        if (s < k_end) {
          if (kMode == kPaged) {
            const long long row = static_cast<long long>(
                p.table[static_cast<long long>(b) * p.maxp + s / p.page])
                * p.page + s % p.page;
            kr = kb + row * kv_row;
            vr = vb + row * kv_row;
          } else if (s < p.P) {
            kr = kb + static_cast<long long>(s) * kv_row;
            vr = vb + static_cast<long long>(s) * kv_row;
          } else if (s >= p.Pp) {
            kr = p.suf_k + (suf + static_cast<long long>(s) * kv_row);
            vr = p.suf_v + (suf + static_cast<long long>(s) * kv_row);
          }
        }
        s_kr[tid] = kr;
        s_vr[tid] = vr;
      }
      __syncthreads();
      load_tile(sk, [&](int r) { return s_kr[r]; });
      load_tile(sv, [&](int r) { return s_vr[r]; });
    } else {
      auto row = [&](const bf16* base_ptr, int r) -> const bf16* {
        const int s = kt + r;
        return s < k_end ? base_ptr + static_cast<long long>(s) * kv_row
                         : nullptr;
      };
      load_tile(sk, [&](int r) { return row(kb, r); });
      load_tile(sv, [&](int r) { return row(vb, r); });
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
        x[c] = ok ? ss[srow * kLds + col] * p.scale_log2 : neg_inf();
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
        sp[srow * kLdp + sq4 * 16 + c] = __float2bfloat16(e);
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

template <int kMode>
int launch(const Params& p, cudaStream_t stream) {
  // set once per instantiation: no runtime call beyond the launches runs
  // while a decode step is captured into a CUDA graph
  static const cudaError_t attr = cudaFuncSetAttribute(
      attention_hd256_kernel<kMode>,
      cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(kSmemBytes));
  if (attr != cudaSuccess) return static_cast<int>(attr);
  dim3 grid(p.row_tiles, p.splits, p.B * p.KV);
  attention_hd256_kernel<kMode><<<grid, kThreads, kSmemBytes, stream>>>(p);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || p.splits == 1) return static_cast<int>(err);
  attention_hd256_merge<<<dim3(p.L * p.G, p.B * p.KV), kHd, 0, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
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
  p.k = static_cast<const bf16*>(k);
  p.v = static_cast<const bf16*>(v);
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
  if (!common_params(p, q, k, v, lens, out, ws, B, L, S, H, KV, splits,
                     split_keys, sm_scale)
      || (mode == kFolded && q_off == nullptr) || mode < 0 || mode > 2)
    return static_cast<int>(cudaErrorInvalidValue);
  p.q_off = static_cast<const int*>(q_off);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (mode == kPrefill) return launch<kPrefill>(p, st);
  if (mode == kFolded) return launch<kFolded>(p, st);
  return launch<kDecode>(p, st);
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
  if (layer < 0 || P <= 0 || page <= 0 || maxp <= 0 || table == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long layer_elems = static_cast<long long>(layer) * P * page
      * KV * kHd;
  Params p;
  if (!common_params(p, q, static_cast<const bf16*>(k_pages) + layer_elems,
                     static_cast<const bf16*>(v_pages) + layer_elems, kv_len,
                     out, ws, B, 1, maxp * page, H, KV, splits, split_keys,
                     sm_scale))
    return static_cast<int>(cudaErrorInvalidValue);
  p.table = static_cast<const int*>(table);
  p.page = page;
  p.maxp = maxp;
  return launch<kPaged>(p, static_cast<cudaStream_t>(stream));
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
  const int Pp = (P + kKeys - 1) / kKeys * kKeys;
  Params p;
  if (P < 0 || sk == nullptr || sv == nullptr
      || !common_params(p, q, pk, pv, suffix_lens, out, ws, B, L, Pp + L, H,
                        KV, splits, split_keys, sm_scale))
    return static_cast<int>(cudaErrorInvalidValue);
  p.suf_k = static_cast<const bf16*>(sk);
  p.suf_v = static_cast<const bf16*>(sv);
  p.P = P;
  p.Pp = Pp;
  return launch<kSharedPrefix>(p, static_cast<cudaStream_t>(stream));
}
