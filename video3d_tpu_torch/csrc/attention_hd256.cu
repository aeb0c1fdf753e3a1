// Attention at head width 256 (Gemma) in B2's GQA-folded form, over a
// bf16, an int8 or a packed int4 cache: the engine's suffix prefill over a
// cached prefix. B2's prefill form and its training form with the
// logsumexp are flash_attention_hd256.cu; B3 and B7 at hd 256 are the
// hd-128 decode template's hd-256 instantiations (decode_sm90.cuh,
// decode_attention.cu, paged_attention.cu); B5 at hd 256 is
// shared_prefix_hd256.cu.
//
// Replaces, at hd 256: video3d_tpu/kernels/flash_attention.py::_fwd_kernel
// with pos_div = group (:66; entry flash_attention_gqa_folded, :760): a
// suffix chunk whose rows sit at q_offsets[b] + r over one layer of the
// stacked (layers, B, S, KV*hd) cache. JAX sends any hd % 128 == 0 to that
// Pallas kernel, over a bf16 cache and over an int8 or int4 one with f32
// scales per (position, kv head) (attention.py:181, :195;
// flash_attention.py:813-815); the port's hd-128 kernels are compiled for
// 128 only, so hd 256 has this kernel of its own.
//
// What bounds it on an H100: a product of 4 * rows * keys * 256 FLOP
// (causal: about half the rectangle), far above the card's ~295 FLOP/byte
// ridge at prefill lengths, so the tensor cores bound it.
//
// Design (a first, simple form; a wgmma / TMA design is later work): rows
// addressed by stride. A quantized cache (kCache)
// changes only where a tile's K and V come from: an int8 row is 256 bytes,
// a packed int4 row 128 (channel 2j in byte j's low nibble, 2j + 1 in its
// high, two's complement); each row is converted to bf16 into the same
// tiles (exact: |x| <= 127), and the tile's 64 key and 64 value scales go
// to shared memory beside it. They apply as in the TPU kernel
// (decode_attention.py:105-117): the key scale (times sm_scale) on the
// score column, l summed over the unscaled p, the value scale on p before
// its bf16 rounding. The bf16 instantiations compile as they did before
// the quantized ones existed.
// A CTA of 8 warps takes 64 folded query rows (row f of a kv head is query
// position f / G of query head g * G + f % G, so the G <= 8 query heads of
// a kv head share its K/V tiles) and walks a range of 64-key tiles. Q, the
// K and V tiles, the f32 score tile, the bf16 probability tile and the f32
// output accumulator all live in shared memory (192 KiB, one CTA per SM);
// the products run on the tensor cores through WMMA bf16 16x16x16
// fragments with f32 sums; the online softmax runs in f32, four threads
// per row. Where the row tiles
// alone do not fill the card, the keys split over CTAs (the plan is the
// host's, from the shapes alone: the lengths and offsets stay on the
// device) and each split writes its unnormalised
// output with its row max and sum into an f32 workspace that a second
// kernel merges, row by row. A split whose keys all lie past its rows'
// limits writes an empty partial, so a launch with fewer live positions
// than CTAs merges right. The retired forms' parts of the layout (the
// key-row table in shared memory, the by-value parameters they set) stay,
// so that this form's code, and its SASS, stays as it was.
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

enum Mode { kFolded = 1 };
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

// The kernel's by-value parameters. suf_k, suf_v, table, page, maxp, P
// and Pp served the retired shared-prefix and paged forms and are never
// set: they keep the layout, and with it this form's code, as it was.
struct Params {
  const bf16* q;      // (B, L, H, 256)
  const void* k;      // (B, S, KV, 256): a cache layer (a quantized cache:
                      // int8, or int4 rows of KV*128 bytes)
  const void* v;
  const bf16* suf_k;
  const bf16* suf_v;
  const int* lens;    // (B,) keys valid below lens[b]
  const int* q_off;   // (B,) position of query row 0
  const int* table;
  bf16* out;          // (B, L, H, 256)
  float* ws;          // split partials (splits > 1)
  int B, L, S, H, KV, G, row_tiles, splits, split_keys;
  int page, maxp;
  int P, Pp;
  float scale_log2;   // sm_scale * log2(e)
  // a quantized cache's f32 scales of K and V: the layer's (B, S, KV, 1)
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
  // the retired paged form's K and V row of each key (unused)
  const E** s_kr = reinterpret_cast<const E**>(s_lim + kRows);
  const E** s_vr = s_kr + kKeys;
  // a quantized tile's key scales (times scale_log2) and value scales
  float* s_ks = reinterpret_cast<float*>(s_vr + kKeys);
  float* s_vs = s_ks + kKeys;

  const int tile = blockIdx.x, split = blockIdx.y;
  const int bkv = blockIdx.z, b = bkv / p.KV, g = bkv % p.KV;
  const int rows_total = p.L * p.G;
  const int f0 = tile * kRows;
  const int tid = threadIdx.x, warp = tid >> 5;

  // each row's position and key limit; the tile's key range
  const int lim_b = min(max(p.lens[b], 0), p.S);
  const int pos0 = p.q_off[b];
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

  // row 0 of kv head g of batch row b's keys. The offsets count channels,
  // a quantized row's elements are bytes.
  const long long kv_row = static_cast<long long>(p.KV) * kHd;
  const long long base = static_cast<long long>(g) * kHd
      + static_cast<long long>(b) * p.S * kv_row;
  const E* kb = static_cast<const E*>(p.k) + base / kPer;
  const E* vb = static_cast<const E*>(p.v) + base / kPer;

  // the softmax's four threads of one row and its 16 columns
  const int srow = tid >> 2, sq4 = tid & 3;

  for (int kt = k_begin; kt < k_end; kt += kKeys) {
    __syncthreads();   // the previous tile's P, V, rows and scales are
                       // consumed
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
            && s < k_end;
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
  const dim3 merge_grid(p.L * p.G, p.B * p.KV);
  attention_hd256_merge<<<merge_grid, kHd, 0, stream>>>(p);
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

// the folded form's fields (mode 1, the only dense mode); false where
// invalid
bool dense_params(Params& p, const void* q, const void* k, const void* v,
                  const void* lens, const void* q_off, void* out, void* ws,
                  int mode, int B, int L, int S, int H, int KV, int splits,
                  int split_keys, float sm_scale) {
  if (!common_params(p, q, k, v, lens, out, ws, B, L, S, H, KV, splits,
                     split_keys, sm_scale)
      || q_off == nullptr || mode != kFolded)
    return false;
  p.q_off = static_cast<const int*>(q_off);
  return true;
}

}  // namespace

// mode 1, folded. q (B, L, H, 256), k / v (B, S, KV, 256) rows (the caller
// points at a cache layer), lens (B,) int32, q_off (B,) int32, out (B, L,
// H, 256); ws holds B * KV * L * G * splits * 258 floats when splits > 1.
// split_keys is a multiple of 64.
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
  return launch<kFolded, kBf16>(p, static_cast<cudaStream_t>(stream));
}

// The folded form (mode 1) over a quantized cache layer: k / v (B, S,
// KV * 256) int8 rows (bits 8) or (B, S, KV * 128) packed int4 bytes (bits
// 4), k_scale / v_scale the layer's (B, S, KV, 1) f32 scales; the rest as
// v3d_attention_hd256.
extern "C" int v3d_attention_hd256_quant(
    const void* q, const void* k, const void* v, const void* k_scale,
    const void* v_scale, const void* lens, const void* q_off, void* out,
    void* ws, int mode, int bits, int B, int L, int S, int H, int KV,
    int splits, int split_keys, float sm_scale, void* stream) {
  Params p;
  if (!dense_params(p, q, k, v, lens, q_off, out, ws, mode, B, L, S, H, KV,
                    splits, split_keys, sm_scale))
    return static_cast<int>(cudaErrorInvalidValue);
  p.ks = static_cast<const float*>(k_scale);
  p.vs = static_cast<const float*>(v_scale);
  return launch_quant<kFolded>(p, bits, static_cast<cudaStream_t>(stream));
}
