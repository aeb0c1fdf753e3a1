// Attention at head width 256 (Gemma), in the three forms of the engine's
// answer path: B2's prefill, B2 folded and B3.
//
// Replaces, at hd 256:
//   * video3d_tpu/kernels/flash_attention.py::_fwd_kernel (call :283), the
//     prefill form: query row r attends keys s <= r and s < lengths[b];
//   * the same kernel with pos_div = group (:66; entry
//     flash_attention_gqa_folded, :760), the folded form: a suffix chunk
//     whose rows sit at q_offsets[b] + r over one layer of the stacked
//     (layers, B, S, KV*hd) cache;
//   * video3d_tpu/kernels/decode_attention.py::_decode_kernel_blockdiag
//     (call :243), the decode form: one token at kv_len[b] - 1.
// JAX sends any hd % 128 == 0 to those Pallas kernels; the port's hd-128
// kernels are compiled for 128 only, so hd 256 has this kernel of its own.
//
// What bounds it on an H100: the prefill and folded forms are products of
// 4 * rows * keys * 256 FLOP (causal: about half the rectangle), far above
// the card's ~295 FLOP/byte ridge at prefill lengths, so the tensor cores
// bound them; the decode form reads 2 * kv_len * KV * 256 * 2 bytes of K
// and V for ~4 FLOP per byte, so HBM bounds it.
//
// Design (a first, simple form; a wgmma / TMA design is later work): one
// template for all three forms, which differ only in where a query row
// sits (kMode). A CTA of 8 warps takes 64 folded query rows (row f of a kv
// head is query position f / G of query head g * G + f % G, so the G <= 8
// query heads of a kv head share its K/V tiles) and walks a range of
// 64-key tiles. Q, the K and V tiles, the f32 score tile, the bf16
// probability tile and the f32 output accumulator all live in shared
// memory (~191 KiB, one CTA per SM); the products run on the tensor cores
// through WMMA bf16 16x16x16 fragments with f32 sums; the online softmax
// runs in f32, four threads per row. Where the row tiles alone do not fill
// the card, the keys split over CTAs (the plan is the host's, from the
// shapes alone: kv_len stays on the device) and each split writes its
// unnormalised output with its row max and sum into an f32 workspace that
// a second kernel merges, row by row. A split whose keys all lie past its
// rows' limits writes an empty partial, so a launch with fewer live
// positions than CTAs merges right.
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
    + sizeof(int) * 2 * kRows;                 // position, limit per row

enum Mode { kPrefill = 0, kFolded = 1, kDecode = 2 };

__device__ __forceinline__ float neg_inf() {
  return __int_as_float(0xff800000u);
}

struct Params {
  const bf16* q;      // (B, L, H, 256)
  const bf16* k;      // (B, S, KV, 256): a prefill's K or a cache layer
  const bf16* v;
  const int* lens;    // (B,) keys valid below lens[b]
  const int* q_off;   // (B,) folded: position of query row 0
  bf16* out;          // (B, L, H, 256)
  float* ws;          // split partials (splits > 1)
  int B, L, S, H, KV, G, row_tiles, splits, split_keys;
  float scale_log2;   // sm_scale * log2(e)
};

// 64 rows of 256 bf16 (row i at src + row_off(i)) into a pitched tile;
// rows with row_off < 0 are zero-filled
template <typename RowOff>
__device__ __forceinline__ void load_tile(bf16* dst, const bf16* src,
                                          RowOff row_off) {
  // 64 rows x 32 16-byte chunks = 2048 chunks, 8 per thread
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int c = threadIdx.x + i * kThreads;
    const int r = c >> 5, col = (c & 31) * 8;
    const long long off = row_off(r);
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (off >= 0) val = *reinterpret_cast<const uint4*>(src + off + col);
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

  const int tile = blockIdx.x, split = blockIdx.y;
  const int bkv = blockIdx.z, b = bkv / p.KV, g = bkv % p.KV;
  const int rows_total = p.L * p.G;
  const int f0 = tile * kRows;
  const int tid = threadIdx.x, warp = tid >> 5;

  // each row's position and key limit; the tile's key range
  const int lim_b = min(max(p.lens[b], 0), p.S);
  int pos0 = 0;
  if (kMode == kFolded) pos0 = p.q_off[b];
  if (kMode == kDecode) pos0 = p.lens[b] - 1;
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
  load_tile(sq, p.q, [&](int r) -> long long {
    const int f = f0 + r;
    if (f >= rows_total) return -1;
    const int l = f / p.G, h = g * p.G + f % p.G;
    return (static_cast<long long>(b) * p.L + l) * q_row
        + static_cast<long long>(h) * kHd;
  });

  const long long kv_row = static_cast<long long>(p.KV) * kHd;
  const bf16* kb = p.k + static_cast<long long>(b) * p.S * kv_row
      + static_cast<long long>(g) * kHd;
  const bf16* vb = p.v + static_cast<long long>(b) * p.S * kv_row
      + static_cast<long long>(g) * kHd;

  // the softmax's four threads of one row and its 16 columns
  const int srow = tid >> 2, sq4 = tid & 3;

  for (int kt = k_begin; kt < k_end; kt += kKeys) {
    __syncthreads();   // the previous tile's P and V are consumed
    auto key_off = [&](int r) -> long long {
      const int s = kt + r;
      return s < k_end ? static_cast<long long>(s) * kv_row : -1;
    };
    load_tile(sk, kb, key_off);
    load_tile(sv, vb, key_off);
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
        const bool ok = pos >= 0 && s <= pos && s < lim && s < k_end;
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
  if (KV <= 0 || H % KV != 0 || L <= 0 || S <= 0 || splits <= 0
      || split_keys % kKeys != 0 || (splits > 1 && ws == nullptr)
      || (mode == kFolded && q_off == nullptr) || mode < 0 || mode > 2)
    return static_cast<int>(cudaErrorInvalidValue);
  Params p;
  p.q = static_cast<const bf16*>(q);
  p.k = static_cast<const bf16*>(k);
  p.v = static_cast<const bf16*>(v);
  p.lens = static_cast<const int*>(lens);
  p.q_off = static_cast<const int*>(q_off);
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
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (mode == kPrefill) return launch<kPrefill>(p, st);
  if (mode == kFolded) return launch<kFolded>(p, st);
  return launch<kDecode>(p, st);
}
