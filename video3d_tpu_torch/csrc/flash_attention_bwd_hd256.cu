// Flash attention backward at head width 256 (Gemma; kernel B6): dQ, dK
// and dV of the prefill / training form of B2 (L == S, query offset 0,
// causal or not, keys masked at lengths[b]), bf16 in and out, in two
// kernels.
//
// Replaces, at hd 256: video3d_tpu/kernels/flash_attention.py::_dq_kernel
// (:181, call :352) and ::_dkv_kernel (:216, call :376), the custom VJP
// _flash_core_bwd (:332-408), which the JAX wrapper runs for any hd % 128
// == 0 (:478-486). The recurrences (:7-11, _bwd_common :150-178), with
// lse the forward's per-row logsumexp (attention_hd256.cu, kLse) and
// delta_i = dO_i . O_i computed outside, as JAX does (:341):
//     P  = exp(sm_scale Q K^T - lse)      (0 where the mask forbids)
//     dV = P^T dO,  dS = P * (dO V^T - delta) * sm_scale
//     dQ = dS K,    dK = dS^T Q
// key s is allowed for query row r when s < lengths[b] and, causal,
// s <= r. The hd-128 form (flash_attention_bwd.cu) keeps its dK / dV
// accumulators in registers, 128 of 200 per thread at 128 channels; at
// 256 they would not fit beside the products, so this form splits the
// work as the TPU does.
//
// What bounds it on an H100: compute. At B=1, L=8192, length 6780, 8
// heads (Gemma-2B), 32.56 M causal pairs per head make 5 products (S, dP,
// dV, dK, dQ) of 2 * 256 FLOP per pair: 0.67 TFLOP per layer against
// ~0.06 GB of q/k/v/o/dO/dq/dk/dv traffic, far above the card's ~295
// FLOP/byte ridge. This form recomputes S and dP in both kernels (7
// products per pair, as the TPU's two kernels do).
//
// Design (a first, simple form; a fused wgmma / TMA design is later
// work): two kernels of 8 warps, tiles of 64 rows, WMMA bf16 16x16x16
// products with f32 sums, and no atomics, so every gradient is
// bit-reproducible run to run.
//   * dQ: one CTA per (64 query rows, head, batch row), longest causal
//     walks first. Q, dO, the rows' lse * log2(e) and delta stay in
//     shared memory; the CTA walks the 64-key tiles up to its causal end
//     and the length: S = Q K^T and dP = dO V^T into f32 tiles, then
//     P = exp2(S sm_scale log2(e) - lse log2(e)) and dS = P (dP - delta)
//     sm_scale in f32, dS rounded to bf16 for dQ += dS K, whose 64 x 256
//     f32 sum lives in WMMA fragments (64 registers a thread) and is
//     rounded to bf16 once.
//   * dK / dV: one CTA per (64 keys, kv head, batch row); K and V stay in
//     shared memory; the CTA walks the group's G query heads and each
//     head's 64-row query tiles from the causal start (its own key tile)
//     to L: S^T = K Q^T and dP^T = V dO^T, P^T and dS^T as above, each
//     rounded to bf16 for dV += P^T dO and dK += dS^T Q. Both 64 x 256 f32
//     sums live in fragments (128 registers a thread) over the whole
//     group, so the group's sum is taken in f32 and rounded to bf16 once.
//     Key tiles at or past the length walk nothing and write zeros, as in
//     the JAX kernel.
// Tiles load by 16-byte loads (rows past L read as zeros); about 189 KiB
// of shared memory a CTA, one CTA per SM.
#include <mma.h>

#include "common.cuh"

namespace {

using namespace nvcuda;
typedef __nv_bfloat16 bf16;
typedef wmma::fragment<wmma::accumulator, 16, 16, 16, float> Acc;

constexpr int kHd = 256;
constexpr int kTile = 64;         // rows of every tile: queries or keys
constexpr int kThreads = 256;     // 8 warps
constexpr int kLdh = kHd + 8;     // bf16 row pitch of Q / dO / K / V tiles
constexpr int kLds = kTile + 4;   // f32 row pitch of the score tiles
constexpr int kLdp = kTile + 8;   // bf16 row pitch of the P / dS tiles
constexpr int kLdo = kHd + 4;     // f32 row pitch of the output staging
constexpr size_t kTileBytes = sizeof(bf16) * kTile * kLdh;
constexpr size_t kSmemBytes =
    4 * kTileBytes                        // two resident, two walked tiles
    + 2 * sizeof(float) * kTile * kLds    // S and dP (or their transposes)
    + 2 * sizeof(bf16) * kTile * kLdp     // P and dS, bf16
    + 2 * sizeof(float) * kTile;          // lse * log2(e) and delta
static_assert(sizeof(float) * kTile * kLdo <= 2 * kTileBytes,
              "the f32 output staging fits in two tiles");
constexpr float kLog2e = 1.4426950408889634f;

struct Params {
  const bf16* q;       // (B, L, H, 256)
  const bf16* k;       // (B, L, KV, 256)
  const bf16* v;
  const bf16* dout;    // (B, L, H, 256)
  const float* rows;   // (B, H, 2, Lr): lse * log2(e), then delta
  const int* lens;     // (B,) keys valid below lens[b]
  bf16* dq;            // (B, L, H, 256)
  bf16* dk;            // (B, L, KV, 256)
  bf16* dv;
  int L, H, KV, G, Lr, causal;
  float scale, scale_log2;
};

struct Smem {
  bf16* a;        // resident tile: Q (dQ) or K (dK / dV)
  bf16* b;        // resident tile: dO (dQ) or V (dK / dV)
  bf16* c;        // walked tile: K (dQ) or Q (dK / dV)
  bf16* d;        // walked tile: V (dQ) or dO (dK / dV)
  float* s;       // S (or S^T), f32
  float* dp;      // dP (or dP^T), f32
  bf16* p;        // P^T, bf16 (dK / dV)
  bf16* ds;       // dS (or dS^T), bf16
  float* lse2;    // the query rows' lse * log2(e)
  float* delta;   // the query rows' delta
};

__device__ __forceinline__ Smem carve(unsigned char* raw) {
  Smem m;
  m.a = reinterpret_cast<bf16*>(raw);
  m.b = m.a + kTile * kLdh;
  m.c = m.b + kTile * kLdh;
  m.d = m.c + kTile * kLdh;
  m.s = reinterpret_cast<float*>(m.d + kTile * kLdh);
  m.dp = m.s + kTile * kLds;
  m.p = reinterpret_cast<bf16*>(m.dp + kTile * kLds);
  m.ds = m.p + kTile * kLdp;
  m.lse2 = reinterpret_cast<float*>(m.ds + kTile * kLdp);
  m.delta = m.lse2 + kTile;
  return m;
}

// rows r < n of a (., 256) bf16 matrix whose row r starts at src + r *
// stride into a pitched 64-row tile; rows past n are zero-filled
__device__ __forceinline__ void load_tile(bf16* dst, const bf16* src,
                                          long long stride, int n) {
  // 64 rows x 32 16-byte chunks = 2048 chunks, 8 per thread
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int c = threadIdx.x + i * kThreads;
    const int r = c >> 5, col = (c & 31) * 8;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (r < n)
      val = *reinterpret_cast<const uint4*>(src + r * stride + col);
    *reinterpret_cast<uint4*>(dst + r * kLdh + col) = val;
  }
}

// the 64 query rows' lse * log2(e) and delta (zero past L)
__device__ __forceinline__ void load_rows(const Params& p, const Smem& m,
                                          int b, int h, int q0) {
  const int t = threadIdx.x;
  if (t < 2 * kTile) {
    const int which = t / kTile, r = q0 + t % kTile;
    const float x = r < p.L
        ? p.rows[((static_cast<long long>(b) * p.H + h) * 2 + which) * p.Lr
                 + r]
        : 0.f;
    (which == 0 ? m.lse2 : m.delta)[t % kTile] = x;
  }
}

// dst (64 x 64 f32) = A B^T of two 64 x 256 bf16 tiles: 4 x 4 fragments,
// two per warp
__device__ __forceinline__ void product_abt(const bf16* a, const bf16* b,
                                            float* dst, int warp) {
  const int mi = warp >> 1, nj0 = (warp & 1) * 2;
  Acc acc[2];
  wmma::fill_fragment(acc[0], 0.f);
  wmma::fill_fragment(acc[1], 0.f);
#pragma unroll 4
  for (int kk = 0; kk < kHd; kk += 16) {
    wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa;
    wmma::load_matrix_sync(fa, a + mi * 16 * kLdh + kk, kLdh);
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> fb;
      wmma::load_matrix_sync(fb, b + (nj0 + j) * 16 * kLdh + kk, kLdh);
      wmma::mma_sync(acc[j], fa, fb, acc[j]);
    }
  }
#pragma unroll
  for (int j = 0; j < 2; ++j)
    wmma::store_matrix_sync(dst + mi * 16 * kLds + (nj0 + j) * 16, acc[j],
                            kLds, wmma::mem_row_major);
}

// acc (this warp's 16 rows x 128 columns of a 64 x 256 sum) += A X: A the
// 64 x 64 bf16 tile (pitch kLdp), X a 64 x 256 bf16 tile
__device__ __forceinline__ void product_acc(Acc (&acc)[8], const bf16* a,
                                            const bf16* x, int warp) {
  const int mi = warp >> 1, n0 = (warp & 1) * 8;
#pragma unroll
  for (int kk = 0; kk < kTile; kk += 16) {
    wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa;
    wmma::load_matrix_sync(fa, a + mi * 16 * kLdp + kk, kLdp);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> fb;
      wmma::load_matrix_sync(fb, x + kk * kLdh + (n0 + j) * 16, kLdh);
      wmma::mma_sync(acc[j], fa, fb, acc[j]);
    }
  }
}

__device__ __forceinline__ unsigned bf16x2(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const unsigned*>(&h);
}

// rows r < n of the 64 x 256 sum in ``acc`` rounded to bf16 into dst + r *
// stride, through the f32 staging tile
__device__ __forceinline__ void write_rows(Acc (&acc)[8], float* stage,
                                           bf16* dst, long long stride,
                                           int n, int warp) {
  const int mi = warp >> 1, n0 = (warp & 1) * 8;
#pragma unroll
  for (int j = 0; j < 8; ++j)
    wmma::store_matrix_sync(stage + mi * 16 * kLdo + (n0 + j) * 16, acc[j],
                            kLdo, wmma::mem_row_major);
  __syncthreads();
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int c = threadIdx.x + i * kThreads;
    const int r = c >> 5, col = (c & 31) * 8;
    if (r < n) {
      const float* f = stage + r * kLdo + col;
      *reinterpret_cast<uint4*>(dst + r * stride + col) =
          make_uint4(bf16x2(f[0], f[1]), bf16x2(f[2], f[3]),
                     bf16x2(f[4], f[5]), bf16x2(f[6], f[7]));
    }
  }
  __syncthreads();
}

__device__ __forceinline__ bool allowed(const Params& p, int s, int r,
                                        int len) {
  return r < p.L && s < len && (p.causal == 0 || s <= r);
}

// dQ of 64 query rows of one head
__global__ void __launch_bounds__(kThreads, 1)
bwd_dq_kernel(const Params p) {
  extern __shared__ __align__(128) unsigned char smem[];
  const Smem m = carve(smem);
  const int n_tiles = (p.L + kTile - 1) / kTile;
  const int q0 = (n_tiles - 1 - static_cast<int>(blockIdx.x)) * kTile;
  const int h = blockIdx.y, b = blockIdx.z, g = h / p.G;
  const int tid = threadIdx.x, warp = tid >> 5;
  const int len = min(max(p.lens[b], 0), p.L);
  const int k_end = p.causal != 0 ? min(len, q0 + kTile) : len;
  const long long q_stride = static_cast<long long>(p.H) * kHd;
  const long long kv_stride = static_cast<long long>(p.KV) * kHd;
  const long long q_at = (static_cast<long long>(b) * p.L + q0) * q_stride
      + static_cast<long long>(h) * kHd;
  const long long kv_base = static_cast<long long>(b) * p.L * kv_stride
      + static_cast<long long>(g) * kHd;

  load_tile(m.a, p.q + q_at, q_stride, p.L - q0);
  load_tile(m.b, p.dout + q_at, q_stride, p.L - q0);
  load_rows(p, m, b, h, q0);
  Acc acc[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) wmma::fill_fragment(acc[j], 0.f);

  // the dS element phase: row tid / 4, 16 keys from (tid % 4) * 16
  const int er = tid >> 2, ec = (tid & 3) * 16;
  for (int kt = 0; kt < k_end; kt += kTile) {
    __syncthreads();   // the previous K tile and dS are consumed
    const long long at = kv_base + static_cast<long long>(kt) * kv_stride;
    load_tile(m.c, p.k + at, kv_stride, p.L - kt);
    load_tile(m.d, p.v + at, kv_stride, p.L - kt);
    __syncthreads();
    product_abt(m.a, m.c, m.s, warp);    // S = Q K^T
    product_abt(m.b, m.d, m.dp, warp);   // dP = dO V^T
    __syncthreads();
    {
      const int r = q0 + er;
      const float lse2 = m.lse2[er], delta = m.delta[er];
#pragma unroll
      for (int c = 0; c < 16; ++c) {
        const int col = ec + c;
        const float pv = allowed(p, kt + col, r, len)
            ? exp2f(m.s[er * kLds + col] * p.scale_log2 - lse2) : 0.f;
        m.ds[er * kLdp + col] = __float2bfloat16(
            pv * (m.dp[er * kLds + col] - delta) * p.scale);
      }
    }
    __syncthreads();
    product_acc(acc, m.ds, m.c, warp);   // dQ += dS K
  }
  __syncthreads();
  write_rows(acc, reinterpret_cast<float*>(m.c), p.dq + q_at, q_stride,
             min(kTile, p.L - q0), warp);
}

// dK and dV of 64 keys of one kv head, summed over its group of query
// heads
__global__ void __launch_bounds__(kThreads, 1)
bwd_dkv_kernel(const Params p) {
  extern __shared__ __align__(128) unsigned char smem[];
  const Smem m = carve(smem);
  const int k0 = blockIdx.x * kTile;
  const int g = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, warp = tid >> 5;
  const int len = min(max(p.lens[b], 0), p.L);
  const long long q_stride = static_cast<long long>(p.H) * kHd;
  const long long kv_stride = static_cast<long long>(p.KV) * kHd;
  const long long kv_at = (static_cast<long long>(b) * p.L + k0) * kv_stride
      + static_cast<long long>(g) * kHd;

  load_tile(m.a, p.k + kv_at, kv_stride, p.L - k0);
  load_tile(m.b, p.v + kv_at, kv_stride, p.L - k0);
  Acc dk[8], dv[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    wmma::fill_fragment(dk[j], 0.f);
    wmma::fill_fragment(dv[j], 0.f);
  }

  // the P^T / dS^T element phase: key row tid / 4, 16 query columns from
  // (tid % 4) * 16
  const int er = tid >> 2, ec = (tid & 3) * 16;
  const int q_start = k0 < len ? (p.causal != 0 ? k0 : 0) : p.L;
  for (int hh = 0; hh < p.G; ++hh) {
    const int h = g * p.G + hh;
    for (int q0 = q_start; q0 < p.L; q0 += kTile) {
      __syncthreads();   // the previous Q / dO tiles, P^T and dS^T are
                         // consumed
      const long long at = (static_cast<long long>(b) * p.L + q0) * q_stride
          + static_cast<long long>(h) * kHd;
      load_tile(m.c, p.q + at, q_stride, p.L - q0);
      load_tile(m.d, p.dout + at, q_stride, p.L - q0);
      load_rows(p, m, b, h, q0);
      __syncthreads();
      product_abt(m.a, m.c, m.s, warp);    // S^T = K Q^T
      product_abt(m.b, m.d, m.dp, warp);   // dP^T = V dO^T
      __syncthreads();
#pragma unroll
      for (int c = 0; c < 16; ++c) {
        const int col = ec + c;
        const float pv = allowed(p, k0 + er, q0 + col, len)
            ? exp2f(m.s[er * kLds + col] * p.scale_log2 - m.lse2[col])
            : 0.f;
        m.p[er * kLdp + col] = __float2bfloat16(pv);
        m.ds[er * kLdp + col] = __float2bfloat16(
            pv * (m.dp[er * kLds + col] - m.delta[col]) * p.scale);
      }
      __syncthreads();
      product_acc(dv, m.p, m.d, warp);     // dV += P^T dO
      product_acc(dk, m.ds, m.c, warp);    // dK += dS^T Q
    }
  }
  __syncthreads();
  const int n = min(kTile, p.L - k0);
  float* stage = reinterpret_cast<float*>(m.c);
  write_rows(dk, stage, p.dk + kv_at, kv_stride, n, warp);
  write_rows(dv, stage, p.dv + kv_at, kv_stride, n, warp);
}

}  // namespace

// q (B, L, H, 256), k / v (B, S, KV, 256) with S == L, dout (B, L, H,
// 256), all bf16; rows (B, H, 2, L rounded up to 4) f32: lse * log2(e),
// then delta; lengths (B,) int32; dq (B, L, H, 256), dk / dv (B, S, KV,
// 256) bf16, every element written. Two launches on ``stream``: dQ, then
// dK / dV.
extern "C" int v3d_flash_attention_bwd_hd256(
    const void* q, const void* k, const void* v, const void* dout,
    const void* rows, const void* lengths, void* dq, void* dk, void* dv,
    int B, int L, int S, int H, int KV, int causal, float sm_scale,
    void* stream) {
  if (B <= 0 || L <= 0 || S != L || KV <= 0 || H % KV != 0 || B > 65535
      || H > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  static const cudaError_t attr_dq = cudaFuncSetAttribute(
      bwd_dq_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(kSmemBytes));
  static const cudaError_t attr_dkv = cudaFuncSetAttribute(
      bwd_dkv_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(kSmemBytes));
  if (attr_dq != cudaSuccess) return static_cast<int>(attr_dq);
  if (attr_dkv != cudaSuccess) return static_cast<int>(attr_dkv);
  Params p;
  p.q = static_cast<const bf16*>(q);
  p.k = static_cast<const bf16*>(k);
  p.v = static_cast<const bf16*>(v);
  p.dout = static_cast<const bf16*>(dout);
  p.rows = static_cast<const float*>(rows);
  p.lens = static_cast<const int*>(lengths);
  p.dq = static_cast<bf16*>(dq);
  p.dk = static_cast<bf16*>(dk);
  p.dv = static_cast<bf16*>(dv);
  p.L = L;
  p.H = H;
  p.KV = KV;
  p.G = H / KV;
  p.Lr = (L + 3) / 4 * 4;
  p.causal = causal;
  p.scale = sm_scale;
  p.scale_log2 = sm_scale * kLog2e;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int tiles = (L + kTile - 1) / kTile;
  bwd_dq_kernel<<<dim3(tiles, H, B), kThreads, kSmemBytes, st>>>(p);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  bwd_dkv_kernel<<<dim3(tiles, KV, B), kThreads, kSmemBytes, st>>>(p);
  return static_cast<int>(cudaGetLastError());
}
