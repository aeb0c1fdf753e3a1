// Flash attention backward (kernel B6): dQ and dK/dV of the prefill /
// training form of B2 (L == S, query offset 0), bf16 in, bf16 out.
//
// Replaces: video3d_tpu/kernels/flash_attention.py::_dq_kernel (:181) and
// ::_dkv_kernel (:216), the custom VJP _flash_core_bwd (:332-408). The
// recurrences (:7-11, _bwd_common :150-178), with lse the per-row
// logsumexp of the forward (flash_attention.cu, kLse) and
// delta_i = dO_i . O_i computed outside, as JAX does (:341):
//     P  = exp(sm_scale Q K^T - lse)      (0 where the mask forbids)
//     dV = P^T dO,  dS = P * (dO V^T - delta) * sm_scale
//     dQ = dS K,    dK = dS^T Q
// masked as the forward: key s is allowed for query row r when s < length
// and, causal, s <= r. Only the tiles the causal rule and the key length
// admit are visited (:194-196, :231-233).
//
// What bounds it on an H100: compute. Per layer at B=1, L=8192 (6780
// valid keys), 28 heads, hd 128, causal, the two kernels do ~5 products of
// 2 * 64 * 64 * 128 FLOP per visited (64-query, 64-key) tile pair per
// head (dQ: S, dP, dS K; dK/dV: S, dP, P^T dO, dS^T Q, so 7 in all),
// against ~0.2 GB of q/k/v/o/dO/dq/dk/dv traffic: far above the card's
// ~295 FLOP/byte ridge.
//
// Design (tile machinery and constants from flash_tile.cuh; 128 threads,
// 4 warps of 16 rows, WMMA 16x16x16 bf16 fragments with f32 accumulation,
// P and dS rounded to bf16 for the tensor-core products, as B2 rounds P):
//   dQ: one block per (64-query tile, batch row, head). Q and dO tiles and
//   the rows' lse / delta are staged once; the block walks the key tiles up
//   to the causal bound and the key length, K and V staged once per tile
//   for all 64 rows; the f32 dQ accumulator lives in shared memory.
//   dK/dV: one block per (64-key tile, batch row, KV head). The GQA group
//   is folded into the block: it walks the group's H / KV query heads and,
//   for each, the query tiles from the key tile's own (causal) to L, so
//   dK and dV of the kv head are summed over the group in the block's f32
//   accumulators and rounded to bf16 once. This saves JAX's per-q-head
//   (B*H, S, hd) buffers and the group sum outside (:403-405): at B=1,
//   S=8192, 28 heads that is 2 x 28 x 8192 x 128 x 2 B = 117 MB per layer
//   written and read again. Key tiles at or past the key length get zero
//   gradients, as in the JAX kernel.
// Shared memory: Q, dO, K, V tiles (64 x 136 bf16, 17,408 B each), one
// f32 64 x 68 score tile (S, then dP, in place), one or two bf16 64 x 72
// tiles (P, dS), one or two f32 64 x 132 accumulators, 512 B of lse /
// delta: 130,560 B for dQ, 173,568 B for dK/dV (one block per SM).
// Simple first: no cp.async / TMA pipelining and no wgmma yet.
#include "flash_tile.cuh"

using namespace v3d_flash;

namespace {

constexpr int kTileBf16 = kBq * kLdq;   // elements of a Q/K/V/dO tile
constexpr int kBwdDqSmem = 4 * kTileBf16 * 2 + kBq * kLds * 4 +
                           kBq * kLdp * 2 + kBq * kLdo * 4 + 2 * kBq * 4;
constexpr int kBwdDkvSmem = 4 * kTileBf16 * 2 + kBq * kLds * 4 +
                            2 * kBq * kLdp * 2 + 2 * kBq * kLdo * 4 +
                            2 * kBq * 4;

struct BwdTiles {
  bf16* q;       // (64, kLdq) query tile
  bf16* dout;    // (64, kLdq) dO tile
  bf16* k;       // (64, kLdq) key tile
  bf16* v;       // (64, kLdq) value tile
  float* s;      // (64, kLds) scores, then dP (warp-local rows)
  bf16* p;       // (64, kLdp) P^T (dK/dV) / unused (dQ)
  bf16* ds;      // (64, kLdp) dS (dQ) or dS^T (dK/dV)
  float* acc0;   // (64, kLdo) dQ or dK accumulator
  float* acc1;   // (64, kLdo) dV accumulator (dK/dV only)
  float* lse;    // (64,) the query tile's lse
  float* delta;  // (64,) the query tile's delta
};

// every tile starts on a 32-byte boundary, as WMMA loads and stores need
__device__ __forceinline__ BwdTiles carve_bwd(unsigned char* smem,
                                              bool two_acc) {
  BwdTiles t;
  t.q = reinterpret_cast<bf16*>(smem);
  t.dout = t.q + kTileBf16;
  t.k = t.dout + kTileBf16;
  t.v = t.k + kTileBf16;
  t.s = reinterpret_cast<float*>(t.v + kTileBf16);
  t.ds = reinterpret_cast<bf16*>(t.s + kBq * kLds);
  t.p = two_acc ? t.ds + kBq * kLdp : nullptr;
  t.acc0 = reinterpret_cast<float*>(two_acc ? t.p + kBq * kLdp
                                            : t.ds + kBq * kLdp);
  t.acc1 = two_acc ? t.acc0 + kBq * kLdo : nullptr;
  t.lse = (two_acc ? t.acc1 : t.acc0) + kBq * kLdo;
  t.delta = t.lse + kBq;
  return t;
}

__device__ __forceinline__ void zero_acc(float* acc) {
  for (int i = threadIdx.x; i < kBq * kLdo; i += kThreads) acc[i] = 0.f;
}

// rows [r0, r0 + 64) of a (B, H, L) f32 row vector -> shared (0 past L)
__device__ __forceinline__ void load_rows_f32(float* dst, const float* src,
                                              int r0, int L) {
  for (int i = threadIdx.x; i < kBq; i += kThreads)
    dst[i] = r0 + i < L ? src[r0 + i] : 0.f;
}

typedef wmma::fragment<wmma::accumulator, 16, 16, 16, float> AccFrag;
typedef wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major>
    AFrag;
typedef wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major>
    BColFrag;
typedef wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major>
    BRowFrag;

// this warp's 16 rows of C (64 columns, f32) = A (rows from a, hd deep)
// times B^T (64 rows of b, hd deep): out[r, c] = sum_d a[r, d] b[c, d]
__device__ __forceinline__ void rows_by_rows_t(float* out, const bf16* a,
                                               const bf16* b) {
  const int warp = threadIdx.x / 32;
#pragma unroll
  for (int n = 0; n < kBk / 16; ++n) {
    AccFrag c;
    wmma::fill_fragment(c, 0.f);
#pragma unroll
    for (int kk = 0; kk < kHd / 16; ++kk) {
      AFrag fa;
      BColFrag fb;
      wmma::load_matrix_sync(fa, a + warp * 16 * kLdq + kk * 16, kLdq);
      wmma::load_matrix_sync(fb, b + n * 16 * kLdq + kk * 16, kLdq);
      wmma::mma_sync(c, fa, fb, c);
    }
    wmma::store_matrix_sync(out + warp * 16 * kLds + n * 16, c, kLds,
                            wmma::mem_row_major);
  }
}

// this warp's 16 rows of acc (hd columns, f32) += P (16 x 64 bf16, rows of
// p) times M (64 rows of m, hd wide)
__device__ __forceinline__ void acc_rows(float* acc, const bf16* p,
                                         const bf16* m) {
  const int warp = threadIdx.x / 32;
#pragma unroll
  for (int n = 0; n < kHd / 16; ++n) {
    AccFrag c;
    float* cptr = acc + warp * 16 * kLdo + n * 16;
    wmma::load_matrix_sync(c, cptr, kLdo, wmma::mem_row_major);
#pragma unroll
    for (int kk = 0; kk < kBk / 16; ++kk) {
      AFrag fa;
      BRowFrag fb;
      wmma::load_matrix_sync(fa, p + warp * 16 * kLdp + kk * 16, kLdp);
      wmma::load_matrix_sync(fb, m + kk * 16 * kLdq + n * 16, kLdq);
      wmma::mma_sync(c, fa, fb, c);
    }
    wmma::store_matrix_sync(cptr, c, kLdo, wmma::mem_row_major);
  }
}

// this thread's half (64 values) of row `row` of acc -> dst (hd bf16)
__device__ __forceinline__ void store_acc_row(const float* acc, int row,
                                              int half, bf16* dst) {
  const float* a = acc + row * kLdo + half * (kHd / 2);
  bf16* d = dst + half * (kHd / 2);
#pragma unroll 8
  for (int i = 0; i < kHd / 2; i += 2)
    *reinterpret_cast<__nv_bfloat162*>(d + i) =
        __floats2bfloat162_rn(a[i], a[i + 1]);
}

__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_kernel(const bf16* __restrict__ q,       // (B, L, H, hd)
                    const bf16* __restrict__ k,       // (B, S, KV, hd)
                    const bf16* __restrict__ v,       // (B, S, KV, hd)
                    const bf16* __restrict__ dout,    // (B, L, H, hd)
                    const float* __restrict__ lse,    // (B, H, L)
                    const float* __restrict__ delta,  // (B, H, L)
                    const int* __restrict__ lengths,  // (B,) key lengths
                    bf16* __restrict__ dq,            // (B, L, H, hd)
                    int L, int S, int H, int KV, int causal,
                    float sm_scale) {
  extern __shared__ __align__(128) unsigned char smem[];
  const BwdTiles t = carve_bwd(smem, false);

  const int qt = gridDim.x - 1 - blockIdx.x;   // long causal tiles first
  const int b = blockIdx.y / H, h = blockIdx.y % H;
  const int kvh = h / (H / KV);
  const int q0 = qt * kBq;
  const int length = min(lengths[b], S);
  const long long qrow = (long long)H * kHd, kvrow = (long long)KV * kHd;
  const long long qoff = ((long long)b * L * H + h) * kHd;
  const long long kvoff = ((long long)b * S * KV + kvh) * kHd;
  const long long roff = ((long long)b * H + h) * L;

  load_tile(t.q, q + qoff, qrow, q0, L);
  load_tile(t.dout, dout + qoff, qrow, q0, L);
  load_rows_f32(t.lse, lse + roff, q0, L);
  load_rows_f32(t.delta, delta + roff, q0, L);
  zero_acc(t.acc0);

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int row = warp * 16 + (lane >> 1), half = lane & 1;
  const int row_pos = q0 + row;
  int kend = causal ? min(S, q0 + kBq) : S;
  kend = min(kend, length);
  for (int k0 = 0; k0 < kend; k0 += kBk) {
    __syncthreads();                     // every warp is done with K/V
    load_tile(t.k, k + kvoff, kvrow, k0, S);
    load_tile(t.v, v + kvoff, kvrow, k0, S);
    __syncthreads();

    rows_by_rows_t(t.s, t.q, t.k);       // S = Q K^T, this warp's rows
    __syncwarp();
    const float* srow = t.s + row * kLds + half * 32;
    const float row_lse = t.lse[row];
    float p[32];
#pragma unroll
    for (int c = 0; c < 32; ++c) {
      const int col = k0 + half * 32 + c;
      const bool ok = col < length && (!causal || col <= row_pos);
      p[c] = ok ? expf(srow[c] * sm_scale - row_lse) : 0.f;
    }
    __syncwarp();
    rows_by_rows_t(t.s, t.dout, t.v);    // dP = dO V^T, in place of S
    __syncwarp();
    const float row_delta = t.delta[row];
    bf16* dsrow = t.ds + row * kLdp + half * 32;
#pragma unroll
    for (int c = 0; c < 32; ++c)
      dsrow[c] = __float2bfloat16(p[c] * (srow[c] - row_delta) * sm_scale);
    __syncwarp();
    acc_rows(t.acc0, t.ds, t.k);         // dQ += dS K
    __syncwarp();
  }
  __syncthreads();                       // the zeroed accumulator, no tile
  if (row_pos < L)
    store_acc_row(t.acc0, row, half, dq + qoff + row_pos * qrow);
}

__global__ void __launch_bounds__(kThreads)
flash_bwd_dkv_kernel(const bf16* __restrict__ q,       // (B, L, H, hd)
                     const bf16* __restrict__ k,       // (B, S, KV, hd)
                     const bf16* __restrict__ v,       // (B, S, KV, hd)
                     const bf16* __restrict__ dout,    // (B, L, H, hd)
                     const float* __restrict__ lse,    // (B, H, L)
                     const float* __restrict__ delta,  // (B, H, L)
                     const int* __restrict__ lengths,  // (B,) key lengths
                     bf16* __restrict__ dk,            // (B, S, KV, hd)
                     bf16* __restrict__ dv,            // (B, S, KV, hd)
                     int L, int S, int H, int KV, int causal,
                     float sm_scale) {
  extern __shared__ __align__(128) unsigned char smem[];
  const BwdTiles t = carve_bwd(smem, true);

  const int k0 = blockIdx.x * kBk;       // short causal walks last
  const int b = blockIdx.y / KV, kvh = blockIdx.y % KV;
  const int G = H / KV;
  const int length = min(lengths[b], S);
  const long long qrow = (long long)H * kHd, kvrow = (long long)KV * kHd;
  const long long kvoff = ((long long)b * S * KV + kvh) * kHd;

  load_tile(t.k, k + kvoff, kvrow, k0, S);
  load_tile(t.v, v + kvoff, kvrow, k0, S);
  zero_acc(t.acc0);
  zero_acc(t.acc1);

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int row = warp * 16 + (lane >> 1), half = lane & 1;
  const int key = k0 + row;
  const bool key_ok = key < length;
  // key tiles at or past the length: no query attends them
  const int qstart = k0 < length ? (causal ? k0 : 0) : L;
  for (int g = 0; g < G; ++g) {
    const int h = kvh * G + g;
    const long long qoff = ((long long)b * L * H + h) * kHd;
    const long long roff = ((long long)b * H + h) * L;
    for (int q0 = qstart; q0 < L; q0 += kBq) {
      __syncthreads();                   // every warp is done with Q/dO
      load_tile(t.q, q + qoff, qrow, q0, L);
      load_tile(t.dout, dout + qoff, qrow, q0, L);
      load_rows_f32(t.lse, lse + roff, q0, L);
      load_rows_f32(t.delta, delta + roff, q0, L);
      __syncthreads();

      rows_by_rows_t(t.s, t.k, t.q);     // S^T = K Q^T, this warp's keys
      __syncwarp();
      const float* srow = t.s + row * kLds + half * 32;
      const float* tlse = t.lse + half * 32;
      bf16* prow = t.p + row * kLdp + half * 32;
      float p[32];
#pragma unroll
      for (int c = 0; c < 32; ++c) {
        const int qpos = q0 + half * 32 + c;
        const bool ok = key_ok && qpos < L && (!causal || key <= qpos);
        p[c] = ok ? expf(srow[c] * sm_scale - tlse[c]) : 0.f;
        prow[c] = __float2bfloat16(p[c]);
      }
      __syncwarp();
      rows_by_rows_t(t.s, t.v, t.dout);  // dP^T = V dO^T, in place of S^T
      __syncwarp();
      const float* tdelta = t.delta + half * 32;
      bf16* dsrow = t.ds + row * kLdp + half * 32;
#pragma unroll
      for (int c = 0; c < 32; ++c)
        dsrow[c] = __float2bfloat16(p[c] * (srow[c] - tdelta[c]) * sm_scale);
      __syncwarp();
      acc_rows(t.acc1, t.p, t.dout);     // dV += P^T dO
      acc_rows(t.acc0, t.ds, t.q);       // dK += dS^T Q
      __syncwarp();
    }
  }
  __syncthreads();
  if (key < S) {
    store_acc_row(t.acc0, row, half, dk + kvoff + key * kvrow);
    store_acc_row(t.acc1, row, half, dv + kvoff + key * kvrow);
  }
}

}  // namespace

extern "C" int v3d_flash_attention_bwd_dq(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* delta, const void* lengths, void* dq,
    int B, int L, int S, int H, int KV, int causal, float sm_scale,
    void* stream) {
  static const cudaError_t attr = cudaFuncSetAttribute(
      flash_bwd_dq_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kBwdDqSmem);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  if (KV <= 0 || H % KV != 0) return static_cast<int>(cudaErrorInvalidValue);
  if (B <= 0 || L <= 0) return 0;
  dim3 grid((L + kBq - 1) / kBq, B * H);
  flash_bwd_dq_kernel<<<grid, kThreads, kBwdDqSmem,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const bf16*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<const int*>(lengths), static_cast<bf16*>(dq), L, S, H, KV,
      causal, sm_scale);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int v3d_flash_attention_bwd_dkv(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* delta, const void* lengths, void* dk,
    void* dv, int B, int L, int S, int H, int KV, int causal,
    float sm_scale, void* stream) {
  static const cudaError_t attr = cudaFuncSetAttribute(
      flash_bwd_dkv_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kBwdDkvSmem);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  if (KV <= 0 || H % KV != 0) return static_cast<int>(cudaErrorInvalidValue);
  if (B <= 0 || S <= 0) return 0;
  dim3 grid((S + kBk - 1) / kBk, B * KV);
  flash_bwd_dkv_kernel<<<grid, kThreads, kBwdDkvSmem,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const bf16*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<const int*>(lengths), static_cast<bf16*>(dk),
      static_cast<bf16*>(dv), L, S, H, KV, causal, sm_scale);
  return static_cast<int>(cudaGetLastError());
}
