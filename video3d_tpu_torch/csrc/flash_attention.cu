// Causal / length-masked flash attention forward, bf16 in, bf16 out
// (kernel B2).
//
// Replaces: video3d_tpu/kernels/flash_attention.py::_fwd_kernel in the
// prefill form reached from flash_attention -> _flash_core -> _fwd_call
// (query offset 0, no int8 scales, no logsumexp output: inference only).
//
// What bounds it on an H100: the two matrix products. At the main path's
// prefill (L = 8192, 28 heads, hd 128, causal) a layer is ~0.48 TFLOP of
// products against ~0.2 GB of q/k/v/o traffic, far above the card's ~295
// FLOP/byte ridge, so it is compute-bound: the tensor cores set the pace.
//
// Design: one 128-thread block per (query tile of 64 rows, batch*head); each
// of the 4 warps owns 16 query rows. The block walks key tiles of 64 up to
// the causal diagonal and the row's key length; K and V tiles are staged in
// shared memory and shared by the 4 warps. Both products run on the tensor
// cores through WMMA 16x16x16 bf16 fragments with f32 accumulation
// (S = Q K^T, then O += P V with P rounded to bf16). Softmax is the online
// (flash) form with f32 running max and sum, two lanes per row; the f32
// output accumulator lives in shared memory so it can be rescaled by
// exp(m_old - m_new) between tiles. GQA: kv head = h / (H / KV). A ragged
// last tile (L or S not a multiple of 64) is zero-filled on load and masked,
// instead of padding the tensors as the TPU path does. Rows >= length give
// finite garbage (every processed tile holds at least its first key), and
// the final divide guards l >= 1e-30, as the JAX contract says.
// Simple first: no cp.async / TMA pipelining and no wgmma yet.
#include <mma.h>

#include "common.cuh"

using namespace nvcuda;

namespace {

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

typedef __nv_bfloat16 bf16;

// rows [r0, r0 + 64) of a (rows, row_stride) bf16 matrix -> shared tile,
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

__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const bf16* __restrict__ q,      // (B, L, H, hd)
                 const bf16* __restrict__ k,      // (B, S, KV, hd)
                 const bf16* __restrict__ v,      // (B, S, KV, hd)
                 const int* __restrict__ lengths, // (B,) key lengths
                 bf16* __restrict__ out,          // (B, L, H, hd)
                 int L, int S, int H, int KV, int causal, float sm_scale) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* Qs = reinterpret_cast<bf16*>(smem);
  bf16* Ks = Qs + kBq * kLdq;
  bf16* Vs = Ks + kBk * kLdq;
  float* Ss = reinterpret_cast<float*>(Vs + kBk * kLdq);
  bf16* Ps = reinterpret_cast<bf16*>(Ss + kBq * kLds);
  float* Os = reinterpret_cast<float*>(Ps + kBq * kLdp);

  const int qt = gridDim.x - 1 - blockIdx.x;   // long causal tiles first
  const int b = blockIdx.y / H, h = blockIdx.y % H;
  const int kvh = h / (H / KV);
  const int q0 = qt * kBq;
  const int length = min(lengths[b], S);
  const long long q_stride = (long long)H * kHd;
  const long long kv_stride = (long long)KV * kHd;
  const bf16* qb = q + ((long long)b * L * H + h) * kHd;
  const bf16* kb = k + ((long long)b * S * KV + kvh) * kHd;
  const bf16* vb = v + ((long long)b * S * KV + kvh) * kHd;

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  load_tile(Qs, qb, q_stride, q0, L);
  for (int i = threadIdx.x; i < kBq * kLdo; i += kThreads) Os[i] = 0.f;
  __syncthreads();

  wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> qf[kHd / 16];
#pragma unroll
  for (int kk = 0; kk < kHd / 16; ++kk)
    wmma::load_matrix_sync(qf[kk], Qs + warp * 16 * kLdq + kk * 16, kLdq);

  // softmax state: lanes 2r and 2r+1 share row r of this warp's 16 rows
  const int r = lane >> 1, half = lane & 1;
  const int row = warp * 16 + r;
  const int row_pos = q0 + row;
  float m = V3D_NEG_INF, l = 0.f;

  int kend = causal ? min(S, q0 + kBq) : S;
  kend = min(kend, length);
  for (int k0 = 0; k0 < kend; k0 += kBk) {
    __syncthreads();                       // every warp is done with K/V
    load_tile(Ks, kb, kv_stride, k0, S);
    load_tile(Vs, vb, kv_stride, k0, S);
    __syncthreads();

#pragma unroll
    for (int n = 0; n < kBk / 16; ++n) {   // S = Q K^T, this warp's rows
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> sf;
      wmma::fill_fragment(sf, 0.f);
#pragma unroll
      for (int kk = 0; kk < kHd / 16; ++kk) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> kf;
        wmma::load_matrix_sync(kf, Ks + n * 16 * kLdq + kk * 16, kLdq);
        wmma::mma_sync(sf, qf[kk], kf, sf);
      }
      wmma::store_matrix_sync(Ss + warp * 16 * kLds + n * 16, sf, kLds,
                              wmma::mem_row_major);
    }
    __syncwarp();

    const float* srow = Ss + row * kLds + half * 32;
    bf16* prow = Ps + row * kLdp + half * 32;
    float sv[32];
    float mx = V3D_NEG_INF;
#pragma unroll
    for (int c = 0; c < 32; ++c) {
      const int col = k0 + half * 32 + c;
      const bool ok = col < length && (!causal || col <= row_pos);
      sv[c] = ok ? srow[c] * sm_scale : V3D_NEG_INF;
      mx = fmaxf(mx, sv[c]);
    }
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    const float m_new = fmaxf(m, mx);
    const float alpha = expf(m - m_new);
    float sum = 0.f;
#pragma unroll
    for (int c = 0; c < 32; ++c) {
      const float p = expf(sv[c] - m_new);
      sum += p;
      prow[c] = __float2bfloat16(p);
    }
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    l = l * alpha + sum;
    m = m_new;
    float* orow = Os + row * kLdo + half * (kHd / 2);
#pragma unroll 8
    for (int d = 0; d < kHd / 2; ++d) orow[d] *= alpha;
    __syncwarp();

#pragma unroll
    for (int n = 0; n < kHd / 16; ++n) {   // O += P V
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> of;
      float* optr = Os + warp * 16 * kLdo + n * 16;
      wmma::load_matrix_sync(of, optr, kLdo, wmma::mem_row_major);
#pragma unroll
      for (int kk = 0; kk < kBk / 16; ++kk) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> pf;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> vf;
        wmma::load_matrix_sync(pf, Ps + warp * 16 * kLdp + kk * 16, kLdp);
        wmma::load_matrix_sync(vf, Vs + kk * 16 * kLdq + n * 16, kLdq);
        wmma::mma_sync(of, pf, vf, of);
      }
      wmma::store_matrix_sync(optr, of, kLdo, wmma::mem_row_major);
    }
    __syncwarp();
  }

  if (row_pos < L) {
    const float denom = fmaxf(l, 1e-30f);
    const float* orow = Os + row * kLdo + half * (kHd / 2);
    bf16* dst = out + (((long long)b * L + row_pos) * H + h) * kHd + half * (kHd / 2);
#pragma unroll 8
    for (int d = 0; d < kHd / 2; d += 2) {
      *reinterpret_cast<__nv_bfloat162*>(dst + d) =
          __floats2bfloat162_rn(orow[d] / denom, orow[d + 1] / denom);
    }
  }
}

}  // namespace

extern "C" int v3d_flash_attention(const void* q, const void* k,
                                   const void* v, const void* lengths,
                                   void* out, int B, int L, int S, int H,
                                   int KV, int causal, float sm_scale,
                                   void* stream) {
  static bool configured = false;
  if (!configured) {
    cudaError_t e = cudaFuncSetAttribute(
        flash_fwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        kSmemBytes);
    if (e != cudaSuccess) return static_cast<int>(e);
    configured = true;
  }
  if (B <= 0 || L <= 0) return 0;
  dim3 grid((L + kBq - 1) / kBq, B * H);
  flash_fwd_kernel<<<grid, kThreads, kSmemBytes,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const int*>(lengths),
      static_cast<bf16*>(out), L, S, H, KV, causal, sm_scale);
  return static_cast<int>(cudaGetLastError());
}
