// Suffix-over-shared-prefix attention, bf16 in, bf16 out (kernel B5).
//
// Replaces: video3d_tpu/kernels/flash_attention.py::_sp_fused_kernel (entry
// flash_attention_shared_prefix -> _shared_prefix_fused), with a bf16
// prefix, or an int8 or an int4 one (packed two channels per byte, (P, KV,
// hd / 2)) with (P, KV, 1) f32 scales (quantized=True, scales :879-881).
// Scene-grouped batched suffix prefill: the suffix queries of
// all B rows of a batch attend ONE scene prefix K/V (no batch dim), then
// each row's own suffix K/V causally. The suffix K/V are always the
// chunk's raw bf16 projections, never quantized.
//
// What bounds it on an H100: at the main path's shape (B = 8 questions of
// 64 tokens, 28 heads, a 6.7k-key prefix) the prefix K/V of a layer is
// 13.7 MB while the products are 2 * 2 * 14336 * 6.7k * 128 = 49 GFLOP per
// layer (14336 = 8 * 64 * 28 query rows), ~3600 FLOP/byte: compute-bound.
// A per-row kernel (the folded B2 over a broadcast cache) would stream the
// prefix B times per kv head; here a block streams it once for 64 folded
// rows, which may belong to several batch rows.
//
// Design: the fused single-pass form, not the split-softmax + lse merge:
// one online softmax per row over the prefix then the suffix is exact, needs
// no second launch and no (B, L, H) logsumexp round trip through memory.
// Queries fold b-major into one row set per kv head, row
// b*L*group + r*group + g = query r of row b, head kvh*group + g. One
// 128-thread block per (64-row tile of those rows, kv head), tile machinery
// in flash_tile.cuh:
//   1. every prefix key tile, non-causal (every suffix position follows
//      every prefix position), keys masked to col < P;
//   2. for each batch row b that the tile's rows belong to, b's suffix key
//      tiles under col <= r and col < L. A tile crosses batch rows only when
//      L*group % 64 != 0 (never at the suffix buckets 64..512 with group 7);
//      that case is handled by looping over the rows it holds.
// The prefix is read by strides straight out of the stored (P, KV*hd) layer
// of the scene's prefix entry; the suffix K/V are the chunk's own (B, L,
// KV, hd) projections. Query rows r >= suffix_lens[b] are undefined by
// contract (finite garbage), so suffix_lens never reaches the kernel: the
// causal mask already confines valid rows to cols <= r < suffix_lens[b].
// An int8 prefix (one template on its element type) is staged as bf16 with
// its scales and attended with attend_tile<true> (flash_tile.cuh); the
// suffix tiles of the same pass take the bf16 path without scales. An int4
// prefix (the tag type v3d_nib4, byte offsets half the element offsets) is
// staged through stage_kv_int4 into the same bf16 tile.
#include <type_traits>

#include "flash_tile.cuh"

using namespace v3d_flash;

namespace {

template <typename T>
__global__ void __launch_bounds__(kThreads)
shared_prefix_kernel(const bf16* __restrict__ q,    // (B, L, H, hd)
                     const T* __restrict__ pk,      // (P, KV, hd), int4 hd / 2
                     const T* __restrict__ pv,
                     const float* __restrict__ pks,  // (P, KV) or null (bf16)
                     const float* __restrict__ pvs,
                     const bf16* __restrict__ sk,   // (B, L, KV, hd)
                     const bf16* __restrict__ sv,
                     bf16* __restrict__ out,        // (B, L, H, hd)
                     int B, int L, int P, int H, int KV, float sm_scale) {
  extern __shared__ __align__(128) unsigned char smem[];
  const Tiles t = carve(smem);

  const int G = H / KV, LG = L * G, R = B * LG;
  const int kvh = blockIdx.y;
  const int q0 = blockIdx.x * kBq;
  const long long stride = (long long)KV * kHd;
  // b-major folded row i -> element offset of query r of row b, head
  // kvh * G + g, where i = b * LG + r * G + g
  auto row_off = [=](int i) -> long long {
    const int b = i / LG, rem = i % LG;
    return (((long long)b * L + rem / G) * H + kvh * G + rem % G) * kHd;
  };

  load_rows(t.q, [&](int r) -> const bf16* {
    return q0 + r < R ? q + row_off(q0 + r) : nullptr;
  });
  zero_output(t);
  __syncthreads();
  QFrag qf[kHd / 16];
  load_q_frags(t, qf);
  RowState st = row_state();
  const int fr = q0 + st.row;
  const int rb = fr / LG, rr = (fr % LG) / G;

  // 1. the shared prefix
  auto in_prefix = [&](int col) { return col < P; };
  for (int k0 = 0; k0 < P; k0 += kBk) {
    if constexpr (std::is_same<T, int8_t>::value) {
      stage_kv_int8(t, pk + kvh * kHd, pv + kvh * kHd, stride, pks + kvh,
                    pvs + kvh, KV, k0, P);
      attend_tile<true>(t, qf, st, k0, sm_scale, in_prefix);
    } else if constexpr (std::is_same<T, v3d_nib4>::value) {
      stage_kv_int4(t, pk + kvh * kHd / 2, pv + kvh * kHd / 2, stride / 2,
                    pks + kvh, pvs + kvh, KV, k0, P);
      attend_tile<true>(t, qf, st, k0, sm_scale, in_prefix);
    } else {
      stage_kv(t, pk + kvh * kHd, pv + kvh * kHd, stride, k0, P);
      attend_tile(t, qf, st, k0, sm_scale, in_prefix);
    }
  }
  // 2. each batch row's own suffix, block-diagonal causal
  const int last = min(q0 + kBq, R) - 1;
  const int b_last = last / LG;
  for (int b = q0 / LG; b <= b_last; ++b) {
    const int r_hi = b == b_last ? (last % LG) / G : L - 1;
    const long long base = (long long)b * L * stride + kvh * kHd;
    for (int k0 = 0; k0 <= r_hi; k0 += kBk) {
      stage_kv(t, sk + base, sv + base, stride, k0, L);
      attend_tile(t, qf, st, k0, sm_scale, [&](int col) {
        return rb == b && col <= rr && col < L;
      });
    }
  }
  if (fr < R) store_row(t, st, out + row_off(fr));
}

template <typename T>
int launch(const void* q, const void* pk, const void* pv, const void* pks,
           const void* pvs, const void* sk, const void* sv, void* out, int B,
           int L, int P, int H, int KV, float sm_scale, void* stream) {
  static const cudaError_t attr = cudaFuncSetAttribute(
      shared_prefix_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kSmemBytes);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  if (KV <= 0 || H % KV != 0 || P < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (B <= 0 || L <= 0) return 0;
  const int R = B * L * (H / KV);
  dim3 grid((R + kBq - 1) / kBq, KV);
  shared_prefix_kernel<T><<<grid, kThreads, kSmemBytes,
                            static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(q), static_cast<const T*>(pk),
      static_cast<const T*>(pv), static_cast<const float*>(pks),
      static_cast<const float*>(pvs), static_cast<const bf16*>(sk),
      static_cast<const bf16*>(sv), static_cast<bf16*>(out), B, L, P, H, KV,
      sm_scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int v3d_shared_prefix_attention(const void* q, const void* pk,
                                           const void* pv, const void* sk,
                                           const void* sv, void* out, int B,
                                           int L, int P, int H, int KV,
                                           float sm_scale, void* stream) {
  return launch<bf16>(q, pk, pv, nullptr, nullptr, sk, sv, out, B, L, P, H,
                      KV, sm_scale, stream);
}

extern "C" int v3d_shared_prefix_attention_int8(
    const void* q, const void* pk, const void* pv, const void* pk_scale,
    const void* pv_scale, const void* sk, const void* sv, void* out, int B,
    int L, int P, int H, int KV, float sm_scale, void* stream) {
  return launch<int8_t>(q, pk, pv, pk_scale, pv_scale, sk, sv, out, B, L, P,
                        H, KV, sm_scale, stream);
}

extern "C" int v3d_shared_prefix_attention_int4(
    const void* q, const void* pk, const void* pv, const void* pk_scale,
    const void* pv_scale, const void* sk, const void* sv, void* out, int B,
    int L, int P, int H, int KV, float sm_scale, void* stream) {
  return launch<v3d_nib4>(q, pk, pv, pk_scale, pv_scale, sk, sv, out, B, L,
                          P, H, KV, sm_scale, stream);
}
