// Flash attention forward, bf16 in, bf16 out (kernel B2), in two forms.
//
// Replaces: video3d_tpu/kernels/flash_attention.py::_fwd_kernel
//   1. prefill form, reached from flash_attention -> _flash_core ->
//      _fwd_call (L == S, query offset 0, causal or not);
//   2. GQA-folded cached-chunk form, reached from flash_attention_gqa_folded
//      (pos_div = group, per-row query offsets, keys from one layer of the
//      stacked flat (layers, B, S, KV*hd) cache), over a bf16 cache, or an
//      int8 or an int4 one with per-position, per-kv-head f32 scales
//      (quantized=True, scales :813-815; stacked scales (layers, B, S, KV,
//      1)); the int4 cache packed two channels per byte, (layers, B, S,
//      KV*hd / 2);
// the prefill form also in a training instantiation (kLse) that writes the
// per-row logsumexp (:141-143) for the backward kernels B6
// (flash_attention_bwd.cu); the inference instantiation writes none and is
// the same code as before the flag.
//
// What bounds it on an H100: prefill is compute-bound (at L = 8192, 28
// heads, hd 128, causal a layer is ~0.48 TFLOP against ~0.2 GB of q/k/v/o
// traffic, far above the card's ~295 FLOP/byte ridge). The folded form at
// the suffix-over-prefix shape (64 queries x 7 heads against ~6.7k cached
// keys) does 2 * 448 * 128 * 2 FLOP per key row of 512 bytes it streams
// (~450 FLOP/byte): compute and the cache stream are about even.
//
// Design (both forms; tile machinery in flash_tile.cuh): one 128-thread
// block per (64-row query tile, batch row, head); the block walks key tiles
// of 64 up to the causal bound and the row's key length, K and V staged in
// shared memory once for all 64 rows. A ragged last tile (L or S not a
// multiple of 64) is zero-filled on load and masked, instead of padding the
// tensors as the TPU path does.
//   Prefill: GQA by kv head = h / (H / KV); rows >= length give finite
//   garbage, the JAX contract.
//   Folded: the `group` = H / KV query heads of one kv head fold into the
//   rows (row r*group + g is query r of head kvh*group + g, at position
//   q_off[b] + r), so each K/V tile of the cache is read once for all the
//   group's heads, which is the point of folding. K and V are read straight
//   out of the stacked cache by strides, with no per-layer slice copy. An
//   int8 cache (one template on the element type) halves the stream; its
//   tiles are converted to bf16 while staged and the scales of `layer` are
//   read by strides (flash_tile.cuh, stage_kv_int8 / attend_tile<true>).
//   An int4 cache (the tag type v3d_nib4: byte offsets are half the element
//   offsets) quarters it and is staged by stage_kv_int4 into the same bf16
//   tile.
// Simple first: no cp.async / TMA pipelining and no wgmma yet.
#include <type_traits>

#include "flash_tile.cuh"

using namespace v3d_flash;

namespace {

template <bool kLse>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const bf16* __restrict__ q,      // (B, L, H, hd)
                 const bf16* __restrict__ k,      // (B, S, KV, hd)
                 const bf16* __restrict__ v,      // (B, S, KV, hd)
                 const int* __restrict__ lengths, // (B,) key lengths
                 bf16* __restrict__ out,          // (B, L, H, hd)
                 int L, int S, int H, int KV, int causal, float sm_scale,
                 float* __restrict__ lse) {       // (B, H, L) f32, kLse

  extern __shared__ __align__(128) unsigned char smem[];
  const Tiles t = carve(smem);

  const int qt = gridDim.x - 1 - blockIdx.x;   // long causal tiles first
  const int b = blockIdx.y / H, h = blockIdx.y % H;
  const int kvh = h / (H / KV);
  const int q0 = qt * kBq;
  const int length = min(lengths[b], S);
  const long long kv_stride = (long long)KV * kHd;
  const bf16* qb = q + ((long long)b * L * H + h) * kHd;
  const bf16* kb = k + ((long long)b * S * KV + kvh) * kHd;
  const bf16* vb = v + ((long long)b * S * KV + kvh) * kHd;

  load_tile(t.q, qb, (long long)H * kHd, q0, L);
  zero_output(t);
  __syncthreads();
  QFrag qf[kHd / 16];
  load_q_frags(t, qf);
  RowState st = row_state();
  const int row_pos = q0 + st.row;

  int kend = causal ? min(S, q0 + kBq) : S;
  kend = min(kend, length);
  for (int k0 = 0; k0 < kend; k0 += kBk) {
    stage_kv(t, kb, vb, kv_stride, k0, S);
    attend_tile(t, qf, st, k0, sm_scale, [&](int col) {
      return col < length && (!causal || col <= row_pos);
    });
  }
  if (row_pos < L) {
    store_row(t, st, out + (((long long)b * L + row_pos) * H + h) * kHd);
    // m + log(l), l floored as in the output's divide
    if constexpr (kLse)
      if (st.half == 0)
        lse[((long long)b * H + h) * L + row_pos] =
            st.m + logf(fmaxf(st.l, 1e-30f));
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
flash_folded_kernel(const bf16* __restrict__ q,       // (B, L, H, hd)
                    const T* __restrict__ k_all,      // (NL, B, S, KV*hd)
                    const T* __restrict__ v_all,
                    const float* __restrict__ k_scale,  // (NL, B, S, KV) or
                    const float* __restrict__ v_scale,  // null (bf16)
                    const int* __restrict__ lengths,  // (B,) valid slots
                    const int* __restrict__ q_off,    // (B,) position of row 0
                    bf16* __restrict__ out,           // (B, L, H, hd)
                    int layer, int B, int L, int S, int H, int KV,
                    float sm_scale) {
  extern __shared__ __align__(128) unsigned char smem[];
  const Tiles t = carve(smem);

  const int G = H / KV, R = L * G;
  const int b = blockIdx.y / KV, kvh = blockIdx.y % KV;
  const int q0 = blockIdx.x * kBq;
  const int off = q_off[b];
  const int length = min(lengths[b], S);
  const long long stride = (long long)KV * kHd;
  const long long cache_off = ((long long)layer * B + b) * S * stride + kvh * kHd;
  const long long scale_off = ((long long)layer * B + b) * S * KV + kvh;
  const long long head_off = ((long long)b * L * H + kvh * G) * kHd;
  // folded row i -> element offset of query i / G of head kvh * G + i % G
  auto row_off = [=](int i) -> long long {
    return head_off + ((long long)(i / G) * H + i % G) * kHd;
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
  const int row_pos = off + fr / G;

  const int last = min(q0 + kBq, R) - 1;
  const int kend = min(off + last / G + 1, length);
  auto ok = [&](int col) { return col < length && col <= row_pos; };
  for (int k0 = 0; k0 < kend; k0 += kBk) {
    if constexpr (std::is_same<T, int8_t>::value) {
      stage_kv_int8(t, k_all + cache_off, v_all + cache_off, stride,
                    k_scale + scale_off, v_scale + scale_off, KV, k0, S);
      attend_tile<true>(t, qf, st, k0, sm_scale, ok);
    } else if constexpr (std::is_same<T, v3d_nib4>::value) {
      stage_kv_int4(t, k_all + cache_off / 2, v_all + cache_off / 2,
                    stride / 2, k_scale + scale_off, v_scale + scale_off, KV,
                    k0, S);
      attend_tile<true>(t, qf, st, k0, sm_scale, ok);
    } else {
      stage_kv(t, k_all + cache_off, v_all + cache_off, stride, k0, S);
      attend_tile(t, qf, st, k0, sm_scale, ok);
    }
  }
  if (fr < R) store_row(t, st, out + row_off(fr));
}

}  // namespace

namespace {

template <bool kLse>
int launch_fwd(const void* q, const void* k, const void* v,
               const void* lengths, void* out, void* lse, int B, int L,
               int S, int H, int KV, int causal, float sm_scale,
               void* stream) {
  static const cudaError_t attr = cudaFuncSetAttribute(
      flash_fwd_kernel<kLse>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kSmemBytes);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  if (KV <= 0 || H % KV != 0) return static_cast<int>(cudaErrorInvalidValue);
  if (B <= 0 || L <= 0) return 0;
  dim3 grid((L + kBq - 1) / kBq, B * H);
  flash_fwd_kernel<kLse><<<grid, kThreads, kSmemBytes,
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const int*>(lengths),
      static_cast<bf16*>(out), L, S, H, KV, causal, sm_scale,
      static_cast<float*>(lse));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int v3d_flash_attention(const void* q, const void* k,
                                   const void* v, const void* lengths,
                                   void* out, int B, int L, int S, int H,
                                   int KV, int causal, float sm_scale,
                                   void* stream) {
  return launch_fwd<false>(q, k, v, lengths, out, nullptr, B, L, S, H, KV,
                           causal, sm_scale, stream);
}

// the training forward: also the f32 (B, H, L) per-row logsumexp
extern "C" int v3d_flash_attention_lse(const void* q, const void* k,
                                       const void* v, const void* lengths,
                                       void* out, void* lse, int B, int L,
                                       int S, int H, int KV, int causal,
                                       float sm_scale, void* stream) {
  return launch_fwd<true>(q, k, v, lengths, out, lse, B, L, S, H, KV,
                          causal, sm_scale, stream);
}

namespace {

template <typename T>
int launch_folded(const void* q, const void* k_all, const void* v_all,
                  const void* k_scale, const void* v_scale,
                  const void* lengths, const void* q_off, void* out,
                  int layer, int B, int L, int S, int H, int KV,
                  float sm_scale, void* stream) {
  static const cudaError_t attr = cudaFuncSetAttribute(
      flash_folded_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kSmemBytes);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  if (KV <= 0 || H % KV != 0) return static_cast<int>(cudaErrorInvalidValue);
  if (B <= 0 || L <= 0) return 0;
  const int R = L * (H / KV);
  dim3 grid((R + kBq - 1) / kBq, B * KV);
  flash_folded_kernel<T><<<grid, kThreads, kSmemBytes,
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(q), static_cast<const T*>(k_all),
      static_cast<const T*>(v_all), static_cast<const float*>(k_scale),
      static_cast<const float*>(v_scale), static_cast<const int*>(lengths),
      static_cast<const int*>(q_off), static_cast<bf16*>(out), layer, B, L,
      S, H, KV, sm_scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int v3d_flash_attention_folded(const void* q, const void* k_all,
                                          const void* v_all,
                                          const void* lengths,
                                          const void* q_off, void* out,
                                          int layer, int B, int L, int S,
                                          int H, int KV, float sm_scale,
                                          void* stream) {
  return launch_folded<bf16>(q, k_all, v_all, nullptr, nullptr, lengths,
                             q_off, out, layer, B, L, S, H, KV, sm_scale,
                             stream);
}

extern "C" int v3d_flash_attention_folded_int8(
    const void* q, const void* k_all, const void* v_all, const void* k_scale,
    const void* v_scale, const void* lengths, const void* q_off, void* out,
    int layer, int B, int L, int S, int H, int KV, float sm_scale,
    void* stream) {
  return launch_folded<int8_t>(q, k_all, v_all, k_scale, v_scale, lengths,
                               q_off, out, layer, B, L, S, H, KV, sm_scale,
                               stream);
}

extern "C" int v3d_flash_attention_folded_int4(
    const void* q, const void* k_all, const void* v_all, const void* k_scale,
    const void* v_scale, const void* lengths, const void* q_off, void* out,
    int layer, int B, int L, int S, int H, int KV, float sm_scale,
    void* stream) {
  return launch_folded<v3d_nib4>(q, k_all, v_all, k_scale, v_scale, lengths,
                                 q_off, out, layer, B, L, S, H, KV, sm_scale,
                                 stream);
}
