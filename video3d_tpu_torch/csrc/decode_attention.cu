// Single-token decode attention over the stacked flat KV cache (kernel B3),
// at head width 128 and at 256 (Gemma).
//
// Replaces: video3d_tpu/kernels/decode_attention.py::_decode_kernel_blockdiag
// (entry decode_attention with kv_heads given: the stacked
// (layers, B, S, KV*hd) cache addressed at `layer`), in three forms: a
// bf16 cache, and an int8 or an int4 cache with per-position, per-kv-head
// f32 scales (quantized=True; stacked scales (layers, B, S, KV, 1)); the
// int4 cache is packed two channels per byte, (layers, B, S, KV*hd / 2).
// JAX runs that kernel for any hd % 128 == 0; the port instantiates the
// template at hd 128 and at hd 256.
//
// What bounds it on an H100: HBM. One step of one layer streams
// 2 * kv_len * KV * hd * 2 bytes of K and V (14 MB at kv_len 6812, KV 4,
// hd 128; 7.0 MB at kv_len 6812, KV 1, hd 256) for ~4 FLOP per byte, far
// below the card's ~295 FLOP/byte ridge; the int8 form streams half of it
// plus 2 * kv_len * KV * 4 bytes of scales, the int4 form a quarter of it
// plus the scales.
//
// Design: decode_sm90.cuh, shared with B7 (paged_attention.cu); this file
// gives it the flat cache's map: position s of batch row b is row
// (layer * B + b) * S + s of the cache, and its scales are that row's KV
// f32 values (strided by KV per position; the producer copies the 4 bytes
// of its kv head). The block-diagonal head packing of the TPU kernel is an
// MXU trick and is not copied: the G query heads of a kv head are the
// n = 8 columns of the tensor-core products.
#include "decode_sm90.cuh"

namespace {

using v3d_decode::Params;

struct FlatRows {
  int layer, S;
  struct Cursor {};
  template <typename P>
  __device__ Cursor begin(const P&, int, int, int, int, Cursor) const {
    return {};
  }
  // the cache row of position pos of row b
  template <typename P>
  __device__ long long row(const P& p, Cursor, int b, int pos) const {
    return (static_cast<long long>(layer) * p.B + b) * S + pos;
  }
  // the index of its scale of this kv head
  template <typename P>
  __device__ long long scale(const P& p, Cursor c, int b, int pos) const {
    return row(p, c, b, pos) * p.KV + blockIdx.y;
  }
};

template <typename T, int kHd>
int launch(const void* q, const void* k_all, const void* v_all,
           const void* k_scale, const void* v_scale, const void* kv_len,
           void* out, void* ws, long long ws_bytes, void* counters,
           int layer, int B, int S, int H, int KV, int splits,
           float sm_scale, void* stream) {
  if (KV <= 0 || H % KV != 0) return static_cast<int>(cudaErrorInvalidValue);
  Params<FlatRows> p;
  p.q = static_cast<const v3d_decode::bf16*>(q);
  p.k = static_cast<const unsigned char*>(k_all);
  p.v = static_cast<const unsigned char*>(v_all);
  p.k_scale = static_cast<const float*>(k_scale);
  p.v_scale = static_cast<const float*>(v_scale);
  p.kv_len = static_cast<const int*>(kv_len);
  p.out = static_cast<v3d_decode::bf16*>(out);
  p.ws = static_cast<float*>(ws);
  p.counters = static_cast<int*>(counters);
  p.map = FlatRows{layer, S};
  p.B = B;
  p.H = H;
  p.KV = KV;
  p.G = H / KV;
  p.cap = S;
  p.splits = splits;
  p.sm_scale = sm_scale;
  return v3d_decode::launch<T, FlatRows, kHd>(
      p, ws_bytes, static_cast<cudaStream_t>(stream));
}

}  // namespace

extern "C" int v3d_decode_attention(const void* q, const void* k_all,
                                    const void* v_all, const void* kv_len,
                                    void* out, void* ws, long long ws_bytes,
                                    void* counters, int layer, int B, int S,
                                    int H, int KV, int splits,
                                    float sm_scale, void* stream) {
  return launch<v3d_decode::bf16, 128>(q, k_all, v_all, nullptr, nullptr, kv_len,
                                  out, ws, ws_bytes, counters, layer, B, S,
                                  H, KV, splits, sm_scale, stream);
}

extern "C" int v3d_decode_attention_int8(
    const void* q, const void* k_all, const void* v_all, const void* k_scale,
    const void* v_scale, const void* kv_len, void* out, void* ws,
    long long ws_bytes, void* counters, int layer, int B, int S, int H,
    int KV, int splits, float sm_scale, void* stream) {
  return launch<int8_t, 128>(q, k_all, v_all, k_scale, v_scale, kv_len, out, ws,
                        ws_bytes, counters, layer, B, S, H, KV, splits,
                        sm_scale, stream);
}

extern "C" int v3d_decode_attention_int4(
    const void* q, const void* k_all, const void* v_all, const void* k_scale,
    const void* v_scale, const void* kv_len, void* out, void* ws,
    long long ws_bytes, void* counters, int layer, int B, int S, int H,
    int KV, int splits, float sm_scale, void* stream) {
  return launch<v3d_nib4, 128>(q, k_all, v_all, k_scale, v_scale, kv_len, out, ws,
                          ws_bytes, counters, layer, B, S, H, KV, splits,
                          sm_scale, stream);
}

// The same three forms at head width 256 (Gemma): q (B, 1, H, 256), the
// cache's rows KV * 256 channels (packed int4: KV * 128 bytes); the
// workspace holds 2 * splits * KV slices of 2 * 8 + 8 * 256 floats.
extern "C" int v3d_decode_attention_hd256(const void* q, const void* k_all,
                                          const void* v_all,
                                          const void* kv_len, void* out,
                                          void* ws, long long ws_bytes,
                                          void* counters, int layer, int B,
                                          int S, int H, int KV, int splits,
                                          float sm_scale, void* stream) {
  return launch<v3d_decode::bf16, 256>(q, k_all, v_all, nullptr, nullptr,
                                       kv_len, out, ws, ws_bytes, counters,
                                       layer, B, S, H, KV, splits, sm_scale,
                                       stream);
}

extern "C" int v3d_decode_attention_hd256_int8(
    const void* q, const void* k_all, const void* v_all, const void* k_scale,
    const void* v_scale, const void* kv_len, void* out, void* ws,
    long long ws_bytes, void* counters, int layer, int B, int S, int H,
    int KV, int splits, float sm_scale, void* stream) {
  return launch<int8_t, 256>(q, k_all, v_all, k_scale, v_scale, kv_len, out,
                             ws, ws_bytes, counters, layer, B, S, H, KV,
                             splits, sm_scale, stream);
}

extern "C" int v3d_decode_attention_hd256_int4(
    const void* q, const void* k_all, const void* v_all, const void* k_scale,
    const void* v_scale, const void* kv_len, void* out, void* ws,
    long long ws_bytes, void* counters, int layer, int B, int S, int H,
    int KV, int splits, float sm_scale, void* stream) {
  return launch<v3d_nib4, 256>(q, k_all, v_all, k_scale, v_scale, kv_len,
                               out, ws, ws_bytes, counters, layer, B, S, H,
                               KV, splits, sm_scale, stream);
}
