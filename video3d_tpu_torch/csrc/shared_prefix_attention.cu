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
// prefix B times per kv head; here a CTA streams it once for 128 folded
// rows, which may belong to several batch rows.
//
// Design: the fused single-pass form, not the split-softmax + lse merge of
// the TPU kernel's other path: one online softmax per row over the prefix
// then the suffix is exact. Queries fold b-major into one row set per kv
// head, row b*L*group + r*group + g = query r of row b, head kvh*group + g.
// One CTA per (128-row tile of those rows, kv head), on the Hopper
// machinery of chunk_sm90.cuh (shared with B2 folded): every prefix key
// tile, non-causal (every suffix position follows every prefix position),
// keys masked to col < P; then, for each batch row b that the CTA's rows
// belong to, b's suffix key tiles under col <= r (rows of other batch rows
// masked; a consumer warpgroup with no row of b skips the tile). Where the
// row tiles alone do not fill the card (B < 8), the prefix pass splits
// over keys (planned by the wrapper) and the last split also takes the
// suffix pass. The prefix is read by TMA straight out of the stored (P,
// KV, hd) layer of the scene's prefix entry (an int8 or int4 prefix
// converted to bf16 by the producer warpgroup, with its scales); the
// suffix K/V are the chunk's own bf16 (B, L, KV, hd) projections. Query
// rows r >= suffix_lens[b] are undefined by contract (finite garbage), so
// suffix_lens never reaches the kernel: the causal mask already confines
// valid rows to cols <= r < suffix_lens[b].
#include "chunk_sm90.cuh"

namespace {

template <typename T>
int launch(const void* q, const void* pk, const void* pv, const void* pks,
           const void* pvs, const void* sk, const void* sv, void* out, int B,
           int L, int P, int H, int KV, float sm_scale, void* ws,
           long long ws_bytes, void* counters, int splits, void* stream) {
  v3d_chunk::Params p{};
  p.q = static_cast<const v3d_sm90::bf16*>(q);
  p.out = static_cast<v3d_sm90::bf16*>(out);
  p.ks = static_cast<const float*>(pks);
  p.vs = static_cast<const float*>(pvs);
  p.ws = static_cast<float*>(ws);
  p.counters = static_cast<int*>(counters);
  p.B = B;
  p.L = L;
  p.H = H;
  p.KV = KV;
  p.S = P;
  p.splits = splits;
  p.scale_log2 = sm_scale * v3d_chunk::kLog2e;
  return v3d_chunk::launch<true, T>(p, pk, pv, sk, sv, 1, ws_bytes, stream);
}

}  // namespace

// ws: splits > 1, the workspace of v3d_chunk::workspace_floats, ws_bytes
// its size; counters: splits > 1, one zeroed int per row tile (the kernel
// leaves them zeroed); splits: of the prefix (1: none)
extern "C" int v3d_shared_prefix_attention(
    const void* q, const void* pk, const void* pv, const void* sk,
    const void* sv, void* out, int B, int L, int P, int H, int KV,
    float sm_scale, void* ws, long long ws_bytes, void* counters, int splits,
    void* stream) {
  return launch<v3d_sm90::bf16>(q, pk, pv, nullptr, nullptr, sk, sv, out, B,
                                L, P, H, KV, sm_scale, ws, ws_bytes, counters,
                                splits, stream);
}

extern "C" int v3d_shared_prefix_attention_int8(
    const void* q, const void* pk, const void* pv, const void* pk_scale,
    const void* pv_scale, const void* sk, const void* sv, void* out, int B,
    int L, int P, int H, int KV, float sm_scale, void* ws, long long ws_bytes,
    void* counters, int splits, void* stream) {
  return launch<int8_t>(q, pk, pv, pk_scale, pv_scale, sk, sv, out, B, L, P,
                        H, KV, sm_scale, ws, ws_bytes, counters, splits,
                        stream);
}

extern "C" int v3d_shared_prefix_attention_int4(
    const void* q, const void* pk, const void* pv, const void* pk_scale,
    const void* pv_scale, const void* sk, const void* sv, void* out, int B,
    int L, int P, int H, int KV, float sm_scale, void* ws, long long ws_bytes,
    void* counters, int splits, void* stream) {
  return launch<v3d_nib4>(q, pk, pv, pk_scale, pv_scale, sk, sv, out, B, L,
                          P, H, KV, sm_scale, ws, ws_bytes, counters, splits,
                          stream);
}
