// Paged single-token decode attention over stacked page pools (kernel B7),
// at head width 128 and at 256 (Gemma).
//
// Replaces: video3d_tpu/kernels/paged_attention.py::_ragged_kernel (entry
// paged_decode_attention with the stacked (layers, P, page, KV*hd) pools
// addressed at `layer`), in three forms: bf16 pools, and int8 or int4
// pools with per-position, per-kv-head f32 scales (quantized=True; stacked
// scale pools (layers, P, KV, 1, page), contiguous over a page's
// positions); int4 pools are packed two channels per byte, (layers, P,
// page, KV*hd / 2). Slot b attends its first kv_len[b] positions; position
// s lives in pool page table[b, s / page], row s % page.
//
// What bounds it on an H100: HBM and the L2. One step of one layer reads
// each slot's 2 * kv_len * KV * hd values of K and V (the quantized forms
// plus 2 * kv_len * KV * 4 bytes of scales) for ~4 FLOP per value. Pages
// shared by several slots (the scene prefix of the paged batcher) are read
// once per slot; after the first slot they come mostly from the 50 MB L2,
// so the DRAM bytes are the unique pages' and the logical bytes each
// slot's.
//
// Design: decode_sm90.cuh, shared with B3 (decode_attention.cu); this file
// gives it the pools' map, at either head width (the map gives pool rows,
// the template their bytes). At hd 256 B3 and B7 thus compute alike, as
// at 128: a paged step and a dense one over the same values and capacity
// give the same bits. The TPU kernel walks a compacted (slot, page)
// worklist on a sequential grid and carries the online softmax across a
// slot's pages in scratch; here the kernel lays the slots' live positions
// end to end and gives every CTA an even share, whatever the pool size P,
// so tables whose live (slot, page) pairs outnumber P (aliased prefix
// pages) are covered by construction. A warp reads the page-table entries
// of 32 pages at once, one per lane, ahead of its blocks' copies; a block
// of 16 positions takes the first pool rows of its (at most two) pages by
// two shuffles, then copies each position's row of this kv head. No position past kv_len is read, so masked positions
// contribute exactly 0 whatever a reused page holds; a slot with kv_len ==
// 0 gets zeros.
#include "decode_sm90.cuh"

namespace {

using v3d_decode::Params;

struct PagedRows {
  const int* table;   // (B, maxp)
  int layer, P, page, maxp;
  int shift;          // log2(page) for a power of two, else -1
  // x / page
  __device__ int div(int x) const { return shift >= 0 ? x >> shift : x / page; }
  struct Cursor {
    int b = -1, pg0 = 0;   // slot b's pages pg0 .. pg0 + 31 (to its last)
    int mine = 0;          // lane i: the entry of page pg0 + i
    int pos0 = 0, q0 = 0, r0 = 0;   // the block's first position, its page
                                    // index and its row in that page
    long long row_a = 0, row_b = 0;  // pool rows of pages q0 and q0 + 1
  };
  // a block at positions pos0 .. pos0 + n - 1 of slot b (len live
  // positions): the entries come from the window of `prev` where it holds
  // the block's pages, else from a new window of 32 pages from the block's
  // first one, read ahead of the block's copies (one read per 32 pages of
  // a warp); a block of 16 positions spans at most two pages where page
  // >= 16, whose first pool rows come by two shuffles (every lane calls it)
  template <typename Prm>
  __device__ Cursor begin(const Prm&, int b, int pos0, int n, int len,
                          Cursor prev) const {
    Cursor c = prev;
    c.pos0 = pos0;
    c.q0 = div(pos0);
    c.r0 = pos0 - c.q0 * page;
    const int last = div(pos0 + n - 1);
    if (prev.b != b || c.q0 < prev.pg0 || last >= prev.pg0 + 32) {
      c.b = b;
      c.pg0 = c.q0;
      c.mine = 0;
      const int lane = threadIdx.x % 32;
      if (c.q0 + lane <= div(len - 1))
        c.mine = __ldg(table + static_cast<long long>(b) * maxp + c.q0 + lane);
    }
    c.row_a = pool_page(c, c.q0) * page;
    c.row_b = pool_page(c, c.q0 + 1) * page;
    return c;
  }
  // the pool row of position pos of the block (every lane calls it)
  template <typename Prm>
  __device__ long long row(const Prm&, Cursor c, int, int pos) const {
    int off;
    return row_of(c, pos, off) + off;
  }
  // the index of its scale of this kv head (every lane calls it)
  template <typename Prm>
  __device__ long long scale(const Prm& p, Cursor c, int, int pos) const {
    int off;
    return row_of(c, pos, off) * p.KV + blockIdx.y * page + off;
  }
  // the pool page of page index pi of the block's slot (a shuffle)
  __device__ long long pool_page(Cursor c, int pi) const {
    const int pid = __shfl_sync(0xffffffffu, c.mine,
                                min(max(pi - c.pg0, 0), 31));
    return static_cast<long long>(layer) * P + pid;
  }
  // the first pool row of the page holding a position of the block, and
  // the position's row in it
  __device__ long long row_of(Cursor c, int pos, int& off) const {
    off = c.r0 + (pos - c.pos0);
    if (page >= 16) {
      const bool next = off >= page;
      off -= next ? page : 0;
      return next ? c.row_b : c.row_a;
    }
    const int i = off / page;
    off -= i * page;
    return pool_page(c, c.q0 + i) * page;
  }
};

template <typename T, int kWidth>
int launch(const void* q, const void* k_pages, const void* v_pages,
           const void* k_scale, const void* v_scale, const void* table,
           const void* kv_len, void* out, void* ws, long long ws_bytes,
           void* counters, int layer, int B, int P, int page, int maxp,
           int H, int KV, int splits, float sm_scale, void* stream) {
  if (KV <= 0 || H % KV != 0 || page <= 0 || maxp <= 0 ||
      static_cast<long long>(maxp) * page >= (1LL << 31))
    return static_cast<int>(cudaErrorInvalidValue);
  Params<PagedRows> p;
  p.q = static_cast<const v3d_decode::bf16*>(q);
  p.k = static_cast<const unsigned char*>(k_pages);
  p.v = static_cast<const unsigned char*>(v_pages);
  p.k_scale = static_cast<const float*>(k_scale);
  p.v_scale = static_cast<const float*>(v_scale);
  p.kv_len = static_cast<const int*>(kv_len);
  p.out = static_cast<v3d_decode::bf16*>(out);
  p.ws = static_cast<float*>(ws);
  p.counters = static_cast<int*>(counters);
  const int shift = (page & (page - 1)) == 0 ? __builtin_ctz(page) : -1;
  p.map = PagedRows{static_cast<const int*>(table), layer, P, page, maxp,
                    shift};
  p.B = B;
  p.H = H;
  p.KV = KV;
  p.G = H / KV;
  p.cap = maxp * page;
  p.splits = splits;
  p.sm_scale = sm_scale;
  return v3d_decode::launch<T, PagedRows, kWidth>(
      p, ws_bytes, static_cast<cudaStream_t>(stream));
}

}  // namespace

extern "C" int v3d_paged_attention(const void* q, const void* k_pages,
                                   const void* v_pages, const void* table,
                                   const void* kv_len, void* out, void* ws,
                                   long long ws_bytes, void* counters,
                                   int layer, int B, int P, int page,
                                   int maxp, int H, int KV, int splits,
                                   float sm_scale, void* stream) {
  return launch<v3d_decode::bf16, 128>(q, k_pages, v_pages, nullptr, nullptr,
                                  table, kv_len, out, ws, ws_bytes, counters,
                                  layer, B, P, page, maxp, H, KV, splits,
                                  sm_scale, stream);
}

extern "C" int v3d_paged_attention_int8(
    const void* q, const void* k_pages, const void* v_pages,
    const void* k_scale, const void* v_scale, const void* table,
    const void* kv_len, void* out, void* ws, long long ws_bytes,
    void* counters, int layer, int B, int P, int page, int maxp, int H,
    int KV, int splits, float sm_scale, void* stream) {
  return launch<int8_t, 128>(q, k_pages, v_pages, k_scale, v_scale, table, kv_len,
                        out, ws, ws_bytes, counters, layer, B, P, page, maxp,
                        H, KV, splits, sm_scale, stream);
}

extern "C" int v3d_paged_attention_int4(
    const void* q, const void* k_pages, const void* v_pages,
    const void* k_scale, const void* v_scale, const void* table,
    const void* kv_len, void* out, void* ws, long long ws_bytes,
    void* counters, int layer, int B, int P, int page, int maxp, int H,
    int KV, int splits, float sm_scale, void* stream) {
  return launch<v3d_nib4, 128>(q, k_pages, v_pages, k_scale, v_scale, table,
                          kv_len, out, ws, ws_bytes, counters, layer, B, P,
                          page, maxp, H, KV, splits, sm_scale, stream);
}

// The same three forms at head width 256 (Gemma): q (B, 1, H, 256), the
// pools' rows KV * 256 channels (packed int4: KV * 128 bytes); the
// workspace holds 2 * splits * KV slices of 2 * 8 + 8 * 256 floats.
extern "C" int v3d_paged_attention_hd256(const void* q, const void* k_pages,
                                         const void* v_pages,
                                         const void* table,
                                         const void* kv_len, void* out,
                                         void* ws, long long ws_bytes,
                                         void* counters, int layer, int B,
                                         int P, int page, int maxp, int H,
                                         int KV, int splits, float sm_scale,
                                         void* stream) {
  return launch<v3d_decode::bf16, 256>(q, k_pages, v_pages, nullptr, nullptr,
                                       table, kv_len, out, ws, ws_bytes,
                                       counters, layer, B, P, page, maxp, H,
                                       KV, splits, sm_scale, stream);
}

extern "C" int v3d_paged_attention_hd256_int8(
    const void* q, const void* k_pages, const void* v_pages,
    const void* k_scale, const void* v_scale, const void* table,
    const void* kv_len, void* out, void* ws, long long ws_bytes,
    void* counters, int layer, int B, int P, int page, int maxp, int H,
    int KV, int splits, float sm_scale, void* stream) {
  return launch<int8_t, 256>(q, k_pages, v_pages, k_scale, v_scale, table,
                             kv_len, out, ws, ws_bytes, counters, layer, B,
                             P, page, maxp, H, KV, splits, sm_scale, stream);
}

extern "C" int v3d_paged_attention_hd256_int4(
    const void* q, const void* k_pages, const void* v_pages,
    const void* k_scale, const void* v_scale, const void* table,
    const void* kv_len, void* out, void* ws, long long ws_bytes,
    void* counters, int layer, int B, int P, int page, int maxp, int H,
    int KV, int splits, float sm_scale, void* stream) {
  return launch<v3d_nib4, 256>(q, k_pages, v_pages, k_scale, v_scale, table,
                               kv_len, out, ws, ws_bytes, counters, layer, B,
                               P, page, maxp, H, KV, splits, sm_scale,
                               stream);
}
