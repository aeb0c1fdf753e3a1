// The cached-chunk attention kernels on Hopper: B2's GQA-folded form
// (flash_attention.cu) and B5, suffix over a shared prefix
// (shared_prefix_attention.cu), each over a bf16, an int8 or a packed
// int4 cache. One kernel template, on the machinery of flash_sm90.cuh
// (TMA, mbarrier rings, wgmma, setmaxnreg).
//
// Replaces: video3d_tpu/kernels/flash_attention.py::_fwd_kernel in its
// pos_div = group form (flash_attention_gqa_folded, :760) and
// ::_sp_fused_kernel (flash_attention_shared_prefix, :503, pallas_call
// :910), with their quantized forms (scales :813-815, :879-881).
//
// What bounds it on an H100: at the B=1 suffix-over-prefix shape (64
// queries x 7 heads per kv head against ~6.7k cached keys) a layer is 6.2
// GFLOP against 14.8 MB of cache: 420 FLOP per byte, above the card's ~295
// ridge, so the tensor cores bound it if the card is full. B5 at B=8 is
// ~3600 FLOP per byte. So the design is about filling the card and keeping
// the tensor cores fed.
//
// Design. Query rows fold the `group` = H / KV query heads of one kv head
// into the rows (row r*G + g is query r of head kvh*G + g; B5 folds the
// batch rows in too, b-major), so each K / V tile is read once for all
// of them. A CTA of 384 threads owns 128 rows of one kv head: warpgroup 0
// is the producer, warpgroups 1 and 2 are consumers of 64 rows each, as
// in B2's prefill form (flash_attention.cu, pf). The consumers read their
// Q rows with plain 16-byte loads into the 128-byte-swizzled layout of
// flash_sm90.cuh (a 64-row tile at G = 7 covers no whole positions, so no
// TMA box maps onto it), run S = Q K^T and O += P V on wgmma with S, the
// online softmax and O in registers, and write O with plain 16-byte stores
// that skip rows past the last one. The consumers' issue slots are the
// scarce resource (the tensor cores wait on the softmax): masks are
// per-row key limits, one compare with a constant per score and only on
// the tiles that need it; sm_scale rides on the key scale; 2^x is the
// SFU's ex2 alone.
//
// Keys come in tiles of 128 through a ring of two shared-memory stages
// (full / empty mbarriers), by TMA straight out of the stacked cache (a
// 4-D map over (hd, KV, S, layers x B): no per-layer copy) or B5's (P, KV,
// hd) prefix and its (B, L, KV, hd) suffix projections. A bf16 tile lands
// swizzled where the consumers read it. A quantized tile (int8: 128-byte
// rows, int4: 64-byte rows, no swizzle) lands by TMA in a ring of two raw
// stages; the whole producer warpgroup converts it to the bf16 swizzled
// tile (exact for |x| <= 127 and for int4 nibbles, B8's nibble splice in
// common.cuh) while the consumers work on the tile before, and puts the
// tile's 128 key and 128 value scales beside it (one plain load per
// thread; the f32 scales are strided by KV). Scales apply as in the TPU
// kernel: the key scale on the score after sm_scale, l summed over the
// unscaled p, the value scale on p before its bf16 rounding.
//
// Splits over keys: where the row tiles alone do not fill the card (B=1
// suffixes: 16 CTAs at L = 64), the grid gets a split axis; the wrapper
// plans the count from the shapes and the SM count (flash_attention.py,
// chunk_plan) and hands in the workspace. Each CTA takes an even share of
// its own row tile's key tiles (split s of n: [s n / splits, (s + 1) n /
// splits), n from the tile's real extent: lengths and offsets are read on
// the device), writes its unnormalised f32 O and per-row (m, l), and the
// last CTA of the tile to arrive (an atomic counter per row tile, which
// that CTA resets, so the wrapper zeroes the counters once per stream)
// merges all splits in split order, so an output is bit-identical from run
// to run. A split in which a row has no allowed key writes m = -inf and
// weighs 0. B5 splits only its prefix; its last split also walks the
// suffix tiles.
//
// B5's rows straddle batch rows (128 % (L G) != 0): the producer walks the
// prefix tiles, then the suffix tiles of every batch row the CTA's rows
// touch; the suffix mask is per row (same batch row, col <= r), so a
// warpgroup with no row of a suffix tile's batch row gives it weight 0.
//
// Masked keys get exactly zero weight (exp2(-inf)); a row that has seen no
// allowed key keeps p = 0; rows past a length give finite garbage, the
// JAX contract. An mbarrier wait that outlasts ~2^26 polls traps.
#pragma once

#include <type_traits>

#include "flash_sm90.cuh"

namespace v3d_chunk {

using namespace v3d_sm90;

constexpr int kBq = 128;            // query rows per CTA
constexpr int kBk = 128;            // keys per tile
constexpr int kStages = 2;          // bf16 K / V stages
constexpr int kRaw = 2;             // quantized K / V stages
constexpr int kThreads = 384;       // producer + two consumer warpgroups
constexpr int kQHalf = kBq * 128;   // bytes of one 64-channel half of Q
constexpr int kKHalf = kBk * 128;   // bytes of one half of a K or V tile
constexpr int kQBytes = 2 * kQHalf;
constexpr int kStageBytes = 4 * kKHalf;   // K halves, then V halves
constexpr int kScaleFloats = 2 * kBk;     // a stage's key, then value scales
// one split's partial of a CTA: O (kBq x kHeadDim f32), then m and l
constexpr int kPartFloats = kBq * kHeadDim + 2 * kBq;
constexpr int kMaxSmem = 232448;          // a block's limit on the H100
constexpr int kMaxSplits = 64;            // the merge's weights fill Q's tile
constexpr int kProducerBar = 3;           // named barriers (1, 2: consumers)
constexpr int kMergeBar = 4;
constexpr float kLog2e = 1.4426950408889634f;

// 2^x by the SFU alone (ex2.approx.ftz: ~2 ulp, denormal results flush to
// 0, 2^-inf = 0): exp2f's exact path costs several more instructions per
// score, and the softmax's issue slots are what the consumers run short of
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

template <typename T>
__host__ __device__ constexpr bool quantized() {
  return !std::is_same<T, bf16>::value;
}

// bytes of one cached head row of a quantized K or V
template <typename T>
__host__ __device__ constexpr int raw_row_bytes() {
  return quantized<T>() ? kHeadDim / v3d_per_element<T>() : 0;
}

template <typename T>
__host__ __device__ constexpr int raw_tile_bytes() {   // K or V of a tile
  return kBk * raw_row_bytes<T>();
}

template <typename T>
__host__ __device__ constexpr int layout_bytes() {
  return kQBytes + kStages * kStageBytes +
         kRaw * 2 * raw_tile_bytes<T>() +
         (quantized<T>() ? kStages * kScaleFloats * 4 : 0) + 64;
}

// the layout, and up to 1024 bytes to align it where the limit leaves room
template <typename T>
__host__ __device__ constexpr int smem_bytes() {
  return layout_bytes<T>() + 1024 < kMaxSmem ? layout_bytes<T>() + 1024
                                             : kMaxSmem;
}

struct Smem {
  unsigned char* q;      // Q: two halves of kBq rows (then O, bf16)
  unsigned char* kv;     // stage s: K halves, then V halves
  unsigned char* raw;    // raw stage s: K, then V (quantized)
  float* scales;         // stage s: kBk key, then kBk value scales
  uint64_t* full;        // [kStages]
  uint64_t* empty;       // [kStages]
  uint64_t* raw_full;    // [kRaw]
  int* last;             // this CTA merges the splits
};

template <typename T>
__device__ __forceinline__ Smem carve(unsigned char* raw) {
  const uint32_t a = smem_u32(raw);
  const uint32_t pad = ((a + 1023) & ~1023u) - a;
  if (pad + layout_bytes<T>() > static_cast<uint32_t>(smem_bytes<T>()))
    __trap();
  unsigned char* base = raw + pad;
  Smem s;
  s.q = base;
  s.kv = base + kQBytes;
  s.raw = s.kv + kStages * kStageBytes;
  s.scales = reinterpret_cast<float*>(
      s.raw + kRaw * 2 * raw_tile_bytes<T>());
  s.full = reinterpret_cast<uint64_t*>(
      reinterpret_cast<unsigned char*>(s.scales) +
      (quantized<T>() ? kStages * kScaleFloats * 4 : 0));
  s.empty = s.full + kStages;
  s.raw_full = s.empty + kStages;
  s.last = reinterpret_cast<int*>(s.raw_full + kRaw);
  return s;
}

struct Params {
  const bf16* q;            // (B, L, H, hd)
  bf16* out;                // (B, L, H, hd)
  const float* ks;          // quantized: the cache's or prefix's scales,
  const float* vs;          //   f32, one per (slot, kv head)
  const int* lengths;       // folded: (B,) valid slots
  const int* q_off;         // folded: (B,) position of query 0
  float* ws;                // splits > 1: each split's partial
  int* counters;            // splits > 1: an arrival counter per row tile
  int B, L, H, KV, G, R;    // R: folded rows (folded: per batch row)
  int S;                    // folded: cache slots; shared prefix: P
  int layer;
  int n_rt, splits;         // row tiles, splits over keys
  float scale_log2;         // sm_scale * log2(e)
};

// split s of n tiles: [s n / splits, (s + 1) n / splits)
__host__ __device__ __forceinline__ int split_begin(int n, int s,
                                                    int splits) {
  return static_cast<int>(static_cast<long long>(n) * s / splits);
}

// The CTA's place in the grid and its walk over key tiles: main tiles
// (the cache or the prefix) t0 .. t0 + n_main - 1, then (shared) the
// suffix tiles of batch rows b_lo .. b_hi.
struct Walk {
  int rt, split, b, kvh, group;
  int q0, last;             // first and last folded row of the CTA
  int t0, n_main, n_total;
  int length, off;          // folded
  int b_lo, b_hi;           // shared: batch rows of the CTA's rows
};

// shared: the suffix key tiles batch row b's rows in the CTA need (keys up
// to its last row's position)
__device__ __forceinline__ int suffix_tiles(const Params& p, const Walk& w,
                                            int b) {
  const int LG = p.L * p.G;
  const int r_hi = b == w.b_hi ? (w.last % LG) / p.G : p.L - 1;
  return r_hi / kBk + 1;
}

template <bool kShared>
__device__ __forceinline__ Walk walk(const Params& p) {
  Walk w;
  const int per = (kShared ? 1 : p.B) * p.KV * p.splits;
  w.rt = p.n_rt - 1 - static_cast<int>(blockIdx.x) / per;  // long walks first
  const int rem = static_cast<int>(blockIdx.x) % per;
  w.split = rem % p.splits;
  const int bk = rem / p.splits;
  w.b = kShared ? 0 : bk / p.KV;
  w.kvh = bk % p.KV;
  w.group = bk * p.n_rt + w.rt;
  w.q0 = w.rt * kBq;
  w.last = min(w.q0 + kBq, p.R) - 1;
  int n;
  if constexpr (kShared) {
    n = (p.S + kBk - 1) / kBk;
    const int LG = p.L * p.G;
    w.b_lo = w.q0 / LG;
    w.b_hi = w.last / LG;
    w.length = w.off = 0;
  } else {
    w.off = p.q_off[w.b];
    w.length = min(p.lengths[w.b], p.S);
    const int kend = min(w.off + w.last / p.G + 1, w.length);
    n = kend > 0 ? (kend + kBk - 1) / kBk : 0;
    w.b_lo = w.b_hi = w.b;
  }
  w.t0 = split_begin(n, w.split, p.splits);
  w.n_main = split_begin(n, w.split + 1, p.splits) - w.t0;
  w.n_total = w.n_main;
  if constexpr (kShared) {
    if (w.split == p.splits - 1)
      for (int b = w.b_lo; b <= w.b_hi; ++b)
        w.n_total += suffix_tiles(p, w, b);
  }
  return w;
}

struct Tile {
  bool main;   // a cache / prefix tile (else a bf16 suffix tile)
  int b;       // its batch row (suffix: whose suffix)
  int k0;      // its first key
};

template <bool kShared>
__device__ __forceinline__ Tile tile_at(const Params& p, const Walk& w,
                                        int it) {
  Tile t;
  if (!kShared || it < w.n_main) {
    t.main = true;
    t.b = w.b;
    t.k0 = (w.t0 + it) * kBk;
    return t;
  }
  int j = it - w.n_main, b = w.b_lo;
  for (int nt = suffix_tiles(p, w, b); j >= nt; nt = suffix_tiles(p, w, b)) {
    j -= nt;
    ++b;
  }
  t.main = false;
  t.b = b;
  t.k0 = j * kBk;
  return t;
}

// element offset of folded row fr's query (and output) row
template <bool kShared>
__device__ __forceinline__ long long row_offset(const Params& p,
                                                const Walk& w, int fr) {
  int b = w.b, r = fr;
  if constexpr (kShared) {
    const int LG = p.L * p.G;
    b = fr / LG;
    r = fr % LG;
  }
  return ((static_cast<long long>(b) * p.L + r / p.G) * p.H + w.kvh * p.G +
          r % p.G) * kHeadDim;
}

// ------------------------------------------------------------- producer

// the TMA coordinates of a tile's rows: (kv head, first key, outer index)
template <bool kShared>
__device__ __forceinline__ void issue_bf16(const Params& p, const Walk& w,
                                           const Tile& t,
                                           const CUtensorMap* km,
                                           const CUtensorMap* vm,
                                           const CUtensorMap* skm,
                                           const CUtensorMap* svm,
                                           unsigned char* dst,
                                           uint64_t* bar) {
  const CUtensorMap* k = t.main ? km : skm;
  const CUtensorMap* v = t.main ? vm : svm;
  const int outer = kShared ? (t.main ? 0 : t.b) : p.layer * p.B + w.b;
  mbar_arrive_tx(bar, kStageBytes);
  for (int half = 0; half < 2; ++half) {
    tma_load(dst + half * kKHalf, k, bar, half * 64, w.kvh, t.k0, outer);
    tma_load(dst + (2 + half) * kKHalf, v, bar, half * 64, w.kvh, t.k0,
             outer);
  }
}

template <bool kShared, typename T>
__device__ __forceinline__ void issue_raw(const Params& p, const Walk& w,
                                          int it, const CUtensorMap* km,
                                          const CUtensorMap* vm,
                                          const Smem& sm) {
  const int rs = it % kRaw;
  unsigned char* dst = sm.raw + rs * 2 * raw_tile_bytes<T>();
  const int k0 = (w.t0 + it) * kBk;
  const int outer = kShared ? 0 : p.layer * p.B + w.b;
  mbar_arrive_tx(sm.raw_full + rs, 2 * raw_tile_bytes<T>());
  tma_load(dst, km, sm.raw_full + rs, 0, w.kvh, k0, outer);
  tma_load(dst + raw_tile_bytes<T>(), vm, sm.raw_full + rs, 0, w.kvh, k0,
           outer);
}

// 4 int8 values (one word) -> 2 words of exact bf16 pairs
__device__ __forceinline__ uint2 int8x4_to_bf16(unsigned w) {
  float f[4];
  v3d_int8x4_to_float(w, f);
  return make_uint2(pack_bf16(f[0], f[1]), pack_bf16(f[2], f[3]));
}

// raw K and V of one tile -> the swizzled bf16 stage, by the 128 threads
// of the producer warpgroup; unit u: 16 channels of one row (16 int8 or 8
// int4 bytes), two 16-byte chunks of the bf16 tile
template <typename T>
__device__ __forceinline__ void convert(const unsigned char* raw,
                                        unsigned char* kv, int pt) {
  constexpr int kRowBytes = raw_row_bytes<T>();
#pragma unroll 4
  for (int u = pt; u < 2 * kBk * 8; u += 128) {
    const int kvsel = u / (kBk * 8), row = (u / 8) % kBk, c16 = u % 8;
    const unsigned char* src = raw + kvsel * raw_tile_bytes<T>() +
                               row * kRowBytes + c16 * kRowBytes / 8;
    uint4 lo, hi;
    if constexpr (std::is_same<T, int8_t>::value) {
      const uint4 x = *reinterpret_cast<const uint4*>(src);
      const uint2 a = int8x4_to_bf16(x.x), b = int8x4_to_bf16(x.y);
      const uint2 c = int8x4_to_bf16(x.z), d = int8x4_to_bf16(x.w);
      lo = make_uint4(a.x, a.y, b.x, b.y);
      hi = make_uint4(c.x, c.y, d.x, d.y);
    } else {
      const uint2 x = *reinterpret_cast<const uint2*>(src);
      v3d_nibble_pairs(x.x, reinterpret_cast<unsigned*>(&lo));
      v3d_nibble_pairs(x.y, reinterpret_cast<unsigned*>(&hi));
    }
    unsigned char* half = kv + (2 * kvsel + c16 / 4) * kKHalf;
    const int byte = (c16 % 4) * 32;
    *reinterpret_cast<uint4*>(half + sw128(row, byte)) = lo;
    *reinterpret_cast<uint4*>(half + sw128(row, byte + 16)) = hi;
  }
}

template <bool kShared, typename T>
__device__ __forceinline__ void produce(const Params& p, const Walk& w,
                                        const Smem& sm,
                                        const CUtensorMap* km,
                                        const CUtensorMap* vm,
                                        const CUtensorMap* skm,
                                        const CUtensorMap* svm) {
  const int pt = threadIdx.x;   // 0..127
  if constexpr (!quantized<T>()) {
    if (pt != 0) return;
    for (int it = 0; it < w.n_total; ++it) {
      const int st = it % kStages;
      if (it >= kStages) mbar_wait(sm.empty + st, (it / kStages - 1) & 1);
      issue_bf16<kShared>(p, w, tile_at<kShared>(p, w, it), km, vm, skm, svm,
                          sm.kv + st * kStageBytes, sm.full + st);
    }
  } else {
    if (pt == 0)
      for (int it = 0; it < min(kRaw, w.n_main); ++it)
        issue_raw<kShared, T>(p, w, it, km, vm, sm);
    const long long sbase =
        kShared ? w.kvh : (static_cast<long long>(p.layer) * p.B + w.b) *
                                  p.S * p.KV + w.kvh;
    for (int it = 0; it < w.n_total; ++it) {
      const int st = it % kStages;
      const bool main = it < w.n_main;
      float ksc = 0.f, vsc = 0.f;      // this thread's key's scales
      const int key = (w.t0 + it) * kBk + pt;
      if (main && key < p.S) {
        ksc = p.ks[sbase + static_cast<long long>(key) * p.KV];
        vsc = p.vs[sbase + static_cast<long long>(key) * p.KV];
      }
      if (it >= kStages) mbar_wait(sm.empty + st, (it / kStages - 1) & 1);
      if (main) {
        const int rs = it % kRaw;
        mbar_wait(sm.raw_full + rs, (it / kRaw) & 1);
        convert<T>(sm.raw + rs * 2 * raw_tile_bytes<T>(),
                   sm.kv + st * kStageBytes, pt);
        sm.scales[st * kScaleFloats + pt] = ksc;
        sm.scales[st * kScaleFloats + kBk + pt] = vsc;
        fence_proxy_async();          // the tile, visible to wgmma
        mbar_arrive(sm.full + st);
        named_sync(kProducerBar, 128);   // every thread is done with raw
        if (pt == 0 && it + kRaw < w.n_main)
          issue_raw<kShared, T>(p, w, it + kRaw, km, vm, sm);
      } else if (pt == 0) {            // a bf16 suffix tile (shared)
        issue_bf16<kShared>(p, w, tile_at<kShared>(p, w, it), km, vm, skm, svm,
                            sm.kv + st * kStageBytes, sm.full + st);
      } else {
        mbar_arrive(sm.full + st);
      }
    }
  }
}

// ------------------------------------------------------------- consumers

// The warpgroup's rows after the last tile: with one split, O / l as bf16
// through its Q rows to 16-byte stores; else this split's partial to the
// workspace, and the last CTA of the row tile merges every split.
template <bool kShared>
__device__ __forceinline__ void epilogue(const Params& p, const Smem& sm,
                                         const Walk& w, int cw,
                                         const float (&o)[64], float m0,
                                         float m1, float l0, float l1) {
  const int t = threadIdx.x % 128, warp = t / 32, lane = t % 32;
  const int row0 = 16 * warp + lane / 4;
  const int first = w.q0 + 64 * cw;
  unsigned char* qtile = sm.q + cw * (kQHalf / 2);

  if (p.splits == 1) {
    // the final divide guards l >= 1e-30, as the JAX contract says; O ->
    // the warpgroup's Q rows (bf16, swizzled), then 16-byte row stores
    const float d0 = fmaxf(l0, 1e-30f), d1 = fmaxf(l1, 1e-30f);
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      unsigned char* half = qtile + (i / 8) * kQHalf;
      const int byte = (i % 8) * 16 + 4 * (lane % 4);
      *reinterpret_cast<uint32_t*>(half + sw128(row0, byte)) =
          pack_bf16(o[4 * i] / d0, o[4 * i + 1] / d0);
      *reinterpret_cast<uint32_t*>(half + sw128(row0 + 8, byte)) =
          pack_bf16(o[4 * i + 2] / d1, o[4 * i + 3] / d1);
    }
    named_sync(1 + cw, 128);
    for (int c = t; c < 64 * 16; c += 128) {
      const int r = c / 16, j = c % 16, fr = first + r;
      if (fr < p.R)
        *reinterpret_cast<uint4*>(p.out + row_offset<kShared>(p, w, fr) +
                                  j * 8) =
            *reinterpret_cast<const uint4*>(qtile + (j / 8) * kQHalf +
                                            sw128(r, (j % 8) * 16));
    }
    return;
  }

  // splits > 1: this split's unnormalised O and (m, l) -> the workspace
  float* part = p.ws + (static_cast<long long>(w.group) * p.splits + w.split) *
                           kPartFloats;
  const int r0 = 64 * cw + row0;
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    const int col = 8 * i + 2 * (lane % 4);
    *reinterpret_cast<float2*>(part + r0 * kHeadDim + col) =
        make_float2(o[4 * i], o[4 * i + 1]);
    *reinterpret_cast<float2*>(part + (r0 + 8) * kHeadDim + col) =
        make_float2(o[4 * i + 2], o[4 * i + 3]);
  }
  if (lane % 4 == 0) {
    part[kBq * kHeadDim + r0] = m0;
    part[kBq * kHeadDim + r0 + 8] = m1;
    part[kBq * kHeadDim + kBq + r0] = l0;
    part[kBq * kHeadDim + kBq + r0 + 8] = l1;
  }
  __threadfence();
  named_sync(kMergeBar, 256);
  if (threadIdx.x == 128) {
    int* counter = p.counters + w.group;
    const bool last = atomicAdd(counter, 1) == p.splits - 1;
    if (last) *counter = 0;            // the next launch finds it zeroed
    *sm.last = last;
  }
  named_sync(kMergeBar, 256);
  if (!*sm.last) return;
  __threadfence();

  // The last CTA of the row tile merges every split's partial in split
  // order: first each row's weights 2^(m_s - max m) / sum, 0 for a split
  // with no allowed key (into Q's tile: both warpgroups are done with it),
  // then O, two rows per warp at a time, a float4 per lane.
  const int ct = threadIdx.x - 128, mw = ct / 32;
  const float* parts = p.ws + static_cast<long long>(w.group) * p.splits *
                                  kPartFloats;
  float* wt = reinterpret_cast<float*>(sm.q);   // [kBq][kMaxSplits]
  if (ct < kBq) {
    const float* ml = parts + kBq * kHeadDim + ct;
    float mx = -INFINITY;
    for (int s = 0; s < p.splits; ++s)
      mx = fmaxf(mx, __ldcg(ml + s * kPartFloats));
    float den = 0.f;
    for (int s = 0; s < p.splits; ++s) {
      const float ms = __ldcg(ml + s * kPartFloats);
      const float wgt = ms == -INFINITY ? 0.f : exp2f(ms - mx);
      den += wgt * __ldcg(ml + s * kPartFloats + kBq);
      wt[ct * kMaxSplits + s] = wgt;
    }
    const float inv = 1.f / fmaxf(den, 1e-30f);
    for (int s = 0; s < p.splits; ++s) wt[ct * kMaxSplits + s] *= inv;
  }
  named_sync(kMergeBar, 256);
  for (int r = mw; r < kBq; r += 16) {
    const int ra = r, rb = r + 8;
    if (w.q0 + ra >= p.R) break;
    float4 aa = make_float4(0.f, 0.f, 0.f, 0.f), ab = aa;
#pragma unroll 4
    for (int s = 0; s < p.splits; ++s) {
      const float4* ps = reinterpret_cast<const float4*>(parts +
                                                         s * kPartFloats);
      const float4 va = __ldcg(ps + ra * (kHeadDim / 4) + lane);
      const float4 vb = __ldcg(ps + rb * (kHeadDim / 4) + lane);
      const float wa = wt[ra * kMaxSplits + s], wb = wt[rb * kMaxSplits + s];
      aa.x += wa * va.x;
      aa.y += wa * va.y;
      aa.z += wa * va.z;
      aa.w += wa * va.w;
      ab.x += wb * vb.x;
      ab.y += wb * vb.y;
      ab.z += wb * vb.z;
      ab.w += wb * vb.w;
    }
    *reinterpret_cast<uint2*>(p.out + row_offset<kShared>(p, w, w.q0 + ra) +
                              4 * lane) =
        make_uint2(pack_bf16(aa.x, aa.y), pack_bf16(aa.z, aa.w));
    if (w.q0 + rb < p.R)
      *reinterpret_cast<uint2*>(p.out + row_offset<kShared>(p, w, w.q0 + rb) +
                                4 * lane) =
          make_uint2(pack_bf16(ab.x, ab.y), pack_bf16(ab.z, ab.w));
  }
}

template <bool kShared, typename T>
__device__ __forceinline__ void consume(const Params& p, const Smem& sm,
                                        int cw) {
  const Walk w = walk<kShared>(p);
  const int t = threadIdx.x % 128, warp = t / 32, lane = t % 32;
  const int row0 = 16 * warp + lane / 4;          // and row0 + 8
  const int first = w.q0 + 64 * cw;               // the warpgroup's row 0
  const int fr0 = first + row0, fr1 = fr0 + 8;
  unsigned char* qtile = sm.q + cw * (kQHalf / 2);

  // Q rows -> the warpgroup's swizzled rows (zeros past R)
  for (int c = t; c < 64 * 16; c += 128) {
    const int r = c / 16, j = c % 16, fr = first + r;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (fr < p.R)
      val = *reinterpret_cast<const uint4*>(
          p.q + row_offset<kShared>(p, w, fr) + j * 8);
    *reinterpret_cast<uint4*>(qtile + (j / 8) * kQHalf +
                              sw128(r, (j % 8) * 16)) = val;
  }
  fence_proxy_async();
  named_sync(1 + cw, 128);
  const uint64_t q_desc = desc_kmajor(smem_u32(qtile));

  // Masks as per-row key limits, so that each score's test is one compare
  // with a constant: a main tile's key col is allowed iff col < lim (the
  // row's position + 1 and the length, folded; P, shared); `wg_lim`, the
  // least over the warpgroup's rows, says which tiles need the test.
  const int LG = p.L * p.G;
  int lim0 = p.S, lim1 = p.S, wg_lim = p.S;
  if constexpr (!kShared) {
    lim0 = min(w.off + fr0 / p.G + 1, w.length);
    lim1 = min(w.off + fr1 / p.G + 1, w.length);
    wg_lim = min(w.off + first / p.G + 1, w.length);
  }
  const int lane_col = 2 * (lane % 4);   // this lane's column in 8

  float o[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) o[i] = 0.f;
  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;

  for (int it = 0; it < w.n_total; ++it) {
    const int stage = it % kStages;
    mbar_wait(sm.full + stage, (it / kStages) & 1);
    const Tile tl = tile_at<kShared>(p, w, it);
    {
      const uint32_t k_tile = smem_u32(sm.kv) + stage * kStageBytes;
      const uint64_t kd = desc_kmajor(k_tile);
      const uint64_t vd = desc_mnmajor(k_tile + 2 * kKHalf, kKHalf);
      float s[64];
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 8; ++kk)                 // S = Q K^T
        wgmma_ss_n128<0, 0>(s, step_kmajor(q_desc, kk, kQHalf),
                            step_kmajor(kd, kk, kKHalf), kk > 0);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(s);

      const int k0 = tl.k0;
      const bool scaled = quantized<T>() && (!kShared || tl.main);
      const float* sc = sm.scales + stage * kScaleFloats;
      // the limits relative to this lane's first column of the tile
      int rel0 = lim0, rel1 = lim1;
      bool masked = k0 + kBk > wg_lim;
      if (kShared && !tl.main) {   // the suffix of batch row tl.b
        masked = true;
        rel0 = fr0 / LG == tl.b ? (fr0 % LG) / p.G + 1 : 0;
        rel1 = fr1 / LG == tl.b ? (fr1 % LG) / p.G + 1 : 0;
      }
      rel0 -= k0 + lane_col;
      rel1 -= k0 + lane_col;
      float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        float2 ksc = make_float2(p.scale_log2, p.scale_log2);
        if (scaled) {          // the key scale after sm_scale
          ksc = *reinterpret_cast<const float2*>(sc + 8 * j + lane_col);
          ksc.x *= p.scale_log2;
          ksc.y *= p.scale_log2;
        }
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = 4 * j + e;
          float x = s[i] * ((e & 1) ? ksc.y : ksc.x);
          if (masked && 8 * j + (e & 1) >= ((e & 2) ? rel1 : rel0))
            x = -INFINITY;
          s[i] = x;
          if (e & 2) mx1 = fmaxf(mx1, x);
          else mx0 = fmaxf(mx0, x);
        }
      }
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
      const float n0 = fmaxf(m0, mx0), n1 = fmaxf(m1, mx1);
      // a row that has seen no allowed key yet keeps p = 0 (exp2(-inf))
      const float u0 = n0 == -INFINITY ? 0.f : n0;
      const float u1 = n1 == -INFINITY ? 0.f : n1;
      const float a0 = fast_exp2(m0 - u0), a1 = fast_exp2(m1 - u1);
      m0 = n0;
      m1 = n1;
      float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        float2 vsc = make_float2(1.f, 1.f);
        if (scaled)
          vsc = *reinterpret_cast<const float2*>(sc + kBk + 8 * j + lane_col);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = 4 * j + e;
          const float pr = fast_exp2(s[i] - ((e & 2) ? u1 : u0));
          if (e & 2) sum1 += pr;
          else sum0 += pr;
          s[i] = pr * ((e & 1) ? vsc.y : vsc.x);   // l over the unscaled p
        }
      }
      l0 = l0 * a0 + sum0;                 // per-lane partial sums
      l1 = l1 * a1 + sum1;
      if (a0 != 1.f) {
#pragma unroll
        for (int i = 0; i < 64; i += 4) {
          o[i] *= a0;
          o[i + 1] *= a0;
        }
      }
      if (a1 != 1.f) {
#pragma unroll
        for (int i = 2; i < 64; i += 4) {
          o[i] *= a1;
          o[i + 1] *= a1;
        }
      }
      uint32_t p16[8][4];
      to_a_frags(s, p16);
      wgmma_fence();
#pragma unroll
      for (int j = 0; j < 8; ++j)                    // O += P V
        wgmma_rs_n128<1>(o, p16[j], step_mnmajor(vd, j), 1);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(o);
      fence_regs(p16);
    }
    if (t == 0) mbar_arrive(sm.empty + stage);
  }

  l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
  l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
  epilogue<kShared>(p, sm, walk<kShared>(p), cw, o, m0, m1, l0, l1);
}

template <bool kShared, typename T>
__global__ void __launch_bounds__(kThreads, 1)
chunk_kernel(const __grid_constant__ CUtensorMap kmap,    // main K
             const __grid_constant__ CUtensorMap vmap,    // main V
             const __grid_constant__ CUtensorMap skmap,   // shared: suffix K
             const __grid_constant__ CUtensorMap svmap,   // shared: suffix V
             const Params p) {
  extern __shared__ unsigned char smem_raw[];
  const Smem sm = carve<T>(smem_raw);

  if (threadIdx.x == 0) {
    for (int i = 0; i < kStages; ++i) {
      mbar_init(sm.full + i, quantized<T>() ? 128 : 1);
      mbar_init(sm.empty + i, 2);      // one arrival per consumer warpgroup
    }
    for (int i = 0; i < kRaw; ++i) mbar_init(sm.raw_full + i, 1);
    fence_barrier_init();
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 0) {
    if constexpr (quantized<T>()) regs_dec<56>();   // converts
    else regs_dec<40>();
    if (threadIdx.x == 0) {
      tma_prefetch(&kmap);
      tma_prefetch(&vmap);
      if (kShared) {
        tma_prefetch(&skmap);
        tma_prefetch(&svmap);
      }
    }
    produce<kShared, T>(p, walk<kShared>(p), sm, &kmap, &vmap, &skmap,
                        &svmap);
  } else {
    if constexpr (quantized<T>()) regs_inc<224>();
    else regs_inc<232>();
    consume<kShared, T>(p, sm, wg - 1);
  }
}

// ---------------------------------------------------------------- host

// floats of the workspace: each split's partial of each row tile; 0 for
// one split
inline long long workspace_floats(long long groups, int splits) {
  return splits > 1 ? groups * splits * kPartFloats : 0;
}

// The map of a K or V source, rows of kv head c1, key c2, outer index c3:
// bf16: (hd, KV, N, outer) in swizzled boxes of 64 channels x kBk keys;
// quantized: (row bytes, KV, N, outer) in plain boxes of a whole row x kBk
template <typename T>
inline int encode_source(CUtensorMap* map, const void* base, int KV, int N,
                         long long outer) {
  if (quantized<T>())
    return encode_map(map, base, 1, false,
                      {raw_row_bytes<T>(), KV, N, outer},
                      {raw_row_bytes<T>(), 1, kBk, 1});
  return encode_map(map, base, 2, true, {kHeadDim, KV, N, outer},
                    {kBoxChannels, 1, kBk, 1});
}

// Check the plan against the shapes and launch. Main source (k, v) of
// `N` keys and `outer` leading rows; shared: suffix (sk, sv).
template <bool kShared, typename T>
int launch(Params p, const void* k, const void* v, const void* sk,
           const void* sv, long long outer, long long ws_bytes,
           void* stream) {
  static const cudaError_t attr = cudaFuncSetAttribute(
      chunk_kernel<kShared, T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem_bytes<T>());
  if (attr != cudaSuccess) return static_cast<int>(attr);
  if (p.KV <= 0 || p.H % p.KV != 0 || p.S < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (p.B <= 0 || p.L <= 0) return 0;
  p.G = p.H / p.KV;
  p.R = (kShared ? p.B : 1) * p.L * p.G;
  p.n_rt = (p.R + kBq - 1) / kBq;
  const long long groups =
      static_cast<long long>(p.n_rt) * p.KV * (kShared ? 1 : p.B);
  const int key_tiles = (p.S + kBk - 1) / kBk;
  if (p.splits < 1 || (p.splits > 1 &&
                       (p.splits > key_tiles || p.splits > kMaxSplits ||
                        p.ws == nullptr || p.counters == nullptr ||
                        ws_bytes < workspace_floats(groups, p.splits) * 4)))
    return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap km, vm, skm, svm;
  int err = 0;
  if (p.S > 0) {
    err = encode_source<T>(&km, k, p.KV, p.S, outer);
    if (!err) err = encode_source<T>(&vm, v, p.KV, p.S, outer);
  }
  if (kShared) {
    if (!err) err = encode_source<bf16>(&skm, sk, p.KV, p.L, p.B);
    if (!err) err = encode_source<bf16>(&svm, sv, p.KV, p.L, p.B);
    if (p.S == 0) {                    // no prefix: its maps are never read
      km = skm;
      vm = svm;
    }
  } else {
    skm = km;
    svm = vm;
  }
  if (err) return err;
  const dim3 grid(static_cast<unsigned>(groups * p.splits));
  chunk_kernel<kShared, T><<<grid, kThreads, smem_bytes<T>(),
                             static_cast<cudaStream_t>(stream)>>>(
      km, vm, skm, svm, p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace v3d_chunk
