// Suffix-over-shared-prefix attention at head width 256 (Gemma; kernel B5
// at hd 256), over a bf16 prefix, or an int8 or a packed int4 one (two
// channels a byte, channel 2j in byte j's low nibble) with f32 scales.
//
// Replaces, at hd 256: video3d_tpu/kernels/flash_attention.py::
// _sp_fused_kernel (entry flash_attention_shared_prefix, pallas_call
// :910), which JAX runs for any hd % 128 == 0, with its quantized forms
// (scales :879-881): query r of batch row b sits at position P + r and
// attends the whole (P, KV, 256) prefix (no batch dim), then its row's
// own bf16 suffix keys j <= r of the (B, L, KV, 256) suffix projections.
// Rows r >= suffix_lens[b] are undefined by contract (finite here), so,
// as at hd 128, suffix_lens never reaches the kernel: the causal mask
// keeps valid rows inside their suffix.
//
// What bounds it on an H100: the tensor cores. At the batched answers'
// shape (B = 8 questions of 64 tokens, 8 heads on 1 kv head, a 6716-key
// prefix) a layer is 4 * 4096 rows * 6716 keys * 256 = 28 GFLOP against
// 6.9 MB of prefix: ~4000 FLOP per byte, far above the card's ~295 ridge.
// Every prefix tile feeds 128 rows here, so from the L2 a CTA reads
// 64 KiB of K and V per 8.4 MFLOP of products: the L2, not HBM, is the
// next limit.
//
// Design: the hd-256 prefill kernel's machinery (flash_attention_hd256.cu:
// a 256-thread CTA of two consumer warpgroups, 64 x 256 f32 accumulators
// in registers, wgmma m64n64k16 for S and two m64n128k16 per 16 keys for
// P V, K and V tiles of 64 keys by TMA into two stages) with the
// cached-chunk kernel's walk (chunk_sm90.cuh): the B * L * G query rows of
// a kv head fold b-major (row f = b L G + r G + g is query r of batch row
// b, head kvh G + g), so a CTA's 128 rows share every prefix tile across
// batch rows and the prefix is read once per row tile, not once per batch
// row. The consumers load their Q rows with plain 16-byte loads into the
// 128-byte swizzle (a 64-row tile at 8 heads covers 8 positions of
// several heads: no TMA box maps onto it). A CTA walks prefix tiles, keys
// past P masked; where the row tiles alone do not fill the card the prefix
// splits over CTAs (the wrapper plans it from the shapes: chunk_plan's
// cost model), and the last split also walks the suffix tiles of every
// batch row its rows touch, each row masked to its own batch row and to
// col <= r (a warpgroup with no row of that batch row skips the tile).
// Each split writes its unnormalised f32 O and per-row (m, l); the last
// CTA of a row tile to arrive (an arrival counter per row tile, reset by
// that CTA) merges every split in split order, so outputs are
// bit-identical from run to run.
//
// Loads. There is no producer warpgroup (a 384-thread CTA compiles under
// 168 registers, below the 128-register accumulator and its softmax), so
// warpgroup 0 fills the K side of each stage and warpgroup 1 the V side:
// tile it + 1 after its S product of tile it, once both warpgroups have
// released the stage's tile it - 1. A bf16 tile (the bf16 prefix, any
// suffix tile) is one TMA per 64-channel part, issued by the side's first
// thread. A
// quantized prefix tile lands raw by TMA (int8 rows 256 bytes, int4 128,
// no swizzle) in a one-tile raw stage of its own per side; the side's 128
// threads convert it exactly to the bf16 swizzled tile (|x| <= 127; int4
// by B8's nibble splice, common.cuh) while the other warpgroup's products
// run, put the tile's 64 key or value scales beside it, and
// the side's first thread then loads the next raw tile (key scales wait
// for the stage's V release too: the softmax reads them after its S
// product has released K). Shared memory: Q
// 64 KiB, two stages of 64 KiB, (int8) 32 KiB of raw tiles: 224 KiB, one
// CTA per SM. The scales apply as in the TPU kernel: the key scale (with
// sm_scale) on the score, l summed over the unscaled p, the value scale
// on p before its bf16 rounding; the suffix stays bf16 at scale 1. Scale
// rows are read one f32 at a time (a one-kv-head prefix's are 4-byte
// aligned). Masked keys get exactly zero weight; a row that has seen no
// allowed key keeps p = 0. An mbarrier wait that outlasts ~2^26 polls
// traps.
#include <type_traits>

#include "flash_sm90.cuh"

namespace {

using namespace v3d_sm90;

constexpr int kHd = 256;
constexpr int kBq = 128;            // folded query rows per CTA
constexpr int kBk = 64;             // keys per K / V tile
constexpr int kStages = 2;          // bf16 K / V stages
constexpr int kThreads = 256;       // two consumer warpgroups
constexpr int kParts = kHd / kBoxChannels;   // 64-channel parts of a row
constexpr int kQPart = kBq * 128;   // bytes of one 64-channel part of Q
constexpr int kKPart = kBk * 128;   // ... of a K or V tile
constexpr int kQBytes = kParts * kQPart;      // 64 KiB
constexpr int kTileBytes = kParts * kKPart;   // one K or V tile: 32 KiB
constexpr int kStageBytes = 2 * kTileBytes;   // K, then V
constexpr int kScaleFloats = 2 * kBk;         // a stage's key, value scales
// one split's partial of a CTA: O (kBq x kHd f32), then m and l per row
constexpr int kPartFloats = kBq * kHd + 2 * kBq;
constexpr int kMaxSplits = 64;      // the merge's weights fit in Q's tile
constexpr int kMaxSmem = 232448;    // a block's limit on the H100
constexpr int kMergeBar = 3;        // named barriers 1, 2: the warpgroups
constexpr float kLog2e = 1.4426950408889634f;

// 2^x by the SFU alone (ex2.approx.ftz: ~2 ulp, 2^-inf = 0), as in the
// hd-128 chunk kernel: the softmax's issue slots are scarce
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

template <typename T>
__host__ __device__ constexpr bool quantized() {
  return !std::is_same<T, bf16>::value;
}

// bytes of one cached head row of a quantized K or V (0: bf16)
template <typename T>
__host__ __device__ constexpr int raw_row_bytes() {
  return quantized<T>() ? kHd / v3d_per_element<T>() : 0;
}

template <typename T>
__host__ __device__ constexpr int raw_tile_bytes() {   // K or V of a tile
  return kBk * raw_row_bytes<T>();
}

// Q, the stages, the raw K and V tiles, the stages' scales, 10 barriers
// and the merge flag
template <typename T>
__host__ __device__ constexpr int layout_bytes() {
  return kQBytes + kStages * kStageBytes + 2 * raw_tile_bytes<T>() +
         (quantized<T>() ? kStages * kScaleFloats * 4 : 0) + 96;
}

// the layout, and up to 1024 bytes to align it where the limit leaves room
template <typename T>
__host__ __device__ constexpr int smem_bytes() {
  return layout_bytes<T>() + 1024 < kMaxSmem ? layout_bytes<T>() + 1024
                                             : kMaxSmem;
}

struct Smem {
  unsigned char* q;      // Q: four parts of kBq rows (then the merge's
                         // weights)
  unsigned char* kv;     // stage s: K's four parts, then V's
  unsigned char* raw;    // quantized: the raw K tile, then the raw V tile
  float* scales;         // stage s: kBk key, then kBk value scales
  uint64_t* full;        // [side][kStages]: side 0 K, side 1 V
  uint64_t* empty;       // [side][kStages]
  uint64_t* raw_full;    // [side]
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
  s.scales = reinterpret_cast<float*>(s.raw + 2 * raw_tile_bytes<T>());
  s.full = reinterpret_cast<uint64_t*>(
      reinterpret_cast<unsigned char*>(s.scales) +
      (quantized<T>() ? kStages * kScaleFloats * 4 : 0));
  s.empty = s.full + 2 * kStages;
  s.raw_full = s.empty + 2 * kStages;
  s.last = reinterpret_cast<int*>(s.raw_full + 2);
  return s;
}

struct Params {
  const bf16* q;            // (B, L, H, 256)
  bf16* out;                // (B, L, H, 256)
  const float* ks;          // quantized: the prefix's (P, KV, 1) scales
  const float* vs;
  float* ws;                // splits > 1: each split's partial
  int* counters;            // splits > 1: an arrival counter per row tile
  int B, L, H, KV, G, R;    // R = B L G folded rows of a kv head
  int P;                    // prefix keys
  int n_rt, splits;         // row tiles, splits of the prefix
  float scale_log2;         // sm_scale * log2(e)
};

struct Maps {
  const CUtensorMap *pk, *pv, *sk, *sv;
};

// split s of n tiles: [s n / splits, (s + 1) n / splits)
__device__ __forceinline__ int split_begin(int n, int s, int splits) {
  return static_cast<int>(static_cast<long long>(n) * s / splits);
}

// The CTA's place in the grid and its walk over key tiles: prefix tiles
// t0 .. t0 + n_main - 1, then (the last split) the suffix tiles of batch
// rows b_lo .. b_hi.
struct Walk {
  int rt, split, kvh, group;
  int q0, last;             // first and last folded row of the CTA
  int t0, n_main, n_total;
  int b_lo, b_hi;
};

// the suffix key tiles batch row b's rows in the CTA need (keys up to its
// last row's position)
__device__ __forceinline__ int suffix_tiles(const Params& p, const Walk& w,
                                            int b) {
  const int r_hi = b == w.b_hi ? (w.last % (p.L * p.G)) / p.G : p.L - 1;
  return r_hi / kBk + 1;
}

__device__ __forceinline__ Walk walk(const Params& p) {
  Walk w;
  const int per = p.KV * p.splits;
  w.rt = p.n_rt - 1 - static_cast<int>(blockIdx.x) / per;
  const int rem = static_cast<int>(blockIdx.x) % per;
  w.split = rem % p.splits;
  w.kvh = rem / p.splits;
  w.group = w.kvh * p.n_rt + w.rt;
  w.q0 = w.rt * kBq;
  w.last = min(w.q0 + kBq, p.R) - 1;
  const int LG = p.L * p.G;
  w.b_lo = w.q0 / LG;
  w.b_hi = w.last / LG;
  const int n = (p.P + kBk - 1) / kBk;
  w.t0 = split_begin(n, w.split, p.splits);
  w.n_main = split_begin(n, w.split + 1, p.splits) - w.t0;
  w.n_total = w.n_main;
  if (w.split == p.splits - 1)
    for (int b = w.b_lo; b <= w.b_hi; ++b) w.n_total += suffix_tiles(p, w, b);
  return w;
}

struct Tile {
  bool main;   // a prefix tile (else a bf16 suffix tile)
  int b;       // suffix: whose suffix
  int k0;      // its first key
};

__device__ __forceinline__ Tile tile_at(const Params& p, const Walk& w,
                                        int it) {
  Tile t;
  if (it < w.n_main) {
    t.main = true;
    t.b = 0;
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
__device__ __forceinline__ long long row_offset(const Params& p,
                                                const Walk& w, int fr) {
  const int LG = p.L * p.G;
  const int b = fr / LG, r = fr % LG;
  return ((static_cast<long long>(b) * p.L + r / p.G) * p.H + w.kvh * p.G +
          r % p.G) * kHd;
}

// ------------------------------------------------------------- the loads

// the side's first thread: raw prefix tile j (K: side 0, V: side 1) into
// the side's raw stage
template <typename T>
__device__ __forceinline__ void issue_raw(const Walk& w, const Smem& sm,
                                          const Maps& m, int side, int j) {
  uint64_t* bar = sm.raw_full + side;
  mbar_arrive_tx(bar, raw_tile_bytes<T>());
  tma_load(sm.raw + side * raw_tile_bytes<T>(), side ? m.pv : m.pk, bar, 0,
           w.kvh, (w.t0 + j) * kBk, 0);
}

// 4 int8 values (one word) -> 2 words of exact bf16 pairs
__device__ __forceinline__ uint2 int8x4_to_bf16(unsigned v) {
  float f[4];
  v3d_int8x4_to_float(v, f);
  return make_uint2(pack_bf16(f[0], f[1]), pack_bf16(f[2], f[3]));
}

// A raw K or V tile -> its bf16 swizzled tile, by the side's 128 threads;
// unit u: 16 channels of one row (16 int8 or 8 int4 bytes) -> two 16-byte
// chunks of the part holding them
template <typename T>
__device__ __forceinline__ void convert(const unsigned char* raw,
                                        unsigned char* dst, int t) {
  constexpr int kRowBytes = raw_row_bytes<T>();
#pragma unroll 4
  for (int u = t; u < kBk * 16; u += 128) {
    const int row = u / 16, c16 = u % 16;
    const unsigned char* src = raw + row * kRowBytes + c16 * (kRowBytes / 16);
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
    unsigned char* part = dst + (c16 / 4) * kKPart;
    const int byte = (c16 % 4) * 32;
    *reinterpret_cast<uint4*>(part + sw128(row, byte)) = lo;
    *reinterpret_cast<uint4*>(part + sw128(row, byte + 16)) = hi;
  }
}

// Side `side` (0: K, by warpgroup 0; 1: V, by warpgroup 1) of tile j into
// stage j % 2, once both warpgroups have released the stage's tile j - 2:
// a bf16 tile by TMA from the side's first thread, a quantized prefix tile
// converted from the raw stage by the side's 128 threads (then the next
// raw tile is loaded). Every thread of the side calls it.
template <typename T>
__device__ __forceinline__ void fill(const Params& p, const Walk& w,
                                     const Smem& sm, const Maps& m, int j,
                                     int side, int t) {
  if (j >= w.n_total) return;
  const int stage = j % kStages;
  uint64_t* full = sm.full + side * kStages + stage;
  uint64_t* empty = sm.empty + side * kStages + stage;
  unsigned char* dst = sm.kv + stage * kStageBytes + side * kTileBytes;
  const Tile tl = tile_at(p, w, j);
  if (!quantized<T>() || !tl.main) {
    if (t == 0) {
      if (j >= kStages) mbar_wait(empty, ((j - kStages) / kStages) & 1);
      const CUtensorMap* map = tl.main ? (side ? m.pv : m.pk)
                                       : (side ? m.sv : m.sk);
      mbar_arrive_tx(full, kTileBytes);
      for (int part = 0; part < kParts; ++part)
        tma_load(dst + part * kKPart, map, full, part * kBoxChannels, w.kvh,
                 tl.k0, tl.main ? 0 : tl.b);
    }
    return;
  }
  // the scale of this thread's key, read before the waits
  float sc = 0.f;
  const int key = tl.k0 + t;
  if (t < kBk && key < p.P)
    sc = (side ? p.vs : p.ks)[static_cast<long long>(key) * p.KV + w.kvh];
  mbar_wait(sm.raw_full + side, j & 1);
  if (j >= kStages) mbar_wait(empty, ((j - kStages) / kStages) & 1);
  convert<T>(sm.raw + side * raw_tile_bytes<T>(), dst, t);
  // tile j - 2's key scales are read by the softmax, after the K side's
  // release: they are overwritten once both warpgroups are past its P V
  if (side == 0 && j >= kStages)
    mbar_wait(sm.empty + kStages + stage, ((j - kStages) / kStages) & 1);
  if (t < kBk) sm.scales[stage * kScaleFloats + side * kBk + t] = sc;
  fence_proxy_async();             // the tile, visible to wgmma
  named_sync(1 + side, 128);       // every thread is done with raw
  if (t == 0) {
    mbar_arrive(full);
    if (j + 1 < w.n_main) issue_raw<T>(w, sm, m, side, j + 1);
  }
}

// ------------------------------------------------------------- consumers

// The warpgroup's rows after the last tile: with one split, O / l as bf16
// through its Q rows to 16-byte stores; else this split's partial to the
// workspace, and the last CTA of the row tile merges every split.
__device__ __forceinline__ void epilogue(const Params& p, const Smem& sm,
                                         const Walk& w, int wg,
                                         const float (&o)[2][64], float m0,
                                         float m1, float l0, float l1) {
  const int t = threadIdx.x % 128, warp = t / 32, lane = t % 32;
  const int row0 = 16 * warp + lane / 4;
  const int first = w.q0 + 64 * wg;
  unsigned char* qtile = sm.q + wg * (kQPart / 2);

  if (p.splits == 1) {
    // the final divide guards l >= 1e-30, as the JAX contract says; O ->
    // the warpgroup's Q rows (bf16, swizzled), then 16-byte row stores
    const float d0 = fmaxf(l0, 1e-30f), d1 = fmaxf(l1, 1e-30f);
#pragma unroll
    for (int half = 0; half < 2; ++half)
#pragma unroll
      for (int i = 0; i < 16; ++i) {
        unsigned char* part = qtile + (2 * half + i / 8) * kQPart;
        const int byte = (i % 8) * 16 + 4 * (lane % 4);
        *reinterpret_cast<uint32_t*>(part + sw128(row0, byte)) =
            pack_bf16(o[half][4 * i] / d0, o[half][4 * i + 1] / d0);
        *reinterpret_cast<uint32_t*>(part + sw128(row0 + 8, byte)) =
            pack_bf16(o[half][4 * i + 2] / d1, o[half][4 * i + 3] / d1);
      }
    named_sync(1 + wg, 128);
    for (int c = t; c < 64 * 32; c += 128) {
      const int r = c / 32, j = c % 32, fr = first + r;
      if (fr < p.R)
        *reinterpret_cast<uint4*>(p.out + row_offset(p, w, fr) + j * 8) =
            *reinterpret_cast<const uint4*>(qtile + (j / 8) * kQPart +
                                            sw128(r, (j % 8) * 16));
    }
    return;
  }

  // splits > 1: this split's unnormalised O and (m, l) -> the workspace
  float* part = p.ws + (static_cast<long long>(w.group) * p.splits + w.split) *
                           kPartFloats;
  const int r0 = 64 * wg + row0;
#pragma unroll
  for (int half = 0; half < 2; ++half)
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      const int col = 128 * half + 8 * i + 2 * (lane % 4);
      *reinterpret_cast<float2*>(part + r0 * kHd + col) =
          make_float2(o[half][4 * i], o[half][4 * i + 1]);
      *reinterpret_cast<float2*>(part + (r0 + 8) * kHd + col) =
          make_float2(o[half][4 * i + 2], o[half][4 * i + 3]);
    }
  if (lane % 4 == 0) {
    part[kBq * kHd + r0] = m0;
    part[kBq * kHd + r0 + 8] = m1;
    part[kBq * kHd + kBq + r0] = l0;
    part[kBq * kHd + kBq + r0 + 8] = l1;
  }
  __threadfence();
  named_sync(kMergeBar, kThreads);
  if (threadIdx.x == 0) {
    int* counter = p.counters + w.group;
    const bool last = atomicAdd(counter, 1) == p.splits - 1;
    if (last) *counter = 0;            // the next launch finds it zeroed
    *sm.last = last;
  }
  named_sync(kMergeBar, kThreads);
  if (!*sm.last) return;
  __threadfence();

  // The last CTA of the row tile merges every split's partial in split
  // order: first each row's weights 2^(m_s - max m) / sum, 0 for a split
  // with no allowed key (into Q's tile: both warpgroups are done with
  // it), then O, each thread 8 float4 of the tile's 128 x 64 at a time,
  // every split's in flight together.
  const int ct = threadIdx.x;
  const float* parts = p.ws + static_cast<long long>(w.group) * p.splits *
                                  kPartFloats;
  float* wt = reinterpret_cast<float*>(sm.q);   // [kBq][kMaxSplits]
  if (ct < kBq) {
    const float* ml = parts + kBq * kHd + ct;
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
  named_sync(kMergeBar, kThreads);
  constexpr int kVec = kBq * kHd / 4;            // float4 of a partial's O
  constexpr int kBatch = 8;
  const int rows_here = min(kBq, p.R - w.q0);
  for (int v0 = ct; v0 < kVec; v0 += kThreads * kBatch) {
    float4 acc[kBatch];
#pragma unroll
    for (int k = 0; k < kBatch; ++k) acc[k] = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int s = 0; s < p.splits; ++s) {
      const float4* ps =
          reinterpret_cast<const float4*>(parts + s * kPartFloats);
      float4 v[kBatch];
#pragma unroll
      for (int k = 0; k < kBatch; ++k) {
        const int vi = v0 + k * kThreads;
        v[k] = vi / (kHd / 4) < rows_here ? __ldcg(ps + vi)
                                          : make_float4(0.f, 0.f, 0.f, 0.f);
      }
#pragma unroll
      for (int k = 0; k < kBatch; ++k) {
        const float wgt = wt[((v0 + k * kThreads) / (kHd / 4)) * kMaxSplits +
                             s];
        acc[k].x += wgt * v[k].x;
        acc[k].y += wgt * v[k].y;
        acc[k].z += wgt * v[k].z;
        acc[k].w += wgt * v[k].w;
      }
    }
#pragma unroll
    for (int k = 0; k < kBatch; ++k) {
      const int vi = v0 + k * kThreads;
      const int r = vi / (kHd / 4), c4 = vi % (kHd / 4);
      if (r < rows_here)
        *reinterpret_cast<uint2*>(p.out + row_offset(p, w, w.q0 + r) +
                                  4 * c4) =
            make_uint2(pack_bf16(acc[k].x, acc[k].y),
                       pack_bf16(acc[k].z, acc[k].w));
    }
  }
}

// One warpgroup: 64 folded rows from w.q0 + 64 wg, and side wg of every
// stage's fills.
template <typename T>
__device__ __forceinline__ void consume(const Params& p, const Smem& sm,
                                        const Maps& m, const Walk& w,
                                        int wg) {
  const int t = threadIdx.x % 128, warp = t / 32, lane = t % 32;
  const int row0 = 16 * warp + lane / 4;          // and row0 + 8
  const int first = w.q0 + 64 * wg;               // the warpgroup's row 0
  const int fr0 = first + row0, fr1 = fr0 + 8;
  const int LG = p.L * p.G;
  unsigned char* qtile = sm.q + wg * (kQPart / 2);

  // Q rows -> the warpgroup's swizzled rows (zeros past R)
  for (int c = t; c < 64 * 32; c += 128) {
    const int r = c / 32, j = c % 32, fr = first + r;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (fr < p.R)
      val = *reinterpret_cast<const uint4*>(p.q + row_offset(p, w, fr) +
                                            j * 8);
    *reinterpret_cast<uint4*>(qtile + (j / 8) * kQPart +
                              sw128(r, (j % 8) * 16)) = val;
  }
  fence_proxy_async();
  named_sync(1 + wg, 128);
  const uint64_t q_desc = desc_kmajor(smem_u32(qtile));
  // the batch rows of the warpgroup's rows (a suffix tile of another
  // batch row is skipped)
  const int wb_lo = first / LG, wb_hi = (min(first + 63, p.R - 1)) / LG;
  const int lane_col = 2 * (lane % 4);   // this lane's column in 8

  float o[2][64];                    // channel halves 0-127, 128-255
#pragma unroll
  for (int i = 0; i < 64; ++i) o[0][i] = o[1][i] = 0.f;
  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;

  for (int it = 0; it < w.n_total; ++it) {
    const int stage = it % kStages, parity = (it / kStages) & 1;
    const Tile tl = tile_at(p, w, it);
    const bool live = tl.main || (wb_lo <= tl.b && tl.b <= wb_hi);
    mbar_wait(sm.full + stage, parity);
    float s[32];
    if (live) {
      const uint64_t kd = desc_kmajor(smem_u32(sm.kv) + stage * kStageBytes);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 16; ++kk)              // S = Q K^T
        wgmma_ss_n64<0, 0>(s, step_kmajor(q_desc, kk, kQPart),
                           step_kmajor(kd, kk, kKPart), kk > 0);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(s);
    }
    if (t == 0) mbar_arrive(sm.empty + stage);
    // this side of tile it + 1 (a conversion overlaps the other
    // warpgroup's products)
    fill<T>(p, w, sm, m, it + 1, wg, t);
    __syncwarp();
    mbar_wait(sm.full + kStages + stage, parity);
    if (!live) {
      if (t == 0) mbar_arrive(sm.empty + kStages + stage);
      continue;
    }

    const int k0 = tl.k0;
    const bool scaled = quantized<T>() && tl.main;
    const float* sc = sm.scales + stage * kScaleFloats;
    // masks as per-row key limits relative to this lane's first column
    int rel0 = p.P, rel1 = p.P;
    bool masked = k0 + kBk > p.P;
    if (!tl.main) {   // the suffix of batch row tl.b, col <= r
      masked = true;
      rel0 = fr0 / LG == tl.b ? (fr0 % LG) / p.G + 1 : 0;
      rel1 = fr1 / LG == tl.b ? (fr1 % LG) / p.G + 1 : 0;
    }
    rel0 -= k0 + lane_col;
    rel1 -= k0 + lane_col;
    float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      float2 ksc = make_float2(p.scale_log2, p.scale_log2);
      if (scaled) {          // the key scale with sm_scale
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
    for (int j = 0; j < 8; ++j) {
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
        o[0][i] *= a0;
        o[0][i + 1] *= a0;
        o[1][i] *= a0;
        o[1][i + 1] *= a0;
      }
    }
    if (a1 != 1.f) {
#pragma unroll
      for (int i = 2; i < 64; i += 4) {
        o[0][i] *= a1;
        o[0][i + 1] *= a1;
        o[1][i] *= a1;
        o[1][i + 1] *= a1;
      }
    }
    uint32_t p16[4][4];
    to_a_frags(s, p16);
    const uint32_t v_tile = smem_u32(sm.kv) + stage * kStageBytes +
                            kTileBytes;
    wgmma_fence();
#pragma unroll
    for (int half = 0; half < 2; ++half) {         // O += P V
      const uint64_t vd = desc_mnmajor(v_tile + half * 2 * kKPart, kKPart);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        wgmma_rs_n128<1>(o[half], p16[j], step_mnmajor(vd, j), 1);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(o[0]);
    fence_regs(o[1]);
    fence_regs(p16);
    if (t == 0) mbar_arrive(sm.empty + kStages + stage);
  }

  l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
  l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
  epilogue(p, sm, w, wg, o, m0, m1, l0, l1);
}

template <typename T>
__global__ void __launch_bounds__(kThreads, 1)
shared_prefix_hd256_kernel(
    const __grid_constant__ CUtensorMap pkmap,   // prefix K (P, KV, 256)
    const __grid_constant__ CUtensorMap pvmap,   // prefix V
    const __grid_constant__ CUtensorMap skmap,   // suffix K (B, L, KV, 256)
    const __grid_constant__ CUtensorMap svmap,   // suffix V
    const Params p) {
  extern __shared__ unsigned char smem_raw[];
  const Smem sm = carve<T>(smem_raw);
  const Walk w = walk(p);
  const Maps m{&pkmap, &pvmap, &skmap, &svmap};
  if (threadIdx.x == 0) {
    for (int i = 0; i < 2 * kStages; ++i) {
      mbar_init(sm.full + i, 1);
      mbar_init(sm.empty + i, 2);      // one arrival per warpgroup
    }
    mbar_init(sm.raw_full, 1);
    mbar_init(sm.raw_full + 1, 1);
    fence_barrier_init();
  }
  __syncthreads();

  // the warpgroup index, uniform across each warp by construction
  const int wg = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);
  const int t = threadIdx.x % 128;
  if (t == 0) {
    tma_prefetch(wg ? m.pv : m.pk);
    tma_prefetch(wg ? m.sv : m.sk);
    if (quantized<T>() && w.n_main > 0) issue_raw<T>(w, sm, m, wg, 0);
  }
  fill<T>(p, w, sm, m, 0, wg, t);
  __syncwarp();
  consume<T>(p, sm, m, w, wg);
}

// Check the plan against the shapes and launch.
template <typename T>
int launch(const void* q, const void* pk, const void* pv, const void* pks,
           const void* pvs, const void* sk, const void* sv, void* out, int B,
           int L, int P, int H, int KV, float sm_scale, void* ws,
           long long ws_bytes, void* counters, int splits, void* stream) {
  static const cudaError_t attr = cudaFuncSetAttribute(
      shared_prefix_hd256_kernel<T>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes<T>());
  if (attr != cudaSuccess) return static_cast<int>(attr);
  if (KV <= 0 || H % KV != 0 || P < 0 ||
      (quantized<T>() && P > 0 && (pks == nullptr || pvs == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  if (B <= 0 || L <= 0) return 0;
  Params p{};
  p.q = static_cast<const bf16*>(q);
  p.out = static_cast<bf16*>(out);
  p.ks = static_cast<const float*>(pks);
  p.vs = static_cast<const float*>(pvs);
  p.ws = static_cast<float*>(ws);
  p.counters = static_cast<int*>(counters);
  p.B = B;
  p.L = L;
  p.H = H;
  p.KV = KV;
  p.G = H / KV;
  p.R = B * L * p.G;
  p.P = P;
  p.n_rt = (p.R + kBq - 1) / kBq;
  p.splits = splits;
  p.scale_log2 = sm_scale * kLog2e;
  const long long groups = static_cast<long long>(p.n_rt) * KV;
  const int key_tiles = (P + kBk - 1) / kBk;
  if (splits < 1 ||
      (splits > 1 && (splits > key_tiles || splits > kMaxSplits ||
                      ws == nullptr || counters == nullptr ||
                      ws_bytes < groups * splits * kPartFloats * 4LL)))
    return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap pkm, pvm, skm, svm;
  int err = encode_rows_map(&skm, sk, B, L, KV, kBk, kHd);
  if (!err) err = encode_rows_map(&svm, sv, B, L, KV, kBk, kHd);
  if (!err && P > 0) {
    if (quantized<T>()) {
      err = encode_map(&pkm, pk, 1, false, {raw_row_bytes<T>(), KV, P, 1},
                       {raw_row_bytes<T>(), 1, kBk, 1});
      if (!err)
        err = encode_map(&pvm, pv, 1, false, {raw_row_bytes<T>(), KV, P, 1},
                         {raw_row_bytes<T>(), 1, kBk, 1});
    } else {
      err = encode_rows_map(&pkm, pk, 1, P, KV, kBk, kHd);
      if (!err) err = encode_rows_map(&pvm, pv, 1, P, KV, kBk, kHd);
    }
  }
  if (err) return err;
  if (P == 0) {                        // no prefix: its maps are never read
    pkm = skm;
    pvm = svm;
  }
  const dim3 grid(static_cast<unsigned>(groups * splits));
  shared_prefix_hd256_kernel<T><<<grid, kThreads, smem_bytes<T>(),
                                  static_cast<cudaStream_t>(stream)>>>(
      pkm, pvm, skm, svm, p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// B5 at hd 256: q (B, L, H, 256); pk / pv the (P, KV, 256) prefix, bf16;
// sk / sv the (B, L, KV, 256) bf16 suffix; out (B, L, H, 256). ws: splits >
// 1, groups * splits partials of 128 * 256 + 256 floats (groups: KV *
// ceil(B L H / KV / 128) row tiles), ws_bytes its size; counters: splits >
// 1, one zeroed int per row tile (left zeroed); splits: of the prefix's
// 64-key tiles (1: none).
extern "C" int v3d_shared_prefix_attention_hd256(
    const void* q, const void* pk, const void* pv, const void* sk,
    const void* sv, void* out, int B, int L, int P, int H, int KV,
    float sm_scale, void* ws, long long ws_bytes, void* counters, int splits,
    void* stream) {
  return launch<bf16>(q, pk, pv, nullptr, nullptr, sk, sv, out, B, L, P, H,
                      KV, sm_scale, ws, ws_bytes, counters, splits, stream);
}

// ... over an int8 prefix, (P, KV, 256) bytes with (P, KV, 1) f32 scales
extern "C" int v3d_shared_prefix_attention_hd256_int8(
    const void* q, const void* pk, const void* pv, const void* pk_scale,
    const void* pv_scale, const void* sk, const void* sv, void* out, int B,
    int L, int P, int H, int KV, float sm_scale, void* ws, long long ws_bytes,
    void* counters, int splits, void* stream) {
  return launch<int8_t>(q, pk, pv, pk_scale, pv_scale, sk, sv, out, B, L, P,
                        H, KV, sm_scale, ws, ws_bytes, counters, splits,
                        stream);
}

// ... over a packed int4 prefix, (P, KV, 128) bytes with (P, KV, 1) scales
extern "C" int v3d_shared_prefix_attention_hd256_int4(
    const void* q, const void* pk, const void* pv, const void* pk_scale,
    const void* pv_scale, const void* sk, const void* sv, void* out, int B,
    int L, int P, int H, int KV, float sm_scale, void* ws, long long ws_bytes,
    void* counters, int splits, void* stream) {
  return launch<v3d_nib4>(q, pk, pv, pk_scale, pv_scale, sk, sv, out, B, L,
                          P, H, KV, sm_scale, ws, ws_bytes, counters, splits,
                          stream);
}
