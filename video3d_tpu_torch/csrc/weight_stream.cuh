// Weight-streaming product for decode-sized batches on Hopper, shared by
// kernel B8 (int4 weights, int4_matmul.cu), kernel B4's B>1 form (int8
// weights, int8_matmul.cu) and B4's one-row matvec (int8_matvec.cu, the
// B=1 vocab head; "One row" below): y (rows, out) = x (rows, in) @ W (in,
// out), bf16 x and y, 1-32 rows, every sum in f32 and one rounding at the
// end.
//
// What bounds it on an H100: HBM. A decode projection reads its whole
// quantized weight for a few rows of x: 2 * rows FLOP per weight element,
// far under the ~295 FLOP per byte where the tensor cores would bind. So
// each weight byte is read from HBM once for all rows, in runs long enough
// for the memory to stream them (512 contiguous bytes of a weight row), with
// enough in flight to cover its latency on every SM, and the weight is
// never widened in memory: int8 bytes and int4 nibbles are unpacked in
// registers straight into tensor-core fragments.
//
// Work. The output columns are cut into tiles of kTileCols (512), the
// inputs of a tile into stages (int8: 64 inputs; int4: 128, so a stage
// lies inside one scale group of 512 or more), and the stages of all
// tiles, tile-major, into `ctas` even contiguous ranges, one per CTA of a
// grid of at most one CTA per SM (kernels/quant_matvec.py, stream_plan,
// picks `ctas`; no CTA holds more than one stage over another). A CTA
// walks its range as segments, one per tile it touches: the whole tile, or
// a K-slice of it where its range begins or ends inside the tile.
//
// A CTA is a producer warp and four pairs of consumer warps; pair p owns
// columns 128 p .. 128 p + 127 of every tile (its subtile). One producer
// thread walks the CTA's stages through a ring of kRing slots, each with a
// full and an empty mbarrier, and loads by TMA, per stage, the four pairs'
// boxes of the same inputs, so a weight row is read 512 contiguous bytes
// at a time, and x's rows for those inputs (x is small; from L2). The
// weight's tensor map reads it in pair rows, inputs 2p and 2p + 1 in row
// p: int4, the packed (in / 2, out) bytes as they are; int8, the (in, out)
// bytes viewed as (in / 2, 2 out), whose row p holds input 2p's columns,
// then input 2p + 1's. A pair's part of a stage is one box of 128 columns
// x 64 pair rows (int4) or two boxes of 128 columns x 32 pair rows (int8:
// the even inputs at column c, the odd ones at out + c of the view), 8 KB;
// x's part is one or two boxes of 64 inputs x 8 kNT rows (rows past `rows`
// read as zeros). Every box is 128-byte swizzled: 16-byte chunk j of box
// row r lands at chunk j ^ (r % 8). TMA takes row strides and first
// columns of 16-byte multiples: in % 8 == 0 and out % 16 == 0.
//
// Products: bf16 mma.sync m16n8k16 with the weight as the A operand (16
// output columns x 16 inputs) and x as B (16 inputs x 8 rows of x), so at
// up to 8 rows every product is full; 9-16 and 17-32 rows take kNT = 2
// and 4 n-tiles. Warp h of a pair takes 64 of its 128 columns in 4 m-tiles:
// lane (g, t) (g = lane / 4, t = lane % 4) holds A rows g and g + 8 of
// m-tile i at columns 16 g + 8 h + i and 16 g + 8 h + 4 + i, so its 8 bytes
// of a box row feed all 4 m-tiles and its sums are 8 consecutive columns.
// The inputs of one mma step (16) are pair rows 8 j .. 8 j + 7 of the
// stage; k-slots (2t, 2t + 1) of the mma are pair row 8 j + 2t and slots
// (2t + 8, 2t + 9) pair row 8 j + 2t + 1, so the 8 lanes of a quarter-warp
// read 8 distinct swizzled chunks and a lane's x fragment is the 4
// consecutive inputs 16 j + 4t .. + 3 of a row (one 8-byte load, also
// conflict-free). An int4 byte is exactly the (2p, 2p + 1) bf16 pair of
// an A register (v3d_nibble_pairs, common.cuh: a nibble n becomes bf16
// 128 + (n + 8), then 136 is subtracted, both exact); an int8 pair is the
// same column's byte of the even and the odd box, each v = l - 128 b (b its
// top bit) made exactly as bf16 (128 + l) + bf16 (-128 - 128 b) by one
// bf16x2 add (int8_pairs).
//
// Order of the sums (fixed, no float atomics: bit-identical from run to
// run). A warp adds its columns' products over the segment's stages in
// input order in the mma accumulators; int4 multiplies the f32 sum of each
// stage (at 17-32 rows: of each 16-input step, so the partials fit the
// registers) by the group's f32 scale (a stage lies inside one group) and
// adds it to an f32 total in input order: the TPU kernel multiplies each
// whole group's sum instead. A whole tile is then scaled (int8: the f32
// column scale), rounded once and written from registers. A K-slice writes
// each pair's f32 sums to one of its CTA's two workspace slots (lanes
// whose rows are all past `rows` skip theirs); when the CTA's stream has
// ended (a gpu-scope fence waits for the SM's loads in flight), one thread
// per pair announces its slices on an arrival counter per subtile, and the
// last CTA to arrive (it resets the counter, so the wrapper zeroes the
// counters once per stream) adds the slices in slice (input) order, then
// scales, rounds and writes. No sum crosses warps.
//
// One row (row_stream_kernel, RowParams): the same producer, ring, plan
// walk, K-slices and merge, with three differences. The CTAs' ranges come
// from the host (kernels/quant_matvec.py, matvec_plan: the same weight
// bytes a CTA within one unit, a ragged tile or stage counted by its
// bytes) in the parameters. The consumers multiply on the CUDA cores, not
// the tensor cores, which would compute 8 rows of x to keep one: lane l
// of warp h of a pair takes the 16 columns of chunk l % 8 of the pair's
// subtile and inputs 8 G .. 8 G + 7 (G = 4 h + l / 8) of every stage, the
// even box's rows 4 G .. 4 G + 3 and the odd box's (8 conflict-free
// 16-byte loads: a quarter-warp reads one row's 8 chunks) and x's 8
// inputs (one broadcast load); the bytes become exact floats
// (v3d_int8x4_to_float) and bf16 x int8 products, exact in f32, are added
// in input order. At a segment's end a warp adds its four input groups,
// (G0 + G1) + (G2 + G3), by shuffles; the pair's two warps add theirs in
// warp order through shared memory; and the sums go to row 0 of the mma
// consumer's fragment, so write_y, the K-slices and merge are shared.
// The ring is kRing = 3 slots deep: 3 read the head fastest of 2 to 5 on
// an H100.

#pragma once

#include "flash_sm90.cuh"

namespace v3d_wstream {

using namespace v3d_sm90;

constexpr int kSubCols = 128;        // a pair's columns: one box row
constexpr int kPairs = 4;
constexpr int kTileCols = kPairs * kSubCols;   // 512 contiguous bytes a row
constexpr int kStageBytes = 8192;    // one pair's weights of a stage
constexpr int kRegionBytes = 4096;   // int8: each of its two boxes
constexpr int kXBytes = 8192;        // x's boxes of a stage, at most
constexpr int kSlotBytes = kPairs * kStageBytes + kXBytes;
constexpr int kXBox = 64;            // inputs of an x box: 128 bytes a row
constexpr int kConsumers = 64 * kPairs;       // threads of the 8 warps
constexpr int kThreads = kConsumers + 32;     // and the producer warp
constexpr int kMaxRows = 32;
constexpr int kMaxCtas = 256;        // one row: the begins it takes

// pair rows (two inputs each) of one stage
template <bool kInt4>
__host__ __device__ constexpr int stage_pairs() {
  return kInt4 ? kStageBytes / kSubCols : kRegionBytes / kSubCols;
}

// f32 sums of one pair over a K-slice of its columns: its share of a
// workspace slot (slice_at)
template <int kNT>
__host__ __device__ constexpr int frag_floats() {
  return 2 * 4 * kNT * 4 * 32;
}

struct Params {
  static constexpr int kRing = 5;     // ring slots: 200 KB per SM
  const bf16* x;          // (rows, in)
  const bf16* scale;      // int8 (1, out); int4 (in / group, out)
  bf16* y;                // (rows, out)
  float* ws;              // split tiles: two slots per CTA, kPairs
                          // frag_floats each
  int* counters;          // split tiles: kPairs per tile, left zeroed
  int rows, in, out, group;
  int tile_stages;        // stages of a tile's inputs: its units
  int ctas;
  int units;              // tiles x tile_stages; ctas x units < 2^31
};

// One row: x (1, in), int8 weights, the CTAs' ranges from the host
struct RowParams : Params {
  static constexpr int kRing = 3;
  int begin[kMaxCtas + 1];   // CTA c's units: [begin[c], begin[c + 1])
};

template <class P>
constexpr bool kOneRow = false;
template <>
constexpr bool kOneRow<RowParams> = true;

// ring, its full and empty barriers, the merge flags; one row: the pairs'
// exchange of their warps' sums (two buffers, 4 KB)
template <class P>
constexpr int smem_bytes() {
  return 1024 + P::kRing * kSlotBytes + 2 * P::kRing * 8 + 8 * 4 +
         (kOneRow<P> ? 2 * kPairs * 2 * 8 * 8 * 4 : 0);
}

__host__ __device__ __forceinline__ int unit_begin(const Params& p, int c) {
  return c * p.units / p.ctas;
}

__host__ __device__ __forceinline__ int unit_begin(const RowParams& p,
                                                   int c) {
  return p.begin[c];
}

// the CTA whose range holds unit u
__device__ __forceinline__ int cta_of(const Params& p, int u) {
  return ((u + 1) * p.ctas - 1) / p.units;
}

__device__ __forceinline__ int cta_of(const RowParams& p, int u) {
  int lo = 0, hi = p.ctas - 1;
  while (lo < hi) {
    const int mid = (lo + hi + 1) / 2;
    if (p.begin[mid] <= u) lo = mid;
    else hi = mid - 1;
  }
  return lo;
}

// workspace slot of CTA c's K-slice of `tile`: its first tile's slice, or
// the one it ends in
template <class P>
__device__ __forceinline__ int slot_of(const P& p, int c, int tile) {
  return 2 * c + (unit_begin(p, c) / p.tile_stages == tile ? 0 : 1);
}

struct Segment {
  int tile, s0, s1;       // stages [s0, s1) of tile
};

// This CTA's segments, in order.
template <class P>
struct Segments {
  const P& p;
  int u, end;
  __device__ explicit Segments(const P& params)
      : p(params), u(unit_begin(params, blockIdx.x)),
        end(unit_begin(params, blockIdx.x + 1)) {}
  __device__ bool next(Segment& sg) {
    if (u >= end) return false;
    sg.tile = u / p.tile_stages;
    const int t0 = sg.tile * p.tile_stages;
    sg.s0 = u - t0;
    sg.s1 = min(end, t0 + p.tile_stages) - t0;
    u = t0 + sg.s1;
    return true;
  }
};

__device__ __forceinline__ void fence_gpu() {
  asm volatile("fence.acq_rel.gpu;" ::: "memory");
}

// d += a (16 x 16 bf16, row-major) * b (16 x 8 bf16, column-major)
__device__ __forceinline__ void mma_bf16(float* d, const unsigned* a,
                                         unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// byte i of the even word e and the odd word o -> register r of m-tile i:
// the exact bf16 pair (even, odd). A byte v = l - 128 b (b its top bit, l
// its low 7) is bf16 0x4300 | l = 128 + l plus bf16 0xC300 | (b << 7) =
// -128 - 128 b, a sum that bf16 holds exactly.
__device__ __forceinline__ void int8_pairs(unsigned e, unsigned o,
                                           unsigned (&a)[4][4], int r) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const unsigned v = __byte_perm(e, o, 0x4400 + 0x1100 * i + 0x0011 * i);
    const unsigned l = (v & 0x007F007Fu) | 0x43004300u;
    const unsigned b = (v & 0x00800080u) | 0xC300C300u;
    const __nv_bfloat162 sum = __hadd2(
        *reinterpret_cast<const __nv_bfloat162*>(&l),
        *reinterpret_cast<const __nv_bfloat162*>(&b));
    a[i][r] = *reinterpret_cast<const unsigned*>(&sum);
  }
}

// The CTA's stages in order, each into the next ring slot: the four pairs'
// boxes of the tile's column subtiles (int8: the even and the odd box) and
// x's boxes of the stage's inputs (rows past `rows` read as zeros).
template <bool kInt4, int kNT, class P>
__device__ void produce(const P& p, const CUtensorMap* wmap,
                        const CUtensorMap* xmap, unsigned char* ring,
                        uint64_t* full, uint64_t* empty) {
  constexpr int kXBoxes = 2 * stage_pairs<kInt4>() / kXBox;
  constexpr int kXBoxBytes = 128 * 8 * kNT;
  Segments<P> segs(p);
  Segment sg;
  int q = 0;
  while (segs.next(sg)) {
    for (int s = sg.s0; s < sg.s1; ++s, ++q) {
      const int slot = q % P::kRing;
      mbar_wait(empty + slot, ((q / P::kRing) & 1) ^ 1);
      mbar_arrive_tx(full + slot,
                     kPairs * kStageBytes + kXBoxes * kXBoxBytes);
      unsigned char* dst = ring + slot * kSlotBytes;
      const int p0 = s * stage_pairs<kInt4>();
#pragma unroll
      for (int pr = 0; pr < kPairs; ++pr) {
        const int c0 = sg.tile * kTileCols + pr * kSubCols;
        tma_load(dst + pr * kStageBytes, wmap, full + slot, c0, p0, 0, 0);
        if (!kInt4)
          tma_load(dst + pr * kStageBytes + kRegionBytes, wmap, full + slot,
                   p.out + c0, p0, 0, 0);
      }
#pragma unroll
      for (int xb = 0; xb < kXBoxes; ++xb)
        tma_load(dst + kPairs * kStageBytes + xb * kXBoxBytes, xmap,
                 full + slot, 2 * p0 + xb * kXBox, 0, 0, 0);
    }
  }
}

// A pair's warp over one stage (inputs k0 ..): the products go into acc
// (int8), or, times the group's scales, into acc through f32 partials of
// the stage (int4; at 17-32 rows partials of each 16-input step, so that
// they fit the 168 registers a thread gets: 9 warps put 3 on some quarter
// of the SM's register file). st: the pair's weights; xs: x's boxes
// (128-byte rows of 64 inputs, swizzled, row 8 n + g of n-tile n); off0 /
// off1: this lane's 8 bytes of pair rows 2t and 2t + 1 of mma step 0 (step
// j is 1024 j bytes on: its rows 8 j + 2t (+1) keep the swizzle phase);
// col: its first column (rows g take col + i, rows g + 8 col + 4 + i).
template <bool kInt4, int kNT>
__device__ __forceinline__ void stage_pass(const Params& p,
                                           const unsigned char* st,
                                           const unsigned char* xs, int k0,
                                           int off0, int off1, int g, int t,
                                           int col,
                                           float (&acc)[4][kNT][4]) {
  constexpr int kSteps = stage_pairs<kInt4>() / 8;
  constexpr bool kStepFold = kInt4 && kNT > 2;
  float sc[8];
  if constexpr (kInt4) {
    // the group's f32 scales of columns col .. col + 7; out % 16 == 0, so
    // all of them or none
    if (col < p.out) {
      const bf16* sp =
          p.scale + static_cast<long long>(k0 / p.group) * p.out + col;
      v3d_bf16x8_to_float(__ldg(reinterpret_cast<const uint4*>(sp)), sc);
    } else {
#pragma unroll
      for (int i = 0; i < 8; ++i) sc[i] = 0.f;
    }
  }
  float part[4][kNT][4];
  if constexpr (kInt4 && !kStepFold) {
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int n = 0; n < kNT; ++n)
#pragma unroll
        for (int c = 0; c < 4; ++c) part[i][n][c] = 0.f;
  }
#pragma unroll
  for (int j = 0; j < kSteps; ++j) {
    // inputs 16 j + 4t .. + 3 of the stage: box j / 4, bytes 32 (j % 4) + 8t
    const unsigned char* xb = xs + (j / 4) * (128 * 8 * kNT);
    unsigned b[kNT][2];
#pragma unroll
    for (int n = 0; n < kNT; ++n) {
      const uint2 v = *reinterpret_cast<const uint2*>(
          xb + sw128(8 * n + g, 32 * (j % 4) + 8 * t));
      b[n][0] = v.x;
      b[n][1] = v.y;
    }
    const uint2 w0 = *reinterpret_cast<const uint2*>(st + off0 + 1024 * j);
    const uint2 w1 = *reinterpret_cast<const uint2*>(st + off1 + 1024 * j);
    unsigned a[4][4];
    if constexpr (kInt4) {
      unsigned lo[4], hi[4];
      v3d_nibble_pairs(w0.x, lo);
      v3d_nibble_pairs(w0.y, hi);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        a[i][0] = lo[i];
        a[i][1] = hi[i];
      }
      v3d_nibble_pairs(w1.x, lo);
      v3d_nibble_pairs(w1.y, hi);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        a[i][2] = lo[i];
        a[i][3] = hi[i];
      }
    } else {
      const uint2 o0 = *reinterpret_cast<const uint2*>(
          st + kRegionBytes + off0 + 1024 * j);
      const uint2 o1 = *reinterpret_cast<const uint2*>(
          st + kRegionBytes + off1 + 1024 * j);
      int8_pairs(w0.x, o0.x, a, 0);
      int8_pairs(w0.y, o0.y, a, 1);
      int8_pairs(w1.x, o1.x, a, 2);
      int8_pairs(w1.y, o1.y, a, 3);
    }
#pragma unroll
    for (int n = 0; n < kNT; ++n) {
      if constexpr (kStepFold) {
        float d[4][4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
#pragma unroll
          for (int c = 0; c < 4; ++c) d[i][c] = 0.f;
          mma_bf16(d[i], a[i], b[n][0], b[n][1]);
          acc[i][n][0] = fmaf(d[i][0], sc[i], acc[i][n][0]);
          acc[i][n][1] = fmaf(d[i][1], sc[i], acc[i][n][1]);
          acc[i][n][2] = fmaf(d[i][2], sc[4 + i], acc[i][n][2]);
          acc[i][n][3] = fmaf(d[i][3], sc[4 + i], acc[i][n][3]);
        }
      } else {
#pragma unroll
        for (int i = 0; i < 4; ++i)
          mma_bf16(kInt4 ? part[i][n] : acc[i][n], a[i], b[n][0], b[n][1]);
      }
    }
  }
  if constexpr (kInt4 && !kStepFold) {
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int n = 0; n < kNT; ++n) {
        acc[i][n][0] = fmaf(part[i][n][0], sc[i], acc[i][n][0]);
        acc[i][n][1] = fmaf(part[i][n][1], sc[i], acc[i][n][1]);
        acc[i][n][2] = fmaf(part[i][n][2], sc[4 + i], acc[i][n][2]);
        acc[i][n][3] = fmaf(part[i][n][3], sc[4 + i], acc[i][n][3]);
      }
  }
}

// Lane (g, t) of a pair's warp holds rows 2t, 2t + 1 (+ 8 n) of its
// columns col .. col + 7: accumulator c of m-tile i sits at row 2t + c % 2,
// column col + 4 (c / 2) + i. In the workspace a pair's slice is stored as
// float4s (the four accumulators of one m-tile and n-tile) in the order
// (warp h, m-tile i, n-tile n, lane): frag_floats per pair.
template <int kNT, class P>
__device__ __forceinline__ float4* slice_at(const P& p, int slot,
                                            int pair, int h, int lane) {
  constexpr int kF = frag_floats<kNT>();
  return reinterpret_cast<float4*>(
             p.ws + (static_cast<long long>(slot) * kPairs + pair) * kF +
             h * (kF / 2)) + lane;
}

// Scales (int8), rounds and writes this lane's sums of columns col ..
// col + 7, 16 bytes per row.
template <bool kInt4, int kNT, class P>
__device__ __forceinline__ void write_y(const P& p,
                                        const float (&acc)[4][kNT][4],
                                        int col, int t) {
  if (col >= p.out) return;
  float sc[8];
  if constexpr (!kInt4)
    v3d_bf16x8_to_float(
        __ldg(reinterpret_cast<const uint4*>(p.scale + col)), sc);
#pragma unroll
  for (int n = 0; n < kNT; ++n)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = 8 * n + 2 * t + r;
      if (row >= p.rows) continue;
      float v[8];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        v[i] = acc[i][n][r];
        v[4 + i] = acc[i][n][2 + r];
      }
      if constexpr (!kInt4) {
#pragma unroll
        for (int i = 0; i < 8; ++i) v[i] *= sc[i];
      }
      *reinterpret_cast<uint4*>(p.y + static_cast<long long>(row) * p.out +
                                col) =
          make_uint4(pack_bf16(v[0], v[1]), pack_bf16(v[2], v[3]),
                     pack_bf16(v[4], v[5]), pack_bf16(v[6], v[7]));
    }
}

// The K-slices of `tile` held by CTAs first .. last, added in slice order
// into acc (this lane's fragment positions); a batch of slices is loaded
// before any of it is added, so their reads are in flight together. CTA
// c > first holds its slice in its first slot (its range begins in the
// tile).
template <int kNT, class P>
__device__ __forceinline__ void merge(const P& p, int tile, int first,
                                      int last, int pair, int h, int lane,
                                      float (&acc)[4][kNT][4]) {
  constexpr int kBatch = 4 / kNT > 0 ? 4 / kNT : 1;
  // lanes whose rows of n-tile n are all past `rows` neither store nor
  // read (at one row of x, 8 of 32 lanes)
  const int live = p.rows - 2 * (lane % 4);
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int n = 0; n < kNT; ++n)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[i][n][c] = 0.f;
  for (int c0 = first; c0 <= last; c0 += kBatch) {
    float4 v[kBatch][4][kNT];
#pragma unroll
    for (int k = 0; k < kBatch; ++k) {
      if (c0 + k > last) break;
      const int slot = c0 + k == first ? slot_of(p, first, tile)
                                       : 2 * (c0 + k);
      const float4* src = slice_at<kNT>(p, slot, pair, h, lane);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int n = 0; n < kNT; ++n)
          v[k][i][n] = 8 * n < live ? __ldcg(src + (i * kNT + n) * 32)
                                    : make_float4(0.f, 0.f, 0.f, 0.f);
    }
#pragma unroll
    for (int k = 0; k < kBatch; ++k) {
      if (c0 + k > last) break;
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int n = 0; n < kNT; ++n) {
          acc[i][n][0] += v[k][i][n].x;
          acc[i][n][1] += v[k][i][n].y;
          acc[i][n][2] += v[k][i][n].z;
          acc[i][n][3] += v[k][i][n].w;
        }
    }
  }
}

// One row: a segment's stages on the CUDA cores (the header's "One row"),
// then its sums in row 0 of the fragment acc. q: the CTA's stages so far;
// xch: the pairs' exchange buffers, buffer `buf` this segment (the pair's
// warps meet once a segment, so the other buffer is free).
__device__ __forceinline__ void row_segment(const RowParams& p,
                                            const Segment& sg, int& q,
                                            const unsigned char* ring,
                                            uint64_t* full, uint64_t* empty,
                                            float* xch, int buf, int pair,
                                            int h, int lane,
                                            float (&acc)[4][1][4]) {
  const int j = lane % 8, grp = 4 * h + lane / 8;
  float f[16];
#pragma unroll
  for (int i = 0; i < 16; ++i) f[i] = 0.f;
  for (int s = sg.s0; s < sg.s1; ++s, ++q) {
    const int slot = q % RowParams::kRing;
    mbar_wait(full + slot, (q / RowParams::kRing) & 1);
    const unsigned char* st = ring + slot * kSlotBytes;
    const unsigned char* ws = st + pair * kStageBytes;
    uint4 w[8];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int off = sw128(4 * grp + k, 16 * j);
      w[2 * k] = *reinterpret_cast<const uint4*>(ws + off);
      w[2 * k + 1] =
          *reinterpret_cast<const uint4*>(ws + kRegionBytes + off);
    }
    float xf[8];     // inputs 8 grp ..: chunk grp of x's row 0
    v3d_bf16x8_to_float(*reinterpret_cast<const uint4*>(
        st + kPairs * kStageBytes + 16 * grp), xf);
#pragma unroll
    for (int r = 0; r < 8; ++r) {
      float v[16];
      v3d_int8x4_to_float(w[r].x, v);
      v3d_int8x4_to_float(w[r].y, v + 4);
      v3d_int8x4_to_float(w[r].z, v + 8);
      v3d_int8x4_to_float(w[r].w, v + 12);
#pragma unroll
      for (int i = 0; i < 16; ++i) f[i] = fmaf(xf[r], v[i], f[i]);
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(empty + slot);
  }
  // the warp's input groups: (G0 + G1) + (G2 + G3), the same on all four
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    f[i] += __shfl_xor_sync(0xffffffffu, f[i], 8);
    f[i] += __shfl_xor_sync(0xffffffffu, f[i], 16);
  }
  // lanes 0-7 hand the other warp its half of their chunk (warp h keeps
  // columns 16 j + 8 h .. + 7: where the mma consumer keeps them)
  float* x0 = xch + (buf * kPairs + pair) * 2 * 64;
  if (lane < 8) {
    float4* o = reinterpret_cast<float4*>(x0 + h * 64 + 8 * lane);
    o[0] = h ? make_float4(f[0], f[1], f[2], f[3])
             : make_float4(f[8], f[9], f[10], f[11]);
    o[1] = h ? make_float4(f[4], f[5], f[6], f[7])
             : make_float4(f[12], f[13], f[14], f[15]);
  }
  named_sync(1 + pair, 64);
  // lane (g, t = 0) takes columns 16 g + 8 h .. + 7: its own warp's sums
  // from lane g, the other warp's from shared memory, warp 0's first
  const int g = lane / 4;
  float mine[8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
    mine[i] = __shfl_sync(0xffffffffu, h ? f[8 + i] : f[i], g);
  const float4* other =
      reinterpret_cast<const float4*>(x0 + (1 - h) * 64 + 8 * g);
  const float4 o0 = other[0], o1 = other[1];
  const float theirs[8] = {o0.x, o0.y, o0.z, o0.w, o1.x, o1.y, o1.z, o1.w};
  const bool row0 = lane % 4 == 0;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    acc[i][0][0] = !row0 ? 0.f : h ? theirs[i] + mine[i]
                                   : mine[i] + theirs[i];
    acc[i][0][2] = !row0 ? 0.f : h ? theirs[4 + i] + mine[4 + i]
                                   : mine[4 + i] + theirs[4 + i];
    acc[i][0][1] = acc[i][0][3] = 0.f;
  }
}

template <bool kInt4, int kNT, class P>
__device__ void consume(const P& p, const unsigned char* ring,
                        uint64_t* full, uint64_t* empty, int* flags,
                        float* xch) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int pair = warp / 2, h = warp % 2, g = lane / 4, t = lane % 4;
  const int off0 = sw128(2 * t, 16 * g) + 8 * h;
  const int off1 = sw128(2 * t + 1, 16 * g) + 8 * h;
  const int sub = pair * kSubCols + 16 * g + 8 * h;   // col within a tile
  // K-slices (a CTA has at most two: its first and its last segment) are
  // stored as they end and announced when the CTA's stream has ended: a
  // gpu-scope fence waits for the SM's loads in flight
  int pend_tile[2], pend_first[2], pend_last[2];
  int pending = 0;
  Segments<P> segs(p);
  Segment sg;
  int q = 0, nseg = 0;
  while (segs.next(sg)) {
    float acc[4][kNT][4];
    const int col = sg.tile * kTileCols + sub;
    if constexpr (kOneRow<P>) {
      row_segment(p, sg, q, ring, full, empty, xch, nseg++ & 1, pair, h,
                  lane, acc);
    } else {
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int n = 0; n < kNT; ++n)
#pragma unroll
          for (int c = 0; c < 4; ++c) acc[i][n][c] = 0.f;
      for (int s = sg.s0; s < sg.s1; ++s, ++q) {
        const int slot = q % P::kRing;
        mbar_wait(full + slot, (q / P::kRing) & 1);
        const unsigned char* st = ring + slot * kSlotBytes;
        const unsigned char* ws = st + pair * kStageBytes;
        const unsigned char* xs = st + kPairs * kStageBytes;
        const int k0 = s * 2 * stage_pairs<kInt4>();
        stage_pass<kInt4, kNT>(p, ws, xs, k0, off0, off1, g, t, col, acc);
        __syncwarp();
        if (lane == 0) mbar_arrive(empty + slot);
      }
    }
    const int tu0 = sg.tile * p.tile_stages;
    const int first = cta_of(p, tu0);
    const int last = cta_of(p, tu0 + p.tile_stages - 1);
    if (first == last) {
      write_y<kInt4, kNT>(p, acc, col, t);
      continue;
    }
    float4* mine = slice_at<kNT>(p, slot_of(p, blockIdx.x, sg.tile), pair,
                                 h, lane);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int n = 0; n < kNT; ++n)
        if (8 * n < p.rows - 2 * t) mine[(i * kNT + n) * 32] =
            make_float4(acc[i][n][0], acc[i][n][1], acc[i][n][2],
                        acc[i][n][3]);
    pend_tile[pending] = sg.tile;
    pend_first[pending] = first;
    pend_last[pending] = last;
    ++pending;
  }
  if (pending == 0) return;
  // the pair's stores come before the barrier; one thread's gpu-scope fence
  // releases them all ahead of its arrivals (and acquires the other
  // slices' stores for the pair where it arrives last)
  named_sync(1 + pair, 64);
  if (h == 0 && lane == 0) {
    fence_gpu();
    bool any = false;
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      if (k >= pending) break;
      int* counter = p.counters + pend_tile[k] * kPairs + pair;
      const bool done =
          atomicAdd(counter, 1) == pend_last[k] - pend_first[k];
      if (done) *counter = 0;          // the next launch finds it zeroed
      flags[2 * pair + k] = done;
      any |= done;
    }
    if (any) fence_gpu();
  }
  named_sync(1 + pair, 64);
#pragma unroll
  for (int k = 0; k < 2; ++k) {
    if (k >= pending) break;
    if (!flags[2 * pair + k]) continue;
    float acc[4][kNT][4];
    merge<kNT>(p, pend_tile[k], pend_first[k], pend_last[k], pair, h, lane,
               acc);
    write_y<kInt4, kNT>(p, acc, pend_tile[k] * kTileCols + sub, t);
  }
}

// The ring, the producer thread and the consumer warps of one CTA.
template <bool kInt4, int kNT, class P>
__device__ __forceinline__ void stream_cta(const CUtensorMap& wmap,
                                           const CUtensorMap& xmap,
                                           const P& p) {
  extern __shared__ unsigned char smem_raw[];
  const uint32_t a = smem_u32(smem_raw);
  unsigned char* ring = smem_raw + (((a + 1023) & ~1023u) - a);
  uint64_t* full =
      reinterpret_cast<uint64_t*>(ring + P::kRing * kSlotBytes);
  uint64_t* empty = full + P::kRing;
  int* flags = reinterpret_cast<int*>(empty + P::kRing);
  if (threadIdx.x == 0) {
    for (int i = 0; i < P::kRing; ++i) {
      mbar_init(full + i, 1);
      mbar_init(empty + i, 2 * kPairs);    // every consumer warp
    }
    fence_barrier_init();
  }
  __syncthreads();
  if (threadIdx.x >= kConsumers) {
    if (threadIdx.x == kConsumers) {
      tma_prefetch(&wmap);
      tma_prefetch(&xmap);
      produce<kInt4, kNT>(p, &wmap, &xmap, ring, full, empty);
    }
    return;
  }
  consume<kInt4, kNT>(p, ring, full, empty, flags,
                      reinterpret_cast<float*>(flags + 8));
}

template <bool kInt4, int kNT>
__global__ void __launch_bounds__(kThreads, 1)
weight_stream_kernel(const __grid_constant__ CUtensorMap wmap,
                     const __grid_constant__ CUtensorMap xmap,
                     const __grid_constant__ Params p) {
  stream_cta<kInt4, kNT>(wmap, xmap, p);
}

// P = RowParams; a template, so that only the source that launches it
// (int8_matvec.cu) compiles it
template <class P>
__global__ void __launch_bounds__(kThreads, 1)
row_stream_kernel(const __grid_constant__ CUtensorMap wmap,
                  const __grid_constant__ CUtensorMap xmap,
                  const __grid_constant__ P p) {
  stream_cta<false, 1>(wmap, xmap, p);
}

// Encodes x's tensor map ((in, rows) bf16 in swizzled boxes of kXBox
// inputs x 8 kNT rows) and launches.
template <bool kInt4, int kNT, class P>
int launch(const CUtensorMap& wmap, const P& p, cudaStream_t stream) {
  const auto kernel = [] {
    if constexpr (kOneRow<P>) return row_stream_kernel<P>;
    else return weight_stream_kernel<kInt4, kNT>;
  }();
  static const cudaError_t attr = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem_bytes<P>());
  if (attr != cudaSuccess) return static_cast<int>(attr);
  CUtensorMap xmap;
  const int err = encode_map(&xmap, p.x, 2, true, {p.in, p.rows, 1, 1},
                             {kXBox, 8 * kNT, 1, 1});
  if (err) return err;
  kernel<<<p.ctas, kThreads, smem_bytes<P>(), stream>>>(wmap, xmap, p);
  return static_cast<int>(cudaGetLastError());
}

// TMA takes row strides and first columns of 16-byte multiples: x's rows
// (in % 8), the weight's rows (int4) and the odd box (int8, out % 16)
template <bool kInt4>
bool shapes_ok(int rows, int in, int out, int group) {
  constexpr int kStageInputs = 2 * stage_pairs<kInt4>();
  return rows >= 1 && rows <= kMaxRows && in > 0 && in % 8 == 0 &&
         out > 0 && out % 16 == 0 &&
         (!kInt4 || (group > 0 && group % kStageInputs == 0 &&
                     in % group == 0));
}

// Fills the parameters every form shares but the grid; returns the units
// (tiles x tile_stages).
template <bool kInt4>
long long fill(Params& p, const void* x, const void* scale, void* y,
               void* ws, void* counters, int rows, int in, int out,
               int group) {
  p.x = static_cast<const bf16*>(x);
  p.scale = static_cast<const bf16*>(scale);
  p.y = static_cast<bf16*>(y);
  p.ws = static_cast<float*>(ws);
  p.counters = static_cast<int*>(counters);
  p.rows = rows;
  p.in = in;
  p.out = out;
  p.group = kInt4 ? group : 0;
  p.tile_stages = (in + 2 * stage_pairs<kInt4>() - 1) /
                  (2 * stage_pairs<kInt4>());
  return static_cast<long long>((out + kTileCols - 1) / kTileCols) *
         p.tile_stages;
}

// Checks the workspace (ws_bytes bytes) and the counters (kPairs per
// output tile, zeroed) that a plan needs when a CTA's range begins inside
// a tile, encodes the weight's tensor map and launches.
template <bool kInt4, class P>
int launch_plan(const P& p, const void* w, long long ws_bytes, int nt,
                void* stream) {
  bool split = false;
  for (int c = 1; c < p.ctas && !split; ++c)
    split = unit_begin(p, c) % p.tile_stages != 0;
  const long long need = 2LL * p.ctas * kPairs * nt * frag_floats<1>() * 4;
  if (split && (p.ws == nullptr || p.counters == nullptr || ws_bytes < need))
    return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap wmap;
  const int err = kInt4
      ? encode_map(&wmap, w, 1, true, {p.out, p.in / 2, 1, 1},
                   {kSubCols, stage_pairs<true>(), 1, 1})
      : encode_map(&wmap, w, 1, true, {2LL * p.out, p.in / 2, 1, 1},
                   {kSubCols, stage_pairs<false>(), 1, 1});
  if (err) return err;
  auto st = static_cast<cudaStream_t>(stream);
  if (nt == 1) return launch<kInt4, 1>(wmap, p, st);
  if constexpr (!kOneRow<P>) {
    if (nt == 2) return launch<kInt4, 2>(wmap, p, st);
    return launch<kInt4, 4>(wmap, p, st);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// Checks the shapes and the plan (`ctas`) and launches; returns a
// cudaError_t.
template <bool kInt4>
int stream_matmul(const void* x, const void* w, const void* scale, void* y,
                  void* ws, long long ws_bytes, void* counters, int rows,
                  int in, int out, int group, int ctas, void* stream) {
  if (!shapes_ok<kInt4>(rows, in, out, group))
    return static_cast<int>(cudaErrorInvalidValue);
  Params p;
  const long long units =
      fill<kInt4>(p, x, scale, y, ws, counters, rows, in, out, group);
  if (units * (ctas + 1) >= (1LL << 31) || ctas < 1 || ctas > units)
    return static_cast<int>(cudaErrorInvalidValue);
  p.units = static_cast<int>(units);
  p.ctas = ctas;
  return launch_plan<kInt4>(p, w, ws_bytes,
                            rows <= 8 ? 1 : rows <= 16 ? 2 : 4, stream);
}

}  // namespace v3d_wstream
