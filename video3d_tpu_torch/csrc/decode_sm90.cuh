// Single-token decode attention on Hopper, shared by kernel B3 (the stacked
// flat cache, decode_attention.cu) and kernel B7 (stacked page pools,
// paged_attention.cu), each over a bf16, an int8 or a packed int4 cache.
// The two instantiate one kernel template with their own position ->
// cache row map (FlatRows, PagedRows in those files) and a head width:
// 128, or 256 (B3 and B7 at Gemma's width).
//
// Replaces: video3d_tpu/kernels/decode_attention.py::_decode_kernel_blockdiag
// (call :243) and video3d_tpu/kernels/paged_attention.py::_ragged_kernel
// (call :266), with their quantized forms.
//
// What it computes, per batch row (slot) b and kv head: the G = H / KV
// query heads kvh G .. kvh G + G - 1 (G <= 8) of the one new token attend
// the first kv_len[b] positions of the row; q is pre-scaled by hd^-0.5 and
// rounded to bf16, every sum is f32, the output is rounded once to bf16; a
// row with kv_len 0 gets zeros and no position at or past kv_len is read.
// Quantized caches: the score is the dot times the key's scale, a split's
// sum l is taken over the unscaled p, and p times the value's scale goes
// into P V.
//
// What bounds it on an H100: HBM (L2 for the aliased prefix pages of B7).
// A layer reads 2 kv_len KV hd values (bf16: 14 MB at kv_len 6812, KV 4)
// for ~4 FLOP per value. So the design keeps enough bytes in flight on
// every SM, spreads the positions evenly over every SM whatever the
// lengths, and keeps the issue of the copies and the arithmetic (the int8
// / int4 conversions above all) off the critical path.
//
// Work. The grid is `splits` CTAs per kv head (the wrapper plans it from
// the SM count, kernels/decode_attention.py, decode_plan). On the device
// every CTA reads kv_len, lays the live positions of all rows end to end
// (T in all) and takes positions [c T / splits, (c + 1) T / splits) of
// that line: the same number of positions, give or take one, whatever the
// lengths (a 32k row beside seven short ones spreads over the card like
// eight equal rows). A CTA walks its range as segments, one per row it
// touches: a whole row, or a slice of one where the range begins or ends
// inside it. A segment is cut into blocks of 16 positions, and the CTA's
// blocks go round-robin to its 8 warps.
//
// Each warp streams its own blocks through its own ring of kDepth
// shared-memory slots (2 bf16, 4 int8, 8 int4: ~130 KB per SM): it copies
// block i + kDepth - 1 while it computes block i (16-byte cp.async.cg
// copies of each position's row of this kv head, 256, 128 or 64 bytes of
// K and of V, and 4-byte copies of the f32 scales; rows past the
// segment's end are zero-filled without a read; one cp.async group per
// block). A warp that computes issues its own copies, so the issue rate
// grows with the warps (one producer warp issued a 64-position stage in
// ~1.7 us on the H100, slower than the card delivers it; 16-byte copies
// beat one bulk copy per row, whose issue took ~4 us a stage), and no
// barrier crosses warps. B7 reads the page-table entries of 32 pages at
// once, one per lane, ahead of the blocks that use them (one read per 32
// pages of a warp), and a block takes its (at most two) pages' first rows
// by two shuffles. K and V
// slots are swizzled in 16-byte chunks so that the fragment loads below
// hit distinct banks. The first segment's q is loaded before the first
// copies and converted after them; the next segment's while this one
// streams.
//
// Products on the tensor cores: mma.sync m16n8k16, bf16 (f16 in the int8
// form), f32 accumulators.
//   S^T (16 positions x 8 heads) = K (16 positions x 128) . Q^T: K is the
//   A operand and Q^T the B operand, so G <= 8 heads fill n = 8 and every
//   accumulator is live. The dims of a k-step are permuted so that a lane
//   reads whole 16-byte chunks of its rows (q_dim below gives the
//   permutation; Q's fragments, built once per segment, follow it).
//   O^T (128 x 8 heads) += V^T . P^T: V^T is the A operand (8 m-tiles of
//   16 dims), P^T the B operand. The S^T accumulators, packed to bf16, are
//   P's rows of positions; movmatrix transposes each 8 x 8 half into P^T's
//   fragment. V^T's fragments: bf16, ldmatrix.trans; int8 / int4, two
//   positions' bytes interleaved in registers (o_dim gives the dims of
//   each accumulator).
//   int4 values become bf16 exactly in registers (v3d_nibble_pairs,
//   common.cuh), int8 values f16 (half_products below: one splice under
//   0x64 and one subtraction per pair), so products q k are exact and only
//   the order of the sums differs from the plain version. p (times the
//   value's scale) is rounded to 16 bits for P V, as the TPU's int8 kernel
//   rounds it to bf16: bf16 in the bf16 and int4 forms, f16 in the int8
//   form; l sums p unrounded.
// Online softmax per warp in registers (base 2: the score times log2 e),
// the accumulators rescaled only when some head's running max moves.
//
// Merge. At a segment's end the 8 warps' (m, l, O) merge in warp order
// through shared memory. A whole row is normalised and written; a slice
// writes its f32 (m, l, O) to one of its CTA's two workspace slots (a
// CTA's first and last segments are the only ones that can be slices).
// When the CTA's stream has ended (a gpu-scope fence would otherwise wait
// for the copies in flight), one thread announces its slices on the
// arrival counter of (row, kv head) with a release-acquire atomic; the last
// CTA to arrive resets the counter (the wrapper zeroes the counters once
// per stream), brings the row's slices into its free rings by one bulk
// copy each and merges them in CTA order, so an output is bit-identical
// from run to run. With fewer live positions than CTAs (T < splits) some
// CTAs' ranges are empty, also between a row's first and last CTA: each
// non-empty range then holds one position, and a row's slices are those
// of the CTAs of its positions (slice_cta), one per position. At B=1 a row's 33 slices (120 KB) take that one SM
// ~2.6 us: its read rate, not latency, bounds the merge. One launch per
// call; the wrapper allocates only the output.
//
// Head width 256 (kWidth = 256, decode_hd256; B3 and B7 alike, so that a
// paged step and a dense one over the same values and capacity give the
// same bits, as at 128). What bounds it is the same: HBM (7.0 MB at
// Gemma-2B's kv_len 6812, one kv head, bf16). A position's
// kv-head row is two halves of 128 channels, and the 8 warps pair up into
// 4 units: a unit's two warps walk the same blocks, each copying and
// holding only its half of K and V (copy_half) in its own ring, so the
// rings, their depths and the shared memory are the hd-128 ones (~130 KB
// of rings; whole 256-channel rows at these depths would need ~256 KB),
// with the lane's q and O^T (64 f32) as at 128. A block's S^T is the sum
// of its halves' products: each warp writes its 16 x 8 sums to the unit's
// exchange, passes the pair's barrier (one a block: two buffers) and adds
// its partner's (block_pair), so both run the same softmax; each adds its
// half of P V. The units merge at a segment's end as the warps do at 128.
// A slice is then 8.3 KB (8 heads x 256 f32), and Gemma's one kv head puts
// all 132 CTAs on one row: one CTA merging 132 slices took ~0.17 us a
// slice (28 us a step), so at 256 a row's slices merge in two levels
// (merge_tree): groups of group_size(n) = ceil(sqrt(n)) consecutive
// slices, each group merged by its last CTA to arrive into the slot of
// its first slice, then the groups by the last group to arrive, all in a
// fixed order (132 slices: 11 groups of 12). The hd-256 body is a function
// of its own beside the hd-128 one, which stays as it was written:
// folding the width into the shared code (warp / 1, + 0 offsets, unused
// arguments) left the IR and hence the hd-128 kernels' SASS slightly
// different, and their SASS is held unchanged.

#pragma once

#include <cuda_fp16.h>

#include <type_traits>

#include "flash_sm90.cuh"

namespace v3d_decode {

using namespace v3d_sm90;

constexpr int kHd = 128;
constexpr int kMaxG = 8;
constexpr int kBlock = 16;                 // positions of a warp's block
constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kPartFloats = 2 * kMaxG + kMaxG * kHd;   // m, l, O of a slice
constexpr int kMergeBar = 1;               // named barrier of the CTA
constexpr int kMaxSplits = 256;            // CTAs per kv head
constexpr float kLog2e = 1.4426950408889634f;
// head width 256 (decode_hd256 below): a position's kv-head row is two
// halves of kHd channels, and the 8 warps are 4 units of two, one warp per
// half
constexpr int kHd256 = 2 * kHd;
constexpr int kUnits256 = kWarps / 2;
constexpr int kPartFloats256 = 2 * kMaxG + kMaxG * kHd256;
constexpr int kPairBar = 2;                // unit u syncs its pair on 2 + u
// hd 256: a row of more than kTreeMin slices merges in two levels, in at
// most kMaxGroups groups (group_size)
constexpr int kTreeMin = 12;
constexpr int kMaxGroups = 16;

// bytes of one kv head's row of a position, and a warp's ring depth
template <typename T>
struct Form;
template <>
struct Form<bf16> {
  static constexpr int kRowBytes = 256, kDepth = 2;
};
template <>
struct Form<int8_t> {
  static constexpr int kRowBytes = 128, kDepth = 4;
};
template <>
struct Form<v3d_nib4> {
  static constexpr int kRowBytes = 64, kDepth = 8;
};

template <typename T>
__host__ __device__ constexpr bool quantized() {
  return !std::is_same<T, bf16>::value;
}

// The int8 form runs its products in f16: an int8 byte becomes an exact f16
// in fewer operations than an exact bf16 (one splice under 0x64 and one
// subtraction per pair), q rounded to bf16 is an exact f16 for |q| in
// [2^-14, 65504], and p times the value's scale is rounded to f16 (11
// bits where bf16 keeps 8) after a multiplication by kPScale that keeps it
// out of f16's subnormals (exact: a power of two, divided out of O when a
// segment ends). The bf16 and int4 forms run in bf16.
template <typename T>
__host__ __device__ constexpr bool half_products() {
  return std::is_same<T, int8_t>::value;
}

template <typename T>
__host__ __device__ constexpr float p_scale() {
  return half_products<T>() ? 1024.f : 1.f;
}

// a ring slot: the block's K rows, its V rows, then (quantized) its 16
// key scales and 16 value scales
template <typename T>
__host__ __device__ constexpr int v_tile() {
  return kBlock * Form<T>::kRowBytes;
}

template <typename T>
__host__ __device__ constexpr int slot_bytes() {
  return 2 * v_tile<T>() + (quantized<T>() ? 2 * kBlock * 4 : 0);
}

// the warps' rings, their merge area, the arrival flags and the merge's
// barrier
template <typename T>
__host__ __device__ constexpr int smem_bytes() {
  return 128 + kWarps * Form<T>::kDepth * slot_bytes<T>() +
         kWarps * kPartFloats * 4 + 16;
}

// slices of a row that the rings and the merge area hold at once
template <typename T>
__host__ __device__ constexpr int merge_capacity() {
  return (kWarps * Form<T>::kDepth * slot_bytes<T>() +
          kWarps * kPartFloats * 4) / (kPartFloats * 4);
}

// byte offset of 16-byte chunk c of row r in a slot's K rows: bf16 and
// int8 flip the upper half of a row's 8-chunk bank window on odd rows (a
// quarter-warp reads chunks t + 4m of rows g, g + 1); int4 rows are 64
// bytes, two to a bank window
template <typename T>
__device__ __forceinline__ int k_off(int r, int c) {
  if constexpr (std::is_same<T, v3d_nib4>::value) return r * 64 + (c << 4);
  return r * Form<T>::kRowBytes + ((c ^ ((r & 1) << 2)) << 4);
}

// ... and in its V rows: bf16, the 128-byte swizzle (ldmatrix reads one
// chunk of 8 consecutive rows); int8, chunk c ^ (r & 6) (a quarter-warp
// reads chunks g, g + 1 of rows 2t); int4, rows paired into 128-byte
// lines whose chunk slots are flipped by the line (a half-warp reads
// 8-byte halves of chunks 0-1 of rows 2t)
template <typename T>
__device__ __forceinline__ int v_off(int r, int c) {
  if constexpr (std::is_same<T, bf16>::value)
    return r * 256 + ((c ^ (r & 7)) << 4);
  else if constexpr (std::is_same<T, int8_t>::value)
    return r * 128 + ((c ^ (r & 6)) << 4);
  else
    return (r >> 1) * 128 +
           (((((r & 1) << 2) + c) ^ (((r >> 1) & 3) << 1)) << 4);
}

// first of the 4 dims that lane t feeds at k-slots (2t, 2t + 1) of k-step
// j of S^T (then 2t + 8, 2t + 9 take the next two): the dims of the
// chunks a lane's K loads hold
template <typename T>
__device__ __forceinline__ int q_dim(int j, int t) {
  if constexpr (std::is_same<T, bf16>::value)
    return 32 * (j >> 1) + 8 * t + 4 * (j & 1);
  else if constexpr (std::is_same<T, int8_t>::value)
    return 64 * (j >> 2) + 16 * t + 4 * (j & 3);
  else
    return 32 * t + 8 * (j >> 1) + 4 * (j & 1);
}

// dim of O^T row g (hi 0) or g + 8 (hi 1) of m-tile m
template <typename T>
__device__ __forceinline__ int o_dim(int m, int g, int hi) {
  if constexpr (std::is_same<T, bf16>::value)
    return 16 * m + 8 * hi + g;
  else if constexpr (std::is_same<T, int8_t>::value)
    return 16 * g + 8 * hi + m;
  else
    return 16 * g + 8 * hi + 2 * (m & 3) + (m >> 2);
}

// ------------------------------------------------------------ primitives

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(dst),
               "l"(src), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src,
                                          int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;" ::"r"(dst),
               "l"(src), "r"(bytes)
               : "memory");
}

// one contiguous copy of `bytes` (a multiple of 16) from global into
// shared memory, counted in bytes on `bar`
__device__ __forceinline__ void bulk_copy(uint32_t dst, const void* src,
                                          int bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];" ::"r"(dst),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}

// this thread's cp.async groups: all but the newest kPending have landed
template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(kPending) : "memory");
}

__device__ __forceinline__ void ldsm_x4_trans(unsigned (&a)[4],
                                              uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];"
      : "=r"(a[0]), "=r"(a[1]), "=r"(a[2]), "=r"(a[3])
      : "r"(addr));
}

// the transpose of an 8 x 8 b16 matrix held as mma fragments
__device__ __forceinline__ unsigned movmatrix_t(unsigned x) {
  unsigned y;
  asm volatile("movmatrix.sync.aligned.m8n8.trans.b16 %0, %1;"
               : "=r"(y)
               : "r"(x));
  return y;
}

// d += a (16 x 16, row-major) * b (16 x 8, column-major), both bf16 or
// (kHalf) both f16
template <bool kHalf>
__device__ __forceinline__ void mma16816(float (&d)[4],
                                         const unsigned (&a)[4], unsigned b0,
                                         unsigned b1) {
  if constexpr (kHalf)
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  else
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two floats as the 16-bit pair of the form's products
template <bool kHalf>
__device__ __forceinline__ unsigned pack16(float lo, float hi) {
  if constexpr (kHalf) {
    const __half2 v = __floats2half2_rn(lo, hi);
    return *reinterpret_cast<const unsigned*>(&v);
  } else {
    return pack_bf16(lo, hi);
  }
}

// an f16 pair whose halves are 0x64 | u (1024 + u, u a byte with its top
// bit flipped: x + 128) -> the exact f16 pair of the int8 values x
__device__ __forceinline__ unsigned int8_f16x2(unsigned v) {
  const unsigned k = 0x64806480u;                   // (1152, 1152)
  const __half2 r = __hsub2(*reinterpret_cast<const __half2*>(&v),
                            *reinterpret_cast<const __half2*>(&k));
  return *reinterpret_cast<const unsigned*>(&r);
}

// old value of *p, after adding v, with release and acquire at gpu scope
__device__ __forceinline__ int atom_add_acq_rel(int* p, int v) {
  int old;
  asm volatile("atom.acq_rel.gpu.global.add.s32 %0, [%1], %2;"
               : "=r"(old)
               : "l"(p), "r"(v)
               : "memory");
  return old;
}

// ------------------------------------------------------------ the work

template <typename Map>
struct Params {
  const bf16* q;            // (B, 1, H, hd)
  const unsigned char* k;   // the stacked cache or pools, bytes
  const unsigned char* v;
  const float* k_scale;     // quantized: the stacked scales, else null
  const float* v_scale;
  const int* kv_len;        // (B,)
  bf16* out;                // (B, 1, H, hd)
  float* ws;                // 2 slots of kPartFloats per CTA
  int* counters;            // (B, KV), left zeroed
  Map map;
  int B, H, KV, G, cap, splits;
  float sm_scale;
};

struct Segment {
  int b;                    // the row
  int s0, s1;               // its positions [s0, s1)
  long long base;           // the row's first position in the line
  int n;                    // its live positions
  bool first_of_cta;        // the CTA's range begins in this row
};

// This CTA's segments, in order (the same walk in every thread).
template <typename Map>
struct Walk {
  const Params<Map>& p;
  long long total, p0, p1, acc;
  int b;
  __device__ Walk(const Params<Map>& params, int c)
      : p(params), total(0), acc(0), b(0) {
    for (int i = 0; i < p.B; ++i) total += len(i);
    p0 = c * total / p.splits;
    p1 = (c + 1) * total / p.splits;
  }
  __device__ int len(int i) const {
    return min(max(__ldg(p.kv_len + i), 0), p.cap);
  }
  // the CTA whose range holds position x of the line
  __device__ int cta_of(long long x) const {
    return static_cast<int>(((x + 1) * p.splits - 1) / total);
  }
  __device__ bool next(Segment& sg) {
    while (b < p.B && acc < p1) {
      const int n = len(b);
      const long long s0 = max(p0, acc), s1 = min(p1, acc + n);
      if (s0 < s1) {
        sg.b = b;
        sg.s0 = static_cast<int>(s0 - acc);
        sg.s1 = static_cast<int>(s1 - acc);
        sg.base = acc;
        sg.n = n;
        sg.first_of_cta = p0 >= acc;
        acc += n;
        ++b;
        return true;
      }
      acc += n;
      ++b;
    }
    return false;
  }
};

// A warp's blocks: every kWarps-th 16-position block of the CTA's walk,
// from block `first` on. `seg` numbers the segment of the current block;
// `cur` holds what the map read for it (B7: a window of 32 page entries,
// kept while the warp's blocks stay inside it).
template <typename Map>
struct Blocks {
  const Params<Map>& p;
  Walk<Map> walk;
  Segment sg;
  bool has;
  int pos, seg;
  typename Map::Cursor cur;
  // `start`: the CTA's walk before its first segment
  __device__ Blocks(const Params<Map>& params, const Walk<Map>& start,
                    int first)
      : p(params), walk(start), pos(0), seg(0), cur{} {
    has = walk.next(sg);
    if (has) pos = sg.s0;
    skip(first);
  }
  __device__ int n() const { return min(kBlock, sg.s1 - pos); }
  // k blocks on; `resolve`: the map's reads for the new block (the copies
  // need them, the consumer does not)
  __device__ void skip(int k, bool resolve = true) {
    while (has && k > 0) {
      const int left = (sg.s1 - pos + kBlock - 1) / kBlock;
      if (k < left) {
        pos += kBlock * k;
        k = 0;
      } else {
        k -= left;
        has = walk.next(sg);
        if (has) {
          pos = sg.s0;
          ++seg;
        }
      }
    }
    if (has && resolve) cur = p.map.begin(p, sg.b, pos, n(), sg.n, cur);
  }
};

// Lane l's copies of a block (its positions pos .. pos + n - 1 of row b)
// into a ring slot: 16-byte chunk l % kCh of rows l / kCh + j 32 / kCh of
// K and of V, and (quantized) the key scale of row l (l < 16) or the value
// scale of row l - 16; rows at or past n are zero-filled without a read.
// The map's shuffles (B7 with pages under 16 positions) run on every lane.
template <typename T, typename Map>
__device__ __forceinline__ void copy_block(const Params<Map>& p,
                                           const Blocks<Map>& bl,
                                           uint32_t slot, int lane) {
  constexpr int kRowBytes = Form<T>::kRowBytes;
  constexpr int kCh = kRowBytes / 16;
  constexpr int kRowsPerLane = kCh / 2;
  const int n = bl.n(), c = lane % kCh;
  const long long row_bytes = static_cast<long long>(p.KV) * kRowBytes;
  const unsigned char* kb = p.k + blockIdx.y * kRowBytes + c * 16;
  const unsigned char* vb = p.v + blockIdx.y * kRowBytes + c * 16;
  // every row's offset first, then the copies
  long long off[kRowsPerLane];
#pragma unroll
  for (int j = 0; j < kRowsPerLane; ++j) {
    const int r = lane / kCh + j * (32 / kCh);
    off[j] = p.map.row(p, bl.cur, bl.sg.b, bl.pos + r) * row_bytes;
  }
  long long si = 0;
  if constexpr (quantized<T>())
    si = p.map.scale(p, bl.cur, bl.sg.b, bl.pos + lane % kBlock);
#pragma unroll
  for (int j = 0; j < kRowsPerLane; ++j) {
    const int r = lane / kCh + j * (32 / kCh);
    const bool ok = r < n;
    cp_async16(slot + k_off<T>(r, c), ok ? kb + off[j] : kb, ok ? 16 : 0);
    cp_async16(slot + v_tile<T>() + v_off<T>(r, c), ok ? vb + off[j] : vb,
               ok ? 16 : 0);
  }
  if constexpr (quantized<T>()) {
    const bool ok = lane % kBlock < n;
    const float* src = lane < kBlock ? p.k_scale : p.v_scale;
    cp_async4(slot + 2 * v_tile<T>() + lane * 4, src + (ok ? si : 0),
              ok ? 4 : 0);
  }
}

// S^T's A fragments of the 8 k-steps for rows g (registers 0, 2) and
// g + 8 (1, 3) of a slot's K rows
template <typename T>
__device__ __forceinline__ void k_frags(const unsigned char* kt, int g, int t,
                                        unsigned (&a)[8][4]) {
  if constexpr (std::is_same<T, bf16>::value) {
#pragma unroll
    for (int m = 0; m < 4; ++m) {
      const uint4 x = *reinterpret_cast<const uint4*>(kt + k_off<T>(g, t + 4 * m));
      const uint4 y = *reinterpret_cast<const uint4*>(kt + k_off<T>(g + 8, t + 4 * m));
      a[2 * m][0] = x.x; a[2 * m][1] = y.x; a[2 * m][2] = x.y; a[2 * m][3] = y.y;
      a[2 * m + 1][0] = x.z; a[2 * m + 1][1] = y.z;
      a[2 * m + 1][2] = x.w; a[2 * m + 1][3] = y.w;
    }
  } else if constexpr (std::is_same<T, int8_t>::value) {
#pragma unroll
    for (int m = 0; m < 2; ++m) {
      const uint4 x = *reinterpret_cast<const uint4*>(kt + k_off<T>(g, t + 4 * m));
      const uint4 y = *reinterpret_cast<const uint4*>(kt + k_off<T>(g + 8, t + 4 * m));
      const unsigned xw[4] = {x.x, x.y, x.z, x.w}, yw[4] = {y.x, y.y, y.z, y.w};
#pragma unroll
      for (int w = 0; w < 4; ++w) {
        // bytes 0, 1 (and 2, 3) under 0x64, top bits flipped
        const unsigned xu = xw[w] ^ 0x80808080u, yu = yw[w] ^ 0x80808080u;
        a[4 * m + w][0] = int8_f16x2(__byte_perm(xu, 0x64646464u, 0x5140));
        a[4 * m + w][1] = int8_f16x2(__byte_perm(yu, 0x64646464u, 0x5140));
        a[4 * m + w][2] = int8_f16x2(__byte_perm(xu, 0x64646464u, 0x7362));
        a[4 * m + w][3] = int8_f16x2(__byte_perm(yu, 0x64646464u, 0x7362));
      }
    }
  } else {
    const uint4 x = *reinterpret_cast<const uint4*>(kt + k_off<T>(g, t));
    const uint4 y = *reinterpret_cast<const uint4*>(kt + k_off<T>(g + 8, t));
    const unsigned xw[4] = {x.x, x.y, x.z, x.w}, yw[4] = {y.x, y.y, y.z, y.w};
#pragma unroll
    for (int w = 0; w < 4; ++w) {
      unsigned px[4], py[4];
      v3d_nibble_pairs(xw[w], px);
      v3d_nibble_pairs(yw[w], py);
      a[2 * w][0] = px[0]; a[2 * w][1] = py[0];
      a[2 * w][2] = px[1]; a[2 * w][3] = py[1];
      a[2 * w + 1][0] = px[2]; a[2 * w + 1][1] = py[2];
      a[2 * w + 1][2] = px[3]; a[2 * w + 1][3] = py[3];
    }
  }
}

// V^T's A fragments of the 8 m-tiles (k-slots 2t, 2t + 1 in registers 0-1,
// 2t + 8, 2t + 9 in 2-3)
template <typename T>
__device__ __forceinline__ void v_frags(const unsigned char* vt, int lane,
                                        unsigned (&a)[8][4]) {
  const int g = lane / 4, t = lane % 4;
  if constexpr (std::is_same<T, bf16>::value) {
    const int r = ((lane >> 4) << 3) + (lane & 7);
    const uint32_t base = smem_u32(vt);
#pragma unroll
    for (int m = 0; m < 8; ++m)
      ldsm_x4_trans(a[m], base + v_off<T>(r, 2 * m + ((lane >> 3) & 1)));
  } else if constexpr (std::is_same<T, int8_t>::value) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const uint4 e = *reinterpret_cast<const uint4*>(vt + v_off<T>(2 * t + 8 * h, g));
      const uint4 o = *reinterpret_cast<const uint4*>(vt + v_off<T>(2 * t + 1 + 8 * h, g));
      const unsigned ew[4] = {e.x, e.y, e.z, e.w}, ow[4] = {o.x, o.y, o.z, o.w};
#pragma unroll
      for (int w = 0; w < 4; ++w) {
        // each word's bytes under 0x64 in pairs, top bits flipped; then
        // byte i of the even row beside byte i of the odd one
        const unsigned eu = ew[w] ^ 0x80808080u, ou = ow[w] ^ 0x80808080u;
        const unsigned e01 = __byte_perm(eu, 0x64646464u, 0x5140);
        const unsigned e23 = __byte_perm(eu, 0x64646464u, 0x7362);
        const unsigned o01 = __byte_perm(ou, 0x64646464u, 0x5140);
        const unsigned o23 = __byte_perm(ou, 0x64646464u, 0x7362);
        const int m0 = 4 * (w & 1), r = (w >> 1) + 2 * h;
        a[m0 + 0][r] = int8_f16x2(__byte_perm(e01, o01, 0x5410));
        a[m0 + 1][r] = int8_f16x2(__byte_perm(e01, o01, 0x7632));
        a[m0 + 2][r] = int8_f16x2(__byte_perm(e23, o23, 0x5410));
        a[m0 + 3][r] = int8_f16x2(__byte_perm(e23, o23, 0x7632));
      }
    }
  } else {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int re = 2 * t + 8 * h;
      const uint2 x = *reinterpret_cast<const uint2*>(vt + v_off<T>(re, g >> 1) + 8 * (g & 1));
      const uint2 y = *reinterpret_cast<const uint2*>(vt + v_off<T>(re + 1, g >> 1) + 8 * (g & 1));
      const unsigned xw[2] = {x.x, x.y}, yw[2] = {y.x, y.y};
#pragma unroll
      for (int w = 0; w < 2; ++w) {
        // byte k: (row 2t, row 2t + 1) nibbles of channel 2k (lo), 2k + 1 (hi)
        const unsigned lo = (xw[w] & 0x0F0F0F0Fu) | ((yw[w] & 0x0F0F0F0Fu) << 4);
        const unsigned hi = ((xw[w] >> 4) & 0x0F0F0F0Fu) | (yw[w] & 0xF0F0F0F0u);
        unsigned pl[4], ph[4];
        v3d_nibble_pairs(lo, pl);
        v3d_nibble_pairs(hi, ph);
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          a[k][w + 2 * h] = pl[k];
          a[4 + k][w + 2 * h] = ph[k];
        }
      }
    }
  }
}

// A warp's running state over a segment: lane (g, t) holds heads 2t, 2t + 1
// (m in base 2, l over its own positions) and O^T rows g, g + 8 of every
// m-tile for those heads.
struct WarpState {
  float m[2], l[2];
  float o[8][4];
  __device__ void reset() {
    m[0] = m[1] = V3D_NEG_INF;
    l[0] = l[1] = 0.f;
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int c = 0; c < 4; ++c) o[i][c] = 0.f;
  }
};

// One warp over the block in ring slot `sl` (K rows, V rows, scales),
// `live` of its 16 positions valid.
template <typename T>
__device__ __forceinline__ void block(const unsigned char* sl, int live,
                                      const unsigned (&qb)[8][2], int lane,
                                      WarpState& ws) {
  const int g = lane / 4, t = lane % 4;
  const float* scales = reinterpret_cast<const float*>(sl + 2 * v_tile<T>());
  unsigned a[8][4];
  k_frags<T>(sl, g, t, a);
  float s0[4] = {0.f, 0.f, 0.f, 0.f}, s1[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
  for (int j = 0; j < 8; j += 2) {
    mma16816<half_products<T>()>(s0, a[j], qb[j][0], qb[j][1]);
    mma16816<half_products<T>()>(s1, a[j + 1], qb[j + 1][0], qb[j + 1][1]);
  }
  // x[0], x[1]: position g, heads 2t, 2t + 1; x[2], x[3]: position g + 8
  float x[4];
#pragma unroll
  for (int c = 0; c < 4; ++c) x[c] = s0[c] + s1[c];
  if constexpr (quantized<T>()) {
    const float k0 = scales[g], k1 = scales[g + 8];
    x[0] *= k0; x[1] *= k0; x[2] *= k1; x[3] *= k1;
  }
#pragma unroll
  for (int c = 0; c < 4; ++c) x[c] *= kLog2e;
  const float masked = __int_as_float(0xff800000);   // -inf: p = 0
  if (g >= live) x[0] = x[1] = masked;
  if (g + 8 >= live) x[2] = x[3] = masked;
  float bm[2] = {fmaxf(x[0], x[2]), fmaxf(x[1], x[3])};
#pragma unroll
  for (int o = 4; o < 32; o <<= 1) {
    bm[0] = fmaxf(bm[0], __shfl_xor_sync(0xffffffffu, bm[0], o));
    bm[1] = fmaxf(bm[1], __shfl_xor_sync(0xffffffffu, bm[1], o));
  }
  float alpha[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const float mn = fmaxf(ws.m[h], bm[h]);
    alpha[h] = exp2f(ws.m[h] - mn);
    ws.m[h] = mn;
  }
  float pr[4];
#pragma unroll
  for (int c = 0; c < 4; ++c) pr[c] = exp2f(x[c] - ws.m[c & 1]);
  ws.l[0] = ws.l[0] * alpha[0] + (pr[0] + pr[2]);
  ws.l[1] = ws.l[1] * alpha[1] + (pr[1] + pr[3]);
  if (__any_sync(0xffffffffu, alpha[0] != 1.f || alpha[1] != 1.f)) {
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      ws.o[i][0] *= alpha[0];
      ws.o[i][1] *= alpha[1];
      ws.o[i][2] *= alpha[0];
      ws.o[i][3] *= alpha[1];
    }
  }
  if constexpr (quantized<T>()) {
    const float v0 = scales[kBlock + g] * p_scale<T>();
    const float v1 = scales[kBlock + g + 8] * p_scale<T>();
    pr[0] *= v0; pr[1] *= v0; pr[2] *= v1; pr[3] *= v1;
  }
  const unsigned b0 = movmatrix_t(pack16<half_products<T>()>(pr[0], pr[1]));
  const unsigned b1 = movmatrix_t(pack16<half_products<T>()>(pr[2], pr[3]));
  unsigned va[8][4];
  v_frags<T>(sl + v_tile<T>(), lane, va);
#pragma unroll
  for (int i = 0; i < 8; ++i)
    mma16816<half_products<T>()>(ws.o[i], va[i], b0, b1);
}

// Q^T's B fragments of head g (zeros past G) for the dims q_dim gives, in
// two steps so that the loads are in flight while the warp issues its
// copies: q_load reads the lane's 8 x 4 bf16 of q of row b, q_frags turns
// them into q times bf16(sm_scale), rounded to bf16
template <typename T, typename Map>
__device__ __forceinline__ void q_load(const Params<Map>& p, int b, int g,
                                       int t, uint2 (&raw)[8]) {
  const bf16* qh = p.q + (static_cast<long long>(b) * p.H +
                          blockIdx.y * p.G + g) * kHd;
#pragma unroll
  for (int j = 0; j < 8; ++j)
    raw[j] = g < p.G ? __ldg(reinterpret_cast<const uint2*>(qh + q_dim<T>(j, t)))
                     : make_uint2(0u, 0u);
}

template <typename T, typename Map>
__device__ __forceinline__ void q_frags(const Params<Map>& p, uint2 (&raw)[8],
                                        unsigned (&qb)[8][2]) {
  // the loads land here, not where the compiler would hoist the math
#pragma unroll
  for (int j = 0; j < 8; ++j)
    asm volatile("" : "+r"(raw[j].x), "+r"(raw[j].y));
  const float scale = __bfloat162float(__float2bfloat16(p.sm_scale));
  auto scaled = [&](float x) {
    return __bfloat162float(__float2bfloat16(x * scale));
  };
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const float2 lo = bf16_pair(raw[j].x), hi = bf16_pair(raw[j].y);
    qb[j][0] = pack16<half_products<T>()>(scaled(lo.x), scaled(lo.y));
    qb[j][1] = pack16<half_products<T>()>(scaled(hi.x), scaled(hi.y));
  }
}

// 4 dims d0 .. d0 + 3 of head h of this kv head's heads in row b
__device__ __forceinline__ bf16* out_at(bf16* out, int b, int H, int G,
                                        int h, int d0) {
  return out + (static_cast<long long>(b) * H + blockIdx.y * G + h) * kHd + d0;
}

__device__ __forceinline__ void write4(bf16* dst, float4 acc, float l) {
  const float inv = 1.f / fmaxf(l, 1e-30f);
  *reinterpret_cast<uint2*>(dst) = make_uint2(
      pack_bf16(acc.x * inv, acc.y * inv), pack_bf16(acc.z * inv, acc.w * inv));
}

__device__ __forceinline__ void fma4(float4& acc, float w, float4 u) {
  acc.x += w * u.x;
  acc.y += w * u.y;
  acc.z += w * u.z;
  acc.w += w * u.w;
}

// workspace slot `which` (0, 1) of CTA `cta`: m[8], l[8], O[8][128]
template <typename Map>
__device__ __forceinline__ float* part_at(const Params<Map>& p, int cta,
                                          int which) {
  return p.ws + (2LL * (blockIdx.y * p.splits + cta) + which) * kPartFloats;
}

// The warps' states of a segment, merged in warp order through shared
// memory (mw: kWarps parts of kPartFloats): a whole row is normalised and
// written, a slice goes to workspace slot `which` of this CTA. Thread tid
// takes head tid / 32, dims 4 (tid % 32) .. + 3.
template <typename T, typename Map>
__device__ void end_segment(const Params<Map>& p, int b, bool whole,
                            int which, WarpState& st, float* mw) {
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int o = 4; o < 32; o <<= 1)
      st.l[h] += __shfl_xor_sync(0xffffffffu, st.l[h], o);
  named_sync(kMergeBar, kThreads);        // the last segment's reads are done
  float* mine = mw + warp * kPartFloats;
  if (g == 0) {
    mine[2 * t] = st.m[0];
    mine[2 * t + 1] = st.m[1];
    mine[kMaxG + 2 * t] = st.l[0];
    mine[kMaxG + 2 * t + 1] = st.l[1];
  }
  float* mo = mine + 2 * kMaxG;
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int c = 0; c < 4; ++c)
      mo[(2 * t + (c & 1)) * kHd + o_dim<T>(i, g, c >> 1)] =
          st.o[i][c] * (1.f / p_scale<T>());
  named_sync(kMergeBar, kThreads);
  st.reset();
  const int h = tid / 32, d0 = 4 * (tid % 32);
  if (h >= p.G) return;
  float mx = V3D_NEG_INF;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) mx = fmaxf(mx, mw[w * kPartFloats + h]);
  float l = 0.f;
  float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    const float* part = mw + w * kPartFloats;
    const float wt = exp2f(part[h] - mx);
    l += wt * part[kMaxG + h];
    fma4(acc, wt, *reinterpret_cast<const float4*>(part + 2 * kMaxG + h * kHd + d0));
  }
  if (whole) {
    write4(out_at(p.out, b, p.H, p.G, h, d0), acc, l);
    return;
  }
  float* part = part_at(p, blockIdx.x, which);
  if (d0 == 0) {
    part[h] = mx;
    part[kMaxG + h] = l;
  }
  *reinterpret_cast<float4*>(part + 2 * kMaxG + h * kHd + d0) = acc;
}

// The CTA holding the k-th slice of a row whose positions begin at `base`
// on the line of `total` positions: first + k while every CTA holds a
// position (total >= splits), else the CTA of the row's k-th position.
__device__ __forceinline__ int slice_cta(int splits, int first, int k,
                                         long long base, long long total) {
  return total >= splits
             ? first + k
             : static_cast<int>(((base + k + 1) * splits - 1) / total);
}

// The n slices of row b (line positions from `base`, of `total`), the
// first held by CTA `first`, merged in CTA order and written (every
// thread calls it). A CTA after `first` holds its slice in its first slot
// (its range begins in the row), `first` in slot first_slot.
// The slices come into shared memory (buf: the rings and the merge area,
// free once the CTA's stream has ended, `cap` slices at a time), one bulk
// copy of the live heads' (m, l, O) each, counted on `bar` (its phase
// `phase`, flipped per round); then warp h takes head h, its lane i dims
// 4 i .. 4 i + 3, the max over the slices first and then their weighted
// sum in CTA order (each round rescaled onto the running max as in the
// online softmax).
template <typename Map>
__device__ void merge_row(const Params<Map>& p, int first, int n,
                          int first_slot, int b, long long base,
                          long long total, unsigned char* buf, int cap,
                          uint64_t* bar, int& phase) {
  const int tid = threadIdx.x, h = tid / 32, d0 = 4 * (tid % 32);
  const int bytes = (2 * kMaxG + p.G * kHd) * 4;
  const uint32_t buf_s = smem_u32(buf);
  const float* sl = reinterpret_cast<const float*>(buf);
  float mx = V3D_NEG_INF, l = 0.f;
  float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int c0 = 0; c0 < n; c0 += cap) {
    const int cnt = min(cap, n - c0);
    if (tid == 0) mbar_arrive_tx(bar, cnt * bytes);
    named_sync(kMergeBar, kThreads);
    if (tid < cnt) {
      const int c = slice_cta(p.splits, first, c0 + tid, base, total);
      // the slices were stored by other CTAs (acquired above): order
      // them before this thread's bulk copy
      asm volatile("fence.proxy.async.global;" ::: "memory");
      bulk_copy(buf_s + tid * kPartFloats * 4,
                part_at(p, c, c == first ? first_slot : 0), bytes, bar);
    }
    mbar_wait(bar, phase);
    phase ^= 1;
    if (h < p.G) {
      float mn = mx;
      for (int k = 0; k < cnt; ++k) mn = fmaxf(mn, sl[k * kPartFloats + h]);
      const float sa = exp2f(mx - mn);
      l *= sa;
      acc = make_float4(acc.x * sa, acc.y * sa, acc.z * sa, acc.w * sa);
      for (int k = 0; k < cnt; ++k) {
        const float* part = sl + k * kPartFloats;
        const float wt = exp2f(part[h] - mn);
        l += wt * part[kMaxG + h];
        fma4(acc, wt, *reinterpret_cast<const float4*>(
                          part + 2 * kMaxG + h * kHd + d0));
      }
      mx = mn;
    }
    named_sync(kMergeBar, kThreads);      // buf is the next round's
  }
  if (h < p.G) write4(out_at(p.out, b, p.H, p.G, h, d0), acc, l);
}

// ------------------------------------------------------------ hd 256

// the warps' rings (each holds its half of a block: the hd-128 slots),
// the units' merge area, the arrival flags, the merge's barrier and the
// pairs' exchange (per unit two buffers of two halves' 32 lanes x 4 f32)
template <typename T>
__host__ __device__ constexpr int smem_bytes_hd256() {
  return 128 + kWarps * Form<T>::kDepth * slot_bytes<T>() +
         kUnits256 * kPartFloats256 * 4 + 16 + kUnits256 * 2 * 2 * 32 * 16;
}

// slices of a row that the rings and the merge area hold at once
template <typename T>
__host__ __device__ constexpr int merge_capacity_hd256() {
  return (kWarps * Form<T>::kDepth * slot_bytes<T>() +
          kUnits256 * kPartFloats256 * 4) / (kPartFloats256 * 4);
}

// copy_block for the warp of half `half` (channels 128 half ..): its half
// of each row of K and of V, and the block's scales
template <typename T, typename Map>
__device__ __forceinline__ void copy_half(const Params<Map>& p,
                                          const Blocks<Map>& bl,
                                          uint32_t slot, int lane, int half) {
  constexpr int kRowBytes = Form<T>::kRowBytes;
  constexpr int kCh = kRowBytes / 16;
  constexpr int kRowsPerLane = kCh / 2;
  const int n = bl.n(), c = lane % kCh;
  const long long row_bytes = static_cast<long long>(p.KV) * 2 * kRowBytes;
  const unsigned char* kb =
      p.k + (2 * blockIdx.y + half) * kRowBytes + c * 16;
  const unsigned char* vb =
      p.v + (2 * blockIdx.y + half) * kRowBytes + c * 16;
  long long off[kRowsPerLane];
#pragma unroll
  for (int j = 0; j < kRowsPerLane; ++j) {
    const int r = lane / kCh + j * (32 / kCh);
    off[j] = p.map.row(p, bl.cur, bl.sg.b, bl.pos + r) * row_bytes;
  }
  long long si = 0;
  if constexpr (quantized<T>())
    si = p.map.scale(p, bl.cur, bl.sg.b, bl.pos + lane % kBlock);
#pragma unroll
  for (int j = 0; j < kRowsPerLane; ++j) {
    const int r = lane / kCh + j * (32 / kCh);
    const bool ok = r < n;
    cp_async16(slot + k_off<T>(r, c), ok ? kb + off[j] : kb, ok ? 16 : 0);
    cp_async16(slot + v_tile<T>() + v_off<T>(r, c), ok ? vb + off[j] : vb,
               ok ? 16 : 0);
  }
  if constexpr (quantized<T>()) {
    const bool ok = lane % kBlock < n;
    const float* src = lane < kBlock ? p.k_scale : p.v_scale;
    cp_async4(slot + 2 * v_tile<T>() + lane * 4, src + (ok ? si : 0),
              ok ? 4 : 0);
  }
}

// hd 256: `block` for one warp of a unit, over its half of the block's
// channels. Its sums over the half go to `mine` of the unit's exchange and
// the partner's come from `other` after the pair's barrier `bar`, so both
// warps hold the same scores (a + b == b + a) and run the same softmax;
// each then adds its half of P V.
template <typename T>
__device__ __forceinline__ void block_pair(const unsigned char* sl, int live,
                                           const unsigned (&qb)[8][2],
                                           int lane, float4* mine,
                                           const float4* other, int bar,
                                           WarpState& ws) {
  const int g = lane / 4, t = lane % 4;
  const float* scales = reinterpret_cast<const float*>(sl + 2 * v_tile<T>());
  unsigned a[8][4];
  k_frags<T>(sl, g, t, a);
  float s0[4] = {0.f, 0.f, 0.f, 0.f}, s1[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
  for (int j = 0; j < 8; j += 2) {
    mma16816<half_products<T>()>(s0, a[j], qb[j][0], qb[j][1]);
    mma16816<half_products<T>()>(s1, a[j + 1], qb[j + 1][0], qb[j + 1][1]);
  }
  // x[0], x[1]: position g, heads 2t, 2t + 1; x[2], x[3]: position g + 8
  float x[4];
#pragma unroll
  for (int c = 0; c < 4; ++c) x[c] = s0[c] + s1[c];
  *mine = make_float4(x[0], x[1], x[2], x[3]);
  named_sync(bar, 64);
  const float4 y = *other;
  x[0] += y.x;
  x[1] += y.y;
  x[2] += y.z;
  x[3] += y.w;
  if constexpr (quantized<T>()) {
    const float k0 = scales[g], k1 = scales[g + 8];
    x[0] *= k0; x[1] *= k0; x[2] *= k1; x[3] *= k1;
  }
#pragma unroll
  for (int c = 0; c < 4; ++c) x[c] *= kLog2e;
  const float masked = __int_as_float(0xff800000);   // -inf: p = 0
  if (g >= live) x[0] = x[1] = masked;
  if (g + 8 >= live) x[2] = x[3] = masked;
  float bm[2] = {fmaxf(x[0], x[2]), fmaxf(x[1], x[3])};
#pragma unroll
  for (int o = 4; o < 32; o <<= 1) {
    bm[0] = fmaxf(bm[0], __shfl_xor_sync(0xffffffffu, bm[0], o));
    bm[1] = fmaxf(bm[1], __shfl_xor_sync(0xffffffffu, bm[1], o));
  }
  float alpha[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const float mn = fmaxf(ws.m[h], bm[h]);
    alpha[h] = exp2f(ws.m[h] - mn);
    ws.m[h] = mn;
  }
  float pr[4];
#pragma unroll
  for (int c = 0; c < 4; ++c) pr[c] = exp2f(x[c] - ws.m[c & 1]);
  ws.l[0] = ws.l[0] * alpha[0] + (pr[0] + pr[2]);
  ws.l[1] = ws.l[1] * alpha[1] + (pr[1] + pr[3]);
  if (__any_sync(0xffffffffu, alpha[0] != 1.f || alpha[1] != 1.f)) {
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      ws.o[i][0] *= alpha[0];
      ws.o[i][1] *= alpha[1];
      ws.o[i][2] *= alpha[0];
      ws.o[i][3] *= alpha[1];
    }
  }
  if constexpr (quantized<T>()) {
    const float v0 = scales[kBlock + g] * p_scale<T>();
    const float v1 = scales[kBlock + g + 8] * p_scale<T>();
    pr[0] *= v0; pr[1] *= v0; pr[2] *= v1; pr[3] *= v1;
  }
  const unsigned b0 = movmatrix_t(pack16<half_products<T>()>(pr[0], pr[1]));
  const unsigned b1 = movmatrix_t(pack16<half_products<T>()>(pr[2], pr[3]));
  unsigned va[8][4];
  v_frags<T>(sl + v_tile<T>(), lane, va);
#pragma unroll
  for (int i = 0; i < 8; ++i)
    mma16816<half_products<T>()>(ws.o[i], va[i], b0, b1);
}

// q_load of the warp's half of head g's 256 channels
template <typename T, typename Map>
__device__ __forceinline__ void q_load_half(const Params<Map>& p, int b,
                                            int g, int t, int half,
                                            uint2 (&raw)[8]) {
  const bf16* qh = p.q + (static_cast<long long>(b) * p.H +
                          blockIdx.y * p.G + g) * kHd256 + half * kHd;
#pragma unroll
  for (int j = 0; j < 8; ++j)
    raw[j] = g < p.G ? __ldg(reinterpret_cast<const uint2*>(qh + q_dim<T>(j, t)))
                     : make_uint2(0u, 0u);
}

// 4 dims d0 .. d0 + 3 of head h of this kv head's heads in row b (hd 256)
__device__ __forceinline__ bf16* out_at_hd256(bf16* out, int b, int H, int G,
                                              int h, int d0) {
  return out + (static_cast<long long>(b) * H + blockIdx.y * G + h) * kHd256 +
         d0;
}

// workspace slot `which` (0, 1) of CTA `cta`: m[8], l[8], O[8][256]
template <typename Map>
__device__ __forceinline__ float* part_at_hd256(const Params<Map>& p, int cta,
                                                int which) {
  return p.ws +
         (2LL * (blockIdx.y * p.splits + cta) + which) * kPartFloats256;
}

// end_segment at hd 256: the units' states merged in unit order (a unit's
// warps write their halves of its O, its half-0 warp its m and l); thread
// tid takes head tid / 32, dims 4 (tid % 32) .. + 3 of each half.
template <typename T, typename Map>
__device__ void end_segment_hd256(const Params<Map>& p, int b, bool whole,
                                  int which, WarpState& st, float* mw) {
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int unit = warp / 2, half = warp % 2;
  const int g = lane / 4, t = lane % 4;
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int o = 4; o < 32; o <<= 1)
      st.l[h] += __shfl_xor_sync(0xffffffffu, st.l[h], o);
  named_sync(kMergeBar, kThreads);        // the last segment's reads are done
  float* mine = mw + unit * kPartFloats256;
  if (g == 0 && half == 0) {
    mine[2 * t] = st.m[0];
    mine[2 * t + 1] = st.m[1];
    mine[kMaxG + 2 * t] = st.l[0];
    mine[kMaxG + 2 * t + 1] = st.l[1];
  }
  float* mo = mine + 2 * kMaxG + half * kHd;
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int c = 0; c < 4; ++c)
      mo[(2 * t + (c & 1)) * kHd256 + o_dim<T>(i, g, c >> 1)] =
          st.o[i][c] * (1.f / p_scale<T>());
  named_sync(kMergeBar, kThreads);
  st.reset();
  const int h = tid / 32, d0 = 4 * (tid % 32);
  if (h >= p.G) return;
  float mx = V3D_NEG_INF;
#pragma unroll
  for (int w = 0; w < kUnits256; ++w)
    mx = fmaxf(mx, mw[w * kPartFloats256 + h]);
  float l = 0.f;
  float4 acc[2] = {make_float4(0.f, 0.f, 0.f, 0.f),
                   make_float4(0.f, 0.f, 0.f, 0.f)};
#pragma unroll
  for (int w = 0; w < kUnits256; ++w) {
    const float* part = mw + w * kPartFloats256 + 2 * kMaxG + h * kHd256 + d0;
    const float wt = exp2f(mw[w * kPartFloats256 + h] - mx);
    l += wt * mw[w * kPartFloats256 + kMaxG + h];
    fma4(acc[0], wt, *reinterpret_cast<const float4*>(part));
    fma4(acc[1], wt, *reinterpret_cast<const float4*>(part + kHd));
  }
  if (whole) {
    write4(out_at_hd256(p.out, b, p.H, p.G, h, d0), acc[0], l);
    write4(out_at_hd256(p.out, b, p.H, p.G, h, kHd + d0), acc[1], l);
    return;
  }
  float* part = part_at_hd256(p, blockIdx.x, which);
  if (d0 == 0) {
    part[h] = mx;
    part[kMaxG + h] = l;
  }
  float* po = part + 2 * kMaxG + h * kHd256 + d0;
  *reinterpret_cast<float4*>(po) = acc[0];
  *reinterpret_cast<float4*>(po + kHd) = acc[1];
}

// hd 256: the slices of a row of n merge in groups of this many
// consecutive ones (in merge order), then the groups' partials in group
// order: ceil(sqrt(n)) where n > kTreeMin, else all n in one group.
__host__ __device__ __forceinline__ int group_size(int n) {
  if (n <= kTreeMin) return n;
  int g = 1;
  while (g * g < n) ++g;
  return g;
}

// workspace slot of slice k of a row (in merge order) whose first slice
// CTA `first` holds in its slot first_slot
template <typename Map>
__device__ __forceinline__ float* slice_at(const Params<Map>& p, int first,
                                           int k, int first_slot,
                                           long long base, long long total) {
  const int c = slice_cta(p.splits, first, k, base, total);
  return part_at_hd256(p, c, c == first ? first_slot : 0);
}

// hd 256: slices k0, k0 + stride, ... (cnt_all of them, in merge order) of
// row b, merged in that order as merge_row merges a row's slices; then
// written normalised to the output, or (part not null) as one unnormalised
// slice (m, l, O of the live heads) into `part`.
template <typename Map>
__device__ void merge_slices(const Params<Map>& p, int first, int k0,
                             int stride, int cnt_all, int first_slot, int b,
                             long long base, long long total,
                             unsigned char* buf, int cap, uint64_t* bar,
                             int& phase, float* part) {
  const int tid = threadIdx.x, h = tid / 32, d0 = 4 * (tid % 32);
  const int bytes = (2 * kMaxG + p.G * kHd256) * 4;
  const uint32_t buf_s = smem_u32(buf);
  const float* sl = reinterpret_cast<const float*>(buf);
  float mx = V3D_NEG_INF, l = 0.f;
  float4 acc[2] = {make_float4(0.f, 0.f, 0.f, 0.f),
                   make_float4(0.f, 0.f, 0.f, 0.f)};
  for (int c0 = 0; c0 < cnt_all; c0 += cap) {
    const int cnt = min(cap, cnt_all - c0);
    if (tid == 0) mbar_arrive_tx(bar, cnt * bytes);
    named_sync(kMergeBar, kThreads);
    if (tid < cnt) {
      // stored by other CTAs (acquired above): ordered before the copy
      asm volatile("fence.proxy.async.global;" ::: "memory");
      bulk_copy(buf_s + tid * kPartFloats256 * 4,
                slice_at(p, first, k0 + (c0 + tid) * stride, first_slot,
                         base, total),
                bytes, bar);
    }
    mbar_wait(bar, phase);
    phase ^= 1;
    if (h < p.G) {
      float mn = mx;
      for (int k = 0; k < cnt; ++k) mn = fmaxf(mn, sl[k * kPartFloats256 + h]);
      const float sa = exp2f(mx - mn);
      l *= sa;
#pragma unroll
      for (int j = 0; j < 2; ++j)
        acc[j] = make_float4(acc[j].x * sa, acc[j].y * sa, acc[j].z * sa,
                             acc[j].w * sa);
      for (int k = 0; k < cnt; ++k) {
        const float* sk = sl + k * kPartFloats256;
        const float wt = exp2f(sk[h] - mn);
        l += wt * sk[kMaxG + h];
        const float* so = sk + 2 * kMaxG + h * kHd256 + d0;
        fma4(acc[0], wt, *reinterpret_cast<const float4*>(so));
        fma4(acc[1], wt, *reinterpret_cast<const float4*>(so + kHd));
      }
      mx = mn;
    }
    named_sync(kMergeBar, kThreads);      // buf is the next round's
  }
  if (h >= p.G) return;
  if (part == nullptr) {
    write4(out_at_hd256(p.out, b, p.H, p.G, h, d0), acc[0], l);
    write4(out_at_hd256(p.out, b, p.H, p.G, h, kHd + d0), acc[1], l);
    return;
  }
  if (d0 == 0) {
    part[h] = mx;
    part[kMaxG + h] = l;
  }
  float* po = part + 2 * kMaxG + h * kHd256 + d0;
  *reinterpret_cast<float4*>(po) = acc[0];
  *reinterpret_cast<float4*>(po + kHd) = acc[1];
}

// hd 256, after the slices' stores and a barrier: this CTA's pending rows
// (at most 2) merge in two levels. Each slice arrives on the counter of
// its group (group_size consecutive slices in merge order; (B, KV,
// kMaxGroups) counters after the rows' (B, KV)); the last CTA of a group
// merges it in order, writes the row where the group is the row's only
// one, else puts the group's partial in the slot of the group's first
// slice (read by no one else) and arrives on the row's counter, whose last
// CTA merges the groups' partials in group order. Every counter is reset
// by its last CTA; the order is fixed, so outputs repeat bit for bit.
// `flag` (the free exchange area) carries the row level's arrival.
template <typename T, typename Map>
__device__ void merge_tree(const Params<Map>& p, const int (&pend_b)[2],
                           const int (&pend_first)[2], const int (&pend_n)[2],
                           const int (&pend_slot)[2], const int (&pend_k)[2],
                           const long long (&pend_base)[2], int pending,
                           long long total, unsigned char* buf, int* flags,
                           int* flag, uint64_t* bar) {
  const int tid = threadIdx.x;
  if (tid == 0) {
    for (int k = 0; k < pending; ++k) {
      const int n = pend_n[k], gs = group_size(n), j = pend_k[k] / gs;
      int* counter = p.counters + p.B * p.KV +
                     (pend_b[k] * p.KV + blockIdx.y) * kMaxGroups + j;
      const bool last =
          atom_add_acq_rel(counter, 1) == min(gs, n - j * gs) - 1;
      if (last) *counter = 0;          // the next launch finds it zeroed
      flags[k] = last;
    }
  }
  named_sync(kMergeBar, kThreads);
  int phase = 0;
  for (int k = 0; k < pending; ++k) {
    if (!flags[k]) continue;
    const int n = pend_n[k], gs = group_size(n), j = pend_k[k] / gs;
    const int groups = (n + gs - 1) / gs;
    float* group_part =
        groups > 1 ? slice_at(p, pend_first[k], j * gs, pend_slot[k],
                                   pend_base[k], total)
                   : nullptr;
    merge_slices(p, pend_first[k], j * gs, 1, min(gs, n - j * gs),
                      pend_slot[k], pend_b[k], pend_base[k], total, buf,
                      merge_capacity_hd256<T>(), bar, phase, group_part);
    if (groups == 1) continue;
    named_sync(kMergeBar, kThreads);      // the group's partial is stored
    if (tid == 0) {
      int* counter = p.counters + pend_b[k] * p.KV + blockIdx.y;
      const bool last = atom_add_acq_rel(counter, 1) == groups - 1;
      if (last) *counter = 0;
      *flag = last;
    }
    named_sync(kMergeBar, kThreads);
    if (*flag)
      merge_slices(p, pend_first[k], 0, gs, groups, pend_slot[k],
                        pend_b[k], pend_base[k], total, buf,
                        merge_capacity_hd256<T>(), bar, phase, nullptr);
  }
}

// The kernel's body at hd 256: the hd-128 body with units of two warps
// (copy_half, q_load_half, block_pair, end_segment_hd256) and the
// two-level merge (merge_tree).
template <typename T, typename Map>
__device__ __forceinline__ void decode_hd256(const Params<Map>& p) {
  constexpr int kDepth = Form<T>::kDepth;
  constexpr int kUnits = kUnits256;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t a = smem_u32(smem_raw);
  unsigned char* base = smem_raw + (((a + 127) & ~127u) - a);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int unit = warp / 2, half = warp % 2;
  const int g = lane / 4, t = lane % 4;
  unsigned char* ring = base + warp * kDepth * slot_bytes<T>();
  float* mw = reinterpret_cast<float*>(base + kWarps * kDepth * slot_bytes<T>());
  int* flags = reinterpret_cast<int*>(mw + kUnits * kPartFloats256);
  uint64_t* merge_bar = reinterpret_cast<uint64_t*>(flags + 2);
  // hd 256: the pair's two exchange buffers of two halves' 32 lanes
  float4* xch = reinterpret_cast<float4*>(merge_bar + 1) + unit * 2 * 2 * 32;
  const uint32_t ring_s = smem_u32(ring);
  if (tid == 0) {                         // used after the CTA's barriers
    mbar_init(merge_bar, 1);
    fence_barrier_init();
  }

  // the first segment's q, then this warp's first copies: `in` copies
  // kDepth - 1 blocks ahead of `use`; a unit's warps walk the same blocks
  Walk<Map> walk(p, blockIdx.x);
  Blocks<Map> in(p, walk, unit);
  Blocks<Map> use = in;
  Segment sg;
  bool more = walk.next(sg);
  uint2 raw[8];
  if (more) q_load_half<T>(p, sg.b, g, t, half, raw);
  int issued = 0, used = 0;
  auto issue = [&]() {
    if (in.has) {
      copy_half<T>(p, in, ring_s + (issued % kDepth) * slot_bytes<T>(), lane,
                   half);
      in.skip(kUnits);
    }
    cp_async_commit();
    ++issued;
  };
#pragma unroll
  for (int k = 0; k < kDepth - 1; ++k) issue();
  unsigned qb[8][2];
  q_frags<T>(p, raw, qb);

  // rows with no live position: zeros, written by one CTA per kv head
  {
    const int h = tid / 32, d0 = 4 * (tid % 32);
    for (int b = blockIdx.x; b < p.B; b += p.splits)
      if (walk.len(b) == 0 && h < p.G) {
        *reinterpret_cast<uint2*>(out_at_hd256(p.out, b, p.H, p.G, h, d0)) =
            make_uint2(0u, 0u);
        *reinterpret_cast<uint2*>(
            out_at_hd256(p.out, b, p.H, p.G, h, kHd + d0)) = make_uint2(0u, 0u);
      }
  }
  int pend_b[2], pend_first[2], pend_n[2], pend_slot[2], pend_k[2];
  long long pend_base[2];
  int pending = 0;
  WarpState st;
  st.reset();
  for (int si = 0; more; ++si) {
    // the next segment's q, in flight while this one streams
    Walk<Map> peek = walk;
    Segment nx;
    const bool has_next = peek.next(nx);
    if (has_next) q_load_half<T>(p, nx.b, g, t, half, raw);
    while (use.has && use.seg == si) {
      issue();                                // block used + kDepth - 1
      cp_async_wait<kDepth - 1>();            // block `used` has landed
      __syncwarp();
      float4* x = xch + (used & 1) * 2 * 32 + lane;
      block_pair<T>(ring + (used % kDepth) * slot_bytes<T>(), use.n(), qb,
                    lane, x + half * 32, x + (1 - half) * 32,
                    kPairBar + unit, st);
      __syncwarp();                           // before its slot is refilled
      use.skip(kUnits, false);
      ++used;
    }
    const int first = walk.cta_of(sg.base);
    const int last = walk.cta_of(sg.base + sg.n - 1);
    const int which = sg.first_of_cta ? 0 : 1;
    end_segment_hd256<T>(p, sg.b, first == last, which, st, mw);
    if (first != last) {
      pend_b[pending] = sg.b;
      pend_first[pending] = first;
      // the row's slices: every CTA first .. last, or one per position
      // where some ranges are empty (slice_cta)
      pend_n[pending] = walk.total >= p.splits ? last - first + 1 : sg.n;
      pend_base[pending] = sg.base;
      // the slot of `first`'s slice: 0 where its range begins in the row
      pend_slot[pending] = first * walk.total / p.splits >= sg.base ? 0 : 1;
      // this CTA's slice's index in the row's merge order
      pend_k[pending] = walk.total >= p.splits
                            ? static_cast<int>(blockIdx.x) - first
                            : sg.s0;
      ++pending;
    }
    if (has_next) q_frags<T>(p, raw, qb);
    more = walk.next(sg);
  }
  if (pending == 0) return;
  // the slices' stores come before the barrier; one thread's release at
  // gpu scope publishes them all with its arrivals (and its acquire, where
  // it arrives last, brings the other slices' stores)
  named_sync(kMergeBar, kThreads);
  merge_tree<T>(p, pend_b, pend_first, pend_n, pend_slot, pend_k, pend_base,
                pending, walk.total, base, flags,
                reinterpret_cast<int*>(merge_bar + 1), merge_bar);
}

template <typename T, typename Map, int kWidth>
__global__ void __launch_bounds__(kThreads, 1)
split_decode_kernel(const __grid_constant__ Params<Map> p) {
  if constexpr (kWidth == kHd256) {
    decode_hd256<T, Map>(p);
  } else {
    constexpr int kDepth = Form<T>::kDepth;
    extern __shared__ unsigned char smem_raw[];
    const uint32_t a = smem_u32(smem_raw);
    unsigned char* base = smem_raw + (((a + 127) & ~127u) - a);
    const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
    const int g = lane / 4, t = lane % 4;
    unsigned char* ring = base + warp * kDepth * slot_bytes<T>();
    float* mw = reinterpret_cast<float*>(base + kWarps * kDepth * slot_bytes<T>());
    int* flags = reinterpret_cast<int*>(mw + kWarps * kPartFloats);
    uint64_t* merge_bar = reinterpret_cast<uint64_t*>(flags + 2);
    const uint32_t ring_s = smem_u32(ring);
    if (tid == 0) {                         // used after the CTA's barriers
      mbar_init(merge_bar, 1);
      fence_barrier_init();
    }

    // the first segment's q, then this warp's first copies: `in` copies
    // kDepth - 1 blocks ahead of `use`
    Walk<Map> walk(p, blockIdx.x);
    Blocks<Map> in(p, walk, warp);
    Blocks<Map> use = in;
    Segment sg;
    bool more = walk.next(sg);
    uint2 raw[8];
    if (more) q_load<T>(p, sg.b, g, t, raw);
    int issued = 0, used = 0;
    auto issue = [&]() {
      if (in.has) {
        copy_block<T>(p, in, ring_s + (issued % kDepth) * slot_bytes<T>(), lane);
        in.skip(kWarps);
      }
      cp_async_commit();
      ++issued;
    };
  #pragma unroll
    for (int k = 0; k < kDepth - 1; ++k) issue();
    unsigned qb[8][2];
    q_frags<T>(p, raw, qb);

    // rows with no live position: zeros, written by one CTA per kv head
    {
      const int h = tid / 32, d0 = 4 * (tid % 32);
      for (int b = blockIdx.x; b < p.B; b += p.splits)
        if (walk.len(b) == 0 && h < p.G)
          *reinterpret_cast<uint2*>(out_at(p.out, b, p.H, p.G, h, d0)) =
              make_uint2(0u, 0u);
    }
    int pend_b[2], pend_first[2], pend_n[2], pend_slot[2];
    long long pend_base[2];
    int pending = 0;
    WarpState st;
    st.reset();
    for (int si = 0; more; ++si) {
      // the next segment's q, in flight while this one streams
      Walk<Map> peek = walk;
      Segment nx;
      const bool has_next = peek.next(nx);
      if (has_next) q_load<T>(p, nx.b, g, t, raw);
      while (use.has && use.seg == si) {
        issue();                                // block used + kDepth - 1
        cp_async_wait<kDepth - 1>();            // block `used` has landed
        __syncwarp();
        block<T>(ring + (used % kDepth) * slot_bytes<T>(), use.n(), qb, lane, st);
        __syncwarp();                           // before its slot is refilled
        use.skip(kWarps, false);
        ++used;
      }
      const int first = walk.cta_of(sg.base);
      const int last = walk.cta_of(sg.base + sg.n - 1);
      const int which = sg.first_of_cta ? 0 : 1;
      end_segment<T>(p, sg.b, first == last, which, st, mw);
      if (first != last) {
        pend_b[pending] = sg.b;
        pend_first[pending] = first;
        // the row's slices: every CTA first .. last, or one per position
        // where some ranges are empty (slice_cta)
        pend_n[pending] = walk.total >= p.splits ? last - first + 1 : sg.n;
        pend_base[pending] = sg.base;
        // the slot of `first`'s slice: 0 where its range begins in the row
        pend_slot[pending] = first * walk.total / p.splits >= sg.base ? 0 : 1;
        ++pending;
      }
      if (has_next) q_frags<T>(p, raw, qb);
      more = walk.next(sg);
    }
    if (pending == 0) return;
    // the slices' stores come before the barrier; one thread's release at
    // gpu scope publishes them all with its arrivals (and its acquire, where
    // it arrives last, brings the other slices' stores)
    named_sync(kMergeBar, kThreads);
    if (tid == 0) {
      for (int k = 0; k < pending; ++k) {
        int* counter = p.counters + pend_b[k] * p.KV + blockIdx.y;
        const bool last = atom_add_acq_rel(counter, 1) == pend_n[k] - 1;
        if (last) *counter = 0;          // the next launch finds it zeroed
        flags[k] = last;
      }
    }
    named_sync(kMergeBar, kThreads);
    int phase = 0;
    for (int k = 0; k < pending; ++k)
      if (flags[k])
        merge_row(p, pend_first[k], pend_n[k], pend_slot[k], pend_b[k],
                  pend_base[k], walk.total, base, merge_capacity<T>(),
                  merge_bar, phase);
  }
}

// Checks the shapes and the plan, launches at head width kWidth (kHd, or
// kHd256: decode_hd256); returns a cudaError_t. The workspace (2 slices
// per CTA: kPartFloats, or kPartFloats256 f32) and the counters, zeroed,
// are always needed: which rows split depends on kv_len, read on the
// device. The counters: (B, KV), and at hd 256 after them (B, KV,
// kMaxGroups) for the groups of merge_tree.
template <typename T, typename Map, int kWidth = kHd>
int launch(const Params<Map>& p, long long ws_bytes, cudaStream_t stream) {
  static_assert(kWidth == kHd || kWidth == kHd256, "head width 128 or 256");
  constexpr int kPart = kWidth == kHd ? kPartFloats : kPartFloats256;
  constexpr int kSmem =
      kWidth == kHd ? smem_bytes<T>() : smem_bytes_hd256<T>();
  if (p.KV <= 0 || p.H % p.KV != 0 || p.H / p.KV > kMaxG || p.cap <= 0 ||
      p.splits < 1 || p.splits > kMaxSplits || p.ws == nullptr ||
      p.counters == nullptr ||
      ws_bytes < 2LL * p.splits * p.KV * kPart * 4)
    return static_cast<int>(cudaErrorInvalidValue);
  if (p.B <= 0) return 0;
  static const cudaError_t attr = cudaFuncSetAttribute(
      split_decode_kernel<T, Map, kWidth>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  split_decode_kernel<T, Map, kWidth><<<dim3(p.splits, p.KV), kThreads,
                                        kSmem, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace v3d_decode
