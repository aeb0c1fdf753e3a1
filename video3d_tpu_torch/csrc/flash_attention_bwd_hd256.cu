// Flash attention backward at head width 256 (Gemma; kernel B6): dQ, dK
// and dV of the prefill / training form of B2 (L == S, query offset 0,
// causal or not, keys masked at lengths[b]), bf16 in, one fused kernel.
//
// Replaces, at hd 256: video3d_tpu/kernels/flash_attention.py::_dq_kernel
// (:181, call :352) and ::_dkv_kernel (:216, call :376), the custom VJP
// _flash_core_bwd (:332-408), which the JAX wrapper runs for any hd % 128
// == 0 (:478-486). The recurrences (:7-11, _bwd_common :150-178), with
// lse the forward's per-row logsumexp (flash_attention_hd256.cu, kLse)
// and delta_i = dO_i . O_i computed outside, as JAX does (:341):
//     P  = exp(sm_scale Q K^T - lse)      (0 where the mask forbids)
//     dV = P^T dO,  dS = P * (dO V^T - delta) * sm_scale
//     dQ = dS K,    dK = dS^T Q
// key s is allowed for query row r when s < lengths[b] and, causal,
// s <= r. Key tiles at or past the length walk nothing and get zero
// gradients, as in the JAX kernel.
//
// What bounds it on an H100: compute. At B=1, L=8192, length 6780, 8
// heads (Gemma-2B), 32.56 M causal pairs a head make 5 products (S, dP,
// dV, dK, dQ) of 2 * 256 FLOP a pair: 0.67 TFLOP a layer against ~0.1 GB
// of traffic, far above the card's ~295 FLOP/byte ridge. What the design
// has to get past is the register file: a 64-key tile's dK and dV at 256
// channels are 256 f32 a thread in one warpgroup, too many beside the
// products (the TPU and the first form here split the work into a dQ and
// a dK / dV kernel and computed S and dP twice: 7 products a pair).
//
// Design (Hopper: TMA, mbarriers, wgmma; machinery in flash_sm90.cuh):
// one 256-thread CTA per (64-key tile, batch row, kv head, head split),
// two warpgroups and no producer warpgroup (ptxas compiles a 384-thread
// CTA under 168 registers a thread whatever setmaxnreg grants later: a
// first form with a producer warpgroup spilled 1 KB; two warpgroups may
// take 255). Thread 0 loads the K and V tiles once and keeps the walk's
// query-side tiles (Q and dO, 64 rows x 256 channels each, and the rows'
// lse * log2(e) and delta, which the wrapper packs into one f32 (B, H, 2,
// L rounded up to 4) tensor) in flight by TMA through two 64 KiB stages:
// tile it + 1 goes into the stage of tile it - 1 as soon as both
// warpgroups have released it, early in iteration it. The two warpgroups
// share the key tile and split the channels: warpgroup c owns channels
// 128 c .. 128 c + 127 of dK and dV (128 f32 registers a thread, summed
// over the whole walk). Per query tile:
//   c = 0: S^T = K Q^T (wgmma m64n64k16, 16 channel steps), P^T =
//     exp2(S^T log2(e) sm_scale - lse) masked on the tiles that can hold a
//     forbidden pair, in f32 to shared memory for warpgroup 1 (each thread
//     hands its 32 values to the thread of warpgroup 1 that holds the same
//     elements of dP^T);
//   c = 1: dP^T = V dO^T (the same shape), then dS^T = P^T (dP^T - delta)
//     sm_scale from the f32 P^T, as the plain version computes it (from a
//     bf16 P^T a row of dS no longer sums to zero), rounded to bf16 as a hi
//     and a lo part (lo = dS^T - hi), two swizzled 64 x 64 tiles for
//     warpgroup 0 and dQ;
//   both: P^T rounded to bf16 as A fragments, dV[:, c] += P^T dO[:, c],
//     dK[:, c] += dS^T Q[:, c] (wgmma m64n128k16 over the 64 queries; dS^T
//     from warpgroup 1's registers or shared memory) and dQ[:, c] = dS
//     K[:, c] over dS's hi and lo parts (m64n128k16 over the 64 keys, dS
//     and K MN-major from shared memory): a row of dS sums to zero and its
//     rounding error does not, so in dQ that error meets the keys' common
//     part undamped; the lo part takes dQ's error to the other gradients'
//     (2.0e-3 of the largest value at the main shape against 3.7e-3).
// Five tile products a pair and half of one for dQ's lo part, each
// warpgroup 2.75 of them; two named barriers hand P^T and dS^T over, a
// third frees the stage. dQ is staged
// as f32 in the stage it came with (its 64 KiB are free once both
// warpgroups' products have read Q and dO) and added into an f32
// (B, L, H, 256) scratch by TMA reduce-add, 32-channel boxes; the stage
// goes back to thread 0's loads when that add has read it. The reduce-adds
// add in an order that changes from run to run, so dQ is not
// bit-reproducible (chip_smoke holds it to 2e-2 of the largest gradient).
// Balance: a causal key tile j walks (tiles - j) query tiles of each of the
// group's G heads (G = 8 on Gemma's one kv head: the first tile's 1,024
// pairs against ~485 a SM at the main shape), so the wrapper splits the
// group's heads over `splits` CTAs (kernels/attention_hd256.py,
// bwd_hd256_plan: the fewest for which the longest walk is no longer than
// an even share of the SMs' work), longest walks first. Each CTA writes
// its f32 dK / dV partial to its own slice of a (splits, B, S, KV, 256)
// scratch, summed by the wrapper in a fixed order, so dK and dV stay
// bit-reproducible. Shared memory 226 KiB: one CTA per SM.
#include "flash_sm90.cuh"

namespace {

using namespace v3d_sm90;

constexpr int kHd = 256;
constexpr int kBk = 64;             // keys per CTA
constexpr int kBq = 64;             // query rows per tile of the walk
constexpr int kStages = 2;          // query-side stages in flight
constexpr int kThreads = 256;       // two warpgroups; thread 0 also loads
constexpr int kParts = kHd / kBoxChannels;   // 64-channel parts of a row
constexpr int kPart = 64 * 128;     // bytes of one part of a 64-row tile
constexpr int kTileBytes = kParts * kPart;   // a 64 x 256 bf16 tile: 32 KiB
constexpr int kStageBytes = 2 * kTileBytes;  // Q, then dO
constexpr int kDqChannels = 32;              // f32: 128-byte box rows
constexpr int kDqBox = kBq * 128;            // 64 rows x 32 f32
constexpr int kRowBytes = 2 * kBq * 4;       // lse * log2(e), delta
constexpr int kStageOff = 2 * kTileBytes;    // after K and V
constexpr int kDsOff = kStageOff + kStages * kStageBytes;
constexpr int kDsLoOff = kDsOff + kPart;     // dS^T, hi and lo: 64 x 64 bf16
constexpr int kPfOff = kDsLoOff + kPart;     // P^T in f32
constexpr int kRowsOff = kPfOff + 64 * 64 * 4;
constexpr int kBarOff = kRowsOff + kStages * kRowBytes;
constexpr int kSmemBytes = kBarOff + 64 + 1024;   // + alignment slack
constexpr float kLog2e = 1.4426950408889634f;
static_assert(kParts * kDqBox == kTileBytes,
              "a warpgroup's f32 dQ half fills one bf16 tile of its stage");

// named barriers: P^T ready, dS^T ready, the stage's products done, then
// one per warpgroup over its own threads' writes to shared memory
// (warpgroup 1's dS^T tiles, each one's dQ staging)
enum Barrier { kPReady = 1, kDsReady = 2, kStageRead = 3, kOwnTiles = 4 };

struct Smem {
  unsigned char* k;      // K's four parts, then V's
  unsigned char* stage;  // stage s: Q's parts, then dO's
  unsigned char* ds;     // dS^T's bf16 hi part, 64 keys x 64 queries,
                         // swizzled
  unsigned char* ds_lo;  // its lo part, the same
  float* pf;             // P^T in f32: value i of thread t at [128 i + t]
  float* rows;           // stage s: lse * log2(e) [64], then delta [64]
  uint64_t* kv_full;
  uint64_t* full;        // [kStages]
  uint64_t* empty;       // [kStages]
};

__device__ __forceinline__ Smem carve(unsigned char* raw) {
  const uint32_t a = smem_u32(raw);
  unsigned char* base = raw + (((a + 1023) & ~1023u) - a);
  Smem s;
  s.k = base;
  s.stage = base + kStageOff;
  s.ds = base + kDsOff;
  s.ds_lo = base + kDsLoOff;
  s.pf = reinterpret_cast<float*>(base + kPfOff);
  s.rows = reinterpret_cast<float*>(base + kRowsOff);
  s.kv_full = reinterpret_cast<uint64_t*>(base + kBarOff);
  s.full = s.kv_full + 1;
  s.empty = s.full + kStages;
  return s;
}

struct Walk {          // the query tiles of one CTA, in order
  int heads, h0, qstart, per_head;
  __device__ int count() const { return heads * per_head; }
  __device__ int head(int it) const { return h0 + it / per_head; }
  __device__ int q0(int it) const { return qstart + (it % per_head) * kBq; }
};

struct Maps {
  const CUtensorMap *q, *k, *v, *dout, *rows, *dq;
};

// thread 0: the query-side tiles of iteration it into its stage, once both
// warpgroups have released the tile it replaces
__device__ __forceinline__ void load_stage(const Smem& sm, const Maps& m,
                                           const Walk& w, int it, int b) {
  const int stage = it % kStages;
  const int h = w.head(it), q0 = w.q0(it);
  unsigned char* dst = sm.stage + stage * kStageBytes;
  uint64_t* bar = sm.full + stage;
  if (it >= kStages) mbar_wait(sm.empty + stage, (it / kStages - 1) & 1);
  mbar_arrive_tx(bar, kStageBytes + kRowBytes);
  for (int part = 0; part < kParts; ++part) {
    tma_load(dst + part * kPart, m.q, bar, part * kBoxChannels, h, q0, b);
    tma_load(dst + kTileBytes + part * kPart, m.dout, bar,
             part * kBoxChannels, h, q0, b);
  }
  tma_load(sm.rows + stage * 2 * kBq, m.rows, bar, q0, 0, h, b);
}

// a 64 x 64 bf16 tile in the accumulator layout -> its swizzled rows
__device__ __forceinline__ void store_frags(unsigned char* tile,
                                            const uint32_t (&f)[4][4],
                                            int row0, int lane) {
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int byte = i * 16 + 4 * (lane % 4);
    *reinterpret_cast<uint32_t*>(tile + sw128(row0, byte)) =
        f[i / 2][(i % 2) * 2];
    *reinterpret_cast<uint32_t*>(tile + sw128(row0 + 8, byte)) =
        f[i / 2][(i % 2) * 2 + 1];
  }
}

// v as bf16 A fragments hi and lo = v - hi (rounded to bf16): a product
// over both errs by ~2^-17 of v where one over hi alone errs by 2^-9
__device__ __forceinline__ void split_frags(const float (&v)[32],
                                            uint32_t (&hi)[4][4],
                                            uint32_t (&lo)[4][4]) {
  to_a_frags(v, hi);
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const float2 h = bf16_pair(hi[j][r]);
      lo[j][r] = pack_bf16(v[8 * j + 2 * r] - h.x,
                           v[8 * j + 2 * r + 1] - h.y);
    }
}

// One warpgroup: c = 0 makes P^T, c = 1 makes dS^T; each owns channels
// 128 c .. 128 c + 127 of dK, dV and dQ
__device__ __forceinline__ void consume(const Smem& sm, const Maps& m,
                                        float* __restrict__ dk_part,
                                        float* __restrict__ dv_part,
                                        const Walk& w, int c, int k0, int b,
                                        int kvh, int L, int S, int KV,
                                        int length, int causal,
                                        float sm_scale) {
  const int t = threadIdx.x % 128, warp = t / 32, lane = t % 32;
  const int row0 = 16 * warp + lane / 4;          // and row0 + 8
  const int key0 = k0 + row0, key1 = key0 + 8;
  const float scale_log2 = sm_scale * kLog2e;
  const uint32_t k_tile = smem_u32(sm.k), v_tile = k_tile + kTileBytes;
  // my first product's A operand (K or V, K-major), and K's channel half
  // c as dQ's B operand (MN-major)
  const uint64_t a_desc = desc_kmajor(c == 0 ? k_tile : v_tile);
  const uint64_t k_chan = desc_mnmajor(k_tile + c * 2 * kPart, kPart);
  const uint64_t ds_desc = desc_kmajor(smem_u32(sm.ds));
  const uint64_t ds_mn = desc_mnmajor(smem_u32(sm.ds), kPart);
  const uint64_t ds_lo_mn = desc_mnmajor(smem_u32(sm.ds_lo), kPart);

  float dk[64], dv[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) dk[i] = dv[i] = 0.f;

  mbar_wait(sm.kv_full, 0);
  const int n = w.count();
  for (int it = 0; it < n; ++it) {
    const int stage = it % kStages;
    mbar_wait(sm.full + stage, (it / kStages) & 1);
    const int h = w.head(it), q0 = w.q0(it);
    unsigned char* stage_ptr = sm.stage + stage * kStageBytes;
    const uint32_t q_tile = smem_u32(stage_ptr);
    const uint32_t do_tile = q_tile + kTileBytes;
    const float* lse2 = sm.rows + stage * 2 * kBq;
    const float* dlt = lse2 + kBq;

    float x[32];                         // S^T (c = 0) or dP^T (c = 1)
    const uint64_t b_desc = desc_kmajor(c == 0 ? q_tile : do_tile);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 16; ++kk)
      wgmma_ss_n64<0, 0>(x, step_kmajor(a_desc, kk, kPart),
                         step_kmajor(b_desc, kk, kPart), kk > 0);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(x);
    // the previous stage's dQ add has read its staging: the stage is free
    if (t == 0 && it > 0) {
      bulk_wait_read<0>();
      mbar_arrive(sm.empty + (it - 1) % kStages);
    }
    // thread 0: tile it + 1 into that stage once the other warpgroup has
    // released it too
    if (threadIdx.x == 0 && it + 1 < n && it + 1 >= kStages)
      load_stage(sm, m, w, it + 1, b);
    __syncwarp();

    uint32_t f16[4][4];                  // P^T (c = 0) or dS^T (c = 1)
    const uint64_t dv_b = desc_mnmajor(do_tile + c * 2 * kPart, kPart);
    const uint64_t dk_b = desc_mnmajor(q_tile + c * 2 * kPart, kPart);
    if (c == 0) {
      const bool masked = (causal && k0 + kBk - 1 > q0) ||
                          k0 + kBk > length || q0 + kBq > L;
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int col = 8 * (i / 4) + 2 * (lane % 4) + (i % 2);  // q0 + col
        float p = exp2f(x[i] * scale_log2 - lse2[col]);
        if (masked) {
          const int key = (i & 2) ? key1 : key0, pos = q0 + col;
          if (key >= length || pos >= L || (causal && key > pos)) p = 0.f;
        }
        x[i] = p;
        sm.pf[128 * i + t] = p;
      }
      named_arrive(kPReady, 256);
      to_a_frags(x, f16);                // P^T in bf16, as the products take it
      wgmma_fence();
#pragma unroll
      for (int j = 0; j < 4; ++j)                  // dV += P^T dO
        wgmma_rs_n128<1>(dv, f16[j], step_mnmajor(dv_b, j), 1);
      wgmma_commit();
      named_sync(kDsReady, 256);
      wgmma_fence();
#pragma unroll
      for (int j = 0; j < 4; ++j)                  // dK += dS^T Q
        wgmma_ss_n128<0, 1>(dk, step_kmajor(ds_desc, j, kPart),
                            step_mnmajor(dk_b, j), 1);
      wgmma_commit();
    } else {
      named_sync(kPReady, 256);
      // dS^T = P^T (dP^T - delta) sm_scale, with warpgroup 0's f32 P^T;
      // P^T in bf16 for dV
      float p[32];
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int col = 8 * (i / 4) + 2 * (lane % 4) + (i % 2);
        p[i] = sm.pf[128 * i + t];
        x[i] = p[i] * (x[i] - dlt[col]) * sm_scale;
      }
      uint32_t p16[4][4], lo[4][4];
      to_a_frags(p, p16);
      split_frags(x, f16, lo);
      store_frags(sm.ds, f16, row0, lane);
      store_frags(sm.ds_lo, lo, row0, lane);
      fence_proxy_async();
      named_arrive(kDsReady, 256);
      wgmma_fence();
#pragma unroll
      for (int j = 0; j < 4; ++j)                  // dK += dS^T Q
        wgmma_rs_n128<1>(dk, f16[j], step_mnmajor(dk_b, j), 1);
#pragma unroll
      for (int j = 0; j < 4; ++j)                  // dV += P^T dO
        wgmma_rs_n128<1>(dv, p16[j], step_mnmajor(dv_b, j), 1);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(p16);
      // its own dS^T tiles, written by all its threads, feed its dQ
      named_sync(kOwnTiles + 1, 128);
    }
    // the products reading my fragments are done: their registers are free
    wgmma_wait<0>();
    fence_regs(f16);

    // dQ = dS K, my channels, over dS's hi and lo parts: a row of dS sums
    // to zero, its bf16 rounding error does not, and that error would meet
    // the keys' common part undamped
    float dq[64];
    wgmma_fence();
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      wgmma_ss_n128<1, 1>(dq, step_mnmajor(ds_mn, j), step_mnmajor(k_chan, j),
                          j > 0);
      wgmma_ss_n128<1, 1>(dq, step_mnmajor(ds_lo_mn, j),
                          step_mnmajor(k_chan, j), 1);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(dk);
    fence_regs(dv);
    fence_regs(dq);
    // both warpgroups' products are done: Q, dO, P^T and dS^T are read
    named_sync(kStageRead, 256);

    // dQ -> my half of the stage (four f32 boxes of 32 channels,
    // swizzled), then one thread adds it into the scratch; rows past L
    // are not written
    unsigned char* dq_tile = stage_ptr + c * kTileBytes;
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      unsigned char* box = dq_tile + (i / 4) * kDqBox;
      const int byte = (i % 4) * 32 + 8 * (lane % 4);
      *reinterpret_cast<float2*>(box + sw128(row0, byte)) =
          make_float2(dq[4 * i], dq[4 * i + 1]);
      *reinterpret_cast<float2*>(box + sw128(row0 + 8, byte)) =
          make_float2(dq[4 * i + 2], dq[4 * i + 3]);
    }
    fence_proxy_async();
    named_sync(kOwnTiles + c, 128);
    if (t == 0) {
#pragma unroll
      for (int j = 0; j < kParts; ++j)
        tma_reduce_add(m.dq, dq_tile + j * kDqBox,
                       128 * c + kDqChannels * j, h, q0, b);
      bulk_commit();
    }
  }
  if (t == 0) bulk_wait_all();

  // my channels of the f32 dK / dV partials, keys < S
  const long long stride = (long long)KV * kHd;
  const long long base = ((long long)b * S * KV + kvh) * kHd + 128 * c;
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    const int col = 8 * i + 2 * (lane % 4);
    if (key0 < S) {
      *reinterpret_cast<float2*>(dk_part + base + key0 * stride + col) =
          make_float2(dk[4 * i], dk[4 * i + 1]);
      *reinterpret_cast<float2*>(dv_part + base + key0 * stride + col) =
          make_float2(dv[4 * i], dv[4 * i + 1]);
    }
    if (key1 < S) {
      *reinterpret_cast<float2*>(dk_part + base + key1 * stride + col) =
          make_float2(dk[4 * i + 2], dk[4 * i + 3]);
      *reinterpret_cast<float2*>(dv_part + base + key1 * stride + col) =
          make_float2(dv[4 * i + 2], dv[4 * i + 3]);
    }
  }
}

__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_hd256_kernel(
    const __grid_constant__ CUtensorMap qmap,    // (B, L, H, 256)
    const __grid_constant__ CUtensorMap kmap,    // (B, S, KV, 256)
    const __grid_constant__ CUtensorMap vmap,
    const __grid_constant__ CUtensorMap domap,   // (B, L, H, 256)
    const __grid_constant__ CUtensorMap rowmap,  // (B, H, 2, Lp)
    const __grid_constant__ CUtensorMap dqmap,   // (B, L, H, 256) f32
    const int* __restrict__ lengths,             // (B,) key lengths
    float* __restrict__ dk_part,   // (splits, B, S, KV, 256) f32
    float* __restrict__ dv_part,
    int L, int S, int H, int KV, int splits, int causal, float sm_scale) {
  extern __shared__ unsigned char smem_raw[];
  const Smem sm = carve(smem_raw);

  // key tile major, so the long causal walks start in the first wave and
  // the short ones fill in behind them
  const int per_tile = gridDim.x / ((S + kBk - 1) / kBk);   // B * KV * splits
  const int k0 = blockIdx.x / per_tile * kBk;
  const int r = blockIdx.x % per_tile;
  const int b = r / (KV * splits), kvh = r / splits % KV, sp = r % splits;
  const int length = min(lengths[b], S);
  Walk w;
  w.heads = H / KV / splits;
  w.h0 = kvh * (H / KV) + sp * w.heads;
  // key tiles at or past the length: no query attends them
  w.qstart = k0 < length ? (causal ? k0 : 0) : L;
  w.per_head = (L - w.qstart + kBq - 1) / kBq;
  // this split's slice of the partials: B * KV * S rows of 256
  const long long slice = (long long)sp * (per_tile / splits) * S * kHd;

  const Maps m{&qmap, &kmap, &vmap, &domap, &rowmap, &dqmap};
  if (threadIdx.x == 0) {
    mbar_init(sm.kv_full, 1);
    for (int i = 0; i < kStages; ++i) {
      mbar_init(sm.full + i, 1);
      mbar_init(sm.empty + i, 2);      // one arrival per warpgroup
    }
    fence_barrier_init();
    tma_prefetch(m.q);
    tma_prefetch(m.dout);
    tma_prefetch(m.rows);
    mbar_arrive_tx(sm.kv_full, 2 * kTileBytes);
    for (int p = 0; p < kParts; ++p) {
      tma_load(sm.k + p * kPart, m.k, sm.kv_full, p * kBoxChannels, kvh, k0,
               b);
      tma_load(sm.k + kTileBytes + p * kPart, m.v, sm.kv_full,
               p * kBoxChannels, kvh, k0, b);
    }
    for (int it = 0; it < kStages && it < w.count(); ++it)
      load_stage(sm, m, w, it, b);
  }
  __syncthreads();

  const int wg = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);
  consume(sm, m, dk_part + slice, dv_part + slice, w, wg, k0, b, kvh, L, S,
          KV, length, causal, sm_scale);
}

}  // namespace

// rows: lse * log2(e) and delta, f32 (B, H, 2, Lp) with Lp = L rounded
// up to 4 (kernels/flash_attention.py, bwd_rows); dq: the f32 (B, L, H,
// 256) scratch, which the caller has zeroed and the kernel adds dS K into;
// dk_part / dv_part: f32 (splits, B, S, KV, 256), every element written;
// splits divides H / KV (kernels/attention_hd256.py, bwd_hd256_plan).
extern "C" int v3d_flash_attention_bwd_hd256(
    const void* q, const void* k, const void* v, const void* dout,
    const void* rows, const void* lengths, void* dq, void* dk_part,
    void* dv_part, int B, int L, int S, int H, int KV, int splits,
    int causal, float sm_scale, void* stream) {
  static const cudaError_t attr = cudaFuncSetAttribute(
      flash_bwd_hd256_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kSmemBytes);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  if (KV <= 0 || H % KV != 0 || splits <= 0 || (H / KV) % splits != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (B <= 0 || L <= 0 || S <= 0) return 0;
  const long long Lp = (L + 3) / 4 * 4;
  CUtensorMap qmap, kmap, vmap, domap, rowmap, dqmap;
  int err = encode_rows_map(&qmap, q, B, L, H, kBq, kHd);
  if (!err) err = encode_rows_map(&kmap, k, B, S, KV, kBk, kHd);
  if (!err) err = encode_rows_map(&vmap, v, B, S, KV, kBk, kHd);
  if (!err) err = encode_rows_map(&domap, dout, B, L, H, kBq, kHd);
  if (!err)   // both vectors of a query tile in one box
    err = encode_map(&rowmap, rows, 4, false, {Lp, 2, H, B}, {kBq, 2, 1, 1});
  if (!err)
    err = encode_map(&dqmap, dq, 4, true, {kHd, H, L, B},
                     {kDqChannels, 1, kBq, 1});
  if (err) return err;
  // one CTA per (key tile, batch row, kv head, head split), decoded by the
  // kernel; split sp writes slice sp of the partials
  const dim3 grid((S + kBk - 1) / kBk * B * KV * splits);
  flash_bwd_hd256_kernel<<<grid, kThreads, kSmemBytes,
                           static_cast<cudaStream_t>(stream)>>>(
      qmap, kmap, vmap, domap, rowmap, dqmap,
      static_cast<const int*>(lengths), static_cast<float*>(dk_part),
      static_cast<float*>(dv_part), L, S, H, KV, splits, causal, sm_scale);
  return static_cast<int>(cudaGetLastError());
}
