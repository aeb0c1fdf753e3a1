// Flash attention backward (kernel B6): dQ, dK and dV of the prefill /
// training form of B2 (L == S, query offset 0), bf16 in, one fused kernel.
//
// Replaces: video3d_tpu/kernels/flash_attention.py::_dq_kernel (:181) and
// ::_dkv_kernel (:216), the custom VJP _flash_core_bwd (:332-408). The
// recurrences (:7-11, _bwd_common :150-178), with lse the per-row
// logsumexp of the forward (flash_attention.cu, kLse) and
// delta_i = dO_i . O_i computed outside, as JAX does (:341):
//     P  = exp(sm_scale Q K^T - lse)      (0 where the mask forbids)
//     dV = P^T dO,  dS = P * (dO V^T - delta) * sm_scale
//     dQ = dS K,    dK = dS^T Q
// masked as the forward: key s is allowed for query row r when s < length
// and, causal, s <= r. Only the tiles the causal rule and the key length
// admit are visited (:194-196, :231-233). The TPU needs two kernels
// because Mosaic has no atomics (:1-18), so S and dP are computed twice;
// here one kernel computes them once and adds dQ up by TMA reduce-adds.
//
// What bounds it on an H100: compute. Per (128-key, 64-query) tile pair
// the kernel does 5 products of 2 * 128 * 64 * 128 FLOP (S^T, dP^T, dV,
// dK, dQ) against ~0.2 GB of q/k/v/o/dO/dq/dk/dv traffic per layer at
// B=1, L=8192, 28 heads: far above the card's ~295 FLOP/byte ridge.
//
// Design (Hopper: TMA, mbarriers, wgmma; machinery in flash_sm90.cuh):
// one 256-thread CTA (two warpgroups, each owning 64 of the keys) per
// (128-key tile, batch row, kv head); the K and V tiles stay in shared
// memory for the whole walk. The CTA walks the GQA group's H / KV query
// heads and, for each, the query tiles from its own causal start to L, so
// dK and dV of the kv head are summed over the group in registers and
// rounded to bf16 once (the TPU's per-q-head buffers and their sum
// outside, :403-405, are not needed). Thread 0 keeps the query-side tiles
// (Q and dO, 64 rows each, and the rows' lse * log2(e) and delta, which
// the wrapper packs into one f32 (B, H, 2, L rounded up to 4) tensor) in
// flight by TMA through a ring of two shared-memory stages: the tiles of
// iteration it + 2 go into the stage of iteration it right after the
// barrier both warpgroups pass once done with it. There is no producer
// warpgroup: with a third, producer warpgroup and setmaxnreg (24 / 240
// registers), ptxas spilled and serialized the wgmmas, and that form ran
// slower than this one. The dK and dV accumulators alone take 128
// registers per thread; ptxas 12.9 gives this kernel 200 (__maxnreg__): at
// 208 and above it crashes on it. At 200 it still waits for each wgmma
// before the next (C7512), a loss the next redesign can take on.
// Per query tile:
//   S^T = K Q^T (wgmma m64n64k16, both operands from shared memory,
//   K-major); P^T = exp2(S^T log2(e) sm_scale - lse) in registers, masked
//   on the tiles that can hold a forbidden pair, rounded to bf16 as the A
//   fragments of dV += P^T dO (wgmma m64n128k16, dO MN-major from shared
//   memory), issued with dP^T = V dO^T; then dS^T = P^T (dP^T - delta)
//   sm_scale from the bf16 P^T (the f32 scores need not live through the
//   dP^T product), rounded to bf16 for dK += dS^T Q; dK and dV accumulate
//   in registers;
//   dS^T to shared memory (swizzled, two buffers), one barrier between the
//   two warpgroups, then dQ[:, 64 w .. 64 w + 63] = dS K[:, ...]
//   (wgmma m64n64k16, dS and K MN-major from shared memory) over all 128
//   keys, written to a swizzled f32 tile in shared memory and added into
//   an f32 (B, L, H, hd) scratch by TMA reduce-add
//   (cp.reduce.async.bulk.tensor), two 32-channel boxes per tile: the L2
//   adds whole lines, where per-thread float2 atomics (the first form of
//   this kernel) took most of its time.
// Five tile products per visited pair instead of the TPU's seven. The
// wrapper zeroes the scratch and rounds it to bf16 after. The reductions
// add in an order that changes from run to run, so dQ is not
// bit-reproducible (chip_smoke holds it to 2e-2 of the largest gradient).
// Key tiles at or past the key length walk nothing and get zero
// gradients, as in the JAX kernel.
#include "flash_sm90.cuh"

using namespace v3d_sm90;

namespace {

constexpr int kBk = 128;            // keys per CTA (64 per warpgroup)
constexpr int kBq = 64;             // query rows per tile of the walk
constexpr int kStages = 2;          // query-side stages in flight
constexpr int kThreads = 256;       // two warpgroups
constexpr int kKHalf = kBk * 128;   // bytes of one 64-channel half of K, V
constexpr int kQHalf = kBq * 128;   // ... of Q, dO
constexpr int kKVBytes = 4 * kKHalf;
constexpr int kStageBytes = 4 * kQHalf;           // Q halves, dO halves
constexpr int kRowBytes = 2 * kBq * 4;            // lse * log2(e), delta
constexpr int kDsBytes = kBk * kBq * 2;           // dS^T, 128 B per key
constexpr int kDqChannels = 32;                   // f32: 128-byte rows
constexpr int kDqBox = kBq * 128;                 // 64 rows x 32 f32
constexpr int kStageOff = kKVBytes;
constexpr int kDsOff = kStageOff + kStages * kStageBytes;
constexpr int kDqOff = kDsOff + 2 * kDsBytes;     // per consumer: 2 boxes
constexpr int kRowsOff = kDqOff + 2 * 2 * kDqBox;
constexpr int kBarOff = kRowsOff + kStages * kRowBytes;
constexpr int kSmemBytes = kBarOff + 64 + 1024;   // + alignment slack
constexpr float kLog2e = 1.4426950408889634f;

struct Smem {
  unsigned char* kv;     // K halves, then V halves
  unsigned char* stage;  // stage s: Q halves, then dO halves
  unsigned char* ds;     // two dS^T buffers
  unsigned char* dq;     // consumer w: its dQ tile, two 32-channel boxes
  float* rows;           // stage s: lse * log2(e) [64], then delta [64]
  uint64_t* kv_full;
  uint64_t* full;        // [kStages]
};

__device__ __forceinline__ Smem carve(unsigned char* raw) {
  const uint32_t a = smem_u32(raw);
  unsigned char* base = raw + (((a + 1023) & ~1023u) - a);
  Smem s;
  s.kv = base;
  s.stage = base + kStageOff;
  s.ds = base + kDsOff;
  s.dq = base + kDqOff;
  s.rows = reinterpret_cast<float*>(base + kRowsOff);
  s.kv_full = reinterpret_cast<uint64_t*>(base + kBarOff);
  s.full = s.kv_full + 1;
  return s;
}

struct Walk {          // the query tiles of one CTA, in order
  int G, qstart, per_head, L;
  __device__ int count() const { return G * per_head; }
  __device__ int head(int it) const { return it / per_head; }
  __device__ int q0(int it) const { return qstart + (it % per_head) * kBq; }
};

__device__ __forceinline__ Walk walk(int k0, int length, int L, int G,
                                     int causal) {
  Walk w;
  w.G = G;
  w.L = L;
  // key tiles at or past the length: no query attends them
  w.qstart = k0 < length ? (causal ? k0 : 0) : L;
  w.per_head = (L - w.qstart + kBq - 1) / kBq;
  return w;
}

struct Maps {
  const CUtensorMap *q, *k, *v, *dout, *rows, *dq;
};

// thread 0: the query-side tiles of iteration it into its stage
__device__ __forceinline__ void load_stage(const Smem& sm, const Maps& m,
                                           const Walk& w, int it, int b,
                                           int kvh) {
  const int stage = it % kStages;
  const int h = kvh * w.G + w.head(it), q0 = w.q0(it);
  unsigned char* dst = sm.stage + stage * kStageBytes;
  uint64_t* bar = sm.full + stage;
  mbar_arrive_tx(bar, kStageBytes + kRowBytes);
  for (int half = 0; half < 2; ++half) {
    tma_load(dst + half * kQHalf, m.q, bar, half * 64, h, q0, b);
    tma_load(dst + (2 + half) * kQHalf, m.dout, bar, half * 64, h, q0, b);
  }
  tma_load(sm.rows + stage * 2 * kBq, m.rows, bar, q0, 0, h, b);
}

// One warpgroup: keys k0 + 64 wg .. + 63
__device__ __forceinline__ void consume(const Smem& sm, const Maps& m,
                                        bf16* __restrict__ dk,
                                        bf16* __restrict__ dv, const Walk& w,
                                        int wg, int k0, int b, int kvh,
                                        int S, int KV, int length,
                                        int causal, float sm_scale) {
  const int t = threadIdx.x % 128, warp = t / 32, lane = t % 32;
  const int row0 = 16 * warp + lane / 4;          // and row0 + 8
  const int kfirst = k0 + 64 * wg;                // the warpgroup's key 0
  const int key0 = kfirst + row0, key1 = key0 + 8;
  const int L = w.L;
  const float scale_log2 = sm_scale * kLog2e;
  const uint32_t k_tile = smem_u32(sm.kv);
  // K and V: my 64 key rows (K-major); K's channel half wg (MN-major)
  const uint64_t k_mine = desc_kmajor(k_tile + wg * (kKHalf / 2));
  const uint64_t v_mine = desc_kmajor(k_tile + 2 * kKHalf + wg * (kKHalf / 2));
  const uint64_t k_chan = desc_mnmajor(k_tile + wg * kKHalf, kKHalf);

  unsigned char* dq_tile = sm.dq + wg * 2 * kDqBox;

  float dk_acc[64], dv_acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) dk_acc[i] = dv_acc[i] = 0.f;

  mbar_wait(sm.kv_full, 0);
  const int n = w.count();
  for (int it = 0; it < n; ++it) {
    const int stage = it % kStages;
    mbar_wait(sm.full + stage, (it / kStages) & 1);
    const int h = kvh * w.G + w.head(it), q0 = w.q0(it);
    const uint32_t q_tile = smem_u32(sm.stage) + stage * kStageBytes;
    const uint32_t do_tile = q_tile + 2 * kQHalf;
    const float* lse2 = sm.rows + stage * 2 * kBq;
    const float* dlt = lse2 + kBq;

    float s[32];
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 8; ++kk)                 // S^T = K Q^T
      wgmma_ss_n64<0, 0>(s, step_kmajor(k_mine, kk, kKHalf),
                         step_kmajor(desc_kmajor(q_tile), kk, kQHalf), kk > 0);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(s);

    const bool masked = (causal && kfirst + 63 > q0) ||
                        kfirst + 64 > length || q0 + kBq > L;
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int c = 8 * (i / 4) + 2 * (lane % 4) + (i % 2);   // query q0 + c
      float p = exp2f(s[i] * scale_log2 - lse2[c]);
      if (masked) {
        const int key = (i & 2) ? key1 : key0, pos = q0 + c;
        if (key >= length || pos >= L || (causal && key > pos)) p = 0.f;
      }
      s[i] = p;
    }
    uint32_t p16[4][4], ds16[4][4];
    to_a_frags(s, p16);                  // P^T in bf16, as the products take it
    float dp[32];
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 8; ++kk)                 // dP^T = V dO^T
      wgmma_ss_n64<0, 0>(dp, step_kmajor(v_mine, kk, kKHalf),
                         step_kmajor(desc_kmajor(do_tile), kk, kQHalf),
                         kk > 0);
    wgmma_commit();
#pragma unroll
    for (int j = 0; j < 4; ++j)                    // dV += P^T dO
      wgmma_rs_n128<1>(dv_acc, p16[j],
                       step_mnmajor(desc_mnmajor(do_tile, kQHalf), j), 1);
    wgmma_commit();
    wgmma_wait<1>();                     // dP^T is there
    fence_regs(dp);
    // dS^T = P^T (dP^T - delta) sm_scale, P^T read back from its bf16 form:
    // holding the f32 scores through the dP^T product would spill registers
#pragma unroll
    for (int i = 0; i < 32; i += 2) {
      const int c = 8 * (i / 4) + 2 * (lane % 4);
      const float2 pp = bf16_pair(p16[i / 8][(i % 8) / 2]);
      dp[i] = pp.x * (dp[i] - dlt[c]) * sm_scale;
      dp[i + 1] = pp.y * (dp[i + 1] - dlt[c + 1]) * sm_scale;
    }
    to_a_frags(dp, ds16);
    wgmma_fence();
#pragma unroll
    for (int j = 0; j < 4; ++j)                    // dK += dS^T Q
      wgmma_rs_n128<1>(dk_acc, ds16[j],
                       step_mnmajor(desc_mnmajor(q_tile, kQHalf), j), 1);
    wgmma_commit();

    // dS^T (bf16) -> buffer it % 2, my 64 key rows, swizzled
    unsigned char* ds = sm.ds + (it % 2) * kDsBytes + wg * (kDsBytes / 2);
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int byte = i * 16 + 4 * (lane % 4);
      *reinterpret_cast<uint32_t*>(ds + sw128(row0, byte)) =
          ds16[i / 2][(i % 2) * 2];
      *reinterpret_cast<uint32_t*>(ds + sw128(row0 + 8, byte)) =
          ds16[i / 2][(i % 2) * 2 + 1];
    }
    fence_proxy_async();
    wgmma_wait<0>();                     // dV and dK have read the stage
    fence_regs(dv_acc);
    fence_regs(dk_acc);
    fence_regs(p16);
    fence_regs(ds16);
    if (t == 0) bulk_wait_read<0>();     // the last dQ tile has been read
    // both halves of dS^T are there, and both warpgroups are done with
    // this stage: it takes the tiles of iteration it + kStages
    named_sync(1, 256);
    if (threadIdx.x == 0 && it + kStages < n)
      load_stage(sm, m, w, it + kStages, b, kvh);

    float dq_acc[32];
    const uint64_t dsd = desc_mnmajor(
        smem_u32(sm.ds) + (it % 2) * kDsBytes, kDsBytes);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 8; ++kk)                 // dQ = dS K, my channels
      wgmma_ss_n64<1, 1>(dq_acc, step_mnmajor(dsd, kk), step_mnmajor(k_chan, kk),
                         kk > 0);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(dq_acc);

    // dQ -> my f32 tile (two boxes of 32 channels, swizzled), then one
    // thread adds it into the scratch; rows past L are not written
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      unsigned char* box = dq_tile + (i / 4) * kDqBox;
      const int byte = (i % 4) * 32 + 8 * (lane % 4);
      *reinterpret_cast<float2*>(box + sw128(row0, byte)) =
          make_float2(dq_acc[4 * i], dq_acc[4 * i + 1]);
      *reinterpret_cast<float2*>(box + sw128(row0 + 8, byte)) =
          make_float2(dq_acc[4 * i + 2], dq_acc[4 * i + 3]);
    }
    fence_proxy_async();
    named_sync(2 + wg, 128);
    if (t == 0) {
      tma_reduce_add(m.dq, dq_tile, 64 * wg, h, q0, b);
      tma_reduce_add(m.dq, dq_tile + kDqBox, 64 * wg + kDqChannels, h, q0,
                     b);
      bulk_commit();
    }
  }
  if (t == 0) bulk_wait_all();

  const long long stride = (long long)KV * 128;
  bf16* dk0 = dk + ((long long)b * S * KV + kvh) * 128;
  bf16* dv0 = dv + ((long long)b * S * KV + kvh) * 128;
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    const int col = 8 * i + 2 * (lane % 4);
    if (key0 < S) {
      *reinterpret_cast<uint32_t*>(dk0 + key0 * stride + col) =
          pack_bf16(dk_acc[4 * i], dk_acc[4 * i + 1]);
      *reinterpret_cast<uint32_t*>(dv0 + key0 * stride + col) =
          pack_bf16(dv_acc[4 * i], dv_acc[4 * i + 1]);
    }
    if (key1 < S) {
      *reinterpret_cast<uint32_t*>(dk0 + key1 * stride + col) =
          pack_bf16(dk_acc[4 * i + 2], dk_acc[4 * i + 3]);
      *reinterpret_cast<uint32_t*>(dv0 + key1 * stride + col) =
          pack_bf16(dv_acc[4 * i + 2], dv_acc[4 * i + 3]);
    }
  }
}

// 256 threads x 200 registers: one CTA per SM (the shared memory allows no
// second one)
__global__ void __maxnreg__(200)
flash_bwd_kernel(const __grid_constant__ CUtensorMap qmap,    // (B, L, H, hd)
                 const __grid_constant__ CUtensorMap kmap,    // (B, S, KV, hd)
                 const __grid_constant__ CUtensorMap vmap,
                 const __grid_constant__ CUtensorMap domap,   // (B, L, H, hd)
                 const __grid_constant__ CUtensorMap rowmap,  // (B, H, 2, Lp)
                 const __grid_constant__ CUtensorMap dqmap,   // (B, L, H, hd)
                 const int* __restrict__ lengths,    // (B,) key lengths
                 bf16* __restrict__ dk,              // (B, S, KV, hd)
                 bf16* __restrict__ dv,              // (B, S, KV, hd)
                 int L, int S, int H, int KV, int causal, float sm_scale) {
  extern __shared__ unsigned char smem_raw[];
  const Smem sm = carve(smem_raw);

  // key tile major, so every (batch row, kv head)'s long causal walks
  // start in the first wave and the short ones fill in behind them
  const int bkv = gridDim.x / ((S + kBk - 1) / kBk);   // B * KV
  const int k0 = blockIdx.x / bkv * kBk;
  const int b = blockIdx.x % bkv / KV, kvh = blockIdx.x % KV;
  const int length = min(lengths[b], S);
  const Walk w = walk(k0, length, L, H / KV, causal);

  const Maps m{&qmap, &kmap, &vmap, &domap, &rowmap, &dqmap};
  if (threadIdx.x == 0) {
    mbar_init(sm.kv_full, 1);
    for (int i = 0; i < kStages; ++i) mbar_init(sm.full + i, 1);
    fence_barrier_init();
    tma_prefetch(m.q);
    tma_prefetch(m.dout);
    tma_prefetch(m.rows);
    mbar_arrive_tx(sm.kv_full, kKVBytes);
    for (int half = 0; half < 2; ++half) {
      tma_load(sm.kv + half * kKHalf, m.k, sm.kv_full, half * 64, kvh, k0, b);
      tma_load(sm.kv + (2 + half) * kKHalf, m.v, sm.kv_full, half * 64, kvh,
               k0, b);
    }
    for (int it = 0; it < kStages && it < w.count(); ++it)
      load_stage(sm, m, w, it, b, kvh);
  }
  __syncthreads();
  consume(sm, m, dk, dv, w, threadIdx.x / 128, k0, b, kvh, S, KV, length,
          causal, sm_scale);
}

}  // namespace

// rows: lse * log2(e) and delta, f32 (B, H, 2, Lp) with Lp = L rounded
// up to 4 (16-byte row strides for TMA; kernels/flash_attention.py,
// bwd_rows); dq: the f32 (B, L, H, hd) scratch, which the caller has
// zeroed and the kernel adds dS K into.
extern "C" int v3d_flash_attention_bwd(
    const void* q, const void* k, const void* v, const void* dout,
    const void* rows, const void* lengths, void* dq, void* dk, void* dv,
    int B, int L, int S, int H, int KV, int causal, float sm_scale,
    void* stream) {
  static const cudaError_t attr = cudaFuncSetAttribute(
      flash_bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kSmemBytes);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  if (KV <= 0 || H % KV != 0) return static_cast<int>(cudaErrorInvalidValue);
  if (B <= 0 || L <= 0 || S <= 0) return 0;
  const long long Lp = (L + 3) / 4 * 4;
  CUtensorMap qmap, kmap, vmap, domap, rowmap, dqmap;
  int err = encode_rows_map(&qmap, q, B, L, H, kBq);
  if (!err) err = encode_rows_map(&kmap, k, B, S, KV, kBk);
  if (!err) err = encode_rows_map(&vmap, v, B, S, KV, kBk);
  if (!err) err = encode_rows_map(&domap, dout, B, L, H, kBq);
  if (!err)   // both vectors of a query tile in one box
    err = encode_map(&rowmap, rows, 4, false, {Lp, 2, H, B}, {kBq, 2, 1, 1});
  if (!err)
    err = encode_map(&dqmap, dq, 4, true, {kHeadDim, H, L, B},
                     {kDqChannels, 1, kBq, 1});
  if (err) return err;
  // one CTA per (key tile, batch row, kv head), decoded by the kernel
  const dim3 grid((S + kBk - 1) / kBk * B * KV);
  flash_bwd_kernel<<<grid, kThreads, kSmemBytes,
                     static_cast<cudaStream_t>(stream)>>>(
      qmap, kmap, vmap, domap, rowmap, dqmap,
      static_cast<const int*>(lengths), static_cast<bf16*>(dk),
      static_cast<bf16*>(dv), L, S, H, KV, causal, sm_scale);
  return static_cast<int>(cudaGetLastError());
}
