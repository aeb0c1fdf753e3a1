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
// per-row logsumexp (:141-143) for the backward kernel B6
// (flash_attention_bwd.cu); both instantiations are one template and give
// the same output bit for bit.
//
// What bounds it on an H100: prefill is compute-bound (at L = 8192, 28
// heads, hd 128, causal a layer is ~0.48 TFLOP against ~0.2 GB of q/k/v/o
// traffic, far above the card's ~295 FLOP/byte ridge). The folded form at
// the suffix-over-prefix shape (64 queries x 7 heads against ~6.7k cached
// keys) does 2 * 448 * 128 * 2 FLOP per key row of 512 bytes it streams
// (~450 FLOP/byte): compute and the cache stream are about even.
//
// Prefill design (Hopper: TMA, mbarriers, wgmma; machinery in
// flash_sm90.cuh): one 384-thread CTA per (128-row query tile, batch row,
// head), longest causal tiles first over all heads. Warpgroup 0 is the producer: it gives
// its registers to the others (setmaxnreg) and one thread keeps the K and V
// tiles of 128 keys in flight by TMA through a ring of two shared-memory
// stages (full / empty mbarriers). Warpgroups 1 and 2 each own 64 query
// rows: S = Q K^T is wgmma m64n128k16 with Q and K from shared memory; the
// f32 scores stay in registers, the online softmax runs there (exp2 with
// log2(e) * sm_scale folded into one multiply, row max and sum over the
// four lanes of a row, O rescaled only where the row max moved), and
// O += P V is wgmma with P as bf16 A fragments from registers (P rounded
// to bf16 as before) and V from shared memory as an MN-major operand; the
// 64 x 128 f32 output accumulator stays in registers. TMA zero-fills rows
// past L (a ragged last tile); masked keys (s >= length, causal s > r) get
// exactly zero weight, tested only on the tiles that can hold one. The
// epilogue writes O as bf16 into the warpgroup's Q rows (swizzled) and
// stores it by TMA, which skips rows past L. GQA by kv head = h / (H / KV);
// rows >= length give finite garbage, the JAX contract.
//
// Folded design (chunk_sm90.cuh, shared with B5): the `group` = H / KV
// query heads of one kv head fold into the rows (row r*group + g is query
// r of head kvh*group + g, at position q_off[b] + r), so each K/V tile of
// the cache is read once for all the group's heads, which is the point of
// folding; 128 rows per CTA, K and V by TMA straight out of the stacked
// cache (an int8 or int4 tile converted to bf16 by the producer
// warpgroup), wgmma with softmax and O in registers, and a split over keys
// planned by the wrapper where the row tiles alone do not fill the card.
#include <type_traits>

#include "chunk_sm90.cuh"
#include "flash_sm90.cuh"

namespace {

namespace pf {   // the prefill form

using namespace v3d_sm90;

constexpr int kBq = 128;            // query rows per CTA
constexpr int kBk = 128;            // keys per K / V tile
constexpr int kStages = 2;          // K / V stages in flight
constexpr int kThreads = 384;       // producer + two consumer warpgroups
constexpr int kQBox = 64;           // rows of a Q / O box: a consumer's
constexpr int kQHalf = kBq * 128;   // bytes of one 64-channel half of Q
constexpr int kKHalf = kBk * 128;   // bytes of one half of a K or V tile
constexpr int kQBytes = 2 * kQHalf;
constexpr int kStageBytes = 4 * kKHalf;   // K, then V
constexpr int kBarOff = kQBytes + kStages * kStageBytes;
constexpr int kSmemBytes = kBarOff + 64 + 1024;   // + alignment slack
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

struct Smem {
  unsigned char* q;      // Q: two halves of kBq rows
  unsigned char* kv;     // stage s: K halves, then V halves
  uint64_t* q_full;
  uint64_t* full;        // [kStages]
  uint64_t* empty;       // [kStages]
};

__device__ __forceinline__ Smem carve(unsigned char* raw) {
  const uint32_t a = smem_u32(raw);
  unsigned char* base = raw + (((a + 1023) & ~1023u) - a);
  Smem s;
  s.q = base;
  s.kv = base + kQBytes;
  s.q_full = reinterpret_cast<uint64_t*>(base + kBarOff);
  s.full = s.q_full + 1;
  s.empty = s.full + kStages;
  return s;
}

// One consumer warpgroup: 64 query rows, starting at q0 + 64 * wg
template <bool kLse>
__device__ __forceinline__ void consume(const Smem& sm,
                                        const CUtensorMap* omap,
                                        float* __restrict__ lse, int wg,
                                        int n_tiles, int q0, int b, int h,
                                        int L, int H, int length, int causal,
                                        float scale_log2) {
  const int t = threadIdx.x % 128, warp = t / 32, lane = t % 32;
  const int row0 = 16 * warp + lane / 4;          // and row0 + 8
  const int first = q0 + 64 * wg;                 // the warpgroup's row 0
  const int pos0 = first + row0, pos1 = pos0 + 8;
  const uint64_t q_desc = desc_kmajor(smem_u32(sm.q) + wg * (kQHalf / 2));

  float o[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) o[i] = 0.f;
  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;

  mbar_wait(sm.q_full, 0);
  for (int it = 0; it < n_tiles; ++it) {
    const int stage = it % kStages;
    mbar_wait(sm.full + stage, (it / kStages) & 1);
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

    const int k0 = it * kBk;
    const bool masked = k0 + kBk > length ||
                        (causal && k0 + kBk - 1 > first);
    float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
    for (int i = 0; i < 64; ++i) {
      float x = s[i] * scale_log2;
      if (masked) {
        const int col = k0 + 8 * (i / 4) + 2 * (lane % 4) + (i % 2);
        const int pos = (i & 2) ? pos1 : pos0;
        if (col >= length || (causal && col > pos)) x = -INFINITY;
      }
      s[i] = x;
      if (i & 2) mx1 = fmaxf(mx1, x);
      else mx0 = fmaxf(mx0, x);
    }
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
    const float n0 = fmaxf(m0, mx0), n1 = fmaxf(m1, mx1);
    // a row that has seen no allowed key yet keeps p = 0 (exp2(-inf))
    const float u0 = n0 == -INFINITY ? 0.f : n0;
    const float u1 = n1 == -INFINITY ? 0.f : n1;
    const float a0 = exp2f(m0 - u0), a1 = exp2f(m1 - u1);
    m0 = n0;
    m1 = n1;
    float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
    for (int i = 0; i < 64; ++i) {
      const float p = exp2f(s[i] - ((i & 2) ? u1 : u0));
      s[i] = p;
      if (i & 2) sum1 += p;
      else sum0 += p;
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
    if (t == 0) mbar_arrive(sm.empty + stage);
  }

  l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
  l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
  // the final divide guards l >= 1e-30, as the JAX contract says
  const float d0 = fmaxf(l0, 1e-30f), d1 = fmaxf(l1, 1e-30f);
  // O -> the warpgroup's rows of the Q tile (its last reader was this
  // warpgroup's final S product), then one TMA store per half
  unsigned char* out_tile = sm.q + wg * (kQHalf / 2);
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    unsigned char* half = out_tile + (i / 8) * kQHalf;
    const int byte = (i % 8) * 16 + 4 * (lane % 4);
    *reinterpret_cast<uint32_t*>(half + sw128(row0, byte)) =
        pack_bf16(o[4 * i] / d0, o[4 * i + 1] / d0);
    *reinterpret_cast<uint32_t*>(half + sw128(row0 + 8, byte)) =
        pack_bf16(o[4 * i + 2] / d1, o[4 * i + 3] / d1);
  }
  fence_proxy_async();
  named_sync(1 + wg, 128);
  if (t == 0) {
    tma_store(omap, out_tile, 0, h, first, b);
    tma_store(omap, out_tile + kQHalf, 64, h, first, b);
    bulk_commit();
    bulk_wait_all();
  }
  if constexpr (kLse) {
    // m + log(l), l floored as in the output's divide; m back from log2
    if (lane % 4 == 0) {
      float* row = lse + ((long long)b * H + h) * L;
      if (pos0 < L)
        row[pos0] = (m0 == -INFINITY ? V3D_NEG_INF : m0 * kLn2) + logf(d0);
      if (pos1 < L)
        row[pos1] = (m1 == -INFINITY ? V3D_NEG_INF : m1 * kLn2) + logf(d1);
    }
  }
}

template <bool kLse>
__global__ void __launch_bounds__(kThreads, 1)
flash_fwd_kernel(const __grid_constant__ CUtensorMap qmap,   // (B, L, H, hd)
                 const __grid_constant__ CUtensorMap kmap,   // (B, S, KV, hd)
                 const __grid_constant__ CUtensorMap vmap,
                 const __grid_constant__ CUtensorMap omap,   // (B, L, H, hd)
                 const int* __restrict__ lengths,  // (B,) key lengths
                 int L, int S, int H, int KV, int causal, float sm_scale,
                 float* __restrict__ lse) {        // (B, H, L) f32, kLse
  extern __shared__ unsigned char smem_raw[];
  const Smem sm = carve(smem_raw);

  // query tile major, long causal tiles first over every (batch row, head)
  const int n_qt = (L + kBq - 1) / kBq;
  const int bh = gridDim.x / n_qt;                     // B * H
  const int qt = n_qt - 1 - blockIdx.x / bh;
  const int b = blockIdx.x % bh / H, h = blockIdx.x % H;
  const int kvh = h / (H / KV);
  const int q0 = qt * kBq;
  const int length = min(lengths[b], S);
  int kend = causal ? min(S, q0 + kBq) : S;
  kend = min(kend, length);
  const int n_tiles = kend > 0 ? (kend + kBk - 1) / kBk : 0;

  if (threadIdx.x == 0) {
    mbar_init(sm.q_full, 1);
    for (int i = 0; i < kStages; ++i) {
      mbar_init(sm.full + i, 1);
      mbar_init(sm.empty + i, 2);      // one arrival per consumer warpgroup
    }
    fence_barrier_init();
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 0) {                       // producer
    regs_dec<24>();
    if (threadIdx.x == 0) {
      tma_prefetch(&qmap);
      tma_prefetch(&kmap);
      tma_prefetch(&vmap);
      mbar_arrive_tx(sm.q_full, kQBytes);
      for (int r = 0; r < kBq; r += kQBox)
        for (int half = 0; half < 2; ++half)
          tma_load(sm.q + half * kQHalf + r * 128, &qmap, sm.q_full,
                   half * 64, h, q0 + r, b);
      for (int it = 0; it < n_tiles; ++it) {
        const int stage = it % kStages;
        if (it >= kStages) mbar_wait(sm.empty + stage, (it / kStages - 1) & 1);
        unsigned char* dst = sm.kv + stage * kStageBytes;
        mbar_arrive_tx(sm.full + stage, kStageBytes);
        for (int half = 0; half < 2; ++half) {
          tma_load(dst + half * kKHalf, &kmap, sm.full + stage, half * 64,
                   kvh, it * kBk, b);
          tma_load(dst + (2 + half) * kKHalf, &vmap, sm.full + stage,
                   half * 64, kvh, it * kBk, b);
        }
      }
    }
  } else {                             // consumers
    regs_inc<240>();
    consume<kLse>(sm, &omap, lse, wg - 1, n_tiles, q0, b, h, L, H, length,
                  causal, sm_scale * kLog2e);
  }
}

}  // namespace pf

}  // namespace

namespace {

template <bool kLse>
int launch_fwd(const void* q, const void* k, const void* v,
               const void* lengths, void* out, void* lse, int B, int L,
               int S, int H, int KV, int causal, float sm_scale,
               void* stream) {
  static const cudaError_t attr = cudaFuncSetAttribute(
      pf::flash_fwd_kernel<kLse>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      pf::kSmemBytes);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  if (KV <= 0 || H % KV != 0) return static_cast<int>(cudaErrorInvalidValue);
  if (B <= 0 || L <= 0) return 0;
  CUtensorMap qmap, kmap, vmap, omap;
  int err = v3d_sm90::encode_rows_map(&qmap, q, B, L, H, pf::kQBox);
  if (!err) err = v3d_sm90::encode_rows_map(&kmap, k, B, S, KV, pf::kBk);
  if (!err) err = v3d_sm90::encode_rows_map(&vmap, v, B, S, KV, pf::kBk);
  if (!err) err = v3d_sm90::encode_rows_map(&omap, out, B, L, H, pf::kQBox);
  if (err) return err;
  // one CTA per (query tile, batch row, head), decoded by the kernel
  const dim3 grid((L + pf::kBq - 1) / pf::kBq * B * H);
  pf::flash_fwd_kernel<kLse><<<grid, pf::kThreads, pf::kSmemBytes,
                               static_cast<cudaStream_t>(stream)>>>(
      qmap, kmap, vmap, omap, static_cast<const int*>(lengths), L, S, H, KV,
      causal, sm_scale, static_cast<float*>(lse));
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
                  float sm_scale, void* ws, long long ws_bytes,
                  void* counters, int splits, void* stream) {
  if (layer < 0) return static_cast<int>(cudaErrorInvalidValue);
  v3d_chunk::Params p{};
  p.q = static_cast<const v3d_sm90::bf16*>(q);
  p.out = static_cast<v3d_sm90::bf16*>(out);
  p.ks = static_cast<const float*>(k_scale);
  p.vs = static_cast<const float*>(v_scale);
  p.lengths = static_cast<const int*>(lengths);
  p.q_off = static_cast<const int*>(q_off);
  p.ws = static_cast<float*>(ws);
  p.counters = static_cast<int*>(counters);
  p.B = B;
  p.L = L;
  p.H = H;
  p.KV = KV;
  p.S = S;
  p.layer = layer;
  p.splits = splits;
  p.scale_log2 = sm_scale * v3d_chunk::kLog2e;
  // the stacked cache: layer `layer` of (NL, B, S, KV * hd) by strides
  return v3d_chunk::launch<false, T>(p, k_all, v_all, nullptr, nullptr,
                                     static_cast<long long>(layer + 1) * B,
                                     ws_bytes, stream);
}

}  // namespace

// ws: splits > 1, the workspace of v3d_chunk::workspace_floats, ws_bytes
// its size; counters: splits > 1, one zeroed int per row tile (the kernel
// leaves them zeroed); splits: over keys (1: none)
extern "C" int v3d_flash_attention_folded(
    const void* q, const void* k_all, const void* v_all, const void* lengths,
    const void* q_off, void* out, int layer, int B, int L, int S, int H,
    int KV, float sm_scale, void* ws, long long ws_bytes, void* counters,
    int splits, void* stream) {
  return launch_folded<v3d_sm90::bf16>(
      q, k_all, v_all, nullptr, nullptr, lengths, q_off, out, layer, B, L, S,
      H, KV, sm_scale, ws, ws_bytes, counters, splits, stream);
}

extern "C" int v3d_flash_attention_folded_int8(
    const void* q, const void* k_all, const void* v_all, const void* k_scale,
    const void* v_scale, const void* lengths, const void* q_off, void* out,
    int layer, int B, int L, int S, int H, int KV, float sm_scale, void* ws,
    long long ws_bytes, void* counters, int splits, void* stream) {
  return launch_folded<int8_t>(q, k_all, v_all, k_scale, v_scale, lengths,
                               q_off, out, layer, B, L, S, H, KV, sm_scale,
                               ws, ws_bytes, counters, splits, stream);
}

extern "C" int v3d_flash_attention_folded_int4(
    const void* q, const void* k_all, const void* v_all, const void* k_scale,
    const void* v_scale, const void* lengths, const void* q_off, void* out,
    int layer, int B, int L, int S, int H, int KV, float sm_scale, void* ws,
    long long ws_bytes, void* counters, int splits, void* stream) {
  return launch_folded<v3d_nib4>(q, k_all, v_all, k_scale, v_scale, lengths,
                                 q_off, out, layer, B, L, S, H, KV, sm_scale,
                                 ws, ws_bytes, counters, splits, stream);
}
