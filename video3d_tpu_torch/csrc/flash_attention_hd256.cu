// Flash attention forward at head width 256 (Gemma; kernel B2's prefill
// form), bf16 in, bf16 out, and its training instantiation (kLse) that also
// writes each row's logsumexp for the backward kernel B6
// (flash_attention_bwd_hd256.cu); both instantiations are one template and
// give the same output bit for bit.
//
// Replaces, at hd 256: video3d_tpu/kernels/flash_attention.py::_fwd_kernel
// (:64, call :283), reached from flash_attention -> _flash_core ->
// _fwd_call (L == S, query offset 0, causal or not), which the JAX wrapper
// runs for any hd % 128 == 0; with kLse the custom VJP's forward
// (:141-143): query row r attends key s when s < lengths[b] and, causal,
// s <= r; GQA by kv head h / (H / KV); lse (B, H, L) f32 in natural-log
// units, -1e30 + log(1e-30) for a row with no allowed key.
//
// What bounds it on an H100: compute. At B=1, L=8192, length 6780, 8 heads
// (Gemma-2B) the mask allows 32.56 M (query, key) pairs a head, each 2
// products of 2 * 256 FLOP: 0.27 TFLOP a layer against ~0.04 GB of
// q/k/v/o traffic, far above the card's ~295 FLOP/byte ridge. Each score
// carries twice the tensor-core work of the hd-128 form for the same
// softmax work, so the tensor cores are even more the limit here.
//
// Design (Hopper: TMA, mbarriers, wgmma; machinery in flash_sm90.cuh), the
// hd-128 prefill form's (flash_attention.cu) at twice the width, without
// its producer warpgroup: one 256-thread CTA per (128-row query tile,
// batch row, head), longest causal tiles first over all heads. The 64 x
// 256 f32 output accumulator is 128 registers a thread; ptxas compiles a
// 384-thread CTA under its launch bound's 168 registers whatever setmaxnreg
// grants later (the first form of this kernel spilled ~280 bytes and
// serialized its wgmmas, C7512), while two warpgroups may take 255. So
// thread 0 loads: Q once, then K and V tiles of 64 keys by TMA through two
// stages, K and V on barriers of their own; tile it + 2 goes into the
// stage of tile it as soon as both warpgroups are done with it (its K after
// their scores, its V after O += P V), two tiles ahead of the consumers.
// Shared memory: Q 64 KiB (four 64-channel swizzled parts of 128 rows),
// each stage 32 + 32 KiB: 192 KiB, one CTA per SM. Warpgroups 0 and 1 each
// own 64 query rows: S = Q K^T is wgmma m64n64k16 over 16 channel steps, the
// 64 x 64 f32 scores stay in registers and the online softmax runs there
// as at hd 128 (exp2 with log2(e) * sm_scale folded in, O rescaled only
// where a row max moved), and O += P V is two wgmma m64n128k16 per 16-key
// step (one per channel half of V, an MN-major operand), P as bf16 A
// fragments from registers. A warpgroup whose causal rows end before the
// CTA's last key tile skips that tile (nothing waits for its release: it
// is the last, and thread 0 has issued every load before it). TMA
// zero-fills rows past L; masked keys get exactly zero weight, tested
// only on the tiles that can hold one. The epilogue writes O as bf16 into
// the warpgroup's Q rows and stores it by TMA, which skips rows past L;
// rows >= length give finite values (the JAX contract). No split over
// keys: at the main shape 64 row tiles x 8 heads are 512 CTAs on 132 SMs.
#include "flash_sm90.cuh"

namespace {

using namespace v3d_sm90;

constexpr int kHd = 256;
constexpr int kBq = 128;            // query rows per CTA
constexpr int kBk = 64;             // keys per K / V tile
constexpr int kStages = 2;          // K / V stages in flight
constexpr int kThreads = 256;       // two warpgroups; thread 0 also loads
constexpr int kParts = kHd / kBoxChannels;   // 64-channel parts of a row
constexpr int kQBox = 64;           // rows of a Q / O box: a consumer's
constexpr int kQPart = kBq * 128;   // bytes of one 64-channel part of Q
constexpr int kKPart = kBk * 128;   // ... of a K or V tile
constexpr int kQBytes = kParts * kQPart;      // 64 KiB
constexpr int kTileBytes = kParts * kKPart;   // one K or V tile: 32 KiB
constexpr int kKOff = kQBytes;
constexpr int kVOff = kKOff + kStages * kTileBytes;
constexpr int kBarOff = kVOff + kStages * kTileBytes;
constexpr int kSmemBytes = kBarOff + 128 + 1024;   // + alignment slack
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

struct Smem {
  unsigned char* q;      // Q: four parts of kBq rows
  unsigned char* k;      // stage s: K's four parts
  unsigned char* v;      // stage s: V's four parts
  uint64_t* q_full;
  uint64_t* k_full;      // [kStages]
  uint64_t* v_full;      // [kStages]
  uint64_t* k_empty;     // [kStages]
  uint64_t* v_empty;     // [kStages]
};

__device__ __forceinline__ Smem carve(unsigned char* raw) {
  const uint32_t a = smem_u32(raw);
  unsigned char* base = raw + (((a + 1023) & ~1023u) - a);
  Smem s;
  s.q = base;
  s.k = base + kKOff;
  s.v = base + kVOff;
  s.q_full = reinterpret_cast<uint64_t*>(base + kBarOff);
  s.k_full = s.q_full + 1;
  s.v_full = s.k_full + kStages;
  s.k_empty = s.v_full + kStages;
  s.v_empty = s.k_empty + kStages;
  return s;
}

struct Maps {
  const CUtensorMap *q, *k, *v, *o;
};

// thread 0: tile it's K (or V) into its stage
__device__ __forceinline__ void load_kv(unsigned char* dst, uint64_t* bar,
                                        const CUtensorMap* map, int it,
                                        int kvh, int b) {
  mbar_arrive_tx(bar, kTileBytes);
  for (int part = 0; part < kParts; ++part)
    tma_load(dst + part * kKPart, map, bar, part * kBoxChannels, kvh,
             it * kBk, b);
}

// One warpgroup: 64 query rows, starting at q0 + 64 * wg
template <bool kLse>
__device__ __forceinline__ void consume(const Smem& sm, const Maps& m,
                                        float* __restrict__ lse, int wg,
                                        int n_tiles, int q0, int b, int h,
                                        int kvh, int L, int H, int length,
                                        int causal, float scale_log2) {
  const int t = threadIdx.x % 128, warp = t / 32, lane = t % 32;
  const int row0 = 16 * warp + lane / 4;          // and row0 + 8
  const int first = q0 + 64 * wg;                 // the warpgroup's row 0
  const int pos0 = first + row0, pos1 = pos0 + 8;
  const uint64_t q_desc = desc_kmajor(smem_u32(sm.q) + wg * (kQPart / 2));
  // the key tiles this warpgroup's rows can see: the CTA's, or one fewer
  const int kend = causal ? min(length, first + 64) : length;
  const int n_mine = min(n_tiles, (kend + kBk - 1) / kBk);

  float o[2][64];                    // channel halves 0-127, 128-255
#pragma unroll
  for (int i = 0; i < 64; ++i) o[0][i] = o[1][i] = 0.f;
  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;

  mbar_wait(sm.q_full, 0);
  for (int it = 0; it < n_mine; ++it) {
    const int stage = it % kStages, parity = (it / kStages) & 1;
    mbar_wait(sm.k_full + stage, parity);
    const uint64_t kd = desc_kmajor(smem_u32(sm.k) + stage * kTileBytes);

    float s[32];
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 16; ++kk)                // S = Q K^T
      wgmma_ss_n64<0, 0>(s, step_kmajor(q_desc, kk, kQPart),
                         step_kmajor(kd, kk, kKPart), kk > 0);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(s);
    if (t == 0) mbar_arrive(sm.k_empty + stage);
    // thread 0: once both warpgroups' scores have read this K, tile it + 2's
    if (threadIdx.x == 0 && it + kStages < n_tiles) {
      mbar_wait(sm.k_empty + stage, parity);
      load_kv(sm.k + stage * kTileBytes, sm.k_full + stage, m.k,
              it + kStages, kvh, b);
    }
    __syncwarp();

    const int k0 = it * kBk;
    const bool masked = k0 + kBk > length ||
                        (causal && k0 + kBk - 1 > first);
    float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
    for (int i = 0; i < 32; ++i) {
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
    for (int i = 0; i < 32; ++i) {
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
    mbar_wait(sm.v_full + stage, parity);
    const uint32_t v_tile = smem_u32(sm.v) + stage * kTileBytes;
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
    if (t == 0) mbar_arrive(sm.v_empty + stage);
    if (threadIdx.x == 0 && it + kStages < n_tiles) {
      mbar_wait(sm.v_empty + stage, parity);
      load_kv(sm.v + stage * kTileBytes, sm.v_full + stage, m.v,
              it + kStages, kvh, b);
    }
    __syncwarp();
  }

  l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
  l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
  // the final divide guards l >= 1e-30, as the JAX contract says
  const float d0 = fmaxf(l0, 1e-30f), d1 = fmaxf(l1, 1e-30f);
  // O -> the warpgroup's rows of the Q tile (their last reader was this
  // warpgroup's final S product), then one TMA store per part
  unsigned char* out_tile = sm.q + wg * (kQPart / 2);
#pragma unroll
  for (int half = 0; half < 2; ++half)
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      unsigned char* part = out_tile + (2 * half + i / 8) * kQPart;
      const int byte = (i % 8) * 16 + 4 * (lane % 4);
      *reinterpret_cast<uint32_t*>(part + sw128(row0, byte)) =
          pack_bf16(o[half][4 * i] / d0, o[half][4 * i + 1] / d0);
      *reinterpret_cast<uint32_t*>(part + sw128(row0 + 8, byte)) =
          pack_bf16(o[half][4 * i + 2] / d1, o[half][4 * i + 3] / d1);
    }
  fence_proxy_async();
  named_sync(1 + wg, 128);
  if (t == 0) {
#pragma unroll
    for (int part = 0; part < kParts; ++part)
      tma_store(m.o, out_tile + part * kQPart, part * kBoxChannels, h,
                first, b);
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
flash_fwd_hd256_kernel(
    const __grid_constant__ CUtensorMap qmap,   // (B, L, H, 256)
    const __grid_constant__ CUtensorMap kmap,   // (B, S, KV, 256)
    const __grid_constant__ CUtensorMap vmap,
    const __grid_constant__ CUtensorMap omap,   // (B, L, H, 256)
    const int* __restrict__ lengths,            // (B,) key lengths
    int L, int S, int H, int KV, int causal, float sm_scale,
    float* __restrict__ lse) {                  // (B, H, L) f32, kLse
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

  const Maps m{&qmap, &kmap, &vmap, &omap};
  if (threadIdx.x == 0) {
    mbar_init(sm.q_full, 1);
    for (int i = 0; i < kStages; ++i) {
      mbar_init(sm.k_full + i, 1);
      mbar_init(sm.v_full + i, 1);
      mbar_init(sm.k_empty + i, 2);    // one arrival per warpgroup
      mbar_init(sm.v_empty + i, 2);
    }
    fence_barrier_init();
    tma_prefetch(m.q);
    tma_prefetch(m.k);
    tma_prefetch(m.v);
    mbar_arrive_tx(sm.q_full, kQBytes);
    for (int r = 0; r < kBq; r += kQBox)
      for (int part = 0; part < kParts; ++part)
        tma_load(sm.q + part * kQPart + r * 128, m.q, sm.q_full,
                 part * kBoxChannels, h, q0 + r, b);
    for (int it = 0; it < kStages && it < n_tiles; ++it) {
      load_kv(sm.k + it * kTileBytes, sm.k_full + it, m.k, it, kvh, b);
      load_kv(sm.v + it * kTileBytes, sm.v_full + it, m.v, it, kvh, b);
    }
  }
  __syncthreads();

  // the warpgroup index, uniform across each warp by construction
  const int wg = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);
  consume<kLse>(sm, m, lse, wg, n_tiles, q0, b, h, kvh, L, H, length, causal,
                sm_scale * kLog2e);
}

template <bool kLse>
int launch_fwd(const void* q, const void* k, const void* v,
               const void* lengths, void* out, void* lse, int B, int L,
               int S, int H, int KV, int causal, float sm_scale,
               void* stream) {
  static const cudaError_t attr = cudaFuncSetAttribute(
      flash_fwd_hd256_kernel<kLse>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  if (KV <= 0 || H % KV != 0) return static_cast<int>(cudaErrorInvalidValue);
  if (B <= 0 || L <= 0) return 0;
  CUtensorMap qmap, kmap, vmap, omap;
  int err = encode_rows_map(&qmap, q, B, L, H, kQBox, kHd);
  if (!err) err = encode_rows_map(&kmap, k, B, S, KV, kBk, kHd);
  if (!err) err = encode_rows_map(&vmap, v, B, S, KV, kBk, kHd);
  if (!err) err = encode_rows_map(&omap, out, B, L, H, kQBox, kHd);
  if (err) return err;
  // one CTA per (query tile, batch row, head), decoded by the kernel
  const dim3 grid((L + kBq - 1) / kBq * B * H);
  flash_fwd_hd256_kernel<kLse><<<grid, kThreads, kSmemBytes,
                                 static_cast<cudaStream_t>(stream)>>>(
      qmap, kmap, vmap, omap, static_cast<const int*>(lengths), L, S, H, KV,
      causal, sm_scale, static_cast<float*>(lse));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q (B, L, H, 256), k / v (B, S, KV, 256) bf16, lengths (B,) int32, out
// (B, L, H, 256) bf16
extern "C" int v3d_flash_attention_hd256(const void* q, const void* k,
                                         const void* v, const void* lengths,
                                         void* out, int B, int L, int S,
                                         int H, int KV, int causal,
                                         float sm_scale, void* stream) {
  return launch_fwd<false>(q, k, v, lengths, out, nullptr, B, L, S, H, KV,
                           causal, sm_scale, stream);
}

// the training forward: also the f32 (B, H, L) per-row logsumexp
extern "C" int v3d_flash_attention_hd256_lse(const void* q, const void* k,
                                             const void* v,
                                             const void* lengths, void* out,
                                             void* lse, int B, int L, int S,
                                             int H, int KV, int causal,
                                             float sm_scale, void* stream) {
  return launch_fwd<true>(q, k, v, lengths, out, lse, B, L, S, H, KV,
                          causal, sm_scale, stream);
}
