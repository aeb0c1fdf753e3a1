// HBM stream-rate probes (kernel B9): K streams of blocks read whole, with
// near-zero arithmetic, and one checksum per block.
//
// Replaces the four Pallas probes of the JAX package's benchmark scripts:
//   scripts/bench/kv_probe.py:42 `kernel` (B9a: (bs, KV, hd) token blocks of
//     an int8 K and V cache, out[8j:8j+8, :] = t + k[j bs, 0, :] + v[j bs, 0, :]);
//   scripts/bench/int8_matvec.py:55 `probe_kernel` (B9b: (IN, bo) column
//     blocks of one int8 or bf16 weight, out = t + q[0, :]);
//   scripts/bench/stream_probe.py:73 `probe_kernel` (B9c: K weights at once,
//     strided (IN, bo) or contiguous (G, IN, bo) blocks, out = t + sum_k q_k[0, :]);
//   scripts/bench/stream_probe.py:113 `probe_kernel` (B9d: K streams over
//     ONE weight at column offsets j OUT / K, out_j = t + q[0, j OUT/K ...]).
// On the TPU the BlockSpec DMA moved every byte of a block whatever the body
// read. On Hopper a kernel moves only what it loads, and the compiler drops
// loads whose result goes unused, so each block also yields the wrapping
// 32-bit sum of its 4-byte words (exact in any order): every byte counts,
// and a skipped block or a wrong stride shows in the checksum.
//
// What bounds it on an H100: HBM, by construction (one 32-bit add per
// 4 bytes read). The point is to reach the card's read ceiling, which is
// why this is CUDA and not Triton.
//
// B9b-d (stream_probe_kernel): explicit 16-byte streaming loads (__ldcs:
// ld.global.cs, evict-first), kUnroll rows in flight per lane, and a grid
// of several waves over the 132 SMs. A block is `rows` rows of `vecs`
// 16-byte vectors at a row stride of `stride` bytes (a contiguous block is
// viewed as rows of up to 2 KB). The grid is (steps, splits): CTA (i, y)
// reads rows [y rpc, (y + 1) rpc) of step i's block of each of the K
// streams, so blocks too few for the card (99 column blocks of the vocab
// head) are split over their rows. A warp reads whole rows (lane c:
// vectors c, c + 32, ...; 512 contiguous bytes per warp-load), warp w rows
// w, w + 8, ..., kUnroll of them per load batch. Per stream, the 32-bit
// sums reduce across the CTA and land in the block's checksum with one
// atomicAdd (zeroed by the wrapper). The CTAs of split 0 also write the
// step's row-0 outputs: acc = t, then acc += float(row 0 of stream s) for
// s = 0..K-1 in order (sum form), or out_s = t + row 0 of stream s (split
// form), so the plain version's sums are equal bit for bit.
//
// B9a (kv_probe_kernel): K and V are contiguous, so the two streams are
// one line of 2 S KV hd bytes cut into copy units of kUnit bytes, and each
// of one CTA per SM takes an even range of units planned on the host
// (`kv_probe_plan`: CTA c starts at unit c units / ctas, nothing divided
// on the device but one 32-bit division per CTA). A producer warp streams
// the range through a ring of kSlots shared-memory slots, one 1-D bulk
// copy (cp.async.bulk, no tensor map) per unit completed on the slot's
// mbarrier; 8 consumer warps sum each slot's 32-bit words and free it. A
// range that crosses the end of a bs block splits its sum there: each warp
// adds its part into a shared slot per block touched, and the CTA adds each
// slot into that block's checksum with one atomicAdd. The CTA whose range
// holds unit 0 of K block j writes the block's 8 output rows from global
// memory: t + k[j bs, 0, :], then + v[j bs, 0, :], as the plain version.
#include "common.cuh"
#include "flash_sm90.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kUnroll = 8;
constexpr int kMaxStreams = 4;

struct Streams {
  const char* base[kMaxStreams];
};

template <typename T>
__device__ __forceinline__ float v3d_probe_elem(const char* row0, int c) {
  return static_cast<float>(reinterpret_cast<const int8_t*>(row0)[c]);
}

template <>
__device__ __forceinline__ float v3d_probe_elem<__nv_bfloat16>(
    const char* row0, int c) {
  return __bfloat162float(reinterpret_cast<const __nv_bfloat16*>(row0)[c]);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
stream_probe_kernel(Streams st, const float* __restrict__ t,
                    float* __restrict__ out, unsigned* __restrict__ checksum,
                    int K, long long step_bytes, long long stride, int rows,
                    int vecs, int rows_per_cta, int nsteps, int nout, int rep,
                    int sum_form, int t_len) {
  __shared__ unsigned red[kMaxStreams][kWarps];
  const int step = blockIdx.x;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int r0 = blockIdx.y * rows_per_cta;
  const int r1 = min(rows, r0 + rows_per_cta);
  for (int s = 0; s < K; ++s) {
    const char* blk = st.base[s] + step * step_bytes;
    unsigned acc = 0u;
    for (int rb = r0 + warp; rb < r1; rb += kWarps * kUnroll) {
      for (int c = lane; c < vecs; c += 32) {
        uint4 w[kUnroll];
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          const int r = rb + u * kWarps;
          w[u] = r < r1 ? __ldcs(reinterpret_cast<const uint4*>(
                              blk + r * stride) + c)
                        : make_uint4(0u, 0u, 0u, 0u);
        }
#pragma unroll
        for (int u = 0; u < kUnroll; ++u)
          acc += w[u].x + w[u].y + w[u].z + w[u].w;
      }
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, o);
    if (lane == 0) red[s][warp] = acc;
  }
  __syncthreads();
  if (threadIdx.x < K) {
    unsigned total = 0u;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) total += red[threadIdx.x][w];
    atomicAdd(checksum + threadIdx.x * nsteps + step, total);
  }
  if (blockIdx.y != 0) return;
  for (int c = threadIdx.x; c < nout; c += kThreads) {
    const float tc = t[t_len == 1 ? 0 : c];
    if (sum_form) {
      float v = tc;
      for (int s = 0; s < K; ++s)
        v += v3d_probe_elem<T>(st.base[s] + step * step_bytes, c);
      for (int r = 0; r < rep; ++r)
        out[(static_cast<long long>(step) * rep + r) * nout + c] = v;
    } else {
      for (int s = 0; s < K; ++s)
        out[(static_cast<long long>(s) * nsteps + step) * nout + c] =
            tc + v3d_probe_elem<T>(st.base[s] + step * step_bytes, c);
    }
  }
}

}  // namespace

// p0..p3: the K stream bases (16-byte aligned); t (t_len,) f32; out f32;
// checksum (K, nsteps) uint32, zeroed; elem_bf16: 1 for bf16 streams,
// 0 for int8 (only row 0's conversion depends on it).
extern "C" int v3d_stream_probe(const void* p0, const void* p1,
                                const void* p2, const void* p3,
                                const void* t, void* out, void* checksum,
                                int K, long long step_bytes, long long stride,
                                int rows, int vecs, int rows_per_cta,
                                int nsteps, int nout, int rep, int sum_form,
                                int t_len, int elem_bf16, void* stream) {
  if (K < 1 || K > kMaxStreams || rows <= 0 || vecs <= 0 ||
      rows_per_cta <= 0 || nsteps <= 0 || nout <= 0 || rep <= 0 ||
      stride % 16 != 0 || step_bytes % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  Streams st;
  const void* ps[kMaxStreams] = {p0, p1, p2, p3};
  for (int s = 0; s < kMaxStreams; ++s)
    st.base[s] = static_cast<const char*>(s < K ? ps[s] : p0);
  const dim3 grid(nsteps, (rows + rows_per_cta - 1) / rows_per_cta);
  cudaStream_t cs = static_cast<cudaStream_t>(stream);
  const float* tp = static_cast<const float*>(t);
  float* op = static_cast<float*>(out);
  unsigned* cp = static_cast<unsigned*>(checksum);
  if (elem_bf16)
    stream_probe_kernel<__nv_bfloat16><<<grid, kThreads, 0, cs>>>(
        st, tp, op, cp, K, step_bytes, stride, rows, vecs, rows_per_cta,
        nsteps, nout, rep, sum_form, t_len);
  else
    stream_probe_kernel<int8_t><<<grid, kThreads, 0, cs>>>(
        st, tp, op, cp, K, step_bytes, stride, rows, vecs, rows_per_cta,
        nsteps, nout, rep, sum_form, t_len);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------- B9a
namespace v3d_kvprobe {

using namespace v3d_sm90;

constexpr int kConsumerWarps = 8;
constexpr int kConsumers = kConsumerWarps * 32;
constexpr int kThreads = kConsumers + 32;   // + the producer warp
constexpr int kMaxCtas = 256;
constexpr int kMaxTouched = 32;             // bs blocks one range may touch
constexpr int kRep = 8;                     // output rows per block
// the ring: 4 slots of 32 KB copies in flight per SM (2-4 slots of
// 16-64 KB read alike, PERF.md)
constexpr int kSlots = 4;
constexpr int kUnit = 32768;                // bytes of one copy

// the first unit of each CTA's range (the host's plan), by value
struct Begins {
  int unit[kMaxCtas + 1];
};

struct Args {
  const char* k;
  const char* v;
  const float* t;
  float* out;
  unsigned* checksum;    // (2, nblocks): K's blocks, then V's
  int units_per_stream;  // units of K (and of V)
  int units_per_block;   // units of one bs block
  int nblocks;           // bs blocks per stream
  int hd;
};

// one contiguous copy of `bytes` (a multiple of 16) from global into
// shared memory, counted in bytes on `bar`
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          int bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];" ::"r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// a warp's wrapping sum, added to the shared slot of its block
__device__ __forceinline__ void flush(unsigned acc, unsigned* slot,
                                      int lane) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, o);
  if (lane == 0) atomicAdd(slot, acc);
}

__global__ void __launch_bounds__(kThreads, 1)
kv_probe_kernel(Args a, Begins b) {
  extern __shared__ __align__(128) unsigned char ring[];
  __shared__ __align__(8) uint64_t full[kSlots], empty[kSlots];
  __shared__ unsigned part[kMaxTouched];
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int u0 = b.unit[blockIdx.x], u1 = b.unit[blockIdx.x + 1];
  const int n = u1 - u0;
  const int g0 = u0 / a.units_per_block;   // the first block touched
  if (tid == 0) {
#pragma unroll
    for (int s = 0; s < kSlots; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kConsumerWarps);
    }
    fence_barrier_init();
  }
  if (tid < kMaxTouched) part[tid] = 0u;
  __syncthreads();

  if (warp == kConsumerWarps) {             // the producer
    if (lane == 0) {
      for (int i = 0; i < n; ++i) {
        const int s = i % kSlots;
        if (i >= kSlots) mbar_wait(&empty[s], (i / kSlots - 1) & 1);
        const int u = u0 + i;
        const char* src =
            u < a.units_per_stream
                ? a.k + static_cast<long long>(u) * kUnit
                : a.v + static_cast<long long>(u - a.units_per_stream) * kUnit;
        mbar_arrive_tx(&full[s], kUnit);
        bulk_load(ring + s * kUnit, src, kUnit, &full[s]);
      }
    }
    return;
  }

  // the output rows of the K blocks whose first unit lies in this range
  for (int j = g0 + (u0 != g0 * a.units_per_block);
       j < a.nblocks && j * a.units_per_block < u1; ++j) {
    const long long off = static_cast<long long>(j) * a.units_per_block * kUnit;
    for (int c = tid; c < a.hd; c += kConsumers) {
      float x = a.t[c] + static_cast<float>(
                             reinterpret_cast<const int8_t*>(a.k)[off + c]);
      x += static_cast<float>(reinterpret_cast<const int8_t*>(a.v)[off + c]);
#pragma unroll
      for (int r = 0; r < kRep; ++r)
        a.out[(static_cast<long long>(j) * kRep + r) * a.hd + c] = x;
    }
  }

  constexpr int kPerThread = kUnit / 16 / kConsumers;
  static_assert(kPerThread * 16 * kConsumers == kUnit, "unit / threads");
  unsigned acc = 0u;
  int g = g0, next = (g0 + 1) * a.units_per_block;
  for (int i = 0; i < n; ++i) {
    if (u0 + i == next) {                   // a block boundary
      flush(acc, &part[g - g0], lane);
      acc = 0u;
      ++g;
      next += a.units_per_block;
    }
    const int s = i % kSlots;
    mbar_wait(&full[s], (i / kSlots) & 1);
    const uint4* p = reinterpret_cast<const uint4*>(ring + s * kUnit);
    uint4 w[kPerThread];
#pragma unroll
    for (int r = 0; r < kPerThread; ++r) w[r] = p[tid + r * kConsumers];
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[s]);
#pragma unroll
    for (int r = 0; r < kPerThread; ++r) acc += w[r].x + w[r].y + w[r].z + w[r].w;
  }
  flush(acc, &part[g - g0], lane);
  named_sync(1, kConsumers);
  if (tid <= g - g0) atomicAdd(a.checksum + g0 + tid, part[tid]);
}

}  // namespace v3d_kvprobe

// B9a. k, v: int8 (S, KV, hd), 16-byte aligned; t (hd,) f32; out (S / bs
// * 8, hd) f32; checksum (2, S / bs) uint32, zeroed; begins (host, ctas +
// 1 ints): CTA c reads units [begins[c], begins[c + 1]) of kUnit bytes,
// K's units_per_stream units first, then V's; a bs block holds
// units_per_block units.
extern "C" int v3d_kv_probe(const void* k, const void* v, const void* t,
                            void* out, void* checksum, const int* begins,
                            int ctas, int units_per_stream,
                            int units_per_block, int hd, void* stream) {
  using namespace v3d_kvprobe;
  if (ctas < 1 || ctas > kMaxCtas || units_per_block < 1 ||
      units_per_stream < 1 || units_per_stream % units_per_block != 0 ||
      hd < 1 || begins == nullptr || begins[0] != 0 ||
      begins[ctas] != 2 * units_per_stream ||
      reinterpret_cast<uintptr_t>(k) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(v) % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  Begins b;
  for (int c = 0; c < ctas; ++c) {
    if (begins[c + 1] <= begins[c] ||
        (begins[c + 1] - 1) / units_per_block - begins[c] / units_per_block >=
            kMaxTouched)
      return static_cast<int>(cudaErrorInvalidValue);
    b.unit[c] = begins[c];
  }
  b.unit[ctas] = begins[ctas];
  const Args a{static_cast<const char*>(k), static_cast<const char*>(v),
               static_cast<const float*>(t), static_cast<float*>(out),
               static_cast<unsigned*>(checksum), units_per_stream,
               units_per_block, units_per_stream / units_per_block, hd};
  constexpr int smem = kSlots * kUnit;
  static const cudaError_t attr = cudaFuncSetAttribute(
      kv_probe_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  kv_probe_kernel<<<ctas, v3d_kvprobe::kThreads, smem,
                    static_cast<cudaStream_t>(stream)>>>(
      a, b);
  return static_cast<int>(cudaGetLastError());
}
