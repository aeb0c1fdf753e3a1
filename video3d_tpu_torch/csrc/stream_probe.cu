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
// why this is CUDA and not Triton: explicit 16-byte streaming loads
// (__ldcs: ld.global.cs, evict-first), kUnroll rows in flight per lane,
// and a grid of several waves over the 132 SMs.
//
// Design: a block is `rows` rows of `vecs` 16-byte vectors at a row stride
// of `stride` bytes (a contiguous block is viewed as rows of up to 2 KB).
// The grid is (steps, splits): CTA (i, y) reads rows [y rpc, (y + 1) rpc)
// of step i's block of each of the K streams, so blocks too few for the
// card (99 column blocks of the vocab head) are split over their rows. A
// warp reads whole rows (lane c: vectors c, c + 32, ...; 512 contiguous
// bytes per warp-load), warp w rows w, w + 8, ..., kUnroll of them per
// load batch. Per stream, the 32-bit sums reduce across the CTA and land
// in the block's checksum with one atomicAdd (zeroed by the wrapper). The
// CTAs of split 0 also write the step's row-0 outputs: acc = t, then
// acc += float(row 0 of stream s) for s = 0..K-1 in order (sum form), or
// out_s = t + row 0 of stream s (split form), so the plain version's sums
// are equal bit for bit.
#include "common.cuh"

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
