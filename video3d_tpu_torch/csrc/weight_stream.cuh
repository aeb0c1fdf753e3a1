// Weight-streaming product for decode-sized batches, shared by kernel B8
// (int4 weights, int4_matmul.cu) and kernel B4's B>1 form (int8 weights,
// int8_matmul.cu): y (rows, out) = x (rows, in) @ W (in, out), bf16 x and
// y, 1-32 rows, every sum in f32 and one rounding at the end.
//
// What bounds it on an H100: HBM. A decode projection reads its whole
// quantized weight for a few rows of x: 2 * rows FLOP per weight element,
// far under the ~295 FLOP per byte where the tensor cores would bind. So
// each weight byte is read from HBM once for up to 16 rows, and the weight
// is never widened in memory: int8 bytes and int4 nibbles are unpacked in
// registers straight into tensor-core fragments.
//
// Design (simple first: mma.sync, no TMA, no wgmma, no shared-memory
// staging). A 128-thread block owns 64 output columns and a tile of 16 rows
// of x (more rows take more blocks, adjacent in launch order, so a weight
// byte's second read is an L2 hit); its 4 warps split the block's input
// rows. Each warp runs bf16 m16n8k16 products with f32 accumulators: A is
// 16 rows of x by 16 inputs, loaded as bf16 pairs from global memory
// (x is small and stays in L1 / L2); B is 16 inputs by 8 columns of the
// unpacked weight. The columns of n-tile j are chosen as col0 + 8 n + j
// (n = the mma column), so lane (g, t) (g = lane / 4, t = lane % 4) needs
// columns col0 + 8 g .. + 7 of each weight row it reads: one 8-byte load
// per row serves its B fragments of all 8 n-tiles, and a warp reads 64
// contiguous bytes of 4-8 rows at once. Its sums then sit at columns
// col0 + 16 t .. + 15. The 4 warps are summed in a fixed order in shared
// memory; narrow outputs also split the input over grid z, each split
// writing f32 partials to a workspace that combine_kernel sums in split
// order, then scales (int8) and rounds: no atomics, so a result never
// depends on scheduling.
//
// int4: byte p of a packed row holds input row 2p (low nibble) and 2p + 1
// (high nibble), two's complement in [-7, 7]: exactly the (k, k + 1) pair
// of a B fragment register, so the TPU kernel's split of x into even and
// odd rows (Mosaic rejects the interleave) is not needed. A nibble n
// becomes bf16 128 + (n + 8) by splicing n ^ 8 under 0x43 and then 136 is
// subtracted in bf16x2, both exact (v3d_nibble_pairs, common.cuh). The
// products of one scale group (512 inputs) accumulate in f32; at the
// group's end they are multiplied by
// the group's f32 scale and added to the f32 total, as the TPU kernel
// does. int8: each byte becomes an exact f32 (v3d_int8x4_to_float's
// splice), whose upper half is its exact bf16; the per-column scale
// multiplies the f32 sum once at the end.
#pragma once

#include "common.cuh"

namespace {

constexpr int kWarps = 4;                  // input slices per block
constexpr int kThreads = 32 * kWarps;
constexpr int kTile = 64;                  // output columns per block
constexpr int kTiles = kTile / 8;          // mma n-tiles per warp
constexpr int kRows = 16;                  // rows of x per block
constexpr int kMaxRows = 32;
constexpr int kChunk = 512;                // inputs per split unit (and group)
constexpr int kStep = 16;                  // inputs per mma
constexpr int kUnroll = 4;                 // steps whose loads go out together

typedef __nv_bfloat16 bf16;

// d += a (16 x 16 bf16, row-major) * b (16 x 8 bf16, column-major)
__device__ __forceinline__ void mma_bf16(float* d, const unsigned* a,
                                         unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// byte k of two int8 rows -> the bf16 pair (row a, row b), exact
__device__ __forceinline__ unsigned int8_pair(unsigned a, unsigned b, int k) {
  const unsigned sel = 0x7440u + k;
  const float fa = __int_as_float(
      __byte_perm(a ^ 0x80808080u, 0x4B000000u, sel)) - 8388736.f;
  const float fb = __int_as_float(
      __byte_perm(b ^ 0x80808080u, 0x4B000000u, sel)) - 8388736.f;
  return __byte_perm(__float_as_uint(fa), __float_as_uint(fb), 0x7632);
}

__device__ __forceinline__ unsigned load_pair(const bf16* p, bool ok) {
  return ok ? __ldg(reinterpret_cast<const unsigned*>(p)) : 0u;
}

__device__ __forceinline__ uint2 load_row(const int8_t* p, bool ok) {
  return ok ? __ldg(reinterpret_cast<const uint2*>(p)) : make_uint2(0u, 0u);
}

template <bool kInt4>
__global__ void __launch_bounds__(kThreads)
stream_kernel(const bf16* __restrict__ x,        // (rows, in)
              const int8_t* __restrict__ w,      // (in, out) / (in/2, out)
              const bf16* __restrict__ scale,    // (1, out) / (in/group, out)
              bf16* __restrict__ y,              // (rows, out)
              float* __restrict__ ws,            // (splits, rows, out)
              int rows, int in, int out, int group, int per_split) {
  __shared__ float red[kWarps][32][kTiles * 4];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int row0 = blockIdx.x * kRows;
  const int col0 = blockIdx.y * kTile;
  const bool live = col0 + 8 * g < out;    // out % 8 == 0: all 8 or none
  const bool v0 = row0 + g < rows, v1 = row0 + g + 8 < rows;
  const bf16* x0 = x + (long long)(row0 + g) * in + 2 * t;
  const bf16* x1 = x0 + 8LL * in;
  const int8_t* wl = w + col0 + 8 * g;
  // this block's input steps, then this warp's contiguous share of them
  const int steps = (in + kStep - 1) / kStep;
  const int b_begin = min(steps, blockIdx.z * per_split * (kChunk / kStep));
  const int b_end = min(steps, b_begin + per_split * (kChunk / kStep));
  const int share = (b_end - b_begin + kWarps - 1) / kWarps;
  const int s_begin = min(b_end, b_begin + warp * share);
  const int s_end = min(b_end, s_begin + share);
  const int group_steps = group / kStep;

  float part[kTiles][4], total[kTiles][4];
#pragma unroll
  for (int j = 0; j < kTiles; ++j)
#pragma unroll
    for (int c = 0; c < 4; ++c) part[j][c] = total[j][c] = 0.f;

  for (int s = s_begin; s < s_end; s += kUnroll) {
    constexpr int kLoads = kInt4 ? 2 : 4;  // weight rows per lane and step
    unsigned a[kUnroll][4];
    uint2 wv[kUnroll][kLoads];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int k0 = (s + u) * kStep;
      const bool ok = s + u < s_end;
      // inputs k0 + 2t (+1) and k0 + 8 + 2t (+1); in % 2 == 0
      const bool k_lo = ok && k0 + 2 * t < in, k_hi = ok && k0 + 8 + 2 * t < in;
      a[u][0] = load_pair(x0 + k0, k_lo && v0);
      a[u][1] = load_pair(x1 + k0, k_lo && v1);
      a[u][2] = load_pair(x0 + k0 + 8, k_hi && v0);
      a[u][3] = load_pair(x1 + k0 + 8, k_hi && v1);
      if constexpr (kInt4) {
        // packed rows k0/2 + t (inputs k0 + 2t, +1) and + 4 (k0 + 8 + 2t)
        const int8_t* p = wl + (long long)(k0 / 2 + t) * out;
        wv[u][0] = load_row(p, ok && live);
        wv[u][1] = load_row(p + 4LL * out, ok && live);
      } else {
        const int8_t* p = wl + (long long)(k0 + 2 * t) * out;
        wv[u][0] = load_row(p, k_lo && live);
        wv[u][1] = load_row(p + out, k_lo && live);
        wv[u][2] = load_row(p + 8LL * out, k_hi && live);
        wv[u][3] = load_row(p + 9LL * out, k_hi && live);
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (s + u >= s_end) break;
      unsigned b0[kTiles], b1[kTiles];
      if constexpr (kInt4) {
        v3d_nibble_pairs(wv[u][0].x, b0);
        v3d_nibble_pairs(wv[u][0].y, b0 + 4);
        v3d_nibble_pairs(wv[u][1].x, b1);
        v3d_nibble_pairs(wv[u][1].y, b1 + 4);
      } else {
#pragma unroll
        for (int j = 0; j < kTiles; ++j) {
          const int k = j % 4;
          b0[j] = int8_pair(j < 4 ? wv[u][0].x : wv[u][0].y,
                            j < 4 ? wv[u][1].x : wv[u][1].y, k);
          b1[j] = int8_pair(j < 4 ? wv[u][2].x : wv[u][2].y,
                            j < 4 ? wv[u][3].x : wv[u][3].y, k);
        }
      }
#pragma unroll
      for (int j = 0; j < kTiles; ++j) mma_bf16(part[j], a[u], b0[j], b1[j]);
      if constexpr (kInt4) {
        // at the end of a scale group (or of this warp's share): the
        // group's sums times its f32 scales, columns col0 + 16t + j and
        // col0 + 16t + 8 + j
        const int next = s + u + 1;
        if (next % group_steps == 0 || next == s_end) {
          float sc[16];
          const bf16* sp = scale + (long long)((s + u) * kStep / group) * out
              + col0 + 16 * t;
          v3d_bf16x8_to_float(__ldg(reinterpret_cast<const uint4*>(sp)), sc);
          v3d_bf16x8_to_float(__ldg(reinterpret_cast<const uint4*>(sp + 8)),
                              sc + 8);
#pragma unroll
          for (int j = 0; j < kTiles; ++j) {
            total[j][0] = fmaf(part[j][0], sc[j], total[j][0]);
            total[j][1] = fmaf(part[j][1], sc[8 + j], total[j][1]);
            total[j][2] = fmaf(part[j][2], sc[j], total[j][2]);
            total[j][3] = fmaf(part[j][3], sc[8 + j], total[j][3]);
#pragma unroll
            for (int c = 0; c < 4; ++c) part[j][c] = 0.f;
          }
        }
      }
    }
  }

  // accumulator c of n-tile j sits at row g + 8 (c / 2), column
  // col0 + 16 t + 8 (c % 2) + j; the 4 warps are summed in order
#pragma unroll
  for (int j = 0; j < kTiles; ++j)
#pragma unroll
    for (int c = 0; c < 4; ++c)
      red[warp][lane][j * 4 + c] = kInt4 ? total[j][c] : part[j][c];
  __syncthreads();
  for (int idx = threadIdx.x; idx < 32 * kTiles * 4; idx += kThreads) {
    const int l = idx / (kTiles * 4), v = idx % (kTiles * 4);
    const int j = v / 4, c = v % 4;
    const int orow = row0 + l / 4 + 8 * (c / 2);
    const int oc = col0 + 16 * (l % 4) + 8 * (c % 2) + j;
    if (orow >= rows || oc >= out) continue;
    float sum = 0.f;
#pragma unroll
    for (int k = 0; k < kWarps; ++k) sum += red[k][l][v];
    if (gridDim.z == 1) {
      if constexpr (!kInt4) sum *= __bfloat162float(scale[oc]);
      y[(long long)orow * out + oc] = __float2bfloat16(sum);
    } else {
      ws[((long long)blockIdx.z * rows + orow) * out + oc] = sum;
    }
  }
}

// y = bf16(sum over splits of ws (times the int8 column scale))
template <bool kScale>
__global__ void __launch_bounds__(kThreads)
combine_kernel(const float* __restrict__ ws, const bf16* __restrict__ scale,
               bf16* __restrict__ y, int splits, int rows, int out) {
  const long long n = (long long)rows * out;
  for (long long idx = (long long)blockIdx.x * kThreads + threadIdx.x;
       idx < n; idx += (long long)gridDim.x * kThreads) {
    float s = 0.f;
    for (int k = 0; k < splits; ++k) s += ws[k * n + idx];
    if constexpr (kScale) s *= __bfloat162float(scale[idx % out]);
    y[idx] = __float2bfloat16(s);
  }
}

// Checks the shapes, launches the streaming kernel (and the combine pass
// when splits > 1) and returns cudaGetLastError().
template <bool kInt4>
int stream_matmul(const void* x, const void* w, const void* scale, void* y,
                  void* ws, int rows, int in, int out, int group, int splits,
                  void* stream) {
  const int chunks = (in + kChunk - 1) / kChunk;
  if (rows < 1 || rows > kMaxRows || in <= 0 || in % 2 != 0 || out <= 0 ||
      out % 8 != 0 || splits < 1 || splits > chunks ||
      (kInt4 && (out % kTile != 0 || group <= 0 || group % kChunk != 0 ||
                 in % group != 0)))
    return static_cast<int>(cudaErrorInvalidValue);
  const int per_split = (chunks + splits - 1) / splits;
  auto st = static_cast<cudaStream_t>(stream);
  auto* yp = static_cast<bf16*>(y);
  auto* wsp = static_cast<float*>(ws);
  const auto* sp = static_cast<const bf16*>(scale);
  const dim3 grid((rows + kRows - 1) / kRows, (out + kTile - 1) / kTile,
                  splits);
  stream_kernel<kInt4><<<grid, kThreads, 0, st>>>(
      static_cast<const bf16*>(x), static_cast<const int8_t*>(w), sp, yp,
      wsp, rows, in, out, kInt4 ? group : kChunk, per_split);
  if (splits > 1) {
    const long long n = (long long)rows * out;
    const long long want = (n + kThreads - 1) / kThreads;
    const int blocks = static_cast<int>(want < 4096 ? want : 4096);
    combine_kernel<!kInt4><<<blocks, kThreads, 0, st>>>(wsp, sp, yp, splits,
                                                        rows, out);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
