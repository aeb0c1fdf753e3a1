// Weight-only int8 matvec for one row, bf16 in, bf16 out (kernel B4):
// y[c] = bf16((sum_i x[i] * q[i, c]) * scale[c]), the sum in f32.
//
// Replaces: video3d_tpu/kernels/quant_matvec.py::_int8_mv_kernel (entry
// int8_matmul with one row), dispatched by models/quant.py only for the
// B=1 vocab head (out >= 32768). The B>1 form (_int8_kernel) is not ported.
//
// What bounds it on an H100: HBM. At the vocab head (in 3584, out 152064)
// the int8 weight is 545 MB, read once, for 2 FLOP per byte: ~0.16 ms at
// 3.35 TB/s; x (7 KB) and y (0.3 MB) are noise.
//
// Design: the weight is (in, out) with out contiguous, so a warp reads 512
// contiguous bytes of one input row with one 16-byte load per lane (16
// columns per lane). A 128-thread block owns a 512-column tile and splits
// the input rows across its 4 warps (row r goes to warp r % 4); x is
// staged in shared memory in f32, 1024 rows at a time. Each lane keeps 16
// f32 partial sums; the 4 warps' partials are summed in shared memory, then
// multiplied by the f32 scale and rounded once, as the TPU kernel does. The
// 297 blocks of the vocab head all fit on the card at once. int8 -> f32 is
// exact (v3d_int8x4_to_float). Simple first: no cp.async / TMA staging.
#include "common.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kCols = 16;             // int8 columns per lane
constexpr int kTile = 32 * kCols;     // columns per block
constexpr int kChunk = 1024;          // rows of x staged at a time

typedef __nv_bfloat16 bf16;

__global__ void __launch_bounds__(kThreads)
int8_matvec_kernel(const bf16* __restrict__ x,       // (in,)
                   const int8_t* __restrict__ q,     // (in, out)
                   const bf16* __restrict__ scale,   // (out,)
                   bf16* __restrict__ y,             // (out,)
                   int in, int out) {
  __shared__ float xs[kChunk];
  __shared__ float red[kWarps][kTile];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int col = blockIdx.x * kTile + lane * kCols;
  const bool live = col < out;     // out % kCols == 0: all 16 or none

  float acc[kCols];
#pragma unroll
  for (int j = 0; j < kCols; ++j) acc[j] = 0.f;
  const int8_t* qc = q + col;
  for (int r0 = 0; r0 < in; r0 += kChunk) {
    const int n = min(kChunk, in - r0);
    __syncthreads();                    // every warp is done with xs
    for (int i = threadIdx.x; i < n; i += kThreads)
      xs[i] = __bfloat162float(x[r0 + i]);
    __syncthreads();
    if (live) {
#pragma unroll 8
      for (int r = warp; r < n; r += kWarps) {
        const uint4 w = __ldg(reinterpret_cast<const uint4*>(
            qc + (long long)(r0 + r) * out));
        const float xv = xs[r];
        float f[kCols];
        v3d_int8x4_to_float(w.x, f);
        v3d_int8x4_to_float(w.y, f + 4);
        v3d_int8x4_to_float(w.z, f + 8);
        v3d_int8x4_to_float(w.w, f + 12);
#pragma unroll
        for (int j = 0; j < kCols; ++j) acc[j] = fmaf(xv, f[j], acc[j]);
      }
    }
  }
#pragma unroll
  for (int j = 0; j < kCols; ++j) red[warp][lane * kCols + j] = acc[j];
  __syncthreads();
  for (int c = threadIdx.x; c < kTile; c += kThreads) {
    const int oc = blockIdx.x * kTile + c;
    if (oc < out) {
      float s = 0.f;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) s += red[w][c];
      y[oc] = __float2bfloat16(s * __bfloat162float(scale[oc]));
    }
  }
}

}  // namespace

extern "C" int v3d_int8_matvec(const void* x, const void* q,
                               const void* scale, void* y, int in, int out,
                               void* stream) {
  if (in <= 0 || out <= 0 || out % kCols != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  int8_matvec_kernel<<<(out + kTile - 1) / kTile, kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(x), static_cast<const int8_t*>(q),
      static_cast<const bf16*>(scale), static_cast<bf16*>(y), in, out);
  return static_cast<int>(cudaGetLastError());
}
