// Weight-only int8 matvec for one row, bf16 in, bf16 out (kernel B4's
// one-row form): y[c] = bf16((sum_i x[i] * q[i, c]) * scale[c]), the sum
// in f32 and one rounding, as the TPU kernel does.
//
// Replaces: video3d_tpu/kernels/quant_matvec.py::_int8_mv_kernel (entry
// int8_matmul with one row), which models/quant.py runs for the B=1 vocab
// head (one row, out >= 32768); every other int8 product of at most 32
// rows takes B4's B>1 form (int8_matmul.cu).
//
// What bounds it on an H100: HBM. At the vocab head (in 3584, out 152064)
// the int8 weight is 545.6 MB, read once, for 2 FLOP per byte: 0.1629 ms
// at the data sheet's 3.35 TB/s; x (7 KB) and y (0.3 MB) are noise. To
// read it in ~0.18 ms every SM has to take ~23 KB of weight per
// microsecond and keep some tens of KB in flight to cover HBM's latency.
//
// The weight-streaming template (weight_stream.cuh, its "One row"
// instantiation row_stream_kernel) does that: a TMA ring of 3 stages of
// 512 columns x 64 inputs per SM, the units of all tiles cut into one
// range per SM of the same weight bytes within one unit
// (kernels/quant_matvec.py, matvec_plan, whose ranges the kernel takes
// from its parameters: at the head 126 units each), f32 products on the
// CUDA cores, and K-slices merged in slice order inside the kernel by the
// last CTA to arrive. No float atomics: repeats are bit-identical.
#include "weight_stream.cuh"

// begins: the ctas + 1 first units of the CTAs' ranges (host memory;
// kernels/quant_matvec.py, matvec_plan: rising from 0 to the units, no
// range empty); ws / ws_bytes / counters: the workspace and the arrival
// counters (kPairs per tile, zeroed) of a plan whose CTAs split tiles
extern "C" int v3d_int8_matvec(const void* x, const void* q,
                               const void* scale, void* y, void* ws,
                               long long ws_bytes, void* counters,
                               const int* begins, int in, int out, int ctas,
                               void* stream) {
  using namespace v3d_wstream;
  if (!shapes_ok<false>(1, in, out, 0) || ctas < 1 || ctas > kMaxCtas)
    return static_cast<int>(cudaErrorInvalidValue);
  RowParams p;
  const long long units =
      fill<false>(p, x, scale, y, ws, counters, 1, in, out, 0);
  bool ok = units < (1LL << 31) && begins[0] == 0 && begins[ctas] == units;
  for (int c = 0; c <= ctas && ok; ++c) {
    p.begin[c] = begins[c];
    ok = c == 0 || begins[c] > begins[c - 1];
  }
  if (!ok) return static_cast<int>(cudaErrorInvalidValue);
  p.units = static_cast<int>(units);
  p.ctas = ctas;
  return launch_plan<false>(p, q, ws_bytes, 1, stream);
}
