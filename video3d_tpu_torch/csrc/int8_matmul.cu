// Weight-only int8 product for 1-32 rows, bf16 in, bf16 out (kernel B4's
// B>1 form): y[r, c] = bf16((sum_i x[r, i] * q[i, c]) * scale[c]), the sum
// in f32 and one rounding, as the TPU kernel does.
//
// Replaces: video3d_tpu/kernels/quant_matvec.py::_int8_kernel (entry
// int8_matmul with more than one row). models/quant.py runs it for every
// int8 product of at most 32 rows except the one-row vocab head, which
// keeps B4's matvec (int8_matvec.cu): the int8 decode projections, which
// otherwise widened their weight to bf16 in memory at every step.
//
// What bounds it on an H100: HBM. A decode step streams ~7.07 GB of int8
// weights, ~2.1 ms at 3.35 TB/s; w_gate (3584 x 18944, 67.9 MB) alone
// takes 0.020 ms for 2 * rows FLOP per weight byte. The template
// (weight_stream.cuh) keeps 64 KB or more of each SM's weight bytes in
// flight through a TMA ring, reads each byte once for all rows and feeds
// it, exact in bf16, to tensor-core products with f32 sums, split inputs
// merged inside the kernel.
#include "weight_stream.cuh"

// ws / ws_bytes / counters: the workspace and the per-tile arrival
// counters of a plan whose CTAs split tiles (kernels/quant_matvec.py,
// stream_plan); ctas: the plan's grid
extern "C" int v3d_int8_matmul(const void* x, const void* q,
                               const void* scale, void* y, void* ws,
                               long long ws_bytes, void* counters, int rows,
                               int in, int out, int ctas, void* stream) {
  return v3d_wstream::stream_matmul<false>(x, q, scale, y, ws, ws_bytes,
                                           counters, rows, in, out, 0, ctas,
                                           stream);
}
