// Weight-only int4 product for 1-32 rows, bf16 in, bf16 out (kernel B8):
// y[r, c] = bf16(sum_g scale[g, c] * sum_{i in g} x[r, i] * nib(i, c)), the
// sums in f32; nib(2p, c) is the low nibble of packed[p, c], nib(2p+1, c)
// the high one, scale[g, c] the bf16 scale of input group g (512 rows).
//
// Replaces: video3d_tpu/kernels/quant_matvec.py::_int4_kernel (entry
// int4_matmul), which models/quant.py runs for every int4 product of at
// most 32 rows: each decode projection and the vocab head.
//
// What bounds it on an H100: HBM. A decode step streams ~3.7 GB of packed
// weights (~122 MB per layer with padding, 275 MB of vocab head), ~1.1 ms
// at 3.35 TB/s; at the head (3584 x 153600 padded) 0.083 ms for 2 FLOP per
// weight nibble. The template (weight_stream.cuh) keeps 64 KB or more of
// each SM's packed bytes in flight through a TMA ring, reads each byte once
// for all rows and unpacks both nibbles in registers straight into the A
// operand of tensor-core products, one f32 partial per scale group, split
// inputs merged inside the kernel.
#include "weight_stream.cuh"

// ws / ws_bytes / counters: the workspace and the per-tile arrival
// counters of a plan whose CTAs split tiles (kernels/quant_matvec.py,
// stream_plan); ctas: the plan's grid
extern "C" int v3d_int4_matmul(const void* x, const void* packed,
                               const void* scales, void* y, void* ws,
                               long long ws_bytes, void* counters, int rows,
                               int in_p, int out_p, int group, int ctas,
                               void* stream) {
  return v3d_wstream::stream_matmul<true>(x, packed, scales, y, ws, ws_bytes,
                                          counters, rows, in_p, out_p, group,
                                          ctas, stream);
}
