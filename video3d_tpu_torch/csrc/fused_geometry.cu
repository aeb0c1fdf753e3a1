// Fused depth -> camera xyz -> patch mean -> pose -> voxel id (kernel B1).
//
// Replaces: video3d_tpu/kernels/fused_geometry.py::_fused_kernel (the Pallas
// TPU kernel behind fused_patch_voxel_coords).
//
// What bounds it on an H100: not the launch. At the main path's shape (V
// = 32 frames of 480 x 640, crop 384, grid 14, patch 27) it reads the
// 4.57M depth pixels the pooled patches cover, which lie in 22.8 MB of
// 32-byte sectors of the 39 MB of depths (0.0068 ms at 3.35 TB/s: the
// bound chip_smoke.py counts), and runs three correctly rounded f32
// divisions per pixel, ~40 lane instructions a pixel in all (~6 us at the
// SMs' issue rate, estimated from the source). Measured on an H100 80GB
// HBM3 at 700 W (scripts/torch_port/matvec_geometry_ab.py): 0.0206 ms
// warm and 0.0238 with the L2 flushed, 3.0x and 3.5x its bound; the rest
// is most likely the loads' latency (two dependent rounds of loads a warp,
// 1.7 waves of blocks), which no profiler on that machine could confirm.
// The one-block-per-patch kernel it replaced took 0.0538 and 0.0599
// through its wrapper.
//
// Design: a patch row of a frame is cut into `parts` blocks of at most
// kMaxWarps patches (grid 14: 2 x 7), one warp a patch: 896 blocks at the
// main shape, so the SMs' shares differ by at most one small block. A block
// first computes, in 32-bit integers, the cv2 INTER_NEAREST + center-crop
// source column of each of its pooled columns and the source row of each
// of its patch rows (src = floor(dst * size / new_size), JAX's _src_maps;
// the wrapper checks that the products fit in int32), with u - cx and
// v - cy, into shared memory; the (V, crop, crop) gathered depth tensor the
// TPU path builds outside its kernel is never made. Lane c of a warp takes
// column c of its patch (c + 32, ... for patches wider than a warp) down
// the patch's rows, kChunk rows' loads issued before any is used, so a
// warp reads runs of source rows and keeps its sums in registers:
// z = d / 1000, x = (u - cx) z / fx and y = (v - cy) z / fy in correctly
// rounded f32 (no reciprocals, no tensor cores: the TPU kernel needed
// Precision.HIGHEST for the same reason). The warp then adds its lanes'
// sums, and its lane 0 applies the affine 4x4 pose to the patch MEAN (it
// commutes with the mean), the homogeneous divide, the clip and the
// round-half-to-even (rintf, as jnp.round / torch.round): a block's
// epilogues run on as many lanes at once. fx, fy, cx, cy and the pose are
// read from the caller's f32 intrinsic and poses, so a call is one launch.
#include "common.cuh"

namespace {

constexpr int kMaxWarps = 8;   // patches of a block: one a warp
constexpr int kChunk = 16;     // rows a lane loads before it computes them

__global__ void __launch_bounds__(32 * kMaxWarps)
fused_geometry_kernel(const int32_t* __restrict__ depths,   // (V, H, W) mm
                      const float* __restrict__ intrinsic,  // (4, 4) or
                      int intrinsic_stride,                 // (V, 4, 4)
                      const float* __restrict__ poses,      // (V, 4, 4)
                      float* __restrict__ out,              // (V, g, g, 3)
                      int H, int W, int crop, int new_w, int left, int grid,
                      int patch, int parts, float min_x, float min_y,
                      float min_z, float max_x, float max_y, float max_z,
                      float voxel, int discretize) {
  extern __shared__ int smem[];
  const int per = blockDim.x / 32;
  const int f = blockIdx.x / (grid * parts);
  const int rest = blockIdx.x - f * grid * parts;
  const int gy = rest / parts, gx0 = (rest - gy * parts) * per;
  const int cols = min(per, grid - gx0) * patch;
  int* src_col = smem;                                       // (cols,)
  float* du = reinterpret_cast<float*>(src_col + cols);      // u - cx
  int* row_off = reinterpret_cast<int*>(du + cols);          // (patch,)
  float* dv = reinterpret_cast<float*>(row_off + patch);     // v - cy
  const float* k = intrinsic + f * intrinsic_stride;
  const float fx = k[0], fy = k[5], cx = k[2], cy = k[6];
  for (int t = threadIdx.x; t < cols; t += blockDim.x) {
    const int u = min((gx0 * patch + t + left) * W / new_w, W - 1);
    src_col[t] = u;
    du[t] = __fsub_rn(static_cast<float>(u), cx);
  }
  for (int t = threadIdx.x; t < patch; t += blockDim.x) {
    const int v = min((gy * patch + t) * H / crop, H - 1);
    row_off[t] = v * W;                  // the source row's offset
    dv[t] = __fsub_rn(static_cast<float>(v), cy);
  }
  __syncthreads();

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (warp * patch >= cols) return;      // past the last patch of the row
  const int32_t* frame = depths + static_cast<size_t>(f) * H * W;
  float sx = 0.f, sy = 0.f, sz = 0.f;
  for (int c = lane; c < patch; c += 32) {
    const int t = warp * patch + c;
    const int32_t* col = frame + src_col[t];
    const float dx = du[t];
    for (int r0 = 0; r0 < patch; r0 += kChunk) {
      int d[kChunk];
#pragma unroll
      for (int i = 0; i < kChunk; ++i)
        if (r0 + i < patch) d[i] = __ldg(col + row_off[r0 + i]);
#pragma unroll
      for (int i = 0; i < kChunk; ++i) {
        if (r0 + i >= patch) break;
        const float z = __fdiv_rn(static_cast<float>(d[i]), 1000.0f);
        sx += __fdiv_rn(__fmul_rn(dx, z), fx);
        sy += __fdiv_rn(__fmul_rn(dv[r0 + i], z), fy);
        sz += z;
      }
    }
  }
  sx = v3d_warp_sum(sx);
  sy = v3d_warp_sum(sy);
  sz = v3d_warp_sum(sz);
  if (lane != 0) return;
  const float count = static_cast<float>(patch * patch);
  const float px = __fdiv_rn(sx, count), py = __fdiv_rn(sy, count),
              pz = __fdiv_rn(sz, count);
  const float* pose = poses + f * 16;                        // row-major
  float world[4];
#pragma unroll
  for (int r = 0; r < 4; ++r)
    world[r] = pose[4 * r + 0] * px + pose[4 * r + 1] * py +
               pose[4 * r + 2] * pz + pose[4 * r + 3];
  const float lo[3] = {min_x, min_y, min_z};
  const float hi[3] = {max_x, max_y, max_z};
  float* o = out +
      ((static_cast<size_t>(f) * grid + gy) * grid + gx0 + warp) * 3;
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    float w = __fdiv_rn(world[a], world[3]);
    if (discretize) {
      w = fminf(fmaxf(w, lo[a]), hi[a]);
      w = rintf(__fdiv_rn(__fsub_rn(w, lo[a]), voxel));
    }
    o[a] = w;
  }
}

}  // namespace

// intrinsic_stride: 16 for per-frame (V, 4, 4) intrinsics, 0 for one
// shared (4, 4); kernels/fused_geometry.py, geometry_plan, gives new_w,
// left and patch and checks the shape (crop * H, new_w * W and H * W
// below 2^31)
extern "C" int v3d_fused_geometry(const void* depths, const void* intrinsic,
                                  int intrinsic_stride, const void* poses,
                                  void* out, int V, int H, int W, int crop,
                                  int new_w, int left, int grid, int patch,
                                  float min_x, float min_y, float min_z,
                                  float max_x, float max_y, float max_z,
                                  float voxel, int discretize, void* stream) {
  if (V <= 0) return 0;
  if (H <= 0 || W <= 0 || crop <= 0 || crop > H || new_w < crop ||
      left < 0 || left + crop > new_w || grid <= 0 || patch <= 0 ||
      grid * patch > crop)
    return static_cast<int>(cudaErrorInvalidValue);
  // a patch row in `parts` blocks of at most kMaxWarps patches
  const int parts = (grid + kMaxWarps - 1) / kMaxWarps;
  const int per = (grid + parts - 1) / parts;
  const size_t smem = static_cast<size_t>(per * patch + patch) * 8;
  fused_geometry_kernel<<<V * grid * parts, 32 * per, smem,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(depths),
      static_cast<const float*>(intrinsic), intrinsic_stride,
      static_cast<const float*>(poses), static_cast<float*>(out), H, W, crop,
      new_w, left, grid, patch, parts, min_x, min_y, min_z, max_x, max_y,
      max_z, voxel, discretize);
  return static_cast<int>(cudaGetLastError());
}
