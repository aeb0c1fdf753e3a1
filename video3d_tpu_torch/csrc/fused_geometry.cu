// Fused depth -> camera xyz -> patch mean -> pose -> voxel id (kernel B1).
//
// Replaces: video3d_tpu/kernels/fused_geometry.py::_fused_kernel (the Pallas
// TPU kernel behind fused_patch_voxel_coords).
//
// What bounds it on an H100: nothing much. Per frame it reads the
// crop x crop depth pixels it needs (4 bytes each, ~0.6 MB at crop 384) and
// writes grid*grid*3 floats, so a 32-frame call moves ~19 MB: a few
// microseconds of HBM time, dwarfed by the launch. It is memory-bound and
// tiny.
//
// Design: one thread block per (frame, patch). The block computes the cv2
// INTER_NEAREST + center-crop source pixel of every pooled pixel in integer
// arithmetic (src = floor(dst * size / new_size)) and reads the raw depth
// through that map, so the (V, crop, crop) gathered depth tensor the TPU
// path builds outside its kernel is never materialised. Camera x, y, z are
// reduced over the patch in f32 (warp shuffles, then shared memory); the
// affine 4x4 pose is applied to the patch MEAN (it commutes with the mean),
// then the homogeneous divide, clip and round-half-to-even (rintf, as
// jnp.round / torch.round). All arithmetic is true f32: no tensor cores, so
// no TF32 truncation (the TPU kernel needed Precision.HIGHEST for the same
// reason).
#include "common.cuh"

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
fused_geometry_kernel(const int32_t* __restrict__ depths,   // (V, H, W) mm
                      const float* __restrict__ scalars,    // (V, 20)
                      float* __restrict__ out,              // (V, g, g, 3)
                      int H, int W, int crop, int new_w, int left, int grid,
                      int patch, float min_x, float min_y, float min_z,
                      float max_x, float max_y, float max_z, float voxel,
                      int discretize) {
  const int f = blockIdx.x / (grid * grid);
  const int cell = blockIdx.x % (grid * grid);
  const int gy = cell / grid, gx = cell % grid;
  const float* sc = scalars + f * 20;
  const float fx = sc[0], fy = sc[1], cx = sc[2], cy = sc[3];
  const int32_t* dep = depths + (size_t)f * H * W;

  float sx = 0.f, sy = 0.f, sz = 0.f;
  const int n = patch * patch;
  for (int p = threadIdx.x; p < n; p += kThreads) {
    const int i = gy * patch + p / patch;   // row in the cropped image
    const int j = gx * patch + p % patch;   // column in the cropped image
    const int v = min((int)(((long long)i * H) / crop), H - 1);
    const int u = min((int)(((long long)(j + left) * W) / new_w), W - 1);
    const float z = __fdiv_rn((float)dep[(size_t)v * W + u], 1000.0f);
    sx += __fdiv_rn(__fmul_rn(__fsub_rn((float)u, cx), z), fx);
    sy += __fdiv_rn(__fmul_rn(__fsub_rn((float)v, cy), z), fy);
    sz += z;
  }
  __shared__ float red[3][kThreads / 32];
  sx = v3d_warp_sum(sx);
  sy = v3d_warp_sum(sy);
  sz = v3d_warp_sum(sz);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (lane == 0) {
    red[0][warp] = sx;
    red[1][warp] = sy;
    red[2][warp] = sz;
  }
  __syncthreads();
  if (threadIdx.x != 0) return;
  float px = 0.f, py = 0.f, pz = 0.f;
  for (int w = 0; w < kThreads / 32; ++w) {
    px += red[0][w];
    py += red[1][w];
    pz += red[2][w];
  }
  const float count = (float)n;
  px = __fdiv_rn(px, count);
  py = __fdiv_rn(py, count);
  pz = __fdiv_rn(pz, count);

  const float* pose = sc + 4;   // row-major 4x4
  float world[4];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    world[r] = pose[4 * r + 0] * px + pose[4 * r + 1] * py +
               pose[4 * r + 2] * pz + pose[4 * r + 3];
  }
  const float lo[3] = {min_x, min_y, min_z};
  const float hi[3] = {max_x, max_y, max_z};
  float* o = out + (size_t)blockIdx.x * 3;
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

extern "C" int v3d_fused_geometry(const void* depths, const void* scalars,
                                  void* out, int V, int H, int W, int crop,
                                  int new_w, int left, int grid, int patch,
                                  float min_x, float min_y, float min_z,
                                  float max_x, float max_y, float max_z,
                                  float voxel, int discretize, void* stream) {
  if (V <= 0) return 0;
  fused_geometry_kernel<<<V * grid * grid, kThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(depths), static_cast<const float*>(scalars),
      static_cast<float*>(out), H, W, crop, new_w, left, grid, patch, min_x,
      min_y, min_z, max_x, max_y, max_z, voxel, discretize);
  return static_cast<int>(cudaGetLastError());
}
