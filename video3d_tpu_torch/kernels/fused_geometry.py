"""Depth -> per-patch voxel ids (kernel B1) and its plain PyTorch version.

:func:`fused_patch_voxel_coords` dispatches on the device of ``depths``: a
CPU tensor runs :func:`reference_patch_voxel_coords` (the composed ops); a
CUDA tensor launches ``csrc/fused_geometry.cu`` (one launch a call, at the
grid of :func:`geometry_plan`) or raises. Counterpart of
``video3d_tpu/kernels/fused_geometry.py``.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import Tuple

import torch

from video3d_tpu_torch.kernels import _build
from video3d_tpu_torch.ops import geometry


def reference_patch_voxel_coords(depths, intrinsic, poses, crop: int = 384,
                                 grid: int = 14,
                                 min_xyz=(-15, -15, -5), max_xyz=(15, 15, 5),
                                 voxel: float = 0.1,
                                 discretize: bool = True) -> torch.Tensor:
    """unproject -> resize_nearest -> center_crop -> patch mean -> voxelize."""
    V, H, W = depths.shape
    wc = geometry.unproject(intrinsic, poses, depths)
    new_w = int(W * (crop / H))
    wc = geometry.center_crop(geometry.resize_nearest(wc, (crop, new_w)),
                              (crop, crop))
    pooled = geometry.average_coordinate_in_patch(wc, patch_size=crop // grid)
    if discretize:
        pooled = geometry.discrete_coords(pooled, min_xyz, max_xyz, voxel)
    return pooled


#: widest crop the kernel takes: its per-block tables (8 bytes a pooled
#: column and a patch row) stay under the 48 KB of shared memory a launch
#: gets without an opt-in
MAX_CROP = 2048


@dataclass(frozen=True)
class GeometryPlan:
    """B1's launch at one input size: the nearest resize to (crop, new_w),
    the center crop's left edge, ``grid`` x ``grid`` patches of ``patch``
    pixels a side; the kernel runs one block per (frame, patch row)."""
    H: int
    W: int
    crop: int
    grid: int

    @property
    def new_w(self) -> int:
        return int(self.W * (self.crop / self.H))

    @property
    def left(self) -> int:
        return (self.new_w - self.crop) // 2

    @property
    def patch(self) -> int:
        return self.crop // self.grid

    def source_maps(self) -> Tuple[torch.Tensor, torch.Tensor]:
        """(crop,) int32 source rows and columns of the cropped, resized
        pixels: row i reads min(i H / crop, H - 1), column j min((j +
        left) W / new_w, W - 1) (JAX ``_src_maps``). A host mirror of the
        32-bit formula the kernel evaluates per block; the bytes B1 must
        read follow from it."""
        i = torch.arange(self.crop, dtype=torch.int32)
        rows = torch.clamp(i * self.H // self.crop, max=self.H - 1)
        cols = torch.clamp((i + self.left) * self.W // self.new_w,
                           max=self.W - 1)
        return rows, cols


@functools.lru_cache(maxsize=None)
def geometry_plan(H: int, W: int, crop: int, grid: int) -> GeometryPlan:
    """The plan of a (V, H, W) call; raises on a size the kernel does not
    take: the crop must fit the resized image and hold the patches, and
    the kernel's int32 products (i H for i < crop, (j + left) W for j +
    left < new_w, the offset of a pixel in its frame) stay below 2^31."""
    plan = GeometryPlan(H, W, crop, grid)
    if not (0 < crop <= min(H, plan.new_w, MAX_CROP) and 0 < grid
            and grid * plan.patch > 0):
        raise ValueError(f"crop {crop} / grid {grid} do not fit {H}x{W}")
    if max(crop * H, plan.new_w * W, H * W) >= 2 ** 31:
        raise ValueError(f"{H}x{W} at crop {crop}: the kernel's int32 "
                         f"source maps would overflow")
    return plan


def fused_patch_voxel_coords(depths: torch.Tensor, intrinsic: torch.Tensor,
                             poses: torch.Tensor, crop: int = 384,
                             grid: int = 14,
                             min_xyz: Tuple[float, float, float] = (-15, -15, -5),
                             max_xyz: Tuple[float, float, float] = (15, 15, 5),
                             voxel: float = 0.1,
                             discretize: bool = True) -> torch.Tensor:
    """(V, H, W) int32 raw depths (mm) -> (V, grid, grid, 3) f32 voxel ids
    (or world coords with ``discretize=False``); ``intrinsic`` (4, 4) or
    (V, 4, 4), ``poses`` (V, 4, 4), read as f32."""
    if depths.device.type == "cpu":
        return reference_patch_voxel_coords(depths, intrinsic, poses, crop,
                                            grid, min_xyz, max_xyz, voxel,
                                            discretize)
    if depths.device.type != "cuda":
        raise ValueError(f"fused_patch_voxel_coords: no kernel for device "
                         f"{depths.device}")
    if depths.dim() != 3 or depths.dtype != torch.int32:
        raise ValueError(f"depths must be (V, H, W) int32, got "
                         f"{tuple(depths.shape)} {depths.dtype}")
    V, H, W = depths.shape
    plan = geometry_plan(H, W, crop, grid)
    depths = depths.contiguous()
    intr, poses = (t.to(device=depths.device, dtype=torch.float32)
                   .contiguous() for t in (intrinsic, poses))
    if intr.shape not in ((4, 4), (V, 4, 4)) or poses.shape != (V, 4, 4):
        raise ValueError(f"intrinsic {tuple(intr.shape)} / poses "
                         f"{tuple(poses.shape)} for {V} frames")
    out = torch.empty((V, grid, grid, 3), dtype=torch.float32,
                      device=depths.device)
    lib = _build.library()
    err = lib.v3d_fused_geometry(
        depths.data_ptr(), intr.data_ptr(), 16 if intr.dim() == 3 else 0,
        poses.data_ptr(), out.data_ptr(), V, H, W, crop, plan.new_w,
        plan.left, grid, plan.patch, *[float(x) for x in min_xyz],
        *[float(x) for x in max_xyz], float(voxel), int(discretize),
        torch.cuda.current_stream(depths.device).cuda_stream)
    _build.check(err, "fused_geometry")
    _build.count_launch("fused_geometry")
    return out
