"""Depth -> per-patch voxel ids (kernel B1) and its plain PyTorch version.

:func:`fused_patch_voxel_coords` dispatches on the device of ``depths``: a
CPU tensor runs :func:`reference_patch_voxel_coords` (the composed ops); a
CUDA tensor launches ``csrc/fused_geometry.cu`` or raises. Counterpart of
``video3d_tpu/kernels/fused_geometry.py``.
"""

from __future__ import annotations

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


def _frame_scalars(intrinsic: torch.Tensor, poses: torch.Tensor) -> torch.Tensor:
    """(V, 20) f32 per-frame table: fx, fy, cx, cy, then the 16 pose entries."""
    V = poses.shape[0]
    if intrinsic.dim() == 2:
        intrinsic = intrinsic.expand(V, 4, 4)
    cam = torch.stack([intrinsic[:, 0, 0], intrinsic[:, 1, 1],
                       intrinsic[:, 0, 2], intrinsic[:, 1, 2]], dim=1)
    return torch.cat([cam.to(torch.float32),
                      poses.reshape(V, 16).to(torch.float32)],
                     dim=1).contiguous()


def fused_patch_voxel_coords(depths: torch.Tensor, intrinsic: torch.Tensor,
                             poses: torch.Tensor, crop: int = 384,
                             grid: int = 14,
                             min_xyz: Tuple[float, float, float] = (-15, -15, -5),
                             max_xyz: Tuple[float, float, float] = (15, 15, 5),
                             voxel: float = 0.1,
                             discretize: bool = True) -> torch.Tensor:
    """(V, H, W) int32 raw depths (mm) -> (V, grid, grid, 3) f32 voxel ids
    (or world coords with ``discretize=False``)."""
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
    new_w = int(W * (crop / H))
    left = (new_w - crop) // 2
    patch = crop // grid
    if crop > H or crop > new_w or grid * patch > crop:
        raise ValueError(f"crop {crop} / grid {grid} do not fit {H}x{W}")
    depths = depths.contiguous()
    scalars = _frame_scalars(intrinsic.to(depths.device),
                             poses.to(depths.device))
    out = torch.empty((V, grid, grid, 3), dtype=torch.float32,
                      device=depths.device)
    lib = _build.library()
    err = lib.v3d_fused_geometry(
        depths.data_ptr(), scalars.data_ptr(), out.data_ptr(), V, H, W, crop,
        new_w, left, grid, patch, *[float(x) for x in min_xyz],
        *[float(x) for x in max_xyz], float(voxel), int(discretize),
        torch.cuda.current_stream(depths.device).cuda_stream)
    _build.check(err, "fused_geometry")
    _build.count_launch("fused_geometry")
    return out
