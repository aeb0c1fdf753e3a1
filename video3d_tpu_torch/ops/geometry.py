"""3D geometry ops in PyTorch: depth back-projection, cv2-style nearest
resize, center crop, patch pooling (means, min-max pairs, sampled points),
voxel discretization and the 2D token pools (bilinear, average, max).

Counterpart of ``video3d_tpu/ops/geometry.py``. Every function is device-agnostic plain torch; float32
matrix products here need true f32, so callers on the GPU keep TF32 off
(``torch.backends.cuda.matmul.allow_tf32 = False``, PyTorch's default).
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch


def unproject(intrinsics: torch.Tensor, poses: torch.Tensor,
              depths: torch.Tensor, depth_scale: float = 1000.0
              ) -> torch.Tensor:
    """Pinhole back-projection of (V, H, W) depth maps (mm) to world xyz.

    ``intrinsics`` (4, 4) or (V, 4, 4); ``poses`` (V, 4, 4) world-from-camera.
    Returns (V, H, W, 3) float32: z = d / 1000, x = (u - cx) z / fx,
    y = (v - cy) z / fy, world = pose @ [x, y, z, 1], divided by w.
    """
    depths = depths.to(torch.float32)
    V, H, W = depths.shape
    if intrinsics.dim() == 2:
        intrinsics = intrinsics.expand(V, 4, 4)
    intrinsics = intrinsics.to(torch.float32)
    poses = poses.to(torch.float32)
    dev = depths.device
    u = torch.arange(W, device=dev, dtype=torch.float32)[None, None, :]
    v = torch.arange(H, device=dev, dtype=torch.float32)[None, :, None]
    fx = intrinsics[:, 0, 0][:, None, None]
    fy = intrinsics[:, 1, 1][:, None, None]
    cx = intrinsics[:, 0, 2][:, None, None]
    cy = intrinsics[:, 1, 2][:, None, None]
    z = depths / depth_scale
    x = (u - cx) * z / fx
    y = (v - cy) * z / fy
    cam = torch.stack([x, y, z, torch.ones_like(z)], dim=-1)     # (V,H,W,4)
    world = torch.einsum("vij,vhwj->vhwi", poses, cam)
    return world[..., :3] / world[..., 3:4]


def resize_nearest(arr: torch.Tensor, out_hw: Tuple[int, int]) -> torch.Tensor:
    """OpenCV INTER_NEAREST over dims (-3, -2): src = floor(dst*size/new)."""
    H, W = arr.shape[-3], arr.shape[-2]
    new_h, new_w = out_hw
    dev = arr.device
    rows = torch.clamp(torch.arange(new_h, device=dev) * H // new_h, 0, H - 1)
    cols = torch.clamp(torch.arange(new_w, device=dev) * W // new_w, 0, W - 1)
    return arr.index_select(-3, rows).index_select(-2, cols)


def center_crop(arr: torch.Tensor, crop_hw: Tuple[int, int]) -> torch.Tensor:
    """Center crop over dims (-3, -2): top = (H - ch) // 2, left likewise."""
    H, W = arr.shape[-3], arr.shape[-2]
    ch, cw = crop_hw
    top, left = (H - ch) // 2, (W - cw) // 2
    return arr[..., top:top + ch, left:left + cw, :]


def average_coordinate_in_patch(world_coords: torch.Tensor,
                                patch_size: int = 27) -> torch.Tensor:
    """(V, H, W, 3) -> (V, H//ps, W//ps, 3) patch means (trailing rows and
    columns beyond a multiple of ``patch_size`` are dropped)."""
    return _patches(world_coords, patch_size).mean(dim=(2, 4))


def _patches(world_coords: torch.Tensor, patch_size: int) -> torch.Tensor:
    """(V, H, W, D) -> (V, gh, ps, gw, ps, D), trailing rows and columns
    beyond a multiple of ``patch_size`` dropped."""
    V, H, W, D = world_coords.shape
    gh, gw = H // patch_size, W // patch_size
    wc = world_coords[:, :gh * patch_size, :gw * patch_size, :]
    return wc.reshape(V, gh, patch_size, gw, patch_size, D)


def minmax_coordinate_in_patch(world_coords: torch.Tensor,
                               patch_size: int = 27) -> torch.Tensor:
    """(V, H, W, 3) -> (V, gh, gw, 2, 3) per-patch (min, max) pairs, the
    minimum first (llava_arch.py:225-239)."""
    wc = _patches(world_coords, patch_size)
    mn = wc.amin(dim=(2, 4))
    mx = wc.amax(dim=(2, 4))
    return torch.stack([mn, mx], dim=3)


def sample_n_points(world_coords: torch.Tensor, n_points: int = 9,
                    patch_size: int = 27) -> torch.Tensor:
    """Per patch, the 3x3 grid of pixels at offsets 4::9 (llava_arch.py:
    241-257): (V, gh, gw, 9, 3) for n = 9, every other of those for n = 5,
    and the centre point, (V, gh, gw, 3), for n = 1."""
    wc = _patches(world_coords, patch_size).permute(0, 1, 3, 2, 4, 5)
    V, gh, gw = wc.shape[:3]
    nine = wc[:, :, :, 4::9, 4::9, :].reshape(V, gh, gw, 9, wc.shape[-1])
    if n_points == 9:
        return nine
    if n_points == 5:
        return nine[:, :, :, 0::2, :]
    if n_points == 1:
        return nine[:, :, :, 4, :]
    raise ValueError(f"n_points={n_points}")


def discrete_coords(world_coords: torch.Tensor,
                    min_xyz_range: Sequence[float],
                    max_xyz_range: Sequence[float],
                    voxel_size: float) -> torch.Tensor:
    """Clamp to the scene range and round ((c - min) / voxel) half to even."""
    mn = torch.tensor(min_xyz_range, dtype=world_coords.dtype,
                      device=world_coords.device)
    mx = torch.tensor(max_xyz_range, dtype=world_coords.dtype,
                      device=world_coords.device)
    wc = torch.minimum(torch.maximum(world_coords, mn), mx)
    return torch.round((wc - mn) / voxel_size)


def bilinear_weights(in_size: int, out_size: int,
                     device=None) -> torch.Tensor:
    """(out_size, in_size) f32 interpolation matrix of
    ``F.interpolate(mode='bilinear', align_corners=False)`` along one axis:
    src = (dst + 0.5) * in/out - 0.5, clamped to [0, in - 1]; row i holds
    1 - w at floor(src) and w at min(floor(src) + 1, in - 1)."""
    src = ((torch.arange(out_size, dtype=torch.float32, device=device) + 0.5)
           * (in_size / out_size) - 0.5)
    src = torch.clamp(src, 0.0, in_size - 1.0)
    lo = torch.floor(src).to(torch.int64)
    hi = torch.clamp(lo + 1, max=in_size - 1)
    w_hi = src - lo.to(torch.float32)
    mat = torch.zeros(out_size, in_size, dtype=torch.float32, device=device)
    rows = torch.arange(out_size, device=device)
    mat.index_put_((rows, lo), 1.0 - w_hi, accumulate=True)
    mat.index_put_((rows, hi), w_hi, accumulate=True)
    return mat


def bilinear_pool_2d(x: torch.Tensor, out_hw: Tuple[int, int]) -> torch.Tensor:
    """(..., H, W, C) -> (..., out_h, out_w, C) bilinear resize, computed in
    f32 as two products with the per-axis weight matrices."""
    H, W = x.shape[-3], x.shape[-2]
    wr = bilinear_weights(H, out_hw[0], x.device)
    wc = bilinear_weights(W, out_hw[1], x.device)
    y = torch.einsum("oh,...hwc->...owc", wr, x.to(torch.float32))
    y = torch.einsum("pw,...owc->...opc", wc, y)
    return y.to(x.dtype)


def pool_2d_tokens(tokens: torch.Tensor, side: int, stride: int = 2,
                   mode: str = "bilinear") -> torch.Tensor:
    """(V, side*side, D) patch tokens -> (V, out*out, D): bilinear with
    out = ceil(side / stride) (729 -> 196), or the ``average`` / ``max``
    of stride x stride windows with out = side // stride, the trailing
    row and column dropped (torch's pooling semantics)."""
    V, _, D = tokens.shape
    x = tokens.reshape(V, side, side, D)
    if mode == "bilinear":
        out = -(-side // stride)
        return bilinear_pool_2d(x, (out, out)).reshape(V, out * out, D)
    if mode not in ("average", "max"):
        raise ValueError(f"Unexpected pool mode: {mode}")
    out = side // stride
    win = x[:, :out * stride, :out * stride, :].reshape(
        V, out, stride, out, stride, D)
    y = win.mean(dim=(2, 4)) if mode == "average" else win.amax(dim=(2, 4))
    return y.reshape(V, out * out, D)
