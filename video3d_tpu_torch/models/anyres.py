"""AnyRes 2D-image feature arrangement (the spatial_unpad merge) in
PyTorch: counterpart of ``video3d_tpu/models/anyres.py``.

Equivalent of the reference's multi-patch branch in prepare_inputs_labels
(llava_arch.py:572-634): tile features are laid out on the anyres grid,
padding introduced by resize_and_pad is cropped off (``unpad_image``), an
``image_newline`` embedding terminates every pixel row, anyres_max
optionally bilinearly downsamples the grid, and the base-view features are
prepended.

Two routes, as in JAX: :func:`encode_image_2d` arranges one image's
features with data-dependent shapes (the engine's answers), and
:func:`encode_image_2d_batch` gathers a batch's features by host-built
integer plans (:func:`build_anyres_gather_plan`), so a training batch of
images has static shapes. The tower stays plain matmul + softmax.
"""

from __future__ import annotations

import math
import re
from typing import Tuple

import numpy as np
import torch

from video3d_tpu_torch.data.anyres import get_anyres_image_grid_shape
from video3d_tpu_torch.models import siglip
from video3d_tpu_torch.models.llava_video3d import project_features
from video3d_tpu_torch.ops.geometry import bilinear_pool_2d


def unpad_image(tensor: torch.Tensor,
                original_size: Tuple[int, int]) -> torch.Tensor:
    """Crop the letterbox padding off (C, H, W) features; ``original_size``
    is the raw image's (width, height) (mm_utils.py unpad_image)."""
    ow, oh = original_size
    _, ch, cw = tensor.shape
    if ow / oh > cw / ch:            # image wider than canvas: rows padded
        nh = int(oh * (cw / ow))
        pad = (ch - nh) // 2
        return tensor[:, pad:ch - pad, :]
    nw = int(ow * (ch / oh))          # image taller: columns padded
    pad = (cw - nw) // 2
    return tensor[:, :, pad:cw - pad]


def _grid(image_size, grid_pinpoints, vision_image_size: int,
          image_aspect_ratio: str) -> Tuple[int, int]:
    """(tiles wide, tiles high): the anyres grid, or the fixed 2x2 view of
    the highres / crop_split aspects (llava_arch.py:596-597)."""
    if image_aspect_ratio == "anyres" or "anyres_max" in image_aspect_ratio:
        return get_anyres_image_grid_shape(image_size, grid_pinpoints,
                                           vision_image_size)
    return 2, 2


def arrange_anyres_features(tile_features: torch.Tensor,
                            image_size: Tuple[int, int], grid_pinpoints,
                            vision_image_size: int,
                            num_patches_per_side: int,
                            image_newline: torch.Tensor,
                            image_aspect_ratio: str = "anyres",
                            patch_merge_type: str = "spatial_unpad"
                            ) -> torch.Tensor:
    """(n_tiles + 1, P, D) projected tile features -> (tokens, D) block
    (llava_arch.py:574-629): ``flat`` (every tile in order), ``spatial``
    (the grid tile-major), ``spatial_unpad`` (the pixel-row-major grid
    unpadded, an image_newline after each row, the ``anyres_max_N``
    bilinear shrink), the base view first unless the merge says
    ``nobase``."""
    if patch_merge_type == "flat":
        return tile_features.reshape(-1, tile_features.shape[-1])
    base, tiles = tile_features[0], tile_features[1:]
    hw = num_patches_per_side
    if base.shape[0] != hw * hw:
        raise ValueError(f"base view of {base.shape[0]} patches, not "
                         f"{hw}x{hw}")
    m = re.match(r"anyres_max_(\d+)", image_aspect_ratio)
    max_num_patches = int(m.group(1)) if m else None
    npw, nph = _grid(image_size, grid_pinpoints, vision_image_size,
                     image_aspect_ratio)
    D = tiles.shape[-1]
    feat = tiles.reshape(nph, npw, hw, hw, D)
    if "unpad" in patch_merge_type:
        feat = feat.permute(4, 0, 2, 1, 3).reshape(D, nph * hw, npw * hw)
        feat = unpad_image(feat, image_size)
        if max_num_patches is not None:
            c, h, w = feat.shape
            times = math.sqrt(h * w / (max_num_patches * hw ** 2))
            if times > 1.1:
                # torch F.interpolate(bilinear), align_corners False, as
                # the reference (llava_arch.py:612), on channels last
                feat = bilinear_pool_2d(
                    feat.permute(1, 2, 0),
                    (int(h // times), int(w // times))).permute(2, 0, 1)
        nl = image_newline.to(feat.dtype)[:, None, None].expand(
            D, feat.shape[1], 1)
        feat = torch.cat([feat, nl], dim=-1).reshape(D, -1).T
    else:
        feat = feat.permute(0, 2, 1, 3, 4).reshape(-1, D)
    if "nobase" not in patch_merge_type:
        feat = torch.cat([base, feat], dim=0)
    return feat


def build_anyres_gather_plan(image_size: Tuple[int, int], grid_pinpoints,
                             vision_image_size: int,
                             num_patches_per_side: int,
                             image_aspect_ratio: str = "anyres",
                             patch_merge_type: str = "spatial_unpad"):
    """Host integer plan equivalent of :func:`arrange_anyres_features`:
    (gather (T,) int32 rows of the flattened ``(n_tiles + 1) * hw * hw``
    projected features, newline (T,) bool rows that read
    ``image_newline`` instead). The ``anyres_max_N`` bilinear shrink is
    not a gather and raises, as in JAX."""
    hw = num_patches_per_side
    if "anyres_max" in image_aspect_ratio:
        raise NotImplementedError("anyres_max interpolates; no gather plan")
    npw, nph = _grid(image_size, grid_pinpoints, vision_image_size,
                     image_aspect_ratio)
    if patch_merge_type == "flat":
        n_tiles = 1 + npw * nph
        return (np.arange(n_tiles * hw * hw, dtype=np.int32),
                np.zeros((n_tiles * hw * hw,), bool))

    def flat_idx(tile, r, c):
        return (1 + tile) * hw * hw + r * hw + c   # tiles follow the base

    gather: list = []
    newline: list = []
    if "unpad" in patch_merge_type:
        # pixel-row-major grid (nph*hw, npw*hw), then the unpad crop
        ch, cw = nph * hw, npw * hw
        ow, oh = image_size
        if ow / oh > cw / ch:
            pad = (ch - int(oh * (cw / ow))) // 2
            r0, r1, c0, c1 = pad, ch - pad, 0, cw
        else:
            pad = (cw - int(ow * (ch / oh))) // 2
            r0, r1, c0, c1 = 0, ch, pad, cw - pad
        for R in range(r0, r1):
            t_row, r = divmod(R, hw)
            for C in range(c0, c1):
                t_col, c = divmod(C, hw)
                gather.append(flat_idx(t_row * npw + t_col, r, c))
                newline.append(False)
            gather.append(0)
            newline.append(True)       # image_newline terminates each row
    else:                              # 'spatial': tile-major, no newline
        for t_row in range(nph):
            for r in range(hw):
                for t_col in range(npw):
                    for c in range(hw):
                        gather.append(flat_idx(t_row * npw + t_col, r, c))
                        newline.append(False)
    if "nobase" not in patch_merge_type:
        gather = list(range(hw * hw)) + gather     # base view first
        newline = [False] * (hw * hw) + newline
    return np.asarray(gather, np.int32), np.asarray(newline, bool)


def encode_tiles(params, cfg, tiles: torch.Tensor,
                   remat: bool = False) -> torch.Tensor:
    """(T, 3, S, S) pixel tiles -> (T, P, D) projected features (no 2D pool
    and no world PE: the reference's image branch bypasses both)."""
    w = params["vision"]["patch_embed"]["w"]
    feats = siglip.vision_tower_forward(params["vision"], tiles.to(w.dtype),
                                        cfg.vision, remat=remat)
    return project_features(params["projector"], feats)


def encode_image_2d_batch(params, cfg, tiles: torch.Tensor,
                          gather: torch.Tensor, newline: torch.Tensor,
                          valid: torch.Tensor,
                          remat: bool = False) -> torch.Tensor:
    """Batched static-shape 2D-image encoder: (B, maxT, 3, S, S) tiles
    (zero past each row's count; the tower runs on them, they are never
    gathered), (B, Tv) gather rows, newline and valid masks ->
    (B, Tv, D) spliceable block, zeros at invalid rows."""
    B, maxT = tiles.shape[:2]
    feats = encode_tiles(params, cfg, tiles.reshape(B * maxT,
                                                      *tiles.shape[2:]),
                           remat)
    D = feats.shape[-1]
    feats = feats.reshape(B, -1, D)
    block = torch.gather(feats, 1, gather.long()[..., None].expand(-1, -1, D))
    nl = params["image_newline"].to(block.dtype)
    block = torch.where(newline[..., None], nl, block)
    return torch.where(valid[..., None], block,
                       torch.zeros((), dtype=block.dtype,
                                   device=block.device))


def encode_image_2d(params, cfg, tiles: torch.Tensor,
                    image_size: Tuple[int, int], grid_pinpoints,
                    image_aspect_ratio: str = "anyres",
                    patch_merge_type: str = "spatial_unpad") -> torch.Tensor:
    """One image's (n_tiles + 1, 3, S, S) tiles -> (tokens, D) block:
    tower + projector per tile, then :func:`arrange_anyres_features`."""
    return arrange_anyres_features(
        encode_tiles(params, cfg, tiles), image_size, grid_pinpoints,
        cfg.vision.image_size, cfg.vision.num_patches_per_side,
        params["image_newline"], image_aspect_ratio=image_aspect_ratio,
        patch_merge_type=patch_merge_type)
