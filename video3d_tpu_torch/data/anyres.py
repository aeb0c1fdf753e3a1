"""AnyRes 2D-image tiling (host preprocessing).

The reference's variable-resolution image path (mm_utils.py:87-338): pick the
grid resolution that wastes the least area for the image's aspect ratio,
resize-and-pad onto it, split into tower-sized tiles, and prepend a plain
resize of the original as the "base" view. Also the ``pad`` (expand2square)
aspect mode. Matches the reference exactly, including its documented quirk of
*resizing* (not padding) the base view (mm_utils.py:283-289).

The port's own copy of ``video3d_tpu/data/anyres.py`` (the port imports
nothing of the JAX package); ``tests/test_torch_anyres.py`` holds its
tiles bit for bit against the JAX package's.
"""

from __future__ import annotations

import ast
import math
import re
from typing import List, Sequence, Tuple, Union

import numpy as np
from PIL import Image

GridPinpoints = Union[str, Sequence[Sequence[int]]]


def parse_grid_pinpoints(grid_pinpoints: GridPinpoints,
                         patch_size: int) -> List[List[int]]:
    """'(1x1),...,(6x6)' range syntax / literal-list string / list ->
    [[w, h], ...] pixel resolutions (mm_utils.py:226-238, 256-271)."""
    if isinstance(grid_pinpoints, str) and "x" in grid_pinpoints:
        assert patch_size in (224, 336, 384, 448, 512), patch_size
        matches = re.findall(r"\((\d+)x(\d+)\)", grid_pinpoints)
        start, end = (tuple(map(int, matches[0])),
                      tuple(map(int, matches[-1])))
        grid = [(i, j) for i in range(start[0], end[0] + 1)
                for j in range(start[1], end[1] + 1)]
        return [[dim * patch_size for dim in pair] for pair in grid]
    if isinstance(grid_pinpoints, str):
        return [list(p) for p in ast.literal_eval(grid_pinpoints)]
    return [list(p) for p in grid_pinpoints]


def select_best_resolution(original_size: Tuple[int, int],
                           possible_resolutions: Sequence[Sequence[int]]
                           ) -> Tuple[int, int]:
    """Max effective resolution, then min wasted area (mm_utils.py:119-149)."""
    ow, oh = original_size
    best, max_eff, min_waste = None, 0, float("inf")
    for width, height in possible_resolutions:
        scale = min(width / ow, height / oh)
        dw, dh = int(ow * scale), int(oh * scale)
        eff = min(dw * dh, ow * oh)
        waste = width * height - eff
        if eff > max_eff or (eff == max_eff and waste < min_waste):
            max_eff, min_waste, best = eff, waste, (width, height)
    return best


def resize_and_pad_image(image: Image.Image,
                         target_resolution: Tuple[int, int]) -> Image.Image:
    """Aspect-preserving resize centred on a black canvas
    (mm_utils.py:152-188; note math.ceil on the short side)."""
    ow, oh = image.size
    tw, th = target_resolution
    scale_w, scale_h = tw / ow, th / oh
    if scale_w < scale_h:
        nw, nh = tw, min(math.ceil(oh * scale_w), th)
    else:
        nh, nw = th, min(math.ceil(ow * scale_h), tw)
    resized = image.resize((nw, nh))
    out = Image.new("RGB", (tw, th), (0, 0, 0))
    out.paste(resized, ((tw - nw) // 2, (th - nh) // 2))
    return out


def divide_to_patches(image: Image.Image, patch_size: int) -> List[Image.Image]:
    """Row-major patch_size tiles (mm_utils.py:191-210)."""
    patches = []
    w, h = image.size
    for i in range(0, h, patch_size):
        for j in range(0, w, patch_size):
            patches.append(image.crop((j, i, j + patch_size, i + patch_size)))
    return patches


def get_anyres_image_grid_shape(image_size: Tuple[int, int],
                                grid_pinpoints: GridPinpoints,
                                patch_size: int) -> Tuple[int, int]:
    """(n_patches_wide, n_patches_high) for the selected resolution
    (mm_utils.py:213-240)."""
    res = parse_grid_pinpoints(grid_pinpoints, patch_size)
    w, h = select_best_resolution(image_size, res)
    return w // patch_size, h // patch_size


def expand2square(image: Image.Image, background_color) -> Image.Image:
    """Pad to square, image centred (mm_utils.py:305-316)."""
    w, h = image.size
    if w == h:
        return image
    side = max(w, h)
    out = Image.new(image.mode, (side, side), background_color)
    out.paste(image, ((side - w) // 2 if h > w else 0,
                      (side - h) // 2 if w > h else 0))
    return out


def process_anyres_image(image: Image.Image, processor,
                         grid_pinpoints: GridPinpoints) -> np.ndarray:
    """-> (n_tiles + 1, 3, S, S): [base resize] + row-major tiles
    (mm_utils.py:243-299; the base view is a plain resize — the reference
    keeps this known quirk for checkpoint compatibility and so do we)."""
    tile = processor.crop_size["height"]
    res = parse_grid_pinpoints(grid_pinpoints, tile)
    best = select_best_resolution(image.size, res)
    padded = resize_and_pad_image(image, best)
    patches = divide_to_patches(padded, tile)
    base = image.resize((tile, tile))
    return processor.preprocess([base] + patches)


def resize_and_center_crop(image: Image.Image, shortest_edge_length: int,
                           mode=Image.LANCZOS) -> Image.Image:
    """Resize so the short edge hits the target, center-crop square
    (mm_utils.py:12-30; note the int() truncation of the long edge)."""
    aspect_ratio = float(image.width) / float(image.height)
    if aspect_ratio > 1:
        new_width = int(shortest_edge_length * aspect_ratio)
        new_height = shortest_edge_length
    else:
        new_width = shortest_edge_length
        new_height = int(shortest_edge_length / aspect_ratio)
    resized = image.resize((new_width, new_height), mode)
    left = (new_width - shortest_edge_length) / 2
    top = (new_height - shortest_edge_length) / 2
    return resized.crop((left, top, left + shortest_edge_length,
                         top + shortest_edge_length))


def extract_patches(image: Image.Image, patch_size: int,
                    overlap_ratio: float) -> List[Image.Image]:
    """Centred sliding-window patches (mm_utils.py:63-84)."""
    assert patch_size > 0 and 0 <= overlap_ratio < 1
    W, H = image.size
    stride = int(patch_size * (1 - overlap_ratio))
    num_y = (H - patch_size) // stride + 1
    num_x = (W - patch_size) // stride + 1
    y_start = (H - (num_y - 1) * stride - patch_size) // 2
    x_start = (W - (num_x - 1) * stride - patch_size) // 2
    return [image.crop((x, y, x + patch_size, y + patch_size))
            for y in range(y_start, y_start + num_y * stride, stride)
            for x in range(x_start, x_start + num_x * stride, stride)]


def process_highres_image(image: Image.Image, processor,
                          grid_pinpoints: str) -> np.ndarray:
    """-> (n_tiles + 1, 3, S, S) (mm_utils.py:98-116): square-pad to the
    LARGEST grid size (the reference's FIXME always overrides the fit
    selection, :107 — kept for parity), tile, prepend a plain base resize."""
    grid_params = [int(x) for x in grid_pinpoints.split(",")]
    # the fit-selection result is computed then unconditionally overridden
    # (mm_utils.py:100-107); reproduce the effective behavior
    select_size = max(grid_params)
    bg = tuple(int(x * 255) for x in processor.image_mean)
    size = processor.size
    short_edge = (size["shortest_edge"] if isinstance(size, dict)
                  else size[0] if isinstance(size, (tuple, list)) else size)
    base = image.resize((short_edge, short_edge))
    padded = expand2square(image, bg).resize((select_size, select_size))
    patches = extract_patches(padded, patch_size=short_edge, overlap_ratio=0)
    return processor.preprocess([base] + patches)


def process_highres_image_crop_split(image: Image.Image, processor,
                                     crop_resolution: int,
                                     split_resolution: int) -> np.ndarray:
    """-> (n_tiles, 3, S, S) (mm_utils.py:87-96): resize+center-crop to
    ``crop_resolution`` then split into ``split_resolution`` tiles (no base
    view)."""
    image_crop = resize_and_center_crop(image, crop_resolution)
    patches = extract_patches(image_crop, patch_size=split_resolution,
                              overlap_ratio=0)
    return processor.preprocess(patches)


def process_images_2d(images: Sequence[Image.Image], processor,
                      image_aspect_ratio: str,
                      grid_pinpoints: GridPinpoints = None,
                      crop_resolution: int = 384,
                      split_resolution: int = 384):
    """The reference's ``process_images`` dispatch (mm_utils.py:303-338):
    anyres / anyres_max_* / highres / crop_split / pad / plain. Returns a
    list of (n_tiles(+1), 3, S, S) arrays for tiling modes, else a stacked
    (N, 3, S, S) array."""
    if image_aspect_ratio == "anyres" or "anyres_max" in image_aspect_ratio:
        return [process_anyres_image(im, processor, grid_pinpoints)
                for im in images]
    if image_aspect_ratio == "highres":
        return [process_highres_image(im, processor, grid_pinpoints)
                for im in images]
    if image_aspect_ratio == "crop_split":
        return [process_highres_image_crop_split(im, processor,
                                                 crop_resolution,
                                                 split_resolution)
                for im in images]
    if image_aspect_ratio == "pad":
        bg = tuple(int(x * 255) for x in processor.image_mean)
        return processor.preprocess([expand2square(im, bg) for im in images])
    return processor.preprocess(list(images))
