"""Axis-aligned 3D box math, vectorized over batches of boxes.

Reference semantics: the reference's llava/eval/box_utils.py (corner-based
IoU over axis-aligned boxes) and llava/utils_3d.py
(point-cloud -> center/size box). We store boxes directly as
``(cx, cy, cz, sx, sy, sz)`` and compute IoU from extents — numerically
identical to the reference's corners->minmax->IoU chain for AABBs, without
materializing the 8 corners.
"""

from __future__ import annotations

import numpy as np


def box_center_size_to_minmax(boxes: np.ndarray):
    """(..., 6) center+size -> ((..., 3) min, (..., 3) max)."""
    boxes = np.asarray(boxes, dtype=np.float64)
    c, s = boxes[..., :3], boxes[..., 3:6]
    return c - s / 2.0, c + s / 2.0


def box3d_iou(boxes1: np.ndarray, boxes2: np.ndarray) -> np.ndarray:
    """Pairwise-broadcast IoU of axis-aligned boxes in center+size form.

    Matches box_utils.py:3-27 including the +1e-8 denominator guard.

    Args:
      boxes1: (..., 6); boxes2: (..., 6). Shapes broadcast.
    Returns:
      broadcast IoU array.
    """
    mn1, mx1 = box_center_size_to_minmax(boxes1)
    mn2, mx2 = box_center_size_to_minmax(boxes2)
    lo = np.maximum(mn1, mn2)
    hi = np.minimum(mx1, mx2)
    inter = np.prod(np.maximum(hi - lo, 0.0), axis=-1)
    vol1 = np.prod(mx1 - mn1, axis=-1)
    vol2 = np.prod(mx2 - mn2, axis=-1)
    return inter / (vol1 + vol2 - inter + 1e-8)


def iou_matrix(boxes1: np.ndarray, boxes2: np.ndarray) -> np.ndarray:
    """(N, 6) x (M, 6) -> (N, M) IoU matrix."""
    return box3d_iou(np.asarray(boxes1)[:, None, :], np.asarray(boxes2)[None, :, :])


def get_3d_box_corners(center, box_size) -> np.ndarray:
    """Center+size -> (8, 3) corners, same corner ordering as
    box_utils.py:51-67 (for compatibility with dumped prediction files)."""
    l, w, h = box_size
    x = np.array([l / 2, l / 2, -l / 2, -l / 2, l / 2, l / 2, -l / 2, -l / 2])
    y = np.array([w / 2, -w / 2, -w / 2, w / 2, w / 2, -w / 2, -w / 2, w / 2])
    z = np.array([h / 2, h / 2, h / 2, h / 2, -h / 2, -h / 2, -h / 2, -h / 2])
    corners = np.stack([x + center[0], y + center[1], z + center[2]], axis=0)
    return corners.T


def corners_iou(corners1: np.ndarray, corners2: np.ndarray) -> float:
    """IoU from (8, 3) corner arrays (box_utils.py:3-27)."""
    mn1, mx1 = corners1.min(axis=0), corners1.max(axis=0)
    mn2, mx2 = corners2.min(axis=0), corners2.max(axis=0)
    lo, hi = np.maximum(mn1, mn2), np.minimum(mx1, mx2)
    inter = np.prod(np.maximum(hi - lo, 0.0))
    v1, v2 = np.prod(mx1 - mn1), np.prod(mx2 - mn2)
    return float(inter / (v1 + v2 - inter + 1e-8))


def convert_pc_to_box(obj_pc: np.ndarray):
    """Point cloud (N, 3) -> (center, size) lists (utils_3d.py:3-13)."""
    mn = np.min(obj_pc[:, :3], axis=0)
    mx = np.max(obj_pc[:, :3], axis=0)
    center = ((mn + mx) / 2.0).tolist()
    size = (mx - mn).tolist()
    return center, size
