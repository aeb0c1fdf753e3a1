"""Exact greedy maximum-coverage frame selection on the device.

Counterpart of ``video3d_tpu/ops/mc_select.py``. The reference computes the
greedy set-cover order offline with Python sets over voxel tuples
(max_coverage_sampling.py:68-94). Here the cover universe is the scene
point cloud's voxel list, a frame's coverage is an exact membership bitmap
over that list (linear voxel ids in the scene's bounding grid, looked up
with ``torch.searchsorted`` in the sorted list: collision-free), and the
greedy loop is a Python loop of masked popcount-argmax steps on the
device. Ties go to the lowest frame index (``torch.argmax`` returns the
first maximum), as in the JAX package; the reference breaks them at
random, the one documented deviation.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np
import torch

SENTINEL = 2 ** 31 - 1     # padded / invalid scene slots sort last


def _linear_ids(vox: torch.Tensor, lo: torch.Tensor,
                sizes: torch.Tensor) -> torch.Tensor:
    """(..., 3) voxels -> (...,) linear id in the scene's bounding grid, or
    -1 outside it (such voxels cannot be scene members). Exact while the
    grid has < 2^30 cells (ScanNet at 0.1 m: ~2.7e7)."""
    rel = vox.to(torch.int32) - lo
    inside = ((rel >= 0) & (rel < sizes)).all(dim=-1)
    ids = (rel[..., 0] * sizes[1] + rel[..., 1]) * sizes[2] + rel[..., 2]
    return torch.where(inside, ids, torch.full_like(ids, -1))


def scene_universe(scene_vox: torch.Tensor,
                   scene_valid: Optional[torch.Tensor] = None
                   ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(M, 3) scene voxels -> (sorted linear ids (M,), lo (3,), sizes (3,)).
    Invalid entries become SENTINEL and sort to the tail; duplicates keep
    their slots (membership resolves to the first)."""
    flat = scene_vox.reshape(-1, 3).to(torch.int32)
    valid = (torch.ones(flat.shape[0], dtype=torch.bool, device=flat.device)
             if scene_valid is None else scene_valid.reshape(-1).bool())
    big = 2 ** 30
    lo = torch.where(valid[:, None], flat, big).amin(dim=0)
    hi = torch.where(valid[:, None], flat, -big).amax(dim=0)
    sizes = torch.clamp(hi - lo + 1, min=1)
    ids = torch.where(valid, _linear_ids(flat, lo, sizes),
                      torch.full_like(flat[:, 0], SENTINEL))
    return torch.sort(ids).values, lo, sizes


def frame_occupancy(frame_vox: torch.Tensor, sorted_ids: torch.Tensor,
                    lo: torch.Tensor, sizes: torch.Tensor) -> torch.Tensor:
    """(V, N, 3) voxels -> (V, M) bool: the scene slots each frame covers.
    ``searchsorted`` (left) resolves a duplicated scene voxel to its first
    slot, so each distinct voxel counts once."""
    V = frame_vox.shape[0]
    M = sorted_ids.shape[0]
    pids = _linear_ids(frame_vox.reshape(V, -1, 3), lo, sizes)
    idx = torch.searchsorted(sorted_ids, pids)
    idx_c = idx.clamp(max=M - 1)
    hit = (sorted_ids[idx_c] == pids) & (pids >= 0)
    occ = torch.zeros((V, M + 1), dtype=torch.bool, device=frame_vox.device)
    occ.scatter_(1, torch.where(hit, idx_c, M), True)   # misses -> slot M
    return occ[:, :M]


def greedy_select_frames(frame_vox: torch.Tensor, scene_vox: torch.Tensor,
                         max_frames: int = 32,
                         scene_valid: Optional[torch.Tensor] = None,
                         ratio: float = 1.0
                         ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Greedy max-coverage ordering with exact membership.

    frame_vox (V, N, 3) per-frame voxel ids (duplicates are fine); scene_vox
    (M, 3) the cover universe; scene_valid an optional (M,) mask of padded
    scene voxels; ``ratio`` < 1 stops once the picks cover
    ceil(ratio * num_all) voxels (the reference's ratio cut), the remaining
    ``order`` slots staying -1. Returns (order (max_frames,) int32 frame
    indices, gains (max_frames,) int32 newly covered voxels per pick,
    num_all () int32 = |union of frames ∩ scene|), on frame_vox's device.
    """
    V = frame_vox.shape[0]
    dev = frame_vox.device
    sorted_ids, lo, sizes = scene_universe(scene_vox.to(dev),
                                           None if scene_valid is None
                                           else scene_valid.to(dev))
    occ = frame_occupancy(frame_vox, sorted_ids, lo, sizes)
    num_all = occ.any(dim=0).sum().to(torch.int32)
    if ratio < 1.0:      # the early exit syncs with the host once a step
        target = int(torch.ceil(torch.tensor(ratio, dtype=torch.float32)
                                * num_all.float().cpu()))
    order = torch.full((max_frames,), -1, dtype=torch.int32, device=dev)
    gains = torch.zeros((max_frames,), dtype=torch.int32, device=dev)
    used = torch.zeros(occ.shape[1], dtype=torch.bool, device=dev)
    taken = torch.zeros(V, dtype=torch.bool, device=dev)
    covered = 0
    for i in range(min(max_frames, V)):
        if ratio < 1.0 and covered >= target:
            break
        counts = (occ & ~used).sum(dim=1, dtype=torch.int32)
        counts = torch.where(taken, -1, counts)
        pick = torch.argmax(counts)
        gain = counts[pick]
        used |= occ[pick]
        taken[pick] = True
        order[i] = pick.to(torch.int32)
        gains[i] = gain
        if ratio < 1.0:
            covered += int(gain)
    return order, gains, num_all


def select_prefix_by_ratio(order, gains, num_all, ratio: float) -> List[int]:
    """Host-side prefix cut (video_utils.py:142-151): keep picks until the
    cumulative gain reaches ratio * num_all, then sort chronologically."""
    order, gains, num_all = (x.cpu() if torch.is_tensor(x) else x
                             for x in (order, gains, num_all))
    order = np.asarray(order)
    gains = np.asarray(gains)
    total = float(num_all)
    out, cc = [], 0
    for f, g in zip(order, gains):
        if f < 0:
            break
        out.append(int(f))
        cc += int(g)
        if cc >= total * ratio:
            break
    return sorted(out)
