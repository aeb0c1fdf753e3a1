"""Voxel-deduplicated scene tokens (the reference's 'llava3d' variant,
llava_arch.py:731-746), in PyTorch: counterpart of
``video3d_tpu/ops/voxel_dedup.py``.

The pooled patch features are grouped by their discrete voxel, the
duplicates meaned, and up to ``budget`` (3096) unique voxels drawn in a
random order as the video's token block. As in the JAX package the block
has a fixed length: a scene with fewer unique voxels than the budget
cycles its valid voxels to fill it.

The order of the voxels is an argument (``order_keys``, one float per
patch row, smallest first): the JAX engine draws its keys with
``jax.random.uniform(PRNGKey(0), (P,))``, which the port cannot reproduce
without JAX, so a caller that must match it passes those keys in. The
port's engine draws its own (``default_order_keys``).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch


def linearize_voxels(coords: torch.Tensor,
                     grid_dims: Tuple[int, int, int]) -> torch.Tensor:
    """(..., 3) integer voxel coordinates -> (...,) unique int32 ids."""
    _, gy, gz = grid_dims
    c = coords.to(torch.int32)
    return (c[..., 0] * gy + c[..., 1]) * gz + c[..., 2]


def default_order_keys(n: int) -> torch.Tensor:
    """The port's own voxel draw: ``torch.rand(n)`` from a host generator
    seeded with 0 (float32, on the CPU). It departs from the JAX
    engine's ``jax.random.uniform(PRNGKey(0), (n,))``: the same scene
    keeps a different random subset when it has more unique voxels than
    the budget."""
    return torch.rand(n, generator=torch.Generator().manual_seed(0))


def voxel_dedup_features(feats: torch.Tensor, coords: torch.Tensor,
                         grid_dims: Tuple[int, int, int],
                         budget: int = 3096,
                         order_keys: Optional[torch.Tensor] = None
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Mean features per unique voxel, ordered by ``order_keys`` and cut
    or cycled to ``budget``.

    Args:
      feats: (P, D) patch features; coords: (P, 3) discrete voxel coords.
      grid_dims: the voxel grid's extents (for the ids).
      budget: tokens out (the reference's 3096).
      order_keys: (P,) float keys; voxel slot u (the u-th smallest id)
        sorts by ``order_keys[u]``. None: id order (JAX ``key=None``).
    Returns:
      (budget, D) features in feats' dtype (means taken in float32) and a
      (budget,) bool mask, False at the cycled fill.
    """
    P = feats.shape[0]
    dev = feats.device
    ids = linearize_voxels(coords.reshape(-1, 3), grid_dims)
    _, inv = torch.unique(ids, sorted=True, return_inverse=True)
    inv = inv.reshape(-1)
    sums = torch.zeros(P, feats.shape[1], dtype=torch.float32, device=dev)
    sums.index_add_(0, inv, feats.to(torch.float32))
    counts = torch.zeros(P, dtype=torch.float32, device=dev)
    counts.index_add_(0, inv, torch.ones(P, dtype=torch.float32, device=dev))
    means = (sums / torch.clamp(counts, min=1.0)[:, None]).to(feats.dtype)
    valid = counts > 0
    if order_keys is None:
        keys = torch.arange(P, dtype=torch.float32, device=dev)
    else:
        keys = order_keys.to(device=dev, dtype=torch.float32)
    # valid voxels first, in key order; the fill slots after them
    order = torch.argsort(torch.where(valid, keys, keys + 1e9), stable=True)
    take = torch.clamp(valid.sum(), max=budget)
    slots = torch.arange(budget, device=dev)
    picked = order[slots % torch.clamp(take, min=1)]
    return means[picked], slots < take
