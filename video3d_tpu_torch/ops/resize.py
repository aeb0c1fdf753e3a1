"""Torch-semantics image resizes as precomputed weight matrices: counterpart
of ``video3d_tpu/ops/resize.py``.

The reference's S2 multi-scale tower (clip_encoder.py:125-176) resizes
images with ``F.interpolate(mode='bicubic')`` (align_corners=False, no
antialias) and merges feature maps with ``F.interpolate(mode='area')``.
Both are separable linear maps for static sizes; as in the JAX package the
(out, in) matrix is built once per size pair in float64 and applied as two
f32 products, so the port computes what JAX computes (the weights
``F.interpolate`` would use, up to float rounding).
"""

from __future__ import annotations

import functools

import numpy as np
import torch


def _cubic_kernel(x: np.ndarray, a: float = -0.75) -> np.ndarray:
    """torch's cubic convolution weights (upsample_bicubic2d, A = -0.75)."""
    x = np.abs(x)
    out = np.zeros_like(x)
    m1 = x <= 1.0
    out[m1] = ((a + 2.0) * x[m1] - (a + 3.0)) * x[m1] * x[m1] + 1.0
    m2 = (x > 1.0) & (x < 2.0)
    out[m2] = ((a * x[m2] - 5.0 * a) * x[m2] + 8.0 * a) * x[m2] - 4.0 * a
    return out


@functools.lru_cache(maxsize=64)
def bicubic_resize_matrix(in_size: int, out_size: int) -> np.ndarray:
    """(out_size, in_size) f32 matrix of ``F.interpolate(mode='bicubic',
    align_corners=False)`` along one axis (edge taps clamped)."""
    if in_size == out_size:
        return np.eye(in_size, dtype=np.float32)
    scale = in_size / out_size
    o = np.arange(out_size, dtype=np.float64)
    center = (o + 0.5) * scale - 0.5
    idx = np.floor(center).astype(np.int64)
    t = center - idx
    w = np.zeros((out_size, in_size), dtype=np.float64)
    for k in range(-1, 3):
        tap = np.clip(idx + k, 0, in_size - 1)
        np.add.at(w, (np.arange(out_size), tap), _cubic_kernel(k - t))
    return w.astype(np.float32)


def bicubic_resize(x: torch.Tensor, out_h: int, out_w: int) -> torch.Tensor:
    """Bicubic-resize the trailing two axes of ``x`` (..., H, W) with
    ``F.interpolate(mode='bicubic')`` semantics, in f32."""
    h, w = x.shape[-2], x.shape[-1]
    wh = torch.from_numpy(bicubic_resize_matrix(h, out_h)).to(x.device)
    ww = torch.from_numpy(bicubic_resize_matrix(w, out_w)).to(x.device)
    y = torch.einsum("oh,...hw->...ow", wh, x.to(torch.float32))
    return torch.einsum("pw,...hw->...hp", ww, y)


def area_downsample(x: torch.Tensor, out_size: int) -> torch.Tensor:
    """``F.interpolate(mode='area')`` on the trailing two (square) axes for
    an integer factor: a mean over each f x f block."""
    h = x.shape[-1]
    if h == out_size:
        return x
    if h % out_size:
        raise ValueError(f"area_downsample needs an integer factor, got "
                         f"{h}->{out_size}")
    f = h // out_size
    return x.reshape(*x.shape[:-2], out_size, f, out_size, f) \
        .mean(dim=(-3, -1))
