"""3D sinusoidal world-position embedding (counterpart of
``video3d_tpu/ops/pos_embed.py::sin3d_position_embedding``)."""

from __future__ import annotations

import torch


def _interleave_sin_cos(pos: torch.Tensor, num_feats: int) -> torch.Tensor:
    """out[2k] = sin(p[2k]), out[2k+1] = cos(p[2k+1]); odd ``num_feats``
    drops the trailing cos of the zero pad, as the reference does."""
    if num_feats % 2 != 0:
        pos = torch.cat([pos, torch.zeros_like(pos[..., :1])], dim=-1)
    out = torch.stack([torch.sin(pos[..., 0::2]), torch.cos(pos[..., 1::2])],
                      dim=-1).flatten(-2)
    return out[..., :num_feats]


def sin3d_position_embedding(coords: torch.Tensor, embedding_size: int,
                             temperature: float = 10000.0) -> torch.Tensor:
    """(B, N, 3) coords -> (B, N, embedding_size) f32 embedding: per axis
    ``num_feats = D // 3`` interleaved sin/cos frequencies, [x, y, z] blocks,
    zero-padded up to D."""
    num_feats = embedding_size // 3
    coords = coords.to(torch.float32)
    # An ulp in the frequency table moves sin() by 3e-5 at voxel ids ~300,
    # so it is built as the JAX package's compiled graph builds it: the
    # division by num_feats as a product with the f32 reciprocal, and the
    # power correctly rounded (taken in f64, rounded once to f32).
    i = torch.arange(num_feats, dtype=torch.float32)
    inv = torch.tensor(1.0, dtype=torch.float32) / num_feats
    expo = (2.0 * torch.floor(i / 2.0) * inv).to(torch.float64)
    dim_t = (temperature ** expo).to(torch.float32).to(coords.device)
    parts = [_interleave_sin_cos(coords[..., a, None] / dim_t, num_feats)
             for a in range(3)]
    pe = torch.cat(parts, dim=-1)
    pad = embedding_size - pe.shape[-1]
    if pad > 0:
        pe = torch.nn.functional.pad(pe, (0, pad))
    return pe
