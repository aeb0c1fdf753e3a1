"""World-position embeddings: the 3D sinusoidal one (one or n points per
patch) and the MLP one. Counterpart of ``video3d_tpu/ops/pos_embed.py``."""

from __future__ import annotations

import math
from typing import Dict

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
                             temperature: float = 10000.0,
                             n_points: int = 1) -> torch.Tensor:
    """(B, N, 3) coords, or (B, N, n_points, 3) -> (B, N, embedding_size)
    f32 embedding: per axis ``num_feats = D // (3 * n_points)`` interleaved
    sin/cos frequencies, [x, y, z] blocks (one xyz block per point, the
    points in order), zero-padded up to D."""
    num_feats = embedding_size // (3 * n_points)
    coords = coords.to(torch.float32)
    B = coords.shape[0]
    if n_points > 1:
        coords = coords.reshape(B, -1, 3)
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
    if n_points > 1:
        pe = pe.reshape(B, -1, n_points * 3 * num_feats)
    pad = embedding_size - pe.shape[-1]
    if pad > 0:
        pe = torch.nn.functional.pad(pe, (0, pad))
    return pe


def mlp_position_embedding(params: Dict[str, torch.Tensor],
                           coords: torch.Tensor,
                           n_points: int = 1) -> torch.Tensor:
    """``PositionEmbeddingMLP`` (position_encoding.py:52-84): Linear 3 ->
    512, LayerNorm (eps 1e-5), ReLU, Linear 512 -> D, all in the weights'
    dtype. (B, N, 3) coords -> (B, N, D); with ``n_points > 1`` the
    (B, N, n, 3) coords are flattened to (B, N * n, 3) first, as in JAX."""
    if n_points > 1:
        coords = coords.reshape(coords.shape[0], -1, 3)
    h = coords.to(params["w1"].dtype) @ params["w1"] + params["b1"]
    mean = h.mean(dim=-1, keepdim=True)
    var = ((h - mean) ** 2).mean(dim=-1, keepdim=True)
    h = (h - mean) * torch.rsqrt(var + 1e-5) * params["ln_scale"] \
        + params["ln_bias"]
    return torch.relu(h) @ params["w2"] + params["b2"]


def init_mlp_position_embedding(embedding_size: int, device,
                                generator: torch.Generator,
                                hidden_size: int = 512,
                                dtype=torch.float32
                                ) -> Dict[str, torch.Tensor]:
    """JAX ``init_mlp_position_embedding``'s shapes and distributions:
    U(-1/sqrt(3), 1/sqrt(3)) and U(-1/sqrt(hidden), 1/sqrt(hidden))
    linears, zero biases, a unit LayerNorm scale, drawn from
    ``generator`` (a generator of ``device``)."""

    def uniform(shape, lim):
        return torch.empty(shape, device=device, dtype=dtype).uniform_(
            -lim, lim, generator=generator)

    def const(n, value):
        return torch.full((n,), value, device=device, dtype=dtype)

    return {"w1": uniform((3, hidden_size), 1.0 / math.sqrt(3.0)),
            "b1": const(hidden_size, 0.0),
            "ln_scale": const(hidden_size, 1.0),
            "ln_bias": const(hidden_size, 0.0),
            "w2": uniform((hidden_size, embedding_size),
                          1.0 / math.sqrt(hidden_size)),
            "b2": const(embedding_size, 0.0)}
