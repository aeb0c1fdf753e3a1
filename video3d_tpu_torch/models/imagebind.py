"""The ImageBind-Huge vision tower in PyTorch: counterpart of
``video3d_tpu/models/imagebind.py`` (the reference's ImageBindWrapper,
multimodal_encoder/imagebind.py:27-73, without the external package).

Images in, one L2-normalised joint embedding per image out, (B, 1, 1024).
The vision path of ``imagebind_huge``: the image padded to a 2-frame clip
and patchified by a bias-free Conv3d (2, 14, 14); a CLS token and a
learned (1, 257, 1280) position table; a LayerNorm; 32 pre-norm blocks of
packed-in_proj multi-head attention and an exact-GELU MLP (1280 wide, 16
heads, eps 1e-6); then LayerNorm, token 0, a bias-free Linear to 1024 and
L2 normalisation. The two frames are copies of the image, so the Conv3d is
a 2-D patchify with its kernel summed over time (folded by
:func:`convert_imagebind`). The audio modality is not implemented, in the
JAX package either.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Mapping

import torch
import torch.nn.functional as F

from video3d_tpu_torch.models.siglip import _layer_norm, attention, patchify

Params = Dict[str, Any]


@dataclass(frozen=True)
class ImageBindConfig:
    """imagebind_huge vision trunk dimensions."""

    hidden_size: int = 1280
    num_hidden_layers: int = 32
    num_attention_heads: int = 16
    mlp_ratio: int = 4
    patch_size: int = 14
    image_size: int = 224
    out_dim: int = 1024
    layer_norm_eps: float = 1e-6

    @classmethod
    def tiny(cls) -> "ImageBindConfig":
        return cls(hidden_size=32, num_hidden_layers=2,
                   num_attention_heads=4, patch_size=14, image_size=28,
                   out_dim=16)


def _ln(x, p, eps):
    return _layer_norm(x, p["scale"], p["bias"], eps)


def _block(p: Params, x: torch.Tensor, cfg: ImageBindConfig) -> torch.Tensor:
    """One pre-norm BlockWithMasking (no layer-scale)."""
    h = _ln(x, p["ln1"], cfg.layer_norm_eps)
    x = x + attention(p["attn"], h, cfg.num_attention_heads)
    h = _ln(x, p["ln2"], cfg.layer_norm_eps)
    m = p["mlp"]
    return x + F.gelu(h @ m["w1"] + m["b1"]) @ m["w2"] + m["b2"]


def imagebind_vision_forward(params: Params, pixel_values: torch.Tensor,
                             cfg: ImageBindConfig) -> torch.Tensor:
    """(B, 3, H, W) -> (B, 1, out_dim), L2-normalised (ImageBindWrapper's
    vision branch, imagebind.py:49-54, with its ``unsqueeze(1)``)."""
    B = pixel_values.shape[0]
    w = params["patch_embed"]["w"]
    x = patchify(pixel_values, cfg.patch_size).to(w.dtype) @ w
    cls = params["cls_token"].expand(B, 1, cfg.hidden_size)
    x = torch.cat([cls, x], dim=1) + params["pos_embed"]
    x = _ln(x, params["pre_ln"], cfg.layer_norm_eps)
    for lp in params["layers"]:
        x = _block(lp, x, cfg)
    x = _ln(x, params["head_ln"], cfg.layer_norm_eps)
    emb = x[:, 0] @ params["head_proj"]["w"]
    emb = emb / torch.linalg.vector_norm(emb, dim=-1, keepdim=True)
    return emb[:, None, :]


def convert_imagebind(state: Mapping[str, Any],
                      cfg: ImageBindConfig = ImageBindConfig(),
                      dtype=torch.float32, device=None) -> Params:
    """The official state dict (``modality_preprocessors.vision.*``,
    ``modality_trunks.vision.*``, ``modality_heads.vision.*``) -> the
    tower's tree on ``device`` (default: the card): the Conv3d stem (D, 3,
    2, P, P) summed over time and flattened to the patchify layout, the
    packed in_proj split into q / k / v."""
    from video3d_tpu_torch.models.hf_vision import split_in_proj
    from video3d_tpu_torch.models.weights import _Reader
    from video3d_tpu_torch.params import resolve_device

    r = _Reader(state, "", resolve_device(device), dtype)
    pre, trunk = "modality_preprocessors.vision.", "modality_trunks.vision."
    head = "modality_heads.vision."
    w3d = r.raw(pre + "rgbt_stem.proj.1.weight").to(torch.float32)
    D = w3d.shape[0]
    w2d = w3d.sum(dim=2).reshape(D, -1).t().contiguous().to(dtype)
    layers = []
    while r.has(f"{trunk}blocks.{len(layers)}.norm_1.weight"):
        p = f"{trunk}blocks.{len(layers)}."
        layers.append({
            "ln1": {"scale": r.vec(p + "norm_1.weight"),
                    "bias": r.vec(p + "norm_1.bias")},
            "attn": split_in_proj(r, p + "attn."),
            "ln2": {"scale": r.vec(p + "norm_2.weight"),
                    "bias": r.vec(p + "norm_2.bias")},
            "mlp": {"w1": r.lin(p + "mlp.fc1.weight"),
                    "b1": r.vec(p + "mlp.fc1.bias"),
                    "w2": r.lin(p + "mlp.fc2.weight"),
                    "b2": r.vec(p + "mlp.fc2.bias")},
        })
    return {
        "patch_embed": {"w": w2d},
        "cls_token": r.vec(pre + "cls_token").reshape(1, -1),
        "pos_embed": r.vec(pre + "pos_embedding_helper.pos_embed"),
        "pre_ln": {"scale": r.vec(trunk + "pre_transformer_layer.0.weight"),
                   "bias": r.vec(trunk + "pre_transformer_layer.0.bias")},
        "layers": layers,
        "head_ln": {"scale": r.vec(head + "0.weight"),
                    "bias": r.vec(head + "0.bias")},
        "head_proj": {"w": r.lin(head + "2.weight")},
    }


def init_imagebind(cfg: ImageBindConfig, device, generator: torch.Generator,
                   dtype=torch.float32) -> Params:
    """Random tower with JAX ``init_imagebind``'s distributions (N(0, 0.02)
    matrices, tokens and positions; zero biases; unit LayerNorms), made on
    ``device`` from ``generator``."""
    D, M = cfg.hidden_size, cfg.hidden_size * cfg.mlp_ratio
    n_tok = (cfg.image_size // cfg.patch_size) ** 2 + 1

    def w(*shape):
        return torch.empty(shape, device=device, dtype=dtype).normal_(
            0.0, 0.02, generator=generator)

    def zeros(n):
        return torch.zeros(n, device=device, dtype=dtype)

    def ln():
        return {"scale": torch.ones(D, device=device, dtype=dtype),
                "bias": zeros(D)}

    def layer():
        return {"ln1": ln(),
                "attn": {"wq": w(D, D), "bq": zeros(D), "wk": w(D, D),
                         "bk": zeros(D), "wv": w(D, D), "bv": zeros(D),
                         "wo": w(D, D), "bo": zeros(D)},
                "ln2": ln(),
                "mlp": {"w1": w(D, M), "b1": zeros(M), "w2": w(M, D),
                        "b2": zeros(D)}}

    return {"patch_embed": {"w": w(3 * cfg.patch_size ** 2, D)},
            "cls_token": w(1, D), "pos_embed": w(1, n_tok, D),
            "pre_ln": ln(),
            "layers": [layer() for _ in range(cfg.num_hidden_layers)],
            "head_ln": ln(), "head_proj": {"w": w(D, cfg.out_dim)}}
