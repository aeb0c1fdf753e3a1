"""CLIP vision tower in PyTorch: counterpart of
``video3d_tpu/models/clip.py`` (the reference's other tower family,
multimodal_encoder/clip_encoder.py:12-176).

LLaVA semantics: run the CLIP ViT, take ``hidden_states[select_layer]``
(default -2, the penultimate layer's output) and drop the CLS token
('patch'). Against SigLIP: a class embedding in front, a LayerNorm after
the embeddings, the quick-GELU MLP and a learned position table of
num_patches + 1. ``clip_s2_forward`` is CLIPVisionTowerS2's multi-scale
forward (s2wrapper ``multiscale_forward`` with split_forward=True).
Attention is plain matmul + softmax (``siglip.attention``), as in JAX.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping

import torch

from video3d_tpu_torch.config import VisionConfig
from video3d_tpu_torch.models.siglip import _layer_norm, attention, patchify
from video3d_tpu_torch.ops.resize import area_downsample, bicubic_resize

Params = Dict[str, Any]


def quick_gelu(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(1.702 * x)


def clip_encoder_layer(p: Params, x: torch.Tensor,
                       cfg: VisionConfig) -> torch.Tensor:
    h = _layer_norm(x, p["ln1"]["scale"], p["ln1"]["bias"], cfg.layer_norm_eps)
    x = x + attention(p["attn"], h, cfg.num_attention_heads)
    h = _layer_norm(x, p["ln2"]["scale"], p["ln2"]["bias"], cfg.layer_norm_eps)
    m = p["mlp"]
    return x + quick_gelu(h @ m["w1"] + m["b1"]) @ m["w2"] + m["b2"]


def clip_embed(params: Params, pixel_values: torch.Tensor,
               cfg: VisionConfig) -> torch.Tensor:
    """Patch embedding (a bias-free conv), the class token in front, the
    position table, then the pre-LayerNorm: (B, N + 1, D)."""
    B = pixel_values.shape[0]
    w = params["patch_embed"]["w"]
    x = patchify(pixel_values, cfg.patch_size).to(w.dtype) @ w
    cls = params["class_embed"].expand(B, 1, cfg.hidden_size)
    x = torch.cat([cls, x], dim=1) + params["pos_embed"]
    return _layer_norm(x, params["pre_ln"]["scale"], params["pre_ln"]["bias"],
                       cfg.layer_norm_eps)


def clip_tower_forward(params: Params, pixel_values: torch.Tensor,
                       cfg: VisionConfig,
                       select_layer: int = -2) -> torch.Tensor:
    """(B, 3, S, S) -> (B, num_patches, D): hidden_states[select_layer] with
    the CLS token dropped (clip_encoder.py feature_select 'patch')."""
    x = clip_embed(params, pixel_values, cfg)
    n_layers = len(params["layers"]) + select_layer + 1 if select_layer < 0 \
        else select_layer
    for lp in params["layers"][:n_layers]:
        x = clip_encoder_layer(lp, x, cfg)
    return x[:, 1:, :]


def clip_s2_forward(params: Params, pixel_values: torch.Tensor,
                    cfg: VisionConfig, scales: tuple = (336, 672, 1008),
                    select_layer: int = -2) -> torch.Tensor:
    """CLIPVisionTowerS2.forward: the input is preprocessed at the largest
    scale, (B, 3, S_max, S_max). Per scale s: a bicubic resize to (s, s) in
    f32, an n x n chessboard of base-size tiles (n = ceil(s / scales[0])),
    the tower on every tile ('patch'), the tiles' feature maps merged into
    one (B, D, n g, n g) grid, an area downsample to the base grid; the
    scales concatenate along channels -> (B, g * g, D * len(scales))."""
    B = pixel_values.shape[0]
    split = scales[0]
    if split != cfg.image_size:
        raise ValueError("s2 base scale must equal the tower image size")
    x32 = pixel_values.to(torch.float32)
    merged = []
    for s in scales:
        n = -(-s // split)
        xs = bicubic_resize(x32, s, s).to(pixel_values.dtype)
        h = s // n
        # split_chessboard's tile-major batch order: out[(i n + j) B + b]
        tiles = xs.reshape(B, 3, n, h, n, h).permute(2, 4, 0, 1, 3, 5) \
            .reshape(n * n * B, 3, h, h)
        feats = clip_tower_forward(params, tiles, cfg, select_layer) \
            .to(pixel_values.dtype)
        g = int(round(feats.shape[1] ** 0.5))
        d = feats.shape[-1]
        # 'b (h w) c -> b c h w', then merge_chessboard
        f = feats.reshape(n, n, B, g, g, d).permute(2, 5, 0, 3, 1, 4) \
            .reshape(B, d, n * g, n * g)
        merged.append(f)
    out_size = merged[0].shape[-1]
    merged = [area_downsample(f.to(torch.float32), out_size).to(f.dtype)
              for f in merged]
    out = torch.cat(merged, dim=1)
    return out.reshape(B, out.shape[1], -1).transpose(1, 2)


def convert_clip(state: Mapping[str, Any], cfg: VisionConfig,
                 prefix: str = "vision_model.", dtype=torch.float32,
                 device=None) -> Params:
    """HF ``CLIPVisionModel`` state dict -> the clip tower tree on
    ``device`` (default: the card); every stored encoder layer is read."""
    from video3d_tpu_torch.models.weights import _Reader
    from video3d_tpu_torch.params import resolve_device

    r = _Reader(state, prefix, resolve_device(device), dtype)
    conv = r.vec("embeddings.patch_embedding.weight")
    layers = []
    while r.has(f"encoder.layers.{len(layers)}.layer_norm1.weight"):
        p = f"encoder.layers.{len(layers)}."
        layers.append({
            "ln1": {"scale": r.vec(p + "layer_norm1.weight"),
                    "bias": r.vec(p + "layer_norm1.bias")},
            "attn": {
                "wq": r.lin(p + "self_attn.q_proj.weight"),
                "bq": r.vec(p + "self_attn.q_proj.bias"),
                "wk": r.lin(p + "self_attn.k_proj.weight"),
                "bk": r.vec(p + "self_attn.k_proj.bias"),
                "wv": r.lin(p + "self_attn.v_proj.weight"),
                "bv": r.vec(p + "self_attn.v_proj.bias"),
                "wo": r.lin(p + "self_attn.out_proj.weight"),
                "bo": r.vec(p + "self_attn.out_proj.bias"),
            },
            "ln2": {"scale": r.vec(p + "layer_norm2.weight"),
                    "bias": r.vec(p + "layer_norm2.bias")},
            "mlp": {"w1": r.lin(p + "mlp.fc1.weight"),
                    "b1": r.vec(p + "mlp.fc1.bias"),
                    "w2": r.lin(p + "mlp.fc2.weight"),
                    "b2": r.vec(p + "mlp.fc2.bias")},
        })
    return {
        "patch_embed": {"w": conv.reshape(conv.shape[0], -1).t()
                        .contiguous()},
        "class_embed": r.vec("embeddings.class_embedding").reshape(1, -1),
        "pos_embed": r.vec("embeddings.position_embedding.weight"),
        "pre_ln": {"scale": r.vec("pre_layrnorm.weight"),
                   "bias": r.vec("pre_layrnorm.bias")},
        "layers": layers,
    }


def init_clip(cfg: VisionConfig, device, generator: torch.Generator,
              dtype=torch.float32) -> Params:
    """Random CLIP tower (a bench or test of the tower without weights):
    ``siglip.init_vision_tower``'s distributions, a bias-free patch
    embedding, N(0, 0.02) class token and (num_patches + 1)-row position
    table, unit pre-LayerNorm."""
    from video3d_tpu_torch.models.siglip import init_vision_tower

    p = init_vision_tower(cfg, device, generator, dtype)
    D = cfg.hidden_size

    def normal(*shape):
        return torch.empty(shape, device=device, dtype=dtype).normal_(
            0.0, 0.02, generator=generator)

    return {"patch_embed": {"w": p["patch_embed"]["w"]},
            "class_embed": normal(1, D),
            "pos_embed": normal(cfg.num_patches + 1, D),
            "pre_ln": {"scale": torch.ones(D, device=device, dtype=dtype),
                       "bias": torch.zeros(D, device=device, dtype=dtype)},
            "layers": p["layers"]}
