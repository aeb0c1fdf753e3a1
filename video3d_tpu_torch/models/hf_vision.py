"""The generic HF and OpenCLIP vision towers and the tower-family builder,
in PyTorch: counterpart of ``video3d_tpu/models/hf_vision.py``.

* ``HFVisionTower`` ("hf:" names, multimodal_encoder/hf_vision.py): the
  CLIP / SigLIP families with every hidden state collected, and
  :func:`feature_select`'s four modes (hf_vision.py:45-60).
* ``OpenCLIPVisionTower`` ("open_clip_hub:", open_clip_encoder.py): an
  OpenAI-layout ViT (fused in_proj, ln_pre, class and position
  embeddings) from the open_clip state-dict naming. The reference's
  non-timm path slices ``[:, 1:]`` of (tokens, batch, dim) features, the
  batch (open_clip_encoder.py:84); as JAX, the port drops the CLS token.
* ``imagebind_huge``: the native vision trunk of ``models/imagebind.py``.

:func:`build_vision_tower` follows the reference's dispatch
(multimodal_encoder/builder.py:13-38). Every tower's attention is plain
matmul + softmax, as JAX's (an einsum, not a kernel).
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Mapping, NamedTuple, Optional

import torch
import torch.nn.functional as F

from video3d_tpu_torch.config import VisionConfig
from video3d_tpu_torch.models.clip import clip_embed, clip_encoder_layer
from video3d_tpu_torch.models.siglip import (_layer_norm, attention,
                                             encoder_layer, patchify)
from video3d_tpu_torch.params import resolve_device

Params = Dict[str, Any]


def clip_hidden_states(params: Params, pixel_values: torch.Tensor,
                       cfg: VisionConfig) -> List[torch.Tensor]:
    """Every hidden state of HF's CLIP vision transformer: the
    pre-LayerNormed embeddings, then one per layer (layers + 1)."""
    x = clip_embed(params, pixel_values, cfg)
    states = [x]
    for lp in params["layers"]:
        x = clip_encoder_layer(lp, x, cfg)
        states.append(x)
    return states


def siglip_hidden_states(params: Params, pixel_values: torch.Tensor,
                         cfg: VisionConfig) -> List[torch.Tensor]:
    """Every hidden state of the SigLIP tower (no CLS token): the
    embeddings, then one per layer."""
    w = params["patch_embed"]["w"]
    x = patchify(pixel_values, cfg.patch_size).to(w.dtype) @ w \
        + params["patch_embed"]["b"] + params["pos_embed"]
    states = [x]
    for lp in params["layers"]:
        x = encoder_layer(lp, x, cfg)
        states.append(x)
    return states


def feature_select(hidden_states: List[torch.Tensor], select_layer: int,
                   select_feature: str = "patch") -> torch.Tensor:
    """``hidden_states[select_layer]`` in the reference's modes: patch
    (CLS dropped), cls_patch, and slicefour_patch / slicefour_cls_patch,
    which concatenate every (len // 4)-th state from ``len // 4 +
    select_layer`` along channels (hf_vision.py:48-51)."""
    if select_feature in ("slicefour_patch", "slicefour_cls_patch"):
        k = len(hidden_states) // 4
        feats = torch.cat([hidden_states[i] for i in
                           range(k + select_layer, len(hidden_states), k)],
                          dim=-1)
        select_feature = select_feature.replace("slicefour_", "")
    else:
        feats = hidden_states[select_layer]
    if select_feature == "patch":
        return feats[:, 1:]
    if select_feature == "cls_patch":
        return feats
    raise ValueError(f"Unexpected select feature: {select_feature}")


def hf_vision_tower_forward(params: Params, pixel_values: torch.Tensor,
                            cfg: VisionConfig, family: str = "clip",
                            select_layer: int = -2,
                            select_feature: str = "patch") -> torch.Tensor:
    """HFVisionTower.forward (hf_vision.py:62-74) for the CLIP / SigLIP
    families."""
    collect = {"clip": clip_hidden_states,
               "siglip": siglip_hidden_states}[family]
    return feature_select(collect(params, pixel_values, cfg), select_layer,
                          select_feature)


def open_clip_encoder_layer(p: Params, x: torch.Tensor, cfg: VisionConfig,
                            quick_gelu: bool) -> torch.Tensor:
    """One open_clip ResidualAttentionBlock: the CLIP layer, with exact
    GELU unless the model was built with quick_gelu (OpenAI weights)."""
    if quick_gelu:
        return clip_encoder_layer(p, x, cfg)
    h = _layer_norm(x, p["ln1"]["scale"], p["ln1"]["bias"], cfg.layer_norm_eps)
    x = x + attention(p["attn"], h, cfg.num_attention_heads)
    h = _layer_norm(x, p["ln2"]["scale"], p["ln2"]["bias"], cfg.layer_norm_eps)
    m = p["mlp"]
    return x + F.gelu(h @ m["w1"] + m["b1"]) @ m["w2"] + m["b2"]


def open_clip_tower_forward(params: Params, pixel_values: torch.Tensor,
                            cfg: VisionConfig, select_layer: int = -2,
                            select_feature: str = "patch",
                            quick_gelu: bool = False) -> torch.Tensor:
    """OpenCLIPVisionTower.forward_visual and its feature select
    (open_clip_encoder.py:63-117): conv1, [CLS; patches] + positions,
    ln_pre, then the blocks with one state per block (no embeddings
    entry, unlike the HF towers)."""
    x = clip_embed(params, pixel_values, cfg)
    states = []
    for lp in params["layers"]:
        x = open_clip_encoder_layer(lp, x, cfg, quick_gelu)
        states.append(x)
    feats = states[select_layer]
    if select_feature == "patch":
        return feats[:, 1:]
    if select_feature in ("cls_patch", "conv_flatten"):
        return feats
    raise ValueError(f"Unexpected select feature: {select_feature}")


def split_in_proj(r, p: str) -> Dict[str, torch.Tensor]:
    """A packed ``in_proj_weight`` (3D, D) / ``in_proj_bias`` and the
    ``out_proj`` of ``nn.MultiheadAttention`` -> the tower's q / k / v / o
    (in, out) weights and biases."""
    w = r.lin(p + "in_proj_weight")                 # (D, 3D)
    b = r.vec(p + "in_proj_bias")
    D = w.shape[0]
    out = {}
    for i, n in enumerate("qkv"):
        out["w" + n] = w[:, i * D:(i + 1) * D].contiguous()
        out["b" + n] = b[i * D:(i + 1) * D].contiguous()
    out["wo"] = r.lin(p + "out_proj.weight")
    out["bo"] = r.vec(p + "out_proj.bias")
    return out


def convert_open_clip(state: Mapping[str, Any], dtype=torch.float32,
                      prefix: str = "visual.", device=None) -> Params:
    """An open_clip visual state dict (conv1, class_embedding,
    positional_embedding, ln_pre, transformer.resblocks.N.{ln_1,
    attn.in_proj_*, attn.out_proj, ln_2, mlp.c_fc, mlp.c_proj}) -> the
    clip tree layout, the fused in_proj split into q / k / v."""
    from video3d_tpu_torch.models.weights import _Reader

    r = _Reader(state, prefix, resolve_device(device), dtype)
    conv = r.vec("conv1.weight")
    layers = []
    while r.has(f"transformer.resblocks.{len(layers)}.ln_1.weight"):
        p = f"transformer.resblocks.{len(layers)}."
        layers.append({
            "ln1": {"scale": r.vec(p + "ln_1.weight"),
                    "bias": r.vec(p + "ln_1.bias")},
            "attn": split_in_proj(r, p + "attn."),
            "ln2": {"scale": r.vec(p + "ln_2.weight"),
                    "bias": r.vec(p + "ln_2.bias")},
            "mlp": {"w1": r.lin(p + "mlp.c_fc.weight"),
                    "b1": r.vec(p + "mlp.c_fc.bias"),
                    "w2": r.lin(p + "mlp.c_proj.weight"),
                    "b2": r.vec(p + "mlp.c_proj.bias")},
        })
    return {
        "patch_embed": {"w": conv.reshape(conv.shape[0], -1).t()
                        .contiguous()},
        "class_embed": r.vec("class_embedding").reshape(1, -1),
        "pos_embed": r.vec("positional_embedding"),
        "pre_ln": {"scale": r.vec("ln_pre.weight"),
                   "bias": r.vec("ln_pre.bias")},
        "layers": layers,
    }


class VisionTower(NamedTuple):
    family: str                 # 'clip', 'clip_s2', 'siglip', 'hf',
                                # 'open_clip' or 'imagebind'
    forward: Callable           # (params, pixels) -> (B, N, D)
    convert: Callable           # state dict -> params on the tower's device
    cfg: Optional[Any]


def build_vision_tower(vision_tower: str, cfg: Optional[VisionConfig] = None,
                       select_layer: int = -2,
                       select_feature: str = "patch",
                       use_s2: bool = False, s2_scales: str = "",
                       dtype=torch.float32, device=None) -> VisionTower:
    """The reference's name-based dispatch (multimodal_encoder/builder.py
    :13-38): a 'siglip' substring -> SigLIP; 'hf:' -> the HF families;
    'open_clip_hub:' -> OpenCLIP; 'imagebind_huge' -> the native ImageBind
    vision trunk; an existing path or an openai / laion / ShareGPT4V name
    -> CLIP, or CLIP under S2 with ``use_s2``. The converters put the
    weights on ``device`` (default: the card; ``device="cpu"`` for the
    CPU), where the forward then runs."""
    import os

    from video3d_tpu_torch.models import clip as clip_mod
    from video3d_tpu_torch.models import siglip as siglip_mod
    from video3d_tpu_torch.models import weights as weights_mod

    dev = resolve_device(device)
    name = vision_tower
    if "siglip" in name:
        c = cfg or VisionConfig()
        return VisionTower(
            "siglip", lambda p, x: siglip_mod.vision_tower_forward(p, x, c),
            lambda s: weights_mod.convert_siglip(s, c, prefix="vision_model.",
                                                 dtype=dtype, device=dev), c)
    if name.startswith("hf:"):
        c = cfg or VisionConfig()
        # CLIP-like models carry a class embedding, SigLIP-like do not
        family = "siglip" if "siglip" in name.lower() else "clip"
        if family == "siglip":
            def conv(s):
                return weights_mod.convert_siglip(s, c, prefix="vision_model.",
                                                  dtype=dtype, device=dev)
        else:
            def conv(s):
                return clip_mod.convert_clip(s, c, dtype=dtype, device=dev)
        return VisionTower(
            "hf", lambda p, x: hf_vision_tower_forward(
                p, x, c, family=family, select_layer=select_layer,
                select_feature=select_feature), conv, c)
    if name.startswith("open_clip_hub"):
        c = cfg or VisionConfig()
        return VisionTower(
            "open_clip", lambda p, x: open_clip_tower_forward(
                p, x, c, select_layer=select_layer,
                select_feature=select_feature),
            lambda s: convert_open_clip(s, dtype=dtype, device=dev), c)
    if name in ("imagebind_huge",):
        from video3d_tpu_torch.models import imagebind as ib

        c = ib.ImageBindConfig()
        return VisionTower(
            "imagebind", lambda p, x: ib.imagebind_vision_forward(p, x, c),
            lambda s: ib.convert_imagebind(s, c, dtype=dtype, device=dev),
            None)
    if os.path.exists(name) or name.startswith("openai") \
            or name.startswith("laion") or "ShareGPT4V" in name:
        c = cfg or VisionConfig()
        if use_s2:
            scales = tuple(sorted(
                int(v) for v in (s2_scales or "336,672,1008").split(",")))
            return VisionTower(
                "clip_s2", lambda p, x: clip_mod.clip_s2_forward(
                    p, x, c, scales=scales, select_layer=select_layer),
                lambda s: clip_mod.convert_clip(s, c, dtype=dtype,
                                                device=dev), c)
        return VisionTower(
            "clip", lambda p, x: clip_mod.clip_tower_forward(
                p, x, c, select_layer=select_layer),
            lambda s: clip_mod.convert_clip(s, c, dtype=dtype, device=dev),
            c)
    raise ValueError(f"Unknown vision tower: {vision_tower}")
