"""Pretrained model loading: an HF checkpoint directory -> (tokenizer,
params, ModelConfig, context length). Counterpart of
``video3d_tpu/models/builder.py`` (the reference's
``load_pretrained_model``, model/builder.py:27-305).

``config.json`` gives the decoder family and the 3D knobs the reference
persists (``world_position_embedding_type``, ``voxel_size``,
``min/max_xyz_range``, ``object_feature_type``, ``ground_head_type``); an
``overwrite_config`` dict overrides them (the eval drivers'
``{"vocab_size": ..., "tie_word_embeddings": False}``). Every family's
config parses and loads as in JAX (Qwen2, Qwen2-MoE, LLaMA, Mistral,
Mixtral, Gemma, MPT); ``params.check_config`` refuses only what JAX cannot
run. The weights convert through
:mod:`~video3d_tpu_torch.models.weights` onto the card unless the caller
asks for the CPU. The tokenizer goes through ``transformers`` only when
asked for (``load_tokenizer=True``): the card's machine has no
``transformers``.
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, Optional

import torch

from video3d_tpu_torch.config import (GroundHeadType, LLMConfig, ModelConfig,
                                      MoEConfig, ObjectFeatureType,
                                      VisionConfig, VoxelConfig,
                                      World3DConfig, replace)
from video3d_tpu_torch.models.weights import mpt_config_from_hf
from video3d_tpu_torch.params import check_config, init_model, resolve_device


def llm_config_from_hf(hf: Dict[str, Any]) -> LLMConfig:
    """HF config.json dict -> LLMConfig: qwen2 (qkv bias, theta 1e6),
    llama / mistral / mixtral (no bias, theta 1e4; mixtral and qwen2_moe
    with their MoE), gemma (gelu_tanh MLP, (1 + w) RMSNorm, sqrt(D) embed
    scale, tied head), mpt (ALiBi, LayerNorm, ungated GELU MLP)."""
    model_type = hf.get("model_type", "qwen2")
    if model_type == "mpt":
        return mpt_config_from_hf(hf)
    is_llama = any(t in model_type for t in ("llama", "mistral", "mixtral"))
    is_gemma = "gemma" in model_type
    heads = hf["num_attention_heads"]
    head_dim = hf.get("head_dim") or hf["hidden_size"] // heads
    act = hf.get("hidden_activation") or hf.get("hidden_act", "silu")
    moe = None
    if "mixtral" in model_type:
        moe = MoEConfig(num_experts=hf.get("num_local_experts", 8),
                        num_experts_per_tok=hf.get("num_experts_per_tok", 2),
                        moe_intermediate_size=hf["intermediate_size"],
                        shared_expert_intermediate_size=None,
                        norm_topk_prob=True)
    elif "qwen2_moe" in model_type:
        moe = MoEConfig(num_experts=hf.get("num_experts", 60),
                        num_experts_per_tok=hf.get("num_experts_per_tok", 4),
                        moe_intermediate_size=hf["moe_intermediate_size"],
                        shared_expert_intermediate_size=hf.get(
                            "shared_expert_intermediate_size", 0) or None,
                        norm_topk_prob=hf.get("norm_topk_prob", False))
    return LLMConfig(
        moe=moe,
        vocab_size=hf["vocab_size"],
        hidden_size=hf["hidden_size"],
        intermediate_size=hf["intermediate_size"],
        num_hidden_layers=hf["num_hidden_layers"],
        num_attention_heads=heads,
        num_key_value_heads=hf.get("num_key_value_heads", heads),
        head_dim=head_dim,
        rms_norm_eps=hf.get("rms_norm_eps", 1e-6),
        rope_theta=hf.get("rope_theta",
                          1e6 if not (is_llama or is_gemma) else 1e4),
        max_position_embeddings=hf.get("max_position_embeddings", 32768),
        tie_word_embeddings=hf.get("tie_word_embeddings", is_gemma),
        attention_bias=hf.get("attention_bias", not (is_llama or is_gemma)),
        mrope_section=(head_dim // 4, head_dim // 8, head_dim // 8),
        hidden_act="gelu_tanh" if "gelu" in act else "silu",
        rms_norm_add_unit_offset=is_gemma,
        embed_scale=is_gemma,
    )


def model_config_from_hf(hf: Dict[str, Any]) -> ModelConfig:
    """The 3D knobs the reference stores in the checkpoint's config."""
    w3d = World3DConfig.from_reference_string(
        hf.get("world_position_embedding_type", "avg-discrete-sin3d"),
        VoxelConfig(
            voxel_size=hf.get("voxel_size", 0.1),
            min_xyz_range=tuple(hf.get("min_xyz_range", (-15, -15, -5))),
            max_xyz_range=tuple(hf.get("max_xyz_range", (15, 15, 5)))))
    oft = hf.get("object_feature_type", "patch14-pe")
    w3d = replace(w3d,
                  object_feature_type=(ObjectFeatureType.PATCH27
                                       if "patch27" in oft
                                       else ObjectFeatureType.PATCH14),
                  object_feature_use_pe="pe" in oft)
    ground = hf.get("ground_head_type") or "none"
    pin = hf.get("image_grid_pinpoints", ModelConfig.image_grid_pinpoints)
    if isinstance(pin, list):
        pin = tuple(tuple(p) for p in pin)
    return ModelConfig(
        llm=llm_config_from_hf(hf),
        world_3d=w3d,
        ground_head=GroundHeadType(ground),
        ground_head_temperature=hf.get("ground_head_temperature", 0.07),
        tokenizer_model_max_length=hf.get("tokenizer_model_max_length", 32768),
        image_aspect_ratio=hf.get("image_aspect_ratio", "anyres"),
        image_grid_pinpoints=pin,
        mm_patch_merge_type=hf.get("mm_patch_merge_type", "spatial_unpad"),
        resampler_type=hf.get("mm_resampler_type"),
    )


def _load_torch_bin(path: str) -> Dict[str, torch.Tensor]:
    """A torch-saved ``.bin`` state dict -> {key: f32 CPU tensor}."""
    sd = torch.load(path, map_location="cpu", weights_only=True)
    return {k: v.to(torch.float32) for k, v in sd.items()}


def _strip_wrapper_prefixes(sd: Dict[str, Any]) -> Dict[str, Any]:
    """``non_lora_trainables.bin`` key cleanup, the reference's
    builder.py:104-107: drop 'base_model.', then one more 'model.' if
    'model.model.' keys remain."""
    sd = {(k[len("base_model."):] if k.startswith("base_model.") else k): v
          for k, v in sd.items()}
    if any(k.startswith("model.model.") for k in sd):
        sd = {(k[len("model."):] if k.startswith("model.") else k): v
              for k, v in sd.items()}
    return sd


def merge_lora_into_state(state: Dict[str, Any], model_path: str) -> None:
    """Merge a peft adapter directory into an HF state dict in place: ``w
    += (alpha / r) * B @ A`` in f32 at every adapted Linear (peft's
    ``lora_A`` (r, in) and ``lora_B`` (out, r); HF weights are (out, in)).
    The adapter is ``adapter_model.safetensors`` (read by the port's own
    reader) or ``adapter_model.bin``."""
    with open(os.path.join(model_path, "adapter_config.json")) as f:
        acfg = json.load(f)
    scale = acfg["lora_alpha"] / acfg["r"]
    st = os.path.join(model_path, "adapter_model.safetensors")
    if os.path.exists(st):
        from video3d_tpu_torch.models.weights import read_safetensors

        ad = read_safetensors(st)
    else:
        ad = _load_torch_bin(os.path.join(model_path, "adapter_model.bin"))
    for k, a in ad.items():
        if not k.endswith("lora_A.weight"):
            continue
        b = ad[k[: -len("lora_A.weight")] + "lora_B.weight"]
        base = k[: -len(".lora_A.weight")]
        for pref in ("base_model.model.", "base_model."):
            if base.startswith(pref):
                base = base[len(pref):]
                break
        base += ".weight"
        if base not in state:
            raise KeyError(f"LoRA target {base!r} not in base checkpoint")
        delta = (torch.as_tensor(b).to(torch.float32)
                 @ torch.as_tensor(a).to(torch.float32)) * scale
        state[base] = torch.as_tensor(state[base]).to(torch.float32) + delta


def _read_config(model_path: str,
                 overwrite_config: Optional[Dict[str, Any]]) -> dict:
    with open(os.path.join(model_path, "config.json")) as f:
        hf = json.load(f)
    if overwrite_config:
        hf.update(overwrite_config)
    return hf


def _tokenizer(path: str):
    from transformers import AutoTokenizer

    return AutoTokenizer.from_pretrained(path)


def load_dummy_model(model_path: str, bits: int = 16, act: str = "none",
                     overwrite_config: Optional[Dict[str, Any]] = None,
                     load_tokenizer: bool = True, device=None,
                     dtype=torch.bfloat16):
    """``--load-format dummy``: (tokenizer, params, ModelConfig) from a
    directory holding only ``config.json`` (and tokenizer files); the
    weights are ``params.init_model``'s, drawn on ``device`` (default: the
    card) from seed 0, quantized per ``bits`` / ``act`` as
    ``quantize_tree`` would the loaded weights. An optional
    ``vision_config`` dict in config.json overrides the so400m tower."""
    hf = _read_config(model_path, overwrite_config)
    cfg = model_config_from_hf(hf)
    if "vision_config" in hf:
        cfg = replace(cfg, vision=VisionConfig(**hf["vision_config"]))
    dev = resolve_device(device)
    params = init_model(cfg, dev, torch.Generator(device=dev).manual_seed(0),
                        dtype, bits=bits, act=act)
    return (_tokenizer(model_path) if load_tokenizer else None), params, cfg


def load_pretrained_model(model_path: str,
                          model_name: Optional[str] = None,
                          model_base: Optional[str] = None,
                          overwrite_config: Optional[Dict[str, Any]] = None,
                          dtype=torch.bfloat16,
                          load_tokenizer: bool = True,
                          vision_config: Optional[VisionConfig] = None,
                          device=None):
    """(tokenizer, params, model_cfg, context_len), the params on
    ``device`` (default: the card; without one this raises) in ``dtype``.

    The reference's three branches (builder.py:54-157):
      * ``model_base`` and 'lora' in the model name: the base weights from
        ``model_base``, ``non_lora_trainables.bin`` laid over them
        (projector, newline, ground head), then the peft adapter merged;
      * ``model_base`` alone: a projector-only checkpoint,
        ``mm_projector.bin`` over the base weights;
      * neither: a full checkpoint.
    config.json always comes from ``model_path``, the tokenizer from
    ``model_base`` when given. A configured resampler's weights
    (``model.vision_resampler.*``) load into ``params["resampler"]`` (JAX
    ``builder.py:312-316``). A decoder JAX cannot run raises a ValueError
    (``params.check_config``)."""
    from video3d_tpu_torch.models.weights import (convert_llava_checkpoint,
                                                  convert_resampler,
                                                  load_safetensors_dir,
                                                  vision_config_from_state,
                                                  TOWER_PREFIX)

    dev = resolve_device(device)
    name = model_name or os.path.basename(os.path.normpath(model_path))
    hf = _read_config(model_path, overwrite_config)
    cfg = model_config_from_hf(hf)
    if model_base is not None and "lora" in name.lower():
        state = load_safetensors_dir(model_base)
        nlt = os.path.join(model_path, "non_lora_trainables.bin")
        if os.path.exists(nlt):
            state.update(_strip_wrapper_prefixes(_load_torch_bin(nlt)))
        merge_lora_into_state(state, model_path)
    elif model_base is not None:
        state = load_safetensors_dir(model_base)
        state.update(_load_torch_bin(os.path.join(model_path,
                                                  "mm_projector.bin")))
    else:
        state = load_safetensors_dir(model_path)
    if vision_config is None and \
            TOWER_PREFIX + "embeddings.patch_embedding.weight" in state:
        vision_config = vision_config_from_state(state)
    if vision_config is not None:
        cfg = replace(cfg, vision=vision_config)
    check_config(cfg)
    params = convert_llava_checkpoint(
        state, cfg.llm, cfg.vision, dtype=dtype,
        ground_head="ground_head_obj.0.weight" in state, device=dev)
    if cfg.resampler_type and any(k.startswith("model.vision_resampler.")
                                  for k in state):
        params["resampler"] = convert_resampler(state, cfg.resampler_type,
                                                dtype=dtype, device=dev)
    del state
    tokenizer = _tokenizer(model_base or model_path) if load_tokenizer \
        else None
    context_len = hf.get("max_sequence_length",
                         hf.get("tokenizer_model_max_length", 32768))
    return tokenizer, params, cfg, context_len
