"""Hugging Face checkpoints -> the port's parameter trees, and back:
counterpart of ``video3d_tpu/models/weights.py`` (``load_safetensors_dir``,
``convert_qwen2`` with its Qwen2-MoE and Mixtral layers, ``convert_mpt``
and ``mpt_config_from_hf``, ``convert_siglip``,
``vision_config_from_state``, ``convert_projector``, ``convert_resampler``,
``convert_llava_checkpoint`` with the ground head, and
``export_llava_checkpoint``).

Key layout of the reference's checkpoints (train_3d.py:1425-1475,
llava_arch.py:34-144): the LLM at the root (``model.layers.{i}.*``,
``lm_head``), the tower under ``model.vision_tower.vision_tower.``, the
projector under ``model.mm_projector.``, ``model.image_newline``, and the
ground head at the root (llava_qwen.py:57). HF linears are (out, in); the
port stores (in, out) and applies ``x @ w``.

The ``safetensors`` format is read and written here, without the
``safetensors`` package: an 8-byte little-endian header length, a JSON
header of each tensor's dtype, shape and byte offsets, then the raw
little-endian bytes (:func:`read_safetensors`, :func:`write_safetensors`).

The export writes the dense gated MLP of the Qwen2 layout only, as JAX's
does (``weights.py:438-441``, where a MoE or an MPT tree fails): the port
refuses those trees with a ValueError before writing anything.
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, Mapping, Optional

import numpy as np
import torch

from video3d_tpu_torch.config import LLMConfig, VisionConfig
from video3d_tpu_torch.params import resolve_device

#: safetensors dtype names <-> torch dtypes
_DTYPES = {"F64": torch.float64, "F32": torch.float32, "F16": torch.float16,
           "BF16": torch.bfloat16, "I64": torch.int64, "I32": torch.int32,
           "I16": torch.int16, "I8": torch.int8, "U8": torch.uint8,
           "BOOL": torch.bool}
_NAMES = {v: k for k, v in _DTYPES.items()}

TOWER_PREFIX = "model.vision_tower.vision_tower.vision_model."
PROJECTOR_PREFIX = "model.mm_projector."


# ---------------------------------------------------------------------------
# the safetensors format
# ---------------------------------------------------------------------------

def read_safetensors(path: str) -> Dict[str, torch.Tensor]:
    """Every tensor of a ``.safetensors`` file, as CPU tensors of the
    file's dtypes (bf16 included), in the header's order."""
    with open(path, "rb") as f:
        n = int.from_bytes(f.read(8), "little")
        header = json.loads(f.read(n))
        data = np.fromfile(f, dtype=np.uint8)
    out: Dict[str, torch.Tensor] = {}
    for name, info in header.items():
        if name == "__metadata__":
            continue
        if info["dtype"] not in _DTYPES:
            raise ValueError(f"{path}: tensor {name!r} has dtype "
                             f"{info['dtype']}, which the reader lacks")
        begin, end = info["data_offsets"]
        raw = torch.from_numpy(data[begin:end].copy())
        out[name] = raw.view(_DTYPES[info["dtype"]]).reshape(info["shape"])
    return out


def write_safetensors(tensors: Mapping[str, Any], path: str) -> int:
    """Write ``tensors`` (torch tensors or numpy arrays) to ``path`` in
    the safetensors format, each as its contiguous bytes; returns the
    file's size in bytes. The header is padded with spaces to a multiple
    of 8 bytes, as the format asks."""
    header: Dict[str, Any] = {}
    blobs = []
    offset = 0
    for name, t in tensors.items():
        if isinstance(t, np.ndarray):
            t = torch.from_numpy(np.ascontiguousarray(t))
        t = t.detach().to("cpu").contiguous()
        if t.dtype not in _NAMES:
            raise ValueError(f"tensor {name!r}: dtype {t.dtype} has no "
                             f"safetensors name here")
        raw = t.reshape(-1).view(torch.uint8).numpy()
        header[name] = {"dtype": _NAMES[t.dtype], "shape": list(t.shape),
                        "data_offsets": [offset, offset + raw.nbytes]}
        blobs.append(raw)
        offset += raw.nbytes
    head = json.dumps(header, separators=(",", ":")).encode()
    head += b" " * (-len(head) % 8)
    with open(path, "wb") as f:
        f.write(len(head).to_bytes(8, "little"))
        f.write(head)
        for raw in blobs:
            raw.tofile(f)
    return 8 + len(head) + offset


def load_safetensors_dir(path: str) -> Dict[str, torch.Tensor]:
    """Every ``*.safetensors`` shard under ``path`` (in name order) in
    one dict."""
    out: Dict[str, torch.Tensor] = {}
    for fname in sorted(os.listdir(path)):
        if fname.endswith(".safetensors"):
            out.update(read_safetensors(os.path.join(path, fname)))
    return out


# ---------------------------------------------------------------------------
# HF -> the port
# ---------------------------------------------------------------------------

class _Reader:
    """Leaves of ``state`` (torch tensors or numpy arrays) on ``device``
    in ``dtype``: ``vec`` as stored, ``lin`` transposed (out, in) ->
    (in, out). Casts and transposes run on the device."""

    def __init__(self, state: Mapping[str, Any], prefix: str, device,
                 dtype):
        self.state, self.prefix = state, prefix
        self.device, self.dtype = device, dtype

    def has(self, k: str) -> bool:
        return self.prefix + k in self.state

    def raw(self, k: str) -> torch.Tensor:
        t = self.state[self.prefix + k]
        if isinstance(t, np.ndarray):
            t = torch.from_numpy(np.ascontiguousarray(t))
        return t.to(self.device)

    def vec(self, k: str) -> torch.Tensor:
        return self.raw(k).to(self.dtype)

    def lin(self, k: str) -> torch.Tensor:
        return self.raw(k).to(self.dtype).t().contiguous()


def convert_qwen2(state: Mapping[str, Any], cfg: LLMConfig, prefix: str = "",
                  dtype=torch.float32, device=None) -> Dict[str, Any]:
    """HF ``Qwen2ForCausalLM`` state dict -> the port's qwen2 tree on
    ``device`` (default: the card, :func:`resolve_device`) in ``dtype``.
    Checkpoints without q/k/v biases (the LLaMA family) load without them;
    a tied checkpoint takes its head from the embeddings. A layer without
    ``mlp.gate_proj`` is a MoE layer: Qwen2-MoE's (``mlp.gate``) or
    Mixtral's (``block_sparse_moe``), read by ``models/moe.py``'s
    converters into a ``moe`` subtree."""
    from video3d_tpu_torch.models import moe

    dev = resolve_device(device)
    r = _Reader(state, prefix, dev, dtype)
    layers = []
    for i in range(cfg.num_hidden_layers):
        p = f"model.layers.{i}."
        attn = {"wq": r.lin(p + "self_attn.q_proj.weight"),
                "wk": r.lin(p + "self_attn.k_proj.weight"),
                "wv": r.lin(p + "self_attn.v_proj.weight"),
                "wo": r.lin(p + "self_attn.o_proj.weight")}
        if r.has(p + "self_attn.q_proj.bias"):
            attn.update({"bq": r.vec(p + "self_attn.q_proj.bias"),
                         "bk": r.vec(p + "self_attn.k_proj.bias"),
                         "bv": r.vec(p + "self_attn.v_proj.bias")})
        layer = {"input_layernorm": r.vec(p + "input_layernorm.weight"),
                 "attn": attn,
                 "post_attention_layernorm": r.vec(
                     p + "post_attention_layernorm.weight")}
        if r.has(p + "mlp.gate_proj.weight"):
            layer["mlp"] = {"w_gate": r.lin(p + "mlp.gate_proj.weight"),
                            "w_up": r.lin(p + "mlp.up_proj.weight"),
                            "w_down": r.lin(p + "mlp.down_proj.weight")}
        elif r.has(p + "mlp.gate.weight"):
            layer["moe"] = moe.convert_moe_layer(state, i, cfg.moe, prefix,
                                                 dtype, dev)
        else:
            layer["moe"] = moe.convert_mixtral_layer(state, i, cfg.moe,
                                                     prefix, dtype, dev)
        layers.append(layer)
    embed = r.vec("model.embed_tokens.weight"
                  if r.has("model.embed_tokens.weight") else "lm_head.weight")
    head = r.lin("lm_head.weight") if r.has("lm_head.weight") \
        else embed.t().contiguous()
    return {"embed_tokens": embed, "layers": layers,
            "norm": r.vec("model.norm.weight"), "lm_head": head}


def convert_mpt(state: Mapping[str, Any], cfg: LLMConfig, prefix: str = "",
                dtype=torch.float32, device=None) -> Dict[str, Any]:
    """HF ``MptForCausalLM`` state dict -> the port's decoder tree (the ALiBi
    family, the reference's ``llava_mpt.py``): per block ``norm_1``, the
    fused ``attn.Wqkv`` split into q / k / v, ``attn.out_proj``,
    ``norm_2``, the ungated ``ffn.up_proj`` / ``ffn.down_proj``; the final
    ``norm_f``; the head tied to ``transformer.wte``."""
    r = _Reader(state, prefix, resolve_device(device), dtype)
    D = cfg.hidden_size
    layers = []
    for i in range(cfg.num_hidden_layers):
        p = f"transformer.blocks.{i}."
        wqkv = r.lin(p + "attn.Wqkv.weight")            # (D, 3D)
        layers.append({
            "input_layernorm": r.vec(p + "norm_1.weight"),
            "attn": {"wq": wqkv[:, :D].contiguous(),
                     "wk": wqkv[:, D:2 * D].contiguous(),
                     "wv": wqkv[:, 2 * D:].contiguous(),
                     "wo": r.lin(p + "attn.out_proj.weight")},
            "post_attention_layernorm": r.vec(p + "norm_2.weight"),
            "mlp": {"w_up": r.lin(p + "ffn.up_proj.weight"),
                    "w_down": r.lin(p + "ffn.down_proj.weight")},
        })
    embed = r.vec("transformer.wte.weight")
    return {"embed_tokens": embed, "layers": layers,
            "norm": r.vec("transformer.norm_f.weight"),
            "lm_head": embed.t().contiguous()}


def mpt_config_from_hf(hf: Mapping[str, Any]) -> LLMConfig:
    """HF ``MptConfig`` dict -> LLMConfig (ALiBi, LayerNorm, ungated GELU,
    tied head, full multi-head attention)."""
    d = hf["d_model"]
    heads = hf["n_heads"]
    attn_cfg = hf.get("attn_config", {}) or {}
    return LLMConfig(
        vocab_size=hf["vocab_size"],
        hidden_size=d,
        intermediate_size=int(hf.get("expansion_ratio", 4)) * d,
        num_hidden_layers=hf["n_layers"],
        num_attention_heads=heads,
        num_key_value_heads=heads,
        head_dim=d // heads,
        rms_norm_eps=hf.get("layer_norm_epsilon", 1e-5),
        max_position_embeddings=hf.get("max_seq_len", 2048),
        tie_word_embeddings=True,
        attention_bias=False,
        hidden_act="gelu",
        position_embedding="alibi",
        norm_type="layernorm",
        alibi_bias_max=attn_cfg.get("alibi_bias_max", 8.0),
        mrope_section=(d // heads // 4, d // heads // 8, d // heads // 8),
    )


def convert_siglip(state: Mapping[str, Any], cfg: VisionConfig,
                   prefix: str = "vision_model.", dtype=torch.float32,
                   device=None) -> Dict[str, Any]:
    """HF ``SiglipVisionModel`` state dict -> the port's siglip tree. The
    (D, 3, ps, ps) patch convolution flattens in (c, kh, kw) order, as
    ``siglip.patchify`` emits patches, then transposes. Only the first
    ``cfg.num_hidden_layers`` encoder layers are read."""
    r = _Reader(state, prefix, resolve_device(device), dtype)
    conv = r.raw("embeddings.patch_embedding.weight").to(dtype)
    layers = []
    for i in range(cfg.num_hidden_layers):
        p = f"encoder.layers.{i}."
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
    return {"patch_embed": {"w": conv.reshape(conv.shape[0], -1).t()
                            .contiguous(),
                            "b": r.vec("embeddings.patch_embedding.bias")},
            "pos_embed": r.vec("embeddings.position_embedding.weight"),
            "layers": layers}


def vision_config_from_state(state: Mapping[str, Any],
                             prefix: str = TOWER_PREFIX,
                             num_attention_heads: Optional[int] = None
                             ) -> VisionConfig:
    """The tower's dimensions from its checkpoint shapes (LLaVA checkpoints
    store the tower with its last layer already deleted, so the stored
    count is the run count). The head count is not in the shapes: pass it,
    or 16 is taken for a 1152-wide tower (so400m) and hidden // 64
    otherwise."""
    n_layers = 0
    while f"{prefix}encoder.layers.{n_layers}.layer_norm1.weight" in state:
        n_layers += 1
    hidden, _, patch, _ = tuple(
        state[prefix + "embeddings.patch_embedding.weight"].shape)
    side = int(round(
        state[prefix + "embeddings.position_embedding.weight"].shape[0]
        ** 0.5))
    inter = state[prefix + "encoder.layers.0.mlp.fc1.weight"].shape[0]
    if num_attention_heads is None:
        num_attention_heads = 16 if hidden == 1152 else max(1, hidden // 64)
    return VisionConfig(hidden_size=int(hidden), intermediate_size=int(inter),
                        num_hidden_layers=n_layers,
                        num_attention_heads=num_attention_heads,
                        image_size=side * int(patch), patch_size=int(patch))


def convert_projector(state: Mapping[str, Any],
                      prefix: str = PROJECTOR_PREFIX, dtype=torch.float32,
                      device=None) -> Dict[str, Any]:
    """Any projector variant (multimodal_projector/builder.py:32-65,
    pooler_projector.py): ``linear`` is a bare Linear (``weight`` /
    ``bias``); ``mlpNx_gelu`` a Sequential with Linears at even indices;
    ``mlpNx_resMx_gelu`` appends SimpleResBlocks (``{i}.pre_norm.*``,
    ``{i}.proj.{0,2}.*``); the pooler has ``conv_pool.*`` and
    ``proj.1.*``."""
    r = _Reader(state, prefix, resolve_device(device), dtype)
    if r.has("conv_pool.weight"):
        cw = r.raw("conv_pool.weight").to(dtype)        # (Cout, Cin, 2, 2)
        return {"conv_w": cw.permute(2, 3, 1, 0).reshape(-1, cw.shape[0])
                .contiguous(),
                "conv_b": r.vec("conv_pool.bias"),
                "w1": r.lin("proj.1.weight"), "b1": r.vec("proj.1.bias")}
    if r.has("weight"):
        return {"w1": r.lin("weight"), "b1": r.vec("bias")}
    indices = sorted({int(k[len(prefix):].split(".")[0]) for k in state
                      if k.startswith(prefix)
                      and k[len(prefix):].split(".")[0].isdigit()})
    out: Dict[str, Any] = {}
    res = []
    for i in indices:
        if r.has(f"{i}.pre_norm.weight"):
            res.append({"ln_s": r.vec(f"{i}.pre_norm.weight"),
                        "ln_b": r.vec(f"{i}.pre_norm.bias"),
                        "w1": r.lin(f"{i}.proj.0.weight"),
                        "b1": r.vec(f"{i}.proj.0.bias"),
                        "w2": r.lin(f"{i}.proj.2.weight"),
                        "b2": r.vec(f"{i}.proj.2.bias")})
        else:
            n = len(out) // 2 + 1
            out[f"w{n}"] = r.lin(f"{i}.weight")
            out[f"b{n}"] = r.vec(f"{i}.bias")
    if res:
        out["res"] = res
    return out


def convert_resampler(state: Mapping[str, Any], resampler_type: str,
                      prefix: str = "model.vision_resampler.",
                      dtype=torch.float32, device=None) -> Dict[str, Any]:
    """The reference's resampler state dicts (multimodal_resampler/:
    spatial_pool.py, perceiver.py, qformer.py) -> ``models/resampler.py``
    trees on ``device`` (default: the card); ``masked_drop`` and the
    average / max pools have no parameters."""
    r = _Reader(state, prefix, resolve_device(device), dtype)
    A, T = r.vec, r.lin
    if resampler_type == "masked_drop":
        return {}
    if resampler_type == "spatial_pool":
        if not r.has("pool.weight"):
            return {}
        cw = r.raw("pool.weight").to(dtype)        # (Cout, Cin, s, s)
        return {"conv_w": cw.permute(2, 3, 1, 0).reshape(-1, cw.shape[0])
                .contiguous(), "conv_b": A("pool.bias")}
    if resampler_type == "perceiver":
        layers = []
        while r.has(f"perceiver.layers.{len(layers)}.0.to_q.weight"):
            lp = f"perceiver.layers.{len(layers)}."
            layers.append({
                "attn": {"ln_media_s": A(lp + "0.norm_media.weight"),
                         "ln_media_b": A(lp + "0.norm_media.bias"),
                         "ln_latents_s": A(lp + "0.norm_latents.weight"),
                         "ln_latents_b": A(lp + "0.norm_latents.bias"),
                         "to_q": T(lp + "0.to_q.weight"),
                         "to_kv": T(lp + "0.to_kv.weight"),
                         "to_out": T(lp + "0.to_out.weight")},
                # FeedForward = Sequential(LN, Linear, GELU, Linear)
                "ff": {"ln_s": A(lp + "1.0.weight"),
                       "ln_b": A(lp + "1.0.bias"),
                       "w1": T(lp + "1.1.weight"), "w2": T(lp + "1.3.weight")},
            })
        return {"latents": A("perceiver.latents"), "layers": layers,
                "norm_s": A("perceiver.norm.weight"),
                "norm_b": A("perceiver.norm.bias")}
    if resampler_type == "qformer":
        def attn(ap):
            return {"wq": T(ap + "self.query.weight"),
                    "bq": A(ap + "self.query.bias"),
                    "wk": T(ap + "self.key.weight"),
                    "bk": A(ap + "self.key.bias"),
                    "wv": T(ap + "self.value.weight"),
                    "bv": A(ap + "self.value.bias"),
                    "wo": T(ap + "output.dense.weight"),
                    "bo": A(ap + "output.dense.bias"),
                    "ln_s": A(ap + "output.LayerNorm.weight"),
                    "ln_b": A(ap + "output.LayerNorm.bias")}

        layers = []
        while r.has(f"Qformer.bert.encoder.layer.{len(layers)}"
                    f".attention.self.query.weight"):
            lp = f"Qformer.bert.encoder.layer.{len(layers)}."
            layer = {"self": attn(lp + "attention."),
                     "ffn": {"w1": T(lp + "intermediate_query.dense.weight"),
                             "b1": A(lp + "intermediate_query.dense.bias"),
                             "w2": T(lp + "output_query.dense.weight"),
                             "b2": A(lp + "output_query.dense.bias"),
                             "ln_s": A(lp + "output_query.LayerNorm.weight"),
                             "ln_b": A(lp + "output_query.LayerNorm.bias")}}
            if r.has(lp + "crossattention.self.query.weight"):
                layer["cross"] = attn(lp + "crossattention.")
            layers.append(layer)
        return {"ln_vision_s": A("ln_vision.weight"),
                "ln_vision_b": A("ln_vision.bias"),
                "query_tokens": A("query_tokens")[0],   # (1, n, C) -> (n, C)
                "emb_ln_s": A("Qformer.bert.embeddings.LayerNorm.weight"),
                "emb_ln_b": A("Qformer.bert.embeddings.LayerNorm.bias"),
                "layers": layers}
    raise ValueError(f"Unknown resampler type: {resampler_type}")


def convert_llava_checkpoint(state: Mapping[str, Any], llm_cfg: LLMConfig,
                             vision_cfg: VisionConfig, dtype=torch.bfloat16,
                             ground_head: bool = False,
                             device=None) -> Dict[str, Any]:
    """A whole LLaVA-style checkpoint -> the port's model tree on
    ``device`` (default: the card) in ``dtype``: ``llm``, and where the
    checkpoint has them ``vision``, ``projector``, ``image_newline`` and
    (``ground_head``) the InfoNCE ground head. A pure-LLM checkpoint loads
    its ``llm`` alone (the reference builder's non-llava branch,
    builder.py:253-265). MPT's key layout (``transformer.wte``) reads
    through :func:`convert_mpt`."""
    dev = resolve_device(device)
    convert = convert_mpt if "transformer.wte.weight" in state \
        else convert_qwen2
    out: Dict[str, Any] = {"llm": convert(state, llm_cfg, dtype=dtype,
                                          device=dev)}
    if TOWER_PREFIX + "embeddings.patch_embedding.weight" in state:
        out["vision"] = convert_siglip(state, vision_cfg,
                                       prefix=TOWER_PREFIX, dtype=dtype,
                                       device=dev)
    if any(k.startswith(PROJECTOR_PREFIX) for k in state):
        out["projector"] = convert_projector(state, dtype=dtype, device=dev)
    r = _Reader(state, "", dev, dtype)
    if r.has("model.image_newline"):
        out["image_newline"] = r.vec("model.image_newline")
    if ground_head:
        def mlp(p):
            return {"w1": r.lin(p + "0.weight"), "b1": r.vec(p + "0.bias"),
                    "ln_scale": r.vec(p + "2.weight"),
                    "ln_bias": r.vec(p + "2.bias"),
                    "w2": r.lin(p + "3.weight"), "b2": r.vec(p + "3.bias")}

        out["ground_head"] = {"obj": mlp("ground_head_obj."),
                              "query": mlp("ground_head_query."),
                              "zero_target": r.vec("ground_head_zero_target")}
    return out


# ---------------------------------------------------------------------------
# the port -> HF
# ---------------------------------------------------------------------------

def _f32(x: torch.Tensor) -> torch.Tensor:
    return x.detach().to(torch.float32).contiguous().cpu()


def _f32_t(x: torch.Tensor) -> torch.Tensor:
    """(in, out) -> a contiguous (out, in) f32 host copy (the transpose
    runs where x lives)."""
    return x.detach().to(torch.float32).t().contiguous().cpu()


def export_llava_checkpoint(params: Mapping[str, Any], llm_cfg: LLMConfig,
                            model_cfg=None, path: Optional[str] = None,
                            extra_config: Optional[dict] = None
                            ) -> Dict[str, torch.Tensor]:
    """Inverse of :func:`convert_llava_checkpoint`: the port's tree -> an
    HF-layout state dict of contiguous f32 (out, in) CPU tensors (JAX
    ``export_llava_checkpoint``: the LLM, the tower, every projector
    variant, the newline and the InfoNCE ground head). With ``path`` it is
    written as ``model.safetensors`` and a ``config.json`` (the Qwen2
    fields and, given ``model_cfg``, the persisted 3D knobs). A tree with
    a MoE layer or MPT's ungated MLP raises a ValueError before anything
    is written: the layout holds the dense gated MLP only, and JAX's
    export fails on both (``weights.py:438-441``)."""
    llm = params["llm"]
    for i, layer in enumerate(llm["layers"]):
        if "moe" in layer or "w_gate" not in layer.get("mlp", {}):
            raise ValueError(f"export_llava_checkpoint: layer {i} is not a "
                             f"dense gated MLP (a MoE or an MPT tree); the "
                             f"Qwen2 layout cannot hold it")
    state: Dict[str, torch.Tensor] = {}
    state["model.embed_tokens.weight"] = _f32(llm["embed_tokens"])
    state["model.norm.weight"] = _f32(llm["norm"])
    state["lm_head.weight"] = _f32_t(llm["lm_head"])
    for i, layer in enumerate(llm["layers"]):
        p = f"model.layers.{i}."
        state[p + "input_layernorm.weight"] = _f32(layer["input_layernorm"])
        state[p + "post_attention_layernorm.weight"] = _f32(
            layer["post_attention_layernorm"])
        a = layer["attn"]
        for name, key in (("q_proj", "wq"), ("k_proj", "wk"),
                          ("v_proj", "wv"), ("o_proj", "wo")):
            state[f"{p}self_attn.{name}.weight"] = _f32_t(a[key])
        if "bq" in a:
            for name, key in (("q_proj", "bq"), ("k_proj", "bk"),
                              ("v_proj", "bv")):
                state[f"{p}self_attn.{name}.bias"] = _f32(a[key])
        m = layer["mlp"]
        state[p + "mlp.gate_proj.weight"] = _f32_t(m["w_gate"])
        state[p + "mlp.up_proj.weight"] = _f32_t(m["w_up"])
        state[p + "mlp.down_proj.weight"] = _f32_t(m["w_down"])

    if "vision" in params:
        vp = params["vision"]
        conv = _f32(vp["patch_embed"]["w"])               # (3 ps ps, D)
        hidden = conv.shape[1]
        ps = int(round((conv.shape[0] // 3) ** 0.5))
        state[TOWER_PREFIX + "embeddings.patch_embedding.weight"] = \
            conv.t().contiguous().reshape(hidden, 3, ps, ps)
        state[TOWER_PREFIX + "embeddings.patch_embedding.bias"] = _f32(
            vp["patch_embed"]["b"])
        state[TOWER_PREFIX + "embeddings.position_embedding.weight"] = _f32(
            vp["pos_embed"])
        for i, layer in enumerate(vp["layers"]):
            p = f"{TOWER_PREFIX}encoder.layers.{i}."
            state[p + "layer_norm1.weight"] = _f32(layer["ln1"]["scale"])
            state[p + "layer_norm1.bias"] = _f32(layer["ln1"]["bias"])
            state[p + "layer_norm2.weight"] = _f32(layer["ln2"]["scale"])
            state[p + "layer_norm2.bias"] = _f32(layer["ln2"]["bias"])
            a = layer["attn"]
            for name, w, b in (("q_proj", "wq", "bq"), ("k_proj", "wk", "bk"),
                               ("v_proj", "wv", "bv"),
                               ("out_proj", "wo", "bo")):
                state[f"{p}self_attn.{name}.weight"] = _f32_t(a[w])
                state[f"{p}self_attn.{name}.bias"] = _f32(a[b])
            state[p + "mlp.fc1.weight"] = _f32_t(layer["mlp"]["w1"])
            state[p + "mlp.fc1.bias"] = _f32(layer["mlp"]["b1"])
            state[p + "mlp.fc2.weight"] = _f32_t(layer["mlp"]["w2"])
            state[p + "mlp.fc2.bias"] = _f32(layer["mlp"]["b2"])

    if "projector" in params:
        pj = params["projector"]
        pre = PROJECTOR_PREFIX
        if "conv_w" in pj:
            cw = _f32(pj["conv_w"])                       # (4 Cin, Cout)
            cout = cw.shape[1]
            state[pre + "conv_pool.weight"] = cw.reshape(2, 2, -1, cout) \
                .permute(3, 2, 0, 1).contiguous()
            state[pre + "conv_pool.bias"] = _f32(pj["conv_b"])
            state[pre + "proj.1.weight"] = _f32_t(pj["w1"])
            state[pre + "proj.1.bias"] = _f32(pj["b1"])
        else:
            n_linear = 0
            while f"w{n_linear + 1}" in pj:
                n_linear += 1
            if n_linear == 1 and "res" not in pj:
                state[pre + "weight"] = _f32_t(pj["w1"])
                state[pre + "bias"] = _f32(pj["b1"])
            else:
                for i in range(1, n_linear + 1):
                    state[f"{pre}{2 * (i - 1)}.weight"] = _f32_t(pj[f"w{i}"])
                    state[f"{pre}{2 * (i - 1)}.bias"] = _f32(pj[f"b{i}"])
                for j, blk in enumerate(pj.get("res", ())):
                    bp = f"{pre}{2 * n_linear - 1 + j}."
                    state[bp + "pre_norm.weight"] = _f32(blk["ln_s"])
                    state[bp + "pre_norm.bias"] = _f32(blk["ln_b"])
                    state[bp + "proj.0.weight"] = _f32_t(blk["w1"])
                    state[bp + "proj.0.bias"] = _f32(blk["b1"])
                    state[bp + "proj.2.weight"] = _f32_t(blk["w2"])
                    state[bp + "proj.2.bias"] = _f32(blk["b2"])
    if "image_newline" in params:
        state["model.image_newline"] = _f32(params["image_newline"])
    gh = params.get("ground_head")
    if gh is not None and "zero_target" in gh:
        state["ground_head_zero_target"] = _f32(gh["zero_target"])
        for name in ("obj", "query"):
            m = gh[name]
            state[f"ground_head_{name}.0.weight"] = _f32_t(m["w1"])
            state[f"ground_head_{name}.0.bias"] = _f32(m["b1"])
            state[f"ground_head_{name}.2.weight"] = _f32(m["ln_scale"])
            state[f"ground_head_{name}.2.bias"] = _f32(m["ln_bias"])
            state[f"ground_head_{name}.3.weight"] = _f32_t(m["w2"])
            state[f"ground_head_{name}.3.bias"] = _f32(m["b2"])

    if path is not None:
        os.makedirs(path, exist_ok=True)
        write_safetensors(state, os.path.join(path, "model.safetensors"))
        config = {
            "model_type": "qwen2",
            "vocab_size": llm_cfg.vocab_size,
            "hidden_size": llm_cfg.hidden_size,
            "intermediate_size": llm_cfg.intermediate_size,
            "num_hidden_layers": llm_cfg.num_hidden_layers,
            "num_attention_heads": llm_cfg.num_attention_heads,
            "num_key_value_heads": llm_cfg.num_key_value_heads,
            "head_dim": llm_cfg.head_dim,
            "max_position_embeddings": llm_cfg.max_position_embeddings,
            "rope_theta": llm_cfg.rope_theta,
            "rms_norm_eps": llm_cfg.rms_norm_eps,
            "tie_word_embeddings": llm_cfg.tie_word_embeddings,
        }
        if model_cfg is not None:
            w3d = model_cfg.world_3d
            parts = [w3d.pooling.value]
            if w3d.discrete:
                parts.append("discrete")
            if w3d.pos_embed.value != "none":
                parts.append(w3d.pos_embed.value)
            config.update({
                "world_position_embedding_type": "-".join(parts),
                "voxel_size": w3d.voxel.voxel_size,
                "min_xyz_range": list(w3d.voxel.min_xyz_range),
                "max_xyz_range": list(w3d.voxel.max_xyz_range),
                "object_feature_type": w3d.object_feature_type.value
                + ("-pe" if w3d.object_feature_use_pe else ""),
                "ground_head_type": model_cfg.ground_head.value,
                "ground_head_temperature": model_cfg.ground_head_temperature,
                "tokenizer_model_max_length":
                    model_cfg.tokenizer_model_max_length,
            })
        if extra_config:
            config.update(extra_config)
        with open(os.path.join(path, "config.json"), "w") as f:
            json.dump(config, f, indent=2)
    return state
