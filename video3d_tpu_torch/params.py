"""Parameters of the port: random init on the device, and conversion of the
JAX package's parameter tree.

The port keeps the JAX tree's nesting and layout: nested dicts and lists of
tensors, matrices stored (in, out) and applied as ``x @ w``. So a JAX tree
whose leaves are numpy arrays converts leaf by leaf, and both packages then
compute the same function (the parity tests rely on it).
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from video3d_tpu_torch.config import GroundHeadType, ModelConfig, PosEmbedType
from video3d_tpu_torch.models import llava_video3d as lv3d
from video3d_tpu_torch.models import quant, qwen2, siglip

Params = Dict[str, Any]

#: the subtrees of the JAX tree the answer path reads, and the grounding
#: head, which a tree has when its configuration has one (other optional
#: heads are left out)
_USED = ("vision", "projector", "image_newline", "llm")
_OPTIONAL = ("ground_head",)


def check_config(cfg: ModelConfig) -> None:
    """Raise for configuration features the port does not run yet."""
    llm = cfg.llm
    if (llm.moe is not None or llm.position_embedding != "rope"
            or llm.norm_type != "rmsnorm" or llm.hidden_act != "silu"
            or llm.embed_scale or llm.rms_norm_add_unit_offset
            or not llm.attention_bias or llm.tie_word_embeddings):
        raise NotImplementedError("only the Qwen2 decoder family is ported")
    if cfg.world_3d.pos_embed not in (PosEmbedType.SIN3D, PosEmbedType.NONE) \
            or cfg.world_3d.llava3d:
        raise NotImplementedError("only the sin3d world PE is ported")


def resolve_device(device=None) -> torch.device:
    """``device``, or the first CUDA card when it is None. The port's entry
    points run on the card unless the caller asks for the CPU
    (``device="cpu"``): without a CUDA card the default raises and never
    falls back to the CPU."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: the port runs on the card by "
                           "default; pass device='cpu' to run on the CPU")
    return torch.device("cuda", 0)


def _convert(node, device, dtype):
    if isinstance(node, dict):
        return {k: _convert(v, device, dtype) for k, v in node.items()}
    if isinstance(node, (list, tuple)):
        return [_convert(v, device, dtype) for v in node]
    if type(node).__name__ == "Int4Weight":
        # packed bytes and bf16 scales bit for bit (the kernels take bf16
        # scales, so ``dtype`` does not cast them)
        return quant.Int4Weight(_convert(node.q4, device, None),
                                _convert(node.scale4, device, None),
                                tuple(int(d) for d in node.dims),
                                int(node.group))
    quant.check_ported(node)
    a = np.array(node)                          # a writable copy
    if a.dtype.name == "bfloat16":
        # ml_dtypes' bfloat16, which torch.from_numpy rejects: carry the
        # bits across as uint16 and reinterpret them
        t = torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(a)
    if t.is_floating_point() and dtype is not None:
        t = t.to(dtype)
    return t.to(device)


def from_jax_params(tree: Params, cfg: ModelConfig, device=None,
                    dtype=None) -> Params:
    """The JAX ``llava_video3d.init_model`` tree (numpy leaves; JAX linears
    are (in, out) and used as ``x @ w``) -> the port's parameter dict on
    ``device`` (default: the first CUDA card, see :func:`resolve_device`).
    bf16 leaves carry across bit for bit, and so do the int8
    ``{"q", "scale"}`` dicts and the ``Int4Weight`` leaves of a
    ``quantize_tree``'d tree (bits 8 or 4). ``dtype`` casts floating leaves
    (None keeps theirs) except the int4 scales."""
    check_config(cfg)
    device = resolve_device(device)
    out = {k: _convert(tree[k], device, dtype) for k in _USED
           + tuple(k for k in _OPTIONAL if k in tree)}
    if len(out["vision"]["layers"]) != cfg.vision.num_hidden_layers \
            or len(out["llm"]["layers"]) != cfg.llm.num_hidden_layers:
        raise ValueError("layer counts of the tree and the config differ")
    return out


def init_model(cfg: ModelConfig, device, generator: torch.Generator,
               dtype=torch.bfloat16, bits: int = 16) -> Params:
    """Random init of the answer path's parameters, made directly on
    ``device`` from ``generator`` (a generator of that device). At full
    width that is ~8 B parameters, 16 GB in bf16: built on the host it would
    take minutes and ~30 GB of RAM.

    ``bits=8`` (``bits=4``) gives what ``quantize_tree`` makes of the same
    tree (int8 dicts or ``Int4Weight`` for the LLM projections and
    lm_head), quantizing each decoder layer right after its init, as the
    JAX ``builder.init_dummy_params`` does, so the full bf16 LLM never
    exists next to the quantized one. ``dtype=torch.float32``
    gives the f32 master tree that training updates. The grounding head
    (``cfg.ground_head`` other than NONE) is drawn last, from the same
    generator, and stays in ``dtype`` whatever ``bits`` (JAX's
    ``quantize_tree`` patterns touch only the LLM)."""
    check_config(cfg)
    params = {
        "vision": siglip.init_vision_tower(cfg.vision, device, generator,
                                           dtype),
        "projector": lv3d.init_projector(cfg.vision.hidden_size,
                                         cfg.llm.hidden_size, device,
                                         generator, dtype,
                                         cfg.projector.projector_type),
        "image_newline": torch.empty(cfg.llm.hidden_size, device=device,
                                     dtype=dtype).normal_(
                                         0.0, 0.02, generator=generator),
        "llm": qwen2.init_qwen2(cfg.llm, device, generator, dtype, bits),
    }
    if cfg.ground_head != GroundHeadType.NONE:
        params["ground_head"] = lv3d.init_ground_head(
            cfg.llm.hidden_size, device, generator, dtype, cfg.ground_head)
    return params
