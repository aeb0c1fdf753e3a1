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
from video3d_tpu_torch.ops.pos_embed import init_mlp_position_embedding
from video3d_tpu_torch.models import llava_video3d as lv3d
from video3d_tpu_torch.models import quant, qwen2, siglip

Params = Dict[str, Any]

#: the subtrees of the JAX tree the answer path reads, and the grounding
#: head, the MLP world PE and a resampler, which a tree has when its
#: configuration has them (other optional heads are left out)
_USED = ("vision", "projector", "image_newline", "llm")
_OPTIONAL = ("ground_head", "world_pe_mlp", "resampler")

#: head widths the card's attention kernels take on each path: the dense
#: answer path (B2, B2 folded, B3), B5's shared prefix and B7's pages, over
#: a bf16, an int8 or an int4 cache, at 128 and 256; B2 with the
#: logsumexp and B6 for training at 128 only (ROADMAP B, "hd-256 forms")
CARD_HEAD_DIMS = {"answer": (128, 256), "quantized_cache": (128, 256),
                  "shared_prefix": (128, 256), "paged": (128, 256),
                  "training": (128,)}


def check_config(cfg: ModelConfig) -> None:
    """Raise a ValueError for a decoder the JAX package cannot run either:
    one whose attention width (heads x head_dim) is not its hidden size
    (Gemma-7B's 16 x 256 against 3072), where JAX's reshape of the
    attention output fails (``qwen2.py:433``)."""
    llm = cfg.llm
    width = llm.num_attention_heads * llm.head_dim
    if width != llm.hidden_size:
        raise ValueError(f"attention width {llm.num_attention_heads} x "
                         f"{llm.head_dim} = {width} != hidden size "
                         f"{llm.hidden_size}: the JAX package cannot run "
                         f"this decoder (qwen2.py:433; ROADMAP C)")


def check_card_path(cfg: ModelConfig, device, path: str) -> None:
    """Raise a ValueError, before any work, where ``path`` (a key of
    :data:`CARD_HEAD_DIMS`) has no kernel form on the card for the
    decoder's head width, or (``"paged"``) where the decoder has an ALiBi
    bias, which JAX's paged decode asserts against (``qwen2.py:268``).
    The CPU runs every width through the plain versions."""
    llm = cfg.llm
    if path == "paged" and llm.position_embedding == "alibi":
        raise ValueError("paged attention takes no ALiBi bias (MPT): the "
                         "JAX package asserts (qwen2.py:268); use the dense "
                         "cache")
    if torch.device(device).type != "cuda":
        return
    if llm.head_dim not in CARD_HEAD_DIMS[path]:
        raise ValueError(f"head_dim {llm.head_dim} has no {path} kernel "
                         f"form on the card yet (ROADMAP B, hd-256 forms)")


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
    if node is None:
        return None          # an empty subtree (a LoRA trainable tree)
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
    if type(node).__name__ == "W8A8Weight":
        return quant.W8A8Weight(_convert(node.q, device, None),
                                _convert(node.scale, device, None))
    if type(node).__name__ == "LoraAdapted":
        return quant.LoraAdapted(_convert(node.base, device, dtype),
                                 _convert(node.A, device, dtype),
                                 _convert(node.B, device, dtype),
                                 float(node.scale))
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
    ``{"q", "scale"}`` dicts, the ``W8A8Weight`` and the ``Int4Weight``
    leaves of a ``quantize_tree``'d tree (bits 8, ``act`` "none" or
    "int8", or bits 4), and the ``LoraAdapted`` leaves of an
    ``apply_lora``'d one. The family's subtrees carry across as they are:
    ``moe`` layers, MPT's ungated ``mlp``, bias-less attention, and a
    ``resampler`` tree. ``dtype`` casts floating leaves (None keeps
    theirs) except the int4 and w8a8 scales."""
    check_config(cfg)
    device = resolve_device(device)
    out = {k: _convert(tree[k], device, dtype) for k in _USED
           + tuple(k for k in _OPTIONAL if k in tree)}
    if len(out["vision"]["layers"]) != cfg.vision.num_hidden_layers \
            or len(out["llm"]["layers"]) != cfg.llm.num_hidden_layers:
        raise ValueError("layer counts of the tree and the config differ")
    return out


def from_jax_tree(tree, device=None, dtype=None):
    """Any JAX parameter-shaped tree (numpy leaves) -> the same nesting of
    tensors on ``device``, leaf by leaf as :func:`from_jax_params`, with
    every None position kept: a LoRA trainable tree of the JAX package
    (``{"A", "B"}`` adapters, full copies of the extra trainables, None
    elsewhere) carries across whole."""
    return _convert(tree, resolve_device(device), dtype)


def init_model(cfg: ModelConfig, device, generator: torch.Generator,
               dtype=torch.bfloat16, bits: int = 16,
               act: str = "none") -> Params:
    """Random init of the answer path's parameters, made directly on
    ``device`` from ``generator`` (a generator of that device). At full
    width that is ~8 B parameters, 16 GB in bf16: built on the host it would
    take minutes and ~30 GB of RAM.

    ``bits=8`` (``bits=4``) gives what ``quantize_tree`` makes of the same
    tree (int8 dicts or ``Int4Weight`` for the LLM projections and
    lm_head; ``W8A8Weight`` with ``act="int8"``, JAX's ``--w8a8``), quantizing each decoder layer right after its init, as the
    JAX ``builder.init_dummy_params`` does, so the full bf16 LLM never
    exists next to the quantized one. ``dtype=torch.float32``
    gives the f32 master tree that training updates. The grounding head
    (``cfg.ground_head`` other than NONE) is drawn last, from the same
    generator, and stays in ``dtype`` whatever ``bits`` (JAX's
    ``quantize_tree`` patterns touch only the LLM); so do the MLP world
    PE's leaves (``pos_embed`` MLP), drawn after it."""
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
        "llm": qwen2.init_qwen2(cfg.llm, device, generator, dtype, bits,
                                act),
    }
    if cfg.ground_head != GroundHeadType.NONE:
        params["ground_head"] = lv3d.init_ground_head(
            cfg.llm.hidden_size, device, generator, dtype, cfg.ground_head)
    if cfg.world_3d.pos_embed == PosEmbedType.MLP:
        params["world_pe_mlp"] = init_mlp_position_embedding(
            cfg.llm.hidden_size, device, generator, dtype=dtype)
    return params
