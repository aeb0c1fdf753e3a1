"""LoRA adapters over the parameter tree: counterpart of
``video3d_tpu/train/lora.py`` (the reference's lora_enable branch,
train_3d.py:1588-1657; its split save, llava_trainer.py:560-578; its merge,
model/builder.py:54-117).

An adapter tree parallels the parameters: ``{"A": (in, r), "B": (r, out)}``
at every adapted 2-D weight (the LLM's attention and MLP projections), None
elsewhere. The trainable tree of a LoRA fine-tune adds full copies of the
reference's non-LoRA trainables (projector, ground head, image_newline).
:func:`apply_lora` forms the weights a forward reads: a dense base merges
``w + (A @ B) * scale``; a quantized base is wrapped in a lazy
:class:`~video3d_tpu_torch.models.quant.LoraAdapted` (QLoRA).

The export is the trainer's ``<run>/model/params.pt`` (the trainable tree in
bf16, ``checkpoint.save_params_only``) beside ``<run>/lora.json`` (r, alpha,
bits); :func:`load_lora_export` reads it back and :func:`maybe_merge_lora`
readies a base for serving it (the JAX CLI's ``--lora-path``).
"""

from __future__ import annotations

import dataclasses
import json
import os
import re
from typing import Any, Callable, Optional, Tuple

import torch

from video3d_tpu_torch.models import quant
from video3d_tpu_torch.train.checkpoint import PARAMS_FILE
from video3d_tpu_torch.train.optim import tree_leaves, tree_leaves_with_path

#: the run directory's record of the merge scale and the base's bits
LORA_FILE = "lora.json"


@dataclasses.dataclass(frozen=True)
class LoraConfig:
    r: int = 128
    alpha: int = 256
    # the reference's find_all_linear_names: the LLM's linear layers only
    # (train_3d.py:219-232 excludes mm_projector / vision_tower / resampler)
    target_patterns: Tuple[str, ...] = (
        r"llm/layers/\d+/attn/w[qkvo]$",
        r"llm/layers/\d+/mlp/w_(gate|up|down)$",
    )

    @property
    def scale(self) -> float:
        return self.alpha / self.r


def _match(path: str, cfg: LoraConfig) -> bool:
    return any(re.search(p, path) for p in cfg.target_patterns)


def _weight_shape(w) -> Optional[Tuple[int, int]]:
    """(in, out) of a dense 2-D or quantized weight leaf, else None."""
    if isinstance(w, quant.Int4Weight):
        return w.dims
    if isinstance(w, quant.W8A8Weight):
        return tuple(w.q.shape)
    if isinstance(w, dict) and "q" in w:
        return tuple(w["q"].shape)
    if isinstance(w, torch.Tensor) and w.ndim == 2:
        return tuple(w.shape)
    return None


def _is_adapter(x) -> bool:
    return isinstance(x, dict) and set(x) == {"A", "B"}


def _is_leaf(x) -> bool:
    """Where a walk stops in a tree that mixes adapters with (possibly
    quantized) weights: None, an adapter, and every quantized form, so no
    walk pairs their insides with another tree's."""
    return (x is None or isinstance(x, (quant.Int4Weight, quant.W8A8Weight,
                                        quant.LoraAdapted))
            or _is_adapter(x) or (isinstance(x, dict) and "q" in x))


def _map_with_path(fn: Callable, tree, prefix: str = ""):
    if isinstance(tree, dict) and not _is_leaf(tree):
        return {k: _map_with_path(fn, v, f"{prefix}/{k}" if prefix else k)
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_map_with_path(fn, v, f"{prefix}/{i}")
                for i, v in enumerate(tree)]
    return fn(prefix, tree)


def _map_pair(fn: Callable, params, lora):
    """``fn(w, ad)`` at every leaf ``w`` of ``params`` with the subtree
    ``ad`` of ``lora`` at the same position (``jax.tree.map(fn, params,
    lora, is_leaf=...)``); a None in ``lora`` keeps the whole subtree of
    ``params`` unchanged."""
    if lora is None:
        return params
    if isinstance(params, dict) and not _is_leaf(params):
        return {k: _map_pair(fn, v, lora[k]) for k, v in params.items()}
    if isinstance(params, (list, tuple)):
        return [_map_pair(fn, v, a) for v, a in zip(params, lora)]
    return fn(params, lora)


def _adapters(params, cfg: LoraConfig, make: Callable):
    """``make(w, (in, out))`` at the adapted weights, None elsewhere."""

    def leaf(path, w):
        shape = _weight_shape(w)
        if shape is not None and _match(path, cfg):
            return make(w, shape)
        return None

    return _map_with_path(leaf, params)


def _device(w) -> torch.device:
    if isinstance(w, quant.Int4Weight):
        return w.q4.device
    if isinstance(w, quant.W8A8Weight):
        return w.q.device
    return (w["q"] if isinstance(w, dict) else w).device


def init_lora(generator: torch.Generator, params, cfg: LoraConfig,
              dtype=torch.float32):
    """Adapter tree: ``{"A", "B"}`` at the adapted weights, None elsewhere.
    A ~ N(0, 0.02) drawn from ``generator`` (a generator of the weights'
    device) in tree order, B = 0, so the initial delta is zero (as in
    PEFT). Dense and quantized bases alike (QLoRA inits against the int8 /
    int4 base)."""

    def make(w, shape):
        din, dout = shape
        dev = _device(w)
        return {"A": torch.empty(din, cfg.r, dtype=dtype, device=dev)
                .normal_(0.0, 0.02, generator=generator),
                "B": torch.zeros(cfg.r, dout, dtype=dtype, device=dev)}

    return _adapters(params, cfg, make)


def apply_lora(params, lora, cfg: LoraConfig):
    """The weights a forward reads: ``w + (A @ B) * scale`` at dense
    adapted leaves (the delta in the factors' dtype, then cast to w's),
    a lazy ``LoraAdapted`` at quantized ones (the QLoRA forward), a full
    trainable's copy in place of its base leaf. Gradients reach the
    adapters and the copies only."""

    def merge(w, ad):
        if not _is_adapter(ad):
            # a full trainable override (the reference's non-LoRA
            # trainables, non_lora_trainables.bin)
            return ad
        if quant.is_quantized(w):
            return quant.LoraAdapted(w, ad["A"], ad["B"], cfg.scale)
        delta = (ad["A"] @ ad["B"]) * cfg.scale
        return w + delta.to(w.dtype)

    return _map_pair(merge, params, lora)


# the reference keeps these trained beside the adapters and saves them as
# non_lora_trainables.bin (train_3d.py:1875-1884)
DEFAULT_EXTRA_TRAINABLE = ("projector", "world_pe_mlp", "ground_head",
                           "image_newline")


def _copy_floating(tree, dtype):
    """A copy of ``tree`` with its floating leaves in ``dtype`` (always a
    new tensor: the trainer updates its trainables in place)."""
    if isinstance(tree, dict):
        return {k: _copy_floating(v, dtype) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_copy_floating(v, dtype) for v in tree]
    if isinstance(tree, torch.Tensor):
        return tree.to(dtype if tree.is_floating_point() else tree.dtype,
                       copy=True)
    return tree


def init_lora_trainable(generator: torch.Generator, params, cfg: LoraConfig,
                        extra_prefixes: Tuple[str, ...] =
                        DEFAULT_EXTRA_TRAINABLE, dtype=torch.float32):
    """The trainable tree of a LoRA fine-tune: :func:`init_lora`'s
    adapters, full copies in ``dtype`` (the optimizer's master copy) of the
    subtrees named in ``extra_prefixes`` that ``params`` has, None
    elsewhere. :func:`apply_lora` puts it over the frozen base."""
    lora = init_lora(generator, params, cfg, dtype)
    if not isinstance(params, dict):
        return lora
    out = dict(lora)
    for name in extra_prefixes:
        if params.get(name) is not None:
            out[name] = _copy_floating(params[name], dtype)
    return out


def merge_lora_into_params(params, lora, cfg: LoraConfig):
    """A permanent merge for serving (model/builder.py:106-117): dense
    leaves get ``w + (A @ B) * scale`` (f32 delta), an int8 base is
    dequantized, the delta added, the sum rounded to bf16 and quantized
    again (within one quantization step of the lazy form); int4 bases
    raise (serve them through :func:`apply_lora`). Full trainables
    replace their leaves in the base's dtype."""

    def merge(w, ad):
        if not _is_adapter(ad):
            return ad.to(w.dtype) if isinstance(w, torch.Tensor) else ad
        if isinstance(w, (quant.Int4Weight, quant.W8A8Weight)):
            raise TypeError(
                "permanent merge into int4/w8a8 weights is unsupported; "
                "keep apply_lora's lazy form or merge into bf16 then "
                "requantize")
        delta = (ad["A"].to(torch.float32) @ ad["B"].to(torch.float32)) \
            * cfg.scale
        if isinstance(w, dict) and "q" in w:
            base = w["q"].to(torch.float32) * w["scale"].to(torch.float32)
            return quant.quantize_weight((base + delta).to(torch.bfloat16))
        return w + delta.to(w.dtype)

    return _map_pair(merge, params, lora)


def lora_size(lora) -> int:
    """Elements of every tensor of a trainable tree."""
    return sum(t.numel() for t in tree_leaves(lora))


def _shapes(tree):
    return [(p, tuple(t.shape)) for p, t in tree_leaves_with_path(tree)]


def load_lora_export(model_dir: str, base_params
                     ) -> Tuple[Any, LoraConfig, int]:
    """A trainer's LoRA / QLoRA export read back against ``base_params``:
    ``(trainable tree, LoraConfig, bits)``. ``model_dir`` is the run's
    ``model`` directory; ``lora.json`` beside it gives r, alpha and the
    bits the base was quantized to in training. Bits 8 / 4 mean the
    adapters compensate a base quantized so: quantize ``base_params`` to
    those bits before the call and keep the adapters lazy
    (:func:`apply_lora`), as :func:`maybe_merge_lora` does. The tree keeps
    its None positions and must have the paths and shapes
    :func:`init_lora_trainable` gives ``base_params`` (JAX restores into
    that structure), else ValueError. Its tensors go to the device of
    ``base_params``' first leaf."""
    run_dir = os.path.dirname(os.path.abspath(model_dir))
    with open(os.path.join(run_dir, LORA_FILE)) as f:
        meta = json.load(f)
    cfg = LoraConfig(r=meta["r"], alpha=meta["alpha"])
    bits = int(meta.get("bits", 16))
    leaf = tree_leaves(base_params)[0]
    device = _device(leaf)
    lora = torch.load(os.path.join(os.path.abspath(model_dir), PARAMS_FILE),
                      map_location=device, weights_only=True)
    meta_dev = torch.device("meta")
    want = _adapters(base_params, cfg, lambda w, s: {
        "A": torch.empty(s[0], cfg.r, device=meta_dev),
        "B": torch.empty(cfg.r, s[1], device=meta_dev)})
    for name in DEFAULT_EXTRA_TRAINABLE:
        if isinstance(base_params, dict) \
                and base_params.get(name) is not None:
            want[name] = base_params[name]
    if _shapes(lora) != _shapes(want):
        raise ValueError(f"{model_dir}: the export's tree does not fit the "
                         f"base (r={cfg.r})")
    return lora, cfg, bits


def maybe_merge_lora(params, lora_path: Optional[str]):
    """The serving side of an export (JAX ``cli._maybe_merge_lora``):
    ``params`` unchanged without a ``lora_path`` (the export's ``model``
    directory); else, per ``lora.json``'s bits, bits 8 / 4 quantize the
    base to those bits and keep the adapters lazy (``LoraAdapted`` leaves
    over the quantized projections, the forward the adapters were trained
    through; the full trainables cast to the base's dtype), bits 16 merges
    them into the weights (:func:`merge_lora_into_params`)."""
    if not lora_path:
        return params
    with open(os.path.join(os.path.dirname(os.path.abspath(lora_path)),
                           LORA_FILE)) as f:
        bits = int(json.load(f).get("bits", 16))
    if bits in (8, 4):
        params = quant.quantize_tree(params, bits=bits)
    lora, cfg, _ = load_lora_export(lora_path, params)
    if bits in (8, 4):
        def adapt(w, ad):
            # the full trainables in the base's dtype, as the merge does
            if not _is_adapter(ad) and isinstance(w, torch.Tensor):
                return ad.to(w.dtype)
            return apply_lora(w, ad, cfg)

        return _map_pair(adapt, params, lora)
    return merge_lora_into_params(params, lora, cfg)
