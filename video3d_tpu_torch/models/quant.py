"""Weight-only int8 quantization for serving, in PyTorch: counterpart of
``video3d_tpu/models/quant.py`` (the int8 dict form, ``quantize_tree`` with
bits 8 and ``act="none"``, and the ``matmul`` dispatch).

A quantized weight is the dict ``{"q": int8 (in, out), "scale": bf16
(1, out)}``, symmetric per output channel: w ~= q * scale. ``matmul``
dequantizes into the activation dtype and multiplies, as the JAX package
leaves it to XLA, except for the B=1 vocab head on the GPU, which streams
the int8 weight once through kernel B4 (``kernels/quant_matvec.py``).
"""

from __future__ import annotations

import re
from typing import Any, Tuple

import torch

# LLM projection matrices only: embeddings stay in the model dtype
# (gathers), norms are tiny. The JAX package's DEFAULT_PATTERNS.
DEFAULT_PATTERNS = (
    r"llm/layers/\d+/attn/w[qkvo]$",
    r"llm/layers/\d+/mlp/w_(gate|up|down)$",
    r"llm/lm_head$",
)

#: smallest output width the B=1 matvec kernel takes (the vocab head);
#: every other projection keeps the dequantize-then-matmul path
MATVEC_MIN_OUT = 32768

#: weight forms of the JAX package the port does not run yet -> the
#: ROADMAP item that ports them
_NOT_PORTED = {
    "Int4Weight": "int4 weights, ROADMAP B8 (the int4 serving slice)",
    "W8A8Weight": "w8a8 int8 activations, ROADMAP A3",
    "LoraAdapted": "LoRA-adapted weights, ROADMAP A9 (training)",
}


def check_ported(node) -> None:
    """Raise NotImplementedError for a JAX weight form the port lacks."""
    what = _NOT_PORTED.get(type(node).__name__)
    if what is not None:
        raise NotImplementedError(f"{type(node).__name__}: {what} is not "
                                  f"ported")


def quantize_weight(w: torch.Tensor) -> dict:
    """Symmetric per-output-channel int8 of an (in, out) matrix: the JAX
    arithmetic (absmax / 127 floored at 1e-12, round half to even, clip to
    +-127), computed in float32 on w's device."""
    w32 = w.to(torch.float32)
    absmax = w32.abs().amax(dim=0, keepdim=True)              # (1, out)
    scale = torch.clamp(absmax / 127.0, min=1e-12)
    q = torch.clamp(torch.round(w32 / scale), -127, 127).to(torch.int8)
    return {"q": q, "scale": scale.to(torch.bfloat16)}


def is_quantized(w) -> bool:
    return isinstance(w, dict) and "q" in w


def routes_to_matvec(x: torch.Tensor, q: torch.Tensor) -> bool:
    """Whether :func:`matmul` gives ``x @ q`` to kernel B4 on the GPU: one
    row (the B=1 vocab head) and at least MATVEC_MIN_OUT outputs, as the
    JAX package dispatches its TPU kernel."""
    return x.numel() == x.shape[-1] and q.shape[1] >= MATVEC_MIN_OUT


def matmul(x: torch.Tensor, w) -> torch.Tensor:
    """x @ w for a dense or an int8 dict weight. The int8 product rounds as
    the JAX package's does: ``(x @ q.to(x.dtype)) * scale.to(x.dtype)``;
    on a CUDA tensor with one row and at least MATVEC_MIN_OUT outputs it is
    kernel B4 instead (f32 sum, f32 scale, one rounding at the end)."""
    if isinstance(w, torch.Tensor):
        return x @ w
    if not is_quantized(w):
        check_ported(w)
        raise TypeError(f"matmul: unknown weight {type(w).__name__}")
    q, scale = w["q"], w["scale"]
    if x.device.type == "cuda" and routes_to_matvec(x, q):
        from video3d_tpu_torch.kernels.quant_matvec import int8_matmul

        return int8_matmul(x, q, scale)
    return (x @ q.to(x.dtype)) * scale.to(x.dtype)


def quantize_tree(params: Any, patterns: Tuple[str, ...] = DEFAULT_PATTERNS,
                  bits: int = 8, act: str = "none") -> Any:
    """Quantize the 2-D weights whose path ("llm/layers/3/attn/wq") matches
    one of ``patterns``; already quantized dicts pass through. Only the
    JAX package's default form is ported: bits 8, ``act="none"``."""
    if bits != 8:
        raise NotImplementedError(f"bits={bits}: {_NOT_PORTED['Int4Weight']}"
                                  f" is not ported")
    if act != "none":
        raise NotImplementedError(f"act={act!r}: {_NOT_PORTED['W8A8Weight']}"
                                  f" is not ported")

    def walk(tree, prefix=""):
        if isinstance(tree, dict):
            if is_quantized(tree):
                return tree
            return {k: walk(v, f"{prefix}/{k}" if prefix else k)
                    for k, v in tree.items()}
        if isinstance(tree, list):
            return [walk(v, f"{prefix}/{i}") for i, v in enumerate(tree)]
        if isinstance(tree, torch.Tensor) and tree.ndim == 2 and any(
                re.search(p, prefix) for p in patterns):
            return quantize_weight(tree)
        return tree

    return walk(params)


def quantization_error(params: Any, quantized: Any) -> float:
    """Max relative reconstruction error over quantized leaves."""
    errs = []

    def walk(a, b):
        if is_quantized(b) and not isinstance(a, dict):
            a32 = a.to(torch.float32)
            recon = b["q"].to(torch.float32) * b["scale"].to(torch.float32)
            denom = torch.clamp(a32.abs().max(), min=1e-9)
            errs.append(float((recon - a32).abs().max() / denom))
        elif isinstance(a, dict):
            for k in a:
                walk(a[k], b[k])
        elif isinstance(a, list):
            for x, y in zip(a, b):
                walk(x, y)

    walk(params, quantized)
    return max(errs) if errs else 0.0
