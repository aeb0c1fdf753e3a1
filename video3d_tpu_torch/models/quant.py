"""Weight quantization for serving, in PyTorch: counterpart of
``video3d_tpu/models/quant.py`` (the int8 dict form, the group-wise int4
form ``Int4Weight``, the w8a8 form ``W8A8Weight``, ``quantize_tree`` with
bits 8 or 4 and ``act`` "none" or "int8", the lazily LoRA-adapted form
``LoraAdapted``, and the ``matmul`` dispatch).

An int8 weight is the dict ``{"q": int8 (in, out), "scale": bf16 (1, out)}``,
symmetric per output channel: w ~= q * scale. An int4 weight is an
:class:`Int4Weight`: two input rows per byte, one bf16 scale per (group of
512 input rows, output column).

``matmul`` follows the JAX package's dispatch. On the CPU it runs the JAX
CPU arithmetic (int8: dequantize into x's dtype and multiply; int4: the f32
dequantized product). On the GPU, decode-sized products (at most
``KERNEL_MAX_ROWS`` rows of x) stream the quantized weight once through a
kernel (``kernels/quant_matvec.py``): int4 through B8, int8 through B4's
B>1 form, or B4's one-row matvec at the vocab head; larger products
(prefill, suffix chunks) dequantize into bf16 and run a dense matmul.
The kernels have no backward: a training product (more than
``KERNEL_MAX_ROWS`` rows) takes the differentiable dequantize path, and a
kernel given an input that requires grad raises.

A :class:`W8A8Weight` (``quantize_tree(act="int8")``) is the same int8
weight marked for dynamic int8 activations at every row count, as JAX
sends it to ``matmul_w8a8`` (never to B4): per-row activation scales
absmax / 127, an int8 x int8 product summed in int32, then both scales in
f32 (:func:`matmul_w8a8`). The product is ``torch._int_mm`` (JAX's is an
XLA ``dot_general``, not a Pallas kernel): on the card cuBLASLt's int8
GEMM, which takes more than 16 rows and inner and outer sizes that are
multiples of 8, so fewer rows (decode's 1-8) are zero-padded to
``W8A8_MIN_ROWS``; an inner or outer size off the multiple of 8 raises,
with no float fallback. The weight is kept output-major, the layout of
cuBLASLt's tensor-core int8 kernel. On the CPU it is the exact int32
product.

A :class:`LoraAdapted` weight (QLoRA, and serving a LoRA export over a
quantized base) is ``matmul(x, base) + ((x @ A) @ B) * scale``: the base
term keeps the routes above.
"""

from __future__ import annotations

import re
from typing import Any, Tuple

import torch
import torch.nn.functional as F

from video3d_tpu_torch.kernels import _build
from video3d_tpu_torch.kernels import quant_matvec as qm

# LLM projection matrices only: embeddings stay in the model dtype
# (gathers), norms are tiny. The JAX package's DEFAULT_PATTERNS.
DEFAULT_PATTERNS = (
    r"llm/layers/\d+/attn/w[qkvo]$",
    r"llm/layers/\d+/mlp/w_(gate|up|down)$",
    r"llm/lm_head$",
)

#: smallest output width the B=1 matvec kernel takes (the vocab head)
MATVEC_MIN_OUT = 32768
#: most rows of x the weight-streaming kernels take (JAX ``quant.py:207``);
#: more rows dequantize and run a dense matmul
KERNEL_MAX_ROWS = qm.MAX_ROWS

# The vision tower's projections (the JAX package's VISION_PATTERNS, for
# a w8a8 tower)
VISION_PATTERNS = (
    r"vision/layers/\d+/attn/w[qkvo]$",
    r"vision/layers/\d+/mlp/w[12]$",
)

#: rows a w8a8 product is zero-padded to on the card when it has fewer
#: (``torch._int_mm`` on CUDA takes more than 16)
W8A8_MIN_ROWS = 32
#: the launch-count name of the w8a8 product's ``torch._int_mm`` calls on
#: the card (a library call, counted beside the port's kernels)
W8A8_COUNT = "int_mm_w8a8"


class W8A8Weight:
    """An int8 (in, out) weight ``q`` with its bf16 (1, out) per-channel
    ``scale``, marked for dynamic int8 activations (JAX ``W8A8Weight``).
    ``q`` is stored output-major: the (in, out) view of a contiguous (out,
    in) tensor, the layout cuBLASLt's int8 tensor-core GEMM reads
    (``torch._int_mm`` of a row-major (in, out) weight takes a slower
    kernel, 5-9x at Qwen2-7B's shapes on an H100)."""

    def __init__(self, q: torch.Tensor, scale: torch.Tensor):
        if q.stride(0) != 1:
            q = q.t().contiguous().t()
        self.q = q
        self.scale = scale


class Int4Weight:
    """An int4-packed (in, out) weight, as the JAX ``Int4Weight``:
    ``q4`` int8 (in_p / 2, out_p), input row 2p in the low nibble of byte
    p and row 2p + 1 in its high nibble (two's complement, [-7, 7]);
    ``scale4`` bf16 (in_p / group, out_p); ``dims`` the unpadded (in,
    out); ``group`` input rows per scale."""

    def __init__(self, q4: torch.Tensor, scale4: torch.Tensor,
                 dims: Tuple[int, int], group: int):
        self.q4 = q4
        self.scale4 = scale4
        self.dims = tuple(dims)
        self.group = group


class LoraAdapted:
    """A frozen (possibly quantized) base weight with LoRA factors ``A``
    (in, r) and ``B`` (r, out), evaluated lazily by :func:`matmul` as
    ``matmul(x, base) + ((x @ A) @ B) * scale``, as the JAX
    ``LoraAdapted``: the base is never dequantized into a full-size matrix
    outside the product, and gradients reach x and the factors only.
    ``scale`` (alpha / r) is a Python float."""

    def __init__(self, base, A: torch.Tensor, B: torch.Tensor,
                 scale: float):
        self.base = base
        self.A = A
        self.B = B
        self.scale = float(scale)


def quantize_weight(w: torch.Tensor, act: str = "none"):
    """Symmetric per-output-channel int8 of an (in, out) matrix: the JAX
    arithmetic (absmax / 127 floored at 1e-12, round half to even, clip to
    +-127), computed in float32 on w's device. ``act="int8"`` gives a
    :class:`W8A8Weight`, else the ``{"q", "scale"}`` dict."""
    w32 = w.to(torch.float32)
    absmax = w32.abs().amax(dim=0, keepdim=True)              # (1, out)
    scale = torch.clamp(absmax / 127.0, min=1e-12)
    q = torch.clamp(torch.round(w32 / scale), -127, 127).to(torch.int8)
    if act == "int8":
        return W8A8Weight(q, scale.to(torch.bfloat16))
    return {"q": q, "scale": scale.to(torch.bfloat16)}


def _int_mm(xq: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """(rows, in) int8 @ (in, out) int8 -> (rows, out) int32, exact. On the
    card: ``torch._int_mm`` with the rows zero-padded to W8A8_MIN_ROWS
    when fewer; inner and outer sizes must be multiples of 8. ``q`` is
    best output-major (:class:`W8A8Weight`)."""
    if xq.device.type == "cpu":
        return torch._int_mm(xq, q)
    rows, in_ = xq.shape
    if in_ % 8 or q.shape[1] % 8:
        raise ValueError(f"w8a8 on the card: torch._int_mm takes inner and "
                         f"outer sizes that are multiples of 8, not "
                         f"{in_} x {q.shape[1]}")
    if rows < W8A8_MIN_ROWS:
        xq = F.pad(xq, (0, 0, 0, W8A8_MIN_ROWS - rows))
    _build.count_launch(W8A8_COUNT)
    return torch._int_mm(xq, q)[:rows]


def matmul_w8a8(x: torch.Tensor, q: torch.Tensor,
                scale: torch.Tensor) -> torch.Tensor:
    """Dynamic-activation int8 product (JAX ``matmul_w8a8``): per-row
    scales sx = max(absmax, 1e-12) / 127 of x in f32, x rounded half to
    even and clipped to +-127, an int8 x int8 product summed in int32
    (exact), then ``y32 * sx * scale`` in f32, cast to x's dtype."""
    x32 = x.to(torch.float32)
    # a tensor divisor: CUDA divides by a Python scalar as a multiply by
    # its reciprocal, one ulp off the CPU's (and JAX's) quotient, which
    # moves a rounded activation at a tie
    sx = torch.clamp(x32.abs().amax(dim=-1, keepdim=True), min=1e-12) \
        / torch.full((), 127.0, device=x.device)
    xq = torch.clamp(torch.round(x32 / sx), -127, 127).to(torch.int8)
    y32 = _int_mm(xq.reshape(-1, x.shape[-1]).contiguous(), q)
    y = y32.reshape(*x.shape[:-1], q.shape[1]).to(torch.float32) * sx \
        * scale.to(torch.float32)
    return y.to(x.dtype)


def quantize_weight_int4(w: torch.Tensor, group: int = 512) -> Int4Weight:
    """Group-wise symmetric int4 of an (in, out) matrix, bit for bit the
    JAX ``quantize_weight_int4``: input rows zero-padded to a multiple of
    ``group``; f32 absmax per (group, out) / 7 floored at 1e-12; round half
    to even, clip to +-7; two rows per byte; output columns zero-padded to
    a multiple of 2048 (out >= 8192) or 512; the scale stored in bf16
    after q is computed with the f32 scale."""
    in_, out = w.shape
    w32 = w.to(torch.float32)
    pad_in = (-in_) % group
    if pad_in:
        w32 = F.pad(w32, (0, 0, 0, pad_in))
    in_p = in_ + pad_in
    grouped = w32.reshape(in_p // group, group, out)
    scale = torch.clamp(grouped.abs().amax(dim=1) / 7.0, min=1e-12)
    q = torch.clamp(torch.round(grouped / scale[:, None, :]), -7, 7)
    q = q.reshape(in_p, out).to(torch.int8)
    packed = qm.pack_int4(q)                                 # (in_p/2, out)
    pad_out = (-out) % (2048 if out >= 8192 else 512)
    if pad_out:
        packed = F.pad(packed, (0, pad_out))
        scale = F.pad(scale, (0, pad_out))
    return Int4Weight(packed, scale.to(torch.bfloat16), (in_, out), group)


def is_quantized(w) -> bool:
    return isinstance(w, (Int4Weight, W8A8Weight)) \
        or (isinstance(w, dict) and "q" in w)


def _rows(x: torch.Tensor) -> int:
    return x.numel() // x.shape[-1]


def routes_to_matvec(x: torch.Tensor, q: torch.Tensor) -> bool:
    """Whether :func:`matmul` gives an int8 ``x @ q`` to kernel B4's
    one-row matvec on the GPU: one row (the B=1 vocab head) and at least
    MATVEC_MIN_OUT outputs, as the JAX package dispatches its TPU kernel."""
    return x.numel() == x.shape[-1] and q.shape[1] >= MATVEC_MIN_OUT


def dequantize_int4(q4: torch.Tensor, scale4: torch.Tensor, group: int,
                    dtype=torch.float32) -> torch.Tensor:
    """(in_p, out_p) ``unpack(q4) * repeat(scale4, group)`` in ``dtype``
    (each factor cast first, as the JAX package's dequantized products)."""
    return qm.unpack_int4(q4).to(dtype) * \
        scale4.to(dtype).repeat_interleave(group, dim=0)


def _matmul_int4(x: torch.Tensor, w: Int4Weight) -> torch.Tensor:
    """JAX ``quant.py:186-217``: x padded to the packed input width; the
    CPU runs the f32 dequantized product; on the GPU at most
    KERNEL_MAX_ROWS rows go to kernel B8, more rows dequantize into bf16
    (nibbles are exact in bf16) and run a dense matmul."""
    in_, out = w.dims
    in_p = w.q4.shape[0] * 2
    xp = F.pad(x, (0, in_p - in_)) if in_p != in_ else x
    if x.device.type == "cpu" or _rows(x) > KERNEL_MAX_ROWS:
        dt = torch.float32 if x.device.type == "cpu" else torch.bfloat16
        y = (xp.to(dt) @ dequantize_int4(w.q4, w.scale4, w.group, dt)) \
            .to(x.dtype)
    else:
        y = qm.int4_matmul(xp.contiguous(), w.q4, w.scale4, w.group)
    return y if y.shape[-1] == out else y[..., :out]


def matmul(x: torch.Tensor, w) -> torch.Tensor:
    """x @ w for a dense, an int8 dict, an :class:`Int4Weight`, a
    :class:`W8A8Weight` (:func:`matmul_w8a8` at every row count) or a
    :class:`LoraAdapted` weight (JAX ``quant.py:183-185``: the factors cast
    to x's dtype, the delta times the scale in x's dtype).

    int8 on the CPU and above KERNEL_MAX_ROWS rows rounds as the JAX
    package's product does: ``(x @ q.to(x.dtype)) * scale.to(x.dtype)``. On
    the GPU at most KERNEL_MAX_ROWS rows run kernel B4 instead (its one-row
    matvec at the vocab head, see :func:`routes_to_matvec`, else its B>1
    form): f32 sum, f32 scale, one rounding at the end."""
    if isinstance(w, torch.Tensor):
        return x @ w
    if isinstance(w, LoraAdapted):
        delta = (x @ w.A.to(x.dtype)) @ w.B.to(x.dtype)
        return matmul(x, w.base) + delta * w.scale
    if isinstance(w, Int4Weight):
        return _matmul_int4(x, w)
    if isinstance(w, W8A8Weight):
        return matmul_w8a8(x, w.q, w.scale)
    if not is_quantized(w):
        raise TypeError(f"matmul: unknown weight {type(w).__name__}")
    q, scale = w["q"], w["scale"]
    if x.device.type != "cpu" and _rows(x) <= KERNEL_MAX_ROWS:
        kernel = qm.int8_matvec if routes_to_matvec(x, q) else qm.int8_matmul
        return kernel(x.contiguous(), q, scale)
    return (x @ q.to(x.dtype)) * scale.to(x.dtype)


def quantize_tree(params: Any, patterns: Tuple[str, ...] = DEFAULT_PATTERNS,
                  bits: int = 8, act: str = "none") -> Any:
    """Quantize the 2-D weights whose path ("llm/layers/3/attn/wq") matches
    one of ``patterns`` to int8 dicts (bits 8), :class:`W8A8Weight` (bits
    8, ``act="int8"``) or :class:`Int4Weight` (bits 4); already quantized
    and :class:`LoraAdapted` weights pass through (JAX ``quant.py:257``)."""
    if bits not in (8, 4):
        raise ValueError(f"bits={bits}: expected 8 or 4")
    if act not in ("none", "int8") or (act == "int8" and bits != 8):
        raise ValueError(f"act={act!r} with bits={bits}: int8 activations "
                         f"take bits 8")

    def quantize(w):
        if bits == 4:
            return quantize_weight_int4(w)
        return quantize_weight(w, act)

    def walk(tree, prefix=""):
        if is_quantized(tree) or isinstance(tree, LoraAdapted):
            return tree
        if isinstance(tree, dict):
            return {k: walk(v, f"{prefix}/{k}" if prefix else k)
                    for k, v in tree.items()}
        if isinstance(tree, list):
            return [walk(v, f"{prefix}/{i}") for i, v in enumerate(tree)]
        if isinstance(tree, torch.Tensor) and tree.ndim == 2 and any(
                re.search(p, prefix) for p in patterns):
            return quantize(tree)
        return tree

    return walk(params)


def quantization_error(params: Any, quantized: Any) -> float:
    """Max relative reconstruction error over the int8 dict leaves (int4
    leaves are skipped, as in the JAX package)."""
    errs = []

    def walk(a, b):
        if isinstance(b, dict) and "q" in b and not isinstance(a, dict):
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
