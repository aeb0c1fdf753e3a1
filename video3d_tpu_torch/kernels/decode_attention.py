"""Single-token decode attention over the stacked flat KV cache (kernel B3)
and its plain PyTorch version.

:func:`decode_attention` dispatches on the device of ``q``: a CPU tensor
runs :func:`decode_attention_plain` (slice the layer, split the heads, then
``mha_reference``); a CUDA tensor launches ``csrc/decode_attention.cu`` or
raises. Counterpart of ``video3d_tpu/kernels/decode_attention.py`` with the
stacked-cache input form (``kv_heads`` given), over a bf16 cache, or an int8
or a packed int4 one with per-position scales (the kernel's int8 and int4
instantiations, counted as ``decode_attention_int8`` / ``_int4``).
"""

from __future__ import annotations

from typing import Optional

import torch

from video3d_tpu_torch.kernels import _build
from video3d_tpu_torch.kernels.attention import cache_values, mha_reference

HEAD_DIM = 128      # the kernel's compiled head dim
CHUNK = 256         # cache positions per split-K block (csrc kChunk)
MAX_GROUP = 8       # query heads per kv head (csrc kMaxG)
#: a cache's storage dtype -> the name suffix of its kernel instantiation
#: (int4 values are packed two per uint8 byte)
CACHE_FORMS = {torch.bfloat16: "", torch.int8: "_int8", torch.uint8: "_int4"}


def layer_kv(q: torch.Tensor, k_all: torch.Tensor, v_all: torch.Tensor,
             layer: int, kv_heads: int,
             k_scale: Optional[torch.Tensor] = None,
             v_scale: Optional[torch.Tensor] = None):
    """Head-split (B, S, KV, hd) K and V of ``layer`` of the stacked flat
    cache in q's dtype; a quantized cache (int8, or packed int4 unpacked
    first) is dequantized with its stacked (layers, B, S, KV, 1) scales in
    q's dtype, as the JAX package's plain path does
    (``video3d_tpu/kernels/attention.py:217-220``)."""
    B, hd = q.shape[0], q.shape[-1]
    S = k_all.shape[2]
    kl = cache_values(k_all[layer]).reshape(B, S, kv_heads, hd).to(q.dtype)
    vl = cache_values(v_all[layer]).reshape(B, S, kv_heads, hd).to(q.dtype)
    if k_scale is not None:
        kl = kl * k_scale[layer].to(q.dtype)
        vl = vl * v_scale[layer].to(q.dtype)
    return kl, vl


def decode_attention_plain(q: torch.Tensor, k_all: torch.Tensor,
                           v_all: torch.Tensor, kv_len: torch.Tensor,
                           layer: int, kv_heads: int,
                           k_scale: Optional[torch.Tensor] = None,
                           v_scale: Optional[torch.Tensor] = None
                           ) -> torch.Tensor:
    kl, vl = layer_kv(q, k_all, v_all, layer, kv_heads, k_scale, v_scale)
    return mha_reference(q, kl, vl, q_positions=(kv_len - 1)[:, None],
                         kv_len=kv_len)


def check_cache(name: str, q: torch.Tensor, k_all: torch.Tensor,
                v_all: torch.Tensor, k_scale: Optional[torch.Tensor],
                v_scale: Optional[torch.Tensor], kv_heads: int) -> str:
    """Raise unless q is bf16 and the stacked cache is bf16 without scales,
    or int8 or packed int4 (uint8) with (layers, B, S, KV, 1) f32 scales,
    all contiguous, 16-byte aligned and on q's device, and its rows are
    KV * hd values wide (KV * hd / 2 bytes packed). Returns the kernel's
    name suffix (:data:`CACHE_FORMS`)."""
    form = CACHE_FORMS.get(k_all.dtype)
    tensors = [("q", q, torch.bfloat16), ("k_all", k_all, k_all.dtype),
               ("v_all", v_all, k_all.dtype)]
    if form is None or (form == "") != (k_scale is None):
        raise ValueError(f"{name}: the cache must be bf16 without scales, "
                         f"or int8 or packed int4 (uint8) with scales")
    if form:
        if v_scale is None or \
                k_scale.shape != (*k_all.shape[:3], kv_heads, 1) or \
                v_scale.shape != k_scale.shape:
            raise ValueError(f"{name}: a quantized cache needs (layers, B, "
                             f"S, KV, 1) scales")
        tensors += [("k_scale", k_scale, torch.float32),
                    ("v_scale", v_scale, torch.float32)]
    width = kv_heads * q.shape[-1] // (2 if form == "_int4" else 1)
    if k_all.shape[-1] != width:
        raise ValueError(f"{name}: cache rows of {k_all.shape[-1]} entries "
                         f"for {kv_heads} kv heads of {q.shape[-1]} "
                         f"({k_all.dtype})")
    for arg, t, dt in tensors:
        if t.dtype != dt or not t.is_contiguous() or t.device != q.device \
                or t.data_ptr() % 16:
            raise ValueError(f"{name}: {arg} must be a contiguous, 16-byte "
                             f"aligned {dt} tensor on {q.device}")
    return form


def decode_attention(q: torch.Tensor, k_all: torch.Tensor,
                     v_all: torch.Tensor, kv_len: torch.Tensor,
                     layer: int, kv_heads: int,
                     k_scale: Optional[torch.Tensor] = None,
                     v_scale: Optional[torch.Tensor] = None) -> torch.Tensor:
    """q (B, 1, H, hd); k_all/v_all the stacked (layers, B, S, KV*hd) cache,
    bf16, or int8 (or packed int4: (layers, B, S, KV*hd / 2) uint8) with the
    stacked (layers, B, S, KV, 1) f32 scales ``k_scale``/``v_scale``;
    kv_len (B,) valid slots of each row (the new
    token sits at kv_len - 1). Returns (B, 1, H, hd) in q's dtype."""
    if q.device.type == "cpu":
        return decode_attention_plain(q, k_all, v_all, kv_len, layer,
                                      kv_heads, k_scale, v_scale)
    if q.device.type != "cuda":
        raise ValueError(f"decode_attention: no kernel for device {q.device}")
    B, L, H, hd = q.shape
    NL, Bc, S, _ = k_all.shape
    form = check_cache("decode_attention", q, k_all, v_all, k_scale,
                       v_scale, kv_heads)
    if (L != 1 or hd != HEAD_DIM or Bc != B
            or v_all.shape != k_all.shape or H % kv_heads
            or H // kv_heads > MAX_GROUP or not 0 <= layer < NL):
        raise ValueError(f"decode_attention: unsupported shapes q "
                         f"{tuple(q.shape)} cache {tuple(k_all.shape)} "
                         f"layer {layer} kv_heads {kv_heads}")
    kv_len = kv_len.to(device=q.device, dtype=torch.int32).contiguous()
    n_chunks = -(-S // CHUNK)
    part_m = torch.empty((B, H, n_chunks), dtype=torch.float32,
                         device=q.device)
    part_l = torch.empty_like(part_m)
    part_acc = torch.empty((B, H, n_chunks, hd), dtype=torch.float32,
                           device=q.device)
    out = torch.empty_like(q)
    name = "decode_attention" + form
    scales = (k_scale.data_ptr(), v_scale.data_ptr()) if form else ()
    err = getattr(_build.library(), "v3d_" + name)(
        q.data_ptr(), k_all.data_ptr(), v_all.data_ptr(), *scales,
        kv_len.data_ptr(), out.data_ptr(), part_m.data_ptr(),
        part_l.data_ptr(), part_acc.data_ptr(), layer, B, S, H, kv_heads,
        n_chunks, float(hd ** -0.5),
        torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(err, name)
    _build.count_launch(name)
    return out
