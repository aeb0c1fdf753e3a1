"""Single-token decode attention over the stacked flat KV cache (kernel B3)
and its plain PyTorch version.

:func:`decode_attention` dispatches on the device of ``q``: a CPU tensor
runs :func:`decode_attention_plain` (slice the layer, split the heads, then
``mha_reference``); a CUDA tensor launches ``csrc/decode_attention.cu`` or
raises. Counterpart of ``video3d_tpu/kernels/decode_attention.py`` with the
stacked-cache input form (``kv_heads`` given), over a bf16 cache or an int8
one with per-position scales (the kernel's int8 instantiation).
"""

from __future__ import annotations

from typing import Optional

import torch

from video3d_tpu_torch.kernels import _build
from video3d_tpu_torch.kernels.attention import mha_reference

HEAD_DIM = 128      # the kernel's compiled head dim
CHUNK = 256         # cache positions per split-K block (csrc kChunk)
MAX_GROUP = 8       # query heads per kv head (csrc kMaxG)


def layer_kv(q: torch.Tensor, k_all: torch.Tensor, v_all: torch.Tensor,
             layer: int, kv_heads: int,
             k_scale: Optional[torch.Tensor] = None,
             v_scale: Optional[torch.Tensor] = None):
    """Head-split (B, S, KV, hd) K and V of ``layer`` of the stacked flat
    cache in q's dtype; an int8 cache is dequantized with its stacked
    (layers, B, S, KV, 1) scales in q's dtype, as the JAX package's plain
    path does (``video3d_tpu/kernels/attention.py:217-220``)."""
    B, hd = q.shape[0], q.shape[-1]
    S = k_all.shape[2]
    kl = k_all[layer].reshape(B, S, kv_heads, hd).to(q.dtype)
    vl = v_all[layer].reshape(B, S, kv_heads, hd).to(q.dtype)
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
                v_scale: Optional[torch.Tensor], kv_heads: int) -> bool:
    """Raise unless q is bf16 and the stacked cache is bf16 without scales
    or int8 with (layers, B, S, KV, 1) f32 scales, all contiguous, 16-byte
    aligned and on q's device. Returns whether the cache is int8."""
    quantized = k_all.dtype == torch.int8
    tensors = [("q", q, torch.bfloat16), ("k_all", k_all, k_all.dtype),
               ("v_all", v_all, k_all.dtype)]
    if quantized:
        if k_scale is None or v_scale is None or \
                k_scale.shape != (*k_all.shape[:3], kv_heads, 1) or \
                v_scale.shape != k_scale.shape:
            raise ValueError(f"{name}: an int8 cache needs (layers, B, S, "
                             f"KV, 1) scales")
        tensors += [("k_scale", k_scale, torch.float32),
                    ("v_scale", v_scale, torch.float32)]
    elif k_all.dtype != torch.bfloat16 or k_scale is not None:
        raise ValueError(f"{name}: the cache must be bf16 without scales or "
                         f"int8 with scales")
    for arg, t, dt in tensors:
        if t.dtype != dt or not t.is_contiguous() or t.device != q.device \
                or t.data_ptr() % 16:
            raise ValueError(f"{name}: {arg} must be a contiguous, 16-byte "
                             f"aligned {dt} tensor on {q.device}")
    return quantized


def decode_attention(q: torch.Tensor, k_all: torch.Tensor,
                     v_all: torch.Tensor, kv_len: torch.Tensor,
                     layer: int, kv_heads: int,
                     k_scale: Optional[torch.Tensor] = None,
                     v_scale: Optional[torch.Tensor] = None) -> torch.Tensor:
    """q (B, 1, H, hd); k_all/v_all the stacked (layers, B, S, KV*hd) cache,
    bf16, or int8 with the stacked (layers, B, S, KV, 1) f32 scales
    ``k_scale``/``v_scale``; kv_len (B,) valid slots of each row (the new
    token sits at kv_len - 1). Returns (B, 1, H, hd) in q's dtype."""
    if q.device.type == "cpu":
        return decode_attention_plain(q, k_all, v_all, kv_len, layer,
                                      kv_heads, k_scale, v_scale)
    if q.device.type != "cuda":
        raise ValueError(f"decode_attention: no kernel for device {q.device}")
    B, L, H, hd = q.shape
    NL, Bc, S, C = k_all.shape
    quantized = check_cache("decode_attention", q, k_all, v_all, k_scale,
                            v_scale, kv_heads)
    if (L != 1 or hd != HEAD_DIM or Bc != B or C != kv_heads * hd
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
    lib = _build.library()
    scales = (k_scale.data_ptr(), v_scale.data_ptr()) if quantized else ()
    entry = lib.v3d_decode_attention_int8 if quantized \
        else lib.v3d_decode_attention
    err = entry(
        q.data_ptr(), k_all.data_ptr(), v_all.data_ptr(), *scales,
        kv_len.data_ptr(), out.data_ptr(), part_m.data_ptr(),
        part_l.data_ptr(), part_acc.data_ptr(), layer, B, S, H, kv_heads,
        n_chunks, float(hd ** -0.5),
        torch.cuda.current_stream(q.device).cuda_stream)
    name = "decode_attention_int8" if quantized else "decode_attention"
    _build.check(err, name)
    _build.count_launch(name)
    return out
