"""Single-token decode attention over the stacked flat KV cache (kernel B3)
and its plain PyTorch version.

:func:`decode_attention` dispatches on the device of ``q``: a CPU tensor
runs :func:`decode_attention_plain` (slice the layer, split the heads, then
``mha_reference``); a CUDA tensor launches ``csrc/decode_attention.cu`` or
raises. Counterpart of ``video3d_tpu/kernels/decode_attention.py`` with the
stacked-cache input form (``kv_heads`` given), bf16 cache, no scales.
"""

from __future__ import annotations

import torch

from video3d_tpu_torch.kernels import _build
from video3d_tpu_torch.kernels.attention import mha_reference

HEAD_DIM = 128      # the kernel's compiled head dim
CHUNK = 256         # cache positions per split-K block (csrc kChunk)
MAX_GROUP = 8       # query heads per kv head (csrc kMaxG)


def decode_attention_plain(q: torch.Tensor, k_all: torch.Tensor,
                           v_all: torch.Tensor, kv_len: torch.Tensor,
                           layer: int, kv_heads: int) -> torch.Tensor:
    B, _, H, hd = q.shape
    S = k_all.shape[2]
    kl = k_all[layer].reshape(B, S, kv_heads, hd).to(q.dtype)
    vl = v_all[layer].reshape(B, S, kv_heads, hd).to(q.dtype)
    return mha_reference(q, kl, vl, q_positions=(kv_len - 1)[:, None],
                         kv_len=kv_len)


def decode_attention(q: torch.Tensor, k_all: torch.Tensor,
                     v_all: torch.Tensor, kv_len: torch.Tensor,
                     layer: int, kv_heads: int) -> torch.Tensor:
    """q (B, 1, H, hd); k_all/v_all the stacked (layers, B, S, KV*hd) cache;
    kv_len (B,) valid slots of each row (the new token sits at kv_len - 1).
    Returns (B, 1, H, hd) in q's dtype."""
    if q.device.type == "cpu":
        return decode_attention_plain(q, k_all, v_all, kv_len, layer,
                                      kv_heads)
    if q.device.type != "cuda":
        raise ValueError(f"decode_attention: no kernel for device {q.device}")
    B, L, H, hd = q.shape
    NL, Bc, S, C = k_all.shape
    for name, t in (("q", q), ("k_all", k_all), ("v_all", v_all)):
        if t.dtype != torch.bfloat16 or not t.is_contiguous() \
                or t.device != q.device or t.data_ptr() % 16:
            raise ValueError(f"decode_attention: {name} must be a contiguous, "
                             f"16-byte aligned bf16 tensor on {q.device}")
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
    err = _build.library().v3d_decode_attention(
        q.data_ptr(), k_all.data_ptr(), v_all.data_ptr(), kv_len.data_ptr(),
        out.data_ptr(), part_m.data_ptr(), part_l.data_ptr(),
        part_acc.data_ptr(), layer, B, S, H, kv_heads, n_chunks,
        float(hd ** -0.5), torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(err, "decode_attention")
    _build.count_launch("decode_attention")
    return out
