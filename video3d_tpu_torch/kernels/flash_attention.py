"""Flash attention forward (kernel B2) and its plain PyTorch version.

:func:`flash_attention` dispatches on the device of ``q``: a CPU tensor runs
:func:`flash_attention_plain` (``mha_reference`` with causal + key-length
masking); a CUDA tensor launches ``csrc/flash_attention.cu`` or raises.
Counterpart of ``video3d_tpu/kernels/flash_attention.py::flash_attention``
in its prefill form (L == S, query offset 0, forward only).
"""

from __future__ import annotations

from typing import Optional

import torch

from video3d_tpu_torch.kernels import _build
from video3d_tpu_torch.kernels.attention import mha_reference

HEAD_DIM = 128   # the kernel's compiled head dim


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          lengths: Optional[torch.Tensor] = None,
                          causal: bool = True) -> torch.Tensor:
    return mha_reference(q, k, v, causal=causal, kv_len=lengths)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    lengths: Optional[torch.Tensor] = None,
                    causal: bool = True) -> torch.Tensor:
    """q (B, L, H, hd), k/v (B, L, KV, hd) -> (B, L, H, hd) in q's dtype.

    Keys at s >= lengths[b] are masked; query rows >= lengths[b] are finite
    garbage that callers ignore.
    """
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, lengths, causal)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: no kernel for device {q.device}")
    B, L, H, hd = q.shape
    S, KV = k.shape[1], k.shape[2]
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.dtype != torch.bfloat16 or not t.is_contiguous() \
                or t.device != q.device or t.data_ptr() % 16:
            raise ValueError(f"flash_attention: {name} must be a contiguous, "
                             f"16-byte aligned bf16 tensor on {q.device}")
    if hd != HEAD_DIM or v.shape != k.shape or k.shape[0] != B \
            or S != L or H % KV:
        raise ValueError(f"flash_attention: unsupported shapes q "
                         f"{tuple(q.shape)} k {tuple(k.shape)}")
    if lengths is None:
        lengths = torch.full((B,), S, dtype=torch.int32, device=q.device)
    lengths = lengths.to(device=q.device, dtype=torch.int32).contiguous()
    out = torch.empty_like(q)
    err = _build.library().v3d_flash_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), lengths.data_ptr(),
        out.data_ptr(), B, L, S, H, KV, int(causal), float(hd ** -0.5),
        torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(err, "flash_attention")
    _build.count_launch("flash_attention")
    return out
