"""Attention entry points of the port (counterpart of
``video3d_tpu/kernels/attention.py``, prefill and stacked-decode forms).

Semantics, as in the JAX package: GQA broadcasts each kv head to H // KV
query heads; softmax runs in float32 and the output keeps the query dtype;
with a KV cache, slot index == absolute position, so a query at position p
attends slots s <= p and s < kv_len.
"""

from __future__ import annotations

from typing import Optional

import torch

NEG_INF = -1e30


def mha_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  causal: bool = True,
                  q_positions: Optional[torch.Tensor] = None,
                  kv_len: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain attention: q (B, L, H, hd), k/v (B, S, KV, hd) -> (B, L, H, hd).

    ``q_positions`` (B, L) are absolute query positions (cache path);
    ``kv_len`` (B,) counts the valid key slots. Without ``q_positions`` a
    causal mask aligns the last query with the last key.
    """
    B, L, H, hd = q.shape
    S, KV = k.shape[1], k.shape[2]
    k = k.repeat_interleave(H // KV, dim=2)
    v = v.repeat_interleave(H // KV, dim=2)
    scores = torch.einsum("blhd,bshd->bhls", q, k).to(torch.float32) \
        * (hd ** -0.5)
    slots = torch.arange(S, device=q.device)[None, None, :]
    allow = torch.ones((B, L, S), dtype=torch.bool, device=q.device)
    if q_positions is not None:
        allow = slots <= q_positions[:, :, None]
    elif causal:
        rows = torch.arange(L, device=q.device)[None, :, None] + (S - L)
        allow = (slots <= rows).expand(B, L, S)
    if kv_len is not None:
        allow = allow & (slots < kv_len[:, None, None])
    scores = torch.where(allow[:, None], scores,
                         torch.tensor(NEG_INF, dtype=torch.float32,
                                      device=q.device))
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    return torch.einsum("bhls,bshd->blhd", probs, v)


def mha(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
        kv_len: torch.Tensor) -> torch.Tensor:
    """Causal prefill attention over the chunk's own K/V (L == S, right
    padding: keys >= kv_len[b] masked). Runs the flash kernel (B2) on the
    GPU and its plain version on the CPU."""
    from video3d_tpu_torch.kernels.flash_attention import flash_attention

    return flash_attention(q, k, v, lengths=kv_len, causal=True)


def mha_cached_stacked(q: torch.Tensor, k_all: torch.Tensor,
                       v_all: torch.Tensor, layer: int, kv_heads: int,
                       q_positions: torch.Tensor,
                       kv_len: torch.Tensor) -> torch.Tensor:
    """One-token attention for ``layer`` of the stacked flat
    (layers, B, S, KV*hd) cache: decode kernel (B3) on the GPU. A slot is
    valid below ``min(q_position + 1, kv_len)``."""
    if q.shape[1] != 1:
        raise NotImplementedError("cached multi-token attention is not ported")
    from video3d_tpu_torch.kernels.decode_attention import decode_attention

    eff_len = torch.minimum(q_positions[:, 0] + 1, kv_len)
    return decode_attention(q, k_all, v_all, eff_len, layer=layer,
                            kv_heads=kv_heads)
