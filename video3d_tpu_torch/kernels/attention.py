"""Attention entry points of the port (counterpart of
``video3d_tpu/kernels/attention.py``: prefill, stacked-cache decode and
multi-token chunks, suffix-over-shared-prefix attention, and paged decode).

Semantics, as in the JAX package: GQA broadcasts each kv head to H // KV
query heads; softmax runs in float32 and the output keeps the query dtype;
with a KV cache, slot index == absolute position, so a query at position p
attends slots s <= p and s < kv_len.
"""

from __future__ import annotations

from typing import Optional

import torch

from video3d_tpu_torch.kernels.quant_matvec import unpack_int4

NEG_INF = -1e30


def cache_values(t: torch.Tensor) -> torch.Tensor:
    """A cache's stored values with one entry per channel: a packed int4
    cache (uint8, two channels per byte along the last dim) unpacked to
    int8 in [-7, 7]; any other cache as it is."""
    return unpack_int4(t, dim=-1) if t.dtype == torch.uint8 else t


def mha_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  causal: bool = True,
                  q_positions: Optional[torch.Tensor] = None,
                  kv_len: Optional[torch.Tensor] = None,
                  score_bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain attention: q (B, L, H, hd), k/v (B, S, KV, hd) -> (B, L, H, hd).

    ``q_positions`` (B, L) are absolute query positions (cache path);
    ``kv_len`` (B,) counts the valid key slots. Without ``q_positions`` a
    causal mask aligns the last query with the last key. ``score_bias``
    (H, S), a per-head key-position bias (MPT's ALiBi), is added to the
    scaled f32 scores before the mask.
    """
    B, L, H, hd = q.shape
    S, KV = k.shape[1], k.shape[2]
    k = k.repeat_interleave(H // KV, dim=2)
    v = v.repeat_interleave(H // KV, dim=2)
    scores = torch.einsum("blhd,bshd->bhls", q, k).to(torch.float32) \
        * (hd ** -0.5)
    if score_bias is not None:
        scores = scores + score_bias.to(torch.float32)[None, :, None, :]
    slots = torch.arange(S, device=q.device)[None, None, :]
    allow = torch.ones((B, L, S), dtype=torch.bool, device=q.device)
    if q_positions is not None:
        allow = slots <= q_positions[:, :, None]
    elif causal:
        rows = torch.arange(L, device=q.device)[None, :, None] + (S - L)
        allow = (slots <= rows).expand(B, L, S)
    if kv_len is not None:
        allow = allow & (slots < kv_len[:, None, None])
    # a Python scalar fill: no host-to-device copy, so a decode step on
    # this path (ALiBi) can be captured into a CUDA graph
    scores = scores.masked_fill(~allow[:, None], NEG_INF)
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    return torch.einsum("bhls,bshd->blhd", probs, v)


def mha(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
        kv_len: torch.Tensor,
        score_bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Causal prefill attention over the chunk's own K/V (L == S, right
    padding: keys >= kv_len[b] masked). Runs the flash kernel (B2) on the
    GPU and its plain version on the CPU; with a ``score_bias`` (ALiBi)
    the plain version on every device, as JAX (``attention.py:193``)."""
    if score_bias is not None:
        return mha_reference(q, k, v, causal=True, kv_len=kv_len,
                             score_bias=score_bias)
    from video3d_tpu_torch.kernels.flash_attention import flash_attention

    return flash_attention(q, k, v, lengths=kv_len, causal=True)


def mha_train(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              kv_len: torch.Tensor,
              score_bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """:func:`mha` with gradients, the training forward (no cache): the
    autograd Function of B2 with the logsumexp and B6 on the GPU, of their
    plain versions on the CPU; with a ``score_bias`` the plain attention,
    differentiated by autograd, on every device."""
    if score_bias is not None:
        return mha_reference(q, k, v, causal=True, kv_len=kv_len,
                             score_bias=score_bias)
    from video3d_tpu_torch.kernels.flash_attention import \
        flash_attention_train

    return flash_attention_train(q, k, v, lengths=kv_len, causal=True)


def mha_shared_prefix(q: torch.Tensor, pk: torch.Tensor, pv: torch.Tensor,
                      sk: torch.Tensor, sv: torch.Tensor,
                      suffix_lens: torch.Tensor,
                      pk_scale: Optional[torch.Tensor] = None,
                      pv_scale: Optional[torch.Tensor] = None,
                      score_bias: Optional[torch.Tensor] = None
                      ) -> torch.Tensor:
    """Suffix-over-SHARED-prefix attention (scene-grouped batched suffix
    prefill: every batch row attends the same scene prefix). Runs kernel B5
    on the GPU and :func:`mha_shared_prefix_reference` on the CPU.

    q (B, L, H, hd), query r of row b at absolute position P + r; pk/pv
    (P, KV, hd) with no batch dim, bf16, or int8 (or packed int4, (P, KV,
    hd / 2) uint8) with (P, KV, 1) f32 scales ``pk_scale``/``pv_scale``;
    sk/sv (B, L, KV, hd) the chunk's own K/V, at
    full precision whatever the prefix's type; suffix_lens (B,) valid suffix
    keys. Rows r >= suffix_lens[b] are undefined by contract. A
    ``score_bias`` (H, P + L) takes the plain version on every device
    (JAX asserts there is none).
    """
    if score_bias is not None:
        return mha_shared_prefix_reference(q, pk, pv, sk, sv, suffix_lens,
                                           pk_scale, pv_scale, score_bias)
    from video3d_tpu_torch.kernels.flash_attention import \
        flash_attention_shared_prefix

    return flash_attention_shared_prefix(q, pk, pv, sk, sv, suffix_lens,
                                         pk_scale, pv_scale)


def mha_shared_prefix_reference(q, pk, pv, sk, sv, suffix_lens,
                                pk_scale=None, pv_scale=None,
                                score_bias=None):
    """Oracle of :func:`mha_shared_prefix`: broadcast the prefix to every
    row (a quantized prefix, int4 unpacked first, dequantized with its
    scales in q's dtype, as the JAX oracle does), concatenate the suffix
    K/V, and run the plain cached path (q_positions = P + r, kv_len = P +
    suffix_lens)."""
    B, L = q.shape[0], q.shape[1]
    P = pk.shape[0]
    pk, pv = cache_values(pk).to(q.dtype), cache_values(pv).to(q.dtype)
    if pk_scale is not None:
        pk = pk * pk_scale.to(q.dtype)
        pv = pv * pv_scale.to(q.dtype)
    k = torch.cat([pk.expand(B, *pk.shape), sk.to(q.dtype)], 1)
    v = torch.cat([pv.expand(B, *pv.shape), sv.to(q.dtype)], 1)
    q_positions = (P + torch.arange(L, device=q.device))[None].expand(B, L)
    return mha_reference(q, k, v, q_positions=q_positions,
                         kv_len=P + suffix_lens.to(q.device),
                         score_bias=score_bias)


def mha_cached_stacked(q: torch.Tensor, k_all: torch.Tensor,
                       v_all: torch.Tensor, layer: int, kv_heads: int,
                       q_positions: torch.Tensor, kv_len: torch.Tensor,
                       k_scale: Optional[torch.Tensor] = None,
                       v_scale: Optional[torch.Tensor] = None,
                       score_bias: Optional[torch.Tensor] = None
                       ) -> torch.Tensor:
    """Cache attention for ``layer`` of the stacked flat (layers, B, S,
    KV*hd) cache: bf16, or int8 (or packed int4, KV*hd / 2 uint8 bytes per
    row) with the stacked (layers, B, S, KV, 1) f32 scales
    ``k_scale``/``v_scale`` (the kernels read the layer's scales by
    stride; the JAX function takes them already sliced). One token
    (L == 1): the decode kernel (B3), a slot valid below
    ``min(q_position + 1, kv_len)``. A multi-token chunk (L > 1) whose rows
    sit at contiguous positions ``q_positions[b, 0] + r``: the GQA-folded
    flash kernel (B2 folded), a slot valid when it is <= the query's
    position and < kv_len. The CPU takes each kernel's plain version. A
    ``score_bias`` (H, S) takes the plain attention over the layer's
    dequantized K/V on every device, as JAX (``attention.py:347``)."""
    if score_bias is not None:
        from video3d_tpu_torch.kernels.decode_attention import layer_kv

        kl, vl = layer_kv(q, k_all, v_all, layer, kv_heads, k_scale, v_scale)
        return mha_reference(q, kl, vl, q_positions=q_positions,
                             kv_len=kv_len, score_bias=score_bias)
    if q.shape[1] > 1:
        from video3d_tpu_torch.kernels.flash_attention import \
            flash_attention_gqa_folded

        return flash_attention_gqa_folded(q, k_all, v_all, kv_len,
                                          q_positions[:, 0], layer, kv_heads,
                                          k_scale, v_scale)
    from video3d_tpu_torch.kernels.decode_attention import decode_attention

    eff_len = torch.minimum(q_positions[:, 0] + 1, kv_len)
    return decode_attention(q, k_all, v_all, eff_len, layer=layer,
                            kv_heads=kv_heads, k_scale=k_scale,
                            v_scale=v_scale)



def paged_mha(q: torch.Tensor, k_pages: torch.Tensor, v_pages: torch.Tensor,
              page_table: torch.Tensor, kv_len: torch.Tensor, layer: int,
              k_scale: Optional[torch.Tensor] = None,
              v_scale: Optional[torch.Tensor] = None,
              score_bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Paged decode attention (L == 1) for ``layer`` of the stacked
    (layers, P, page, KV*hd) pools (packed int4: KV*hd / 2 uint8 bytes per
    row; quantized: (layers, P, KV, 1, page) scales), the dispatch of
    ``video3d_tpu/kernels/attention.py:372-415``: kernel B7 on the GPU and
    its plain version on the CPU. The kv head count is the scale pools'
    kv dim, or the flat last dim over q's head dim. A ``score_bias``
    (ALiBi) raises: the JAX package asserts there is none
    (``qwen2.py:268``)."""
    if score_bias is not None:
        raise ValueError("paged_mha: paged attention takes no score bias "
                         "(ALiBi)")
    from video3d_tpu_torch.kernels.paged_attention import \
        paged_decode_attention

    kv_heads = k_pages.shape[-1] // q.shape[-1] if k_scale is None \
        else k_scale.shape[2]
    return paged_decode_attention(q, k_pages, v_pages, page_table, kv_len,
                                  layer, kv_heads, k_scale, v_scale)
