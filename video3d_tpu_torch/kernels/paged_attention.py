"""Paged single-token decode attention over stacked page pools (kernel B7)
and its plain PyTorch version: counterpart of
``video3d_tpu/kernels/paged_attention.py``.

The pools are flat (layers, P, page, KV*hd), bf16, or int8 (or packed int4,
uint8 (layers, P, page, KV*hd / 2)) with f32 scale pools (layers, P, KV, 1,
page); slot b's position s lives in pool page
``page_table[b, s // page]``, row ``s % page``. The layer is an index into
the stacked pools: the kernel reads it by strides, and no per-layer copy is
made. :func:`paged_decode_attention` dispatches on the device of ``q``: a
CPU tensor runs :func:`paged_attention_plain`, a CUDA tensor launches
``csrc/paged_attention.cu`` or raises. The kernel is B3's
(``csrc/decode_sm90.cuh``) over the pools' page map, with B3's plan
(``decode_attention.decode_plan``, over maxp * page positions per slot):
one launch, only the output allocated, kv_len and the table read on the
device alone. At head width 256 every pool form launches
``csrc/attention_hd256.cu``'s paged form instead
(``kernels/attention_hd256.py``).

Not ported: ``RAGGED_GRID`` (:139-143) and the cumsum / searchsorted
live-page worklist with its ``lax.cond`` sizing (:198-281). They keep a
TPU's sequential grid short; the CUDA kernel gives each CTA an even share
of the slots' live positions laid end to end, which covers aliased tables
by construction. ``paged_attention_multi`` (:328, the speculative
verify's L-token block) is a plain gather and einsum in JAX, not a Pallas
kernel, and stays plain PyTorch here on every device.
"""

from __future__ import annotations

from typing import Optional

import torch

from video3d_tpu_torch.kernels import _build, _launch
from video3d_tpu_torch.kernels.attention import NEG_INF, cache_values
from video3d_tpu_torch.kernels.decode_attention import (CACHE_FORMS,
                                                        _stream, decode_plan,
                                                        split_args)

HEAD_DIM = 128      # the kernel's compiled head dim
MAX_GROUP = 8       # query heads per kv head (csrc kMaxG)


def _dense_from_pages(pool: torch.Tensor, spool: Optional[torch.Tensor],
                      page_table: torch.Tensor, kv_heads: int
                      ) -> torch.Tensor:
    """One layer's flat pool (P, page, KV*hd) (packed int4: KV*hd / 2
    bytes) and its (P, KV, 1, page) scales (or None) gathered into (B,
    maxp * page, KV, hd) f32 rows, as ``_dense_from_pages`` (:290)."""
    B, maxp = page_table.shape
    page = pool.shape[1]
    idx = page_table.long()
    g = cache_values(pool[idx]).reshape(B, maxp * page, kv_heads, -1).float()
    if spool is not None:
        s = spool[idx].permute(0, 1, 4, 2, 3)      # (B, maxp, page, KV, 1)
        g = g * s.reshape(B, maxp * page, kv_heads, 1)
    return g


def paged_attention_plain(q: torch.Tensor, k_pages: torch.Tensor,
                          v_pages: torch.Tensor, page_table: torch.Tensor,
                          kv_len: torch.Tensor, layer: int, kv_heads: int,
                          k_scale: Optional[torch.Tensor] = None,
                          v_scale: Optional[torch.Tensor] = None
                          ) -> torch.Tensor:
    """The oracle ``paged_attention_reference`` (:303) on ``layer`` of the
    stacked pools: gather each slot's pages densely, masked attention in
    f32 (keys at positions >= kv_len get -1e30, so their weight is exactly
    0), output in q's dtype. A slot with kv_len == 0 gets zeros, as the
    kernel entry writes them (:282-286)."""
    B, _, H, hd = q.shape
    G = H // kv_heads
    ks = None if k_scale is None else k_scale[layer]
    vs = None if v_scale is None else v_scale[layer]
    k = _dense_from_pages(k_pages[layer], ks, page_table, kv_heads)
    v = _dense_from_pages(v_pages[layer], vs, page_table, kv_heads)
    k, v = k.transpose(1, 2), v.transpose(1, 2)     # (B, KV, S, hd)
    qf = q[:, 0].float().reshape(B, kv_heads, G, hd) * hd ** -0.5
    s = torch.einsum("bkgd,bksd->bkgs", qf, k)
    lens = kv_len.to(q.device)[:, None, None, None]
    pos = torch.arange(k.shape[2], device=q.device)
    s = torch.where(pos < lens, s, torch.tensor(NEG_INF, device=q.device))
    o = torch.einsum("bkgs,bksd->bkgd", torch.softmax(s, dim=-1), v)
    o = torch.where(lens > 0, o, torch.zeros((), device=q.device))
    return o.reshape(B, 1, H, hd).to(q.dtype)


def paged_attention_multi(q: torch.Tensor, k_pages: torch.Tensor,
                          v_pages: torch.Tensor, page_table: torch.Tensor,
                          q_positions: torch.Tensor, layer: int,
                          k_scale: Optional[torch.Tensor] = None,
                          v_scale: Optional[torch.Tensor] = None
                          ) -> torch.Tensor:
    """Multi-query paged attention over ``layer`` of the stacked pools
    (:328-361): q (B, L, H, hd), query r of slot b at the global position
    ``q_positions[b, r]``, attending the slot's keys 0..q_positions[b, r]
    (the block was appended first, so that is the whole mask). Each slot's
    pages are gathered densely and dequantized (int8, or packed int4
    unpacked) in f32; the softmax runs in f32 and the output keeps q's
    dtype. The same gather-and-einsum on the card as on the CPU."""
    B, L, H, hd = q.shape
    kv_heads = k_scale.shape[2] if k_scale is not None \
        else k_pages.shape[-1] // hd
    G = H // kv_heads
    ks = None if k_scale is None else k_scale[layer]
    vs = None if v_scale is None else v_scale[layer]
    k = _dense_from_pages(k_pages[layer], ks, page_table, kv_heads)
    v = _dense_from_pages(v_pages[layer], vs, page_table, kv_heads)
    k, v = k.transpose(1, 2), v.transpose(1, 2)     # (B, KV, S, hd)
    qf = q.float().reshape(B, L, kv_heads, G, hd) * hd ** -0.5
    s = torch.einsum("blkgd,bksd->blkgs", qf, k)
    pos = torch.arange(k.shape[2], device=q.device)
    ok = pos <= q_positions.to(q.device)[:, :, None, None, None]
    s = torch.where(ok, s, torch.tensor(NEG_INF, device=q.device))
    o = torch.einsum("blkgs,bksd->blkgd", torch.softmax(s, dim=-1), v)
    return o.reshape(B, L, H, hd).to(q.dtype)


def check_pools(q: torch.Tensor, k_pages: torch.Tensor,
                v_pages: torch.Tensor, k_scale: Optional[torch.Tensor],
                v_scale: Optional[torch.Tensor], kv_heads: int) -> str:
    """Raise unless q is bf16 and the stacked pools are bf16 without
    scales, or int8 or packed int4 (uint8) with (layers, P, KV, 1, page)
    f32 scales, all contiguous, 16-byte aligned and on q's device, and
    their rows are KV * hd values wide (KV * hd / 2 bytes packed). Returns
    the kernel's name suffix (``decode_attention.CACHE_FORMS``)."""
    form = CACHE_FORMS.get(k_pages.dtype)
    tensors = [("q", q, torch.bfloat16), ("k_pages", k_pages, k_pages.dtype),
               ("v_pages", v_pages, k_pages.dtype)]
    if form is None or (form == "") != (k_scale is None):
        raise ValueError("paged_decode_attention: the pools must be bf16 "
                         "without scales, or int8 or packed int4 (uint8) "
                         "with scales")
    NL, P, page, C = k_pages.shape
    if form:
        if v_scale is None or \
                k_scale.shape != (NL, P, kv_heads, 1, page) or \
                v_scale.shape != k_scale.shape:
            raise ValueError("paged_decode_attention: quantized pools need "
                             "(layers, P, KV, 1, page) scales")
        tensors += [("k_scale", k_scale, torch.float32),
                    ("v_scale", v_scale, torch.float32)]
    if C != kv_heads * q.shape[-1] // (2 if form == "_int4" else 1):
        raise ValueError(f"paged_decode_attention: pool rows of {C} entries "
                         f"for {kv_heads} kv heads of {q.shape[-1]} "
                         f"({k_pages.dtype})")
    for arg, t, dt in tensors:
        if t.dtype != dt or not t.is_contiguous() or t.device != q.device \
                or t.data_ptr() % 16:
            raise ValueError(f"paged_decode_attention: {arg} must be a "
                             f"contiguous, 16-byte aligned {dt} tensor on "
                             f"{q.device}")
    return form


def paged_decode_attention(q: torch.Tensor, k_pages: torch.Tensor,
                           v_pages: torch.Tensor, page_table: torch.Tensor,
                           kv_len: torch.Tensor, layer: int, kv_heads: int,
                           k_scale: Optional[torch.Tensor] = None,
                           v_scale: Optional[torch.Tensor] = None
                           ) -> torch.Tensor:
    """q (B, 1, H, hd); k_pages/v_pages the stacked (layers, P, page,
    KV*hd) pools, bf16, or int8 (or packed int4: KV*hd / 2 uint8 bytes per
    row) with the stacked (layers, P, KV, 1, page) f32 scales; page_table
    (B, maxp) int32 page ids (entries past a slot's
    pages must lie in [0, P) and are never read); kv_len (B,) valid
    positions per slot after this step's append. Returns (B, 1, H, hd) in
    q's dtype (:146-287)."""
    if q.device.type == "cpu":
        return paged_attention_plain(q, k_pages, v_pages, page_table, kv_len,
                                     layer, kv_heads, k_scale, v_scale)
    if q.device.type != "cuda":
        raise ValueError(f"paged_decode_attention: no kernel for device "
                         f"{q.device}")
    B, L, H, hd = q.shape
    NL, P, page, _ = k_pages.shape
    form = check_pools(q, k_pages, v_pages, k_scale, v_scale, kv_heads)
    if hd == 256:
        from video3d_tpu_torch.kernels import attention_hd256

        return attention_hd256.paged_hd256(q, k_pages, v_pages, page_table,
                                           kv_len, layer, kv_heads, k_scale,
                                           v_scale)
    maxp = page_table.shape[1]
    if (L != 1 or hd != HEAD_DIM
            or v_pages.shape != k_pages.shape or H % kv_heads
            or H // kv_heads > MAX_GROUP or not 0 <= layer < NL
            or page_table.shape != (B, maxp) or maxp < 1
            or kv_len.shape != (B,)):
        raise ValueError(f"paged_decode_attention: unsupported shapes q "
                         f"{tuple(q.shape)} pools {tuple(k_pages.shape)} "
                         f"table {tuple(page_table.shape)} layer {layer} "
                         f"kv_heads {kv_heads}")
    table = page_table.to(device=q.device, dtype=torch.int32).contiguous()
    kv_len = kv_len.to(device=q.device, dtype=torch.int32).contiguous()
    return _launch_paged(_build.library(), _stream(q.device),
                         _launch.sm_count(q.device.index or 0), form, q,
                         k_pages, v_pages, table, kv_len, layer, kv_heads,
                         k_scale, v_scale)


def _launch_paged(lib, stream: int, sms: int, form: str, q, k_pages,
                  v_pages, table, kv_len, layer: int, kv_heads: int,
                  k_scale, v_scale):
    """Launch B7's ``form`` through ``lib`` on ``sms`` SMs: B3's plan over
    maxp * page positions per slot, the stream's workspace and zeroed
    counters; allocates only the output and reads nothing of kv_len or the
    table on the host."""
    B, _, H, hd = q.shape
    P, page = k_pages.shape[1], k_pages.shape[2]
    maxp = table.shape[1]
    plan = decode_plan(B, kv_heads, maxp * page, sms)
    out = torch.empty_like(q)
    name = "paged_attention" + form
    scales = (k_scale.data_ptr(), v_scale.data_ptr()) if form else ()
    err = getattr(lib, "v3d_" + name)(
        q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(), *scales,
        table.data_ptr(), kv_len.data_ptr(), out.data_ptr(),
        *split_args(plan, q.device, stream), layer, B, P, page, maxp, H,
        kv_heads, plan.splits, float(hd ** -0.5), stream)
    _build.check(err, name)
    _build.count_launch(name)
    return out
