"""Paged KV cache: a shared page pool and per-slot page tables, in PyTorch:
counterpart of ``video3d_tpu/models/paged_kv.py``, the cache of the paged
continuous batcher (``serve/batcher.py``), whose device memory scales with
the tokens the slots hold instead of slots x max length.

Device side: :class:`PagedKVCache` (stacked flat pools, table, lengths).
Host side: :class:`PageAllocator`, a free list over the page ids that the
batcher's scheduler thread owns. Pool layout as in the JAX package: values
(layers, P, page, KV*hd), heads flat per token row; int8 pools add f32
scale pools (layers, P, KV, 1, page), the page's positions contiguous;
int4 pools hold uint8 (layers, P, page, KV*hd / 2), two channels per byte
(``models/qwen2.py``, ``pack_kv_int4``), with the same scale pools.

The port writes IN PLACE: a decode step writes each layer's new K/V (and
scales) straight into the stacked pools at (layer, page id, offset); dead
slots write to the scratch page 0, offset 0. The JAX per-layer view and
restack (``layer_view``, ``qwen2.py:580-591, :620-631``) and its parked
stacked-threading loop (:323-361) were XLA compile-time workarounds and
are not ported. The speculative verify appends its L-token block per slot
(:func:`append_positions_multi`).
"""

from __future__ import annotations

from typing import List, NamedTuple, Optional

import torch

from video3d_tpu_torch.config import LLMConfig


class PagedKVCache(NamedTuple):
    """k/v: (layers, P, page, KV*hd) flat pools (int4: uint8, KV*hd / 2
    bytes per row); quantized pools add (layers, P, KV, 1, page) f32 scale
    pools. page_table: (S, maxp) int32
    (entries past a slot's pages stay in [0, P) and are never read).
    lens: (S,) int32 valid tokens per slot. Updated in place."""

    k: torch.Tensor
    v: torch.Tensor
    page_table: torch.Tensor
    lens: torch.Tensor
    k_scale: Optional[torch.Tensor] = None
    v_scale: Optional[torch.Tensor] = None

    @property
    def page_size(self) -> int:
        return self.k.shape[2]

    @property
    def num_pages(self) -> int:
        return self.k.shape[1]

    @property
    def num_slots(self) -> int:
        return self.page_table.shape[0]

    @property
    def max_pages(self) -> int:
        return self.page_table.shape[1]

    @classmethod
    def zeros(cls, cfg: LLMConfig, num_pages: int, page_size: int,
              num_slots: int, max_pages: int, dtype=torch.bfloat16,
              device=None) -> "PagedKVCache":
        """Empty pools of ``dtype``: bf16, f32, int8 or the int4 tag
        ``models.qwen2.KV_INT4``."""
        from video3d_tpu_torch.models.qwen2 import kv_layout

        storage, width, quantized = kv_layout(cfg, dtype)
        if storage not in (torch.bfloat16, torch.float32, torch.int8,
                           torch.uint8):
            raise ValueError(f"a {dtype} paged cache: expected bf16, f32, "
                             f"int8 or int4")
        shape = (cfg.num_hidden_layers, num_pages, page_size, width)
        table = torch.zeros((num_slots, max_pages), dtype=torch.int32,
                            device=device)
        lens = torch.zeros((num_slots,), dtype=torch.int32, device=device)
        k = torch.zeros(shape, dtype=storage, device=device)
        v = torch.zeros(shape, dtype=storage, device=device)
        if not quantized:
            return cls(k, v, table, lens)
        sshape = shape[:2] + (cfg.num_key_value_heads, 1, page_size)
        return cls(k, v, table, lens,
                   torch.zeros(sshape, dtype=torch.float32, device=device),
                   torch.zeros(sshape, dtype=torch.float32, device=device))


class PageAllocator:
    """Host-side free list over the pool's page ids (scheduler thread).

    Page 0 is reserved: the filler of unused page-table entries and the
    scratch page dead slots append to; it is never handed out."""

    def __init__(self, num_pages: int):
        self._free: List[int] = list(range(num_pages - 1, 0, -1))
        self.num_pages = num_pages

    @property
    def available(self) -> int:
        return len(self._free)

    def alloc(self, n: int) -> List[int]:
        if n > len(self._free):
            raise MemoryError(
                f"page pool exhausted: want {n}, have {len(self._free)}")
        return [self._free.pop() for _ in range(n)]

    def free(self, pages: List[int]) -> None:
        for p in pages:
            if not 0 < p < self.num_pages:
                raise ValueError(f"bad page id {p}")
        self._free.extend(pages)


def pages_needed(num_tokens: int, page_size: int) -> int:
    return -(-num_tokens // page_size)


def set_slot_pages(cache: PagedKVCache, slot: int,
                   pages: List[int]) -> PagedKVCache:
    """Install a slot's page list (padded with page 0), in place."""
    if len(pages) > cache.max_pages:
        raise ValueError("too many pages for the table width")
    row = pages + [0] * (cache.max_pages - len(pages))
    cache.page_table[slot] = torch.tensor(row, dtype=torch.int32)
    return cache


def _scatter_dense_pages(cache: PagedKVCache, dense, pages,
                         n_pages: int, skip_pages: int = 0) -> None:
    """Copy dense positions [skip * page, n_pages * page) of a B=1 dense
    cache (``models/qwen2.py`` KVCache) into the ``n_pages - skip_pages``
    pool pages listed in ``pages``, in place: values (int4: packed bytes)
    and scales verbatim (no requantization). Table and lengths
    untouched."""
    page = cache.page_size
    if dense.k.shape[2] < n_pages * page:
        raise ValueError(f"dense cache of {dense.k.shape[2]} positions is "
                         f"shorter than {n_pages} pages of {page}")
    n = n_pages - skip_pages
    idx = torch.as_tensor(pages, dtype=torch.long).to(cache.k.device)
    if idx.shape != (n,):
        raise ValueError(f"{tuple(idx.shape)} page ids for {n} pages")
    lay = dense.k.shape[0]
    lo, hi = skip_pages * page, n_pages * page
    for pool, dn in ((cache.k, dense.k), (cache.v, dense.v)):
        # flat (layers, 1, L, C) -> (layers, n, page, C): a straight reshape
        pool[:, idx] = dn[:, 0, lo:hi].reshape(lay, n, page, -1) \
            .to(pool.dtype)
    if cache.k_scale is not None:
        for pool, dn in ((cache.k_scale, dense.k_scale),
                         (cache.v_scale, dense.v_scale)):
            # (layers, 1, L, KV, 1) -> (layers, n, KV, 1, page)
            KV = dn.shape[3]
            pool[:, idx] = dn[:, 0, lo:hi].reshape(lay, n, page, KV, 1) \
                .permute(0, 1, 3, 4, 2)


def transplant_dense(cache: PagedKVCache, dense, slot: int,
                     page_row: torch.Tensor, n_pages: int, length,
                     skip_pages: int = 0) -> PagedKVCache:
    """Copy a freshly prefilled B=1 dense cache into ``slot``'s pages
    ``skip_pages..n_pages`` (quantized: values and scales verbatim),
    install the (maxp,) page row and set ``lens[slot] = length`` (a 0-d
    tensor or an int), in place (:163). ``skip_pages > 0`` is the
    shared-prefix path: the row's first entries reference scene-prefix
    pages that already hold the same K/V (:func:`scatter_shared_prefix`)."""
    _scatter_dense_pages(cache, dense, page_row[skip_pages:n_pages],
                         n_pages, skip_pages)
    cache.page_table[slot] = page_row.to(cache.page_table.device)
    cache.lens[slot] = length
    return cache


def scatter_shared_prefix(cache: PagedKVCache, prefix, pages,
                          n_pages: int) -> PagedKVCache:
    """Write a scene prefix's dense KV (the engine's ``_PrefixEntry.cache``,
    (layers, 1, P, KV*hd)) into ``n_pages`` pool pages, once per scene
    (:185). Later admissions on the scene reference these pages instead of
    a private copy. They are immutable by construction: every write a slot
    issues lands at positions >= its prefill length > n_pages * page."""
    _scatter_dense_pages(cache, prefix, pages, n_pages, 0)
    return cache


def _write_rows(cache: PagedKVCache, layer: int, pids, off, k: torch.Tensor,
                v: torch.Tensor) -> None:
    """pools[layer, pids, off] = k / v (..., KV, hd), quantized with their
    scales into int8 or packed int4 pools (the rule of JAX
    ``paged_kv._quantize_kv``, :198), in place."""
    from video3d_tpu_torch.models.qwen2 import quantize_rows

    for buf, sbuf, x in ((cache.k, cache.k_scale, k),
                         (cache.v, cache.v_scale, v)):
        if sbuf is not None:
            x, scale = quantize_rows(x, buf.dtype)
            # (layers, P, KV, 1, page)[layer, pids, :, 0, off] -> (..., KV)
            sbuf[layer, pids, :, 0, off] = scale[..., 0]
            buf[layer, pids, off] = x
        else:
            buf[layer, pids, off] = x.flatten(-2).to(buf.dtype)


def write_prefill(cache: PagedKVCache, layer: int, k_seq: torch.Tensor,
                  v_seq: torch.Tensor, slot: int,
                  start_page_idx: int = 0) -> PagedKVCache:
    """Scatter a prefilled (L, KV, hd) sequence into the slot's pages
    ``start_page_idx..`` (:209), in place. L must be a multiple of the page
    size; the slot's table row must already hold the page ids."""
    L, KV, hd = k_seq.shape
    page = cache.page_size
    if L % page:
        raise ValueError(f"{L} positions are not whole pages of {page}")
    n = L // page
    pids = cache.page_table[slot, start_page_idx:start_page_idx + n].long()
    off = torch.arange(page, device=pids.device)
    _write_rows(cache, layer, pids[:, None], off[None],
                k_seq.reshape(n, page, KV, hd),
                v_seq.reshape(n, page, KV, hd))
    return cache


def append_positions(cache: PagedKVCache,
                     active: Optional[torch.Tensor] = None):
    """(pids, off), both (S,) int64: where each slot appends its token at
    position ``lens[s]`` (:248). ``active`` (S,) bool sends dead slots to
    the scratch page 0, offset 0, which no slot's length ever covers. The
    page index is clamped to the table, as JAX's gather clamps."""
    page = cache.page_size
    lens = cache.lens.long()
    pidx = (lens // page).clamp(max=cache.max_pages - 1)
    off = lens % page
    pids = torch.gather(cache.page_table.long(), 1, pidx[:, None])[:, 0]
    if active is not None:
        pids = torch.where(active, pids, 0)
        off = torch.where(active, off, 0)
    return pids, off


def append_positions_multi(cache: PagedKVCache, L: int,
                           active: Optional[torch.Tensor] = None):
    """(pids, off), both (S, L) int64: where each slot appends ``L``
    consecutive tokens at positions ``lens[s] .. lens[s] + L - 1`` (:265),
    a page boundary inside the block handled per token. Dead slots go to
    the scratch page as in :func:`append_positions`; the page index is
    clamped to the table."""
    page = cache.page_size
    pos = cache.lens.long()[:, None] + torch.arange(L,
                                                    device=cache.lens.device)
    pidx = (pos // page).clamp(max=cache.max_pages - 1)
    off = pos % page
    pids = torch.gather(cache.page_table.long(), 1, pidx)
    if active is not None:
        pids = torch.where(active[:, None], pids, 0)
        off = torch.where(active[:, None], off, 0)
    return pids, off


def append_layer_kv(cache: PagedKVCache, layer: int, k_new: torch.Tensor,
                    v_new: torch.Tensor, pids: torch.Tensor,
                    off: torch.Tensor) -> PagedKVCache:
    """Append new tokens into ``layer`` of the stacked pools, in place
    (:284): one per slot, k_new / v_new (S, KV, hd) at the (S,)
    coordinates of :func:`append_positions`, or an L-token block per slot,
    (S, L, KV, hd) at the (S, L) coordinates of
    :func:`append_positions_multi`. Callers advance ``lens`` once per step
    (:func:`advance_lens`), not per layer."""
    _write_rows(cache, layer, pids, off, k_new, v_new)
    return cache


def advance_lens(cache: PagedKVCache,
                 active: Optional[torch.Tensor] = None,
                 n: int = 1) -> PagedKVCache:
    """+n tokens on every (active) slot, in place: once per decode step."""
    cache.lens.add_(n if active is None
                    else n * active.to(cache.lens.dtype))
    return cache

