"""Attention at head width 256 (Gemma's): B2 folded on one hand-written
kernel (``csrc/attention_hd256.cu``, WMMA), B3 and B7 on the hd-128
decode template's hd-256 instantiations (``csrc/decode_sm90.cuh`` through
``csrc/decode_attention.cu`` and ``csrc/paged_attention.cu``), B5 on a
TMA + wgmma kernel of its own
(``csrc/shared_prefix_hd256.cu``), the prefill form of B2 and its training
form with the logsumexp on another (``csrc/flash_attention_hd256.cu``), and
B6, their backward, on a third (``csrc/flash_attention_bwd_hd256.cu``),
with their plain PyTorch twins.

The JAX package sends any ``hd % 128 == 0`` to its Pallas kernels
(``video3d_tpu/kernels/attention.py:181``, ``:195``, ``:223``, ``:401``,
and ``flash_attention.py:673`` for the shared prefix); the port's hd-128
kernels are compiled for 128 alone, so :func:`flash_attention`,
:func:`flash_attention_gqa_folded`, :func:`decode_attention`,
:func:`paged_decode_attention` and :func:`flash_attention_shared_prefix` of
the port send a CUDA tensor of width 256 here. A CPU tensor never reaches
this module: those entries run their plain versions, which are these
forms' twins (``mha_reference`` with each form's masks,
``paged_attention_plain``, ``mha_shared_prefix_reference``) and the oracle
of the ``cuda`` tests. B2 folded, B3, B7 and B5 also read an int8 or a
packed int4 cache (B5: its prefix).

Training: ``flash_attention_fwd`` and ``flash_attention_bwd`` of the port
send hd 256 to :func:`prefill_lse_hd256` (B2 with the logsumexp, counted
as ``flash_attention_lse_hd256``) and :func:`bwd_hd256` (B6, counted as
``flash_attention_bwd_hd256``); their twins are the hd-128 forms' plain
versions, which take any head width.

:func:`hd256_plan` (pure: shapes and the SM count) gives the WMMA
kernel's grid: row tiles of 64 folded query rows per (batch row, kv head),
and, where those do not fill the card, a split of the keys whose partials
merge in a second kernel through the stream's f32 workspace (``_launch``).
B3's and B7's grids are ``decode_attention.decode_plan`` at head width
256 (B7's over a slot's ``maxp * page`` positions); B5's
(:func:`shared_prefix_plan`) is row tiles of 128 folded rows per kv head,
the prefix's 64-key tiles split by the hd-128 chunk kernels' cost model,
the splits merged in the kernel through the stream's workspace and
arrival counters. The prefill forms need no plan (one CTA
per 128-row query tile and head); :func:`bwd_hd256_plan` splits B6's query
heads over CTAs so that no causal walk outlasts an even share of the
card's work.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import Optional

import torch

from video3d_tpu_torch.kernels import _build, _launch
from video3d_tpu_torch.kernels import decode_attention as _decode
from video3d_tpu_torch.kernels import paged_attention as _paged
from video3d_tpu_torch.kernels.attention import (
    mha_shared_prefix_reference as shared_prefix_hd256_plain)
from video3d_tpu_torch.kernels.decode_attention import (
    CACHE_FORMS, decode_attention_plain as decode_hd256_plain)
from video3d_tpu_torch.kernels.flash_attention import (
    bwd_rows, chunk_plan, flash_attention_bwd_plain as bwd_hd256_plain,
    flash_attention_fwd_plain as prefill_lse_hd256_plain,
    flash_attention_gqa_folded_plain as folded_hd256_plain,
    flash_attention_plain as prefill_hd256_plain)
from video3d_tpu_torch.kernels.paged_attention import (
    paged_attention_plain as paged_hd256_plain)

HEAD_DIM = 256
#: a quantized cache's name suffix -> its bits (the C entries' ``bits``)
BITS = {"_int8": 8, "_int4": 4}
ROWS = 64          # folded query rows per CTA (csrc kRows)
KEYS = 64          # keys per tile (csrc kKeys)
PART_FLOATS = HEAD_DIM + 2   # one split's O, m and l of a row
#: the C mode of ``v3d_attention_hd256``'s folded form and every bf16
#: form's launch-count name (a quantized form's adds ``CACHE_FORMS``'
#: suffix)
MODES = {"folded": 1}
SP_ROWS = 128      # B5: folded query rows per CTA (csrc shared_prefix_hd256
SP_KEYS = 64       # kBq), keys per tile (kBk)
#: B5: f32 of one split's partial of a CTA (O, then m and l per row)
SP_PART_FLOATS = SP_ROWS * HEAD_DIM + 2 * SP_ROWS
BWD_KEYS = 64      # B6: keys per CTA (csrc flash_attention_bwd_hd256 kBk)
BWD_ROWS = 64      # B6: query rows per tile of a CTA's walk (kBq)
NAMES = {"prefill": "flash_attention_hd256",
         "folded": "flash_attention_folded_hd256",
         "decode": "decode_attention_hd256",
         "paged": "paged_attention_hd256",
         "shared_prefix": "shared_prefix_attention_hd256",
         "lse": "flash_attention_lse_hd256",
         "bwd": "flash_attention_bwd_hd256"}

__all__ = ["HEAD_DIM", "Hd256Plan", "hd256_plan",
           "SharedPrefixPlan", "shared_prefix_plan", "BwdPlan",
           "bwd_hd256_plan",
           "prefill_hd256", "prefill_hd256_plain",
           "folded_hd256", "folded_hd256_plain", "decode_hd256",
           "decode_hd256_plain", "paged_hd256", "paged_hd256_plain",
           "shared_prefix_hd256", "shared_prefix_hd256_plain",
           "prefill_lse_hd256", "prefill_lse_hd256_plain", "bwd_hd256",
           "bwd_hd256_plain"]


@dataclass(frozen=True)
class Hd256Plan:
    """The grid of one launch: ``row_tiles`` tiles of ROWS folded rows for
    each of ``bkv`` (batch row, kv head) pairs, each over ``splits`` key
    ranges of ``split_keys`` keys (a multiple of KEYS)."""
    bkv: int
    rows: int
    row_tiles: int
    splits: int
    split_keys: int

    @property
    def ctas(self) -> int:
        return self.bkv * self.row_tiles * self.splits

    @property
    def workspace_bytes(self) -> int:
        if self.splits == 1:
            return 0
        return self.bkv * self.rows * self.splits * PART_FLOATS * 4


@functools.lru_cache(maxsize=None)
def hd256_plan(B: int, L: int, H: int, KV: int, S: int,
               sms: int) -> Hd256Plan:
    """A launch over B batch rows of L queries of H heads (KV kv heads)
    against S key slots on ``sms`` SMs, one CTA per SM (its 192 KiB of
    shared memory allows no second): row tiles alone where they fill the
    card, else as many key splits as the SMs left per tile allow, no more
    than the key tiles, each split whole tiles (so none is empty by
    capacity; a split past a row's live keys writes an empty partial)."""
    rows = L * (H // KV)
    row_tiles = -(-rows // ROWS)
    groups = B * KV * row_tiles
    key_tiles = -(-S // KEYS)
    want = 1 if groups >= sms else max(1, min(key_tiles, sms // groups))
    per = -(-key_tiles // want)
    return Hd256Plan(B * KV, rows, row_tiles, -(-key_tiles // per),
                     per * KEYS)


@dataclass(frozen=True)
class BwdPlan:
    """B6's grid: one CTA per (key tile of BWD_KEYS, batch row, kv head,
    split), each walking ``heads`` of the group's query heads; ``longest``
    query tiles the longest CTA walks, ``share`` the query tiles an even
    spread gives each SM (both over all L rows: the host never reads the
    lengths)."""
    key_tiles: int
    bkv: int
    splits: int
    heads: int
    longest: int
    share: float

    @property
    def ctas(self) -> int:
        return self.key_tiles * self.bkv * self.splits

    def partial_shape(self, B: int, S: int, KV: int) -> tuple:
        """The f32 dK / dV partials: one (B, S, KV, 256) slice a split."""
        return (self.splits, B, S, KV, HEAD_DIM)


@functools.lru_cache(maxsize=None)
def bwd_hd256_plan(B: int, L: int, H: int, KV: int, causal: bool,
                   sms: int) -> BwdPlan:
    """B6 at hd 256 over B rows of L queries (= keys) of H heads on KV kv
    heads, ``sms`` SMs: key tile j walks L / BWD_ROWS - j query tiles of
    each head (causal; all of them otherwise). The group's G = H / KV heads
    split over the fewest CTAs (a divisor of G) for which the longest walk
    (key tile 0's) is no longer than the SMs' even share; G where none
    is."""
    G = H // KV
    key_tiles = -(-L // BWD_KEYS)
    q_tiles = -(-L // BWD_ROWS)
    walk = sum(q_tiles - j if causal else q_tiles for j in range(key_tiles))
    share = B * KV * G * walk / sms
    splits = next((s for s in range(1, G + 1)
                   if G % s == 0 and q_tiles * (G // s) <= share), G)
    return BwdPlan(key_tiles, B * KV, splits, G // splits,
                   q_tiles * (G // splits), share)


@dataclass(frozen=True)
class SharedPrefixPlan:
    """B5's grid at hd 256: ``groups`` row tiles of SP_ROWS folded rows
    (b-major over the batch, times the kv heads), each over ``splits``
    CTAs that split the prefix's ``key_tiles`` tiles of SP_KEYS keys (the
    last split also walks the suffix); a split launch's partials (one per
    CTA) and one arrival counter per group."""
    groups: int
    key_tiles: int
    splits: int

    @property
    def ctas(self) -> int:
        return self.groups * self.splits

    @property
    def workspace_bytes(self) -> int:
        if self.splits == 1:
            return 0
        return self.ctas * SP_PART_FLOATS * 4

    def tiles(self, split: int) -> range:
        """The prefix tiles split ``split`` walks: [s n / splits, (s + 1)
        n / splits), as the kernel's ``split_begin``."""
        n = self.key_tiles
        return range(n * split // self.splits,
                     n * (split + 1) // self.splits)


@functools.lru_cache(maxsize=None)
def shared_prefix_plan(B: int, L: int, H: int, KV: int, P: int,
                       sms: int) -> SharedPrefixPlan:
    """B5 at hd 256 over B rows of L suffix queries of H heads (KV kv
    heads) and a P-key prefix on ``sms`` SMs: the row tiles of each kv
    head's B L H / KV folded rows, the split count of the hd-128 chunk
    kernels' cost model (``chunk_plan``: one where the row tiles fill the
    card, never more than the prefix's tiles)."""
    groups = KV * -(-B * L * (H // KV) // SP_ROWS)
    key_tiles = -(-P // SP_KEYS)
    return SharedPrefixPlan(groups, key_tiles,
                            chunk_plan(groups, key_tiles, sms).splits)


def _check_tensors(name: str, device, dtype, align: int = 16,
                   **tensors) -> None:
    """Contiguous, ``align``-byte aligned tensors of ``dtype`` on
    ``device``."""
    for arg, t in tensors.items():
        if t.dtype != dtype or not t.is_contiguous() \
                or t.device != device or t.data_ptr() % align:
            raise ValueError(f"{name}: {arg} must be a contiguous, "
                             f"{align}-byte aligned {dtype} tensor on "
                             f"{device}")


def _check_cache(name: str, q: torch.Tensor, k: torch.Tensor,
                 v: torch.Tensor, k_scale, v_scale, scale_shape) -> str:
    """q bf16; k / v bf16 without scales, or int8 or packed int4 (uint8)
    with f32 scales of ``scale_shape``, all contiguous and on q's device,
    q, k and v 16-byte aligned (the tile loads read 16 bytes), the scales
    read one f32 at a time (a layer's slice of Gemma's one-kv-head prefix
    scales is 4-byte aligned). Returns the form's name suffix
    (``CACHE_FORMS``)."""
    form = CACHE_FORMS.get(k.dtype)
    if form is None or (form == "") != (k_scale is None) \
            or (k_scale is None) != (v_scale is None):
        raise ValueError(f"{name}: the cache must be bf16 without scales, or "
                         f"int8 or packed int4 (uint8) with scales (got "
                         f"{k.dtype})")
    _check_tensors(name, q.device, torch.bfloat16, q=q)
    _check_tensors(name, q.device, k.dtype, k=k, v=v)
    if form:
        if k_scale.shape != tuple(scale_shape) \
                or v_scale.shape != k_scale.shape:
            raise ValueError(f"{name}: scales {tuple(k_scale.shape)} / "
                             f"{tuple(v_scale.shape)}, expected "
                             f"{tuple(scale_shape)}")
        _check_tensors(name, q.device, torch.float32, 4, k_scale=k_scale,
                       v_scale=v_scale)
    return form


def _row_width(kv_heads: int, form: str) -> int:
    """Entries of one cached row of ``kv_heads`` heads: channels, or bytes
    of packed int4."""
    return kv_heads * HEAD_DIM // (2 if form == "_int4" else 1)


def _check_dense(name: str, q: torch.Tensor, k_all: torch.Tensor,
                 v_all: torch.Tensor, layer: int, kv_heads: int, k_scale,
                 v_scale) -> str:
    """The dense forms' stacked (layers, B, S, KV * 256) cache (packed
    int4: KV * 128 bytes) and (layers, B, S, KV, 1) scales; q (B, L, H,
    256) with H a multiple of KV. Returns the form's suffix."""
    B, L, H, hd = q.shape
    form = _check_cache(name, q, k_all, v_all, k_scale, v_scale,
                        (*k_all.shape[:3], kv_heads, 1))
    if (hd != HEAD_DIM or k_all.dim() != 4 or v_all.shape != k_all.shape
            or k_all.shape[1] != B or H % kv_heads
            or k_all.shape[-1] != _row_width(kv_heads, form)
            or not 0 <= layer < k_all.shape[0]):
        raise ValueError(f"{name}: unsupported shapes q {tuple(q.shape)} "
                         f"cache {tuple(k_all.shape)} layer {layer} "
                         f"kv_heads {kv_heads}")
    return form


def _layer(x, layer: int):
    return None if x is None else x[layer]


def _card(dev) -> tuple:
    """(library, current stream, SM count) of a launch on ``dev``."""
    return (_build.library(), torch.cuda.current_stream(dev).cuda_stream,
            _launch.sm_count(dev.index or 0))


def _workspace(plan: Hd256Plan, dev, stream: int):
    """The stream's f32 workspace where the plan splits the keys."""
    return _launch.workspace(dev, stream, plan.workspace_bytes) \
        if plan.splits > 1 else None


def _ptr(t) -> int:
    return 0 if t is None else t.data_ptr()


def _launch_form(lib, stream: int, sms: int, form: str, q: torch.Tensor,
                 k: torch.Tensor, v: torch.Tensor, lens: torch.Tensor, q_off,
                 kv_heads: int, k_scale=None,
                 v_scale=None) -> torch.Tensor:
    """Launch ``form`` through ``lib`` on ``sms`` SMs over k / v rows (B,
    S, KV * 256; packed int4 KV * 128 bytes) of one layer, with that
    layer's (B, S, KV, 1) scales for a quantized cache: the plan, the
    stream's workspace where the keys split, the output; reads nothing of
    lens on the host."""
    B, L, H, hd = q.shape
    S = k.shape[1]
    dev = q.device
    plan = hd256_plan(B, L, H, kv_heads, S, sms)
    ws = _workspace(plan, dev, stream)
    lens = lens.to(device=dev, dtype=torch.int32).contiguous()
    if q_off is not None:
        q_off = q_off.to(device=dev, dtype=torch.int32).contiguous()
    out = torch.empty_like(q)
    if k_scale is None:
        name = NAMES[form]
        err = lib.v3d_attention_hd256(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), lens.data_ptr(),
            _ptr(q_off), out.data_ptr(), _ptr(ws), MODES[form], B, L, S, H,
            kv_heads, plan.splits, plan.split_keys, float(hd ** -0.5),
            stream)
    else:
        suffix = CACHE_FORMS[k.dtype]
        name = NAMES[form] + suffix
        err = lib.v3d_attention_hd256_quant(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), k_scale.data_ptr(),
            v_scale.data_ptr(), lens.data_ptr(), _ptr(q_off), out.data_ptr(),
            _ptr(ws), MODES[form], BITS[suffix], B, L, S, H, kv_heads,
            plan.splits, plan.split_keys, float(hd ** -0.5), stream)
    _build.check(err, name)
    _build.count_launch(name)
    return out


def prefill_hd256(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  lengths: torch.Tensor, causal: bool = True) -> torch.Tensor:
    """B2's prefill form at hd 256 on the card: q (B, L, H, 256), k / v (B,
    L, KV, 256) bf16; query row r attends keys s < lengths[b] (and s <= r,
    causal). Twin: :func:`prefill_hd256_plain` (``flash_attention_plain``)."""
    if k.dtype != torch.bfloat16 or v.dtype != torch.bfloat16:
        raise ValueError(f"{NAMES['prefill']}: k and v must be bf16 (no "
                         f"prefill form reads a quantized cache), got "
                         f"{k.dtype}")
    _check_train(NAMES["prefill"], q, k, v)
    out, _ = _launch_prefill(_build.library(),
                             torch.cuda.current_stream(q.device).cuda_stream,
                             q, k, v, lengths, causal, with_lse=False)
    return out


def _launch_prefill(lib, stream: int, q, k, v, lengths, causal: bool,
                    with_lse: bool):
    """Launch B2's prefill form at hd 256 (``with_lse``: its training
    instantiation) through ``lib``: (out, lse or None); allocates the
    output and the lse and reads nothing of lengths on the host."""
    name = NAMES["lse" if with_lse else "prefill"]
    B, L, H, hd = q.shape
    lengths = lengths.to(device=q.device, dtype=torch.int32).contiguous()
    out = torch.empty_like(q)
    lse = torch.empty(B, H, L, dtype=torch.float32, device=q.device) \
        if with_lse else None
    ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), lengths.data_ptr(),
            out.data_ptr()) + ((lse.data_ptr(),) if with_lse else ())
    entry = "v3d_flash_attention_hd256" + ("_lse" if with_lse else "")
    err = getattr(lib, entry)(*ptrs, B, L, L, H, k.shape[2], int(causal),
                              float(hd ** -0.5), stream)
    _build.check(err, name)
    _build.count_launch(name)
    return out, lse


def folded_hd256(q: torch.Tensor, k_all: torch.Tensor, v_all: torch.Tensor,
                 lengths: torch.Tensor, q_offsets: torch.Tensor, layer: int,
                 kv_heads: int, k_scale: Optional[torch.Tensor] = None,
                 v_scale: Optional[torch.Tensor] = None) -> torch.Tensor:
    """B2 folded at hd 256 on the card: q (B, L, H, 256), query r of row b
    at q_offsets[b] + r, over ``layer`` of the stacked (layers, B, S,
    KV * 256) cache, bf16, or int8 (packed int4: KV * 128 bytes) with its
    (layers, B, S, KV, 1) f32 scales; slot s valid when <= the query's
    position and < lengths[b]. Twin: :func:`folded_hd256_plain`."""
    _check_dense(NAMES["folded"], q, k_all, v_all, layer, kv_heads, k_scale,
                 v_scale)
    return _launch_form(*_card(q.device), "folded", q, k_all[layer],
                        v_all[layer], lengths, q_offsets, kv_heads,
                        _layer(k_scale, layer), _layer(v_scale, layer))


def decode_hd256(q: torch.Tensor, k_all: torch.Tensor, v_all: torch.Tensor,
                 kv_len: torch.Tensor, layer: int, kv_heads: int,
                 k_scale: Optional[torch.Tensor] = None,
                 v_scale: Optional[torch.Tensor] = None) -> torch.Tensor:
    """B3 at hd 256 on the card: q (B, 1, H, 256), the new token at kv_len[b]
    - 1 attending slots < kv_len[b] of ``layer`` of the stacked cache (bf16,
    or int8 / packed int4 with scales, as :func:`folded_hd256`), at most
    ``MAX_GROUP`` query heads per kv head; the hd-128 decode template's
    hd-256 instantiation, planned by ``decode_plan`` at head width 256.
    Twin: :func:`decode_hd256_plain` (``decode_attention_plain``)."""
    name = NAMES["decode"]
    B, L, H, _ = q.shape
    form = _check_dense(name, q, k_all, v_all, layer, kv_heads, k_scale,
                        v_scale)
    if L != 1 or H // kv_heads > _decode.MAX_GROUP or kv_len.shape != (B,):
        raise ValueError(f"{name}: unsupported shapes q {tuple(q.shape)} "
                         f"kv_len {tuple(kv_len.shape)} kv_heads {kv_heads}")
    kv_len = kv_len.to(device=q.device, dtype=torch.int32).contiguous()
    return _decode._launch_decode(*_card(q.device), form, q, k_all, v_all,
                                  kv_len, layer, kv_heads, k_scale, v_scale)


def paged_hd256(q: torch.Tensor, k_pages: torch.Tensor,
                v_pages: torch.Tensor, page_table: torch.Tensor,
                kv_len: torch.Tensor, layer: int, kv_heads: int,
                k_scale: Optional[torch.Tensor] = None,
                v_scale: Optional[torch.Tensor] = None) -> torch.Tensor:
    """B7 at hd 256 on the card: q (B, 1, H, 256), the new token of slot b
    at kv_len[b] - 1 attending its positions < kv_len[b] through
    ``page_table`` (B, maxp) into ``layer`` of the stacked (layers, P,
    page, KV * 256) pools, bf16, or int8 (packed int4: KV * 128 bytes) with
    the stacked (layers, P, KV, 1, page) f32 scales; any page size, at
    most ``MAX_GROUP`` query heads per kv head; the decode template's
    hd-256 instantiation over the pools' map, planned as B3. Twin:
    :func:`paged_hd256_plain` (``paged_attention_plain``)."""
    name = NAMES["paged"]
    B, L, H, hd = q.shape
    NL, P = k_pages.shape[0], k_pages.shape[1]
    page = k_pages.shape[2] if k_pages.dim() == 4 else 0
    form = _check_cache(name, q, k_pages, v_pages, k_scale, v_scale,
                        (NL, P, kv_heads, 1, page))
    if (L != 1 or hd != HEAD_DIM or k_pages.dim() != 4
            or v_pages.shape != k_pages.shape
            or k_pages.shape[-1] != _row_width(kv_heads, form)
            or H % kv_heads or H // kv_heads > _decode.MAX_GROUP
            or not 0 <= layer < NL
            or page_table.dim() != 2 or page_table.shape[0] != B
            or page_table.shape[1] < 1 or kv_len.shape != (B,)):
        raise ValueError(f"{name}: unsupported shapes q {tuple(q.shape)} "
                         f"pools {tuple(k_pages.shape)} table "
                         f"{tuple(page_table.shape)} layer {layer} kv_heads "
                         f"{kv_heads}")
    dev = q.device
    table = page_table.to(device=dev, dtype=torch.int32).contiguous()
    kv_len = kv_len.to(device=dev, dtype=torch.int32).contiguous()
    return _paged._launch_paged(*_card(dev), form, q, k_pages, v_pages,
                                table, kv_len, layer, kv_heads, k_scale,
                                v_scale)


def shared_prefix_hd256(q: torch.Tensor, pk: torch.Tensor, pv: torch.Tensor,
                        sk: torch.Tensor, sv: torch.Tensor,
                        suffix_lens: torch.Tensor,
                        pk_scale: Optional[torch.Tensor] = None,
                        pv_scale: Optional[torch.Tensor] = None
                        ) -> torch.Tensor:
    """B5 at hd 256 on the card: q (B, L, H, 256), query r of row b at
    position P + r, attending the whole (P, KV, 256) prefix (no batch dim),
    bf16, or int8 (packed int4: (P, KV, 128) bytes) with (P, KV, 1) f32
    scales, then its row's own bf16 (B, L, KV, 256) suffix keys j <= r and
    j < suffix_lens[b]; rows r >= suffix_lens[b] are undefined by contract
    (the kernel applies the causal mask alone, so suffix_lens is checked
    but not launched). Twin: :func:`shared_prefix_hd256_plain`
    (``mha_shared_prefix_reference``)."""
    name = NAMES["shared_prefix"]
    B, L, H, hd = q.shape
    P, KV = pk.shape[0], pk.shape[1]
    form = _check_cache(name, q, pk, pv, pk_scale, pv_scale, (P, KV, 1))
    _check_tensors(name, q.device, torch.bfloat16, sk=sk, sv=sv)
    if (hd != HEAD_DIM or pk.shape != (P, KV, _row_width(1, form))
            or pv.shape != pk.shape or sk.shape != (B, L, KV, HEAD_DIM)
            or sv.shape != sk.shape or H % KV
            or suffix_lens.shape != (B,)):
        raise ValueError(f"{name}: unsupported shapes q {tuple(q.shape)} "
                         f"prefix {tuple(pk.shape)} suffix "
                         f"{tuple(sk.shape)}")
    return _launch_shared_prefix(*_card(q.device), q, pk, pv, sk, sv,
                                 pk_scale, pv_scale)


def _launch_shared_prefix(lib, stream: int, sms: int, q, pk, pv, sk, sv,
                          pk_scale=None, pv_scale=None) -> torch.Tensor:
    """Launch B5 at hd 256 in the prefix's form through ``lib`` on ``sms``
    SMs: its plan, the stream's workspace and arrival counters where the
    prefix splits; allocates only the output."""
    B, L, H, hd = q.shape
    P, KV = pk.shape[0], pk.shape[1]
    plan = shared_prefix_plan(B, L, H, KV, P, sms)
    split_args = (0, 0, 0)
    if plan.splits > 1:
        ws = _launch.workspace(q.device, stream, plan.workspace_bytes)
        counters = _launch.arrival_counters(q.device, stream, plan.groups)
        split_args = (ws.data_ptr(), ws.numel() * 4, counters.data_ptr())
    out = torch.empty_like(q)
    form = CACHE_FORMS[pk.dtype]
    name = NAMES["shared_prefix"] + form
    scales = (pk_scale.data_ptr(), pv_scale.data_ptr()) if form else ()
    err = getattr(lib, "v3d_shared_prefix_attention_hd256" + form)(
        q.data_ptr(), pk.data_ptr(), pv.data_ptr(), *scales, sk.data_ptr(),
        sv.data_ptr(), out.data_ptr(), B, L, P, H, KV, float(hd ** -0.5),
        *split_args, plan.splits, stream)
    _build.check(err, name)
    _build.count_launch(name)
    return out


def _check_train(name: str, q: torch.Tensor, k: torch.Tensor,
                 v: torch.Tensor) -> None:
    """The training forms' q (B, L, H, 256) and k / v (B, L, KV, 256):
    bf16, contiguous, 16-byte aligned, on q's device, H a multiple of
    KV."""
    _check_tensors(name, q.device, torch.bfloat16, q=q, k=k, v=v)
    B, L, H, hd = q.shape
    if (hd != HEAD_DIM or k.dim() != 4 or v.shape != k.shape
            or k.shape[:2] != (B, L) or k.shape[3] != HEAD_DIM
            or H % k.shape[2]):
        raise ValueError(f"{name}: unsupported shapes q {tuple(q.shape)} "
                         f"k {tuple(k.shape)} v {tuple(v.shape)}")


def prefill_lse_hd256(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      lengths: torch.Tensor, causal: bool = True):
    """B2's training form at hd 256 on the card: q (B, L, H, 256), k / v
    (B, L, KV, 256) bf16; query row r attends keys s < lengths[b] (and s <=
    r, causal). Returns (out (B, L, H, 256) bf16, lse (B, H, L) f32), out
    equal to :func:`prefill_hd256`'s bit for bit. Twin:
    :func:`prefill_lse_hd256_plain` (``flash_attention_fwd_plain``)."""
    _check_train(NAMES["lse"], q, k, v)
    return _launch_prefill(_build.library(),
                           torch.cuda.current_stream(q.device).cuda_stream,
                           q, k, v, lengths, causal, with_lse=True)


def bwd_hd256(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              do: torch.Tensor, lse: torch.Tensor, delta: torch.Tensor,
              lengths: torch.Tensor, causal: bool = True):
    """B6 at hd 256 on the card: the gradients of :func:`prefill_lse_hd256`
    given dO (B, L, H, 256) bf16, its lse and delta = rowsum(dO * O), both
    (B, H, L) f32. Returns (dq, dk, dv) bf16, dK / dV summed over each kv
    head's group and bit-reproducible (the splits' partials summed in a
    fixed order), dQ summed by reduce-adds (not bit-reproducible). Twin:
    :func:`bwd_hd256_plain` (``flash_attention_bwd_plain``, which takes O
    and computes delta itself)."""
    name = NAMES["bwd"]
    _check_train(name, q, k, v)
    _check_tensors(name, q.device, torch.bfloat16, do=do)
    _check_tensors(name, q.device, torch.float32, 4, lse=lse, delta=delta)
    B, L, H, _ = q.shape
    if do.shape != q.shape or lse.shape != (B, H, L) \
            or delta.shape != lse.shape:
        raise ValueError(f"{name}: do {tuple(do.shape)} lse "
                         f"{tuple(lse.shape)} delta {tuple(delta.shape)}")
    lengths = lengths.to(device=q.device, dtype=torch.int32).contiguous()
    return _launch_bwd(*_card(q.device), q, k, v, do, bwd_rows(lse, delta),
                       lengths, causal)


def _launch_bwd(lib, stream: int, sms: int, q, k, v, do, rows, lengths,
                causal: bool):
    """Launch B6 at hd 256 through ``lib`` on ``sms`` SMs with its plan:
    dQ added into a zeroed f32 scratch, the dK / dV partials (every element
    written) summed over the splits; the sums rounded to bf16."""
    B, L, H, hd = q.shape
    KV = k.shape[2]
    plan = bwd_hd256_plan(B, L, H, KV, bool(causal), sms)
    dq = torch.zeros(B, L, H, hd, dtype=torch.float32, device=q.device)
    dk_part, dv_part = (torch.empty(plan.partial_shape(B, L, KV),
                                    dtype=torch.float32, device=q.device)
                        for _ in range(2))
    err = lib.v3d_flash_attention_bwd_hd256(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
        rows.data_ptr(), lengths.data_ptr(), dq.data_ptr(),
        dk_part.data_ptr(), dv_part.data_ptr(), B, L, L, H, KV, plan.splits,
        int(causal), float(hd ** -0.5), stream)
    _build.check(err, NAMES["bwd"])
    _build.count_launch(NAMES["bwd"])
    return (dq.to(q.dtype), dk_part.sum(0).to(k.dtype),
            dv_part.sum(0).to(v.dtype))
