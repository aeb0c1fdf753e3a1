"""Attention at head width 256 (Gemma's): the prefill form of B2, B2
folded, B3, B7 and B5, on one hand-written kernel
(``csrc/attention_hd256.cu``), with their plain PyTorch twins.

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
of the ``cuda`` tests. Only a bf16 cache has an hd-256 form; the quantized
caches and the training forms at hd 256 raise (ROADMAP B).

:func:`hd256_plan` (pure: shapes and the SM count) gives the grid: row
tiles of 64 folded query rows per (batch row, kv head), and, where those
do not fill the card, a split of the keys whose partials merge in a second
kernel through the stream's f32 workspace (``_launch``). The paged form's
key axis is a slot's ``maxp * page`` positions (:func:`paged_plan`); the
shared-prefix form's is the prefix padded to whole 64-key tiles, then the
suffix (:func:`shared_prefix_plan`).
"""

from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import Optional

import torch

from video3d_tpu_torch.kernels import _build, _launch
from video3d_tpu_torch.kernels.attention import (
    mha_shared_prefix_reference as shared_prefix_hd256_plain)
from video3d_tpu_torch.kernels.decode_attention import (
    CACHE_FORMS, decode_attention_plain as decode_hd256_plain)
from video3d_tpu_torch.kernels.flash_attention import (
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
#: the C modes of ``v3d_attention_hd256``'s forms (the paged and
#: shared-prefix forms have entries of their own) and every bf16 form's
#: launch-count name (a quantized form's adds ``CACHE_FORMS``' suffix)
MODES = {"prefill": 0, "folded": 1, "decode": 2}
NAMES = {"prefill": "flash_attention_hd256",
         "folded": "flash_attention_folded_hd256",
         "decode": "decode_attention_hd256",
         "paged": "paged_attention_hd256",
         "shared_prefix": "shared_prefix_attention_hd256"}

__all__ = ["HEAD_DIM", "Hd256Plan", "hd256_plan", "paged_plan",
           "shared_prefix_plan", "prefill_hd256", "prefill_hd256_plain",
           "folded_hd256", "folded_hd256_plain", "decode_hd256",
           "decode_hd256_plain", "paged_hd256", "paged_hd256_plain",
           "shared_prefix_hd256", "shared_prefix_hd256_plain"]


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


def paged_plan(B: int, H: int, KV: int, maxp: int, page: int,
               sms: int) -> Hd256Plan:
    """The paged form's grid: one query per slot against the slot's maxp *
    page positions (a split past a slot's kv_len writes an empty
    partial)."""
    return hd256_plan(B, 1, H, KV, maxp * page, sms)


def prefix_keys(P: int) -> int:
    """The shared-prefix form's key slots before the suffix: the P prefix
    keys padded to whole KEYS tiles, so no tile mixes prefix and
    suffix."""
    return -(-P // KEYS) * KEYS


def shared_prefix_plan(B: int, L: int, H: int, KV: int, P: int,
                       sms: int) -> Hd256Plan:
    """The shared-prefix form's grid over its key axis: the padded prefix,
    then the L suffix keys."""
    return hd256_plan(B, L, H, KV, prefix_keys(P) + L, sms)


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
                  lengths: torch.Tensor) -> torch.Tensor:
    """B2's prefill form at hd 256 on the card: q (B, L, H, 256), k / v (B,
    L, KV, 256) bf16; query row r attends keys s <= r and s < lengths[b].
    Twin: :func:`prefill_hd256_plain` (``flash_attention_plain``)."""
    name = NAMES["prefill"]
    B, L, KV = k.shape[0], k.shape[1], k.shape[2]
    kf, vf = k.reshape(B, L, KV * HEAD_DIM), v.reshape(B, L, KV * HEAD_DIM)
    _check_cache(name, q, kf, vf, None, None, None)
    if (q.shape[-1] != HEAD_DIM or v.shape != k.shape or q.shape[0] != B
            or q.shape[2] % KV):
        raise ValueError(f"{name}: unsupported shapes q {tuple(q.shape)} "
                         f"k {tuple(k.shape)}")
    return _launch_form(*_card(q.device), "prefill", q, kf, vf, lengths,
                        None, KV)


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
    or int8 / packed int4 with scales, as :func:`folded_hd256`). Twin:
    :func:`decode_hd256_plain` (``decode_attention_plain``)."""
    if q.shape[1] != 1:
        raise ValueError(f"{NAMES['decode']}: q {tuple(q.shape)}")
    _check_dense(NAMES["decode"], q, k_all, v_all, layer, kv_heads, k_scale,
                 v_scale)
    return _launch_form(*_card(q.device), "decode", q, k_all[layer],
                        v_all[layer], kv_len, None, kv_heads,
                        _layer(k_scale, layer), _layer(v_scale, layer))


def paged_hd256(q: torch.Tensor, k_pages: torch.Tensor,
                v_pages: torch.Tensor, page_table: torch.Tensor,
                kv_len: torch.Tensor, layer: int, kv_heads: int,
                k_scale: Optional[torch.Tensor] = None,
                v_scale: Optional[torch.Tensor] = None) -> torch.Tensor:
    """B7 at hd 256 on the card: q (B, 1, H, 256), the new token of slot b
    at kv_len[b] - 1 attending its positions < kv_len[b] through
    ``page_table`` (B, maxp) into ``layer`` of the stacked (layers, P,
    page, KV * 256) pools, bf16, or int8 (packed int4: KV * 128 bytes) with
    the stacked (layers, P, KV, 1, page) f32 scales; any page size. Twin:
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
            or H % kv_heads or not 0 <= layer < NL
            or page_table.dim() != 2 or page_table.shape[0] != B
            or page_table.shape[1] < 1 or kv_len.shape != (B,)):
        raise ValueError(f"{name}: unsupported shapes q {tuple(q.shape)} "
                         f"pools {tuple(k_pages.shape)} table "
                         f"{tuple(page_table.shape)} layer {layer} kv_heads "
                         f"{kv_heads}")
    dev = q.device
    table = page_table.to(device=dev, dtype=torch.int32).contiguous()
    kv_len = kv_len.to(device=dev, dtype=torch.int32).contiguous()
    return _launch_paged(*_card(dev), q, k_pages, v_pages, table, kv_len,
                         layer, kv_heads, k_scale, v_scale)


def _launch_paged(lib, stream: int, sms: int, q, k_pages, v_pages, table,
                  kv_len, layer: int, kv_heads: int, k_scale=None,
                  v_scale=None) -> torch.Tensor:
    """Launch the paged form through ``lib`` on ``sms`` SMs: its plan over
    maxp * page positions per slot and the stream's workspace; allocates
    only the output and reads nothing of kv_len or the table on the
    host."""
    B, _, H, hd = q.shape
    P, page = k_pages.shape[1], k_pages.shape[2]
    maxp = table.shape[1]
    plan = paged_plan(B, H, kv_heads, maxp, page, sms)
    ws = _workspace(plan, q.device, stream)
    out = torch.empty_like(q)
    if k_scale is None:
        name = NAMES["paged"]
        err = lib.v3d_attention_hd256_paged(
            q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
            table.data_ptr(), kv_len.data_ptr(), out.data_ptr(), _ptr(ws),
            layer, B, P, page, maxp, H, kv_heads, plan.splits,
            plan.split_keys, float(hd ** -0.5), stream)
    else:
        suffix = CACHE_FORMS[k_pages.dtype]
        name = NAMES["paged"] + suffix
        err = lib.v3d_attention_hd256_paged_quant(
            q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
            k_scale.data_ptr(), v_scale.data_ptr(), table.data_ptr(),
            kv_len.data_ptr(), out.data_ptr(), _ptr(ws), BITS[suffix], layer,
            B, P, page, maxp, H, kv_heads, plan.splits, plan.split_keys,
            float(hd ** -0.5), stream)
    _build.check(err, name)
    _build.count_launch(name)
    return out


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
    j < suffix_lens[b]; rows r >= suffix_lens[b] are undefined by contract.
    Twin: :func:`shared_prefix_hd256_plain`
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
    suffix_lens = suffix_lens.to(device=q.device,
                                 dtype=torch.int32).contiguous()
    return _launch_shared_prefix(*_card(q.device), q, pk, pv, sk, sv,
                                 suffix_lens, pk_scale, pv_scale)


def _launch_shared_prefix(lib, stream: int, sms: int, q, pk, pv, sk, sv,
                          suffix_lens, pk_scale=None,
                          pv_scale=None) -> torch.Tensor:
    """Launch the shared-prefix form through ``lib`` on ``sms`` SMs: its
    plan over the padded prefix and the suffix and the stream's
    workspace; allocates only the output and reads nothing of suffix_lens
    on the host."""
    B, L, H, hd = q.shape
    P, KV = pk.shape[0], pk.shape[1]
    plan = shared_prefix_plan(B, L, H, KV, P, sms)
    ws = _workspace(plan, q.device, stream)
    out = torch.empty_like(q)
    if pk_scale is None:
        name = NAMES["shared_prefix"]
        err = lib.v3d_attention_hd256_shared_prefix(
            q.data_ptr(), pk.data_ptr(), pv.data_ptr(), sk.data_ptr(),
            sv.data_ptr(), suffix_lens.data_ptr(), out.data_ptr(), _ptr(ws),
            B, L, P, H, KV, plan.splits, plan.split_keys, float(hd ** -0.5),
            stream)
    else:
        suffix = CACHE_FORMS[pk.dtype]
        name = NAMES["shared_prefix"] + suffix
        err = lib.v3d_attention_hd256_shared_prefix_quant(
            q.data_ptr(), pk.data_ptr(), pv.data_ptr(), pk_scale.data_ptr(),
            pv_scale.data_ptr(), sk.data_ptr(), sv.data_ptr(),
            suffix_lens.data_ptr(), out.data_ptr(), _ptr(ws), BITS[suffix],
            B, L, P, H, KV, plan.splits, plan.split_keys, float(hd ** -0.5),
            stream)
    _build.check(err, name)
    _build.count_launch(name)
    return out
