"""Attention at head width 256 (Gemma's): the prefill form of B2, B2 folded
and B3, on one hand-written kernel (``csrc/attention_hd256.cu``), with
their plain PyTorch twins.

The JAX package sends any ``hd % 128 == 0`` to its Pallas kernels
(``video3d_tpu/kernels/attention.py:181``, ``:195``, ``:223``); the port's
hd-128 kernels are compiled for 128 alone, so :func:`flash_attention`,
:func:`flash_attention_gqa_folded` and :func:`decode_attention` of the
port send a CUDA tensor of width 256 here. A CPU tensor never reaches
this module: those entries run their plain versions, which are these
forms' twins (``mha_reference`` with each form's masks) and the oracle of
the ``cuda`` tests. Only a bf16 cache has an hd-256 form; the quantized
caches, B5, B7 and the training forms at hd 256 raise (ROADMAP B).

:func:`hd256_plan` (pure: shapes and the SM count) gives the grid: row
tiles of 64 folded query rows per (batch row, kv head), and, where those
do not fill the card, a split of the keys whose partials merge in a second
kernel through the stream's f32 workspace (``_launch``).
"""

from __future__ import annotations

import functools
from dataclasses import dataclass

import torch

from video3d_tpu_torch.kernels import _build, _launch
from video3d_tpu_torch.kernels.decode_attention import (
    decode_attention_plain as decode_hd256_plain)
from video3d_tpu_torch.kernels.flash_attention import (
    flash_attention_gqa_folded_plain as folded_hd256_plain,
    flash_attention_plain as prefill_hd256_plain)

HEAD_DIM = 256
ROWS = 64          # folded query rows per CTA (csrc kRows)
KEYS = 64          # keys per tile (csrc kKeys)
PART_FLOATS = HEAD_DIM + 2   # one split's O, m and l of a row
#: the forms' C modes and launch-count names
MODES = {"prefill": 0, "folded": 1, "decode": 2}
NAMES = {"prefill": "flash_attention_hd256",
         "folded": "flash_attention_folded_hd256",
         "decode": "decode_attention_hd256"}

__all__ = ["HEAD_DIM", "Hd256Plan", "hd256_plan", "prefill_hd256",
           "prefill_hd256_plain", "folded_hd256", "folded_hd256_plain",
           "decode_hd256", "decode_hd256_plain"]


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
    against S key slots on ``sms`` SMs, one CTA per SM (its ~191 KiB of
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


def _check(name: str, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
           kv_heads: int) -> None:
    """bf16, contiguous, 16-byte aligned tensors on q's device; q (B, L, H,
    256) and k / v (B, S, KV * 256) rows with H a multiple of KV."""
    for arg, t in (("q", q), ("k", k), ("v", v)):
        if t.dtype != torch.bfloat16 or not t.is_contiguous() \
                or t.device != q.device or t.data_ptr() % 16:
            raise ValueError(f"{name}: {arg} must be a contiguous, 16-byte "
                             f"aligned bfloat16 tensor on {q.device} (no "
                             f"quantized hd-256 form yet, ROADMAP B)")
    B, L, H, hd = q.shape
    if hd != HEAD_DIM or k.shape != v.shape or k.shape[0] != B \
            or k.shape[-1] != kv_heads * HEAD_DIM or H % kv_heads:
        raise ValueError(f"{name}: unsupported shapes q {tuple(q.shape)} "
                         f"k {tuple(k.shape)} kv_heads {kv_heads}")


def _on_card(form: str, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
             lens: torch.Tensor, q_off, kv_heads: int) -> torch.Tensor:
    """One launch of ``form`` on q's device and current stream."""
    dev = q.device
    return _launch_form(_build.library(),
                        torch.cuda.current_stream(dev).cuda_stream,
                        _launch.sm_count(dev.index or 0), form, q, k, v,
                        lens, q_off, kv_heads)


def _launch_form(lib, stream: int, sms: int, form: str, q: torch.Tensor,
                 k: torch.Tensor, v: torch.Tensor, lens: torch.Tensor, q_off,
                 kv_heads: int) -> torch.Tensor:
    """Launch ``form`` through ``lib`` on ``sms`` SMs over k / v rows (B,
    S, KV * 256): the plan, the stream's workspace where the keys split,
    the output; reads nothing of lens on the host."""
    B, L, H, hd = q.shape
    S = k.shape[1]
    dev = q.device
    plan = hd256_plan(B, L, H, kv_heads, S, sms)
    ws = _launch.workspace(dev, stream, plan.workspace_bytes) \
        if plan.splits > 1 else None
    lens = lens.to(device=dev, dtype=torch.int32).contiguous()
    if q_off is not None:
        q_off = q_off.to(device=dev, dtype=torch.int32).contiguous()
    out = torch.empty_like(q)
    name = NAMES[form]
    err = lib.v3d_attention_hd256(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), lens.data_ptr(),
        0 if q_off is None else q_off.data_ptr(), out.data_ptr(),
        0 if ws is None else ws.data_ptr(), MODES[form], B, L, S, H,
        kv_heads, plan.splits, plan.split_keys, float(hd ** -0.5), stream)
    _build.check(err, name)
    _build.count_launch(name)
    return out


def prefill_hd256(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  lengths: torch.Tensor) -> torch.Tensor:
    """B2's prefill form at hd 256 on the card: q (B, L, H, 256), k / v (B,
    L, KV, 256); query row r attends keys s <= r and s < lengths[b]. Twin:
    :func:`prefill_hd256_plain` (``flash_attention_plain``)."""
    B, L, KV = k.shape[0], k.shape[1], k.shape[2]
    kf, vf = k.reshape(B, L, KV * HEAD_DIM), v.reshape(B, L, KV * HEAD_DIM)
    _check(NAMES["prefill"], q, kf, vf, KV)
    return _on_card("prefill", q, kf, vf, lengths, None, KV)


def folded_hd256(q: torch.Tensor, k_all: torch.Tensor, v_all: torch.Tensor,
                 lengths: torch.Tensor, q_offsets: torch.Tensor, layer: int,
                 kv_heads: int) -> torch.Tensor:
    """B2 folded at hd 256 on the card: q (B, L, H, 256), query r of row b
    at q_offsets[b] + r, over ``layer`` of the stacked bf16 (layers, B, S,
    KV * 256) cache; slot s valid when <= the query's position and <
    lengths[b]. Twin: :func:`folded_hd256_plain`."""
    if not 0 <= layer < k_all.shape[0]:
        raise ValueError(f"{NAMES['folded']}: layer {layer}")
    k, v = k_all[layer], v_all[layer]
    _check(NAMES["folded"], q, k, v, kv_heads)
    return _on_card("folded", q, k, v, lengths, q_offsets, kv_heads)


def decode_hd256(q: torch.Tensor, k_all: torch.Tensor, v_all: torch.Tensor,
                 kv_len: torch.Tensor, layer: int,
                 kv_heads: int) -> torch.Tensor:
    """B3 at hd 256 on the card: q (B, 1, H, 256), the new token at kv_len[b]
    - 1 attending slots < kv_len[b] of ``layer`` of the stacked bf16 cache.
    Twin: :func:`decode_hd256_plain` (``decode_attention_plain``)."""
    if q.shape[1] != 1 or not 0 <= layer < k_all.shape[0]:
        raise ValueError(f"{NAMES['decode']}: q {tuple(q.shape)} layer "
                         f"{layer}")
    k, v = k_all[layer], v_all[layer]
    _check(NAMES["decode"], q, k, v, kv_heads)
    return _on_card("decode", q, k, v, kv_len, None, kv_heads)
