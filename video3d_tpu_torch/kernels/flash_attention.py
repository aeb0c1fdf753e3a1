"""Flash attention forward (kernel B2, prefill and GQA-folded forms), its
backward (kernel B6), the shared-prefix attention of kernel B5, and their
plain PyTorch versions.

Each entry dispatches on the device of ``q``: a CPU tensor runs its plain
version (``mha_reference`` with the same masks, or
``mha_shared_prefix_reference``); a CUDA tensor launches its
kernel (``csrc/flash_attention.cu``, ``csrc/shared_prefix_attention.cu``)
or raises. Counterparts of ``video3d_tpu/kernels/flash_attention.py``:
``flash_attention`` in its prefill form (L == S, query offset 0, forward
only, bf16), ``flash_attention_gqa_folded`` over a bf16, an int8 or a
packed int4 cache and ``flash_attention_shared_prefix`` over a bf16, an
int8 or a packed int4 prefix (one shared-prefix path, the fused one). A
quantized cache or prefix launches the kernel's int8 or int4
instantiation and counts under its own ``*_int8`` / ``*_int4`` name.

Training: :class:`FlashAttentionFunction` (entry :func:`flash_attention_train`)
is the counterpart of the JAX custom VJP ``_flash_core``: its forward runs B2
with the per-row logsumexp (:func:`flash_attention_fwd`, counted as
``flash_attention_lse``), its backward the fused B6 kernel
(:func:`flash_attention_bwd`, ``csrc/flash_attention_bwd.cu``, counted as
``flash_attention_bwd``), on the CPU their plain versions.

At head width 256 B2 folded (over a bf16, an int8 or a packed int4
cache) launches ``csrc/attention_hd256.cu`` instead, B5 (over such a
prefix) ``csrc/shared_prefix_hd256.cu``, the prefill form and B2 with the
logsumexp ``csrc/flash_attention_hd256.cu``, B6
``csrc/flash_attention_bwd_hd256.cu`` (``kernels/attention_hd256.py``).

Every form at hd 128 runs on Hopper kernels fed by TMA: their C entries
take the shapes, encode the tensor maps from the kernels' own tile sizes
and plan the grids. B2 folded and B5 (``csrc/chunk_sm90.cuh``) split over keys where
their row tiles alone do not fill the card; :func:`chunk_plan` picks the
split count from the shapes and the SM count, and the wrapper allocates
the workspace the splits merge through.
"""

from __future__ import annotations

import functools
import math
from dataclasses import dataclass
from typing import Optional, Tuple

import torch

from video3d_tpu_torch.kernels import _build
from video3d_tpu_torch.kernels._launch import \
    arrival_counters as _arrival_counters
from video3d_tpu_torch.kernels._launch import sm_count as _sm_count
from video3d_tpu_torch.kernels.attention import (NEG_INF, mha_reference,
                                                 mha_shared_prefix_reference)
from video3d_tpu_torch.kernels.decode_attention import (CACHE_FORMS,
                                                        check_cache, layer_kv)

HEAD_DIM = 128   # the kernels' compiled head dim
LOG2E = math.log2(math.e)
# B2 folded / B5 (csrc/chunk_sm90.cuh): folded query rows per CTA, keys per
# tile, and the f32 partial of one split of a CTA (O, then m and l per row)
CHUNK_ROWS = 128
CHUNK_KEYS = 128
PART_FLOATS = CHUNK_ROWS * HEAD_DIM + 2 * CHUNK_ROWS
MAX_SPLITS = 64   # the merge's per-row weights fill one CTA's Q tile


@dataclass(frozen=True)
class ChunkPlan:
    """The grid of a B2 folded or B5 launch: ``groups`` row tiles (times
    kv heads, times batch rows for B2 folded), each split over keys into
    ``splits`` CTAs; ``workspace_floats`` f32 of their partials (0 for one
    split) and one arrival counter per group."""
    groups: int
    key_tiles: int
    splits: int

    @property
    def ctas(self) -> int:
        return self.groups * self.splits

    @property
    def workspace_floats(self) -> int:
        if self.splits == 1:
            return 0
        return self.groups * self.splits * PART_FLOATS


@functools.lru_cache(maxsize=None)
def chunk_plan(groups: int, key_tiles: int, sms: int) -> ChunkPlan:
    """Split count of a grid of ``groups`` row tiles over ``key_tiles`` key
    tiles (an upper bound: the kernel splits each tile's real extent) on
    ``sms`` SMs, one CTA per SM (their shared memory allows no second):
    the count that minimises waves x (key tiles per split + one tile's time
    to fill the ring + two more to write and merge the partials of a
    split), the fewest on a tie. A grid that fills the card alone gets 1; a
    split count never exceeds the key tiles, so no split is empty of them
    by construction, nor MAX_SPLITS."""
    best, splits = None, 1
    for s in range(1, min(max(key_tiles, 1), MAX_SPLITS) + 1
                   if groups < sms else 2):
        cost = -(-groups * s // sms) \
            * (-(-max(key_tiles, 1) // s) + 1 + 2 * (s > 1))
        if best is None or cost < best:
            best, splits = cost, s
    return ChunkPlan(groups, key_tiles, splits)


def folded_plan(B: int, L: int, H: int, KV: int, S: int,
                sms: int) -> ChunkPlan:
    """B2 folded: row tiles of L * (H / KV) rows per (batch row, kv head),
    over the S slots of the cache."""
    return chunk_plan(B * KV * -(-L * (H // KV) // CHUNK_ROWS),
                      -(-S // CHUNK_KEYS), sms)


def shared_prefix_plan(B: int, L: int, H: int, KV: int, P: int,
                       sms: int) -> ChunkPlan:
    """B5: row tiles of B * L * (H / KV) rows per kv head; the P prefix
    keys split (the suffix walks with the last split)."""
    return chunk_plan(KV * -(-B * L * (H // KV) // CHUNK_ROWS),
                      -(-P // CHUNK_KEYS), sms)


def _split_args(plan: ChunkPlan, device, stream: int):
    """(workspace, C arguments) of a launch: for a split launch the f32
    partials (written before they are read; the caller holds the tensor
    until it has launched) and the arguments workspace, its bytes and the
    counters; for one split (None, zeros)."""
    if plan.splits == 1:
        return None, (0, 0, 0)
    ws = torch.empty(plan.workspace_floats, dtype=torch.float32,
                     device=device)
    counters = _arrival_counters(device, stream, plan.groups)
    return ws, (ws.data_ptr(), ws.numel() * 4, counters.data_ptr())


def _check_dtype(name: str, device, dtype, **tensors) -> None:
    for arg, t in tensors.items():
        if t.dtype != dtype or not t.is_contiguous() \
                or t.device != device or t.data_ptr() % 16:
            raise ValueError(f"{name}: {arg} must be a contiguous, 16-byte "
                             f"aligned {dtype} tensor on {device}")


def _check_bf16(name: str, device, **tensors) -> None:
    _check_dtype(name, device, torch.bfloat16, **tensors)


def _int32(t: torch.Tensor, device) -> torch.Tensor:
    return t.to(device=device, dtype=torch.int32).contiguous()


def _stream(device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          lengths: Optional[torch.Tensor] = None,
                          causal: bool = True) -> torch.Tensor:
    return mha_reference(q, k, v, causal=causal, kv_len=lengths)


def rows_len(L: int) -> int:
    """L rounded up to 4: f32 rows of a TMA map need 16-byte strides (B6's
    C entry assumes the same length)."""
    return -(-L // 4) * 4


def bwd_rows(lse: torch.Tensor, delta: torch.Tensor) -> torch.Tensor:
    """B6's per-row inputs in one f32 (B, H, 2, rows_len(L)) tensor: lse *
    log2(e) (the kernel's exponentials are base 2), then delta; zero past
    L."""
    B, H, L = lse.shape
    rows = torch.zeros(B, H, 2, rows_len(L), dtype=torch.float32,
                       device=lse.device)
    rows[:, :, 0, :L] = lse * LOG2E
    rows[:, :, 1, :L] = delta
    return rows


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
    if lengths is None:
        lengths = torch.full((q.shape[0],), k.shape[1], dtype=torch.int32,
                             device=q.device)
    if q.shape[-1] == 256:
        from video3d_tpu_torch.kernels import attention_hd256

        return attention_hd256.prefill_hd256(q, k, v, lengths, causal)
    out, _ = _fwd_launch(_build.library(), _stream(q.device), q, k, v,
                         lengths, causal, with_lse=False)
    return out


def _fwd_launch(lib, stream: int, q, k, v, lengths, causal: bool,
                with_lse: bool):
    """Launch B2's prefill form (``with_lse``: its training instantiation)
    through ``lib``: (out, lse or None)."""
    name = "flash_attention_lse" if with_lse else "flash_attention"
    B, L, H, hd = _check_train(name, q, k, v)
    KV = k.shape[2]
    lengths = _int32(lengths, q.device)
    out = torch.empty_like(q)
    lse = torch.empty(B, H, L, dtype=torch.float32, device=q.device) \
        if with_lse else None
    ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), lengths.data_ptr(),
            out.data_ptr()) + ((lse.data_ptr(),) if with_lse else ())
    err = getattr(lib, "v3d_" + name)(
        *ptrs, B, L, L, H, KV, int(causal),
        float(hd ** -0.5), stream)
    _build.check(err, name)
    _build.count_launch(name)
    return out, lse


def flash_attention_gqa_folded_plain(q: torch.Tensor, k_all: torch.Tensor,
                                     v_all: torch.Tensor,
                                     lengths: torch.Tensor,
                                     q_offsets: torch.Tensor, layer: int,
                                     kv_heads: int,
                                     k_scale: Optional[torch.Tensor] = None,
                                     v_scale: Optional[torch.Tensor] = None
                                     ) -> torch.Tensor:
    L = q.shape[1]
    kl, vl = layer_kv(q, k_all, v_all, layer, kv_heads, k_scale, v_scale)
    q_positions = q_offsets.to(device=q.device, dtype=torch.long)[:, None] \
        + torch.arange(L, device=q.device)
    return mha_reference(q, kl, vl, q_positions=q_positions, kv_len=lengths)


def flash_attention_gqa_folded(q: torch.Tensor, k_all: torch.Tensor,
                               v_all: torch.Tensor, lengths: torch.Tensor,
                               q_offsets: torch.Tensor, layer: int,
                               kv_heads: int,
                               k_scale: Optional[torch.Tensor] = None,
                               v_scale: Optional[torch.Tensor] = None
                               ) -> torch.Tensor:
    """Causal cached-chunk attention with the GQA group folded into the
    query rows, so each kv head's cache streams once for all its query
    heads.

    q (B, L, H, hd): query r of row b sits at absolute position
    ``q_offsets[b] + r``. Keys come from ``layer`` of the stacked flat
    (layers, B, S, KV*hd) cache, bf16, or int8 (or packed int4, KV*hd / 2
    uint8 bytes per row) with the stacked (layers, B, S, KV, 1) f32 scales
    ``k_scale``/``v_scale``; slot s is valid when
    s <= the query's position and s < ``lengths[b]``. Returns (B, L, H, hd)
    in q's dtype.
    """
    if q.device.type == "cpu":
        return flash_attention_gqa_folded_plain(q, k_all, v_all, lengths,
                                                q_offsets, layer, kv_heads,
                                                k_scale, v_scale)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention_gqa_folded: no kernel for device "
                         f"{q.device}")
    if q.shape[-1] == 256:
        from video3d_tpu_torch.kernels import attention_hd256

        return attention_hd256.folded_hd256(q, k_all, v_all, lengths,
                                            q_offsets, layer, kv_heads,
                                            k_scale, v_scale)
    return _folded_launch(_build.library(), _stream(q.device),
                          _sm_count(q.device.index or 0), q, k_all, v_all,
                          lengths, q_offsets, layer, kv_heads, k_scale,
                          v_scale)


def _folded_launch(lib, stream: int, sms: int, q, k_all, v_all, lengths,
                   q_offsets, layer: int, kv_heads: int, k_scale, v_scale):
    """Launch B2 folded through ``lib`` on ``sms`` SMs: the form the cache
    asks for, its split plan and workspace."""
    B, L, H, hd = q.shape
    NL, Bc, S, _ = k_all.shape
    form = check_cache("flash_attention_gqa_folded", q, k_all, v_all,
                       k_scale, v_scale, kv_heads)
    if (hd != HEAD_DIM or Bc != B
            or v_all.shape != k_all.shape or H % kv_heads
            or not 0 <= layer < NL):
        raise ValueError(f"flash_attention_gqa_folded: unsupported shapes q "
                         f"{tuple(q.shape)} cache {tuple(k_all.shape)} "
                         f"layer {layer} kv_heads {kv_heads}")
    lengths, q_offsets = _int32(lengths, q.device), _int32(q_offsets, q.device)
    plan = folded_plan(B, L, H, kv_heads, S, sms)
    ws, split_args = _split_args(plan, q.device, stream)
    out = torch.empty_like(q)
    name = "flash_attention_folded" + form
    scales = (k_scale.data_ptr(), v_scale.data_ptr()) if form else ()
    err = getattr(lib, "v3d_" + name)(
        q.data_ptr(), k_all.data_ptr(), v_all.data_ptr(), *scales,
        lengths.data_ptr(), q_offsets.data_ptr(), out.data_ptr(), layer, B, L,
        S, H, kv_heads, float(hd ** -0.5), *split_args, plan.splits, stream)
    _build.check(err, name)
    _build.count_launch(name)
    return out


def flash_attention_shared_prefix(q: torch.Tensor, pk: torch.Tensor,
                                  pv: torch.Tensor, sk: torch.Tensor,
                                  sv: torch.Tensor, suffix_lens: torch.Tensor,
                                  pk_scale: Optional[torch.Tensor] = None,
                                  pv_scale: Optional[torch.Tensor] = None
                                  ) -> torch.Tensor:
    """Suffix-over-shared-prefix attention: the suffix queries of every
    batch row attend ONE prefix K/V, then their own suffix causally.

    q (B, L, H, hd), query r of row b at position P + r; pk/pv (P, KV, hd)
    with no batch dim, bf16, or int8 (or packed int4, (P, KV, hd / 2)
    uint8) with (P, KV, 1) f32 scales ``pk_scale``/``pv_scale``; sk/sv (B,
    L, KV, hd) the chunk's own bf16
    K/V; suffix_lens (B,) valid suffix keys. Query rows r >= suffix_lens[b]
    are undefined by contract (the kernel applies only the causal mask
    there). Returns (B, L, H, hd) in q's dtype.
    """
    if q.device.type == "cpu":
        return mha_shared_prefix_reference(q, pk, pv, sk, sv, suffix_lens,
                                           pk_scale, pv_scale)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention_shared_prefix: no kernel for "
                         f"device {q.device}")
    if q.shape[-1] == 256:
        from video3d_tpu_torch.kernels import attention_hd256

        return attention_hd256.shared_prefix_hd256(q, pk, pv, sk, sv,
                                                   suffix_lens, pk_scale,
                                                   pv_scale)
    return _shared_prefix_launch(_build.library(), _stream(q.device),
                                 _sm_count(q.device.index or 0), q, pk, pv,
                                 sk, sv, pk_scale, pv_scale)


def _shared_prefix_launch(lib, stream: int, sms: int, q, pk, pv, sk, sv,
                          pk_scale, pv_scale):
    """Launch B5 through ``lib`` on ``sms`` SMs: the form the prefix asks
    for, its split plan and workspace."""
    B, L, H, hd = q.shape
    P, KV = pk.shape[0], pk.shape[1]
    form = CACHE_FORMS.get(pk.dtype)
    _check_bf16("flash_attention_shared_prefix", q.device, q=q, sk=sk, sv=sv)
    if form is None:
        raise ValueError(f"flash_attention_shared_prefix: a {pk.dtype} "
                         f"prefix")
    if form:
        if pk_scale is None or pv_scale is None \
                or pk_scale.shape != (P, KV, 1) \
                or pv_scale.shape != pk_scale.shape:
            raise ValueError("flash_attention_shared_prefix: a quantized "
                             "prefix needs (P, KV, 1) scales")
        _check_dtype("flash_attention_shared_prefix", q.device, torch.float32,
                     pk_scale=pk_scale, pv_scale=pv_scale)
    elif pk_scale is not None or pv_scale is not None:
        raise ValueError("flash_attention_shared_prefix: scales given for a "
                         "bf16 prefix")
    _check_dtype("flash_attention_shared_prefix", q.device, pk.dtype, pk=pk,
                 pv=pv)
    width = hd // 2 if form == "_int4" else hd
    if (hd != HEAD_DIM or pk.shape != (P, KV, width) or pv.shape != pk.shape
            or sk.shape != (B, L, KV, hd) or sv.shape != sk.shape
            or H % KV):
        raise ValueError(f"flash_attention_shared_prefix: unsupported shapes "
                         f"q {tuple(q.shape)} prefix {tuple(pk.shape)} "
                         f"suffix {tuple(sk.shape)}")
    plan = shared_prefix_plan(B, L, H, KV, P, sms)
    ws, split_args = _split_args(plan, q.device, stream)
    out = torch.empty_like(q)
    name = "shared_prefix_attention" + form
    scales = (pk_scale.data_ptr(), pv_scale.data_ptr()) if form else ()
    err = getattr(lib, "v3d_" + name)(
        q.data_ptr(), pk.data_ptr(), pv.data_ptr(), *scales, sk.data_ptr(),
        sv.data_ptr(), out.data_ptr(), B, L, P, H, KV, float(hd ** -0.5),
        *split_args, plan.splits, stream)
    _build.check(err, name)
    _build.count_launch(name)
    return out


# ---------------------------------------------------------------------------
# Training: B2 with the logsumexp, B6, and the autograd Function
# ---------------------------------------------------------------------------

def _allowed(B: int, L: int, S: int, lengths: torch.Tensor, causal: bool,
             device) -> torch.Tensor:
    """(B, L, S) mask of the prefill form: key s < lengths[b] and, causal,
    s <= query row (L == S, query offset 0)."""
    slots = torch.arange(S, device=device)
    allow = (slots[None, None, :] < lengths.to(device)[:, None, None]) \
        .expand(B, L, S)
    if causal:
        allow = allow & (slots[None, :] <= torch.arange(L, device=device)[
            :, None])[None]
    return allow


def flash_attention_fwd_plain(q: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor, lengths: torch.Tensor,
                              causal: bool = True
                              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of the training forward: (out, lse). ``out`` is
    ``mha_reference``'s; lse (B, H, L) f32 is the logsumexp of the masked
    scaled scores, computed in f32 one head at a time."""
    out = mha_reference(q, k, v, causal=causal, kv_len=lengths)
    B, L, H, hd = q.shape
    S, KV = k.shape[1], k.shape[2]
    allow = _allowed(B, L, S, lengths, causal, q.device)
    lse = torch.empty(B, H, L, dtype=torch.float32, device=q.device)
    for h in range(H):
        s = torch.einsum("bld,bsd->bls", q[:, :, h].float(),
                         k[:, :, h // (H // KV)].float()) * hd ** -0.5
        lse[:, h] = torch.logsumexp(s.masked_fill(~allow, NEG_INF), dim=-1)
    return out, lse


def flash_attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        lengths: torch.Tensor, causal: bool = True
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Training forward of the prefill form: q (B, L, H, hd), k/v (B, L, KV,
    hd) -> (out (B, L, H, hd) in q's dtype, lse (B, H, L) f32). B2's
    ``kLse`` instantiation on the GPU (hd 256: that of
    ``csrc/flash_attention_hd256.cu``), the plain version on the CPU."""
    if q.device.type == "cpu":
        return flash_attention_fwd_plain(q, k, v, lengths, causal)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention_fwd: no kernel for device "
                         f"{q.device}")
    if q.shape[-1] == 256:
        from video3d_tpu_torch.kernels import attention_hd256

        return attention_hd256.prefill_lse_hd256(q, k, v, lengths, causal)
    return _fwd_launch(_build.library(), _stream(q.device), q, k, v, lengths,
                       causal, with_lse=True)


def flash_attention_bwd_plain(q: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor, out: torch.Tensor,
                              lse: torch.Tensor, do: torch.Tensor,
                              lengths: torch.Tensor, causal: bool = True
                              ) -> Tuple[torch.Tensor, torch.Tensor,
                                         torch.Tensor]:
    """Plain version of B6: the JAX recurrences
    (``video3d_tpu/kernels/flash_attention.py:7-11``, ``:332-408``) step by
    step in f32, one query head at a time: delta = rowsum(dO * O),
    P = exp(sm_scale Q K^T - lse) on the allowed keys, dP = dO V^T,
    dS = P * (dP - delta) * sm_scale, dQ = dS K, per-head dK = dS^T Q and
    dV = P^T dO, then the sum over each kv head's group. Returns (dq, dk,
    dv) in the dtypes of q, k and v."""
    B, L, H, hd = q.shape
    S, KV = k.shape[1], k.shape[2]
    G = H // KV
    scale = hd ** -0.5
    allow = _allowed(B, L, S, lengths, causal, q.device)
    delta = (do.float() * out.float()).sum(-1)            # (B, L, H)
    dq = torch.empty(B, L, H, hd, dtype=torch.float32, device=q.device)
    dk = torch.zeros(B, S, KV, hd, dtype=torch.float32, device=q.device)
    dv = torch.zeros_like(dk)
    for h in range(H):
        qh, doh = q[:, :, h].float(), do[:, :, h].float()
        kh, vh = k[:, :, h // G].float(), v[:, :, h // G].float()
        s = torch.einsum("bld,bsd->bls", qh, kh) * scale
        p = torch.where(allow, torch.exp(s - lse[:, h, :, None]),
                        torch.zeros((), device=q.device))
        dp = torch.einsum("bld,bsd->bls", doh, vh)
        ds = p * (dp - delta[:, :, h, None]) * scale
        dq[:, :, h] = torch.einsum("bls,bsd->bld", ds, kh)
        dk[:, :, h // G] += torch.einsum("bls,bld->bsd", ds, qh)
        dv[:, :, h // G] += torch.einsum("bls,bld->bsd", p, doh)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def flash_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        out: torch.Tensor, lse: torch.Tensor,
                        do: torch.Tensor, lengths: torch.Tensor,
                        causal: bool = True
                        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Backward of :func:`flash_attention_fwd`: (dq, dk, dv). On the GPU,
    delta = rowsum(dO * O) in f32 (outside the kernel, as JAX computes
    it), then B6, which sums each kv head's group inside (hd 256:
    ``attention_hd256.bwd_hd256``, over a split of each group's heads);
    the plain version on the CPU."""
    if q.device.type == "cpu":
        return flash_attention_bwd_plain(q, k, v, out, lse, do, lengths,
                                         causal)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention_bwd: no kernel for device "
                         f"{q.device}")
    if q.shape[-1] == 256:
        from video3d_tpu_torch.kernels import attention_hd256

        return attention_hd256.bwd_hd256(q, k, v, do, lse,
                                         bwd_delta(out, do), lengths, causal)
    return _bwd_launch(_build.library(), _stream(q.device), q, k, v, do, lse,
                       bwd_delta(out, do), lengths, causal)


def bwd_delta(out: torch.Tensor, do: torch.Tensor) -> torch.Tensor:
    """delta (B, H, L) f32 = rowsum(dO * O) of (B, L, H, hd) tensors, the
    products in f32 (one f32 copy of dO, multiplied in place)."""
    prod = do.to(torch.float32, copy=True)
    prod.mul_(out)
    return prod.sum(-1).transpose(1, 2).contiguous()


def _bwd_launch(lib, stream: int, q, k, v, do, lse, delta, lengths,
                causal: bool):
    """Launch B6 through ``lib``: (dq, dk, dv) bf16. dQ is summed over the
    key tiles by TMA reduce-adds into a zeroed (B, L, H, hd) f32 scratch,
    rounded to bf16 after."""
    name = "flash_attention_bwd"
    B, L, H, hd = _check_train(name, q, k, v)
    KV = k.shape[2]
    _check_bf16(name, q.device, do=do)
    _check_dtype(name, q.device, torch.float32, lse=lse, delta=delta)
    if do.shape != q.shape or lse.shape != (B, H, L) \
            or delta.shape != lse.shape:
        raise ValueError(f"{name}: do / lse / delta shapes")
    lengths = _int32(lengths, q.device)
    rows = bwd_rows(lse, delta)
    dq = torch.zeros(B, L, H, hd, dtype=torch.float32, device=q.device)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    err = lib.v3d_flash_attention_bwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
        rows.data_ptr(), lengths.data_ptr(), dq.data_ptr(), dk.data_ptr(),
        dv.data_ptr(), B, L, L, H, KV, int(causal),
        float(hd ** -0.5), stream)
    _build.check(err, name)
    _build.count_launch(name)
    return dq.to(q.dtype), dk, dv


def _check_train(name: str, q: torch.Tensor, k: torch.Tensor,
                 v: torch.Tensor):
    B, L, H, hd = q.shape
    _check_bf16(name, q.device, q=q, k=k, v=v)
    if hd != HEAD_DIM or v.shape != k.shape or k.shape[0] != B \
            or k.shape[1] != L or H % k.shape[2]:
        raise ValueError(f"{name}: unsupported shapes q {tuple(q.shape)} "
                         f"k {tuple(k.shape)}")
    return B, L, H, hd


class FlashAttentionFunction(torch.autograd.Function):
    """Causal / length-masked prefill attention with its gradient: B2 with
    the logsumexp forward, B6 backward (plain versions on the CPU). The
    counterpart of the JAX ``_flash_core`` custom VJP; ``lengths`` and
    ``causal`` get no gradient."""

    @staticmethod
    def forward(ctx, q, k, v, lengths, causal):
        out, lse = flash_attention_fwd(q, k, v, lengths, causal)
        ctx.save_for_backward(q, k, v, out, lse, lengths)
        ctx.causal = causal
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse, lengths = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, out, lse, do.contiguous(),
                                         lengths, ctx.causal)
        return dq, dk, dv, None, None


def flash_attention_train(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          lengths: Optional[torch.Tensor] = None,
                          causal: bool = True) -> torch.Tensor:
    """Differentiable :func:`flash_attention`: q (B, L, H, hd), k/v (B, L,
    KV, hd), keys at s >= lengths[b] masked -> (B, L, H, hd)."""
    if lengths is None:
        lengths = torch.full((q.shape[0],), k.shape[1], dtype=torch.int32,
                             device=q.device)
    return FlashAttentionFunction.apply(q, k, v, lengths, causal)
