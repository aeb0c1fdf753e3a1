"""HBM stream-rate probes (kernel B9) and their plain PyTorch versions.

Counterpart of the four Pallas probes of the JAX package's benchmark
scripts (``scripts/bench/kv_probe.py:42``, ``int8_matvec.py:55``,
``stream_probe.py:73`` and ``:113``): each reads whole blocks of one or more
arrays with near-zero arithmetic. Every form returns ``(out, checksum)``:

* ``out`` (float32): exactly what the TPU probe wrote, from row 0 of each
  block, ``t`` added first and the streams' values after it, in stream
  order (so the kernel and the plain version agree bit for bit);
* ``checksum`` (int32, the bits of a uint32): per stream and block, the
  wrapping 32-bit sum of the block's 4-byte words. On the TPU the DMA moved
  every byte of a block; on the GPU only what is summed is read.

Forms, each with a launch count of its own in ``_build.LAUNCHES``:

* :func:`kv_probe` (B9a, ``stream_probe_kv``): int8 K and V (S, KV, hd) in
  blocks of ``bs`` tokens; out (S / bs * 8, hd) = t + k[j bs, 0] + v[j bs, 0]
  on the 8 rows of block j; checksum (2, S / bs). Its kernel streams K then
  V as one line of copy units, an even range per SM
  (:func:`kv_probe_plan`), through a ring of bulk copies.
* :func:`matvec_probe` (B9b, ``stream_probe_one``): one (IN, OUT) int8 or
  bf16 weight in (IN, bo) column blocks; out (1, OUT) = t + q[0];
  checksum (1, OUT / bo).
* :func:`stream_probe` (B9c, ``stream_probe_multi``): K int8 weights read
  together, strided (IN, OUT) or pre-tiled contiguous (G, IN, bo)
  (:func:`tile_contig`); out (1, OUT) = t + sum_k q_k[0]; checksum (K, G).
* :func:`split_probe` (B9d, ``stream_probe_split``): K streams over ONE
  (IN, OUT) int8 weight at column offsets j OUT / K; out (K, OUT / K),
  out_j = t + q[0, j OUT/K : (j+1) OUT/K]; checksum (K, OUT / (K bo)), the
  blocks in column order.

A CPU tensor runs the plain version; a CUDA tensor launches
``csrc/stream_probe.cu`` or raises. ``t`` is float32 with one entry or one
per output column (B9a: hd).
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Sequence, Tuple

import torch

from video3d_tpu_torch.kernels import _build
from video3d_tpu_torch.kernels._launch import sm_count

KV_REP = 8            # output rows per block of B9a (the TPU's (8, hd) block)
MAX_STREAMS = 4
_CTA_TARGET = 2048    # CTAs a launch aims for: several waves over 132 SMs
_WARPS = 8            # warps of a CTA (csrc/stream_probe.cu kThreads / 32)
KV_UNIT = 32768       # bytes of one bulk copy of B9a (csrc kUnit)
KV_MAX_CTAS = 256     # csrc kMaxCtas
KV_MAX_TOUCHED = 32   # csrc kMaxTouched: bs blocks one CTA's range touches


def _wrap32(s: torch.Tensor) -> torch.Tensor:
    """int64 sums -> the int32 with the same low 32 bits."""
    s = s & 0xFFFFFFFF
    return torch.where(s >= 2 ** 31, s - 2 ** 32, s).to(torch.int32)


def _block_sums(words: torch.Tensor, skip_last_row: bool) -> torch.Tensor:
    """(blocks, rows, words) int32 -> (blocks,) wrapping sums; the control
    ``skip_last_row`` leaves each block's last row out."""
    if skip_last_row:
        words = words[:, :-1]
    return _wrap32(words.sum((1, 2), dtype=torch.int64))


def _column_words(q: torch.Tensor, nblk: int) -> torch.Tensor:
    """(IN, OUT) -> (nblk, IN, words) int32 view of its column blocks."""
    w = q.contiguous().view(torch.int32)
    return w.view(w.shape[0], nblk, -1).transpose(0, 1)


def tile_contig(q: torch.Tensor, bo: int) -> torch.Tensor:
    """(..., IN, OUT) -> the contiguous (..., OUT / bo, IN, bo) slabs of
    B9c's ``--contig`` layout."""
    *lead, IN, OUT = q.shape
    return q.view(*lead, IN, OUT // bo, bo).transpose(-3, -2).contiguous()


def kv_probe_plain(k: torch.Tensor, v: torch.Tensor, t: torch.Tensor,
                   bs: int, skip_last_row: bool = False):
    S = k.shape[0]
    nj = S // bs
    row = t.float().reshape(1, -1) + k[::bs, 0, :].float()
    row = row + v[::bs, 0, :].float()
    out = row.repeat_interleave(KV_REP, dim=0)
    sums = torch.stack([
        _block_sums(x.contiguous().view(torch.int32).view(nj, bs, -1),
                    skip_last_row) for x in (k, v)])
    return out, sums


class KvProbePlan(NamedTuple):
    """B9a's cut: K then V as one line of ``2 * units_per_stream`` copy
    units of ``unit`` bytes (a bs block holds ``units_per_block``); CTA c
    reads units [begins[c], begins[c + 1])."""
    unit: int
    units_per_stream: int
    units_per_block: int
    begins: Tuple[int, ...]

    @property
    def ctas(self) -> int:
        return len(self.begins) - 1

    def blocks_touched(self, c: int) -> range:
        """The flat checksum indices (K's blocks, then V's) of CTA c's
        range, one atomic add each."""
        upb = self.units_per_block
        return range(self.begins[c] // upb, (self.begins[c + 1] - 1) // upb
                     + 1)


@functools.lru_cache(maxsize=None)
def kv_probe_plan(S: int, KV: int, hd: int, bs: int,
                  sms: int) -> KvProbePlan:
    """The even cut of B9a's K and V over at most ``sms`` CTAs: copy units
    of KV_UNIT bytes, and CTA c from unit c * total // ctas, so ranges
    differ by at most one unit. Pure: computed on the host, the kernel
    divides nothing 64-bit."""
    block = bs * KV * hd
    if S % bs or block % KV_UNIT:
        raise ValueError(f"stream_probe_kv: S {S} bs {bs} KV {KV} hd {hd}: "
                         f"blocks must be whole {KV_UNIT}-byte copy units")
    ups = S * KV * hd // KV_UNIT
    total = 2 * ups
    ctas = min(sms, total, KV_MAX_CTAS)
    return KvProbePlan(KV_UNIT, ups, block // KV_UNIT,
                       tuple(c * total // ctas for c in range(ctas + 1)))


def kv_probe_split_sums(k: torch.Tensor, v: torch.Tensor,
                        plan: KvProbePlan) -> torch.Tensor:
    """A host mirror of the kernel's checksums: each CTA range's wrapping
    sum per block touched (its one atomic add each), added up per block;
    (2, S / bs) int32."""
    words = torch.cat([k.reshape(-1), v.reshape(-1)]).view(torch.int32)
    per_unit = words.view(2 * plan.units_per_stream, -1).sum(
        1, dtype=torch.int64)
    nb = 2 * plan.units_per_stream // plan.units_per_block
    sums = torch.zeros(nb, dtype=torch.int64)
    for c in range(plan.ctas):
        for g in plan.blocks_touched(c):
            lo = max(plan.begins[c], g * plan.units_per_block)
            hi = min(plan.begins[c + 1], (g + 1) * plan.units_per_block)
            sums[g] += int(_wrap32(per_unit[lo:hi].sum()[None])[0])
    return _wrap32(sums).view(2, -1)


def matvec_probe_plain(q: torch.Tensor, t: torch.Tensor, bo: int,
                       skip_last_row: bool = False):
    nblk = q.shape[1] // bo
    out = t.float().reshape(1, 1) + q[0:1].float()
    return out, _block_sums(_column_words(q, nblk), skip_last_row)[None]


def stream_probe_plain(qs: Sequence[torch.Tensor], t: torch.Tensor, bo: int,
                       contig: bool = False, skip_last_row: bool = False):
    acc = t.float().reshape(1, 1)
    sums = []
    for q in qs:
        if contig:
            acc = acc + q[:, 0, :].reshape(1, -1).float()
            words = q.contiguous().view(torch.int32)
        else:
            acc = acc + q[0:1].float()
            words = _column_words(q, q.shape[1] // bo)
        sums.append(_block_sums(words, skip_last_row))
    return acc, torch.stack(sums)


def split_probe_plain(q: torch.Tensor, t: torch.Tensor, bo: int, K: int,
                      skip_last_row: bool = False, shift: int = 0):
    """``shift``: the control reading every stream's columns ``shift``
    blocks late."""
    row = q[0]
    if shift:
        row = torch.roll(row, -shift * bo)
    out = (t.float().reshape(1, 1) + row[None].float()).view(K, -1)
    sums = _block_sums(_column_words(q, q.shape[1] // bo), skip_last_row)
    return out, sums.view(K, -1)


def _row_width(nbytes: int) -> int:
    """Bytes per row of a contiguous block: the largest of 2 KB ... 16 B
    that divides it."""
    w = 2048
    while nbytes % w:
        w //= 2
    return w


def _check(name: str, arrays, dtypes, t: torch.Tensor, t_len: int):
    dev = arrays[0].device
    for a in arrays:
        if a.device != dev or a.dtype not in dtypes or not a.is_contiguous():
            raise ValueError(f"{name}: streams must be contiguous "
                             f"{'/'.join(map(str, dtypes))} on {dev}, got "
                             f"{a.dtype} on {a.device}, contiguous="
                             f"{a.is_contiguous()}")
        if a.data_ptr() % 16:
            raise ValueError(f"{name}: streams must be 16-byte aligned")
    if (t.device != dev or t.dtype != torch.float32
            or not t.is_contiguous() or t.numel() != t_len):
        raise ValueError(f"{name}: t must be {t_len} contiguous float32 on "
                         f"{dev}, got {tuple(t.shape)} {t.dtype} on "
                         f"{t.device}")
    if dev.type != "cuda":
        raise ValueError(f"{name}: no kernel for device {dev}")


def _launch(name: str, streams, t, out, K: int, step_bytes: int,
            stride: int, rows: int, row_bytes: int, nsteps: int, nout: int,
            sum_form: bool, bf16: bool) -> torch.Tensor:
    """B9b-d's launch: one output row per step (the kernel's ``rep`` 1)."""
    if row_bytes % 16 or stride % 16 or step_bytes % 16:
        raise ValueError(f"{name}: rows and blocks must be multiples of 16 "
                         f"bytes (row {row_bytes}, stride {stride}, block "
                         f"step {step_bytes})")
    rpc = min(64, max(_WARPS, rows * nsteps // _CTA_TARGET))
    rpc -= rpc % _WARPS
    checksum = torch.zeros((K, nsteps), dtype=torch.int32,
                           device=t.device)
    ptrs = [s.data_ptr() for s in streams]
    ptrs += [ptrs[0]] * (MAX_STREAMS - len(ptrs))
    err = _build.library().v3d_stream_probe(
        *ptrs, t.data_ptr(), out.data_ptr(), checksum.data_ptr(), K,
        step_bytes, stride, rows, row_bytes // 16, rpc, nsteps, nout, 1,
        int(sum_form), t.numel(), int(bf16),
        torch.cuda.current_stream(t.device).cuda_stream)
    _build.check(err, name)
    _build.count_launch(name)
    return checksum


@functools.lru_cache(maxsize=None)
def _begins_buffer(plan: KvProbePlan):
    """The plan's ``begins`` as a C int array (kept for the process)."""
    return (ctypes.c_int * len(plan.begins))(*plan.begins)


def kv_probe(k: torch.Tensor, v: torch.Tensor, t: torch.Tensor,
             bs: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """B9a: int8 k, v (S, KV, hd), t (hd,) or (1, hd) float32, blocks of
    ``bs`` tokens (S % bs == 0)."""
    if k.device.type == "cpu":
        return kv_probe_plain(k, v, t, bs)
    S, KV, hd = k.shape
    if v.shape != k.shape or S % bs:
        raise ValueError(f"stream_probe_kv: k {tuple(k.shape)} v "
                         f"{tuple(v.shape)} bs {bs}")
    _check("stream_probe_kv", (k, v), (torch.int8,), t, hd)
    plan = kv_probe_plan(S, KV, hd, bs, sm_count(k.device.index or 0))
    out = torch.empty((S // bs * KV_REP, hd), dtype=torch.float32,
                      device=k.device)
    checksum = torch.zeros((2, S // bs), dtype=torch.int32, device=k.device)
    err = _build.library().v3d_kv_probe(
        k.data_ptr(), v.data_ptr(), t.data_ptr(), out.data_ptr(),
        checksum.data_ptr(), ctypes.addressof(_begins_buffer(plan)),
        plan.ctas, plan.units_per_stream, plan.units_per_block, hd,
        torch.cuda.current_stream(k.device).cuda_stream)
    _build.check(err, "stream_probe_kv")
    _build.count_launch("stream_probe_kv")
    return out, checksum


def matvec_probe(q: torch.Tensor, t: torch.Tensor,
                 bo: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """B9b: one (IN, OUT) int8 or bf16 weight in (IN, bo) column blocks,
    t one float32."""
    if q.device.type == "cpu":
        return matvec_probe_plain(q, t, bo)
    IN, OUT = q.shape
    if q.dim() != 2 or OUT % bo:
        raise ValueError(f"stream_probe_one: q {tuple(q.shape)} bo {bo}")
    _check("stream_probe_one", (q,), (torch.int8, torch.bfloat16), t, 1)
    es = q.element_size()
    out = torch.empty((1, OUT), dtype=torch.float32, device=q.device)
    sums = _launch("stream_probe_one", (q,), t, out, 1, bo * es, OUT * es,
                   IN, bo * es, OUT // bo, bo, True,
                   q.dtype == torch.bfloat16)
    return out, sums


def stream_probe(qs: Sequence[torch.Tensor], t: torch.Tensor, bo: int,
                 contig: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
    """B9c: K = len(qs) int8 weights, each (IN, OUT) strided or, with
    ``contig``, (OUT / bo, IN, bo) slabs; t one float32."""
    if qs[0].device.type == "cpu":
        return stream_probe_plain(qs, t, bo, contig)
    K = len(qs)
    shape = qs[0].shape
    if not 1 <= K <= MAX_STREAMS or any(q.shape != shape for q in qs):
        raise ValueError(f"stream_probe_multi: {K} streams of shapes "
                         f"{[tuple(q.shape) for q in qs]}")
    if contig:
        if len(shape) != 3 or shape[2] != bo:
            raise ValueError(f"stream_probe_multi: contig slabs must be "
                             f"(G, IN, {bo}), got {tuple(shape)}")
        G, IN, _ = shape
        block = IN * bo
        width = _row_width(block)
        args = (block, width, block // width, width)
    else:
        if len(shape) != 2 or shape[1] % bo:
            raise ValueError(f"stream_probe_multi: q {tuple(shape)} bo {bo}")
        IN, OUT = shape
        G = OUT // bo
        args = (bo, OUT, IN, bo)
    _check("stream_probe_multi", qs, (torch.int8,), t, 1)
    out = torch.empty((1, G * bo), dtype=torch.float32, device=t.device)
    sums = _launch("stream_probe_multi", qs, t, out, K, *args, G, bo, True,
                   False)
    return out, sums


def split_probe(q: torch.Tensor, t: torch.Tensor, bo: int,
                K: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """B9d: K streams over one (IN, OUT) int8 weight, stream j at column
    j OUT / K, (IN, bo) blocks (OUT % (K bo) == 0); t one float32."""
    if q.device.type == "cpu":
        return split_probe_plain(q, t, bo, K)
    IN, OUT = q.shape
    if q.dim() != 2 or not 1 <= K <= MAX_STREAMS or OUT % (K * bo):
        raise ValueError(f"stream_probe_split: q {tuple(q.shape)} bo {bo} "
                         f"K {K}")
    _check("stream_probe_split", (q,), (torch.int8,), t, 1)
    gk = OUT // (K * bo)
    streams = [q[:, j * gk * bo:] for j in range(K)]
    out = torch.empty((K, OUT // K), dtype=torch.float32, device=q.device)
    sums = _launch("stream_probe_split", streams, t, out, K, bo, OUT, IN, bo,
                   gk, bo, False, False)
    return out, sums
