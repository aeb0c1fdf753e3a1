"""Weight-streaming products with quantized weights and their plain PyTorch
versions: kernel B4 (int8, ``_int8_mv_kernel`` at one row and
``_int8_kernel`` at 1-32 rows) and kernel B8 (int4, ``_int4_kernel``).

Each wrapper dispatches on the device of ``x``: a CPU tensor runs the plain
version; a CUDA tensor launches the kernel or raises. Counterpart of
``video3d_tpu/kernels/quant_matvec.py``:

* :func:`int8_matvec` -- B4's one-row form (``csrc/int8_matvec.cu``), the
  B=1 vocab head: the template's one-row instantiation, its units cut by
  their bytes (:func:`matvec_plan`), f32 products on the CUDA cores;
* :func:`int8_matmul` -- B4's B>1 form (``csrc/int8_matmul.cu``), 1-32
  rows, the int8 configuration's decode projections;
* :func:`int4_matmul` -- B8 (``csrc/int4_matmul.cu``), 1-32 rows, every
  int4 decode projection and head.

The three share one Hopper template (``csrc/weight_stream.cuh``) that
streams the weight through a TMA ring in shared memory and reads each byte
from HBM once for all rows of x; B4's B>1 form and B8 unpack it in
registers into the A operand of bf16 tensor-core products.
:func:`stream_plan` cuts the work (column tiles x K-slices) evenly over at
most one CTA per SM; the kernel merges split tiles itself, through a
per-stream workspace and arrival counters (``_launch``).
"""

from __future__ import annotations

import bisect
import ctypes
import functools
from dataclasses import dataclass
from typing import List, Tuple

import torch

from video3d_tpu_torch.kernels import _build, _launch

# The streaming template (csrc/weight_stream.cuh): output columns per tile,
# warp pairs per tile (one 128-column subtile each, with its own arrival
# counter), inputs per ring stage by weight bits, rows of x it takes, and
# the f32 sums of one workspace slot per 8 rows of x
STREAM_TILE = 512
STREAM_PAIRS = 4
STAGE_INPUTS = {8: 64, 4: 128}
MAX_ROWS = 32
SLOT_FLOATS = STREAM_PAIRS * 1024
# The plan's cost model, in microseconds, measured on an H100 80GB HBM3 at
# 700 W with a timestamped copy of the kernel: one SM's consumer warps take
# about 30 (int8) / 22 (int4) KB of weight per us and the card about 2900
# KB per us in all; a split tile costs its CTAs' arrivals (a gpu-scope
# fence and an atomic, ~1.3 us) and its last CTA's reads of the K-slices,
# ~100 KB per us.
SM_KB_PER_US = {8: 30.0, 4: 22.0}
CARD_KB_PER_US = 2900.0
ARRIVE_US = 1.3
MERGE_KB_PER_US = 100.0
#: the plan takes the largest grid within this share of the least cost
COST_SLACK = 0.05


def pack_int4(q: torch.Tensor, dim: int = 0) -> torch.Tensor:
    """int8 values in [-7, 7] -> int8 bytes with ``dim`` halved: byte p
    holds index 2p in its low nibble and 2p + 1 in its high nibble, each
    two's complement. ``dim=0``: the (in, out) int4 weights (JAX
    ``quantize_weight_int4``); ``dim=-1``: the int4 KV cache, two channels
    of a token row per byte."""
    d = dim % q.dim()
    pairs = q.unflatten(d, (q.shape[d] // 2, 2))
    return (pairs.select(d + 1, 0) & 0x0F) | (pairs.select(d + 1, 1) << 4)


def unpack_int4(packed: torch.Tensor, dim: int = 0) -> torch.Tensor:
    """The inverse of :func:`pack_int4` (int8 or uint8 bytes) -> int8
    values in [-7, 7] with ``dim`` doubled, as the JAX ``unpack_int4``
    along dim 0: index 2p from the low nibble of byte p, 2p + 1 from its
    high nibble, each sign-extended."""
    c = packed.to(torch.int32)
    lo = (c << 28) >> 28
    hi = (c << 24) >> 28
    d = dim % packed.dim()
    return torch.stack([lo, hi], dim=d + 1).flatten(d, d + 1).to(torch.int8)


def int8_matmul_plain(x: torch.Tensor, q: torch.Tensor,
                      scale: torch.Tensor) -> torch.Tensor:
    """x (..., in) @ q (in, out) int8 with a (1, out) scale -> (..., out)
    in x's dtype, as the JAX ``int8_matmul`` computes it: the product
    summed in float32, times the float32 scale, rounded once; one row of x
    enters in float32 (``_int8_mv_kernel``), more rows rounded to bf16
    first (``_int8_kernel``)."""
    xf = x.to(torch.float32)
    if x.numel() != x.shape[-1]:
        xf = x.to(torch.bfloat16).to(torch.float32)
    y = (xf @ q.to(torch.float32)) * scale.to(torch.float32)
    return y.to(x.dtype)


def int4_matmul_plain(x: torch.Tensor, packed: torch.Tensor,
                      scales: torch.Tensor, group: int = 512) -> torch.Tensor:
    """x (..., in_p) @ int4-packed (in_p/2, out_p) with (in_p/group, out_p)
    scales -> (..., out_p) in x's dtype, as ``_int4_kernel`` computes it: x
    rounded to bf16, one float32 product per input group of the bf16 rows
    against the group's nibbles, each times that group's float32 scale,
    summed in float32, rounded once."""
    *lead, in_p = x.shape
    n_g, out_p = scales.shape
    xg = x.reshape(-1, n_g, group).to(torch.bfloat16).to(torch.float32)
    nib = unpack_int4(packed).to(torch.float32).reshape(n_g, group, out_p)
    part = torch.bmm(xg.transpose(0, 1), nib)            # (n_g, rows, out_p)
    y = (part * scales.to(torch.float32)[:, None, :]).sum(dim=0)
    return y.reshape(*lead, out_p).to(x.dtype)


def _device_checks(name: str, x: torch.Tensor, tensors) -> int:
    """Raise unless x is on a CUDA device and every (arg, tensor, dtype) is
    a contiguous, 16-byte aligned tensor of that dtype on x's device;
    returns the device index. The kernels have no backward, so an input
    that requires grad while autograd records raises too (a result without
    a gradient would silently cut the graph)."""
    if x.device.type != "cuda":
        raise ValueError(f"{name}: no kernel for device {x.device}")
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (x, *(t for _, t, _ in tensors))):
        raise RuntimeError(f"{name}: the kernel has no backward; a "
                           f"product that needs gradients must take the "
                           f"dequantize path")
    index = x.get_device()
    for arg, t, dt in tensors:
        if t.dtype != dt or not t.is_contiguous() \
                or t.get_device() != index or t.data_ptr() % 16:
            raise ValueError(f"{name}: {arg} must be a contiguous, 16-byte "
                             f"aligned {dt} tensor on {x.device}")
    return index


def _stream(index: int) -> int:
    """The current CUDA stream of device ``index``, as a raw handle."""
    return torch._C._cuda_getCurrentRawStream(index)


@dataclass(frozen=True)
class StreamPlan:
    """The grid of a weight-streaming launch: ``tiles`` column tiles of
    STREAM_TILE outputs, each of ``units_per_tile`` K-slice units of
    ``unit_k`` inputs (one ring stage: int8 64, int4 128, inside one scale
    group), and the ``units`` (tile-major) cut into ``ctas`` even
    contiguous ranges, as the kernel cuts them; ``rows`` rows of x, in
    ``row_tiles`` n-tiles of 8. ``begins``: B4's matvec's ranges, which it
    takes from the host, as ``ctas + 1`` first units, the last one
    ``units``; empty for the even cut, which the B>1 kernels compute."""
    tiles: int
    unit_k: int
    units_per_tile: int
    ctas: int
    rows: int
    begins: Tuple[int, ...] = ()

    @property
    def row_tiles(self) -> int:
        return 1 if self.rows <= 8 else 2 if self.rows <= 16 else 4

    @property
    def units(self) -> int:
        return self.tiles * self.units_per_tile

    def unit_begin(self, cta: int) -> int:
        """First unit of CTA ``cta`` (``unit_begin`` in the kernel)."""
        if self.begins:
            return self.begins[cta]
        return cta * self.units // self.ctas

    def slices(self) -> List[Tuple[int, int, int, int]]:
        """(cta, tile, first unit, end unit) of every segment, units
        counted within the tile, in CTA order."""
        out = []
        for c in range(self.ctas):
            u, end = self.unit_begin(c), self.unit_begin(c + 1)
            while u < end:
                tile = u // self.units_per_tile
                t0 = tile * self.units_per_tile
                e = min(end, t0 + self.units_per_tile)
                out.append((c, tile, u - t0, e - t0))
                u = e
        return out

    @property
    def split(self) -> bool:
        """Whether some CTA's range begins inside a tile (its tile then
        merges through the workspace)."""
        return any(self.unit_begin(c) % self.units_per_tile
                   for c in range(1, self.ctas))

    @property
    def workspace_bytes(self) -> int:
        """f32 bytes of the workspace: two slots per CTA; 0 unsplit."""
        if not self.split:
            return 0
        return self.ctas * 2 * SLOT_FLOATS * self.row_tiles * 4

    def max_slices(self) -> int:
        """Most K-slices (CTAs) of one tile."""
        per_tile = {}
        for _, tile, _, _ in self.slices():
            per_tile[tile] = per_tile.get(tile, 0) + 1
        return max(per_tile.values())

    def cost_us(self, bits: int) -> float:
        """The cost model's time: the most units a CTA streams at its
        share of the card, then the arrivals and the longest merge."""
        unit_kb = STREAM_TILE * self.unit_k * bits / 8 / 1024
        rate = min(SM_KB_PER_US[bits], CARD_KB_PER_US / self.ctas)
        stream = -(-self.units // self.ctas) * unit_kb / rate
        if not self.split:
            return stream
        slice_kb = SLOT_FLOATS * self.row_tiles * 4 / 1024
        return stream + ARRIVE_US + \
            self.max_slices() * slice_kb / MERGE_KB_PER_US


@functools.lru_cache(maxsize=None)
def stream_plan(rows: int, in_: int, out: int, sms: int,
                bits: int) -> StreamPlan:
    """Cut y (rows, out) = x (rows, in_) @ W into (column tile, K-slice)
    work for at most one CTA per SM: every CTA streams the same number of
    units, give or take one, so the same bytes within one K-slice; a unit
    is one ring stage, so an int4 slice boundary never falls inside a
    stage, and a stage never straddles two scale groups (groups are
    multiples of 128 inputs). The grid is the largest whose cost
    (``StreamPlan.cost_us``) is within COST_SLACK of the least: more CTAs
    stream faster until the card's rate binds, but cut the tiles into more
    K-slices for their merges to read (wk / wv: one tile)."""
    tiles = -(-out // STREAM_TILE)
    unit_k = STAGE_INPUTS[bits]
    upt = -(-in_ // unit_k)
    plans = [StreamPlan(tiles, unit_k, upt, c, rows)
             for c in range(1, min(sms, tiles * upt) + 1)]
    costs = [plan.cost_us(bits) for plan in plans]
    least = min(costs)
    return [plan for plan, cost in zip(plans, costs)
            if cost <= least * (1 + COST_SLACK)][-1]


def _launch_stream(lib, stream: int, sms: int, name: str, x: torch.Tensor,
                   w: torch.Tensor, scale: torch.Tensor, in_: int, out: int,
                   bits: int, group: int = 512) -> torch.Tensor:
    """Launch a weight-streaming kernel through ``lib`` on ``sms`` SMs: x
    (..., in_) -> (..., out), its plan, and for a split plan the stream's
    workspace and zeroed arrival counters (allocated once per stream)."""
    rows = x.numel() // max(in_, 1)
    if not 1 <= rows <= MAX_ROWS:
        raise ValueError(f"{name}: {rows} rows of x; the kernel takes 1-"
                         f"{MAX_ROWS}")
    extra = (group,) if bits == 4 else ()
    return _launch_plan(lib, stream, name, stream_plan(rows, in_, out, sms,
                                                       bits),
                        x, w, scale, out, (rows, in_, out, *extra))


def _launch_plan(lib, stream: int, name: str, plan: StreamPlan,
                 x: torch.Tensor, w: torch.Tensor, scale: torch.Tensor,
                 out: int, args: tuple) -> torch.Tensor:
    """Launch ``v3d_<name>`` through ``lib`` at ``plan``'s grid: x (...,
    in) -> (..., out), for a split plan the stream's workspace and zeroed
    arrival counters (allocated once per stream), then ``args``, the
    plan's CTAs and the stream."""
    y = torch.empty((*x.shape[:-1], out), dtype=x.dtype, device=x.device)
    split = (0, 0, 0)
    if plan.workspace_bytes:
        ws = _launch.workspace(x.device, stream, plan.workspace_bytes)
        counters = _launch.arrival_counters(x.device, stream,
                                            plan.tiles * STREAM_PAIRS)
        split = (ws.data_ptr(), ws.numel() * 4, counters.data_ptr())
    err = getattr(lib, f"v3d_{name}")(
        x.data_ptr(), w.data_ptr(), scale.data_ptr(), y.data_ptr(), *split,
        *args, plan.ctas, stream)
    _build.check(err, name)
    _build.count_launch(name)
    return y


def _unit_bytes(in_: int, out: int, unit_k: int, upt: int, u: int) -> int:
    """Weight bytes of unit u: its tile's columns x its stage's inputs."""
    tile, stage = divmod(u, upt)
    return min(STREAM_TILE, out - tile * STREAM_TILE) * \
        min(unit_k, in_ - stage * unit_k)


@functools.lru_cache(maxsize=None)
def matvec_plan(in_: int, out: int, sms: int) -> StreamPlan:
    """Cut y (1, out) = x (1, in_) @ q into (column tile, K-slice) units
    for one CTA per SM, each range holding the same weight bytes within one
    unit (a ragged last tile or stage weighs its bytes): CTA c starts at
    the first unit whose bytes before it reach ceil(c x total / ctas). The
    CUDA-core consumers take the bytes faster than one SM's share of HBM
    brings them, so every SM streams, unless the weight holds fewer than
    ``sms`` whole units' bytes (then at least that much a CTA, so no range
    is empty)."""
    tiles = -(-out // STREAM_TILE)
    unit_k = STAGE_INPUTS[8]
    upt = -(-in_ // unit_k)
    units = tiles * upt
    total = in_ * out
    ctas = max(1, min(sms, total // (STREAM_TILE * unit_k)))
    before = [0]
    for u in range(units):
        before.append(before[-1] + _unit_bytes(in_, out, unit_k, upt, u))
    begins = tuple(bisect.bisect_left(before, -(-c * total // ctas))
                   for c in range(ctas + 1))
    return StreamPlan(tiles, unit_k, upt, ctas, 1, begins)


@functools.lru_cache(maxsize=None)
def _begins_buffer(plan: StreamPlan):
    """The plan's ``begins`` as a C int array (kept for the process)."""
    return (ctypes.c_int * len(plan.begins))(*plan.begins)


def _launch_matvec(lib, stream: int, sms: int, x: torch.Tensor,
                   q: torch.Tensor, scale: torch.Tensor, in_: int,
                   out: int) -> torch.Tensor:
    """Launch B4's matvec through ``lib`` on ``sms`` SMs: x (..., in_) of
    one row -> (..., out), at the byte-balanced ranges of its plan."""
    plan = matvec_plan(in_, out, sms)
    return _launch_plan(lib, stream, "int8_matvec", plan, x, q, scale, out,
                        (ctypes.addressof(_begins_buffer(plan)), in_, out))


def int8_matvec(x: torch.Tensor, q: torch.Tensor,
                scale: torch.Tensor) -> torch.Tensor:
    """B4's one-row matvec: x (..., in) with a single row, q (in, out)
    int8, scale (1, out) -> (..., out) in x's dtype."""
    if x.device.type == "cpu":
        return int8_matmul_plain(x, q, scale)
    in_, out = q.shape
    if (x.numel() != in_ or x.shape[-1] != in_ or scale.shape != (1, out)
            or out % 16 or in_ % 8):
        raise ValueError(f"int8_matvec: unsupported shapes x "
                         f"{tuple(x.shape)} q {tuple(q.shape)} scale "
                         f"{tuple(scale.shape)}")
    index = _device_checks("int8_matvec", x, (("x", x, torch.bfloat16),
                                              ("q", q, torch.int8),
                                              ("scale", scale,
                                               torch.bfloat16)))
    return _launch_matvec(_build.library(), _stream(index),
                          _launch.sm_count(index), x, q, scale, in_, out)


def int8_matmul(x: torch.Tensor, q: torch.Tensor,
                scale: torch.Tensor) -> torch.Tensor:
    """B4's B>1 form: x (..., in) with 1-32 rows, q (in, out) int8, scale
    (1, out) -> (..., out) in x's dtype."""
    if x.device.type == "cpu":
        return int8_matmul_plain(x, q, scale)
    in_, out = q.shape
    if (x.shape[-1] != in_ or scale.shape != (1, out) or out % 16
            or in_ % 8):
        raise ValueError(f"int8_matmul: unsupported shapes x "
                         f"{tuple(x.shape)} q {tuple(q.shape)} scale "
                         f"{tuple(scale.shape)}")
    index = _device_checks("int8_matmul", x, (("x", x, torch.bfloat16),
                                              ("q", q, torch.int8),
                                              ("scale", scale,
                                               torch.bfloat16)))
    return _launch_stream(_build.library(), _stream(index),
                          _launch.sm_count(index), "int8_matmul", x, q,
                          scale, in_, out, 8)


def int4_matmul(x: torch.Tensor, packed: torch.Tensor, scales: torch.Tensor,
                group: int = 512) -> torch.Tensor:
    """B8: x (..., in_p) with 1-32 rows @ int4-packed (in_p/2, out_p) with
    (in_p/group, out_p) bf16 scales -> (..., out_p) in x's dtype."""
    if x.device.type == "cpu":
        return int4_matmul_plain(x, packed, scales, group)
    half, out_p = packed.shape
    in_p = 2 * half
    if (x.shape[-1] != in_p or group <= 0 or group % 512 or in_p % group
            or scales.shape != (in_p // group, out_p) or out_p % 16):
        raise ValueError(f"int4_matmul: unsupported shapes x "
                         f"{tuple(x.shape)} packed {tuple(packed.shape)} "
                         f"scales {tuple(scales.shape)} group {group}")
    index = _device_checks("int4_matmul", x, (("x", x, torch.bfloat16),
                                              ("packed", packed, torch.int8),
                                              ("scales", scales,
                                               torch.bfloat16)))
    return _launch_stream(_build.library(), _stream(index),
                          _launch.sm_count(index), "int4_matmul", x, packed,
                          scales, in_p, out_p, 4, group)
