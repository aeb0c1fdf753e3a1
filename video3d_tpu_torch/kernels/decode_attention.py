"""Single-token decode attention over the stacked flat KV cache (kernel B3)
and its plain PyTorch version.

:func:`decode_attention` dispatches on the device of ``q``: a CPU tensor
runs :func:`decode_attention_plain` (slice the layer, split the heads, then
``mha_reference``); a CUDA tensor launches ``csrc/decode_attention.cu`` or
raises. Counterpart of ``video3d_tpu/kernels/decode_attention.py`` with the
stacked-cache input form (``kv_heads`` given), over a bf16 cache, or an int8
or a packed int4 one with per-position scales (the kernel's int8 and int4
instantiations, counted as ``decode_attention_int8`` / ``_int4``). At
head width 256 every cache form goes through
``kernels/attention_hd256.py``'s ``decode_hd256`` to the same template's
hd-256 instantiations (counted as ``decode_attention_hd256`` and its
``_int8`` / ``_int4``).

B3 and B7 (``paged_attention.py``) share one Hopper kernel
(``csrc/decode_sm90.cuh``): one launch per call, :func:`decode_plan` gives
its grid from the shapes, the head width and the SM count alone (the kernel
reads kv_len on the device and gives each CTA an even share of the live
positions), and rows split over several CTAs merge in the kernel through
the stream's workspace and arrival counters (``_launch``). The wrapper
allocates only the output.
"""

from __future__ import annotations

import functools
import math
from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import torch

from video3d_tpu_torch.kernels import _build, _launch
from video3d_tpu_torch.kernels.attention import cache_values, mha_reference

HEAD_DIM = 128      # the kernel's head width here (256: attention_hd256)
MAX_GROUP = 8       # query heads per kv head (csrc kMaxG)
MAX_SPLITS = 256    # CTAs per kv head (csrc kMaxSplits)
#: hd 256: a row of more slices than TREE_MIN merges in two levels, in at
#: most MAX_GROUPS groups (csrc kTreeMin, kMaxGroups; :func:`group_size`)
TREE_MIN = 12
MAX_GROUPS = 16


def group_size(n: int) -> int:
    """hd 256: the slices of a row of ``n`` merge in groups of this many
    consecutive ones (merge order), then the groups' partials in group
    order: ceil(sqrt(n)) where n > TREE_MIN, else all n in one group
    (csrc group_size)."""
    if n <= TREE_MIN:
        return n
    return math.isqrt(n - 1) + 1


def part_floats(head_dim: int = HEAD_DIM) -> int:
    """f32 of one split's (m, l, O) for MAX_GROUP heads of ``head_dim``
    (csrc part_floats)."""
    return 2 * MAX_GROUP + MAX_GROUP * head_dim


#: f32 of one split's (m, l, O) at head width 128
PART_FLOATS = part_floats()
#: a cache's storage dtype -> the name suffix of its kernel instantiation
#: (int4 values are packed two per uint8 byte)
CACHE_FORMS = {torch.bfloat16: "", torch.int8: "_int8", torch.uint8: "_int4"}


@dataclass(frozen=True)
class DecodePlan:
    """The grid of a B3 or B7 launch: ``splits`` CTAs for each of
    ``kv_heads`` kv heads over ``batch`` rows of ``cap`` positions. The
    kernel lays the rows' live positions (kv_len, clamped to [0, cap]) end
    to end and gives CTA c positions [c T / splits, (c + 1) T / splits)
    (:meth:`ranges`); a row touched by several CTAs merges through two
    workspace slots per CTA (slices of ``part_floats(head_dim)`` f32) and
    one arrival counter per (row, kv head); at head width 256 the slices
    merge in two levels (:func:`group_size`), with MAX_GROUPS more counters
    per (row, kv head) after those."""
    batch: int
    kv_heads: int
    cap: int
    splits: int
    head_dim: int = HEAD_DIM

    @property
    def ctas(self) -> int:
        return self.splits * self.kv_heads

    @property
    def workspace_bytes(self) -> int:
        return 2 * self.ctas * part_floats(self.head_dim) * 4

    @property
    def counters(self) -> int:
        return self.batch * self.kv_heads * (
            1 + (MAX_GROUPS if self.head_dim == 256 else 0))

    def lens(self, kv_len: Sequence[int]) -> List[int]:
        return [min(max(int(n), 0), self.cap) for n in kv_len]

    def ranges(self, kv_len: Sequence[int]) -> List[Tuple[int, int]]:
        """Each CTA's [p0, p1) of the line of live positions."""
        total = sum(self.lens(kv_len))
        return [(c * total // self.splits, (c + 1) * total // self.splits)
                for c in range(self.splits)]

    def cta_of(self, x: int, total: int) -> int:
        """The CTA whose range holds position x of the line (the kernel's
        ``Walk::cta_of``)."""
        return ((x + 1) * self.splits - 1) // total

    def slices(self, kv_len: Sequence[int]) -> List[List[int]]:
        """Per row, the CTAs whose slices the kernel merges, in merge order
        (its ``slice_cta``): every CTA from the row's first to its last
        while each CTA holds a position, else (fewer live positions than
        CTAs, some ranges empty) the CTA of each of the row's positions;
        [] for a row that one CTA holds whole, or that has no position."""
        lens = self.lens(kv_len)
        total = sum(lens)
        out, base = [], 0
        for n in lens:
            first = self.cta_of(base, total) if n else 0
            last = self.cta_of(base + n - 1, total) if n else 0
            if first == last:
                out.append([])
            elif total >= self.splits:
                out.append(list(range(first, last + 1)))
            else:
                out.append([self.cta_of(base + k, total) for k in range(n)])
            base += n
        return out

    def segments(self, kv_len: Sequence[int]
                 ) -> List[Tuple[int, int, int, int]]:
        """(cta, row, s0, s1) of every segment, positions [s0, s1) of the
        row, in CTA order: the kernel's walk."""
        lens = self.lens(kv_len)
        out = []
        for c, (p0, p1) in enumerate(self.ranges(kv_len)):
            acc = 0
            for b, n in enumerate(lens):
                s0, s1 = max(p0, acc), min(p1, acc + n)
                if s0 < s1:
                    out.append((c, b, s0 - acc, s1 - acc))
                acc += n
        return out


@functools.lru_cache(maxsize=None)
def decode_plan(batch: int, kv_heads: int, cap: int, sms: int,
                head_dim: int = HEAD_DIM) -> DecodePlan:
    """One CTA per SM (its ~165-180 KB of rings allows no second): sms //
    kv_heads splits per kv head, at least one and no more than a full
    cache's positions or MAX_SPLITS, at either head width (at 256 a row's
    slices merge in two levels, so that Gemma's one kv head can take all
    132 SMs). Nothing here depends on kv_len, which stays on the device."""
    return DecodePlan(batch, kv_heads, cap,
                      max(1, min(sms // kv_heads, batch * cap, MAX_SPLITS)),
                      head_dim)


def split_args(plan: DecodePlan, device, stream: int):
    """The C arguments workspace, its bytes and the counters of a launch:
    the stream's buffers (``_launch``), allocated once per stream."""
    ws = _launch.workspace(device, stream, plan.workspace_bytes)
    counters = _launch.arrival_counters(device, stream, plan.counters)
    return ws.data_ptr(), ws.numel() * 4, counters.data_ptr()


def _stream(device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def layer_kv(q: torch.Tensor, k_all: torch.Tensor, v_all: torch.Tensor,
             layer: int, kv_heads: int,
             k_scale: Optional[torch.Tensor] = None,
             v_scale: Optional[torch.Tensor] = None):
    """Head-split (B, S, KV, hd) K and V of ``layer`` of the stacked flat
    cache in q's dtype; a quantized cache (int8, or packed int4 unpacked
    first) is dequantized with its stacked (layers, B, S, KV, 1) scales in
    q's dtype, as the JAX package's plain path does
    (``video3d_tpu/kernels/attention.py:217-220``)."""
    B, hd = q.shape[0], q.shape[-1]
    S = k_all.shape[2]
    kl = cache_values(k_all[layer]).reshape(B, S, kv_heads, hd).to(q.dtype)
    vl = cache_values(v_all[layer]).reshape(B, S, kv_heads, hd).to(q.dtype)
    if k_scale is not None:
        kl = kl * k_scale[layer].to(q.dtype)
        vl = vl * v_scale[layer].to(q.dtype)
    return kl, vl


def decode_attention_plain(q: torch.Tensor, k_all: torch.Tensor,
                           v_all: torch.Tensor, kv_len: torch.Tensor,
                           layer: int, kv_heads: int,
                           k_scale: Optional[torch.Tensor] = None,
                           v_scale: Optional[torch.Tensor] = None
                           ) -> torch.Tensor:
    kl, vl = layer_kv(q, k_all, v_all, layer, kv_heads, k_scale, v_scale)
    return mha_reference(q, kl, vl, q_positions=(kv_len - 1)[:, None],
                         kv_len=kv_len)


def check_cache(name: str, q: torch.Tensor, k_all: torch.Tensor,
                v_all: torch.Tensor, k_scale: Optional[torch.Tensor],
                v_scale: Optional[torch.Tensor], kv_heads: int) -> str:
    """Raise unless q is bf16 and the stacked cache is bf16 without scales,
    or int8 or packed int4 (uint8) with (layers, B, S, KV, 1) f32 scales,
    all contiguous, 16-byte aligned and on q's device, and its rows are
    KV * hd values wide (KV * hd / 2 bytes packed). Returns the kernel's
    name suffix (:data:`CACHE_FORMS`)."""
    form = CACHE_FORMS.get(k_all.dtype)
    tensors = [("q", q, torch.bfloat16), ("k_all", k_all, k_all.dtype),
               ("v_all", v_all, k_all.dtype)]
    if form is None or (form == "") != (k_scale is None):
        raise ValueError(f"{name}: the cache must be bf16 without scales, "
                         f"or int8 or packed int4 (uint8) with scales")
    if form:
        if v_scale is None or \
                k_scale.shape != (*k_all.shape[:3], kv_heads, 1) or \
                v_scale.shape != k_scale.shape:
            raise ValueError(f"{name}: a quantized cache needs (layers, B, "
                             f"S, KV, 1) scales")
        tensors += [("k_scale", k_scale, torch.float32),
                    ("v_scale", v_scale, torch.float32)]
    width = kv_heads * q.shape[-1] // (2 if form == "_int4" else 1)
    if k_all.shape[-1] != width:
        raise ValueError(f"{name}: cache rows of {k_all.shape[-1]} entries "
                         f"for {kv_heads} kv heads of {q.shape[-1]} "
                         f"({k_all.dtype})")
    for arg, t, dt in tensors:
        if t.dtype != dt or not t.is_contiguous() or t.device != q.device \
                or t.data_ptr() % 16:
            raise ValueError(f"{name}: {arg} must be a contiguous, 16-byte "
                             f"aligned {dt} tensor on {q.device}")
    return form


def decode_attention(q: torch.Tensor, k_all: torch.Tensor,
                     v_all: torch.Tensor, kv_len: torch.Tensor,
                     layer: int, kv_heads: int,
                     k_scale: Optional[torch.Tensor] = None,
                     v_scale: Optional[torch.Tensor] = None) -> torch.Tensor:
    """q (B, 1, H, hd); k_all/v_all the stacked (layers, B, S, KV*hd) cache,
    bf16, or int8 (or packed int4: (layers, B, S, KV*hd / 2) uint8) with the
    stacked (layers, B, S, KV, 1) f32 scales ``k_scale``/``v_scale``;
    kv_len (B,) valid slots of each row (the new
    token sits at kv_len - 1). Returns (B, 1, H, hd) in q's dtype."""
    if q.device.type == "cpu":
        return decode_attention_plain(q, k_all, v_all, kv_len, layer,
                                      kv_heads, k_scale, v_scale)
    if q.device.type != "cuda":
        raise ValueError(f"decode_attention: no kernel for device {q.device}")
    B, L, H, hd = q.shape
    NL, Bc, S, _ = k_all.shape
    form = check_cache("decode_attention", q, k_all, v_all, k_scale,
                       v_scale, kv_heads)
    if hd == 256:
        from video3d_tpu_torch.kernels import attention_hd256

        return attention_hd256.decode_hd256(q, k_all, v_all, kv_len, layer,
                                            kv_heads, k_scale, v_scale)
    if (L != 1 or hd != HEAD_DIM or Bc != B
            or v_all.shape != k_all.shape or H % kv_heads
            or H // kv_heads > MAX_GROUP or not 0 <= layer < NL
            or kv_len.shape != (B,)):
        raise ValueError(f"decode_attention: unsupported shapes q "
                         f"{tuple(q.shape)} cache {tuple(k_all.shape)} "
                         f"layer {layer} kv_heads {kv_heads}")
    kv_len = kv_len.to(device=q.device, dtype=torch.int32).contiguous()
    return _launch_decode(_build.library(), _stream(q.device),
                          _launch.sm_count(q.device.index or 0), form, q,
                          k_all, v_all, kv_len, layer, kv_heads, k_scale,
                          v_scale)


def _launch_decode(lib, stream: int, sms: int, form: str, q, k_all, v_all,
                   kv_len, layer: int, kv_heads: int, k_scale, v_scale):
    """Launch B3's ``form`` at q's head width (128, or 256: the
    ``_hd256`` entries) through ``lib`` on ``sms`` SMs: its plan, the
    stream's workspace and zeroed counters; allocates only the output and
    reads nothing of kv_len on the host."""
    B, _, H, hd = q.shape
    S = k_all.shape[2]
    plan = decode_plan(B, kv_heads, S, sms, hd)
    out = torch.empty_like(q)
    name = "decode_attention" + ("" if hd == HEAD_DIM else "_hd256") + form
    scales = (k_scale.data_ptr(), v_scale.data_ptr()) if form else ()
    err = getattr(lib, "v3d_" + name)(
        q.data_ptr(), k_all.data_ptr(), v_all.data_ptr(), *scales,
        kv_len.data_ptr(), out.data_ptr(),
        *split_args(plan, q.device, stream), layer, B, S, H, kv_heads,
        plan.splits, float(hd ** -0.5), stream)
    _build.check(err, name)
    _build.count_launch(name)
    return out
