"""Host logic of the weight-streaming kernels B4's B>1 form (int8) and B8
(int4), on the CPU: the work plan (``stream_plan``: every (column tile,
K-slice unit) once, a unit one ring stage that never straddles two int4
scale groups, every CTA's bytes within one unit of the mean at the
Qwen2-7B decode shapes), the launch glue with a
stand-in library (the plan, shapes and pointers handed to the C entry, the
stream's cached workspace and zeroed counters, nothing allocated on a
second call), and the plan's split-and-merge arithmetic, written out in
plain torch in the kernel's order, against the plain versions."""

import ctypes
import dataclasses
from collections import Counter

import numpy as np
import pytest
import torch

from video3d_tpu_torch.kernels import _build, _launch
from video3d_tpu_torch.kernels import quant_matvec as qm
from video3d_tpu_torch.models.quant import (quantize_weight,
                                            quantize_weight_int4)

H100_SMS = 132
# Qwen2-7B's decode projections and vocab head: (in, out)
DECODE_SHAPES = [("wq", 3584, 3584), ("wk", 3584, 512), ("wv", 3584, 512),
                 ("wo", 3584, 3584), ("w_gate", 3584, 18944),
                 ("w_up", 3584, 18944), ("w_down", 18944, 3584),
                 ("lm_head", 3584, 152064)]


def _int4_dims(in_: int, out: int, group: int = 512):
    """The packed int4 weight's (in_p, out_p): ``quantize_weight_int4``'s
    padding."""
    return -(-in_ // group) * group, \
        -(-out // (2048 if out >= 8192 else 512)) * (2048 if out >= 8192
                                                     else 512)


def _units_per_cta(plan):
    return [plan.unit_begin(c + 1) - plan.unit_begin(c)
            for c in range(plan.ctas)]


@pytest.mark.parametrize("rows,in_,out,sms,bits,group", [
    (8, 3584, 512, 132, 8, 512), (1, 1000, 1040, 7, 8, 512),
    (32, 2048, 720, 132, 8, 512), (5, 18944, 3584, 114, 8, 512),
    (8, 3584, 512, 132, 4, 512), (1, 2048, 1536, 5, 4, 512),
    (8, 18944, 3584, 8, 4, 512), (3, 3584, 153600, 132, 4, 512),
    (16, 4096, 1024, 132, 4, 1024), (2, 512, 16, 132, 4, 512)])
def test_stream_plan_covers_every_tile_slice_once(rows, in_, out, sms, bits,
                                                  group):
    """The segments of all CTAs cover every (column tile, unit) exactly
    once, each CTA a contiguous, non-empty range; a unit is one ring stage
    of the kernel, and an int4 stage lies inside one scale group (the
    kernel multiplies each stage's f32 sums by one group's scales)."""
    plan = qm.stream_plan(rows, in_, out, sms, bits)
    assert (plan.tiles - 1) * qm.STREAM_TILE < out <= \
        plan.tiles * qm.STREAM_TILE
    assert plan.units_per_tile * plan.unit_k >= in_
    assert 1 <= plan.ctas <= min(sms, plan.units)
    assert min(_units_per_cta(plan)) >= 1
    seen = Counter()
    last = -1
    for cta, tile, u0, u1 in plan.slices():
        assert 0 <= u0 < u1 <= plan.units_per_tile
        for u in range(u0, u1):
            flat = tile * plan.units_per_tile + u
            assert flat == last + 1            # contiguous, in CTA order
            last = flat
            seen[(tile, u)] += 1
    assert seen == Counter({(t, u): 1 for t in range(plan.tiles)
                            for u in range(plan.units_per_tile)})
    assert plan.unit_k == qm.STAGE_INPUTS[bits]
    if bits == 4:
        assert in_ % group == 0 and group % plan.unit_k == 0
        for _, _, u0, u1 in plan.slices():
            assert (u0 * plan.unit_k) // group == \
                (u0 * plan.unit_k + plan.unit_k - 1) // group
    assert plan.row_tiles == (1 if rows <= 8 else 2 if rows <= 16 else 4)


@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("rows", [1, 8, 32])
@pytest.mark.parametrize("what,in_,out", DECODE_SHAPES)
def test_stream_plan_balances_the_bytes_at_the_decode_shapes(what, in_, out,
                                                             rows, bits):
    """At every Qwen2-7B decode shape on 132 SMs, every CTA streams the
    mean bytes within one K-slice unit; the grid is the largest within
    COST_SLACK of the least cost, and the wide products (w_gate, w_up, the
    head) fill the card."""
    if bits == 4:
        in_, out = _int4_dims(in_, out)
    plan = qm.stream_plan(rows, in_, out, H100_SMS, bits)
    per_input = 1.0 if bits == 8 else 0.5
    cta_bytes = [0.0] * plan.ctas
    slices = Counter()
    for cta, tile, u0, u1 in plan.slices():
        cols = min(qm.STREAM_TILE, out - tile * qm.STREAM_TILE)
        inputs = min(u1 * plan.unit_k, in_) - u0 * plan.unit_k
        cta_bytes[cta] += cols * inputs * per_input
        slices[tile] += 1
    assert sum(cta_bytes) == in_ * out * per_input
    mean = sum(cta_bytes) / plan.ctas
    unit_bytes = qm.STREAM_TILE * plan.unit_k * per_input
    assert max(abs(b - mean) for b in cta_bytes) <= unit_bytes
    assert max(slices.values()) == plan.max_slices()
    costs = {c: dataclasses.replace(plan, ctas=c).cost_us(bits)
             for c in range(1, min(H100_SMS, plan.units) + 1)}
    least = min(costs.values())
    assert costs[plan.ctas] <= least * (1 + qm.COST_SLACK)
    assert all(cost > least * (1 + qm.COST_SLACK)
               for c, cost in costs.items() if c > plan.ctas)
    if what in ("w_gate", "w_up", "lm_head"):
        assert plan.ctas == H100_SMS


class _Library:
    """Stands in for the kernel library: records each call's arguments and
    runs ``body`` on them."""

    def __init__(self, body):
        self.calls, self.body = [], body

    def __getattr__(self, name):
        if not name.startswith("v3d_"):
            raise AttributeError(name)

        def entry(*args):
            self.calls.append((name, args))
            self.body(name, args)
            return 0
        return entry


def _weight(rng, bits, in_, out):
    """(weight, scale) of the form: int8 (in, out) with a (1, out) scale,
    or int4 packed (in / 2, out) with (in / 512, out) scales."""
    w = torch.from_numpy(rng.normal(size=(in_, out)).astype(np.float32))
    if bits == 8:
        d = quantize_weight(w)
        return d["q"], d["scale"]
    w4 = quantize_weight_int4(w)
    return w4.q4, w4.scale4


@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("rows,in_,out,sms", [
    (8, 3584, 512, H100_SMS),     # wk: tiles cut into K-slices
    (8, 512, 1024, 2)])           # one CTA per tile: no workspace
def test_stream_launch_hands_the_plan_to_the_c_entry(bits, rows, in_, out,
                                                     sms, monkeypatch):
    rng = np.random.default_rng(7)
    w, scale = _weight(rng, bits, in_, out)
    x = torch.from_numpy(rng.normal(size=(rows, 1, in_))
                         .astype(np.float32)).bfloat16()
    plan = qm.stream_plan(rows, in_, out, sms, bits)
    name = "int8_matmul" if bits == 8 else "int4_matmul"
    counters = []

    def body(_, args):
        if args[6]:
            counters.append(np.ctypeslib.as_array(
                (ctypes.c_int * (plan.tiles * qm.STREAM_PAIRS))
                .from_address(args[6])).copy())
    lib = _Library(body)
    stream = 200 + bits + sms
    before = _build.LAUNCHES[name]
    y = qm._launch_stream(lib, stream, sms, name, x, w, scale, in_, out, bits)
    assert _build.LAUNCHES[name] == before + 1
    assert y.shape == (rows, 1, out) and y.dtype == torch.bfloat16
    (entry, args), = lib.calls
    assert entry == f"v3d_{name}"
    assert len(args) == len(_build._SIGNATURES[entry])
    assert args[:4] == (x.data_ptr(), w.data_ptr(), scale.data_ptr(),
                        y.data_ptr())
    assert args[7:10] == (rows, in_, out)
    assert args[10:-2] == ((512,) if bits == 4 else ())
    assert args[-2:] == (plan.ctas, stream)
    ws_ptr, ws_bytes, ctr_ptr = args[4:7]
    if plan.split:
        assert ws_ptr and ctr_ptr and ws_bytes >= plan.workspace_bytes > 0
        assert not counters[0].any()
    else:
        assert (ws_ptr, ws_bytes, ctr_ptr) == (0, 0, 0)
    # a second call of the same shape allocates no workspace or counters
    monkeypatch.setattr(_launch, "_allocate", lambda *a: pytest.fail(
        "a buffer was allocated on the second call"))
    qm._launch_stream(lib, stream, sms, name, x, w, scale, in_, out, bits)
    assert lib.calls[1][1][4:7] == args[4:7]
    with pytest.raises(ValueError, match="rows"):
        qm._launch_stream(lib, stream, sms, name,
                          torch.zeros(33, in_, dtype=torch.bfloat16), w,
                          scale, in_, out, bits)


def test_stream_buffers_grow_per_stream_and_stay():
    """One workspace and one zeroed counter buffer per (device, stream),
    grown when a launch needs more and then reused."""
    cpu = torch.device("cpu")
    ws = _launch.workspace(cpu, 301, 4000)
    assert ws.dtype == torch.float32 and ws.numel() * 4 >= 4000
    assert _launch.workspace(cpu, 301, 100) is ws
    assert _launch.workspace(cpu, 302, 100) is not ws
    big = _launch.workspace(cpu, 301, 1 << 20)
    assert big.numel() * 4 >= 1 << 20 and _launch.workspace(cpu, 301, 8) is big
    ctr = _launch.arrival_counters(cpu, 301, 3000)
    assert ctr.dtype == torch.int32 and ctr.numel() >= 3000 and not ctr.any()
    assert _launch.arrival_counters(cpu, 301, 10) is ctr


def _split_merge(plan, xf, w, scale, bits, group=512):
    """The kernel's arithmetic in plain torch, f32 before the rounding: a
    segment adds its stages' f32 sums (int4: each times its group's scale)
    in input order; a tile adds its K-slices in slice order, then int8
    multiplies by the column scale."""
    rows, in_ = xf.shape
    wf = (w if bits == 8 else qm.unpack_int4(w)).to(torch.float32)
    out = wf.shape[1]
    stage_k = qm.STAGE_INPUTS[bits]
    slices = {}
    for cta, tile, u0, u1 in plan.slices():
        c0, c1 = tile * qm.STREAM_TILE, min(out, (tile + 1) * qm.STREAM_TILE)
        total = torch.zeros(rows, c1 - c0)
        for s in range(u0, u1):
            k0, k1 = s * stage_k, min(in_, (s + 1) * stage_k)
            if k0 >= in_:
                break
            part = xf[:, k0:k1] @ wf[k0:k1, c0:c1]
            if bits == 4:
                part = part * scale[k0 // group, c0:c1].to(torch.float32)
            total = total + part
        slices.setdefault(tile, []).append(total)
    y = torch.zeros(rows, out)
    for tile, parts in slices.items():
        total = parts[0]
        for p in parts[1:]:
            total = total + p
        c0 = tile * qm.STREAM_TILE
        y[:, c0:c0 + total.shape[1]] = total
    if bits == 8:
        y = y * scale.to(torch.float32)
    return y


@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("rows,in_,out,sms", [
    (5, 1000, 720, 7),            # ragged last stage and tile, split tiles
    (20, 2048, 1024, 5),          # 2 tiles over 5 CTAs
    (1, 3584, 512, H100_SMS)])    # wk at B=1
def test_split_merge_matches_the_plain_version(bits, rows, in_, out, sms):
    """The plan's split-and-merge order in f32 against the plain version
    (float32 sums in another order: within 2e-6 of max |ref|), and the
    rounded result within one bf16 ulp of it, as on the card."""
    rng = np.random.default_rng(8 + bits)
    w, scale = _weight(rng, bits, in_, out)
    in_p, out_p = (in_, out) if bits == 8 else (2 * w.shape[0], w.shape[1])
    x = torch.zeros(rows, in_p, dtype=torch.bfloat16)
    x[:, :in_] = torch.from_numpy(rng.normal(size=(rows, in_))
                                  .astype(np.float32)).bfloat16()
    plan = qm.stream_plan(rows, in_p, out_p, sms, bits)
    assert plan.split
    got = _split_merge(plan, x.float(), w, scale, bits)
    ref = (qm.int8_matmul_plain if bits == 8 else qm.int4_matmul_plain)(
        x.float(), w, scale)
    assert float((got - ref).abs().max()) <= 2e-6 * float(ref.abs().max())
    ulps = ((got.bfloat16().float() - ref).abs()
            / (2.0 ** -7 * ref.abs() + 1e-4)).max()
    assert float(ulps) <= 1.0
