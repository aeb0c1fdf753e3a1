"""Host logic of B4's one-row int8 matvec (the B=1 vocab head), on the
CPU: its work plan (``matvec_plan``: every (column tile, K-slice unit)
once, every CTA's bytes within one unit of the mean, at the head and at
ragged shapes), the launch glue with a stand-in library (the plan, shapes
and pointers handed to the C entry, the stream's cached workspace and
zeroed counters, nothing allocated on a second call), the shapes the
wrapper refuses, and the kernel's order of the sums (each input group's
products in input order, the groups as a tree in group order, the
K-slices in slice order), written out in plain torch, against the plain
version."""

import ctypes
from collections import Counter

import numpy as np
import pytest
import torch

from video3d_tpu_torch.kernels import _build, _launch
from video3d_tpu_torch.kernels import quant_matvec as qm
from video3d_tpu_torch.models.quant import quantize_weight

H100_SMS = 132
HEAD = (3584, 152064)        # Qwen2-7B's vocab head: (in, out)
GROUPS, GROUP_INPUTS = 8, 8  # a stage's input groups and their inputs


def _units_per_cta(plan):
    return [plan.unit_begin(c + 1) - plan.unit_begin(c)
            for c in range(plan.ctas)]


PLAN_CASES = [(*HEAD, H100_SMS), (1000, 1040, H100_SMS), (1000, 1040, 7),
              (64, 32768, H100_SMS), (3584, 32768, H100_SMS),
              (4096, 1024, 5)]


@pytest.mark.parametrize("in_,out,sms", PLAN_CASES)
def test_matvec_plan_covers_every_tile_slice_once(in_, out, sms):
    """The segments of all CTAs cover every (column tile, unit) exactly
    once, each CTA a contiguous, non-empty range, at most two of its
    segments K-slices (its first and its last); one row, int8 units of 64
    inputs, the template's workspace slots."""
    plan = qm.matvec_plan(in_, out, sms)
    assert (plan.rows, plan.unit_k) == (1, 64)
    assert (plan.tiles - 1) * qm.STREAM_TILE < out <= \
        plan.tiles * qm.STREAM_TILE
    assert (plan.units_per_tile - 1) * plan.unit_k < in_ <= \
        plan.units_per_tile * plan.unit_k
    assert plan.ctas == max(1, min(sms, in_ * out // (512 * 64)))
    assert plan.begins[0] == 0 and plan.begins[-1] == plan.units
    assert min(_units_per_cta(plan)) >= 1        # no CTA without work
    seen, last = Counter(), -1
    partial = Counter()
    for cta, tile, u0, u1 in plan.slices():
        assert 0 <= u0 < u1 <= plan.units_per_tile
        if (u0, u1) != (0, plan.units_per_tile):
            partial[cta] += 1
        for u in range(u0, u1):
            flat = tile * plan.units_per_tile + u
            assert flat == last + 1            # contiguous, in CTA order
            last = flat
            seen[(tile, u)] += 1
    assert seen == Counter({(t, u): 1 for t in range(plan.tiles)
                            for u in range(plan.units_per_tile)})
    assert max(partial.values(), default=0) <= 2
    assert plan.workspace_bytes == (plan.ctas * 2 * qm.SLOT_FLOATS * 4
                                    if plan.split else 0)


@pytest.mark.parametrize("in_,out,sms", PLAN_CASES)
def test_matvec_plan_balances_the_bytes(in_, out, sms):
    """Every CTA streams the mean weight bytes within one unit (512
    columns x 64 inputs), ragged tiles and stages counted by their bytes:
    at the head on 132 SMs, 126 units each."""
    plan = qm.matvec_plan(in_, out, sms)
    cta_bytes = [0] * plan.ctas
    for cta, tile, u0, u1 in plan.slices():
        cols = min(qm.STREAM_TILE, out - tile * qm.STREAM_TILE)
        inputs = min(u1 * plan.unit_k, in_) - u0 * plan.unit_k
        cta_bytes[cta] += cols * inputs
    assert sum(cta_bytes) == in_ * out
    mean = sum(cta_bytes) / plan.ctas
    assert max(abs(b - mean) for b in cta_bytes) <= \
        qm.STREAM_TILE * plan.unit_k
    if (in_, out) == HEAD:
        assert (plan.tiles, plan.units_per_tile) == (297, 56)
        assert set(_units_per_cta(plan)) == {126}


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
            self.body(args)
            return 0
        return entry


def _weight(rng, in_, out):
    d = quantize_weight(torch.from_numpy(
        rng.normal(size=(in_, out)).astype(np.float32)))
    return d["q"], d["scale"]


@pytest.mark.parametrize("in_,out,sms", [
    (1000, 1040, 7),              # tiles cut into K-slices
    (512, 1024, 2)])              # one CTA per tile: no workspace
def test_matvec_launch_hands_the_plan_to_the_c_entry(in_, out, sms,
                                                     monkeypatch):
    rng = np.random.default_rng(7)
    q, scale = _weight(rng, in_, out)
    x = torch.from_numpy(rng.normal(size=(1, 1, in_))
                         .astype(np.float32)).bfloat16()
    plan = qm.matvec_plan(in_, out, sms)
    counters = []

    def body(args):
        if args[6]:
            counters.append(np.ctypeslib.as_array(
                (ctypes.c_int * (plan.tiles * qm.STREAM_PAIRS))
                .from_address(args[6])).copy())
    lib = _Library(body)
    stream = 400 + sms
    before = _build.LAUNCHES["int8_matvec"]
    y = qm._launch_matvec(lib, stream, sms, x, q, scale, in_, out)
    assert _build.LAUNCHES["int8_matvec"] == before + 1
    assert y.shape == (1, 1, out) and y.dtype == torch.bfloat16
    (entry, args), = lib.calls
    assert entry == "v3d_int8_matvec"
    assert len(args) == len(_build._SIGNATURES[entry])
    assert args[:4] == (x.data_ptr(), q.data_ptr(), scale.data_ptr(),
                        y.data_ptr())
    assert args[8:] == (in_, out, plan.ctas, stream)
    assert tuple((ctypes.c_int * (plan.ctas + 1)).from_address(args[7])) \
        == plan.begins
    ws_ptr, ws_bytes, ctr_ptr = args[4:7]
    if plan.split:
        assert ws_ptr and ctr_ptr and ws_bytes >= plan.workspace_bytes > 0
        assert not counters[0].any()
    else:
        assert (ws_ptr, ws_bytes, ctr_ptr) == (0, 0, 0)
    # a second call of the same shape allocates no workspace or counters
    monkeypatch.setattr(_launch, "_allocate", lambda *a: pytest.fail(
        "a buffer was allocated on the second call"))
    qm._launch_matvec(lib, stream, sms, x, q, scale, in_, out)
    assert lib.calls[1][1][4:7] == args[4:7]


@pytest.mark.parametrize("x_shape,q_shape", [
    ((1, 1004), (1004, 1040)),    # in % 8: x's TMA row stride
    ((1, 1000), (1000, 1000)),    # out % 16: the weight's row stride
    ((2, 1000), (1000, 1040))])   # two rows: B4's B>1 form
def test_matvec_wrapper_refuses_what_the_kernel_does_not_take(x_shape,
                                                              q_shape):
    """No fallback: a shape the kernel cannot take raises, off the CPU."""
    x = torch.zeros(x_shape, dtype=torch.bfloat16, device="meta")
    q = torch.zeros(q_shape, dtype=torch.int8, device="meta")
    scale = torch.zeros(1, q_shape[1], dtype=torch.bfloat16, device="meta")
    with pytest.raises(ValueError, match="unsupported shapes"):
        qm.int8_matvec(x, q, scale)


def _kernel_order(plan, xf, q, scale):
    """The kernel's arithmetic in plain torch, f32 before the rounding:
    in a segment, group G adds the products of inputs 8G .. 8G + 7 of each
    stage in input order; the groups' sums are added as ((G0 + G1) + (G2 +
    G3)) + ((G4 + G5) + (G6 + G7)) (a warp's four by shuffles, then the
    pair's two warps in order); a tile adds its K-slices in slice order,
    then multiplies by the column scale."""
    in_ = xf.shape[-1]
    qf = q.to(torch.float32)
    out = qf.shape[1]
    slices = {}
    for _, tile, u0, u1 in plan.slices():
        c0, c1 = tile * qm.STREAM_TILE, min(out, (tile + 1) * qm.STREAM_TILE)
        g = []
        for grp in range(GROUPS):
            acc = torch.zeros(c1 - c0)
            for s in range(u0, u1):
                for r in range(GROUP_INPUTS):
                    k = s * plan.unit_k + grp * GROUP_INPUTS + r
                    if k < in_:
                        acc = acc + xf[k] * qf[k, c0:c1]
            g.append(acc)
        total = ((g[0] + g[1]) + (g[2] + g[3])) + \
            ((g[4] + g[5]) + (g[6] + g[7]))
        slices.setdefault(tile, []).append(total)
    y = torch.zeros(out)
    for tile, parts in slices.items():
        total = parts[0]
        for p in parts[1:]:
            total = total + p
        c0 = tile * qm.STREAM_TILE
        y[c0:c0 + total.shape[0]] = total
    return y * scale.to(torch.float32).reshape(-1)


@pytest.mark.parametrize("in_,out,sms", [
    (1000, 1040, 7),              # ragged last stage and tile, split tiles
    (512, 2048, H100_SMS)])       # one unit a CTA: 8 K-slices a tile
def test_split_merge_matches_the_plain_version(in_, out, sms):
    """The kernel's order of the sums against the plain version (f32 sums
    in another order: within 2e-6 of max |ref|), and the rounded result
    within one bf16 ulp of it, as on the card."""
    rng = np.random.default_rng(9)
    q, scale = _weight(rng, in_, out)
    x = torch.from_numpy(rng.normal(size=(in_,)).astype(np.float32)) \
        .bfloat16()
    plan = qm.matvec_plan(in_, out, sms)
    assert plan.split
    got = _kernel_order(plan, x.float(), q, scale)
    ref = qm.int8_matmul_plain(x.float()[None], q, scale)[0]
    assert float((got - ref).abs().max()) <= 2e-6 * float(ref.abs().max())
    ulps = ((got.bfloat16().float() - ref).abs()
            / (2.0 ** -7 * ref.abs() + 1e-4)).max()
    assert float(ulps) <= 1.0
