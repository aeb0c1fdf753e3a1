"""Host logic of the decode-attention kernels B3 (flat cache) and B7 (page
pools), on the CPU: the split plan (``decode_plan``: the grid from the
shapes and the SM count alone; on the device every CTA takes an even share
of the rows' live positions laid end to end, each position exactly once,
each row merged from the workspace slots its CTAs wrote), the launch glue
with a stand-in library (the pointers, shapes and plan handed to each C
entry, the stream's cached workspace and zeroed counters, nothing but the
output allocated on a second call, no value of kv_len or the table read
on the host), and the kernel's split-softmax merge written out in plain
torch in CTA order, against both plain versions in all three cache
forms."""

import ctypes
from collections import Counter

import numpy as np
import pytest
import torch

from video3d_tpu_torch.kernels import _build, _launch
from video3d_tpu_torch.kernels import decode_attention as da
from video3d_tpu_torch.kernels import paged_attention as pa
from video3d_tpu_torch.models.qwen2 import quantize_rows

torch.set_num_threads(1)

H100_SMS = 132
FORMS = ["bf16", "int8", "int4"]
STORAGE = {"int8": torch.int8, "int4": torch.uint8}
# (kv heads, capacity per row, kv_len) of every B3 / B7 call chip_smoke.py
# makes: phase 3's B3 rows, phase 5's B=8 rows, phase 11's 32k row, phase
# 3's B7 serving slots (56 pages of 128) and phase 11's 1 x 32k + 7 x ~520
# mix (256 pages)
SMOKE_SHAPES = [
    (4, 8704, [6812]), (4, 8704, [8704, 6812, 300, 4097]),
    (4, 8704, [8704, 6812, 300, 4097, 6000, 2048, 7777, 1]),
    (4, 8704, [6780, 6801, 6750, 6912, 6790, 6760, 6845, 6812]),
    (4, 32768, [32760]),
    (4, 56 * 128, [6780, 6801, 0, 6750, 6912, 6790, 6760, 6845]),
    (4, 256 * 128, [32760, 520, 513, 527, 512, 521, 515, 524])]
# fewer live positions than CTAs: some CTAs' ranges are empty, also
# between a row's first and last CTA (a 2-layer model's short prompts)
SHORT_SHAPES = [(2, 528, [61]), (4, 8704, [20]), (2, 528, [1]),
                (4, 600, [5, 0, 9, 3, 1, 2, 4, 6]), (1, 528, [131])]


def _slot_of(ranges, cta, base):
    """The workspace slot a CTA's slice of the row starting at ``base``
    goes to (the kernel's ``first_of_cta``): 0 where its range begins in
    the row, else 1."""
    return 0 if ranges[cta][0] >= base else 1


@pytest.mark.parametrize("kv_heads,cap,lens", SMOKE_SHAPES + SHORT_SHAPES)
def test_decode_plan_covers_every_position_once(kv_heads, cap, lens):
    """At every chip_smoke shape, at short rows and at full capacity, the
    segments of all CTAs cover every live position of every row exactly
    once, each CTA's positions within one of the mean; a row's CTAs are
    the ones the merge reads (``slices``: the range [cta_of(first
    position), cta_of(last position)] while every CTA holds a position,
    else the CTA of each position), each of them writes the row's slice to
    a slot the merge reads, and no CTA holds more than two slices (its
    first and last segments)."""
    B = len(lens)
    plan = da.decode_plan(B, kv_heads, cap, H100_SMS)
    assert plan.ctas <= H100_SMS and plan.splits >= 1
    for case in (lens, [cap] * B):
        live = plan.lens(case)
        total = sum(live)
        seen = Counter()
        per_cta = Counter()
        for cta, b, s0, s1 in plan.segments(case):
            assert 0 <= s0 < s1 <= live[b]
            per_cta[cta] += s1 - s0
            for s in range(s0, s1):
                seen[(b, s)] += 1
        assert seen == Counter({(b, s): 1 for b, n in enumerate(live)
                                for s in range(n)})
        mean = total / plan.splits
        assert all(abs(per_cta[c] - mean) <= 1 for c in range(plan.splits))
        ranges = plan.ranges(case)
        merged = plan.slices(case)
        base = 0
        slots = Counter()
        for b, n in enumerate(live):
            if n:
                first = plan.cta_of(base, total)
                last = plan.cta_of(base + n - 1, total)
                holders = sorted({c for c, bb, _, _ in plan.segments(case)
                                  if bb == b})
                assert holders[0] == first and holders[-1] == last
                assert merged[b] == (holders if first != last else [])
                if first != last:
                    for c in holders:
                        slot = _slot_of(ranges, c, base)
                        assert slot == 0 or c == first
                        slots[(c, slot)] += 1
            base += n
        assert all(v == 1 for v in slots.values())


@pytest.mark.parametrize("B,cap", [(1, 8704), (1, 32768), (8, 8704),
                                   (8, 56 * 128), (8, 256 * 128)])
def test_decode_plan_fills_the_card(B, cap):
    """Qwen2-7B's 4 kv heads: 33 CTAs each, 132 in all, at every batch
    (one CTA per SM; the ring leaves room for no second)."""
    plan = da.decode_plan(B, 4, cap, H100_SMS)
    assert plan.ctas == H100_SMS
    assert plan.workspace_bytes == 2 * H100_SMS * da.PART_FLOATS * 4
    assert plan.counters == 4 * B
    assert da.decode_plan(1, 4, 1, H100_SMS).splits == 1


class _Library:
    """Stands in for the kernel library: records each call's arguments."""

    def __init__(self):
        self.calls = []

    def __getattr__(self, name):
        if not name.startswith("v3d_"):
            raise AttributeError(name)

        def entry(*args):
            self.calls.append((name, args))
            return 0
        return entry


def _no_host_reads(monkeypatch):
    """Every way to bring a tensor's value to the host raises."""
    def refuse(*_, **__):
        raise AssertionError("a tensor value was read on the host")
    for attr in ("item", "tolist", "cpu", "numpy", "__bool__", "__int__",
                 "__index__", "__float__"):
        monkeypatch.setattr(torch.Tensor, attr, refuse)


def _count_allocations(monkeypatch):
    made = []
    for fn in ("empty", "empty_like", "zeros", "zeros_like", "ones",
               "full", "tensor"):
        orig = getattr(torch, fn)

        def wrapped(*a, _orig=orig, _fn=fn, **k):
            made.append(_fn)
            return _orig(*a, **k)
        monkeypatch.setattr(torch, fn, wrapped)
    monkeypatch.setattr(_launch, "_allocate", lambda *a: pytest.fail(
        "a buffer was allocated on the second call"))
    return made


def _flat_case(rng, form, NL=2, B=3, S=600, H=28, KV=4, hd=128):
    q = torch.from_numpy(rng.normal(size=(B, 1, H, hd)).astype(np.float32))
    x = [torch.from_numpy(rng.normal(size=(NL, B, S, KV, hd))
                          .astype(np.float32)).bfloat16() for _ in range(2)]
    if form == "bf16":
        return q.bfloat16(), *(t.reshape(NL, B, S, -1) for t in x), None, \
            None
    (k, ks), (v, vs) = (quantize_rows(t, STORAGE[form]) for t in x)
    return q.bfloat16(), k, v, ks, vs


def _paged_case(rng, form, NL=2, P=12, page=16, H=28, KV=4, hd=128):
    q = torch.from_numpy(rng.normal(size=(4, 1, H, hd)).astype(np.float32))
    x = [torch.from_numpy(rng.normal(size=(NL, P, page, KV, hd))
                          .astype(np.float32)).bfloat16() for _ in range(2)]
    # every slot aliases pages 1-3, then two pages of its own
    table = torch.tensor([[1, 2, 3, 4 + 2 * b, 5 + 2 * b] for b in range(4)],
                         dtype=torch.int32)
    if form == "bf16":
        return q.bfloat16(), *(t.reshape(NL, P, page, -1) for t in x), \
            table, None, None
    (k, ks), (v, vs) = (quantize_rows(t, STORAGE[form]) for t in x)
    ks, vs = (s.permute(0, 1, 3, 4, 2).contiguous() for s in (ks, vs))
    return q.bfloat16(), k, v, table, ks, vs


@pytest.mark.parametrize("form", FORMS)
def test_decode_launch_hands_the_plan_to_the_c_entry(form, monkeypatch):
    rng = np.random.default_rng(3)
    q, k, v, ks, vs = _flat_case(rng, form)
    kv_len = torch.tensor([600, 257, 1], dtype=torch.int32)
    suffix = "" if form == "bf16" else f"_{form}"
    lib = _Library()
    stream = 310 + len(form)
    plan = da.decode_plan(3, 4, 600, H100_SMS)
    before = _build.LAUNCHES["decode_attention" + suffix]
    out = da._launch_decode(lib, stream, H100_SMS, suffix, q, k, v, kv_len,
                            1, 4, ks, vs)
    assert _build.LAUNCHES["decode_attention" + suffix] == before + 1
    assert out.shape == q.shape and out.dtype == torch.bfloat16
    (entry, args), = lib.calls
    assert entry == "v3d_decode_attention" + suffix
    assert len(args) == len(_build._SIGNATURES[entry])
    ptrs = [q.data_ptr(), k.data_ptr(), v.data_ptr()]
    if form != "bf16":
        ptrs += [ks.data_ptr(), vs.data_ptr()]
    n = len(ptrs)
    assert list(args[:n]) == ptrs
    assert args[n:n + 2] == (kv_len.data_ptr(), out.data_ptr())
    ws_ptr, ws_bytes, ctr_ptr = args[n + 2:n + 5]
    assert ws_ptr and ctr_ptr and ws_bytes >= plan.workspace_bytes
    counters = np.ctypeslib.as_array((ctypes.c_int * plan.counters)
                                     .from_address(ctr_ptr))
    assert not counters.any()
    assert args[n + 5:] == (1, 3, 600, 28, 4, plan.splits,
                            pytest.approx(128 ** -0.5), stream)
    made = _count_allocations(monkeypatch)
    _no_host_reads(monkeypatch)
    da._launch_decode(lib, stream, H100_SMS, suffix, q, k, v, kv_len, 1, 4,
                      ks, vs)
    assert made == ["empty_like"]                  # the output alone
    assert lib.calls[1][1][n + 2:n + 5] == (ws_ptr, ws_bytes, ctr_ptr)


@pytest.mark.parametrize("form", FORMS)
def test_paged_launch_hands_the_plan_to_the_c_entry(form, monkeypatch):
    rng = np.random.default_rng(4)
    q, k, v, table, ks, vs = _paged_case(rng, form)
    kv_len = torch.tensor([80, 70, 0, 45], dtype=torch.int32)
    suffix = "" if form == "bf16" else f"_{form}"
    lib = _Library()
    stream = 320 + len(form)
    plan = da.decode_plan(4, 4, 5 * 16, H100_SMS)
    out = pa._launch_paged(lib, stream, H100_SMS, suffix, q, k, v, table,
                           kv_len, 1, 4, ks, vs)
    (entry, args), = lib.calls
    assert entry == "v3d_paged_attention" + suffix
    assert len(args) == len(_build._SIGNATURES[entry])
    ptrs = [q.data_ptr(), k.data_ptr(), v.data_ptr()]
    if form != "bf16":
        ptrs += [ks.data_ptr(), vs.data_ptr()]
    n = len(ptrs)
    assert list(args[:n]) == ptrs
    assert args[n:n + 3] == (table.data_ptr(), kv_len.data_ptr(),
                             out.data_ptr())
    ws_ptr, ws_bytes, ctr_ptr = args[n + 3:n + 6]
    assert ws_ptr and ctr_ptr and ws_bytes >= plan.workspace_bytes
    assert args[n + 6:] == (1, 4, 12, 16, 5, 28, 4, plan.splits,
                            pytest.approx(128 ** -0.5), stream)
    made = _count_allocations(monkeypatch)
    _no_host_reads(monkeypatch)
    pa._launch_paged(lib, stream, H100_SMS, suffix, q, k, v, table, kv_len,
                     1, 4, ks, vs)
    assert made == ["empty_like"]
    assert lib.calls[1][1][n + 3:n + 6] == (ws_ptr, ws_bytes, ctr_ptr)


def _merge(parts):
    """(m, l, O) parts added in order, each with the running max rescaled
    as in the online softmax (the kernel's merge of a row's slices)."""
    mx, l, o = parts[0]
    for m, li, oi in parts[1:]:
        mn = torch.maximum(mx, m)
        sa, sb = torch.exp(mx - mn), torch.exp(m - mn)
        l, o, mx = l * sa + sb * li, o * sa + sb * oi, mn
    return mx, l, o


def _split_merge(plan, q, k, v, lens, round_p=None):
    """The kernel's arithmetic in plain torch, f32: per kv head, each CTA's
    segment of a row gives (m, l, O) over its positions (l over the
    unscaled p; ``round_p``, a dtype: the p that goes into P V rounded to
    it); a row adds its segments in CTA order, each with the running max
    rescaled. q (B, H, hd) f32; k, v (B, cap, KV, hd) f32, dequantized (the kernel
    multiplies the dot by the key's scale and p by the value's, the same
    products); rows with no position get zeros."""
    B, H, hd = q.shape
    KV = k.shape[2]
    G = H // KV
    out = torch.zeros(B, H, hd)
    for h in range(KV):
        parts = {}
        for _, b, s0, s1 in plan.segments(lens):
            s = q[b, h * G:(h + 1) * G] @ k[b, s0:s1, h].T * hd ** -0.5
            m = s.max(-1, keepdim=True).values
            p = torch.exp(s - m)
            pv = p if round_p is None else p.to(round_p).float()
            parts.setdefault(b, []).append((m, p.sum(-1, keepdim=True),
                                            pv @ v[b, s0:s1, h]))
        for b, ps in parts.items():
            _, l, o = _merge(ps)
            out[b, h * G:(h + 1) * G] = o / l
    return out


# the kernel rounds p (times the value's scale) to 16 bits for P V: bf16
# in the bf16 and int4 forms, f16 in the int8 form; unit roundoff of each
P_ROUNDING = {"bf16": (torch.bfloat16, 2.0 ** -9),
              "int8": (torch.float16, 2.0 ** -11),
              "int4": (torch.bfloat16, 2.0 ** -9)}


def _check_merge(got, ref, got_rounded, unit, v_max, live):
    rows = [b for b, n in enumerate(live) if n]
    ref = ref[rows, 0]
    scale = float(ref.abs().max())
    assert float((got[rows] - ref).abs().max()) <= 2e-6 * scale
    # p rounded moves each weight by at most `unit` of itself, so the
    # output by at most `unit` of the largest |v| it averages
    bound = unit * v_max + 2e-6 * scale
    assert float((got_rounded[rows] - ref).abs().max()) <= bound


@pytest.mark.parametrize("form", FORMS)
def test_split_merge_matches_the_flat_plain_version(form):
    """B3's plan and merge order (H 28, KV 4: G = 7; 33 splits per kv head
    over 858 positions, rows cut into many slices) against
    ``decode_attention_plain`` in f32 within 2e-6 of max |ref|, and with p
    rounded as the kernel rounds it (bf16; f16 in the int8 form) within
    its unit roundoff of max |v|."""
    rng = np.random.default_rng(5)
    q, k, v, ks, vs = _flat_case(rng, form)
    lens = [600, 257, 1]
    kv_len = torch.tensor(lens, dtype=torch.int32)
    qf = q.float()
    ref = da.decode_attention_plain(qf, k, v, kv_len, 1, 4, ks, vs)
    kl, vl = da.layer_kv(qf, k, v, 1, 4, ks, vs)
    plan = da.decode_plan(3, 4, 600, H100_SMS)
    assert len({c for c, *_ in plan.segments(lens)}) == plan.splits
    got = _split_merge(plan, qf[:, 0], kl, vl, lens)
    dtype, unit = P_ROUNDING[form]
    rounded = _split_merge(plan, qf[:, 0], kl, vl, lens, round_p=dtype)
    _check_merge(got, ref, rounded, unit, float(vl.abs().max()), lens)


@pytest.mark.parametrize("form", FORMS)
def test_split_merge_matches_the_paged_plain_version(form):
    """B7's plan and merge order over aliased pages, a slot with kv_len 0
    (zeros) and slots ending mid-page, against ``paged_attention_plain``
    as above."""
    rng = np.random.default_rng(6)
    q, k, v, table, ks, vs = _paged_case(rng, form)
    lens = [80, 70, 0, 45]
    kv_len = torch.tensor(lens, dtype=torch.int32)
    qf = q.float()
    ref = pa.paged_attention_plain(qf, k, v, table, kv_len, 1, 4, ks, vs)
    kl = pa._dense_from_pages(k[1], None if ks is None else ks[1], table, 4)
    vl = pa._dense_from_pages(v[1], None if vs is None else vs[1], table, 4)
    plan = da.decode_plan(4, 4, 5 * 16, H100_SMS)
    got = _split_merge(plan, qf[:, 0], kl, vl, lens)
    dtype, unit = P_ROUNDING[form]
    rounded = _split_merge(plan, qf[:, 0], kl, vl, lens, round_p=dtype)
    _check_merge(got, ref, rounded, unit, float(vl.abs().max()), lens)
    assert bool((got[2] == 0).all()) and bool((ref[2] == 0).all())
