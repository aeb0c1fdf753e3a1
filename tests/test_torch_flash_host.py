"""Host logic of the Hopper flash kernels, on the CPU: B6's packed per-row
inputs, delta, and its launch glue with a stand-in library (the f32 dQ
scratch zeroed before the launch and rounded to bf16 after; the shapes
handed to the C entry, which encodes the tensor maps and plans the grid
itself); the split plan of B2 folded and B5 (``chunk_plan``), their launch
glue in all three cache forms (shapes, pointers, a workspace of the
planned size with its counters zeroed), and the split-and-merge arithmetic
of their kernel, written out in plain torch, against the plain version."""

import ctypes
import math

import numpy as np
import pytest
import torch

from video3d_tpu_torch.kernels import _build
from video3d_tpu_torch.kernels import flash_attention as fa
from video3d_tpu_torch.kernels.attention import mha_shared_prefix_reference
from video3d_tpu_torch.kernels.quant_matvec import pack_int4


def test_bwd_rows_pack_lse_and_delta():
    rng = np.random.default_rng(2)
    lse = torch.from_numpy(rng.normal(size=(2, 3, 129)).astype(np.float32))
    delta = torch.from_numpy(rng.normal(size=(2, 3, 129)).astype(np.float32))
    rows = fa.bwd_rows(lse, delta)
    assert rows.shape == (2, 3, 2, 132) and rows.dtype == torch.float32
    assert torch.equal(rows[:, :, 0, :129], lse * fa.LOG2E)
    assert torch.equal(rows[:, :, 1, :129], delta)
    assert float(rows[..., 129:].abs().max()) == 0.0


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_bwd_delta_leaves_its_inputs(dtype):
    """delta = rowsum(dO * O) in f32, (B, H, L); dO and O are not written,
    also when dO is already f32."""
    rng = np.random.default_rng(3)
    out = torch.from_numpy(rng.normal(size=(2, 5, 3, 128))
                           .astype(np.float32)).to(dtype)
    do = torch.from_numpy(rng.normal(size=(2, 5, 3, 128))
                          .astype(np.float32)).to(dtype)
    out0, do0 = out.clone(), do.clone()
    delta = fa.bwd_delta(out, do)
    assert torch.equal(out, out0) and torch.equal(do, do0)
    assert delta.shape == (2, 3, 5) and delta.dtype == torch.float32
    ref = (do.double() * out.double()).sum(-1).transpose(1, 2)
    np.testing.assert_allclose(delta.numpy(), ref.numpy(), rtol=1e-5,
                               atol=1e-5)


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


def _floats(ptr: int, n: int) -> np.ndarray:
    return np.ctypeslib.as_array((ctypes.c_float * n).from_address(ptr))


def test_bwd_launch_zeroes_the_dq_scratch_and_rounds_it():
    B, L, H, KV, hd = 2, 129, 4, 2, 128
    rng = np.random.default_rng(1)
    bf = lambda *s: torch.from_numpy(  # noqa: E731
        rng.normal(size=s).astype(np.float32)).bfloat16()
    q, k, v, do = bf(B, L, H, hd), bf(B, L, KV, hd), bf(B, L, KV, hd), \
        bf(B, L, H, hd)
    lse = torch.from_numpy(rng.normal(size=(B, H, L)).astype(np.float32))
    delta = torch.from_numpy(rng.normal(size=(B, H, L)).astype(np.float32))
    lens = torch.tensor([129, 1])
    added = rng.normal(size=B * L * H * hd).astype(np.float32)
    seen = {}

    def body(name, args):
        dq = _floats(args[6], B * L * H * hd)
        seen["zeroed"] = bool((dq == 0).all())
        seen["rows"] = _floats(args[4], B * H * 2 * fa.rows_len(L)).copy()
        seen["dims"] = args[9:15]
        dq += added                       # what the kernel's reductions add

    lib = _Library(body)
    before = _build.LAUNCHES["flash_attention_bwd"]
    dq, dk, dv = fa._bwd_launch(lib, 0, q, k, v, do, lse, delta, lens, True)
    assert [c[0] for c in lib.calls] == ["v3d_flash_attention_bwd"]
    assert len(lib.calls[0][1]) == len(
        _build._SIGNATURES["v3d_flash_attention_bwd"])
    assert _build.LAUNCHES["flash_attention_bwd"] == before + 1
    assert seen["zeroed"]
    np.testing.assert_array_equal(seen["rows"],
                                  fa.bwd_rows(lse, delta).numpy().ravel())
    assert seen["dims"] == (B, L, L, H, KV, 1)
    assert dq.dtype == torch.bfloat16 and dq.shape == q.shape
    assert torch.equal(dq, torch.from_numpy(added).reshape(q.shape)
                       .bfloat16())
    assert dk.shape == k.shape and dv.shape == v.shape
    args = lib.calls[0][1]
    assert args[:4] == (q.data_ptr(), k.data_ptr(), v.data_ptr(),
                        do.data_ptr())
    assert args[7:9] == (dk.data_ptr(), dv.data_ptr())


# ---------------------------------------------------------- B2 folded / B5

H100_SMS = 132


def split_ranges(n: int, splits: int):
    """The key tiles [begin, end) of each split of n tiles, as the kernel
    cuts them (``split_begin`` in ``csrc/chunk_sm90.cuh``)."""
    return [(n * s // splits, n * (s + 1) // splits) for s in range(splits)]


def test_chunk_plan_fills_the_card_at_the_prefix_hit_shape():
    """B=1, L=64, H=28, KV=4 at offset 6716 of an 8224-slot cache: 16 row
    tiles (4 x 4 kv heads) split over keys into one full wave. One CTA fits
    an SM (its shared memory), so 132 CTAs or more would leave a second
    wave; the plan takes the largest whole multiple of the row tiles that
    one wave holds."""
    plan = fa.folded_plan(1, 64, 28, 4, 8224, H100_SMS)
    assert plan.groups == 16 and plan.key_tiles == 65
    assert plan.splits == 8 and plan.ctas == 128
    assert H100_SMS - plan.groups < plan.ctas <= H100_SMS
    assert plan.workspace_floats == 16 * 8 * fa.PART_FLOATS
    # the suffix batches of B5: B=8 fills the card alone, B=2 splits
    assert fa.shared_prefix_plan(8, 64, 28, 4, 6716, H100_SMS).splits == 1
    b2 = fa.shared_prefix_plan(2, 64, 28, 4, 6716, H100_SMS)
    assert b2.splits > 1 and H100_SMS - b2.groups < b2.ctas <= H100_SMS


@pytest.mark.parametrize("L,S", [(4096, 32768), (4096, 8192)])
def test_chunk_plan_does_not_split_the_long_context_chunks(L, S):
    """ctx32k's 4096-query chunks fill the card with row tiles (896 CTAs)."""
    plan = fa.folded_plan(1, L, 28, 4, S, H100_SMS)
    assert plan.splits == 1 and plan.ctas == 896
    assert plan.workspace_floats == 0


@pytest.mark.parametrize("B,L,H,KV,S", [
    (1, 64, 28, 4, 8224), (2, 64, 28, 4, 8224), (1, 256, 28, 4, 8224),
    (3, 100, 8, 2, 800), (1, 1, 28, 4, 100), (1, 64, 28, 4, 1),
    (8, 512, 28, 4, 32768), (1, 8, 8, 8, 129)])
@pytest.mark.parametrize("sms", [132, 114, 8])
def test_chunk_plan_splits_are_within_the_key_tiles(B, L, H, KV, S, sms):
    """Splits never exceed the key tiles, and the kernel's even cut of the
    key tiles leaves no split empty."""
    for plan in (fa.folded_plan(B, L, H, KV, S, sms),
                 fa.shared_prefix_plan(B, L, H, KV, S, sms)):
        assert 1 <= plan.splits <= max(plan.key_tiles, 1)
        ranges = split_ranges(plan.key_tiles, plan.splits)
        assert ranges[0][0] == 0 and ranges[-1][1] == plan.key_tiles
        assert all(a[1] == b[0] for a, b in zip(ranges, ranges[1:]))
        if plan.key_tiles:
            assert all(e > b for b, e in ranges)
        if plan.groups >= sms:
            assert plan.splits == 1


def _bf(rng, *shape, scale=1.0):
    return torch.from_numpy((scale * rng.normal(size=shape))
                            .astype(np.float32)).bfloat16()


def _quantized(rng, shape, bits):
    """Stand-in cache values of the form (the glue reads no values)."""
    vals = torch.from_numpy(rng.integers(-7, 8, size=shape).astype(np.int8))
    return vals if bits == 8 else pack_int4(vals, dim=-1).view(torch.uint8)


def _record_workspace(seen):
    """A library body that records what a split launch gets, from the
    arguments workspace, its bytes, counters and splits just before the
    stream: their values, and the first ``groups`` counters."""
    def body(name, args):
        ptr, nbytes, counters, splits = args[-5:-1]
        seen.update(name=name, ptr=ptr, nbytes=nbytes, splits=splits,
                    counters_ptr=counters)
        if counters:
            seen["counters"] = np.ctypeslib.as_array(
                (ctypes.c_int * seen["groups"]).from_address(counters)).copy()
    return body


@pytest.mark.parametrize("bits", [16, 8, 4])
def test_folded_launch_hands_the_plan_to_the_c_entry(bits):
    B, L, H, KV, hd, NL, S, layer = 1, 64, 28, 4, 128, 2, 8224, 1
    rng = np.random.default_rng(5)
    q = _bf(rng, B, L, H, hd)
    if bits == 16:
        k, v, ks, vs = _bf(rng, NL, B, S, KV * hd), _bf(rng, NL, B, S,
                                                         KV * hd), None, None
    else:
        k = _quantized(rng, (NL, B, S, KV * hd), bits)
        v = _quantized(rng, (NL, B, S, KV * hd), bits)
        ks = torch.ones(NL, B, S, KV, 1)
        vs = torch.ones(NL, B, S, KV, 1)
    lens, offs = torch.tensor([6756]), torch.tensor([6716])
    plan = fa.folded_plan(B, L, H, KV, S, H100_SMS)
    seen = {"groups": plan.groups}
    lib = _Library(_record_workspace(seen))
    form = {16: "", 8: "_int8", 4: "_int4"}[bits]
    name = "flash_attention_folded" + form
    before = _build.LAUNCHES[name]
    out = fa._folded_launch(lib, 7, H100_SMS, q, k, v, lens, offs, layer, KV,
                            ks, vs)
    assert [c[0] for c in lib.calls] == ["v3d_" + name]
    args = lib.calls[0][1]
    assert len(args) == len(_build._SIGNATURES["v3d_" + name])
    assert _build.LAUNCHES[name] == before + 1
    scales = (ks.data_ptr(), vs.data_ptr()) if bits != 16 else ()
    n = 3 + len(scales)
    assert args[:n] == (q.data_ptr(), k.data_ptr(), v.data_ptr(), *scales)
    assert args[n + 2] == out.data_ptr() and out.shape == q.shape
    assert args[n + 3:n + 9] == (layer, B, L, S, H, KV)
    assert args[n + 9] == pytest.approx(hd ** -0.5)
    assert args[-1] == 7
    assert seen["splits"] == plan.splits == 8
    assert seen["ptr"] and seen["nbytes"] == plan.workspace_floats * 4
    assert not seen["counters"].any()


@pytest.mark.parametrize("bits", [16, 8, 4])
@pytest.mark.parametrize("B", [8, 2])
def test_shared_prefix_launch_hands_the_plan_to_the_c_entry(bits, B):
    L, H, KV, hd, P = 64, 28, 4, 128, 6716
    rng = np.random.default_rng(6)
    q, sk, sv = _bf(rng, B, L, H, hd), _bf(rng, B, L, KV, hd), \
        _bf(rng, B, L, KV, hd)
    if bits == 16:
        pk, pv, ps, pvs = _bf(rng, P, KV, hd), _bf(rng, P, KV, hd), None, None
    else:
        pk = _quantized(rng, (P, KV, hd), bits)
        pv = _quantized(rng, (P, KV, hd), bits)
        ps, pvs = torch.ones(P, KV, 1), torch.ones(P, KV, 1)
    plan = fa.shared_prefix_plan(B, L, H, KV, P, H100_SMS)
    seen = {"groups": plan.groups}
    lib = _Library(_record_workspace(seen))
    form = {16: "", 8: "_int8", 4: "_int4"}[bits]
    name = "shared_prefix_attention" + form
    out = fa._shared_prefix_launch(lib, 3, H100_SMS, q, pk, pv, sk, sv, ps,
                                   pvs)
    args = lib.calls[0][1]
    assert lib.calls[0][0] == "v3d_" + name
    assert len(args) == len(_build._SIGNATURES["v3d_" + name])
    scales = (ps.data_ptr(), pvs.data_ptr()) if bits != 16 else ()
    n = 3 + len(scales)
    assert args[:n + 3] == (q.data_ptr(), pk.data_ptr(), pv.data_ptr(),
                            *scales, sk.data_ptr(), sv.data_ptr(),
                            out.data_ptr())
    assert args[n + 3:n + 8] == (B, L, P, H, KV)
    assert seen["splits"] == plan.splits
    if plan.splits == 1:
        assert (seen["ptr"], seen["nbytes"], seen["counters_ptr"]) == (0, 0, 0)
    else:
        assert seen["nbytes"] == plan.workspace_floats * 4
        assert not seen["counters"].any()


def _partial(q, k, v, allow, scale):
    """One split's unnormalised O and per-row (m, l), base 2, as a CTA of
    the kernel leaves them: a row with no allowed key has m = -inf, l = 0
    and O = 0."""
    s = (q @ k.T) * scale * fa.LOG2E
    s = s.masked_fill(~allow, -math.inf)
    m = s.max(-1).values if s.shape[1] else torch.full(
        (s.shape[0],), -math.inf, dtype=s.dtype)
    u = torch.where(m == -math.inf, torch.zeros_like(m), m)
    p = torch.exp2(s - u[:, None])
    return p @ v, m, p.sum(-1)


def _merge(parts):
    """The last CTA's merge, in split order: weights 2^(m_s - max m), 0
    for a split with no allowed key; the divide guards l >= 1e-30."""
    m_all = torch.stack([m for _, m, _ in parts])
    mx = m_all.max(0).values
    o = torch.zeros_like(parts[0][0])
    den = torch.zeros_like(mx)
    for po, pm, pl in parts:
        w = torch.where(pm == -math.inf, torch.zeros_like(pm),
                        torch.exp2(pm - mx))
        o = o + w[:, None] * po
        den = den + w * pl
    return o / den.clamp_min(1e-30)[:, None]


def _split_folded(q, k_all, v_all, lengths, offs, layer, KV, splits,
                  tile=16, rows=16):
    """B2 folded as the kernel walks it, in f64: per (batch row, kv head)
    tiles of ``rows`` folded rows, each with its key tiles (of ``tile``
    keys, up to its last row's position and the length) cut into
    ``splits`` even ranges, merged. The kernel's tiles are 128 and 128;
    smaller ones give more splits with rows that see no key."""
    B, L, H, hd = q.shape
    G = H // KV
    out = torch.empty(B, L, H, hd, dtype=torch.float64)
    for b in range(B):
        off, length = int(offs[b]), int(lengths[b])
        for kvh in range(KV):
            k = k_all[layer, b].reshape(-1, KV, hd)[:, kvh].double()
            v = v_all[layer, b].reshape(-1, KV, hd)[:, kvh].double()
            for r0 in range(0, L * G, rows):
                fr = torch.arange(r0, min(r0 + rows, L * G))
                qr = q[b, fr // G, kvh * G + fr % G].double()
                pos = off + fr // G
                kend = min(off + int(fr[-1]) // G + 1, length)
                n = -(-kend // tile) if kend > 0 else 0
                parts = []
                for a, e in split_ranges(n, splits):
                    cols = torch.arange(a * tile, min(e * tile, k.shape[0]))
                    allow = (cols[None] <= pos[:, None]) & (cols[None]
                                                            < length)
                    parts.append(_partial(qr, k[cols], v[cols], allow,
                                          hd ** -0.5))
                out[b, fr // G, kvh * G + fr % G] = _merge(parts)
    return out


@pytest.mark.parametrize("splits", [1, 3, 8])
def test_split_merge_matches_the_plain_folded_version(splits):
    """Two batch rows, the second's length ending early (its trailing
    splits hold no allowed key), causal rows before a split's first key:
    the merge gives those splits weight 0 and no NaN. The plain version
    takes its scores to f32, hence 1e-5."""
    rng = np.random.default_rng(7)
    B, L, H, KV, hd, S, layer = 2, 12, 4, 2, 128, 120, 1
    q = torch.from_numpy(2 * rng.normal(size=(B, L, H, hd)))
    k_all = torch.from_numpy(rng.normal(size=(2, B, S, KV * hd)))
    v_all = torch.from_numpy(rng.normal(size=(2, B, S, KV * hd)))
    offs, lens = torch.tensor([90, 20]), torch.tensor([102, 32])
    got = _split_folded(q, k_all, v_all, lens, offs, layer, KV, splits)
    ref = fa.flash_attention_gqa_folded_plain(q, k_all, v_all, lens, offs,
                                              layer, KV)
    assert bool(torch.isfinite(got).all())
    for b, (o, n) in enumerate(zip(offs.tolist(), lens.tolist())):
        np.testing.assert_allclose(got[b, :n - o].numpy(),
                                   ref[b, :n - o].numpy(), rtol=1e-5,
                                   atol=1e-5)


@pytest.mark.parametrize("splits", [1, 2, 5])
def test_split_merge_matches_the_plain_shared_prefix_version(splits):
    """B5 as the kernel walks it: the prefix keys cut into even ranges, the
    suffix (block-diagonal causal) with the last split, merged."""
    rng = np.random.default_rng(8)
    B, L, H, KV, hd, P, tile = 3, 5, 4, 2, 128, 70, 16
    G = H // KV
    q = torch.from_numpy(2 * rng.normal(size=(B, L, H, hd)))
    pk = torch.from_numpy(rng.normal(size=(P, KV, hd)))
    pv = torch.from_numpy(rng.normal(size=(P, KV, hd)))
    sk = torch.from_numpy(rng.normal(size=(B, L, KV, hd)))
    sv = torch.from_numpy(rng.normal(size=(B, L, KV, hd)))
    slens = torch.tensor([5, 3, 1])
    ref = mha_shared_prefix_reference(q, pk, pv, sk, sv, slens)
    n = -(-P // tile)
    for b in range(B):
        for h in range(H):
            kvh = h // G
            parts = []
            for a, e in split_ranges(n, splits):
                cols = slice(a * tile, min(e * tile, P))
                parts.append(_partial(q[b, :, h], pk[cols, kvh],
                                      pv[cols, kvh],
                                      torch.ones(L, cols.stop - cols.start,
                                                 dtype=torch.bool),
                                      hd ** -0.5))
            o, m, s = parts[-1]
            allow = torch.arange(L)[None] <= torch.arange(L)[:, None]
            o2, m2, s2 = _partial(q[b, :, h], sk[b, :, kvh], sv[b, :, kvh],
                                  allow, hd ** -0.5)
            mx = torch.maximum(m, m2)            # one online softmax
            a1, a2 = torch.exp2(m - mx), torch.exp2(m2 - mx)
            parts[-1] = (a1[:, None] * o + a2[:, None] * o2, mx,
                         a1 * s + a2 * s2)
            got = _merge(parts)
            n_rows = int(slens[b])
            np.testing.assert_allclose(got[:n_rows].numpy(),
                                       ref[b, :n_rows, h].numpy(),
                                       rtol=1e-5, atol=1e-5)


def test_split_launches_share_one_zeroed_counter_buffer_per_stream():
    """The counters are zeroed once per (device, stream) and reused: the
    kernel leaves them zeroed, so a launch needs no memset; a larger grid
    gets a larger buffer."""
    small = fa._arrival_counters(torch.device("cpu"), 11, 16)
    assert small.dtype == torch.int32 and not small.any()
    assert fa._arrival_counters(torch.device("cpu"), 11, 16) is small
    assert fa._arrival_counters(torch.device("cpu"), 12, 16) is not small
    big = fa._arrival_counters(torch.device("cpu"), 11, 5000)
    assert big.numel() >= 5000 and not big.any()
    assert fa._arrival_counters(torch.device("cpu"), 11, 16) is big
