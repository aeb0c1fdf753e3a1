"""The port's CUDA kernels against their plain PyTorch versions, on the GPU
at small shapes, and the grounding path through them. Marked ``cuda``; they
skip without a CUDA device. Run on a machine with one (no JAX needed
there):

    python -m pytest tests/test_torch_cuda.py -m cuda --noconftest -q
"""

import numpy as np
import pytest
import torch

from video3d_tpu_torch.kernels import _build
from video3d_tpu_torch.kernels import decode_attention as da
from video3d_tpu_torch.kernels import flash_attention as fa
from video3d_tpu_torch.kernels import fused_geometry as fg
from video3d_tpu_torch.kernels import paged_attention as pa
from video3d_tpu_torch.kernels import quant_matvec as qm
from video3d_tpu_torch.kernels.attention import mha_shared_prefix_reference
from video3d_tpu_torch.models.quant import (quantize_weight,
                                            quantize_weight_int4)
from video3d_tpu_torch.models.qwen2 import quantize_rows

pytestmark = pytest.mark.cuda

BF16_ATOL = 2e-2   # bf16 outputs of magnitude < 4: about one ulp
# peaked attention, and most of the weight on the keys under test (the
# chunk's own keys, the suffix), as in chip_smoke.py: a wrong mask there
# then moves the output by far more than BF16_ATOL
Q_SCALE, FOCUS = 3.0, 11.0


def _rows_err(a, b, rows):
    return max(float((a[i, :n].float() - b[i, :n].float()).abs().max())
               for i, n in enumerate(rows))


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", 0)


def _launched(name, fn):
    before = _build.LAUNCHES[name]
    out = fn()
    torch.cuda.synchronize()
    assert _build.LAUNCHES[name] == before + 1
    return out


def _geometry_inputs(V, H, W, seed, focal):
    g = torch.Generator().manual_seed(seed)
    depths = torch.randint(200, 8000, (V, H, W), generator=g,
                           dtype=torch.int32)
    intr = torch.eye(4)
    intr[0, 0] = intr[1, 1] = focal
    intr[0, 2], intr[1, 2] = W / 2 - 0.5, H / 2 - 0.5
    a, _ = torch.linalg.qr(torch.randn(V, 3, 3, generator=g))
    poses = torch.eye(4).repeat(V, 1, 1)
    poses[:, :3, :3] = a
    poses[:, :3, 3] = torch.rand(V, 3, generator=g) * 4 - 2
    return depths, intr, poses


def _geometry_misses(got, ref, discretize):
    """B1's distance from a plain result, in units of its bound: the share
    of ids that differ over 1e-3 (ids) or max |d| over 1e-3 m (world
    coordinates)."""
    diff = (got - ref).abs()
    if discretize:
        return float((diff > 0).float().mean()) / 1e-3
    return float(diff.max()) / 1e-3


@pytest.mark.parametrize("discretize", [True, False])
@pytest.mark.parametrize("V,H,W,crop,grid,seed,focal", [
    (3, 480, 640, 384, 14, 0, 577.87), (32, 480, 640, 384, 14, 416, 576.0),
    (4, 240, 320, 224, 16, 228, 288.0)])
def test_fused_geometry_kernel(dev, discretize, V, H, W, crop, grid, seed,
                               focal):
    """B1 against its plain version: at most 1e-3 of the ids differ, by at
    most 1, and world coordinates within 1e-3 m; controls (frame f with
    frame f + 1's pose, the crop window one patch to the right) miss by
    >= 4x."""
    depths, intr, poses = _geometry_inputs(V, H, W, seed, focal)
    args = (depths.to(dev), intr.to(dev), poses.to(dev))
    kw = dict(crop=crop, grid=grid, discretize=discretize)
    got = _launched("fused_geometry",
                    lambda: fg.fused_patch_voxel_coords(*args, **kw))
    assert got.shape == (V, grid, grid, 3)
    ref = fg.reference_patch_voxel_coords(*args, **kw)
    assert _geometry_misses(got, ref, discretize) <= 1.0
    if discretize:
        assert float((got - ref).abs().max()) <= 1
    shift = (crop // grid) * W // fg.geometry_plan(H, W, crop, grid).new_w
    for broken in (
            fg.reference_patch_voxel_coords(
                args[0], args[1], torch.roll(args[2], -1, dims=0), **kw),
            fg.reference_patch_voxel_coords(
                torch.roll(args[0], -shift, dims=2), args[1], args[2], **kw)):
        assert _geometry_misses(got, broken, discretize) >= 4.0


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("B,L,lengths", [
    (2, 300, [300, 150]), (1, 129, [129]), (3, 257, [1, 128, 129]),
    (1, 1000, [1000])])
def test_flash_kernel(dev, causal, B, L, lengths):
    """B2 prefill against its plain version in f32, at the edges of its
    128-row and 128-key tiles, peaked (keys 128-255 focused)."""
    g = torch.Generator(device=dev).manual_seed(1)
    H, KV, hd = 4, 2, 128
    q = Q_SCALE * torch.randn(B, L, H, hd, generator=g, device=dev)
    q[..., 0] += FOCUS
    k = torch.randn(B, L, KV, hd, generator=g, device=dev)
    k[:, 128:256, :, 0] += FOCUS
    v = 0.5 * torch.randn(B, L, KV, hd, generator=g, device=dev)
    q, k, v = q.bfloat16(), k.bfloat16(), v.bfloat16()
    lens = torch.tensor(lengths, dtype=torch.int32, device=dev)
    got = _launched("flash_attention", lambda: fa.flash_attention(
        q, k, v, lengths=lens, causal=causal))
    ref = fa.flash_attention_plain(q.float(), k.float(), v.float(),
                                   lengths=lens, causal=causal)
    assert bool(torch.isfinite(got.float()).all())
    assert _rows_err(got, ref, lengths) <= BF16_ATOL


# B3 / B7 cases: (H, KV, capacity, kv_len): G = 4 (the first case's
# shapes), G = 7 (Qwen2-7B), G = 8 and G = 1; rows of 1, 255, 256, 257
# positions (the tensor-core blocks hold 16, a stage 64) and at the
# capacity. The last 4 keys of every row carry most of the weight, so a
# dropped or misplaced key moves the output by far more than BF16_ATOL.
DECODE_CASES = [(8, 2, 600, [600, 257, 1]), (28, 4, 600, [1, 255, 256, 257]),
                (16, 2, 520, [520, 300]), (4, 4, 300, [256, 1, 299])]


def _focus_last(k, lens, at):
    """Channel 0 of the last 4 keys of each row gets FOCUS; ``at(b, s)``
    indexes key s of row b in ``k``."""
    for b, n in enumerate(lens):
        for s_ in range(max(n - 4, 0), n):
            k[at(b, s_) + (slice(None), 0)] += FOCUS


def _peaked_q(g, dev, B, H, hd=128):
    q = Q_SCALE * torch.randn(B, 1, H, hd, generator=g, device=dev)
    q[..., 0] += FOCUS
    return q.bfloat16()


def _flat_kv(g, dev, NL, S, KV, lens, layer, hd=128):
    """(NL, B, S, KV, hd) f32 keys (the last 4 of each row focused) and
    values."""
    B = len(lens)
    k = torch.randn(NL, B, S, KV, hd, generator=g, device=dev)
    _focus_last(k, lens, lambda b, s_: (layer, b, s_))
    v = 0.5 * torch.randn(NL, B, S, KV, hd, generator=g, device=dev)
    return k, v


def _same_bits(fn, out):
    """A second call gives the same bits (the splits merge in CTA order)."""
    assert torch.equal(fn(), out)


@pytest.mark.parametrize("H,KV,S,lens", DECODE_CASES)
def test_decode_kernel(dev, H, KV, S, lens):
    g = torch.Generator(device=dev).manual_seed(2)
    NL, B, hd, layer = 2, len(lens), 128, 1
    q = _peaked_q(g, dev, B, H)
    k, v = _flat_kv(g, dev, NL, S, KV, lens, layer)
    k_all, v_all = (x.reshape(NL, B, S, KV * hd).bfloat16() for x in (k, v))
    kv_len = torch.tensor(lens, dtype=torch.int32, device=dev)
    call = lambda: da.decode_attention(q, k_all, v_all, kv_len, layer, KV)
    got = _launched("decode_attention", call)
    ref = da.decode_attention_plain(q.float(), k_all, v_all, kv_len, layer,
                                    KV)
    assert bool(torch.isfinite(got.float()).all())
    assert float((got.float() - ref).abs().max()) <= BF16_ATOL
    _same_bits(call, got)
    broken = da.decode_attention_plain(q.float(), k_all, v_all,
                                       (kv_len - 1).clamp(min=1), layer, KV)
    assert float((broken - ref).abs().max()) > 4 * BF16_ATOL


# fewer live positions than CTAs (a CTA per SM: 66 per kv head at KV = 2,
# 33 at KV = 4): some CTAs' ranges are empty, also inside a row's span
SHORT_DECODE_CASES = [(4, 2, 528, [61]), (28, 4, 528, [20]),
                      (8, 2, 600, [5, 0, 9, 3]), (2, 2, 528, [2])]


@pytest.mark.parametrize("H,KV,S,lens", SHORT_DECODE_CASES)
def test_decode_kernel_with_fewer_positions_than_ctas(dev, H, KV, S, lens):
    """B3 where the rows' live positions number fewer than the CTAs: the
    plain version's output, the same bits on a second call, and a launch
    after it at full rows still right (the arrival counters left zeroed)."""
    g = torch.Generator(device=dev).manual_seed(3)
    NL, B, hd, layer = 2, len(lens), 128, 1
    q = _peaked_q(g, dev, B, H)
    k, v = _flat_kv(g, dev, NL, S, KV, lens, layer)
    k_all, v_all = (x.reshape(NL, B, S, KV * hd).bfloat16() for x in (k, v))
    kv_len = torch.tensor(lens, dtype=torch.int32, device=dev)
    call = lambda: da.decode_attention(q, k_all, v_all, kv_len, layer, KV)
    got = _launched("decode_attention", call)
    ref = da.decode_attention_plain(q.float(), k_all, v_all, kv_len, layer,
                                    KV)
    assert bool(torch.isfinite(got.float()).all())
    live = [b for b, n in enumerate(lens) if n]
    assert float((got[live].float() - ref[live]).abs().max()) <= BF16_ATOL
    for b in (kv_len == 0).nonzero().flatten().tolist():
        assert bool((got[b] == 0).all())           # a kv_len == 0 row
    _same_bits(call, got)
    full = torch.full_like(kv_len, S)
    after = da.decode_attention(q, k_all, v_all, full, layer, KV)
    ref_full = da.decode_attention_plain(q.float(), k_all, v_all, full,
                                         layer, KV)
    assert float((after.float() - ref_full).abs().max()) <= BF16_ATOL


@pytest.mark.parametrize("form", ["bf16", "int8", "int4"])
def test_paged_kernel_with_fewer_positions_than_ctas(dev, form):
    """B7 over four slots of 5, 0, 9 and 3 positions (17 in all, 66 CTAs
    per kv head): the plain version's output, the same bits twice, and a
    launch after it at longer rows still right."""
    q, k, v, table, kv_len, layer, KV, ks, vs = _paged_case(
        dev, form, 21, lens=(5, 0, 9, 3))
    name = "paged_attention" + ("" if form == "bf16" else f"_{form}")
    call = lambda: pa.paged_decode_attention(q, k, v, table, kv_len, layer,
                                             KV, ks, vs)
    got = _launched(name, call)
    ref = pa.paged_attention_plain(q.float(), k, v, table, kv_len, layer, KV,
                                   ks, vs)
    assert bool(torch.isfinite(got.float()).all())
    assert float((got.float() - ref).abs().max()) <= BF16_ATOL
    _same_bits(call, got)
    longer = torch.tensor([80, 70, 0, 45], dtype=torch.int32, device=dev)
    after = pa.paged_decode_attention(q, k, v, table, longer, layer, KV, ks,
                                      vs)
    ref_long = pa.paged_attention_plain(q.float(), k, v, table, longer,
                                        layer, KV, ks, vs)
    assert float((after.float() - ref_long).abs().max()) <= BF16_ATOL


FOLDED_PARAMS = [
    (28, 4, 64, [700], [740]),                 # the B=1 prefix-hit shape
    (8, 2, 100, [300, 37], [400, 100]),        # ragged, rows over 3 tiles
    (28, 4, 64, [200], [264]),        # a split boundary in the chunk's keys
    (28, 4, 64, [700, 100], [740, 164]),       # a row with empty splits
]


@pytest.mark.parametrize("H,KV,L,offs,lens", FOLDED_PARAMS)
def test_folded_kernel(dev, H, KV, L, offs, lens):
    g = torch.Generator(device=dev).manual_seed(3)
    NL, S, hd, layer = 2, 800, 128, 1
    B = len(offs)
    q = Q_SCALE * torch.randn(B, L, H, hd, generator=g, device=dev)
    q[..., 0] += FOCUS
    q = q.bfloat16()
    k_all = torch.randn(NL, B, S, KV * hd, generator=g, device=dev).bfloat16()
    for b, (o, n) in enumerate(zip(offs, lens)):
        k_all[layer, b, o:n, ::hd] += FOCUS
    v_all = (0.5 * torch.randn(NL, B, S, KV * hd, generator=g,
                               device=dev)).bfloat16()
    offs_t = torch.tensor(offs, dtype=torch.int32, device=dev)
    lens_t = torch.tensor(lens, dtype=torch.int32, device=dev)
    got = _launched("flash_attention_folded",
                    lambda: fa.flash_attention_gqa_folded(
                        q, k_all, v_all, lens_t, offs_t, layer, KV))
    # the splits merge in a fixed order: a second call gives the same bits
    assert torch.equal(got, fa.flash_attention_gqa_folded(
        q, k_all, v_all, lens_t, offs_t, layer, KV))
    # the plain version on the same values in f32 (the bf16 one rounds the
    # scores to bf16, by itself more than BF16_ATOL at peaked attention)
    ref = fa.flash_attention_gqa_folded_plain(q.float(), k_all, v_all, lens_t,
                                              offs_t, layer, KV)
    rows = [min(L, n - o) for o, n in zip(offs, lens)]
    assert bool(torch.isfinite(got.float()).all())
    assert _rows_err(got, ref, rows) <= BF16_ATOL
    no_mask = fa.flash_attention_gqa_folded_plain(q.float(), k_all, v_all,
                                                  lens_t, lens_t - 1, layer,
                                                  KV)
    assert _rows_err(no_mask, ref, rows) > 10 * BF16_ATOL


@pytest.mark.parametrize("B,L,P,H,KV", [
    (2, 64, 300, 28, 4),       # P not a multiple of 64
    (8, 64, 1000, 28, 4),      # 128-row CTAs straddle batch rows
    (3, 20, 130, 8, 2),        # 64-row tiles cross batch rows
    (2, 64, 2000, 28, 4),      # the prefix split over keys
])
def test_shared_prefix_kernel(dev, B, L, P, H, KV):
    g = torch.Generator(device=dev).manual_seed(4)
    hd = 128
    q = Q_SCALE * torch.randn(B, L, H, hd, generator=g, device=dev)
    q[..., 0] += FOCUS
    q = q.bfloat16()
    pk = torch.randn(P, KV, hd, generator=g, device=dev).bfloat16()
    pv = (0.5 * torch.randn(P, KV, hd, generator=g, device=dev)).bfloat16()
    sk = torch.randn(B, L, KV, hd, generator=g, device=dev)
    sk[..., 0] += FOCUS
    sk = sk.bfloat16()
    sv = (0.5 * torch.randn(B, L, KV, hd, generator=g, device=dev)).bfloat16()
    slens = [L - (7 * b) % L for b in range(B)]
    slens_t = torch.tensor(slens, dtype=torch.int32, device=dev)
    got = _launched("shared_prefix_attention",
                    lambda: fa.flash_attention_shared_prefix(
                        q, pk, pv, sk, sv, slens_t))
    assert torch.equal(got, fa.flash_attention_shared_prefix(
        q, pk, pv, sk, sv, slens_t))
    ref = mha_shared_prefix_reference(q.float(), pk, pv, sk, sv, slens_t)
    assert bool(torch.isfinite(got.float()).all())
    assert _rows_err(got, ref, slens) <= BF16_ATOL
    no_suffix = mha_shared_prefix_reference(q.float(), pk, pv, sk, sv,
                                            torch.zeros_like(slens_t))
    assert _rows_err(no_suffix, ref, slens) > 10 * BF16_ATOL


def test_wrappers_reject_what_the_kernels_do_not_take(dev):
    q = torch.zeros(1, 64, 4, 128, device=dev)             # float32
    kv = torch.zeros(1, 64, 2, 128, device=dev)
    with pytest.raises(ValueError):
        fa.flash_attention(q, kv, kv)
    qb = torch.zeros(1, 64, 4, 64, device=dev, dtype=torch.bfloat16)
    kvb = torch.zeros(1, 64, 2, 64, device=dev, dtype=torch.bfloat16)
    with pytest.raises(ValueError):                        # head dim 64
        fa.flash_attention(qb, kvb, kvb)
    cache = torch.zeros(2, 1, 16, 256, device=dev, dtype=torch.bfloat16)
    q1 = torch.zeros(1, 1, 4, 128, device=dev, dtype=torch.bfloat16)
    n = torch.ones(1, dtype=torch.int32, device=dev)
    with pytest.raises(ValueError):                        # no layer 2
        da.decode_attention(q1, cache, cache, n, 2, 2)
    q64 = torch.zeros(1, 64, 4, 128, device=dev, dtype=torch.bfloat16)
    with pytest.raises(ValueError):                        # no layer 2
        fa.flash_attention_gqa_folded(q64, cache, cache, n, n, 2, 2)
    pk = torch.zeros(16, 2, 128, device=dev, dtype=torch.bfloat16)
    sk = torch.zeros(1, 32, 2, 128, device=dev, dtype=torch.bfloat16)
    with pytest.raises(ValueError):                        # suffix L != 64
        fa.flash_attention_shared_prefix(q64, pk, pk, sk, sk, n)


# ---- the quantized caches: B4 and the int8- and int4-cache forms of B3, B2
# folded and B5, each against its plain version in f32 on the same values
# and scales; controls as in chip_smoke.py: scales one position off and of
# the wrong kv head (int4: also the nibbles of each byte swapped) must miss
# the bound by far more than 4x

def _int8(x, bits=8):
    """bf16 (..., S, KV, hd) -> flat int8 (..., S, KV*hd), or int4 packed
    two per uint8 byte (..., S, KV*hd / 2), and (..., S, KV, 1) f32 scales,
    quantized by the port's cache write (``quantize_rows``)."""
    q, s = quantize_rows(x, torch.int8 if bits == 8 else torch.uint8)
    return q.contiguous(), s.contiguous()


def _rolled(ks, vs, dim):
    return torch.roll(ks, 1, dims=dim), torch.roll(vs, 1, dims=dim)


def _swapped(x):
    """Packed int4 bytes with their two nibbles swapped."""
    return ((x >> 4) & 0x0F) | (x << 4)


@pytest.mark.parametrize("in_,out", [(3584, 4096), (1000, 1040),
                                     (3584, 32768), (3584, 152064)])
def test_int8_matvec_kernel(dev, in_, out):
    """B4's matvec: bf16 rounding of an f32 sum, so within one bf16 ulp of
    the f32 plain version, and the same bits on a second call; out 1040
    ends inside a 512-column tile, (3584, 32768) splits every tile over
    two or three CTAs, (3584, 152064) is Qwen2-7B's vocab head."""
    g = torch.Generator(device=dev).manual_seed(5)
    d = quantize_weight(0.02 * torch.randn(in_, out, generator=g, device=dev))
    q, scale = d["q"], d["scale"]
    del d
    x = torch.randn(1, 1, in_, generator=g, device=dev).bfloat16()
    got = _launched("int8_matvec", lambda: qm.int8_matvec(x, q, scale))
    ref = qm.int8_matmul_plain(x.float(), q, scale)
    bound = 2.0 ** -7 * ref.abs() + 1e-4
    assert got.dtype == torch.bfloat16 and got.shape == (1, 1, out)
    assert float(((got.float() - ref).abs() / bound).max()) <= 1.0
    assert torch.equal(qm.int8_matvec(x, q, scale), got)
    off = qm.int8_matmul_plain(x.float(), q, torch.roll(scale, 1, dims=1))
    assert float(((off - ref).abs() / bound).max()) > 4.0
    short = qm.int8_matmul_plain(x[..., :-64].float(), q[:-64], scale)
    assert float(((short - ref).abs() / bound).max()) > 4.0


def _ulps(got, ref):
    """max |got - ref| / (one bf16 ulp of |ref| + 1e-4)."""
    return float(((got.float() - ref).abs()
                  / (2.0 ** -7 * ref.abs() + 1e-4)).max())


@pytest.mark.parametrize("rows,in_,out", [
    (1, 1000, 1040),     # one row at a narrow output; ragged last stage
    (5, 3584, 4096),     # rows 5-7 of the n-tile are zero, split tiles
    (32, 2048, 720),     # four n-tiles, out ends inside a 128-column
                         # subtile of a 512-column tile
    (1, 3584, 512),      # wk / wv at B = 1, 8, 16, 32: the tile cut into
    (8, 3584, 512),      # K-slices, edges in the middle of the input
    (16, 3584, 512),
    (32, 3584, 512),
    (9, 1000, 1040),     # two n-tiles, slices over a ragged input
    (8, 18944, 3584),    # w_down's input
])
def test_int8_matmul_kernel(dev, rows, in_, out):
    """B4's B>1 form within one bf16 ulp of the f32 plain version, the
    same bits on a second call; controls: the scale one column off, the
    last input chunk dropped."""
    g = torch.Generator(device=dev).manual_seed(12)
    d = quantize_weight(0.02 * torch.randn(in_, out, generator=g, device=dev))
    q, scale = d["q"], d["scale"]
    x = torch.randn(rows, in_, generator=g, device=dev).bfloat16()
    got = _launched("int8_matmul", lambda: qm.int8_matmul(x, q, scale))
    ref = qm.int8_matmul_plain(x.float(), q, scale)
    assert got.dtype == torch.bfloat16 and got.shape == (rows, out)
    assert _ulps(got, ref) <= 1.0
    assert torch.equal(qm.int8_matmul(x, q, scale), got)
    cut = (in_ - 1) // 512 * 512
    for broken in (qm.int8_matmul_plain(x.float(), q,
                                        torch.roll(scale, 1, dims=1)),
                   qm.int8_matmul_plain(x[:, :cut].float(), q[:cut], scale)):
        assert _ulps(broken, ref) >= 4.0


@pytest.mark.parametrize("rows,in_,out", [
    (1, 3584, 3584),     # a decode projection at B=1, split tiles
    (8, 1000, 8200),     # padded in and out
    (32, 2048, 512),     # four n-tiles of 8 rows
    (1, 3584, 512),      # wk / wv at B = 1, 8, 16, 32: the tile cut into
    (8, 3584, 512),      # 7 K-slices (one group each)
    (16, 3584, 512),
    (32, 3584, 512),
    (8, 18944, 3584),    # w_down's input
])
def test_int4_matmul_kernel(dev, rows, in_, out):
    """B8 within one bf16 ulp of the f32 plain version, every value in
    [-7, 7] in both nibbles, the same bits on a second call; controls:
    scales one group off, the nibbles swapped, the last group dropped."""
    g = torch.Generator(device=dev).manual_seed(13)
    w4 = quantize_weight_int4(0.02 * torch.randn(in_, out, generator=g,
                                                 device=dev))
    q4, sc = w4.q4, w4.scale4
    nib = qm.unpack_int4(q4)
    assert set(nib.unique().tolist()) == set(range(-7, 8))
    in_p = 2 * q4.shape[0]
    x = torch.zeros(rows, in_p, device=dev, dtype=torch.bfloat16)
    x[:, :in_] = torch.randn(rows, in_, generator=g, device=dev).bfloat16()
    got = _launched("int4_matmul", lambda: qm.int4_matmul(x, q4, sc))
    ref = qm.int4_matmul_plain(x.float(), q4, sc)
    assert got.dtype == torch.bfloat16 and got.shape == (rows, q4.shape[1])
    assert _ulps(got, ref) <= 1.0
    assert torch.equal(qm.int4_matmul(x, q4, sc), got)
    swapped = ((q4 >> 4) & 0x0F) | (q4 << 4)
    controls = [qm.int4_matmul_plain(x.float(), swapped, sc)]
    if sc.shape[0] > 1:
        controls += [
            qm.int4_matmul_plain(x.float(), q4, torch.roll(sc, 1, dims=0)),
            qm.int4_matmul_plain(x[:, :-512].float(), q4[:-256], sc[:-1])]
    for broken in controls:
        assert _ulps(broken, ref) >= 4.0


def test_stream_wrappers_reject_what_the_kernels_do_not_take(dev):
    w4 = quantize_weight_int4(torch.randn(512, 512, device=dev))
    x = torch.zeros(33, 512, device=dev, dtype=torch.bfloat16)
    with pytest.raises(ValueError):                        # 33 rows
        qm.int4_matmul(x, w4.q4, w4.scale4)
    with pytest.raises(ValueError):                        # f32 x
        qm.int4_matmul(x[:2].float(), w4.q4, w4.scale4)
    with pytest.raises(ValueError):                        # group 256
        qm.int4_matmul(x[:2], w4.q4, w4.scale4, group=256)
    d = quantize_weight(torch.randn(512, 1004, device=dev))
    with pytest.raises(ValueError):                        # out % 8 != 0
        qm.int8_matmul(x[:2], d["q"], d["scale"])
    # weights whose TMA maps cannot be encoded: rows of 712 and 520 bytes
    # (strides and first columns must be 16-byte multiples)
    d = quantize_weight(torch.randn(512, 712, device=dev))
    with pytest.raises(ValueError):
        qm.int8_matmul(x[:2], d["q"], d["scale"])
    packed = torch.zeros(256, 520, dtype=torch.int8, device=dev)
    with pytest.raises(ValueError):
        qm.int4_matmul(x[:2], packed,
                       torch.ones(1, 520, dtype=torch.bfloat16, device=dev))


@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("H,KV,S,lens", DECODE_CASES)
def test_decode_int8_kernel(dev, bits, H, KV, S, lens):
    g = torch.Generator(device=dev).manual_seed(6)
    NL, B, hd, layer = 2, len(lens), 128, 1
    q = _peaked_q(g, dev, B, H)
    k, v = _flat_kv(g, dev, NL, S, KV, lens, layer)
    k8, ks = _int8(k.bfloat16(), bits)
    v8, vs = _int8(v.bfloat16(), bits)
    kv_len = torch.tensor(lens, dtype=torch.int32, device=dev)
    call = lambda: da.decode_attention(q, k8, v8, kv_len, layer, KV, ks, vs)
    got = _launched(f"decode_attention_int{bits}", call)
    ref = da.decode_attention_plain(q.float(), k8, v8, kv_len, layer, KV, ks,
                                    vs)
    assert bool(torch.isfinite(got.float()).all())
    assert float((got.float() - ref).abs().max()) <= BF16_ATOL
    _same_bits(call, got)
    controls = [da.decode_attention_plain(q.float(), k8, v8, kv_len, layer,
                                          KV, *_rolled(ks, vs, dim))
                for dim in (2, 3)]        # one position off, wrong kv head
    if bits == 4:
        controls.append(da.decode_attention_plain(
            q.float(), _swapped(k8), _swapped(v8), kv_len, layer, KV, ks, vs))
    for broken in controls:
        assert float((broken - ref).abs().max()) > 4 * BF16_ATOL


@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("H,KV,L,offs,lens", FOLDED_PARAMS)
def test_folded_int8_kernel(dev, H, KV, L, offs, lens, bits):
    g = torch.Generator(device=dev).manual_seed(7)
    NL, S, hd, layer = 2, 800, 128, 1
    B = len(offs)
    q = Q_SCALE * torch.randn(B, L, H, hd, generator=g, device=dev)
    q[..., 0] += FOCUS
    q = q.bfloat16()
    k = torch.randn(NL, B, S, KV, hd, generator=g, device=dev)
    for b, (o, n) in enumerate(zip(offs, lens)):
        k[layer, b, o:n, :, 0] += FOCUS
    k8, ks = _int8(k.bfloat16(), bits)
    v8, vs = _int8((0.5 * torch.randn(NL, B, S, KV, hd, generator=g,
                                      device=dev)).bfloat16(), bits)
    offs_t = torch.tensor(offs, dtype=torch.int32, device=dev)
    lens_t = torch.tensor(lens, dtype=torch.int32, device=dev)
    got = _launched(f"flash_attention_folded_int{bits}",
                    lambda: fa.flash_attention_gqa_folded(
                        q, k8, v8, lens_t, offs_t, layer, KV, ks, vs))
    assert torch.equal(got, fa.flash_attention_gqa_folded(
        q, k8, v8, lens_t, offs_t, layer, KV, ks, vs))
    ref = fa.flash_attention_gqa_folded_plain(q.float(), k8, v8, lens_t,
                                              offs_t, layer, KV, ks, vs)
    rows = [min(L, n - o) for o, n in zip(offs, lens)]
    assert bool(torch.isfinite(got.float()).all())
    assert _rows_err(got, ref, rows) <= BF16_ATOL
    controls = [fa.flash_attention_gqa_folded_plain(
        q.float(), k8, v8, lens_t, offs_t, layer, KV, *_rolled(ks, vs, dim))
        for dim in (2, 3)]                # one position off, wrong kv head
    if bits == 4:
        controls.append(fa.flash_attention_gqa_folded_plain(
            q.float(), _swapped(k8), _swapped(v8), lens_t, offs_t, layer, KV,
            ks, vs))
    for broken in controls:
        assert _rows_err(broken, ref, rows) > 4 * BF16_ATOL


@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("B,L,P,H,KV", [
    (8, 64, 1000, 28, 4),      # 128-row CTAs straddle batch rows
    (3, 20, 130, 8, 2),        # 64-row tiles cross batch rows
    (2, 64, 2000, 28, 4),      # the prefix split over keys
])
def test_shared_prefix_int8_kernel(dev, B, L, P, H, KV, bits):
    g = torch.Generator(device=dev).manual_seed(8)
    hd = 128
    q = Q_SCALE * torch.randn(B, L, H, hd, generator=g, device=dev)
    q[..., 0] += FOCUS
    q = q.bfloat16()
    pk8, pks = _int8(torch.randn(P, KV, hd, generator=g,
                                 device=dev).bfloat16(), bits)
    pv8, pvs = _int8((0.5 * torch.randn(P, KV, hd, generator=g,
                                        device=dev)).bfloat16(), bits)
    pk8, pv8 = pk8.reshape(P, KV, -1), pv8.reshape(P, KV, -1)
    sk = torch.randn(B, L, KV, hd, generator=g, device=dev)
    sk[..., 0] += FOCUS
    sk = sk.bfloat16()
    sv = (0.5 * torch.randn(B, L, KV, hd, generator=g, device=dev)).bfloat16()
    slens = [L - (7 * b) % L for b in range(B)]
    slens_t = torch.tensor(slens, dtype=torch.int32, device=dev)
    got = _launched(f"shared_prefix_attention_int{bits}",
                    lambda: fa.flash_attention_shared_prefix(
                        q, pk8, pv8, sk, sv, slens_t, pks, pvs))
    assert torch.equal(got, fa.flash_attention_shared_prefix(
        q, pk8, pv8, sk, sv, slens_t, pks, pvs))
    ref = mha_shared_prefix_reference(q.float(), pk8, pv8, sk, sv, slens_t,
                                      pks, pvs)
    assert bool(torch.isfinite(got.float()).all())
    assert _rows_err(got, ref, slens) <= BF16_ATOL
    controls = [mha_shared_prefix_reference(q.float(), pk8, pv8, sk, sv,
                                            slens_t, *_rolled(pks, pvs, dim))
                for dim in (0, 1)]        # one position off, wrong kv head
    if bits == 4:
        controls.append(mha_shared_prefix_reference(
            q.float(), _swapped(pk8), _swapped(pv8), sk, sv, slens_t, pks,
            pvs))
    for broken in controls:
        assert _rows_err(broken, ref, slens) > 4 * BF16_ATOL


def test_int8_wrappers_reject_what_the_kernels_do_not_take(dev):
    cache = torch.zeros(2, 1, 16, 256, device=dev, dtype=torch.int8)
    scale = torch.zeros(2, 1, 16, 2, 1, device=dev)
    q1 = torch.zeros(1, 1, 4, 128, device=dev, dtype=torch.bfloat16)
    n = torch.ones(1, dtype=torch.int32, device=dev)
    with pytest.raises(ValueError):                        # no scales
        da.decode_attention(q1, cache, cache, n, 1, 2)
    with pytest.raises(ValueError):                        # scales per layer
        da.decode_attention(q1, cache, cache, n, 1, 2, scale[1], scale[1])
    q64 = torch.zeros(1, 64, 4, 128, device=dev, dtype=torch.bfloat16)
    with pytest.raises(ValueError):                        # f64 scales
        fa.flash_attention_gqa_folded(q64, cache, cache, n, n, 1, 2,
                                      scale.double(), scale.double())
    pk = torch.zeros(16, 2, 128, device=dev, dtype=torch.int8)
    sk = torch.zeros(1, 64, 2, 128, device=dev, dtype=torch.bfloat16)
    with pytest.raises(ValueError):                        # no prefix scales
        fa.flash_attention_shared_prefix(q64, pk, pk, sk, sk, n)
    w = torch.zeros(64, 1000, device=dev, dtype=torch.int8)
    with pytest.raises(ValueError):                        # out % 16 != 0
        qm.int8_matvec(torch.zeros(1, 64, device=dev, dtype=torch.bfloat16),
                       w, torch.zeros(1, 1000, device=dev,
                                      dtype=torch.bfloat16))


def test_int4_wrappers_reject_what_the_kernels_do_not_take(dev):
    packed = torch.zeros(2, 1, 16, 128, device=dev, dtype=torch.uint8)
    scale = torch.zeros(2, 1, 16, 2, 1, device=dev)
    q1 = torch.zeros(1, 1, 4, 128, device=dev, dtype=torch.bfloat16)
    n = torch.ones(1, dtype=torch.int32, device=dev)
    with pytest.raises(ValueError):                        # no scales
        da.decode_attention(q1, packed, packed, n, 1, 2)
    wide = torch.zeros(2, 1, 16, 256, device=dev, dtype=torch.uint8)
    with pytest.raises(ValueError):                        # unpacked width
        da.decode_attention(q1, wide, wide, n, 1, 2, scale, scale)
    odd = torch.zeros(2 * 16 * 128 + 4, device=dev,
                      dtype=torch.uint8)[4:].reshape(2, 1, 16, 128)
    with pytest.raises(ValueError):                        # misaligned
        da.decode_attention(q1, odd, odd, n, 1, 2, scale, scale)
    q64 = torch.zeros(1, 64, 4, 128, device=dev, dtype=torch.bfloat16)
    with pytest.raises(ValueError):                        # unpacked width
        fa.flash_attention_gqa_folded(q64, wide, wide, n, n, 1, 2, scale,
                                      scale)
    pk = torch.zeros(16, 2, 128, device=dev, dtype=torch.uint8)
    sk = torch.zeros(1, 64, 2, 128, device=dev, dtype=torch.bfloat16)
    ps = torch.zeros(16, 2, 1, device=dev)
    with pytest.raises(ValueError):                        # no prefix scales
        fa.flash_attention_shared_prefix(q64, pk[..., :64], pk[..., :64],
                                         sk, sk, n)
    with pytest.raises(ValueError):                        # unpacked width
        fa.flash_attention_shared_prefix(q64, pk, pk, sk, sk, n, ps, ps)


# ---- training: B2 with the logsumexp and B6 (dQ, dK/dV), each against its
# plain version in f32 on the same bf16 values; B6 within B6_REL of the
# largest reference gradient, with controls (one q head per group, delta
# left out, the causal mask dropped) that must miss it by 4x

B6_REL = 2e-2
LSE_ATOL = 1e-3


def _train_inputs(dev, B, L, H, KV, lengths, seed):
    g = torch.Generator(device=dev).manual_seed(seed)
    q = (Q_SCALE * torch.randn(B, L, H, 128, generator=g, device=dev)
         ).bfloat16()
    k = torch.randn(B, L, KV, 128, generator=g, device=dev).bfloat16()
    v = (0.5 * torch.randn(B, L, KV, 128, generator=g, device=dev)).bfloat16()
    do = torch.randn(B, L, H, 128, generator=g, device=dev).bfloat16()
    return q, k, v, do, torch.tensor(lengths, dtype=torch.int32, device=dev)


def _rel(a, b):
    return float((a.float() - b.float()).abs().max()) \
        / float(b.float().abs().max())


TRAIN_CASES = [(2, 300, 8, 2, [300, 150]), (1, 256, 28, 4, [200]),
               (1, 129, 2, 2, [129]), (2, 257, 7, 1, [1, 128]),
               (1, 257, 4, 1, [129])]


@pytest.mark.parametrize("B,L,H,KV,lengths", TRAIN_CASES)
def test_flash_lse_kernel(dev, B, L, H, KV, lengths):
    q, k, v, _, lens = _train_inputs(dev, B, L, H, KV, lengths, 11)
    out, lse = _launched("flash_attention_lse",
                         lambda: fa.flash_attention_fwd(q, k, v, lens))
    # the same tile code as the inference instantiation: the same output
    assert torch.equal(out, fa.flash_attention(q, k, v, lengths=lens))
    ref_out, ref_lse = fa.flash_attention_fwd_plain(q.float(), k.float(),
                                                    v.float(), lens)
    assert _rows_err(out, ref_out, lengths) <= BF16_ATOL
    assert float((lse - ref_lse).abs().max()) <= LSE_ATOL
    _, no_causal = fa.flash_attention_fwd_plain(q.float(), k.float(),
                                                v.float(), lens, causal=False)
    assert float((no_causal - ref_lse).abs().max()) > 4 * LSE_ATOL


@pytest.mark.parametrize("B,L,H,KV,lengths", TRAIN_CASES)
def test_flash_bwd_kernels(dev, B, L, H, KV, lengths):
    """The fused B6 (one launch) against its plain version in f32; dQ's
    TMA reduce-adds run in any order, within the same bound."""
    q, k, v, do, lens = _train_inputs(dev, B, L, H, KV, lengths, 12)
    out, lse = fa.flash_attention_fwd(q, k, v, lens)
    dq, dk, dv = _launched("flash_attention_bwd",
                           lambda: fa.flash_attention_bwd(q, k, v, out, lse,
                                                          do, lens))
    f = [t.float() for t in (q, k, v, out)]
    ref = fa.flash_attention_bwd_plain(*f, lse, do.float(), lens)
    for got, want in zip((dq, dk, dv), ref):
        assert bool(torch.isfinite(got.float()).all())
        assert _rel(got, want) <= B6_REL
    G = H // KV
    one_head = fa.flash_attention_bwd_plain(
        f[0][:, :, ::G], f[1], f[2], f[3][:, :, ::G], lse[:, ::G],
        do.float()[:, :, ::G], lens)
    no_delta = fa.flash_attention_bwd_plain(f[0], f[1], f[2],
                                            torch.zeros_like(f[3]), lse,
                                            do.float(), lens)
    no_causal = fa.flash_attention_bwd_plain(*f, lse, do.float(), lens,
                                             causal=False)
    if G > 1:
        assert _rel(one_head[1], ref[1]) > 4 * B6_REL
    assert _rel(no_delta[0], ref[0]) > 4 * B6_REL
    assert max(_rel(a, b) for a, b in zip(no_causal, ref)) > 4 * B6_REL


def test_flash_bwd_rejects_an_f32_do_untouched(dev):
    """B6 takes a bf16 dO: an f32 one raises before any launch and is not
    written on the way (delta multiplies an f32 copy)."""
    q, k, v, do, lens = _train_inputs(dev, 1, 129, 2, 2, [129], 14)
    out, lse = fa.flash_attention_fwd(q, k, v, lens)
    do32 = do.float()
    kept = do32.clone()
    before = _build.LAUNCHES["flash_attention_bwd"]
    with pytest.raises(ValueError):
        fa.flash_attention_bwd(q, k, v, out, lse, do32, lens)
    assert torch.equal(do32, kept)
    assert _build.LAUNCHES["flash_attention_bwd"] == before


def test_flash_train_function_on_the_gpu(dev):
    """mha_train on CUDA tensors: the forward launches B2 with the lse, the
    backward B6 once; gradients agree with the plain versions."""
    from video3d_tpu_torch.kernels.attention import mha_train

    q, k, v, do, lens = _train_inputs(dev, 1, 200, 8, 2, [170], 13)
    before = dict(_build.LAUNCHES)
    args = [t.clone().requires_grad_(True) for t in (q, k, v)]
    mha_train(*args, lens).backward(do)
    torch.cuda.synchronize()
    for name in ("flash_attention_lse", "flash_attention_bwd"):
        assert _build.LAUNCHES[name] == before[name] + 1
    out, lse = fa.flash_attention_fwd_plain(q.float(), k.float(), v.float(),
                                            lens)
    ref = fa.flash_attention_bwd_plain(q.float(), k.float(), v.float(), out,
                                       lse, do.float(), lens)
    for a, want in zip(args, ref):
        assert _rel(a.grad, want) <= B6_REL


# ---- kernel B7: paged decode attention over stacked page pools (bf16, int8
# and int4), against its plain version in f32 on the same values: three prefix
# pages aliased by every slot (13 live pages over a pool of 12), a
# kv_len == 0 slot, a slot ending mid-page; the last 4 keys of each slot
# carry most of the weight, so the controls (a table entry pointed at
# another slot's page, kv_len one short, scales of the wrong kv head, int4
# nibbles swapped) move the output by far more than the bound

def _paged_case(dev, form, seed, H=8, KV=2, page=16, lens=(80, 70, 0, 45),
                table=None, P=12):
    """Stacked (2, P, page, KV*hd) pools (quantized: with (2, P, KV, 1,
    page) scales), layer 1 read; by default every slot aliases pages 1-3
    and owns two pages after them."""
    g = torch.Generator(device=dev).manual_seed(seed)
    NL, hd, layer = 2, 128, 1
    lens = list(lens)
    if table is None:
        table = [[1, 2, 3, 4 + 2 * b, 5 + 2 * b] for b in range(len(lens))]
    table = torch.tensor(table, dtype=torch.int32, device=dev)
    q = _peaked_q(g, dev, len(lens), H)
    k = torch.randn(NL, P, page, KV, hd, generator=g, device=dev)
    v = 0.5 * torch.randn(NL, P, page, KV, hd, generator=g, device=dev)
    _focus_last(k, lens, lambda b, s_: (layer, int(table[b, s_ // page]),
                                        s_ % page))
    ks = vs = None
    if form == "bf16":
        k, v = (x.reshape(NL, P, page, KV * hd).bfloat16().contiguous()
                for x in (k, v))
    else:
        storage = torch.int8 if form == "int8" else torch.uint8
        k, ks = quantize_rows(k.bfloat16(), storage)
        v, vs = quantize_rows(v.bfloat16(), storage)
        ks, vs = (x.permute(0, 1, 3, 4, 2).contiguous() for x in (ks, vs))
    kv_len = torch.tensor(lens, dtype=torch.int32, device=dev)
    return q, k, v, table, kv_len, layer, KV, ks, vs


# B7 cases beside the first (G = 4, pages of 16, a kv_len 0 slot, slots
# ending mid-page): G = 7 over pages of 128 (the serving page), every slot
# aliasing pages 1-2, at the capacity (384), 257, 0 and 1; G = 8 and G = 1
# over pages of 16 with rows of 255 and 256 positions
PAGED_CASES = [
    {},
    dict(H=28, KV=4, page=128, lens=(384, 257, 0, 1),
         table=[[1, 2, 3 + b] for b in range(4)], P=8),
    dict(H=16, KV=2, lens=(80, 255, 256, 3), P=44,
         table=[[1, 2, 3] + list(range(4 + 13 * b, 17 + 13 * b))
                for b in range(3)] + [[1, 2, 3] + [0] * 13]),
    dict(H=4, KV=4, lens=(256, 0, 255, 17), P=44,
         table=[[1, 2, 3] + list(range(4 + 13 * b, 17 + 13 * b))
                for b in range(3)] + [[1, 2, 3] + [0] * 13])]


@pytest.mark.parametrize("case", range(len(PAGED_CASES)))
@pytest.mark.parametrize("form", ["bf16", "int8", "int4"])
def test_paged_kernel(dev, form, case):
    q, k, v, table, kv_len, layer, KV, ks, vs = _paged_case(
        dev, form, 8 + case, **PAGED_CASES[case])
    name = "paged_attention" + ("" if form == "bf16" else f"_{form}")
    call = lambda: pa.paged_decode_attention(q, k, v, table, kv_len, layer,
                                             KV, ks, vs)
    got = _launched(name, call)
    ref = pa.paged_attention_plain(q.float(), k, v, table, kv_len, layer, KV,
                                   ks, vs)
    assert got.dtype == torch.bfloat16 and bool(torch.isfinite(
        got.float()).all())
    assert float((got.float() - ref).abs().max()) <= BF16_ATOL
    for b in (kv_len == 0).nonzero().flatten().tolist():
        assert bool((got[b] == 0).all())           # a kv_len == 0 slot
    _same_bits(call, got)
    b0 = int(kv_len.argmax())
    last = (int(kv_len[b0]) - 1) // k.shape[2]
    other = (b0 + 1) % len(kv_len)
    wrong_page = table.clone()
    wrong_page[b0, last] = table[other, -1] if table[other, -1] != \
        table[b0, last] else table[other, 0]
    controls = [
        pa.paged_attention_plain(q.float(), k, v, wrong_page, kv_len, layer,
                                 KV, ks, vs),
        pa.paged_attention_plain(q.float(), k, v, table,
                                 (kv_len - 1).clamp(min=0), layer, KV, ks,
                                 vs)]
    if form != "bf16":
        controls.append(pa.paged_attention_plain(
            q.float(), k, v, table, kv_len, layer, KV,
            *_rolled(ks, vs, 2)))
    if form == "int4":
        controls.append(pa.paged_attention_plain(
            q.float(), _swapped(k), _swapped(v), table, kv_len, layer, KV,
            ks, vs))
    for broken in controls:
        assert float((broken - ref).abs().max()) > 4 * BF16_ATOL


def test_paged_wrapper_rejects_what_the_kernel_does_not_take(dev):
    q, k, v, table, kv_len, layer, KV, ks, vs = _paged_case(dev, "int8", 9)
    with pytest.raises(ValueError):                  # f32 query
        pa.paged_decode_attention(q.float(), k, v, table, kv_len, layer, KV,
                                  ks, vs)
    with pytest.raises(ValueError):                  # int8 pools, no scales
        pa.paged_decode_attention(q, k, v, table, kv_len, layer, KV)
    with pytest.raises(ValueError):                  # scales (.., page, KV)
        pa.paged_decode_attention(q, k, v, table, kv_len, layer, KV,
                                  ks.transpose(2, 4), vs.transpose(2, 4))
    with pytest.raises(ValueError):                  # no layer 2
        pa.paged_decode_attention(q, k, v, table, kv_len, 2, KV, ks, vs)
    with pytest.raises(ValueError):                  # a length per slot
        pa.paged_decode_attention(q, k, v, table, kv_len[:3], layer, KV, ks,
                                  vs)
    with pytest.raises(ValueError):                  # a table row per slot
        pa.paged_decode_attention(q, k, v, table[:3], kv_len, layer, KV, ks,
                                  vs)
    with pytest.raises(ValueError):                  # G = 16 > 8 heads
        pa.paged_decode_attention(q.repeat(1, 1, 4, 1), k, v, table, kv_len,
                                  layer, KV, ks, vs)


@pytest.mark.parametrize("form", ["kv", "one_int8", "one_bf16", "multi",
                                  "contig", "split"])
def test_stream_probe_kernel(dev, form):
    """B9 against its plain version: rows and checksums equal; the controls
    (a checksum skipping each block's last row; B9d one block late) differ."""
    from video3d_tpu_torch.kernels import stream_probe as sp

    g = torch.Generator(device=dev).manual_seed(40)

    def int8(*shape):
        return torch.randint(-127, 128, shape, generator=g, dtype=torch.int8,
                             device=dev)

    t = torch.full((1, 1), 3e-6, device=dev)
    IN, OUT, bo = 96, 3072, 256
    if form == "kv":
        k, v = int8(1024, 4, 128), int8(1024, 4, 128)
        th = torch.linspace(-1, 1, 128, device=dev)
        name, args = "stream_probe_kv", (k, v, th, 256)
        fn, plain = sp.kv_probe, sp.kv_probe_plain
    elif form.startswith("one"):
        q = int8(IN, OUT).to(torch.int8 if form == "one_int8"
                             else torch.bfloat16)
        name, args = "stream_probe_one", (q, t, bo)
        fn, plain = sp.matvec_probe, sp.matvec_probe_plain
    elif form in ("multi", "contig"):
        qs = [int8(IN, OUT) for _ in range(3)]
        if form == "contig":
            qs = [sp.tile_contig(q, bo) for q in qs]
        name, args = "stream_probe_multi", (qs, t, bo, form == "contig")
        fn, plain = sp.stream_probe, sp.stream_probe_plain
    else:
        name, args = "stream_probe_split", (int8(IN, OUT), t, bo, 4)
        fn, plain = sp.split_probe, sp.split_probe_plain
    out, sums = _launched(name, lambda: fn(*args))
    ref_out, ref_sums = plain(*args)
    assert torch.equal(out, ref_out) and torch.equal(sums, ref_sums)
    _, bad = plain(*args, skip_last_row=True)
    assert bool((bad != sums).all())
    if form == "split":
        shifted, _ = plain(*args, shift=1)
        assert not torch.equal(shifted, out)


def test_stream_probe_wrappers_reject_what_the_kernel_does_not_take(dev):
    from video3d_tpu_torch.kernels import stream_probe as sp

    q = torch.zeros(64, 1024, dtype=torch.int8, device=dev)
    t = torch.zeros(1, 1, device=dev)
    with pytest.raises(ValueError):
        sp.matvec_probe(q.float(), t, 256)
    with pytest.raises(ValueError):
        sp.matvec_probe(q.t().contiguous().t(), t, 256)
    with pytest.raises(ValueError):
        sp.matvec_probe(q[:, 8:1016], t, 252)
    with pytest.raises(ValueError):
        sp.split_probe(q, t, 256, 3)
    with pytest.raises(ValueError):
        sp.matvec_probe(q, t.double(), 256)


@pytest.mark.parametrize("bs", [4096, 8192, 16384])
def test_kv_probe_bulk_ring(dev, bs):
    """B9a's bulk-copy ring at the probe script's shape, every block size:
    rows and checksums equal to the plain version in two calls (the same
    bits); the checksum skipping each block's last row differs."""
    from video3d_tpu_torch.kernels import stream_probe as sp

    g = torch.Generator(device=dev).manual_seed(41)
    kv = torch.randint(-127, 128, (2, 32768, 4, 128), generator=g,
                       dtype=torch.int8, device=dev)
    k, v = kv[0], kv[1]
    t = torch.linspace(-1, 1, 128, device=dev)
    first = _launched("stream_probe_kv", lambda: sp.kv_probe(k, v, t, bs))
    second = sp.kv_probe(k, v, t, bs)
    ref = sp.kv_probe_plain(k, v, t, bs)
    for a, b, c in zip(first, second, ref):
        assert torch.equal(a, b) and torch.equal(a, c)
    _, bad = sp.kv_probe_plain(k, v, t, bs, skip_last_row=True)
    assert bool((bad != first[1]).all())


# ---- the decode loops as captured CUDA graphs (models/decode_graph.py)

CAPTURE_LAYERS = 2
CAPTURE_CASES = [(w, c) for w, c in ((16, "bf16"), (16, "int8"),
                                     (16, "int4"), (8, "bf16"), (4, "bf16"))]


@pytest.fixture(scope="module")
def decoders(dev):
    """Qwen2-7B's decoder at full width cut to CAPTURE_LAYERS layers, in
    bf16, int8 and int4 weights, from one seed."""
    import dataclasses

    from video3d_tpu_torch.config import ModelConfig
    from video3d_tpu_torch.models import qwen2

    cfg = ModelConfig()
    cfg = dataclasses.replace(cfg, llm=dataclasses.replace(
        cfg.llm, num_hidden_layers=CAPTURE_LAYERS))
    out = {}
    for bits in (16, 8, 4):
        g = torch.Generator(device=dev).manual_seed(0)
        out[bits] = {"llm": qwen2.init_qwen2(cfg.llm, dev, g,
                                             torch.bfloat16, bits)}
    return cfg, out


def _decode_states(cfg, dev, slots, form, seed=1):
    """A dense and a paged state of ``slots`` live rows over the same
    random K/V (rows of ~600 positions, pages of 64)."""
    from video3d_tpu_torch.models import generate as gen
    from video3d_tpu_torch.models import qwen2

    dtype = {"bf16": torch.bfloat16, "int8": torch.int8,
             "int4": qwen2.KV_INT4}[form]
    g = torch.Generator(device=dev).manual_seed(seed)
    page, maxp = 64, 12
    lens = [600 + 13 * s for s in range(slots)]
    dense = gen.empty_decode_state(cfg, slots, page * maxp, dtype,
                                   device=dev)
    paged = gen.empty_paged_state(cfg, slots, 1 + slots * maxp, page, maxp,
                                  dtype, device=dev)
    with torch.inference_mode():
        for t in dense.cache:
            if t is None:
                continue
            if t.dtype == torch.float32:
                t.uniform_(0.005, 0.02, generator=g)
            elif t.dtype == torch.bfloat16:
                t.normal_(generator=g)
            else:
                t.copy_(torch.randint(-7 if form == "int4" else -127, 8
                                      if form == "int4" else 128, t.shape,
                                      generator=g, device=dev)
                        .to(t.dtype))
        for s, n in enumerate(lens):
            row = torch.arange(1 + s * maxp, 1 + (s + 1) * maxp,
                               dtype=torch.int32, device=dev)
            sub = qwen2.KVCache(*(None if t is None else t[:, s:s + 1]
                                  for t in dense.cache))
            gen.insert_paged_slot(
                paged, s, gen.DecodeState(
                    torch.zeros(1, cfg.llm.vocab_size, device=dev), sub,
                    torch.tensor([n], device=dev),
                    torch.zeros(1, dtype=torch.bool, device=dev),
                    torch.zeros((), dtype=torch.long, device=dev)),
                row, maxp)
            dense.pos[s] = n
        logits = torch.randn(slots, cfg.llm.vocab_size, generator=g,
                             device=dev)
        for st in (dense, paged):
            st.next_logits.copy_(logits)
            st.done.fill_(False)
    return dense, paged


def _expected_step_launches(params, bits, form, layout, slots, layers):
    from video3d_tpu_torch.kernels.decode_attention import CACHE_FORMS
    from video3d_tpu_torch.models import qwen2

    suffix = CACHE_FORMS[qwen2.kv_storage_dtype(
        {"bf16": torch.bfloat16, "int8": torch.int8,
         "int4": qwen2.KV_INT4}[form])]
    name = ("paged_attention" if layout == "paged" else "decode_attention")
    out = {name + suffix: layers}
    if bits == 4:
        out["int4_matmul"] = 7 * layers + 1
    elif bits == 8:
        out["int8_matmul"] = 7 * layers + (slots > 1)
        if slots == 1:
            out["int8_matvec"] = 1
    return out


@pytest.mark.parametrize("slots", [1, 8])
@pytest.mark.parametrize("layout", ["dense", "paged"])
@pytest.mark.parametrize("bits,form", CAPTURE_CASES)
def test_captured_chunk_equals_uncaptured(dev, decoders, bits, form, layout,
                                          slots):
    """A 4-step decode chunk replayed as a CUDA graph against the same
    chunk uncaptured, from copies of one state: tokens and next logits bit
    for bit, the state's own tensors written; launch counts exact over the
    warm-up and three replays."""
    from video3d_tpu_torch.models import generate as gen
    from video3d_tpu_torch.models.decode_graph import (DecodeGraphs,
                                                       state_tensors)

    cfg, models = decoders
    params = models[bits]
    dense, paged = _decode_states(cfg, dev, slots, form)
    state = dense if layout == "dense" else paged
    fn = gen.decode_chunk if layout == "dense" else gen.paged_decode_chunk
    eos, steps = -1, 4
    with torch.inference_mode():
        start = [t.clone() for t in state_tensors(state)]
        eager = type(state)(*(
            type(x)(*(None if t is None else t.clone() for t in x))
            if isinstance(x, tuple) else x.clone() for x in state))
        _, want = fn(params, cfg, eager, steps, eos, capture=False)
        graphs = DecodeGraphs(dev)
        ptrs = [t.data_ptr() for t in state_tensors(state)]
        _build.reset_launches()
        for i in range(4):
            for t, s in zip(state_tensors(state), start):
                t.copy_(s)
            out, toks = fn(params, cfg, state, steps, eos, graphs=graphs)
            assert out is state
            assert torch.equal(toks, want), i
            assert torch.equal(state.next_logits, eager.next_logits), i
        torch.cuda.synchronize()
    assert [t.data_ptr() for t in state_tensors(state)] == ptrs
    assert graphs.captures == 1 and graphs.replays == 3
    per_step = _expected_step_launches(params, bits, form, layout, slots,
                                       CAPTURE_LAYERS)
    launched = {k: v for k, v in _build.LAUNCHES.items() if v}
    assert launched == {k: 4 * steps * v for k, v in per_step.items()}


def _adapted(params, dev, r=16, seed=5):
    """``params`` with every decoder projection a ``LoraAdapted`` over its
    (quantized) base, factors N(0, 0.02) in bf16 (B too, so the delta is
    visible)."""
    from video3d_tpu_torch.models.quant import LoraAdapted

    g = torch.Generator(device=dev).manual_seed(seed)
    out = {"llm": dict(params["llm"])}
    layers = []
    for lp in params["llm"]["layers"]:
        lp = dict(lp)
        for grp in ("attn", "mlp"):
            sub = dict(lp[grp])
            for name, w in lp[grp].items():
                if not name.startswith("w"):
                    continue
                din, dout = (w.dims if hasattr(w, "dims")
                             else w["q"].shape)
                A = 0.02 * torch.randn(din, r, generator=g, device=dev)
                B = 0.02 * torch.randn(r, dout, generator=g, device=dev)
                sub[name] = LoraAdapted(w, A.bfloat16(), B.bfloat16(), 2.0)
            lp[grp] = sub
        layers.append(lp)
    out["llm"]["layers"] = layers
    return out


@pytest.mark.parametrize("bits,rows", [(8, 1), (8, 8), (4, 1), (4, 8)])
def test_lora_adapted_decode_rows_through_the_stream_kernels(dev, bits,
                                                             rows):
    """A decode-row ``LoraAdapted`` product: its base term launches B4's
    B>1 form (int8) or B8 (int4), and the whole is within one bf16 ulp of
    |base| + |delta| of the f32 plain base term plus the same bf16 delta
    (the kernel rounds the base term, the sum is rounded again); an input
    that requires grad raises instead of launching."""
    from video3d_tpu_torch.models.quant import LoraAdapted, matmul

    g = torch.Generator(device=dev).manual_seed(21)
    in_, out = 3584, 512
    w = 0.02 * torch.randn(in_, out, generator=g, device=dev)
    base = quantize_weight(w) if bits == 8 else quantize_weight_int4(w)
    A = (0.02 * torch.randn(in_, 16, generator=g, device=dev)).bfloat16()
    B = (0.02 * torch.randn(16, out, generator=g, device=dev)).bfloat16()
    wa = LoraAdapted(base, A, B, 2.0)
    x = torch.randn(rows, in_, generator=g, device=dev).bfloat16()
    name = "int8_matmul" if bits == 8 else "int4_matmul"
    with torch.no_grad():
        got = _launched(name, lambda: matmul(x, wa))
        if bits == 8:
            plain = qm.int8_matmul_plain(x.float(), base["q"],
                                         base["scale"])
        else:
            plain = qm.int4_matmul_plain(x.float(), base.q4,
                                         base.scale4)[:, :out]
        delta = (((x @ A) @ B) * 2.0).float()
        ref = plain + delta
        ulp = 2.0 ** -7 * (plain.abs() + delta.abs()) + 1e-4
    assert got.dtype == torch.bfloat16 and got.shape == (rows, out)
    assert float(((got.float() - ref).abs() / ulp).max()) <= 1.0
    # control: the base term alone misses by the delta
    assert float(((plain - ref).abs() / ulp).max()) >= 4.0
    xg = x.clone().requires_grad_(True)
    with pytest.raises(RuntimeError, match="no backward"):
        matmul(xg, wa)


def test_captured_chunk_over_an_adapted_int8_base(dev, decoders):
    """A 4-step decode chunk over lazily adapted int8 weights, replayed as
    a CUDA graph, equals the uncaptured chunk bit for bit; the base terms
    launch B4 exactly as over the bare int8 base; the step's split
    buffers are planned by the bases."""
    from video3d_tpu_torch.kernels import _launch
    from video3d_tpu_torch.models import generate as gen
    from video3d_tpu_torch.models import decode_graph as dg

    cfg, models = decoders
    params = _adapted(models[8], dev)
    assert dg.weight_form(params) == "int8+lora"
    sms = _launch.sm_count(dev.index or 0)
    assert dg.step_buffers(params, cfg, 8, 8704, sms) == \
        dg.step_buffers(models[8], cfg, 8, 8704, sms)
    dense, _ = _decode_states(cfg, dev, 8, "bf16")
    steps = 4
    with torch.inference_mode():
        start = [t.clone() for t in dg.state_tensors(dense)]
        eager = type(dense)(*(
            type(x)(*(None if t is None else t.clone() for t in x))
            if isinstance(x, tuple) else x.clone() for x in dense))
        _, want = gen.decode_chunk(params, cfg, eager, steps, -1,
                                   capture=False)
        bare = type(dense)(*(
            type(x)(*(None if t is None else t.clone() for t in x))
            if isinstance(x, tuple) else x.clone() for x in dense))
        gen.decode_chunk(models[8], cfg, bare, steps, -1, capture=False)
        graphs = dg.DecodeGraphs(dev)
        _build.reset_launches()
        for i in range(3):
            for t, s in zip(dg.state_tensors(dense), start):
                t.copy_(s)
            _, toks = gen.decode_chunk(params, cfg, dense, steps, -1,
                                       graphs=graphs)
            assert torch.equal(toks, want), i
            assert torch.equal(dense.next_logits, eager.next_logits), i
        torch.cuda.synchronize()
    assert graphs.captures == 1 and graphs.replays == 2
    # control: the adapters move the logits off the bare base's
    assert not torch.equal(bare.next_logits, eager.next_logits)
    per_step = _expected_step_launches(models[8], 8, "bf16", "dense", 8,
                                       CAPTURE_LAYERS)
    launched = {k: v for k, v in _build.LAUNCHES.items() if v}
    assert launched == {k: 3 * steps * v for k, v in per_step.items()}


def test_replay_after_a_larger_key_grew_the_buffers(dev, decoders):
    """A B=1 int8 chunk captured, then a B=16 chunk on the same holder
    (its warm-up grows the capture stream's split buffers: more row tiles),
    then the B=1 graph replayed over freed memory refilled with junk: the
    uncaptured chunk's tokens and next logits bit for bit (the graph still
    holds the buffers it was captured with)."""
    from video3d_tpu_torch.kernels import _launch
    from video3d_tpu_torch.models import generate as gen
    from video3d_tpu_torch.models.decode_graph import (DecodeGraphs,
                                                       state_tensors)

    cfg, models = decoders
    params = models[8]
    graphs = DecodeGraphs(dev)
    key = (str(graphs.device), graphs.stream_id)
    # a pooled stream id may come back with an earlier holder's buffers
    _launch._counters.pop(key, None)
    _launch._workspaces.pop(key, None)
    small, _ = _decode_states(cfg, dev, 1, "int8")
    big, _ = _decode_states(cfg, dev, 16, "int8", seed=2)
    with torch.inference_mode():
        start = [t.clone() for t in state_tensors(small)]
        eager = type(small)(*(
            type(x)(*(None if t is None else t.clone() for t in x))
            if isinstance(x, tuple) else x.clone() for x in small))
        _, want = gen.decode_chunk(params, cfg, eager, 4, -1, capture=False)
        gen.decode_chunk(params, cfg, small, 4, -1, graphs=graphs)
        before = [b.data_ptr() for b in _launch.held(dev, graphs.stream_id)]
        gen.decode_chunk(params, cfg, big, 4, -1, graphs=graphs)
        after = [b.data_ptr() for b in _launch.held(dev, graphs.stream_id)]
        assert before[1] != after[1]          # the workspace grew
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        junk = torch.full((256 << 20,), -1, dtype=torch.int32, device=dev)
        for t, s in zip(state_tensors(small), start):
            t.copy_(s)
        _, toks = gen.decode_chunk(params, cfg, small, 4, -1, graphs=graphs)
        torch.cuda.synchronize()
        del junk
    assert graphs.captures == 2 and graphs.replays == 1
    assert torch.equal(toks, want)
    assert torch.equal(small.next_logits, eager.next_logits)


def test_captured_generate_equals_uncaptured(dev, decoders):
    """generate_from_state in captured chunks of 8 (the last cut to 3) on
    B=2, twice through one holder (the second call copied into the held
    state, all replays): the uncaptured loop's tokens and lengths."""
    from video3d_tpu_torch.models import generate as gen
    from video3d_tpu_torch.models.decode_graph import DecodeGraphs

    cfg, models = decoders
    graphs = DecodeGraphs(dev)
    for seed, captures in ((1, 2), (2, 2)):
        dense, _ = _decode_states(cfg, dev, 2, "int8", seed)
        copy = type(dense)(dense.next_logits.clone(),
                           type(dense.cache)(*(None if t is None else
                                               t.clone()
                                               for t in dense.cache)),
                           dense.pos.clone(), dense.done.clone(),
                           dense.step.clone())
        want = gen.generate_from_state(models[8], cfg, copy, 19, -1,
                                       capture=False)
        got = gen.generate_from_state(models[8], cfg, dense, 19, -1,
                                      graphs=graphs)
        assert torch.equal(got.tokens, want.tokens)
        assert torch.equal(got.lengths, want.lengths)
        assert graphs.captures == captures
    assert graphs.replays == 3 + 1


def test_reset_batcher_state_captures_anew(dev, decoders):
    """After ``_reset_state`` the batcher's decode chunks capture into a
    new holder over the new state: the old state's graphs never replay."""
    import types

    from video3d_tpu_torch.models import generate as gen
    from video3d_tpu_torch.serve.batcher import ContinuousBatcher

    cfg, models = decoders
    engine = types.SimpleNamespace(
        params=models[16], cfg=cfg, device=dev, cache_dtype=torch.bfloat16,
        ecfg=types.SimpleNamespace(buckets=(64,), max_new_tokens=8,
                                   eos_token_id=-1,
                                   speculative_draft_layers=0,
                                   speculative_k=4),
        draft_params=None, draft_cfg=None, _prefix_evict_hooks=[])
    b = ContinuousBatcher(engine, num_slots=2, chunk=2)
    try:
        with b._lock:
            old, old_graphs = b.state, b._graphs
            for _ in range(2):
                gen.decode_chunk(models[16], cfg, b.state, 2, -1,
                                 graphs=b._graphs)
            assert (old_graphs.captures, old_graphs.replays) == (1, 1)
            b._reset_state()
            assert b.state is not old and b._graphs is not old_graphs
            gen.decode_chunk(models[16], cfg, b.state, 2, -1,
                             graphs=b._graphs)
            assert (b._graphs.captures, b._graphs.replays) == (1, 0)
            assert old_graphs.replays == 1
    finally:
        b.shutdown()


# ---------------------------------------------------------------------------
# grounding on the card at a small width (head_dim 128, the kernels' own)
# ---------------------------------------------------------------------------

#: grounding scores (cosines) of a prefix hit or a batched query against
#: the full forward at this width in bf16
GROUND_ATOL = 2e-2


@pytest.fixture(scope="module")
def grounding(dev, tmp_path_factory):
    """A 2-layer decoder of head_dim 128 over the tiny tower, bf16, an
    INFONCE head; a 3-frame synthetic scene with 8 proposals; a factory of
    engines on the card."""
    import dataclasses
    import os

    from fixtures import FakeTokenizer, make_fake_scene

    from video3d_tpu_torch.config import DataConfig, ModelConfig
    from video3d_tpu_torch.data.video_processor import VideoProcessor
    from video3d_tpu_torch.eval import drivers
    from video3d_tpu_torch.params import init_model

    tiny = ModelConfig.tiny()
    cfg = dataclasses.replace(tiny, llm=dataclasses.replace(
        tiny.llm, hidden_size=512, intermediate_size=1024,
        num_attention_heads=4, num_key_value_heads=2, head_dim=128,
        mrope_section=(32, 16, 16)))
    params = init_model(cfg, dev, torch.Generator(device=dev).manual_seed(0),
                        torch.bfloat16)
    root = str(tmp_path_factory.mktemp("ground"))
    info = make_fake_scene(root, n_frames=3, n_objects=8)
    data_cfg = DataConfig(video_folder=root,
                          annotation_dir=os.path.join(root, "embodiedscan"),
                          metadata_dir=os.path.join(root, "metadata"),
                          frames_upbound=3)

    def engine(**kw):
        tok = FakeTokenizer()
        return drivers.InferenceEngine(
            params, cfg, tok, VideoProcessor(data_cfg),
            engine_cfg=drivers.EngineConfig(
                max_new_tokens=4, eos_token_id=tok.eos_token_id,
                max_frames=3, buckets=(512,), stop_str="",
                ground_token_id=tok.vocab["<ground>"], max_objects=8, **kw),
            device=dev)

    queries = [{
        "id": f"g{i}", "video": info["sample_idx"],
        "conversations": [
            {"from": "human", "value": f"<image>\nfind object number {i}"},
            {"from": "gpt", "value": "<ground>"}],
        "metadata": {"dataset": "scanrefer", "question_type": "unique"}}
        for i in range(4)]
    return engine, queries


def _same_grounding(got, want):
    for (s1, o1), (s2, o2) in zip(got, want):
        np.testing.assert_array_equal(o1, o2)
        assert np.isfinite(s1).all() and s1.shape == s2.shape
        np.testing.assert_allclose(s1, s2, rtol=0, atol=GROUND_ATOL)
        assert int(np.argmax(s1)) == int(np.argmax(s2))


def test_grounding_prefix_hits_match_the_full_forward(dev, grounding):
    """A miss (cached prefill, B2), then hits through ``ground_suffix`` (B2
    folded at B=1, each layer once): the full forward's scores."""
    engine, queries = grounding
    cached, plain = engine(prefix_cache_scenes=1), engine()
    got = [cached.ground(queries[0])]
    before = _build.LAUNCHES["flash_attention_folded"]
    got += [cached.ground(q) for q in queries[1:]]
    assert _build.LAUNCHES["flash_attention_folded"] - before == 2 * 3
    assert cached.prefix_cache_stats == [3, 1]
    _same_grounding(got, [plain.ground(q) for q in queries])


def test_grounding_batch_matches_single(dev, grounding):
    """``ground_batch`` at B=4 (one B2 prefill per layer) against ``ground``
    at B=1 on the same queries."""
    engine, queries = grounding
    plain = engine()
    single = [plain.ground(q) for q in queries]
    before = _build.LAUNCHES["flash_attention"]
    batched = plain.ground_batch(queries)
    assert _build.LAUNCHES["flash_attention"] - before == 2
    _same_grounding(batched, single)


def test_grounding_object_cache_is_the_recomputed_features(dev, grounding):
    """The object features a hit reads are those a miss on another engine
    recomputes, bit for bit."""
    engine, queries = grounding
    first, second = engine(prefix_cache_scenes=1), engine(prefix_cache_scenes=1)
    first.ground(queries[0])
    second.ground(queries[1])
    key = queries[0]["video"]
    assert torch.equal(first._ground_obj_cache[key][0],
                       second._ground_obj_cache[key][0])


# ---- the 2D-image modality on the card: the batched anyres encoder and an
# image-batch train mini-step through B2 with the lse and B6


@pytest.fixture(scope="module")
def image_batch(dev, tmp_path_factory):
    """A 2-layer decoder of head_dim 128 over the tiny tower, f32 master
    weights; two images of different anyres grids collated into one
    static-shape batch on the card."""
    import dataclasses
    import json

    from PIL import Image

    from fixtures import FakeTokenizer

    from video3d_tpu_torch.config import DataConfig, ModelConfig
    from video3d_tpu_torch.data.dataset import (Collator, CollatorConfig,
                                                SupervisedDataset)
    from video3d_tpu_torch.data.image_processor import SigLipImageProcessor
    from video3d_tpu_torch.params import init_model
    from video3d_tpu_torch.train.trainer import to_batch

    tiny = ModelConfig.tiny()
    pin = ((112, 56), (56, 112), (112, 112))
    cfg = dataclasses.replace(
        tiny, image_grid_pinpoints=pin, llm=dataclasses.replace(
            tiny.llm, hidden_size=512, intermediate_size=1024,
            num_attention_heads=4, num_key_value_heads=2, head_dim=128,
            mrope_section=(32, 16, 16)))
    root = tmp_path_factory.mktemp("images")
    rng = np.random.default_rng(0)
    for i, (w, h) in enumerate([(300, 200), (120, 400)]):
        Image.fromarray(rng.integers(0, 255, (h, w, 3), dtype=np.uint8)).save(
            root / f"img{i}.png")
    with open(root / "data.json", "w") as f:
        json.dump([{"id": i, "image": f"img{i}.png",
                    "conversations": [
                        {"from": "human", "value": "<image>\nwhat is shown"},
                        {"from": "gpt", "value": "a test pattern"}]}
                   for i in range(2)], f)
    ds = SupervisedDataset(str(root / "data.json"), FakeTokenizer(),
                           DataConfig(image_folder=str(root),
                                      image_grid_pinpoints=pin),
                           image_processor=SigLipImageProcessor(
                               size=(56, 56)))
    arrays = Collator(cfg, CollatorConfig(max_len=256))([ds[0], ds[1]])
    params = init_model(cfg, dev, torch.Generator(device=dev).manual_seed(0),
                        torch.float32)
    return cfg, params, arrays, to_batch(arrays, dev)


def test_encode_image_2d_batch_on_the_card(dev, image_batch):
    """The gather-plan encoder on the card against the same encoder on the
    CPU in f32 (TF32 off), and each row against the per-image
    arrangement on the card."""
    from video3d_tpu_torch.models import anyres
    from video3d_tpu_torch.params import from_jax_tree

    cfg, params, arrays, batch = image_batch
    with torch.no_grad():
        got = anyres.encode_image_2d_batch(
            params, cfg, batch.image_tiles, batch.vision_gather,
            batch.vision_newline, batch.vision_valid)
        host = from_jax_tree({k: _to_numpy(params[k]) for k in
                              ("vision", "projector", "image_newline")},
                             "cpu")
        want = anyres.encode_image_2d_batch(
            host, cfg, batch.image_tiles.cpu(), batch.vision_gather.cpu(),
            batch.vision_newline.cpu(), batch.vision_valid.cpu())
        assert got.shape == want.shape and got.device.type == "cuda"
        assert _rel(got.cpu(), want) <= 1e-4
        for row, size in enumerate([(300, 200), (120, 400)]):
            n = int((arrays["image_tiles"][row] != 0).any(
                axis=(1, 2, 3)).sum())
            one = anyres.encode_image_2d(params, cfg,
                                         batch.image_tiles[row, :n], size,
                                         cfg.image_grid_pinpoints)
            assert _rel(got[row, :one.shape[0]], one) <= 1e-4
            assert not got[row, one.shape[0]:].any()


def _to_numpy(tree):
    if isinstance(tree, dict):
        return {k: _to_numpy(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to_numpy(v) for v in tree]
    return tree.detach().cpu().numpy()


class _PlainTrainAttention(torch.autograd.Function):
    """``mha_train`` by the plain versions of B2 with the lse and of B6 in
    f32 on the kernels' bf16 inputs."""

    @staticmethod
    def forward(ctx, q, k, v, lengths):
        out, lse = fa.flash_attention_fwd_plain(q.float(), k.float(),
                                                v.float(), lengths)
        ctx.save_for_backward(q, k, v, out, lse, lengths)
        return out.to(q.dtype)

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse, lengths = ctx.saved_tensors
        grads = fa.flash_attention_bwd_plain(q.float(), k.float(), v.float(),
                                             out, lse, do.float(), lengths)
        return (*(g.to(t.dtype) for g, t in zip(grads, (q, k, v))), None)


def test_image_train_step_through_the_kernels(dev, image_batch, monkeypatch):
    """One image-batch mini-step (bf16 compute over the f32 masters, remat)
    through B2 with the lse (2 x layers) and B6 (layers): its loss and
    gradient norm against the same mini-step with the plain attention
    swapped in, within phase 7's bounds of chip_smoke.py."""
    from video3d_tpu_torch.models import qwen2
    from video3d_tpu_torch.train.optim import global_norm, tree_leaves
    from video3d_tpu_torch.train.train_step import loss_fn

    cfg, params, _, batch = image_batch
    leaves = tree_leaves(params)

    def step():
        for t in leaves:
            t.requires_grad_(True)
        try:
            loss, _ = loss_fn(params, cfg, batch, remat=True,
                              compute_dtype=torch.bfloat16)
            grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        finally:
            for t in leaves:
                t.requires_grad_(False)
        return float(loss.detach()), float(global_norm(
            [g for g in grads if g is not None]))

    before = dict(_build.LAUNCHES)
    loss, gn = step()
    torch.cuda.synchronize()
    L = cfg.llm.num_hidden_layers
    ran = {k: v - before[k] for k, v in _build.LAUNCHES.items()
           if v != before[k]}
    assert ran == {"flash_attention_lse": 2 * L, "flash_attention_bwd": L}
    monkeypatch.setattr(qwen2, "mha_train", _PlainTrainAttention.apply)
    p_loss, p_gn = step()
    assert np.isfinite(loss) and abs(loss - p_loss) <= 2e-3 * abs(p_loss)
    assert abs(gn - p_gn) <= 2e-2 * p_gn


# ---- the serving stack on the card (chip_smoke phase 17's checks at a
# small size): the HTTP worker's routes against the engine, the stream and
# per-request overrides (eager: no captured entry added), 2D images, the
# host-geometry route and the batcher worker


@pytest.fixture(scope="module")
def serving(dev, tmp_path_factory):
    """A 2-layer decoder of head_dim 128 over the tiny tower, bf16; a
    3-frame synthetic scene; an engine factory sharing one FakeTokenizer
    whose words are numbered up front; a sequential worker on a free
    port."""
    import dataclasses
    import os
    import socket

    from fixtures import FakeTokenizer, make_fake_scene

    from video3d_tpu_torch.config import DataConfig, ModelConfig
    from video3d_tpu_torch.data.video_processor import VideoProcessor
    from video3d_tpu_torch.eval import drivers
    from video3d_tpu_torch.params import init_model
    from video3d_tpu_torch.serve.model_worker import serve_worker

    tiny = ModelConfig.tiny()
    cfg = dataclasses.replace(tiny, llm=dataclasses.replace(
        tiny.llm, hidden_size=512, intermediate_size=1024,
        num_attention_heads=4, num_key_value_heads=2, head_dim=128,
        mrope_section=(32, 16, 16)))
    params = init_model(cfg, dev, torch.Generator(device=dev).manual_seed(0),
                        torch.bfloat16)
    root = str(tmp_path_factory.mktemp("serve"))
    info = make_fake_scene(root, n_frames=3)
    data_cfg = DataConfig(video_folder=root,
                          annotation_dir=os.path.join(root, "embodiedscan"),
                          metadata_dir=os.path.join(root, "metadata"),
                          frames_upbound=3)
    tok = FakeTokenizer()
    for text in ("what is in the room", "what color is it",
                 "compare the images", "a chair"):
        tok(text)

    def engine(**kw):
        return drivers.InferenceEngine(
            params, cfg, tok, VideoProcessor(data_cfg),
            engine_cfg=drivers.EngineConfig(
                max_new_tokens=16, eos_token_id=tok.eos_token_id,
                max_frames=3, buckets=(512,), stop_str=""),
            device=dev, **kw)

    def port():
        s = socket.socket()
        s.bind(("127.0.0.1", 0))
        p = s.getsockname()[1]
        s.close()
        return p

    eng = engine()
    p = port()
    worker, server = serve_worker(eng, "tiny", port=p, background=True,
                                  heartbeat=False)
    yield {"cfg": cfg, "params": params, "info": info, "engine": engine,
           "eng": eng, "addr": f"http://127.0.0.1:{p}", "port": port,
           "worker": worker}
    server.shutdown()
    server.server_close()


def _post(url, payload):
    from video3d_tpu_torch.serve.controller import _post_json

    out = _post_json(url, payload, timeout=300)
    assert out.get("error_code", 0) == 0, out
    return out


def _ran(before):
    torch.cuda.synchronize()
    return {k: v - before[k] for k, v in _build.LAUNCHES.items()
            if v != before[k]}


def test_worker_routes_on_the_card(dev, serving):
    """/worker_generate equals generate_answer (B1 once, B2 per layer, B3
    per layer and captured step); the stream's last chunk equals it (B3 per
    layer and eager step); max_new_tokens cuts it to the first ids."""
    eng, addr, L = serving["eng"], serving["addr"], 2
    rec = {"video": serving["info"]["sample_idx"],
           "conversations": [{"from": "human",
                              "value": "<image>\nwhat is in the room"},
                             {"from": "gpt", "value": None}]}
    want = eng.generate_answer(rec)
    before = dict(_build.LAUNCHES)
    out = _post(addr + "/worker_generate",
                {"video": rec["video"],
                 "prompt": rec["conversations"][0]["value"]})
    ran = _ran(before)
    assert out["text"] == want
    assert ran["fused_geometry"] == 1 and ran["flash_attention"] == L
    assert ran["decode_attention"] % L == 0 and ran["decode_attention"] > 0
    stream = list(eng.generate_answer_stream(rec, chunk=4))
    assert stream[-1] == want
    assert all(b.startswith(a) for a, b in zip(stream, stream[1:]))
    capped = _post(addr + "/worker_generate",
                   {"video": rec["video"], "max_new_tokens": 3,
                    "prompt": rec["conversations"][0]["value"]})
    assert want.startswith(capped["text"])


def test_stream_and_overrides_add_no_graph_entry(dev, serving):
    """Streams and eight distinct sampling combinations decode eagerly:
    the engine's DecodeGraphs keeps its entries and captures; top_k = 1
    gives the greedy stream's text."""
    eng, addr = serving["eng"], serving["addr"]
    base = {"video": serving["info"]["sample_idx"],
            "prompt": "<image>\nwhat is in the room", "max_new_tokens": 6}
    _post(addr + "/worker_generate", {k: v for k, v in base.items()
                                      if k != "max_new_tokens"})
    stats = eng._graphs.stats()
    greedy = _post(addr + "/worker_generate", base)["text"]
    for i in range(7):
        _post(addr + "/worker_generate",
              base | {"temperature": 0.3 + 0.1 * i, "top_k": 10 + i})
    assert _post(addr + "/worker_generate",
                 base | {"temperature": 0.7, "top_k": 1})["text"] == greedy
    after = eng._graphs.stats()
    assert after["entries"] == stats["entries"]
    assert after["captures"] == stats["captures"]


def test_images_on_the_card(dev, serving):
    """Two images through the worker's ``images`` field equal
    ``generate_answer_images`` (B2 once per layer, no B1)."""
    import base64
    import io

    from PIL import Image

    eng, addr = serving["eng"], serving["addr"]
    rng = np.random.default_rng(0)
    imgs = [Image.fromarray(rng.integers(0, 255, (48, 64, 3), np.uint8))
            for _ in range(2)]
    b64 = []
    for im in imgs:
        buf = io.BytesIO()
        im.save(buf, format="PNG")
        b64.append(base64.b64encode(buf.getvalue()).decode())
    want = eng.generate_answer_images("compare the images", imgs)
    before = dict(_build.LAUNCHES)
    out = _post(addr + "/worker_generate", {"prompt": "compare the images",
                                            "images": b64})
    ran = _ran(before)
    assert out["text"] == want
    assert ran.get("fused_geometry", 0) == 0 and ran["flash_attention"] == 2


def test_host_geometry_route_on_the_card(dev, serving):
    """``device_geometry=False``: the host route's voxel ids against B1's
    on the same frames, its first-step logits within chip_smoke's
    LOGIT_ATOL of the B1 route's."""
    from video3d_tpu_torch.models import generate as gen

    eng, cfg, params = serving["eng"], serving["cfg"], serving["params"]
    host = serving["engine"](device_geometry=False)
    video = serving["info"]["sample_idx"]
    V, _, b1 = eng._video_arrays(video)
    Vh, images, hp = host._video_arrays(video)
    assert Vh == V and images.shape[1] == 3
    assert float((b1[0, :V] != hp[0, :V]).any(-1).float().mean()) < 0.05
    rec = {"video": video, "conversations": [
        {"from": "human", "value": "<image>\nwhat is in the room"},
        {"from": "gpt", "value": None}]}
    with torch.inference_mode():
        got, ref = (gen.prefill_multimodal(params, cfg, e._prepare_generation(
            rec)[0], 600)[0].float() for e in (host, eng))
    assert float((got - ref).abs().max()) <= 0.25
    assert isinstance(host.generate_answer(rec), str)


#: two answers through different decode paths (the batcher's rows or
#: pages against the sequential B=1 cache) may part only where the two ids'
#: logits lie within this of each other: a few bf16 ulps at this width's
#: logits (|logits| < 2), where a reduction order can break a tie apart
SERVE_TIE = 1.0 / 16


def _tie_gap(engine, rec, want, got):
    """None when the id lists are equal, else the two ids' logit distance
    at their first difference, teacher-forced along ``want`` (B3 steps
    after a full prefill)."""
    from video3d_tpu_torch.models import generate as gen
    from video3d_tpu_torch.models import qwen2

    m = next((i for i, (a, b) in enumerate(zip(want, got)) if a != b), None)
    if m is None:
        assert len(want) == len(got)
        return None
    batch, vf = engine._prepare_generation(rec)
    params, cfg, llm = engine.params, engine.cfg, engine.params["llm"]
    with torch.inference_mode():
        logits, cache, pos = gen.prefill_multimodal(
            params, cfg, batch, batch.text_ids.shape[1] + len(want) + 1, vf)
        pos = pos.long()
        for t in want[:m]:
            h = qwen2.qwen2_forward(
                llm, cfg.llm, qwen2.embed_tokens(llm, torch.tensor(
                    [[t]], device=pos.device)),
                gen._decode_position_ids(pos[:, None]), kv_cache=cache,
                cache_positions=pos[:, None], kv_len=pos + 1)
            logits = qwen2.lm_head(llm, h)[:, 0]
            pos = pos + 1
    row = logits[0].float()
    return float((row[want[m]] - row[got[m]]).abs())


@pytest.mark.parametrize("paged", [False, True])
def test_batcher_worker_on_the_card(dev, serving, paged):
    """serve_worker(num_slots=4): four concurrent requests, each the
    sequential engine's ids up to a near-tie (SERVE_TIE); every slot and
    page back after."""
    import threading

    from video3d_tpu_torch.serve.model_worker import serve_worker

    eng = serving["eng"]
    video = serving["info"]["sample_idx"]
    prompts = ["<image>\nwhat is in the room", "<image>\nwhat color is it"]
    recs = [{"video": video, "conversations": [
        {"from": "human", "value": p}, {"from": "gpt", "value": None}]}
        for p in prompts]
    want = []
    for r in recs:
        res = eng._generate(*eng._prepare_generation(r))
        want.append(res.tokens[0, :int(res.lengths[0])].tolist())
    beng = serving["engine"]()
    seen = []
    inner = beng._decode_text

    def decode(toks):
        seen.append([int(t) for t in toks])
        return inner(toks)

    beng._decode_text = decode
    port = serving["port"]()
    worker, server = serve_worker(beng, "tiny-b", port=port,
                                  background=True, heartbeat=False,
                                  num_slots=4, paged=paged, page_size=64)
    try:
        out = [None] * 4

        def hit(i):
            out[i] = _post(f"http://127.0.0.1:{port}/worker_generate",
                           {"video": video, "prompt": prompts[i % 2]})

        threads = [threading.Thread(target=hit, args=(i,)) for i in range(4)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=300)
        for i, o in enumerate(out):
            got = next(ids for ids in seen if inner(ids) == o["text"])
            gap = _tie_gap(eng, recs[i % 2], want[i % 2], got)
            assert gap is None or gap <= SERVE_TIE, (i, gap)
        m = _post(f"http://127.0.0.1:{port}/worker_metrics", {})
        assert m["slots_in_use"] == 0 and m["requests_total"] == 4
        if paged:
            assert m["pages_free"] == m["pages"]
    finally:
        worker.batcher.shutdown()
        server.shutdown()
        server.server_close()


@pytest.mark.parametrize("rows", [1, 8, 17, 32])
def test_w8a8_product_on_the_card_equals_its_cpu_form(dev, rows):
    """``matmul_w8a8`` on the card (``torch._int_mm``, rows under
    W8A8_MIN_ROWS zero-padded, the weight output-major) against the same
    product on the CPU (exact int32 sums, the same f32 scale arithmetic):
    within one bf16 ulp, one ``torch._int_mm`` call counted; a control
    with the weight's scales left off misses."""
    from video3d_tpu_torch.models import quant

    g = torch.Generator(device=dev).manual_seed(rows)
    w = 0.02 * torch.randn(3584, 512, generator=g, device=dev)
    qw = quantize_weight(w, act="int8")
    x = torch.randn(rows, 3584, generator=g, device=dev).bfloat16()
    before = _build.LAUNCHES[quant.W8A8_COUNT]
    got = quant.matmul(x, qw)
    torch.cuda.synchronize()
    assert _build.LAUNCHES[quant.W8A8_COUNT] == before + 1
    ref = quant.matmul_w8a8(x.cpu(), qw.q.cpu(), qw.scale.cpu()).float()
    ulp = 2.0 ** -7 * ref.abs() + 1e-6
    assert got.dtype == torch.bfloat16 and got.shape == (rows, 512)
    assert float(((got.float().cpu() - ref).abs() / ulp).max()) <= 1.0
    bare = quant.matmul_w8a8(x.cpu(), qw.q.cpu(),
                             torch.ones_like(qw.scale.cpu())).float()
    assert float(((bare - ref).abs() / ulp).max()) >= 4.0


def test_captured_w8a8_chunk_equals_uncaptured(dev, decoders):
    """A 4-step decode chunk of 8 rows over w8a8 weights replayed as a
    CUDA graph (the padded ``torch._int_mm`` products captured, no host
    sync) equals the uncaptured chunk bit for bit; the counts are B3 per
    layer and one ``torch._int_mm`` per projection and head, each step."""
    from video3d_tpu_torch.models import decode_graph as dg
    from video3d_tpu_torch.models import generate as gen
    from video3d_tpu_torch.models import quant

    cfg, models = decoders
    params = quant.quantize_tree(models[16], act="int8")
    assert dg.weight_form(params) == "w8a8"
    dense, _ = _decode_states(cfg, dev, 8, "bf16")
    steps = 4
    with torch.inference_mode():
        start = [t.clone() for t in dg.state_tensors(dense)]
        eager = type(dense)(*(
            type(x)(*(None if t is None else t.clone() for t in x))
            if isinstance(x, tuple) else x.clone() for x in dense))
        _, want = gen.decode_chunk(params, cfg, eager, steps, -1,
                                   capture=False)
        graphs = dg.DecodeGraphs(dev)
        _build.reset_launches()
        for i in range(4):
            for t, s in zip(dg.state_tensors(dense), start):
                t.copy_(s)
            _, toks = gen.decode_chunk(params, cfg, dense, steps, -1,
                                       graphs=graphs)
            assert torch.equal(toks, want), i
            assert torch.equal(dense.next_logits, eager.next_logits), i
        torch.cuda.synchronize()
    assert graphs.captures == 1 and graphs.replays == 3
    launched = {k: v for k, v in _build.LAUNCHES.items() if v}
    assert launched == {"decode_attention": 4 * steps * CAPTURE_LAYERS,
                        quant.W8A8_COUNT:
                            4 * steps * (7 * CAPTURE_LAYERS + 1)}


# ---------------------------------------------------------------------------
# head width 256 (Gemma): B2's prefill form, B2 folded and B3 on
# csrc/attention_hd256.cu, against their plain twins in f32
# ---------------------------------------------------------------------------

HD256_PREFILL = [(2, 300, [300, 150], 8, 1), (1, 129, [129], 4, 2),
                 (3, 65, [1, 64, 65], 8, 8)]


@pytest.mark.parametrize("B,L,lengths,H,KV", HD256_PREFILL)
def test_hd256_prefill_kernel(dev, B, L, lengths, H, KV):
    """At the edges of the 64-row and 64-key tiles, peaked (keys 64-127
    focused); control: the causal mask dropped misses by 4x."""
    from video3d_tpu_torch.kernels import attention_hd256 as h256

    g = torch.Generator(device=dev).manual_seed(11)
    hd = 256
    q = Q_SCALE * torch.randn(B, L, H, hd, generator=g, device=dev)
    q[..., 0] += FOCUS
    k = torch.randn(B, L, KV, hd, generator=g, device=dev)
    k[:, 64:128, :, 0] += FOCUS
    v = 0.5 * torch.randn(B, L, KV, hd, generator=g, device=dev)
    q, k, v = q.bfloat16(), k.bfloat16(), v.bfloat16()
    lens = torch.tensor(lengths, dtype=torch.int32, device=dev)
    got = _launched("flash_attention_hd256",
                    lambda: fa.flash_attention(q, k, v, lengths=lens))
    ref = h256.prefill_hd256_plain(q.float(), k.float(), v.float(), lens)
    assert bool(torch.isfinite(got.float()).all())
    assert _rows_err(got, ref, lengths) <= BF16_ATOL
    no_mask = h256.prefill_hd256_plain(q.float(), k.float(), v.float(), lens,
                                       causal=False)
    assert _rows_err(no_mask, ref, lengths) > 4 * BF16_ATOL


HD256_FOLDED = [(8, 1, 64, [700], [740]),       # Gemma-2B's prefix hit
                (8, 2, 100, [300, 37], [400, 100]),
                (8, 1, 64, [200], [264]),
                (16, 2, 64, [700, 100], [740, 164])]   # empty splits


@pytest.mark.parametrize("H,KV,L,offs,lens", HD256_FOLDED)
def test_hd256_folded_kernel(dev, H, KV, L, offs, lens):
    """Over a stacked cache layer; controls: the causal mask dropped, and
    the next kv head's keys, each miss by 4x."""
    from video3d_tpu_torch.kernels import attention_hd256 as h256

    g = torch.Generator(device=dev).manual_seed(12)
    NL, S, hd, layer = 2, 800, 256, 1
    B = len(offs)
    q = Q_SCALE * torch.randn(B, L, H, hd, generator=g, device=dev)
    q[..., 0] += FOCUS
    q = q.bfloat16()
    k_all = torch.randn(NL, B, S, KV * hd, generator=g, device=dev)
    for b, (o, n) in enumerate(zip(offs, lens)):
        k_all[layer, b, o:n, ::hd] += FOCUS
    k_all = k_all.bfloat16()
    v_all = (0.5 * torch.randn(NL, B, S, KV * hd, generator=g,
                               device=dev)).bfloat16()
    offs_t = torch.tensor(offs, dtype=torch.int32, device=dev)
    lens_t = torch.tensor(lens, dtype=torch.int32, device=dev)
    call = lambda: fa.flash_attention_gqa_folded(q, k_all, v_all, lens_t,
                                                 offs_t, layer, KV)
    got = _launched("flash_attention_folded_hd256", call)
    _same_bits(call, got)
    ref = h256.folded_hd256_plain(q.float(), k_all, v_all, lens_t, offs_t,
                                  layer, KV)
    rows = [min(L, n - o) for o, n in zip(offs, lens)]
    assert bool(torch.isfinite(got.float()).all())
    assert _rows_err(got, ref, rows) <= BF16_ATOL
    no_mask = h256.folded_hd256_plain(q.float(), k_all, v_all, lens_t,
                                      lens_t - 1, layer, KV)
    assert _rows_err(no_mask, ref, rows) > 4 * BF16_ATOL
    if KV > 1:
        shifted = h256.folded_hd256_plain(
            q.float(), k_all.roll(hd, dims=-1), v_all, lens_t, offs_t, layer,
            KV)
        assert _rows_err(shifted, ref, rows) > 4 * BF16_ATOL


HD256_DECODE = [(8, 1, 600, [600, 257, 1]), (16, 2, 520, [520, 300]),
                (8, 8, 300, [256, 1, 299]),
                # fewer live positions than CTAs (B3's split fault), a row of 0
                (8, 1, 528, [5, 0, 9, 3]), (8, 1, 7000, [2])]


@pytest.mark.parametrize("H,KV,S,lens", HD256_DECODE)
def test_hd256_decode_kernel(dev, H, KV, S, lens):
    """Over a stacked cache layer: the twin's output on live rows, zeros on
    a kv_len == 0 row, the same bits twice, a launch at full rows after it;
    control: the last live key dropped misses by 4x."""
    from video3d_tpu_torch.kernels import attention_hd256 as h256

    g = torch.Generator(device=dev).manual_seed(13)
    NL, B, hd, layer = 2, len(lens), 256, 1
    q = _peaked_q(g, dev, B, H, hd)
    k, v = _flat_kv(g, dev, NL, S, KV, lens, layer, hd)
    k_all, v_all = (x.reshape(NL, B, S, KV * hd).bfloat16() for x in (k, v))
    kv_len = torch.tensor(lens, dtype=torch.int32, device=dev)
    call = lambda: da.decode_attention(q, k_all, v_all, kv_len, layer, KV)
    got = _launched("decode_attention_hd256", call)
    ref = h256.decode_hd256_plain(q.float(), k_all, v_all, kv_len, layer, KV)
    live = [b for b, n in enumerate(lens) if n]
    assert bool(torch.isfinite(got.float()).all())
    assert float((got[live].float() - ref[live]).abs().max()) <= BF16_ATOL
    for b in (kv_len == 0).nonzero().flatten().tolist():
        assert bool((got[b] == 0).all())
    _same_bits(call, got)
    if max(lens) > 1:
        broken = h256.decode_hd256_plain(q.float(), k_all, v_all,
                                         (kv_len - 1).clamp(min=1), layer, KV)
        assert float((broken[live] - ref[live]).abs().max()) > 4 * BF16_ATOL
    full = torch.full_like(kv_len, S)
    after = da.decode_attention(q, k_all, v_all, full, layer, KV)
    ref_full = h256.decode_hd256_plain(q.float(), k_all, v_all, full, layer,
                                       KV)
    assert float((after.float() - ref_full).abs().max()) <= BF16_ATOL


def test_hd256_forms_refuse_what_they_do_not_take(dev):
    """What the hd-256 forms still refuse on the card, with a ValueError
    before any launch: a quantized cache without its scales, f16 scales,
    a flat or paged cache of another dtype (f16), and the training forward
    (B2 with the logsumexp, ROADMAP B)."""
    B, S, KV, hd = 1, 128, 1, 256
    q = torch.zeros(B, 1, 8, hd, dtype=torch.bfloat16, device=dev)
    k8 = torch.zeros(2, B, S, KV * hd, dtype=torch.int8, device=dev)
    sc = torch.ones(2, B, S, KV, 1, device=dev)
    lens = torch.full((B,), 5, dtype=torch.int32, device=dev)
    with pytest.raises(ValueError):
        da.decode_attention(q, k8, k8, lens, 0, KV)
    with pytest.raises(ValueError):
        da.decode_attention(q, k8, k8, lens, 0, KV, sc.half(), sc.half())
    with pytest.raises(ValueError):
        fa.flash_attention_gqa_folded(q.expand(B, 4, 8, hd).contiguous(),
                                      k8.half(), k8.half(), lens, lens - 4,
                                      0, KV)
    kk = torch.zeros(B, 64, KV, hd, dtype=torch.bfloat16, device=dev)
    qq = torch.zeros(B, 64, 8, hd, dtype=torch.bfloat16, device=dev)
    with pytest.raises(ValueError):
        fa.flash_attention_fwd(qq, kk, kk, lens)
    p8 = torch.zeros(64, KV, hd, dtype=torch.int8, device=dev)
    with pytest.raises(ValueError):
        fa.flash_attention_shared_prefix(qq, p8, p8, kk, kk, lens)
    pool = torch.zeros(2, 3, 16, KV * hd, dtype=torch.float16, device=dev)
    table = torch.tensor([[1, 2]], dtype=torch.int32, device=dev)
    with pytest.raises(ValueError):
        pa.paged_decode_attention(q, pool, pool, table, lens, 0, KV)


# (H, KV, page, maxp, alias, kv_len): Gemma-2B's heads over aliased pages,
# an odd page size (24, and 7), fewer live positions than CTAs with a
# kv_len 0 slot (the split fault B3 / B7 had), two kv heads
HD256_PAGED = [(8, 1, 128, 3, 1, [300, 129, 256, 1]),
               (8, 2, 24, 5, 2, [120, 1, 49]),
               (8, 1, 128, 56, 52, [5, 0, 9, 3, 6716, 7000, 2, 7168]),
               (16, 2, 7, 9, 0, [63, 2])]


def _hd256_pages(g, dev, H, KV, page, maxp, alias, lens):
    """q (B, 1, H, 256) peaked, stacked (2, P, page, KV * 256) bf16 pools
    (layer 1 read), a table whose first ``alias`` entries are pool pages
    1.. for every slot, then pages of its own. The last 16 keys of every
    slot are focused where they lie in its own pages: at hd 256 a focused
    key's score gains only 121 / 16, so four of ~7000 keys carry too little
    of the softmax for a swapped page row to show, and focused keys in the
    aliased pages would dominate every slot."""
    NL, hd, layer = 2, 256, 1
    B = len(lens)
    P = 1 + alias + B * (maxp - alias)
    table = torch.zeros(B, maxp, dtype=torch.int32)
    table[:, :alias] = torch.arange(1, 1 + alias)
    table[:, alias:] = torch.arange(1 + alias, P).reshape(B, maxp - alias)
    q = _peaked_q(g, dev, B, H, hd)
    k = torch.randn(NL, P, page, KV, hd, generator=g, device=dev)
    v = 0.5 * torch.randn(NL, P, page, KV, hd, generator=g, device=dev)
    for b, n in enumerate(lens):
        for s_ in range(max(n - 16, alias * page), n):
            k[layer, int(table[b, s_ // page]), s_ % page, :, 0] += FOCUS
    k, v = (x.reshape(NL, P, page, KV * hd).bfloat16() for x in (k, v))
    kv_len = torch.tensor(lens, dtype=torch.int32, device=dev)
    return q, k, v, table.to(dev), kv_len, layer


@pytest.mark.parametrize("H,KV,page,maxp,alias,lens", HD256_PAGED)
def test_hd256_paged_kernel(dev, H, KV, page, maxp, alias, lens):
    """B7 at hd 256 against its twin in f32 on the same bf16 values: live
    slots within 2e-2, kv_len 0 slots zero, the same bits twice; controls
    (two slots' table rows swapped, each slot's last live page dropped)
    miss by 4x."""
    from video3d_tpu_torch.kernels import attention_hd256 as h256

    g = torch.Generator(device=dev).manual_seed(14)
    q, k, v, table, kv_len, layer = _hd256_pages(g, dev, H, KV, page, maxp,
                                                 alias, lens)
    call = lambda: pa.paged_decode_attention(q, k, v, table, kv_len, layer,
                                             KV)
    got = _launched("paged_attention_hd256", call)
    ref = h256.paged_hd256_plain(q.float(), k, v, table, kv_len, layer, KV)
    live = [b for b, n in enumerate(lens) if n]
    assert bool(torch.isfinite(got.float()).all())
    assert float((got[live].float() - ref[live]).abs().max()) <= BF16_ATOL
    for b, n in enumerate(lens):
        if n == 0:
            assert bool((got[b] == 0).all())
    _same_bits(call, got)
    a, b = sorted(range(len(lens)), key=lambda i: lens[i])[-2:]
    swapped = table.clone()               # the two longest slots' rows
    swapped[[a, b]] = table[[b, a]]
    last_page = ((kv_len - 1).clamp(min=0) // page) * page
    for broken in (h256.paged_hd256_plain(q.float(), k, v, swapped, kv_len,
                                          layer, KV),
                   h256.paged_hd256_plain(q.float(), k, v, table, last_page,
                                          layer, KV)):
        assert float((broken[live] - ref[live]).abs().max()) > 4 * BF16_ATOL


# (B, L, H, KV, P, suffix_lens): phase 3's B=8 batch over a prefix ending
# mid-tile, whole tiles with two kv heads, a short suffix
HD256_PREFIX = [(8, 64, 8, 1, 700, [64, 40, 17, 64, 33, 50, 8, 60]),
                (3, 64, 8, 2, 64, [1, 64, 45]),
                (2, 20, 8, 1, 100, [20, 7])]


def _hd256_prefix(g, dev, B, L, H, KV, P):
    """Peaked q; the prefix with its first 64-key tile focused; the suffix
    focused."""
    hd = 256
    q = Q_SCALE * torch.randn(B, L, H, hd, generator=g, device=dev)
    q[..., 0] += FOCUS
    pk = torch.randn(P, KV, hd, generator=g, device=dev)
    pk[:64, :, 0] += FOCUS
    pv = 0.5 * torch.randn(P, KV, hd, generator=g, device=dev)
    sk = torch.randn(B, L, KV, hd, generator=g, device=dev)
    sk[..., 0] += FOCUS
    sv = 0.5 * torch.randn(B, L, KV, hd, generator=g, device=dev)
    return tuple(x.bfloat16() for x in (q, pk, pv, sk, sv))


@pytest.mark.parametrize("B,L,H,KV,P,slens", HD256_PREFIX)
def test_hd256_shared_prefix_kernel(dev, B, L, H, KV, P, slens):
    """B5 at hd 256 against its twin in f32 on the same bf16 values (rows
    below suffix_lens) within 2e-2, the same bits twice; controls (the
    suffix's causal mask dropped, the next row's suffix attended, the
    first prefix tile skipped) miss by 4x."""
    from video3d_tpu_torch.kernels import attention_hd256 as h256
    from video3d_tpu_torch.kernels.attention import mha_reference

    g = torch.Generator(device=dev).manual_seed(15)
    q, pk, pv, sk, sv = _hd256_prefix(g, dev, B, L, H, KV, P)
    slens_t = torch.tensor(slens, dtype=torch.int32, device=dev)
    call = lambda: fa.flash_attention_shared_prefix(q, pk, pv, sk, sv,
                                                    slens_t)
    got = _launched("shared_prefix_attention_hd256", call)
    qf = q.float()
    ref = h256.shared_prefix_hd256_plain(qf, pk, pv, sk, sv, slens_t)
    assert bool(torch.isfinite(got.float()).all())
    assert _rows_err(got, ref, slens) <= BF16_ATOL
    _same_bits(call, got)
    k = torch.cat([pk.expand(B, *pk.shape), sk], 1).float()
    v = torch.cat([pv.expand(B, *pv.shape), sv], 1).float()
    controls = [
        mha_reference(qf, k, v, q_positions=torch.full(
            (B, L), P + L - 1, device=dev), kv_len=P + slens_t),
        h256.shared_prefix_hd256_plain(qf, pk, pv, sk.roll(1, 0),
                                       sv.roll(1, 0), slens_t.roll(1, 0)),
        h256.shared_prefix_hd256_plain(qf, pk[64:], pv[64:], sk, sv,
                                       slens_t)]
    for broken in controls:
        assert _rows_err(broken, ref, slens) > 4 * BF16_ATOL


# ---------------------------------------------------------------------------
# head width 256 over int8 and packed int4 caches: the quantized forms of
# B3, B2 folded, B7 and B5, against their plain twins in f32 on the same
# quantized values and scales; controls as at hd 128: the scales one
# position off, (KV > 1) of the wrong kv head and (int4) the nibbles of
# each byte swapped must miss by 4x
# ---------------------------------------------------------------------------

def _controls(plain, ks, vs, pos_dim, kv_dim, KV, bits, k8, v8):
    """The broken plain versions: ``plain(k8, v8, ks, vs)`` with the scales
    rolled one position, one kv head (KV > 1), or (int4) the nibbles
    swapped."""
    out = [plain(k8, v8, *_rolled(ks, vs, pos_dim))]
    if KV > 1:
        out.append(plain(k8, v8, *_rolled(ks, vs, kv_dim)))
    if bits == 4:
        out.append(plain(_swapped(k8), _swapped(v8), ks, vs))
    return out


@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("H,KV,S,lens", HD256_DECODE)
def test_hd256_quant_decode_kernel(dev, bits, H, KV, S, lens):
    """B3 at hd 256 over a stacked int8 / int4 cache layer: the twin's
    output on live rows, zeros on a kv_len 0 row, the same bits twice."""
    from video3d_tpu_torch.kernels import attention_hd256 as h256

    g = torch.Generator(device=dev).manual_seed(16)
    NL, B, hd, layer = 2, len(lens), 256, 1
    q = _peaked_q(g, dev, B, H, hd)
    k, v = _flat_kv(g, dev, NL, S, KV, lens, layer, hd)
    k8, ks = _int8(k.bfloat16(), bits)
    v8, vs = _int8(v.bfloat16(), bits)
    kv_len = torch.tensor(lens, dtype=torch.int32, device=dev)
    call = lambda: da.decode_attention(q, k8, v8, kv_len, layer, KV, ks, vs)
    got = _launched(f"decode_attention_hd256_int{bits}", call)

    def plain(k_, v_, ks_, vs_):
        return h256.decode_hd256_plain(q.float(), k_, v_, kv_len, layer, KV,
                                       ks_, vs_)
    ref = plain(k8, v8, ks, vs)
    live = [b for b, n in enumerate(lens) if n]
    assert bool(torch.isfinite(got.float()).all())
    assert float((got[live].float() - ref[live]).abs().max()) <= BF16_ATOL
    for b, n in enumerate(lens):
        if n == 0:
            assert bool((got[b] == 0).all())
    _same_bits(call, got)
    for broken in _controls(plain, ks, vs, 2, 3, KV, bits, k8, v8):
        assert float((broken[live] - ref[live]).abs().max()) > 4 * BF16_ATOL


@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("H,KV,L,offs,lens", HD256_FOLDED)
def test_hd256_quant_folded_kernel(dev, bits, H, KV, L, offs, lens):
    """B2 folded at hd 256 over a stacked int8 / int4 cache layer, the
    chunk's own keys focused before quantization; the same bits twice."""
    from video3d_tpu_torch.kernels import attention_hd256 as h256

    g = torch.Generator(device=dev).manual_seed(17)
    NL, S, hd, layer = 2, 800, 256, 1
    B = len(offs)
    q = Q_SCALE * torch.randn(B, L, H, hd, generator=g, device=dev)
    q[..., 0] += FOCUS
    q = q.bfloat16()
    k = torch.randn(NL, B, S, KV, hd, generator=g, device=dev)
    for b, (o, n) in enumerate(zip(offs, lens)):
        k[layer, b, o:n, :, 0] += FOCUS
    k8, ks = _int8(k.bfloat16(), bits)
    v8, vs = _int8((0.5 * torch.randn(NL, B, S, KV, hd, generator=g,
                                      device=dev)).bfloat16(), bits)
    offs_t = torch.tensor(offs, dtype=torch.int32, device=dev)
    lens_t = torch.tensor(lens, dtype=torch.int32, device=dev)
    call = lambda: fa.flash_attention_gqa_folded(q, k8, v8, lens_t, offs_t,
                                                 layer, KV, ks, vs)
    got = _launched(f"flash_attention_folded_hd256_int{bits}", call)
    _same_bits(call, got)

    def plain(k_, v_, ks_, vs_):
        return h256.folded_hd256_plain(q.float(), k_, v_, lens_t, offs_t,
                                       layer, KV, ks_, vs_)
    ref = plain(k8, v8, ks, vs)
    rows = [min(L, n - o) for o, n in zip(offs, lens)]
    assert bool(torch.isfinite(got.float()).all())
    assert _rows_err(got, ref, rows) <= BF16_ATOL
    for broken in _controls(plain, ks, vs, 2, 3, KV, bits, k8, v8):
        assert _rows_err(broken, ref, rows) > 4 * BF16_ATOL


@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("H,KV,page,maxp,alias,lens", HD256_PAGED)
def test_hd256_quant_paged_kernel(dev, bits, H, KV, page, maxp, alias,
                                  lens):
    """B7 at hd 256 over int8 / int4 pools with (layers, P, KV, 1, page)
    scale pools: live slots within 2e-2 of the twin, kv_len 0 slots zero,
    the same bits twice; controls also the two longest slots' table rows
    swapped."""
    from video3d_tpu_torch.kernels import attention_hd256 as h256

    g = torch.Generator(device=dev).manual_seed(18)
    q, k, v, table, kv_len, layer = _hd256_pages(g, dev, H, KV, page, maxp,
                                                 alias, lens)
    NL, P = k.shape[0], k.shape[1]
    k8, ks = _int8(k.reshape(NL, P, page, KV, 256), bits)
    v8, vs = _int8(v.reshape(NL, P, page, KV, 256), bits)
    ks, vs = (x.permute(0, 1, 3, 4, 2).contiguous() for x in (ks, vs))
    call = lambda: pa.paged_decode_attention(q, k8, v8, table, kv_len, layer,
                                             KV, ks, vs)
    got = _launched(f"paged_attention_hd256_int{bits}", call)

    def plain(k_, v_, ks_, vs_, table_=table):
        return h256.paged_hd256_plain(q.float(), k_, v_, table_, kv_len,
                                      layer, KV, ks_, vs_)
    ref = plain(k8, v8, ks, vs)
    live = [b for b, n in enumerate(lens) if n]
    assert bool(torch.isfinite(got.float()).all())
    assert float((got[live].float() - ref[live]).abs().max()) <= BF16_ATOL
    for b, n in enumerate(lens):
        if n == 0:
            assert bool((got[b] == 0).all())
    _same_bits(call, got)
    a, b = sorted(range(len(lens)), key=lambda i: lens[i])[-2:]
    swapped = table.clone()
    swapped[[a, b]] = table[[b, a]]
    controls = _controls(plain, ks, vs, -1, 2, KV, bits, k8, v8)
    controls.append(plain(k8, v8, ks, vs, swapped))
    for broken in controls:
        assert float((broken[live] - ref[live]).abs().max()) > 4 * BF16_ATOL


@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("B,L,H,KV,P,slens",
                         HD256_PREFIX + [(2, 20, 8, 1, 101, [20, 7])])
def test_hd256_quant_shared_prefix_kernel(dev, bits, B, L, H, KV, P, slens):
    """B5 at hd 256 over an int8 / int4 (P, KV, 256) prefix with (P, KV, 1)
    scales and a bf16 suffix: rows below suffix_lens within 2e-2 of the
    twin, the same bits twice; controls also the first prefix tile
    skipped. The prefix and its scales are layer 1 of stacked two-layer
    tensors, as a cached prefix hands them over (at P = 101 and one kv
    head the scales' slice is 4-byte aligned only)."""
    from video3d_tpu_torch.kernels import attention_hd256 as h256

    g = torch.Generator(device=dev).manual_seed(19)
    q, pk, pv, sk, sv = _hd256_prefix(g, dev, B, L, H, KV, P)
    pk8, pks = _int8(torch.stack([pk, pk]), bits)
    pv8, pvs = _int8(torch.stack([pv, pv]), bits)
    pk8, pv8 = (x[1].reshape(P, KV, -1) for x in (pk8, pv8))
    pks, pvs = pks[1], pvs[1]
    slens_t = torch.tensor(slens, dtype=torch.int32, device=dev)
    call = lambda: fa.flash_attention_shared_prefix(q, pk8, pv8, sk, sv,
                                                    slens_t, pks, pvs)
    got = _launched(f"shared_prefix_attention_hd256_int{bits}", call)
    _same_bits(call, got)

    def plain(k_, v_, ks_, vs_):
        return h256.shared_prefix_hd256_plain(q.float(), k_, v_, sk, sv,
                                              slens_t, ks_, vs_)
    ref = plain(pk8, pv8, pks, pvs)
    assert bool(torch.isfinite(got.float()).all())
    assert _rows_err(got, ref, slens) <= BF16_ATOL
    controls = _controls(plain, pks, pvs, 0, 1, KV, bits, pk8, pv8)
    controls.append(plain(pk8[64:], pv8[64:], pks[64:], pvs[64:]))
    for broken in controls:
        assert _rows_err(broken, ref, slens) > 4 * BF16_ATOL
