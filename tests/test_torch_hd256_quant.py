"""Gemma's head width 256 over int8 and int4 KV caches, on the CPU: the
quantized forms of B2 folded, B3, B7 and B5 at hd 256
(``csrc/attention_hd256.cu``'s int8 and packed-int4 instantiations for B2
folded, the decode template's hd-256 ones for B3 and B7
(``csrc/decode_sm90.cuh``), ``csrc/shared_prefix_hd256.cu``'s for B5;
``kernels/attention_hd256.py``).

* Their plain twins against JAX's Pallas kernels in interpret mode (hd 256
  takes JAX's kernels, as any ``hd % 128 == 0`` does; JAX is fed a
  ``jnp.int4`` cache, the port the same values packed two per uint8 byte),
  and in f32 against JAX's jnp oracles.
* The kernels' algorithms written out in plain torch, with the quantized
  tile load (int8 bytes, or nibbles: channel 2j low, 2j + 1 high, two's
  complement) and each form's scale layout, the key scale on the score,
  the value scale on p and l over the unscaled p, against the twins.
* The launch glue with a stand-in library: the quantized C entries, their
  argument order, the scale pointers (a dense layer's scales, the stacked
  scale pools, the prefix's) and the forms' launch-count names.
* A tiny hd-256 Gemma (hidden 512, 2 query heads of 256 on 1 kv head, 2
  layers) in f32 with an int8 and an int4 cache: its sequential answers
  (miss and hit), its batched prefix answers and its paged batcher (plain,
  shared prefix pages, a chunked admission) give the JAX engine's ids.
"""

import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from video3d_tpu.kernels import attention as jatt
from video3d_tpu.kernels import flash_attention as jfa
from video3d_tpu.kernels import paged_attention as jpa
from video3d_tpu.kernels.decode_attention import \
    decode_attention as jax_decode
from video3d_tpu_torch.kernels import _build
from video3d_tpu_torch.kernels import attention_hd256 as h256
from video3d_tpu_torch.kernels import decode_attention as tda
from video3d_tpu_torch.kernels import flash_attention as tfa
from video3d_tpu_torch.kernels import paged_attention as tpa
from video3d_tpu_torch.models import qwen2 as tqwen
from video3d_tpu_torch.serve.batcher import ContinuousBatcher

from family_configs import data_config, engines, jax_params, model_config, \
    question
from fixtures import make_fake_scene
from test_torch_hd256_host import (_count_allocations, _no_host_reads,
                                   emulate_decode, emulate_rows,
                                   emulate_shared_prefix)

torch.set_num_threads(1)

HD = h256.HEAD_DIM
H100_SMS = 132
BITS = [8, 4]
QMAX = {8: 127, 4: 7}
NL, LAYER = 2, 1
# the twins in f32 against JAX's jnp oracles: the same arithmetic in
# another order
F32_ATOL = 1e-5
# against the Pallas kernels: B2 folded and B5 run the quantized cache in
# f32 in interpret mode (a blocked online softmax against one pass); the
# B3 and B7 kernels round the query block and p to bf16 before their dots
# over a quantized cache (decode_attention.py:84-90, paged_attention.py
# :84-90), so they meet the f32 twin at bf16's bound, as at hd 128
KERNEL_ATOL = {"decode": 2e-2, "folded": 1e-5, "paged": 2e-2,
               "shared_prefix": 1e-5}
# bf16 queries: the bf16 twin dequantizes K and V to bf16 and rounds the
# scores to bf16 (as JAX's jnp reference does), the Pallas kernels scale
# the exact integers in f32, so the two bf16 results differ by a few bf16
# ulps of the output: within 2e-2, plus 2e-2 of |output| (at |output| ~ 1
# one ulp is 2^-7)
BF16_ATOL = 2e-2


def t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _np(x) -> np.ndarray:
    return np.asarray(torch.as_tensor(x).float())


def quant_values(rng, shape, bits):
    """int8 values in [-qmax, qmax] (shape (..., KV, hd)) and (..., KV, 1)
    f32 scales growing with 127 / qmax, so the dequantized values keep
    their range."""
    qmax = QMAX[bits]
    q = rng.integers(-qmax, qmax + 1, shape).astype(np.int8)
    s = rng.uniform(0.005, 0.02, shape[:-1] + (1,)) * 127 / qmax
    return q, s.astype(np.float32)


def jcache(a, bits):
    """Cache values for JAX: int8, or jnp.int4."""
    return jnp.asarray(a, jnp.int8 if bits == 8 else jnp.int4)


def tcache(a, bits):
    """The same values for the port: int8, or packed two per uint8 byte
    along the last dim."""
    x = t(a)
    return x if bits == 8 else tqwen.pack_kv_int4(x)


DTYPES = {"f32": torch.float32, "bf16": torch.bfloat16}
JDTYPES = {"f32": jnp.float32, "bf16": jnp.bfloat16}


def _cast(q, dtype: str):
    """The same queries for both: rounded to bf16 first where asked."""
    tq = t(q).to(DTYPES[dtype])
    return tq, jnp.asarray(_np(tq), JDTYPES[dtype])


def _tol(form: str, dtype: str):
    """(atol, rtol) of a twin against JAX's Pallas kernel."""
    return (KERNEL_ATOL[form], 0.0) if dtype == "f32" else (BF16_ATOL,
                                                            BF16_ATOL)


# ---------------------------------------------------------------------------
# the twins against JAX
# ---------------------------------------------------------------------------

def _flat_case(rng, B, S, KV, bits):
    """Stacked (NL, B, S, KV * 256) values and (NL, B, S, KV, 1) scales."""
    k8, ks = quant_values(rng, (NL, B, S, KV, HD), bits)
    v8, vs = quant_values(rng, (NL, B, S, KV, HD), bits)
    flat = (NL, B, S, KV * HD)
    return k8.reshape(flat), ks, v8.reshape(flat), vs


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("bits", BITS)
@pytest.mark.parametrize("H,KV,lens", [(8, 1, [256, 1, 129]),
                                       (4, 2, [200, 77])])
def test_decode_twin_matches_jax(H, KV, lens, bits, dtype):
    """B3 over layer 1 of a stacked quantized cache of 256 slots."""
    rng = np.random.default_rng(31 + bits)
    B, S = len(lens), 256
    k8, ks, v8, vs = _flat_case(rng, B, S, KV, bits)
    tq, jq = _cast(rng.standard_normal((B, 1, H, HD)), dtype)
    kv_len = np.asarray(lens, np.int32)
    before = dict(_build.LAUNCHES)
    got = tda.decode_attention(tq, tcache(k8, bits), tcache(v8, bits),
                               t(kv_len), LAYER, KV, t(ks), t(vs))
    assert _build.LAUNCHES == before            # the CPU runs the twin
    assert got.dtype == DTYPES[dtype] and got.shape == tq.shape
    kern = np.asarray(jax_decode(
        jq, jcache(k8, bits), jcache(v8, bits), jnp.asarray(kv_len),
        k_scale=jnp.asarray(ks[LAYER]), v_scale=jnp.asarray(vs[LAYER]),
        layer=LAYER, kv_heads=KV, interpret=True), np.float32)
    atol, rtol = _tol("decode", dtype)
    np.testing.assert_allclose(_np(got), kern, rtol=rtol, atol=atol)
    if dtype == "f32":
        kl = jcache(k8[LAYER], bits).reshape(B, S, KV, HD)
        vl = jcache(v8[LAYER], bits).reshape(B, S, KV, HD)
        oracle = np.asarray(jatt.mha_reference(
            jq, kl.astype(jnp.float32) * ks[LAYER],
            vl.astype(jnp.float32) * vs[LAYER],
            q_positions=jnp.asarray(kv_len - 1)[:, None],
            kv_len=jnp.asarray(kv_len)))
        np.testing.assert_allclose(_np(got), oracle, rtol=0, atol=F32_ATOL)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("bits", BITS)
@pytest.mark.parametrize("H,KV,L,offs,extra", [(8, 1, 64, [100, 30], [0, 7]),
                                               (4, 2, 20, [150, 3], [0, 5])])
def test_folded_twin_matches_jax(H, KV, L, offs, extra, bits, dtype):
    """A chunk at ragged offsets over layer 1 of a stacked quantized cache;
    rows below each row's length (the rest are undefined by contract)."""
    rng = np.random.default_rng(41 + bits + L)
    B, S = len(offs), 256
    k8, ks, v8, vs = _flat_case(rng, B, S, KV, bits)
    tq, jq = _cast(rng.standard_normal((B, L, H, HD)), dtype)
    offs = np.asarray(offs, np.int32)
    lens = (offs + L - np.asarray(extra)).astype(np.int32)
    before = dict(_build.LAUNCHES)
    got = _np(tfa.flash_attention_gqa_folded(
        tq, tcache(k8, bits), tcache(v8, bits), t(lens), t(offs), LAYER, KV,
        t(ks), t(vs)))
    assert _build.LAUNCHES == before
    kern = np.asarray(jfa.flash_attention_gqa_folded(
        jq, jcache(k8[LAYER], bits).reshape(B, S, KV, HD),
        jcache(v8[LAYER], bits).reshape(B, S, KV, HD), jnp.asarray(lens),
        jnp.asarray(offs), k_scale=jnp.asarray(ks[LAYER]),
        v_scale=jnp.asarray(vs[LAYER]), block_q=64, block_k=64,
        interpret=True), np.float32)
    atol, rtol = _tol("folded", dtype)
    rows = lens - offs
    for b in range(B):
        np.testing.assert_allclose(got[b, :rows[b]], kern[b, :rows[b]],
                                   rtol=rtol, atol=atol)


def _pool_case(rng, KV, page, maxp, lens, bits):
    """Stacked (NL, P, page, KV * 256) pools, (NL, P, KV, 1, page) scale
    pools and a table: every slot's first page is pool page 1 (aliased),
    its others its own, shuffled."""
    B = len(lens)
    P = 2 + B * (maxp - 1)
    own = rng.permutation(np.arange(2, P)).reshape(B, maxp - 1)
    table = np.concatenate([np.ones((B, 1), np.int64), own], 1)
    k8, ks = quant_values(rng, (NL, P, page, KV, HD), bits)
    v8, vs = quant_values(rng, (NL, P, page, KV, HD), bits)
    flat = (NL, P, page, KV * HD)
    pool_scales = [np.ascontiguousarray(s.transpose(0, 1, 3, 4, 2))
                   for s in (ks, vs)]
    return (k8.reshape(flat), v8.reshape(flat), *pool_scales,
            table.astype(np.int32))


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("bits", BITS)
@pytest.mark.parametrize("KV,G,page,maxp,lens", [
    (1, 8, 128, 3, [1, 300, 129, 0]), (2, 2, 24, 4, [50, 1, 96])])
def test_paged_twin_matches_jax(KV, G, page, maxp, lens, bits, dtype):
    """B7 over layer 1 of stacked quantized pools (a kv_len 0 slot reads
    zeros in both)."""
    rng = np.random.default_rng(51 + bits + page)
    k8, v8, ks, vs, table = _pool_case(rng, KV, page, maxp, lens, bits)
    B = len(lens)
    tq, jq = _cast(rng.standard_normal((B, 1, KV * G, HD)), dtype)
    kv_len = np.asarray(lens, np.int32)
    before = dict(_build.LAUNCHES)
    got = _np(tpa.paged_decode_attention(
        tq, tcache(k8, bits), tcache(v8, bits), t(table), t(kv_len), LAYER,
        KV, t(ks), t(vs)))
    assert _build.LAUNCHES == before
    assert h256.paged_hd256_plain is tpa.paged_attention_plain
    kern = np.asarray(jpa.paged_decode_attention(
        jq, jcache(k8, bits), jcache(v8, bits), jnp.asarray(table),
        jnp.asarray(kv_len), k_scale=jnp.asarray(ks),
        v_scale=jnp.asarray(vs), layer=LAYER, kv_heads=KV, interpret=True),
        np.float32)
    live = kv_len > 0
    assert np.all(got[~live] == 0) and np.all(kern[~live] == 0)
    atol, rtol = _tol("paged", dtype)
    np.testing.assert_allclose(got, kern, rtol=rtol, atol=atol)
    if dtype == "f32":
        oracle = np.asarray(jpa.paged_attention_reference(
            jq, jcache(k8[LAYER], bits), jcache(v8[LAYER], bits),
            jnp.asarray(table), jnp.asarray(kv_len),
            k_scale=jnp.asarray(ks[LAYER]), v_scale=jnp.asarray(vs[LAYER]),
            kv_heads=KV))
        np.testing.assert_allclose(got[live], oracle[live], rtol=0,
                                   atol=F32_ATOL)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("bits", BITS)
@pytest.mark.parametrize("B,L,KV,G,P,slens", [
    (2, 64, 1, 4, 100, [64, 30]), (3, 64, 2, 2, 70, [1, 64, 17])])
def test_shared_prefix_twin_matches_jax(B, L, KV, G, P, slens, bits, dtype):
    """B suffixes over one quantized (P, KV, 256) prefix (int4 packed to
    (P, KV, 128) bytes for the port) with (P, KV, 1) scales, the suffix
    K/V full precision; rows below suffix_lens."""
    rng = np.random.default_rng(61 + bits + P)
    pk8, pks = quant_values(rng, (P, KV, HD), bits)
    pv8, pvs = quant_values(rng, (P, KV, HD), bits)
    tq, jq = _cast(rng.standard_normal((B, L, KV * G, HD)), dtype)
    tsk, jsk = _cast(rng.standard_normal((B, L, KV, HD)), dtype)
    tsv, jsv = _cast(0.5 * rng.standard_normal((B, L, KV, HD)), dtype)
    lens = np.asarray(slens, np.int32)
    before = dict(_build.LAUNCHES)
    got = _np(tfa.flash_attention_shared_prefix(
        tq, tcache(pk8, bits), tcache(pv8, bits), tsk, tsv, t(lens),
        t(pks), t(pvs)))
    assert _build.LAUNCHES == before
    kern = np.asarray(jfa.flash_attention_shared_prefix(
        jq, jcache(pk8, bits), jcache(pv8, bits), jsk, jsv,
        jnp.asarray(lens), pk_scale=jnp.asarray(pks),
        pv_scale=jnp.asarray(pvs), block_q_prefix=128, block_k=128,
        interpret=True), np.float32)
    atol, rtol = _tol("shared_prefix", dtype)
    for b, n in enumerate(slens):
        np.testing.assert_allclose(got[b, :n], kern[b, :n], rtol=rtol,
                                   atol=atol)
    if dtype == "f32":
        oracle = np.asarray(jatt.mha_shared_prefix_reference(
            jq, jcache(pk8, bits), jcache(pv8, bits), jsk, jsv,
            jnp.asarray(lens), pk_scale=jnp.asarray(pks),
            pv_scale=jnp.asarray(pvs)))
        for b, n in enumerate(slens):
            np.testing.assert_allclose(got[b, :n], oracle[b, :n], rtol=0,
                                       atol=F32_ATOL)


# ---------------------------------------------------------------------------
# the kernel's algorithm with the quantized tile load, in plain torch
# ---------------------------------------------------------------------------

def tile_row(raw: torch.Tensor, bits: int) -> torch.Tensor:
    """The kernel's tile load of one kv head's row: 256 int8 bytes, or 128
    bytes of packed int4 (byte j: channel 2j in its low nibble, 2j + 1 in
    its high, two's complement), as f32 channel values."""
    if bits == 8:
        return raw.to(torch.int8).float()
    b = raw.to(torch.int32)
    lo, hi = b & 0xF, (b >> 4) & 0xF
    lo, hi = lo - 16 * (lo >= 8), hi - 16 * (hi >= 8)
    return torch.stack([lo, hi], -1).reshape(-1).float()


def _quant_flat(gen, lead, KV, bits, std=1.0):
    """A (*lead, KV * 256) int8 cache (or (*lead, KV * 128) packed int4
    bytes) of N(0, std) values from the port's cache write and its (*lead,
    KV, 1) scales."""
    x = std * torch.randn(*lead, KV, HD, generator=gen)
    q, s = tqwen.quantize_rows(x, torch.int8 if bits == 8 else torch.uint8)
    return q.reshape(*lead, -1), s


def _row_bytes(bits):
    return HD * bits // 8


@pytest.mark.parametrize("bits", BITS)
@pytest.mark.parametrize("mode", ["folded", "decode"])
def test_algorithm_matches_the_dense_twins(mode, bits):
    """B2 folded (the WMMA kernel) and B3 (the decode template at hd 256):
    key s of row b is row s of the layer's cache, its scales at (b, s, g)
    of the layer's (B, S, KV, 1) scales; split over keys, a kv_len 0 row
    (decode) reads zeros."""
    gen = torch.Generator().manual_seed(71 + bits)
    B, H, KV, S = 3, 4, 2, 300
    L = 20 if mode == "folded" else 1
    k_all, ks = _quant_flat(gen, (NL, B, S), KV, bits)
    v_all, vs = _quant_flat(gen, (NL, B, S), KV, bits, 0.5)
    q = 3.0 * torch.randn(B, L, H, HD, generator=gen)
    rb = _row_bytes(bits)
    if mode == "folded":
        offs, lens = torch.tensor([250, 30, 0]), torch.tensor([270, 45, 9])
        pos0 = lambda b: int(offs[b])
        ref = h256.folded_hd256_plain(q, k_all, v_all, lens, offs, LAYER, KV,
                                      ks, vs)
        rows = (lens - offs).tolist()
    else:
        lens = torch.tensor([300, 0, 129])
        pos0 = lambda b: int(lens[b]) - 1
        ref = h256.decode_hd256_plain(q, k_all, v_all, lens, LAYER, KV, ks,
                                      vs)
        rows = [1, 0, 1]

    def key_rows(b, g, s):
        cols = slice(g * rb, (g + 1) * rb)
        return (tile_row(k_all[LAYER, b, s, cols], bits),
                tile_row(v_all[LAYER, b, s, cols], bits),
                ks[LAYER, b, s, g, 0], vs[LAYER, b, s, g, 0])

    if mode == "folded":
        got = emulate_rows(q, S, KV, pos0, lambda b: min(int(lens[b]), S),
                           key_rows, sms=8)
    else:
        got = emulate_decode(q, S, KV, lens.tolist(), key_rows, sms=8)
    for b, n in enumerate(rows):
        torch.testing.assert_close(got[b, :n], ref[b, :n], rtol=0,
                                   atol=F32_ATOL)
    if mode == "decode":
        assert bool((got[1] == 0).all())


@pytest.mark.parametrize("bits", BITS)
@pytest.mark.parametrize("sms", [132, 4])
def test_algorithm_matches_the_paged_twin(sms, bits):
    """B7 at hd 256 (the decode template over the pools): positions
    through each slot's page table (aliased first page, shuffled rest),
    each key's scales from the layer's (P, KV, 1, page) scale pool at its
    page and row; a kv_len 0 slot; few CTAs and many."""
    gen = torch.Generator().manual_seed(81 + bits)
    page, maxp, lens, KV, G = 24, 4, [1, 50, 0, 96], 2, 2
    B = len(lens)
    P = 2 + B * (maxp - 1)
    own = torch.randperm(P - 2, generator=gen).reshape(B, maxp - 1) + 2
    table = torch.cat([torch.ones(B, 1, dtype=torch.long), own],
                      1).to(torch.int32)
    k, ks = _quant_flat(gen, (NL, P, page), KV, bits)
    v, vs = _quant_flat(gen, (NL, P, page), KV, bits, 0.5)
    ksp, vsp = (s.permute(0, 1, 3, 4, 2).contiguous() for s in (ks, vs))
    q = 3.0 * torch.randn(B, 1, KV * G, HD, generator=gen)
    rb = _row_bytes(bits)

    def rows(b, g, s):
        pid, r = int(table[b, s // page]), s % page
        cols = slice(g * rb, (g + 1) * rb)
        return (tile_row(k[LAYER, pid, r, cols], bits),
                tile_row(v[LAYER, pid, r, cols], bits),
                ksp[LAYER, pid, g, 0, r], vsp[LAYER, pid, g, 0, r])

    got = emulate_decode(q, maxp * page, KV, lens, rows, sms)
    ref = h256.paged_hd256_plain(q, k, v, table, torch.tensor(lens), LAYER,
                                 KV, ksp, vsp)
    torch.testing.assert_close(got, ref, rtol=0, atol=F32_ATOL)


@pytest.mark.parametrize("bits", BITS)
@pytest.mark.parametrize("B,L,P,slens,sms", [
    (2, 20, 100, [20, 7], 132), (2, 100, 30, [100, 41], 32),
    (3, 64, 64, [1, 64, 33], 4), (2, 20, 700, [20, 7], 132)])
def test_algorithm_matches_the_shared_prefix_twin(B, L, P, slens, sms,
                                                  bits):
    """B5 at hd 256 over a quantized prefix (its scales at (s, g) of the
    (P, KV, 1) scales), in one split or many, then each row's own bf16
    suffix at scale 1; rows below suffix_lens."""
    gen = torch.Generator().manual_seed(91 + bits + P)
    KV, G = 2, 2
    pk, pks = _quant_flat(gen, (P,), KV, bits)
    pv, pvs = _quant_flat(gen, (P,), KV, bits, 0.5)
    pk, pv = (x.reshape(P, KV, -1) for x in (pk, pv))
    q = 3.0 * torch.randn(B, L, KV * G, HD, generator=gen)
    sk = torch.randn(B, L, KV, HD, generator=gen)
    sv = 0.5 * torch.randn(B, L, KV, HD, generator=gen)
    def rows(g, s):
        return (tile_row(pk[s, g], bits), tile_row(pv[s, g], bits),
                pks[s, g, 0], pvs[s, g, 0])

    got = emulate_shared_prefix(q, P, KV, rows, (sk, sv), sms)
    ref = h256.shared_prefix_hd256_plain(q, pk, pv, sk, sv,
                                         torch.tensor(slens), pks, pvs)
    for b, n in enumerate(slens):
        torch.testing.assert_close(got[b, :n], ref[b, :n], rtol=0,
                                   atol=F32_ATOL)


def test_tile_row_is_the_caches_nibble_order():
    """The emulator's int4 tile load inverts the port's cache packing."""
    vals = torch.arange(-7, 8, dtype=torch.int8).repeat(18)[:256]
    packed = tqwen.pack_kv_int4(vals[None])[0]
    assert packed.shape == (128,)
    assert torch.equal(tile_row(packed, 4), vals.float())
    # a control: the nibbles swapped read other values
    swapped = ((packed >> 4) & 0x0F) | (packed << 4)
    assert not torch.equal(tile_row(swapped, 4), vals.float())


# ---------------------------------------------------------------------------
# the launch glue
# ---------------------------------------------------------------------------

class _Library:
    """Records each C call of the quantized entries; returns success."""

    def __init__(self):
        self.calls = []

    def __getattr__(self, name):
        if not name.startswith(("v3d_attention_hd256",
                                "v3d_decode_attention_hd256",
                                "v3d_paged_attention_hd256",
                                "v3d_shared_prefix_attention_hd256")):
            raise AttributeError(name)
        return lambda *args: self.calls.append((name, args)) or 0


STORAGE = {8: torch.int8, 4: torch.uint8}


def _check_decode_quant_launch(q, k, v, ks, vs, lens, KV, suffix, lib,
                               stream, monkeypatch):
    """B3's quantized forms at hd 256: the decode template's hd-256 entry of
    the form, the stacked cache and scales, the stream's workspace and
    counters for ``decode_plan`` at head width 256; a second call
    allocates only its output."""
    B = q.shape[0]
    k_all, v_all = k[None], v[None]
    ks_all, vs_all = ks[None], vs[None]
    S, H = k.shape[1], q.shape[2]
    plan = tda.decode_plan(B, KV, S, H100_SMS, 256)
    name = h256.NAMES["decode"] + suffix
    before = _build.LAUNCHES[name]
    out = tda._launch_decode(lib, stream, H100_SMS, suffix, q, k_all, v_all,
                             lens, 0, KV, ks_all, vs_all)
    assert _build.LAUNCHES[name] == before + 1
    ((entry, args),) = lib.calls
    assert entry == "v3d_decode_attention_hd256" + suffix
    assert len(args) == len(_build._SIGNATURES[entry])
    assert args[:7] == (q.data_ptr(), k_all.data_ptr(), v_all.data_ptr(),
                        ks_all.data_ptr(), vs_all.data_ptr(), lens.data_ptr(),
                        out.data_ptr())
    ws, ws_bytes, counters = args[7:10]
    assert ws and counters and ws_bytes >= plan.workspace_bytes
    assert args[10:] == (0, B, S, H, KV, plan.splits,
                         pytest.approx(HD ** -0.5), stream)
    made = _count_allocations(monkeypatch)
    _no_host_reads(monkeypatch)
    tda._launch_decode(lib, stream, H100_SMS, suffix, q, k_all, v_all, lens,
                       0, KV, ks_all, vs_all)
    assert made == ["empty_like"]
    assert lib.calls[1][1][7:10] == (ws, ws_bytes, counters)


@pytest.mark.parametrize("bits", BITS)
@pytest.mark.parametrize("form,L,S,q_off", [("folded", 64, 900, [700, 100]),
                                            ("decode", 1, 900, None)])
def test_dense_launch_hands_the_scales_to_the_quant_entry(form, L, S, q_off,
                                                          bits, monkeypatch):
    B, H, KV = 2, 8, 1
    width = KV * _row_bytes(bits)
    q = torch.zeros(B, L, H, HD, dtype=torch.bfloat16)
    k = torch.zeros(B, S, width, dtype=STORAGE[bits])
    v = torch.zeros_like(k)
    ks = torch.ones(B, S, KV, 1)
    vs = torch.ones_like(ks)
    lens = torch.tensor([S, S // 2], dtype=torch.int32)
    offs = None if q_off is None else torch.tensor(q_off, dtype=torch.int32)
    lib, stream = _Library(), 900 + L + bits
    plan = h256.hd256_plan(B, L, H, KV, S, H100_SMS)
    suffix = "_int8" if bits == 8 else "_int4"
    name = h256.NAMES[form] + suffix
    before = _build.LAUNCHES[name]
    if form == "decode":
        _check_decode_quant_launch(q, k, v, ks, vs, lens, KV, suffix, lib,
                                   stream, monkeypatch)
        return
    out = h256._launch_form(lib, stream, H100_SMS, form, q, k, v, lens, offs,
                            KV, ks, vs)
    assert _build.LAUNCHES[name] == before + 1
    assert out.shape == q.shape and out.dtype == torch.bfloat16
    ((entry, args),) = lib.calls
    assert entry == "v3d_attention_hd256_quant"
    assert len(args) == len(_build._SIGNATURES[entry])
    assert args[:7] == (q.data_ptr(), k.data_ptr(), v.data_ptr(),
                        ks.data_ptr(), vs.data_ptr(), lens.data_ptr(),
                        0 if offs is None else offs.data_ptr())
    assert args[7] == out.data_ptr()
    ws = args[8]
    assert (ws == 0) == (plan.splits == 1)
    assert args[9:] == (h256.MODES[form], bits, B, L, S, H, KV, plan.splits,
                        plan.split_keys, pytest.approx(HD ** -0.5), stream)
    made = _count_allocations(monkeypatch)
    _no_host_reads(monkeypatch)
    h256._launch_form(lib, stream, H100_SMS, form, q, k, v, lens, offs, KV,
                      ks, vs)
    assert made == ["empty_like"]
    assert lib.calls[1][1][8] == ws


@pytest.mark.parametrize("bits", BITS)
def test_paged_launch_hands_the_scale_pools_to_the_quant_entry(bits,
                                                               monkeypatch):
    B, H, KV, page, maxp = 2, 8, 1, 128, 60
    P = 2 * maxp + 1
    q = torch.zeros(B, 1, H, HD, dtype=torch.bfloat16)
    pools = torch.zeros(NL, P, page, KV * _row_bytes(bits),
                        dtype=STORAGE[bits])
    vpools = torch.zeros_like(pools)
    ks = torch.ones(NL, P, KV, 1, page)
    vs = torch.ones_like(ks)
    table = torch.arange(1, P, dtype=torch.int32).reshape(B, maxp)
    kv_len = torch.tensor([maxp * page, 5], dtype=torch.int32)
    lib, stream = _Library(), 1000 + bits
    plan = tda.decode_plan(B, KV, maxp * page, H100_SMS, HD)
    suffix = "_int8" if bits == 8 else "_int4"
    name = h256.NAMES["paged"] + suffix
    before = _build.LAUNCHES[name]
    out = tpa._launch_paged(lib, stream, H100_SMS, suffix, q, pools, vpools,
                            table, kv_len, LAYER, KV, ks, vs)
    assert _build.LAUNCHES[name] == before + 1
    ((entry, args),) = lib.calls
    assert entry == "v3d_paged_attention_hd256" + suffix
    assert len(args) == len(_build._SIGNATURES[entry])
    assert args[:8] == (q.data_ptr(), pools.data_ptr(), vpools.data_ptr(),
                        ks.data_ptr(), vs.data_ptr(), table.data_ptr(),
                        kv_len.data_ptr(), out.data_ptr())
    ws, ws_bytes, counters = args[8:11]
    assert plan.splits > 1 and ws and counters \
        and ws_bytes >= plan.workspace_bytes
    assert args[11:] == (LAYER, B, P, page, maxp, H, KV, plan.splits,
                         pytest.approx(HD ** -0.5), stream)
    made = _count_allocations(monkeypatch)
    _no_host_reads(monkeypatch)
    tpa._launch_paged(lib, stream, H100_SMS, suffix, q, pools, vpools, table,
                      kv_len, LAYER, KV, ks, vs)
    assert made == ["empty_like"]
    assert lib.calls[1][1][8:11] == (ws, ws_bytes, counters)


@pytest.mark.parametrize("bits", BITS)
def test_shared_prefix_launch_hands_the_scales_to_the_quant_entry(
        bits, monkeypatch):
    B, L, H, KV, P = 8, 64, 8, 1, 6716
    q = torch.zeros(B, L, H, HD, dtype=torch.bfloat16)
    pk = torch.zeros(P, KV, _row_bytes(bits), dtype=STORAGE[bits])
    pv = torch.zeros_like(pk)
    pks = torch.ones(P, KV, 1)
    pvs = torch.ones_like(pks)
    sk = torch.zeros(B, L, KV, HD, dtype=torch.bfloat16)
    sv = torch.zeros_like(sk)
    lib, stream = _Library(), 1100 + bits
    plan = h256.shared_prefix_plan(B, L, H, KV, P, H100_SMS)
    suffix = "_int8" if bits == 8 else "_int4"
    name = h256.NAMES["shared_prefix"] + suffix
    before = _build.LAUNCHES[name]
    out = h256._launch_shared_prefix(lib, stream, H100_SMS, q, pk, pv, sk,
                                     sv, pks, pvs)
    assert _build.LAUNCHES[name] == before + 1
    ((entry, args),) = lib.calls
    assert entry == "v3d_shared_prefix_attention_hd256" + suffix
    assert len(args) == len(_build._SIGNATURES[entry])
    assert args[:8] == (q.data_ptr(), pk.data_ptr(), pv.data_ptr(),
                        pks.data_ptr(), pvs.data_ptr(), sk.data_ptr(),
                        sv.data_ptr(), out.data_ptr())
    assert args[8:14] == (B, L, P, H, KV, pytest.approx(HD ** -0.5))
    ws, ws_bytes, counters = args[14:17]
    assert plan.splits > 1 and ws and counters \
        and ws_bytes >= plan.workspace_bytes
    assert args[17:] == (plan.splits, stream)
    made = _count_allocations(monkeypatch)
    _no_host_reads(monkeypatch)
    h256._launch_shared_prefix(lib, stream, H100_SMS, q, pk, pv, sk, sv,
                               pks, pvs)
    assert made == ["empty_like"]
    assert lib.calls[1][1][14:17] == (ws, ws_bytes, counters)


def test_quantized_forms_check_their_inputs():
    """What the quantized entries take, checked before any launch: a
    quantized cache without scales, scales of another shape, f16 scales,
    an int4 cache rows of the int8 width, and a prefill form over a
    quantized cache each raise a ValueError (no card needed: the checks
    run before the library loads)."""
    B, S, KV = 1, 128, 1
    q = torch.zeros(B, 1, 8, HD, dtype=torch.bfloat16)
    k8 = torch.zeros(NL, B, S, KV * HD, dtype=torch.int8)
    k4 = torch.zeros(NL, B, S, KV * HD // 2, dtype=torch.uint8)
    sc = torch.ones(NL, B, S, KV, 1)
    lens = torch.full((B,), 5, dtype=torch.int32)
    with pytest.raises(ValueError, match="scales"):
        h256.decode_hd256(q, k8, k8, lens, LAYER, KV)
    with pytest.raises(ValueError, match="scales"):
        h256.decode_hd256(q, k8, k8, lens, LAYER, KV, sc[:, :, :64],
                          sc[:, :, :64])
    with pytest.raises(ValueError, match="float32"):
        h256.decode_hd256(q, k8, k8, lens, LAYER, KV, sc.half(), sc.half())
    with pytest.raises(ValueError, match="shapes"):
        h256.decode_hd256(q, k4.repeat(1, 1, 1, 2), k4.repeat(1, 1, 1, 2),
                          lens, LAYER, KV, sc, sc)
    with pytest.raises(ValueError, match="bf16"):
        h256.prefill_hd256(q, k8[0].reshape(B, S, KV, HD),
                           k8[0].reshape(B, S, KV, HD), lens)
    pools = torch.zeros(NL, 3, 16, KV * HD // 2, dtype=torch.uint8)
    table = torch.tensor([[1, 2]], dtype=torch.int32)
    with pytest.raises(ValueError, match="scales"):
        h256.paged_hd256(q, pools, pools, table, lens, LAYER, KV,
                         torch.ones(NL, 3, KV, 1, 8),
                         torch.ones(NL, 3, KV, 1, 8))


# ---------------------------------------------------------------------------
# the tiny hd-256 Gemma over int8 and int4 caches, against the JAX engine
# ---------------------------------------------------------------------------

TEXTS = ("what color is the chair", "how many tables are there",
         "where is the lamp", "is the door open")
PAGE = 8
EOS = 101
KV_DTYPES = ("int8", "int4")


def _ids(toks) -> list:
    ids = [int(x) for x in toks]
    return ids[:ids.index(EOS)] if EOS in ids else ids


def _recording(engine):
    seen = []
    decode = engine._decode_text

    def wrapped(toks):
        seen.append(_ids(toks))
        return decode(toks)
    engine._decode_text = wrapped
    return seen


@pytest.fixture(scope="module")
def gemma(tmp_path_factory):
    """Two scenes, the hd-256 Gemma's JAX tree, its data config and the
    six questions (four on scene A, two on scene B)."""
    root = str(tmp_path_factory.mktemp("gemma256q"))
    infos = [make_fake_scene(root, scene_id=f"scene{i:04d}_00", n_frames=2,
                             extend=(i > 0)) for i in range(2)]
    cfg = model_config("gemma_hd256")
    records = [question(infos[0], x, i) for i, x in enumerate(TEXTS)] + \
        [question(infos[1], x, 4 + i) for i, x in enumerate(TEXTS[:2])]
    return cfg, jax_params(cfg, seed=3), data_config(root), records


@pytest.fixture(scope="module")
def jax_answers(gemma):
    """Per (cache dtype, scenes the prefix cache holds), the JAX engine's
    answers (ids), one at a time; every question tokenized first. With
    the prefix cache on each scene's first question misses and the rest
    hit, attending the prefix as quantized in the cache; without it every
    question is a full prefill over raw K/V, which an int4 cache answers
    differently."""
    cfg, params, data_cfg, records = gemma
    out = {}
    for kv in KV_DTYPES:
        for scenes in (0, 2):
            jeng, _ = engines(cfg, params, data_cfg,
                              prefix_cache_scenes=scenes, kv_cache_dtype=kv)
            for r in records:
                jeng._tokenize_prompt(r)
            seen = _recording(jeng)
            for r in records:
                jeng.generate_answer(r)
            out[kv, scenes] = seen
    return out


@pytest.mark.parametrize("kv", KV_DTYPES)
def test_sequential_answers_match_jax(gemma, jax_answers, kv):
    """Misses (the scenes' first questions) and hits over the quantized
    prefix, one at a time: the JAX engine's ids."""
    cfg, params, data_cfg, records = gemma
    _, teng = engines(cfg, params, data_cfg, prefix_cache_scenes=2,
                      kv_cache_dtype=kv)
    for r in records:
        teng._tokenize_prompt(r)
    seen = _recording(teng)
    for r in records:
        teng.generate_answer(r)
    assert teng.prefix_cache_stats == [4, 2]
    assert seen == jax_answers[kv, 2]


@pytest.mark.parametrize("kv", KV_DTYPES)
def test_batched_prefix_answers_match_jax(gemma, kv):
    """A miss stores the quantized prefix; the next three questions go as
    one suffix batch over it (B5 over a quantized prefix): the JAX
    engine's batched ids."""
    cfg, params, data_cfg, records = gemma
    jeng, teng = engines(cfg, params, data_cfg, prefix_cache_scenes=2,
                         kv_cache_dtype=kv)
    qs = records[:4]
    for e in (jeng, teng):
        for r in qs:
            e._tokenize_prompt(r)
    jseen, tseen = _recording(jeng), _recording(teng)
    jeng.generate_answer(qs[0])
    teng.generate_answer(qs[0])
    prep = teng.prepare_answers_batch_prefix(qs[1:])
    assert prep is not None and prep["mode"] == "prefix_batch"
    teng.answers_from_prefix_batch(prep)
    jeng.generate_answers_batch_prefix(qs[1:])
    assert teng.prefix_cache_stats == [3, 1]
    assert tseen == jseen


BATCHER_MODES = {
    "paged": dict(batcher={}, engine={}),
    "paged_shared": dict(batcher={}, engine=dict(prefix_cache_scenes=2)),
    "paged_chunked": dict(batcher=dict(chunked_prefill=64),
                          engine=dict(prefix_cache_scenes=2)),
}


@pytest.mark.parametrize("kv", KV_DTYPES)
@pytest.mark.parametrize("mode", list(BATCHER_MODES))
def test_paged_batcher_matches_jax(gemma, jax_answers, mode, kv):
    """Six requests over two scenes through two paged slots over pools of
    the cache's dtype: each scene's first request alone, then the rest at
    once (hits alias the scene's prefix pages). Every answer's ids are the
    JAX engine's sequential ones with the same prefix cache; every private
    page comes back."""
    cfg, params, data_cfg, records = gemma
    m = BATCHER_MODES[mode]
    _, eng = engines(cfg, params, data_cfg, kv_cache_dtype=kv, **m["engine"])
    for r in records:
        eng._tokenize_prompt(r)
    b = ContinuousBatcher(eng, num_slots=2, chunk=2, paged=True,
                          page_size=PAGE, **m["batcher"])
    try:
        assert b.state.cache.k.dtype == {"int8": torch.int8,
                                               "int4": torch.uint8}[kv]
        handles = {}
        for i in (0, 4):
            handles[i] = b.submit(records[i])
            handles[i].result(eng._decode_text, timeout=600)
        for i in (1, 2, 3, 5):
            handles[i] = b.submit(records[i])
        for i in (1, 2, 3, 5):
            handles[i].result(eng._decode_text, timeout=600)
        got = [_ids(handles[i].tokens) for i in range(len(records))]
        assert got == jax_answers[
            kv, m["engine"].get("prefix_cache_scenes", 0)]
        end = time.time() + 60
        while time.time() < end and any(s is not None for s in b.slots):
            time.sleep(0.02)
        held = sum(len(sh["pages"]) for sh in b._shared.values())
        assert b._alloc.available + held == b.total_pages - 1
        if mode != "paged":
            assert b.prefix_share_stats[0] >= 2
    finally:
        b.shutdown()
