"""PyTorch port vs the JAX package for the int8 and int4 KV caches, on the
CPU: the plain versions of the int8 and int4 forms of B3 (decode), B2
folded and B5 against the Pallas kernels in interpret mode (JAX fed a
``jnp.int4`` cache, the port the same values packed two per uint8 byte),
and ``decoder_layer``'s three cache branches (prefill, contiguous chunk with
and without a shared quantized prefix, one-token decode) over a quantized
cache against JAX ``decoder_layer``. Only valid query rows are compared
(pad rows are undefined by contract)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from video3d_tpu.config import LLMConfig
from video3d_tpu.kernels.decode_attention import \
    decode_attention as jax_decode
from video3d_tpu.kernels.flash_attention import (
    flash_attention_gqa_folded as jax_folded,
    flash_attention_shared_prefix as jax_shared_prefix)
from video3d_tpu.models import qwen2 as jqwen
from video3d_tpu_torch.kernels import _build
from video3d_tpu_torch.kernels import attention as tatt
from video3d_tpu_torch.kernels import quant_matvec as tqm
from video3d_tpu_torch.kernels.decode_attention import decode_attention
from video3d_tpu_torch.kernels.flash_attention import \
    flash_attention_gqa_folded
from video3d_tpu_torch.models import qwen2 as tqwen
from video3d_tpu_torch.params import _convert

from port_configs import port_config

torch.set_num_threads(1)

# The Pallas decode kernel runs an int8 cache through bf16 dots (the query
# block and the weights p rounded to bf16), so its interpret mode differs
# from the f32 plain version by bf16 rounding, as in tests/
# test_decode_attention.py; the flash kernel stays in f32 (blocked online
# softmax against one pass) and the shared-prefix oracle of JAX is the
# reference there, within the JAX test's own bound.
DECODE_TOL = 2e-3
FOLDED_TOL = 2e-4
SHARED_TOL = 2e-3


def t(a):
    return torch.from_numpy(np.asarray(a))


BITS = [8, 4]
QMAX = {8: 127, 4: 7}


def int8_cache(rng, *shape, bits=8):
    """int8 values in [-qmax, qmax] (qmax 127, or 7 for int4) and (..., KV,
    1) f32 scales as _quantize_kv makes them (shape = (..., KV, hd)); the
    scales grow with 127 / qmax, so the dequantized values keep their
    range."""
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
    x = torch.from_numpy(np.ascontiguousarray(a))
    return x if bits == 8 else tqwen.pack_kv_int4(x)


@pytest.mark.parametrize("bits", BITS)
@pytest.mark.parametrize("H,KV,lens", [(4, 2, [300, 1]), (7, 1, [257, 64])])
def test_int8_decode_plain_matches_jax_kernel(H, KV, lens, bits):
    """One token against layer 1 of a stacked (layers, B, S, KV*hd) int8 or
    int4 cache with stacked (layers, B, S, KV, 1) scales."""
    rng = np.random.default_rng(11)
    NL, S, hd, layer = 2, 320, 128, 1
    B = len(lens)
    q = rng.normal(size=(B, 1, H, hd)).astype(np.float32)
    k8, ks = int8_cache(rng, NL, B, S, KV, hd, bits=bits)
    v8, vs = int8_cache(rng, NL, B, S, KV, hd, bits=bits)
    kv_len = np.asarray(lens, np.int32)
    flat = (NL, B, S, KV * hd)
    before = dict(_build.LAUNCHES)
    got = decode_attention(t(q), tcache(k8.reshape(flat), bits),
                           tcache(v8.reshape(flat), bits), t(kv_len), layer,
                           KV, t(ks), t(vs)).numpy()
    assert _build.LAUNCHES == before
    ref = np.asarray(jax_decode(
        jnp.asarray(q), jcache(k8.reshape(flat), bits),
        jcache(v8.reshape(flat), bits), jnp.asarray(kv_len),
        k_scale=jnp.asarray(ks[layer]), v_scale=jnp.asarray(vs[layer]),
        layer=layer, kv_heads=KV, interpret=True))
    np.testing.assert_allclose(got, ref, rtol=DECODE_TOL, atol=DECODE_TOL)


@pytest.mark.parametrize("bits", BITS)
@pytest.mark.parametrize("H,KV,L", [(4, 2, 40), (7, 1, 20)])
def test_int8_folded_plain_matches_jax_kernel(H, KV, L, bits):
    """A chunk at ragged per-row offsets over layer 1 of a stacked int8 or
    int4 cache, against the folded Pallas kernel with its quantized form."""
    rng = np.random.default_rng(12)
    NL, B, S, hd, layer = 2, 2, 256, 128, 1
    q = rng.normal(size=(B, L, H, hd)).astype(np.float32)
    k8, ks = int8_cache(rng, NL, B, S, KV, hd, bits=bits)
    v8, vs = int8_cache(rng, NL, B, S, KV, hd, bits=bits)
    offs = np.asarray([100, 37], np.int32)
    lens = np.asarray([100 + L, 37 + L - 7], np.int32)
    flat = (NL, B, S, KV * hd)
    before = dict(_build.LAUNCHES)
    got = flash_attention_gqa_folded(
        t(q), tcache(k8.reshape(flat), bits), tcache(v8.reshape(flat), bits),
        t(lens), t(offs), layer, KV, t(ks), t(vs)).numpy()
    assert _build.LAUNCHES == before
    ref = np.asarray(jax_folded(
        jnp.asarray(q), jcache(k8[layer], bits), jcache(v8[layer], bits),
        jnp.asarray(lens), jnp.asarray(offs), k_scale=jnp.asarray(ks[layer]),
        v_scale=jnp.asarray(vs[layer]), block_q=64, block_k=64,
        interpret=True))
    for b in range(B):
        n = int(lens[b] - offs[b])
        np.testing.assert_allclose(got[b, :n], ref[b, :n], rtol=FOLDED_TOL,
                                   atol=FOLDED_TOL)


@pytest.mark.parametrize("bits", BITS)
@pytest.mark.parametrize("H,KV,L,P", [(4, 2, 64, 384), (7, 1, 64, 300)])
def test_int8_shared_prefix_plain_matches_jax_kernel(H, KV, L, P, bits):
    """B=3 suffixes over one int8 or int4 (P, KV, hd) prefix (int4 packed
    to (P, KV, hd / 2) bytes for the port) with (P, KV, 1) scales; the
    suffix K/V stay full precision."""
    rng = np.random.default_rng(13)
    B, hd = 3, 128
    q = rng.normal(size=(B, L, H, hd)).astype(np.float32)
    pk8, pks = int8_cache(rng, P, KV, hd, bits=bits)
    pv8, pvs = int8_cache(rng, P, KV, hd, bits=bits)
    sk = rng.normal(size=(B, L, KV, hd)).astype(np.float32)
    sv = rng.normal(size=(B, L, KV, hd)).astype(np.float32)
    slens = np.asarray([L, 17, L - 7], np.int32)
    before = dict(_build.LAUNCHES)
    got = tatt.mha_shared_prefix(t(q), tcache(pk8, bits), tcache(pv8, bits),
                                 t(sk), t(sv), t(slens), t(pks),
                                 t(pvs)).numpy()
    assert _build.LAUNCHES == before
    ref = np.asarray(jax_shared_prefix(
        jnp.asarray(q), jcache(pk8, bits), jcache(pv8, bits), jnp.asarray(sk),
        jnp.asarray(sv), jnp.asarray(slens), pk_scale=jnp.asarray(pks),
        pv_scale=jnp.asarray(pvs), block_q_prefix=128, block_k=128,
        interpret=True))
    for b in range(B):
        n = int(slens[b])
        np.testing.assert_allclose(got[b, :n], ref[b, :n], rtol=SHARED_TOL,
                                   atol=SHARED_TOL)


def _layer_case(branch, bits):
    """JAX and port ``decoder_layer`` of layer 1 on one input over the same
    int8 or int4 stacked cache (the first P slots of every row already hold
    a quantized prefix). Returns (jax out, jax cache 4-tuple, port out, port
    KVCache, valid rows per batch row)."""
    cfg = LLMConfig.tiny()
    jp = jqwen.init_qwen2(jax.random.PRNGKey(5), cfg)
    layer = 1
    jl = jp["layers"][layer]
    tl = _convert(jax.tree.map(np.asarray, jl), "cpu", None)
    rng = np.random.default_rng(7)
    NL, KV, hd = cfg.num_hidden_layers, cfg.num_key_value_heads, cfg.head_dim
    B, P, S = 3, 10, 24
    L = {"prefill": 9, "decode": 1}.get(branch, 7)
    # +-32 inputs and rotary angle 0 keep the K/V projections bit-identical
    # in both frameworks (f32 rsqrt and cos differ by an ulp between XLA and
    # torch in general): every x row then has mean square 1024, 1024 + eps
    # rounds to 1024, and its rsqrt, 1/32, is exact in both
    x = rng.choice([-32.0, 32.0], size=(B, L, cfg.hidden_size)).astype(
        np.float32)
    k8, ks = int8_cache(rng, NL, B, S, KV, hd, bits=bits)
    v8, vs = int8_cache(rng, NL, B, S, KV, hd, bits=bits)
    # every row holds the same prefix, as a seeded prefix cache does
    for a in (k8, ks, v8, vs):
        a[:, 1:, :P] = a[:, :1, :P]
    flat = (NL, B, S, KV * hd)
    if branch == "prefill":
        cpos = np.broadcast_to(np.arange(L)[None], (B, L)).copy()
        kv_len = np.asarray([L, 4, 6], np.int32)
        rows = kv_len
    elif branch == "decode":
        cpos = np.asarray([[P], [P + 3], [S - 1]], np.int64)
        kv_len = cpos[:, 0].astype(np.int32) + 1
        rows = [1] * B
    else:
        cpos = np.broadcast_to(P + np.arange(L)[None], (B, L)).copy()
        rows = np.asarray([L, 3, 5], np.int32)
        kv_len = P + rows
    pos3 = np.zeros((B, L, 3), np.int64)
    shared = branch == "shared"
    jsp = tsp = None
    if shared:
        pre = [a[layer, 0, :P] for a in (k8, v8, ks, vs)]
        jsp = (jcache(pre[0], bits), jcache(pre[1], bits),
               *map(jnp.asarray, pre[2:]))
        tsp = (tcache(pre[0], bits), tcache(pre[1], bits),
               *(t(a.copy()) for a in pre[2:]))
    jcos, jsin = jqwen.compute_mrope_cos_sin(jnp.asarray(pos3), cfg)
    jout, jkv = jqwen.decoder_layer(
        jl, jnp.asarray(x), jcos, jsin, cfg,
        kv=(jcache(k8.reshape(flat), bits), jcache(v8.reshape(flat), bits),
            jnp.asarray(ks), jnp.asarray(vs)),
        cache_positions=jnp.asarray(cpos), kv_len=jnp.asarray(kv_len),
        prefill=branch == "prefill",
        contiguous_update=branch in ("chunk", "shared"),
        shared_prefix=jsp, layer_idx=layer, kv_stacked=True)
    cache = tqwen.KVCache(tcache(k8.reshape(flat), bits).clone(),
                          tcache(v8.reshape(flat), bits).clone(),
                          t(ks.copy()), t(vs.copy()))
    tcfg = port_config(cfg)
    tcos, tsin = tqwen.compute_mrope_cos_sin(t(pos3), tcfg)
    tout = tqwen.decoder_layer(
        tl, t(x), tcos, tsin, tcfg, layer, cache, t(cpos), t(kv_len),
        prefill=branch == "prefill",
        cache_start=P if branch in ("chunk", "shared") else None,
        shared_prefix=tsp)
    return np.asarray(jout), list(jkv), tout.numpy(), cache, rows


@pytest.mark.parametrize("bits", BITS)
@pytest.mark.parametrize("branch", ["prefill", "chunk", "shared", "decode"])
def test_decoder_layer_int8_cache_matches_jax(branch, bits):
    """Prefill writes slots [0, L) and attends the raw K/V; a chunk at
    [P, P + L) attends the cache (B=1 path) or the shared quantized prefix
    plus its raw K/V (B>1 path); one token lands at per-row positions and
    attends the cache. The int8 / int4 values (the port's int4 unpacked)
    and f32 scales written into the cache are bit-identical to JAX's;
    outputs agree within 1e-4 (f32)."""
    jout, jkv, tout, cache, rows = _layer_case(branch, bits)
    for b, n in enumerate(rows):
        np.testing.assert_allclose(tout[b, :n], jout[b, :n], rtol=0,
                                   atol=1e-4)
    for got, want in zip(cache, jkv):
        if bits == 4 and got.dtype == torch.uint8:
            got, want = tqwen.unpack_kv_int4(got), want.astype(jnp.int8)
        want = np.asarray(want)
        assert got.numpy().dtype == want.dtype
        np.testing.assert_array_equal(got.numpy(), want)


def test_quantized_cache_dtypes():
    """KVCache.zeros(int8) carries f32 scales of shape (layers, B, S, KV,
    1), as the JAX cache; KVCache.zeros(KV_INT4) the same scales beside
    uint8 values with half JAX's int4 row width; a bf16 cache carries
    none."""
    cfg = LLMConfig.tiny()
    c8 = tqwen.KVCache.zeros(port_config(cfg), 2, 5, dtype=torch.int8)
    j8 = jqwen.KVCache.zeros(cfg, 2, 5, dtype=jnp.int8)
    for got, want in zip(c8, j8):
        assert tuple(got.shape) == want.shape
        assert str(got.dtype).split(".")[-1] == str(want.dtype)
    c4 = tqwen.KVCache.zeros(port_config(cfg), 2, 5, dtype=tqwen.KV_INT4)
    j4 = jqwen.KVCache.zeros(cfg, 2, 5, dtype=jnp.int4)
    for got, want in zip(c4[:2], j4[:2]):
        assert got.dtype == torch.uint8 and want.dtype == jnp.int4
        assert tuple(got.shape) == want.shape[:-1] + (want.shape[-1] // 2,)
    for got, want in zip(c4[2:], j4[2:]):
        assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
    cb = tqwen.KVCache.zeros(port_config(cfg), 2, 5)
    assert cb.k.dtype == torch.bfloat16 and cb.k_scale is None


def test_kv_int4_pack_round_trip_and_nibble_order():
    """Every int4 value in every byte position unpacks to itself; byte j of
    a row holds channel 2j in its low nibble and 2j + 1 in its high nibble
    (two's complement), the order of the int4 weights along their rows;
    ``_quantize_kv`` with the int4 tag equals JAX's int4 quantization bit
    for bit and stays within [-7, 7]."""
    vals = torch.arange(-7, 8, dtype=torch.int8)
    pairs = torch.stack(torch.meshgrid(vals, vals, indexing="ij"), -1) \
        .reshape(225, 2)
    q = torch.cat([pairs, pairs.roll(1, 0)], -1).reshape(3, 75, 4)
    packed = tqwen.pack_kv_int4(q)
    assert packed.dtype == torch.uint8 and packed.shape == (3, 75, 2)
    assert torch.equal(tqwen.unpack_kv_int4(packed), q)
    lo, hi = q[..., 0::2].int() & 0xF, q[..., 1::2].int() & 0xF
    assert torch.equal(packed.int(), lo | (hi << 4))
    assert tqwen.pack_kv_int4(torch.tensor([[-1, 3]], dtype=torch.int8)) \
        .item() == 0x3F
    # the weights' pair (dim 0) and the cache's (dim -1) are one convention
    assert torch.equal(tqwen.pack_kv_int4(q).view(torch.int8),
                       tqm.pack_int4(q.transpose(0, -1)).transpose(0, -1))
    x = np.random.default_rng(3).normal(size=(2, 9, 2, 128)) \
        .astype(np.float32)
    x[0, 0] = 0.0                                 # the 1e-8 floor
    jq, js = jqwen._quantize_kv(jnp.asarray(x), jnp.int4)
    tq, ts = tqwen._quantize_kv(torch.from_numpy(x), tqwen.KV_INT4)
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq.astype(jnp.int8)))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    assert int(tq.abs().max()) == 7


def test_off_cpu_int8_tensors_without_kernel_raise():
    """A non-CPU tensor (an int8 or a packed int4 cache) never falls back
    to the plain versions."""
    q1 = torch.zeros((1, 1, 4, 128), device="meta")
    q = torch.zeros((1, 64, 4, 128), device="meta")
    cache = torch.zeros((1, 1, 96, 256), dtype=torch.int8, device="meta")
    scale = torch.zeros((1, 1, 96, 2, 1), device="meta")
    n = torch.ones(1, dtype=torch.int32)
    with pytest.raises(ValueError, match="no kernel"):
        decode_attention(q1, cache, cache, n, 0, 2, scale, scale)
    with pytest.raises(ValueError, match="no kernel"):
        flash_attention_gqa_folded(q, cache, cache, n, n, 0, 2, scale, scale)
    pk = torch.zeros((32, 2, 128), dtype=torch.int8, device="meta")
    ps = torch.zeros((32, 2, 1), device="meta")
    sk = torch.zeros((1, 64, 2, 128), device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        tatt.mha_shared_prefix(q, pk, pk, sk, sk, n, ps, ps)
    packed = torch.zeros((1, 1, 96, 128), dtype=torch.uint8, device="meta")
    with pytest.raises(ValueError, match="no kernel"):       # int4
        decode_attention(q1, packed, packed, n, 0, 2, scale, scale)
    with pytest.raises(ValueError, match="no kernel"):
        flash_attention_gqa_folded(q, packed, packed, n, n, 0, 2, scale,
                                   scale)
