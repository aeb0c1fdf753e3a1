"""PyTorch port vs the JAX package for the scene-prefix attention path, on
the CPU in float32: the plain versions of the GQA-folded flash kernel (B2
folded) and of the shared-prefix kernel (B5) against the Pallas kernels in
interpret mode, the multi-token branch of ``mha_cached_stacked``, and the
contiguous-chunk / shared-prefix branches of ``decoder_layer``. Only valid
query rows are compared (pad rows are undefined by contract)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from video3d_tpu.config import LLMConfig
from video3d_tpu.kernels import attention as jatt
from video3d_tpu.kernels.flash_attention import (
    flash_attention_gqa_folded as jax_folded,
    flash_attention_shared_prefix as jax_shared_prefix)
from video3d_tpu.models import qwen2 as jqwen
from video3d_tpu_torch.kernels import _build
from video3d_tpu_torch.kernels import attention as tatt
from video3d_tpu_torch.kernels.flash_attention import (
    flash_attention_gqa_folded, flash_attention_shared_prefix)
from video3d_tpu_torch.models import qwen2 as tqwen
from video3d_tpu_torch.params import _convert

from port_configs import port_config

torch.set_num_threads(1)

TOL = 2e-4     # f32, blocked online softmax vs one-pass softmax


def normal(rng, *shape):
    return rng.normal(size=shape).astype(np.float32)


def t(a):
    return torch.from_numpy(np.asarray(a))


@pytest.mark.parametrize("H,KV,L", [(4, 2, 40), (7, 1, 20)])
def test_folded_plain_matches_jax_kernel(H, KV, L):
    """B=2, ragged query offsets and key lengths, keys read from one layer
    of a stacked (layers, B, S, KV*hd) cache; L*group folded rows span
    several 64-row query blocks of the JAX kernel."""
    rng = np.random.default_rng(0)
    NL, B, S, hd, layer = 2, 2, 256, 128, 1
    q = normal(rng, B, L, H, hd)
    k_all, v_all = normal(rng, NL, B, S, KV * hd), normal(rng, NL, B, S, KV * hd)
    offs = np.asarray([100, 37], np.int32)
    lens = np.asarray([100 + L, 37 + L - 7], np.int32)
    before = dict(_build.LAUNCHES)
    got = flash_attention_gqa_folded(t(q), t(k_all), t(v_all), t(lens),
                                     t(offs), layer, KV).numpy()
    assert _build.LAUNCHES == before
    ref = np.asarray(jax_folded(
        jnp.asarray(q), jnp.asarray(k_all[layer].reshape(B, S, KV, hd)),
        jnp.asarray(v_all[layer].reshape(B, S, KV, hd)), jnp.asarray(lens),
        jnp.asarray(offs), block_q=64, block_k=64, interpret=True))
    for b in range(B):
        n = int(lens[b] - offs[b])
        np.testing.assert_allclose(got[b, :n], ref[b, :n], rtol=TOL,
                                   atol=TOL)


@pytest.mark.parametrize("H,KV,L,P", [
    (4, 2, 64, 512),        # group 2
    (7, 1, 64, 300),        # group 7 (Qwen2-7B), P not a multiple of 64
    (8, 8, 32, 256),        # MHA (group 1)
])
def test_shared_prefix_matches_jax_kernel(H, KV, L, P):
    """mha_shared_prefix (CPU -> the plain version) against the JAX fused
    shared-prefix kernel, B=3 with ragged suffix lengths."""
    rng = np.random.default_rng(31)
    B, hd = 3, 128
    q = normal(rng, B, L, H, hd)
    pk, pv = normal(rng, P, KV, hd), normal(rng, P, KV, hd)
    sk, sv = normal(rng, B, L, KV, hd), normal(rng, B, L, KV, hd)
    slens = np.asarray([L, max(1, L // 3), max(1, L - 7)], np.int32)
    before = dict(_build.LAUNCHES)
    got = tatt.mha_shared_prefix(t(q), t(pk), t(pv), t(sk), t(sv),
                                 t(slens)).numpy()
    assert _build.LAUNCHES == before
    ref = np.asarray(jax_shared_prefix(
        jnp.asarray(q), jnp.asarray(pk), jnp.asarray(pv), jnp.asarray(sk),
        jnp.asarray(sv), jnp.asarray(slens), block_q_prefix=128,
        block_k=128, interpret=True))
    for b in range(B):
        n = int(slens[b])
        np.testing.assert_allclose(got[b, :n], ref[b, :n], rtol=TOL,
                                   atol=TOL)


def test_mha_cached_stacked_chunk_matches_jax():
    """L > 1 chunk at contiguous per-row positions over a bf16 stacked
    cache read into an f32 query, as the JAX CPU branch does."""
    rng = np.random.default_rng(2)
    NL, B, L, S, H, KV, hd = 2, 2, 16, 96, 4, 2, 16
    q = normal(rng, B, L, H, hd)
    kt = t(normal(rng, NL, B, S, KV * hd)).to(torch.bfloat16)
    vt = t(normal(rng, NL, B, S, KV * hd)).to(torch.bfloat16)
    pos = np.asarray([[40], [70]], np.int64) + np.arange(L)[None]
    kv_len = np.asarray([56, 80], np.int32)
    got = tatt.mha_cached_stacked(t(q), kt, vt, 1, KV, t(pos),
                                  t(kv_len)).numpy()
    ref = np.asarray(jatt.mha_cached_stacked(
        jnp.asarray(q), jnp.asarray(kt.float().numpy(), jnp.bfloat16),
        jnp.asarray(vt.float().numpy(), jnp.bfloat16), 1, KV,
        jnp.asarray(pos), jnp.asarray(kv_len)))
    np.testing.assert_allclose(got, ref, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("shared", [True, False])
def test_decoder_layer_chunk_matches_jax(shared):
    """A suffix chunk written at [P, P + L) of every row of a stacked cache
    already holding a prefix, attending either the shared (P, KV, hd)
    prefix view plus its own raw K/V (B > 1 path) or the cache (B = 1
    path): layer output and cache contents against JAX ``decoder_layer``."""
    cfg = LLMConfig.tiny()
    jp = jqwen.init_qwen2(jax.random.PRNGKey(5), cfg)
    layer = 1
    jl = jp["layers"][layer]
    tl = _convert(jax.tree.map(np.asarray, jl), "cpu", None)
    rng = np.random.default_rng(6)
    NL, KV, hd = cfg.num_hidden_layers, cfg.num_key_value_heads, cfg.head_dim
    B, P, L, S = 3, 10, 7, 24
    x = normal(rng, B, L, cfg.hidden_size)
    k_all, v_all = normal(rng, NL, B, S, KV * hd), normal(rng, NL, B, S, KV * hd)
    prefix_k, prefix_v = normal(rng, NL, P, KV * hd), normal(rng, NL, P, KV * hd)
    k_all[:, :, :P] = prefix_k[:, None]
    v_all[:, :, :P] = prefix_v[:, None]
    slens = np.asarray([L, 3, 5], np.int32)
    kv_len = P + slens
    cpos = np.broadcast_to(P + np.arange(L)[None], (B, L)).copy()
    pos3 = np.broadcast_to(cpos[..., None], (B, L, 3)).copy()
    jsp = (jnp.asarray(prefix_k[layer].reshape(P, KV, hd)),
           jnp.asarray(prefix_v[layer].reshape(P, KV, hd))) if shared else None
    jcos, jsin = jqwen.compute_mrope_cos_sin(jnp.asarray(pos3), cfg)
    jout, (jk, jv) = jqwen.decoder_layer(
        jl, jnp.asarray(x), jcos, jsin, cfg,
        kv=(jnp.asarray(k_all), jnp.asarray(v_all)),
        cache_positions=jnp.asarray(cpos), kv_len=jnp.asarray(kv_len),
        contiguous_update=True, shared_prefix=jsp, layer_idx=layer,
        kv_stacked=True)

    cache = tqwen.KVCache(t(k_all.copy()), t(v_all.copy()))
    tsp = (t(prefix_k[layer]).reshape(P, KV, hd),
           t(prefix_v[layer]).reshape(P, KV, hd)) if shared else None
    tcfg = port_config(cfg)
    tcos, tsin = tqwen.compute_mrope_cos_sin(t(pos3), tcfg)
    tout = tqwen.decoder_layer(tl, t(x), tcos, tsin, tcfg, layer, cache,
                               t(cpos), t(kv_len), cache_start=P,
                               shared_prefix=tsp).numpy()
    for b in range(B):
        np.testing.assert_allclose(tout[b, :slens[b]],
                                   np.asarray(jout)[b, :slens[b]],
                                   rtol=0, atol=1e-4)
    np.testing.assert_allclose(cache.k.numpy(), np.asarray(jk), rtol=0,
                               atol=1e-5)
    np.testing.assert_allclose(cache.v.numpy(), np.asarray(jv), rtol=0,
                               atol=1e-5)


def test_off_cpu_tensors_without_kernel_raise():
    """A non-CPU tensor never falls back to the plain version."""
    q = torch.zeros((1, 64, 4, 128), device="meta")
    cache = torch.zeros((1, 1, 96, 256), device="meta")
    n = torch.ones(1, dtype=torch.int32)
    with pytest.raises(ValueError, match="no kernel"):
        flash_attention_gqa_folded(q, cache, cache, n, n, 0, 2)
    pk = torch.zeros((32, 2, 128), device="meta")
    sk = torch.zeros((1, 64, 2, 128), device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        flash_attention_shared_prefix(q, pk, pk, sk, sk, n)
