"""PyTorch port vs the JAX package: plain versions of the flash prefill
kernel (B2) and the stacked-cache decode kernel (B3), against the Pallas
kernels in interpret mode, on the CPU in float32."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from video3d_tpu.kernels import attention as jatt
from video3d_tpu.kernels.decode_attention import \
    decode_attention as jax_decode_attention
from video3d_tpu.kernels.flash_attention import \
    flash_attention as jax_flash_attention
from video3d_tpu_torch.kernels import _build
from video3d_tpu_torch.kernels import attention as tatt
from video3d_tpu_torch.kernels.decode_attention import decode_attention
from video3d_tpu_torch.kernels.flash_attention import flash_attention

torch.set_num_threads(1)

F32_ATOL = 1e-5    # f32 online softmax vs one-pass softmax


def normal(rng, *shape):
    return rng.normal(size=shape).astype(np.float32)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("L,lengths", [(200, [200, 137]), (128, [128, 1])])
def test_flash_plain_matches_jax_kernel(causal, L, lengths):
    """L not a multiple of the 64-row tile; per-row key lengths."""
    rng = np.random.default_rng(0)
    B, H, KV, hd = 2, 4, 2, 16
    q, k, v = normal(rng, B, L, H, hd), normal(rng, B, L, KV, hd), \
        normal(rng, B, L, KV, hd)
    lens = np.asarray(lengths, np.int32)
    before = dict(_build.LAUNCHES)
    got = flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                          torch.from_numpy(v), torch.from_numpy(lens),
                          causal=causal).numpy()
    assert _build.LAUNCHES == before
    ref = np.asarray(jax_flash_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
        lengths=jnp.asarray(lens), causal=causal, block_q=64, block_k=64,
        interpret=True))
    for b, n in enumerate(lengths):          # rows >= length are garbage
        np.testing.assert_allclose(got[b, :n], ref[b, :n], rtol=0,
                                   atol=F32_ATOL)


@pytest.mark.parametrize("layer,lens", [(1, [256, 77]), (2, [1, 200])])
def test_decode_plain_matches_jax_kernel(layer, lens):
    """Stacked flat (layers, B, S, KV*hd) cache read at ``layer``."""
    rng = np.random.default_rng(1)
    NL, B, S, H, KV, hd = 3, 2, 256, 8, 2, 128
    q = normal(rng, B, 1, H, hd)
    k_all, v_all = normal(rng, NL, B, S, KV * hd), normal(rng, NL, B, S, KV * hd)
    kv_len = np.asarray(lens, np.int32)
    got = decode_attention(torch.from_numpy(q), torch.from_numpy(k_all),
                           torch.from_numpy(v_all), torch.from_numpy(kv_len),
                           layer=layer, kv_heads=KV).numpy()
    ref = np.asarray(jax_decode_attention(
        jnp.asarray(q), jnp.asarray(k_all), jnp.asarray(v_all),
        jnp.asarray(kv_len), layer=layer, kv_heads=KV, interpret=True))
    np.testing.assert_allclose(got, ref, rtol=0, atol=F32_ATOL)


def test_mha_cached_stacked_matches_jax():
    """Effective length min(q_position + 1, kv_len), bf16 cache read into
    an f32 query, as the JAX CPU branch does."""
    rng = np.random.default_rng(2)
    NL, B, S, H, KV, hd = 2, 3, 64, 4, 2, 16
    q = normal(rng, B, 1, H, hd)
    k_all, v_all = normal(rng, NL, B, S, KV * hd), normal(rng, NL, B, S, KV * hd)
    pos = np.asarray([[10], [63], [30]], np.int32)
    kv_len = np.asarray([11, 40, 64], np.int32)
    kt = torch.from_numpy(k_all).to(torch.bfloat16)
    vt = torch.from_numpy(v_all).to(torch.bfloat16)
    got = tatt.mha_cached_stacked(torch.from_numpy(q), kt, vt, 1, KV,
                                  torch.from_numpy(pos),
                                  torch.from_numpy(kv_len)).numpy()
    ref = np.asarray(jatt.mha_cached_stacked(
        jnp.asarray(q), jnp.asarray(kt.float().numpy(), jnp.bfloat16),
        jnp.asarray(vt.float().numpy(), jnp.bfloat16), 1, KV,
        jnp.asarray(pos), jnp.asarray(kv_len)))
    np.testing.assert_allclose(got, ref, rtol=0, atol=F32_ATOL)


def test_mha_reference_matches_jax():
    rng = np.random.default_rng(3)
    q, k, v = normal(rng, 2, 9, 4, 8), normal(rng, 2, 9, 2, 8), \
        normal(rng, 2, 9, 2, 8)
    lens = np.asarray([9, 5], np.int32)
    got = tatt.mha_reference(torch.from_numpy(q), torch.from_numpy(k),
                             torch.from_numpy(v),
                             kv_len=torch.from_numpy(lens)).numpy()
    ref = np.asarray(jatt.mha_reference(jnp.asarray(q), jnp.asarray(k),
                                        jnp.asarray(v),
                                        kv_len=jnp.asarray(lens)))
    np.testing.assert_allclose(got, ref, rtol=0, atol=F32_ATOL)


def test_off_cpu_tensors_without_kernel_raise():
    """A non-CPU tensor never falls back to the plain version."""
    q = torch.zeros((1, 4, 2, 128), device="meta")
    kv = torch.zeros((1, 4, 1, 128), device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        flash_attention(q, kv, kv)
    cache = torch.zeros((1, 1, 8, 128), device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        decode_attention(q[:, :1], cache, cache,
                         torch.ones(1, dtype=torch.int32), 0, 1)
