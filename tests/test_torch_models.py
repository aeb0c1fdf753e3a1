"""PyTorch port vs the JAX package on tiny configs in float32: the SigLIP
tower; projector -> pool -> sin3d PE -> grid newlines -> assemble_embeds;
Qwen2 prefill (logits and KV-cache contents) and one cached decode step.
Parameters are the JAX init leaves carried across by from_jax_params."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from video3d_tpu.config import LLMConfig, ModelConfig
from video3d_tpu.constants import IMAGE_TOKEN_INDEX
from video3d_tpu.models import llava_video3d as jlv
from video3d_tpu.models import qwen2 as jqwen
from video3d_tpu.models import siglip as jsig
from video3d_tpu.models.splice import build_splice_plan
from video3d_tpu_torch.models import llava_video3d as tlv
from video3d_tpu_torch.models import qwen2 as tqwen
from video3d_tpu_torch.models import siglip as tsig
from video3d_tpu_torch.params import _convert, from_jax_params

from port_configs import port_config

torch.set_num_threads(1)

CFG = ModelConfig.tiny()
TCFG = port_config(CFG)
ATOL = 1e-4     # f32, different matmul blockings and reduction orders


def to_torch(tree):
    return _convert(jax.tree.map(np.asarray, tree), "cpu", None)


def close(a, b, atol=ATOL):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=0,
                               atol=atol)


def test_siglip_tower_matches_jax():
    params = jsig.init_vision_tower(jax.random.PRNGKey(0), CFG.vision)
    px = np.random.default_rng(0).normal(size=(3, 3, 56, 56)) \
        .astype(np.float32)
    ref = jsig.vision_tower_forward(params, jnp.asarray(px), CFG.vision)
    got = tsig.vision_tower_forward(to_torch(params), torch.from_numpy(px),
                                    TCFG.vision)
    assert got.shape == (3, CFG.vision.num_patches, CFG.vision.hidden_size)
    close(got, ref)


@pytest.fixture(scope="module")
def model_params():
    params = jlv.init_model(jax.random.PRNGKey(1), CFG)
    return params, from_jax_params(jax.tree.map(np.asarray, params), TCFG,
                                   device="cpu")


def test_vision_tokens_and_embeds_match_jax(model_params):
    jp, tp = model_params
    rng = np.random.default_rng(2)
    V, S = 3, CFG.vision.image_size
    g = -(-CFG.vision.num_patches_per_side // CFG.spatial_pool_stride)
    images = rng.normal(size=(1, V, 3, S, S)).astype(np.float32)
    coords = rng.integers(0, 301, size=(1, V, g, g, 3)).astype(np.float32)
    ref = jlv.encode_video(jp, CFG, jnp.asarray(images), jnp.asarray(coords))
    got = tlv.encode_video(tp, TCFG, torch.from_numpy(images),
                           torch.from_numpy(coords))
    for name in ("raw", "pooled", "spliceable"):
        close(getattr(got, name), getattr(ref, name))

    ids = [11, 12, IMAGE_TOKEN_INDEX, 13, 14, 15]
    plan = build_splice_plan([ids], None, [V],
                             tokens_per_frame=CFG.tokens_per_frame,
                             max_len=48, grid_side=g)
    jemb = jlv.assemble_embeds(jp, CFG, ref.spliceable,
                               jnp.asarray(plan.text_ids),
                               jnp.asarray(plan.kind),
                               jnp.asarray(plan.vision_index))
    temb = tlv.assemble_embeds(
        tp, TCFG, got.spliceable, torch.from_numpy(plan.text_ids).long(),
        torch.from_numpy(plan.kind), torch.from_numpy(plan.vision_index).long())
    close(temb, jemb)


def test_qwen2_prefill_and_decode_match_jax():
    cfg = LLMConfig.tiny()
    tcfg = port_config(cfg)
    jp = jqwen.init_qwen2(jax.random.PRNGKey(3), cfg)
    tp = to_torch(jp)
    rng = np.random.default_rng(4)
    B, L, S = 2, 24, 32
    embeds = rng.normal(size=(B, L, cfg.hidden_size)).astype(np.float32)
    pos = np.broadcast_to(np.arange(L)[None, :, None], (B, L, 3)).copy()
    pos[1] += 3                                   # a row with offset ids
    seq_len = np.asarray([24, 17], np.int32)
    cpos = np.broadcast_to(np.arange(L)[None], (B, L)).copy()

    jcache = jqwen.KVCache.zeros(cfg, B, S, dtype=jnp.float32)
    jh, jcache = jqwen.qwen2_forward(
        jp, cfg, jnp.asarray(embeds), jnp.asarray(pos), kv_cache=jcache,
        cache_positions=jnp.asarray(cpos), kv_len=jnp.asarray(seq_len),
        prefill=True)
    tcache = tqwen.KVCache.zeros(tcfg, B, S, dtype=torch.float32)
    th = tqwen.qwen2_forward(
        tp, tcfg, torch.from_numpy(embeds), torch.from_numpy(pos),
        kv_cache=tcache, cache_positions=torch.from_numpy(cpos),
        kv_len=torch.from_numpy(seq_len), prefill=True)
    close(tqwen.lm_head(tp, th), jqwen.lm_head(jp, jh))
    close(tcache.k, jcache.k)
    close(tcache.v, jcache.v)

    # one decode step at each row's next position, reading the cache
    step = rng.normal(size=(B, 1, cfg.hidden_size)).astype(np.float32)
    dpos = seq_len.astype(np.int64)[:, None]
    dpos3 = np.broadcast_to(dpos[..., None], (B, 1, 3))
    jh, jcache = jqwen.qwen2_forward(
        jp, cfg, jnp.asarray(step), jnp.asarray(dpos3), kv_cache=jcache,
        cache_positions=jnp.asarray(dpos), kv_len=jnp.asarray(dpos[:, 0] + 1))
    th = tqwen.qwen2_forward(
        tp, tcfg, torch.from_numpy(step), torch.from_numpy(dpos3.copy()),
        kv_cache=tcache, cache_positions=torch.from_numpy(dpos),
        kv_len=torch.from_numpy(dpos[:, 0] + 1))
    close(tqwen.lm_head(tp, th), jqwen.lm_head(jp, jh))
    close(tcache.k, jcache.k)
    close(tcache.v, jcache.v)


def test_mrope_tables_match_jax():
    cfg = LLMConfig()                               # hd 128, [32, 16, 16]
    pos = np.random.default_rng(5).integers(0, 9000, size=(1, 7, 3))
    jc, js = jqwen.compute_mrope_cos_sin(jnp.asarray(pos), cfg)
    tc, ts = tqwen.compute_mrope_cos_sin(torch.from_numpy(pos),
                                         port_config(cfg))
    close(tc, jc, 1e-5)
    close(ts, js, 1e-5)
