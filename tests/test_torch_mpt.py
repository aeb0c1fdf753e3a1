"""The MPT family (ALiBi, LayerNorm, ungated GELU MLP, tied head) in the
port against the JAX package, on the CPU in float32: the ALiBi slopes (32
heads and counts that are not a power of 2), the full forward, the cached
prefill and decode, ``convert_mpt``, the engine's miss and hit, and the
refusals of what JAX cannot run (paged decode with ALiBi, where JAX
asserts; the export of an MPT or a MoE tree, where JAX fails).

JAX's cached path sizes the ALiBi bias by ``kv[0].shape[1]``, which is the
batch of the stacked (layers, B, S, C) cache: at B = 1 every key gets a
bias of 0 and at B > 1 the add does not broadcast. The port biases the
cache's keys by position (the bias JAX's cache-free forward applies);
``test_jax_cached_path_drops_the_bias`` holds JAX's behaviour, and the
engine comparison runs JAX with its ``mha_reference`` handed the bias
of the keys it sees."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from video3d_tpu.kernels import attention as jattn
from video3d_tpu.models import qwen2 as jqwen
from video3d_tpu.models import weights as jw
from video3d_tpu_torch.models import paged_kv as tpkv
from video3d_tpu_torch.models import qwen2 as tqwen
from video3d_tpu_torch.models import weights as tw
from video3d_tpu_torch.params import from_jax_tree
from video3d_tpu_torch.serve.batcher import ContinuousBatcher

from family_configs import (QUESTIONS, data_config, engines, hf_llm_state,
                            jax_params, model_config, question)
from fixtures import make_fake_scene
from port_configs import port_config

ATOL = 1e-4
CFG = model_config("mpt")
TLLM = port_config(CFG.llm)


def _positions(B, L, start=0):
    return np.broadcast_to(np.arange(start, start + L)[None, :, None],
                           (B, L, 3)).copy()


@pytest.fixture(scope="module")
def llm():
    return jax_params(CFG)["llm"]


@pytest.mark.parametrize("heads", [32, 4, 6, 12])
def test_alibi_slopes_match_jax(heads):
    np.testing.assert_allclose(tqwen.alibi_slopes(heads, 8.0).numpy(),
                               np.asarray(jqwen.alibi_slopes(heads, 8.0)),
                               rtol=1e-6)
    cfg = jqwen.LLMConfig(num_attention_heads=heads, alibi_bias_max=4.0)
    np.testing.assert_allclose(
        tqwen.alibi_bias(port_config(cfg), 9).numpy(),
        np.asarray(jqwen.alibi_bias(cfg, 9)), rtol=1e-6)


def _jax_logits(llm, ids, kv_len=None):
    B, L = ids.shape
    h, _ = jqwen.qwen2_forward(llm, CFG.llm,
                               jqwen.embed_tokens(llm, jnp.asarray(ids)),
                               jnp.asarray(_positions(B, L)),
                               kv_len=None if kv_len is None
                               else jnp.asarray(kv_len))
    return np.asarray(jqwen.lm_head(llm, h))


def test_full_forward_matches_jax(llm):
    ids = np.random.default_rng(0).integers(0, 512, size=(2, 9))
    kv_len = np.array([9, 6])
    want = _jax_logits(llm, ids, kv_len)
    tp = from_jax_tree(llm, device="cpu")
    with torch.no_grad():
        h = tqwen.qwen2_forward(tp, TLLM, tqwen.embed_tokens(
            tp, torch.from_numpy(ids)), torch.from_numpy(_positions(2, 9)),
            kv_len=torch.from_numpy(kv_len))
        got = tqwen.lm_head(tp, h).numpy()
    for b, n in enumerate(kv_len):
        np.testing.assert_allclose(got[b, :n], want[b, :n], rtol=0,
                                   atol=ATOL)


def test_cached_decode_matches_the_full_forward(llm):
    """Prefill into a cache, then cached decode steps (greedy, B = 2):
    every step's logits equal JAX's cache-free forward over the whole
    sequence, and so do the ids."""
    tp = from_jax_tree(llm, device="cpu")
    ids = np.random.default_rng(1).integers(0, 512, size=(2, 5))
    B, L0, S = 2, 5, 16
    cache = tqwen.KVCache.zeros(TLLM, B, S, dtype=torch.float32)
    seq = ids.copy()
    with torch.no_grad():
        h = tqwen.qwen2_forward(
            tp, TLLM, tqwen.embed_tokens(tp, torch.from_numpy(ids)),
            torch.from_numpy(_positions(B, L0)), kv_cache=cache,
            cache_positions=torch.arange(L0)[None].expand(B, L0),
            kv_len=torch.full((B,), L0), prefill=True)
        logits = tqwen.lm_head(tp, h)[:, -1].numpy()
        for step in range(4):
            want = _jax_logits(llm, seq)[:, -1]
            np.testing.assert_allclose(logits, want, rtol=0, atol=ATOL,
                                       err_msg=f"step {step}")
            tok = logits.argmax(-1)
            seq = np.concatenate([seq, tok[:, None]], 1)
            pos = seq.shape[1] - 1
            h = tqwen.qwen2_forward(
                tp, TLLM, tqwen.embed_tokens(tp, torch.from_numpy(tok)[:,
                                                                     None]),
                torch.from_numpy(_positions(B, 1, pos)), kv_cache=cache,
                cache_positions=torch.full((B, 1), pos),
                kv_len=torch.full((B,), pos + 1))
            logits = tqwen.lm_head(tp, h)[:, 0].numpy()


def test_jax_cached_path_drops_the_bias(llm):
    """JAX's prefill through a B = 1 cache biases every key by 0, so it
    departs from JAX's own cache-free forward; the port's cached prefill
    does not."""
    ids = np.random.default_rng(2).integers(0, 512, size=(1, 7))
    full = _jax_logits(llm, ids)
    cache = jqwen.KVCache.zeros(CFG.llm, 1, 16, dtype=jnp.float32)
    h, _ = jqwen.qwen2_forward(llm, CFG.llm,
                               jqwen.embed_tokens(llm, jnp.asarray(ids)),
                               jnp.asarray(_positions(1, 7)), kv_cache=cache,
                               cache_positions=jnp.arange(7)[None],
                               kv_len=jnp.asarray([7]), prefill=True)
    jax_cached = np.asarray(jqwen.lm_head(llm, h))
    assert np.abs(jax_cached - full).max() > 1e-2
    tp = from_jax_tree(llm, device="cpu")
    with torch.no_grad():
        th = tqwen.qwen2_forward(
            tp, TLLM, tqwen.embed_tokens(tp, torch.from_numpy(ids)),
            torch.from_numpy(_positions(1, 7)),
            kv_cache=tqwen.KVCache.zeros(TLLM, 1, 16, dtype=torch.float32),
            cache_positions=torch.arange(7)[None],
            kv_len=torch.tensor([7]), prefill=True)
        got = tqwen.lm_head(tp, th).numpy()
    np.testing.assert_allclose(got, full, rtol=0, atol=ATOL)


def test_convert_mpt_matches_jax(llm):
    state = hf_llm_state(CFG, llm)
    want = jax.tree.map(np.asarray, jw.convert_mpt(state, CFG.llm))
    got = tw.convert_mpt(state, TLLM, device="cpu")
    assert set(got) == set(want)
    for i, (a, b) in enumerate(zip(got["layers"], want["layers"])):
        for k in ("wq", "wk", "wv", "wo"):
            np.testing.assert_array_equal(a["attn"][k].numpy(), b["attn"][k],
                                          err_msg=f"{i}/{k}")
        for k in ("w_up", "w_down"):
            np.testing.assert_array_equal(a["mlp"][k].numpy(), b["mlp"][k])
    for k in ("embed_tokens", "norm", "lm_head"):
        np.testing.assert_array_equal(got[k].numpy(), want[k])
    assert tw.mpt_config_from_hf(
        {"d_model": 64, "n_heads": 4, "n_layers": 2, "vocab_size": 512}) == \
        port_config(jw.mpt_config_from_hf(
            {"d_model": 64, "n_heads": 4, "n_layers": 2, "vocab_size": 512}))


def _alibi_mha_reference(orig, cfg):
    """JAX's ``mha_reference`` with a present score bias replaced by the
    ALiBi bias of the keys it is handed (the bias JAX's cache-free
    forward computes), whatever the caller sized it by."""
    def fixed(q, k, v, mask=None, causal=True, q_positions=None, kv_len=None,
              score_bias=None):
        if score_bias is not None:
            score_bias = jqwen.alibi_bias(cfg, k.shape[1])
        return orig(q, k, v, mask=mask, causal=causal,
                    q_positions=q_positions, kv_len=kv_len,
                    score_bias=score_bias)
    return fixed


def test_engine_miss_and_hit_match_jax(tmp_path, monkeypatch):
    """The greedy answers of the port's engine on a prefix miss and the
    hit that follows equal the JAX engine's with its cached bias sized by
    the keys (see the module's note)."""
    monkeypatch.setattr(jattn, "mha_reference", _alibi_mha_reference(
        jattn.mha_reference, CFG.llm))
    root = str(tmp_path)
    info = make_fake_scene(root, n_frames=2)
    jeng, teng = engines(CFG, jax_params(CFG), data_config(root),
                         prefix_cache_scenes=2)
    qs = [question(info, t, i) for i, t in enumerate(QUESTIONS)]
    want = [jeng.generate_answer(q) for q in qs]
    assert [teng.generate_answer(q) for q in qs] == want
    assert teng.prefix_cache_stats == [1, 1]


def test_paged_decode_refused_as_jax_asserts(llm, tmp_path):
    """JAX's paged decode asserts against an ALiBi bias; the port's paged
    forward and the paged batcher refuse with a ValueError."""
    cache = jqwen.KVCache.zeros(CFG.llm, 1, 8, dtype=jnp.float32)
    layer = llm["layers"][0]
    x = jnp.zeros((1, 1, 64), jnp.float32)
    pools = (cache.k[0], cache.v[0], None, None)
    with pytest.raises(AssertionError, match="ALiBi"):
        jqwen.decoder_layer(layer, x, None, None, CFG.llm,
                            paged=(pools, None, None, None, None))
    tp = from_jax_tree(llm, device="cpu")
    pcache = tpkv.PagedKVCache.zeros(TLLM, num_pages=3, page_size=8,
                                     num_slots=1, max_pages=2,
                                     dtype=torch.float32)
    with pytest.raises(ValueError, match="ALiBi"), torch.no_grad():
        tqwen.qwen2_forward(tp, TLLM, torch.zeros(1, 1, 64),
                            torch.zeros(1, 1, 3, dtype=torch.long),
                            paged_cache=pcache)
    _, teng = engines(CFG, jax_params(CFG), data_config(str(tmp_path)))
    with pytest.raises(ValueError, match="ALiBi"):
        ContinuousBatcher(teng, num_slots=2, paged=True, page_size=8)


def test_export_of_mpt_and_moe_trees_refused(llm):
    """JAX's export writes a dense gated MLP and fails on an MPT or a MoE
    tree; the port's refuses both with a ValueError."""
    moe_cfg = model_config("qwen2_moe")
    moe_llm = jax_params(moe_cfg)["llm"]
    for cfg, tree in ((CFG, llm), (moe_cfg, moe_llm)):
        with pytest.raises(KeyError):
            jw.export_llava_checkpoint({"llm": tree}, cfg.llm)
        tp = from_jax_tree({"llm": tree}, device="cpu")
        with pytest.raises(ValueError, match="dense gated MLP"):
            tw.export_llava_checkpoint(tp, port_config(cfg.llm))
