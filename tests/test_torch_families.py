"""The decoder families of the JAX builder (LLaMA, Mistral, Gemma, Mixtral,
Qwen2-MoE) in the port against the JAX package, on the CPU in float32 at
test widths: the logits of the stack, the engine's greedy answers on a
prefix miss and on the hit that follows, ``llm_config_from_hf`` on every
``model_type``, and the refusal of a decoder whose attention width is not
its hidden size (Gemma-7B's), where JAX's reshape fails."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from video3d_tpu.config import LLMConfig
from video3d_tpu.models import builder as jb
from video3d_tpu.models import qwen2 as jqwen
from video3d_tpu_torch.config import ModelConfig as TModelConfig
from video3d_tpu_torch.models import builder as tb
from video3d_tpu_torch.models import qwen2 as tqwen
from video3d_tpu_torch.params import check_config, from_jax_tree

from family_configs import (FAMILIES, QUESTIONS, data_config, engines,
                            jax_params, model_config, question,
                            write_family_checkpoint)
from fixtures import FakeTokenizer, make_fake_scene
from port_configs import port_config

ATOL = 1e-4     # f32, different matmul blockings and reduction orders
ROPE_FAMILIES = ("llama", "mistral", "gemma", "mixtral", "qwen2_moe")


def _positions(B, L):
    return np.broadcast_to(np.arange(L)[None, :, None], (B, L, 3)).copy()


@pytest.mark.parametrize("family", ROPE_FAMILIES)
def test_logits_match_jax(family):
    cfg = model_config(family)
    llm = jax_params(cfg)["llm"]
    rng = np.random.default_rng(1)
    ids = rng.integers(0, cfg.llm.vocab_size, size=(2, 11))
    kv_len = np.array([11, 7])
    pos = _positions(2, 11)
    jh, _ = jqwen.qwen2_forward(llm, cfg.llm,
                                jqwen.embed_tokens(llm, jnp.asarray(ids)),
                                jnp.asarray(pos), kv_len=jnp.asarray(kv_len))
    want = np.asarray(jqwen.lm_head(llm, jh))
    tp = from_jax_tree(llm, device="cpu")
    tcfg = port_config(cfg.llm)
    with torch.no_grad():
        th = tqwen.qwen2_forward(tp, tcfg, tqwen.embed_tokens(
            tp, torch.from_numpy(ids)), torch.from_numpy(pos),
            kv_len=torch.from_numpy(kv_len))
        got = tqwen.lm_head(tp, th).numpy()
    for b, n in enumerate(kv_len):
        np.testing.assert_allclose(got[b, :n], want[b, :n], rtol=0,
                                   atol=ATOL)


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("data"))
    return make_fake_scene(root, n_frames=2), data_config(root)


@pytest.mark.parametrize("family", ROPE_FAMILIES)
def test_engine_miss_and_hit_match_jax(scene, family):
    """A prefix miss (full prefill, the scene prefix stored), then a hit
    (the suffix prefilled over the stored prefix): the greedy answers of
    the port's engine equal the JAX engine's."""
    info, data_cfg = scene
    cfg = model_config(family)
    jeng, teng = engines(cfg, jax_params(cfg), data_cfg,
                         prefix_cache_scenes=2)
    qs = [question(info, t, i) for i, t in enumerate(QUESTIONS)]
    want = [jeng.generate_answer(q) for q in qs]
    got = [teng.generate_answer(q) for q in qs]
    assert got == want
    assert teng.prefix_cache_stats == [1, 1]


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_llm_config_from_hf_matches_jax(family):
    hf = FAMILIES[family]
    assert tb.llm_config_from_hf(hf) == port_config(jb.llm_config_from_hf(hf))


def test_gemma7b_width_fails_in_jax_and_is_refused():
    """Gemma-7B: 16 heads of 256 = 4096 against a hidden size of 3072.
    JAX's reshape of the attention output fails; the port refuses the
    configuration with a ValueError before any work, in check_config and
    in the decoder itself."""
    llm = LLMConfig(vocab_size=64, hidden_size=48, intermediate_size=64,
                    num_hidden_layers=1, num_attention_heads=4,
                    num_key_value_heads=1, head_dim=16,
                    attention_bias=False, hidden_act="gelu_tanh",
                    rms_norm_add_unit_offset=True, embed_scale=True,
                    tie_word_embeddings=True, mrope_section=(4, 2, 2))
    params = jqwen.init_qwen2(jax.random.PRNGKey(0), llm)
    emb = jnp.zeros((1, 3, 48), jnp.float32)
    with pytest.raises(TypeError):
        jqwen.qwen2_forward(params, llm, emb, jnp.zeros((1, 3, 3), jnp.int32))
    tllm = port_config(llm)
    with pytest.raises(ValueError, match="hidden size"):
        check_config(dataclasses.replace(TModelConfig.tiny(), llm=tllm))
    tp = from_jax_tree(jax.tree.map(np.asarray, params), device="cpu")
    with pytest.raises(ValueError, match="hidden size"), torch.no_grad():
        tqwen.qwen2_forward(tp, tllm, torch.zeros(1, 3, 48),
                            torch.zeros(1, 3, 3, dtype=torch.long))
    gemma7b = {"model_type": "gemma", "vocab_size": 256000,
               "hidden_size": 3072, "intermediate_size": 24576,
               "num_hidden_layers": 28, "num_attention_heads": 16,
               "num_key_value_heads": 16, "head_dim": 256}
    with pytest.raises(ValueError, match="hidden size"):
        check_config(tb.model_config_from_hf(gemma7b))


def _leaves_equal(t, j, path=""):
    if isinstance(j, dict):
        assert set(t) == set(j), path
        for k in j:
            _leaves_equal(t[k], j[k], f"{path}/{k}")
    elif isinstance(j, (list, tuple)):
        assert len(t) == len(j), path
        for i, (a, b) in enumerate(zip(t, j)):
            _leaves_equal(a, b, f"{path}/{i}")
    else:
        np.testing.assert_array_equal(t.numpy(), np.asarray(j, np.float32),
                                      err_msg=path)


@pytest.mark.parametrize("family", ["qwen2_moe", "gemma", "gemma_hd256",
                                    "mpt"])
def test_load_format_auto_loads_the_family(tmp_path, scene, family):
    """The worker's ``--load-format auto`` on a checkpoint written with the
    port's safetensors writer: the loaded tree equals JAX's load of the
    same directory leaf for leaf, and the engine answers."""
    from video3d_tpu_torch.serve import model_worker as tmw

    info, dc = scene
    ckpt = str(tmp_path / family)
    write_family_checkpoint(ckpt, family)
    args = tmw.build_parser().parse_args(
        ["--model-path", ckpt, "--device", "cpu", "--max-frame-num", "2",
         "--max-new-tokens", "3", "--video-folder", dc.video_folder,
         "--embodiedscan-folder", dc.annotation_dir,
         "--metadata-folder", dc.metadata_dir])
    engine, _ = tmw.build_worker_engines(args, FakeTokenizer())
    _, jparams, jcfg, _ = jb.load_pretrained_model(
        ckpt, dtype=jnp.float32, load_tokenizer=False)
    assert engine.cfg == port_config(jcfg)
    for key in jparams:
        _leaves_equal(engine.params[key], jparams[key], key)
    assert isinstance(engine.generate_answer(question(info, QUESTIONS[0])),
                      str)


def test_rotary_families_call_attention_without_a_bias(monkeypatch):
    """Only an ALiBi decoder hands its attention a ``score_bias``: a
    rotary family calls ``mha_train`` / ``mha`` as (q, k, v, kv_len), so
    an attention swapped in with that signature (chip_smoke's
    plain-attention checks) still runs."""
    cfg = model_config("llama")
    tp = from_jax_tree(jax_params(cfg)["llm"], device="cpu")
    calls = []

    def plain(q, k, v, kv_len):
        calls.append(q.shape)
        return q

    monkeypatch.setattr(tqwen, "mha_train", plain)
    monkeypatch.setattr(tqwen, "mha", plain)
    emb = torch.zeros(1, 5, cfg.llm.hidden_size)
    tqwen.qwen2_forward(tp, port_config(cfg.llm), emb,
                        torch.zeros(1, 5, 3, dtype=torch.long),
                        kv_len=torch.tensor([5]))
    assert len(calls) == cfg.llm.num_hidden_layers
