"""The port's engine in the int8 serving configuration against the JAX
engine (``device_geometry=True``): a tiny float32 model whose LLM
projections and lm_head are ``quantize_tree``'d to int8 dicts, with
``kv_cache_dtype="int8"`` and, on the same weights, ``"int4"`` (JAX's
``jnp.int4`` cache against the port's packed uint8 one), on synthetic
scenes with the fake tokenizer. Token ids (answers) must be identical at
B=1 without caches, on B=1 prefix hits, on scene-grouped suffix batches
and through ``run_generative``."""

import json
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

import jax

from video3d_tpu.config import DataConfig, ModelConfig
from video3d_tpu.data.image_processor import SigLipImageProcessor
from video3d_tpu.data.video_processor import VideoProcessor
from video3d_tpu.eval import drivers as jdrv
from video3d_tpu.models import llava_video3d as jlv
from video3d_tpu.models import quant as jquant
from video3d_tpu_torch.data.image_processor import \
    SigLipImageProcessor as TSigLipImageProcessor
from video3d_tpu_torch.data.video_processor import \
    VideoProcessor as TVideoProcessor
from video3d_tpu_torch.eval import drivers as tdrv
from video3d_tpu_torch.models import qwen2 as tqwen
from video3d_tpu_torch.params import from_jax_params

from fixtures import FakeTokenizer, make_fake_scene
from port_configs import port_config

torch.set_num_threads(1)

CFG = ModelConfig.tiny()
TCFG = port_config(CFG)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
QUESTIONS = ["what color is the chair", "how many tables are there",
             "where is the lamp"]
#: the quantized KV caches the engine tests run, and the port's storage
KV_DTYPES = {"int8": torch.int8, "int4": torch.uint8}


def _question(info, text, i):
    return {
        "id": f"q{i}_0", "video": info["sample_idx"],
        "conversations": [
            {"from": "human", "value": f"<image>\n{text}"},
            {"from": "gpt", "value": "brown"}],
        "metadata": {"dataset": "scanqa", "question_type": "what"},
    }


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("data"))
    infos = [make_fake_scene(root, scene_id=f"scene{i:04d}_00", n_frames=3,
                             extend=(i > 0)) for i in range(2)]
    data_cfg = DataConfig(video_folder=root,
                          annotation_dir=os.path.join(root, "embodiedscan"),
                          metadata_dir=os.path.join(root, "metadata"),
                          frames_upbound=3)
    params = jquant.quantize_tree(jlv.init_model(jax.random.PRNGKey(0), CFG))
    return infos, data_cfg, params


def _ecfg(module, tok, **kw):
    return module.EngineConfig(max_new_tokens=4, eos_token_id=tok.eos_token_id,
                               max_frames=3, buckets=(256,), stop_str="",
                               suffix_buckets=(32, 64),
                               **{"kv_cache_dtype": "int8", **kw})


def _torch_engine(scene, **kw):
    _, data_cfg, params = scene
    tok = FakeTokenizer()
    return tdrv.InferenceEngine(
        from_jax_params(jax.tree.map(np.asarray, params), TCFG,
                        device="cpu"), TCFG, tok,
        TVideoProcessor(port_config(data_cfg)),
        TSigLipImageProcessor(size=(CFG.vision.image_size,) * 2),
        _ecfg(tdrv, tok, **kw), device="cpu")


def _jax_engine(scene, **kw):
    _, data_cfg, params = scene
    tok = FakeTokenizer()
    return jdrv.InferenceEngine(
        params, CFG, tok, VideoProcessor(data_cfg),
        SigLipImageProcessor(size=(CFG.vision.image_size,) * 2),
        _ecfg(jdrv, tok, **kw), device_geometry=True)


@pytest.mark.parametrize("kv", list(KV_DTYPES))
def test_int8_answers_match_jax_without_caches(scene, kv):
    infos = scene[0]
    qs = [_question(infos[0], t, i) for i, t in enumerate(QUESTIONS)]
    eng = _torch_engine(scene, kv_cache_dtype=kv)
    assert eng.params["llm"]["lm_head"]["q"].dtype == torch.int8
    jeng = _jax_engine(scene, kv_cache_dtype=kv)
    want = [jeng.generate_answer(q) for q in qs]
    assert [eng.generate_answer(q) for q in qs] == want


@pytest.mark.parametrize("kv", list(KV_DTYPES))
def test_int8_prefix_hits_match_jax(scene, kv):
    """B=1: a miss stores the quantized prefix with its scales, two hits
    prefill only their suffix through the cache (the folded kernel's int8
    or int4 form)."""
    infos = scene[0]
    qs = [_question(infos[0], t, i) for i, t in enumerate(QUESTIONS)]
    jeng = _jax_engine(scene, prefix_cache_scenes=2, kv_cache_dtype=kv)
    want = [jeng.generate_answer(q) for q in qs]
    eng = _torch_engine(scene, prefix_cache_scenes=2, kv_cache_dtype=kv)
    assert [eng.generate_answer(q) for q in qs] == want
    assert eng.prefix_cache_stats == jeng.prefix_cache_stats == [2, 1]
    entry = eng._prefix_cache[infos[0]["sample_idx"]]
    P = entry.prefix_len
    assert entry.cache.k.dtype == KV_DTYPES[kv]
    assert tuple(entry.cache.k_scale.shape) == (
        CFG.llm.num_hidden_layers, 1, P, CFG.llm.num_key_value_heads, 1)


@pytest.mark.parametrize("kv", list(KV_DTYPES))
def test_int8_batch_prefix_matches_jax(scene, kv):
    """A same-scene chunk without a prefix: one miss, then a B=2 suffix
    batch over the shared quantized prefix (B5's int8 or int4 form, raw
    suffix K/V); then a pure B=3 suffix batch."""
    infos = scene[0]
    qs = [_question(infos[0], t, i) for i, t in enumerate(QUESTIONS)]
    jeng = _jax_engine(scene, prefix_cache_scenes=2, kv_cache_dtype=kv)
    eng = _torch_engine(scene, prefix_cache_scenes=2, kv_cache_dtype=kv)
    for _ in range(2):
        assert eng.generate_answers_batch_prefix(qs) == \
            jeng.generate_answers_batch_prefix(qs)
    assert eng.prefix_cache_stats == jeng.prefix_cache_stats == [5, 1]


@pytest.mark.parametrize("kv", list(KV_DTYPES))
@pytest.mark.parametrize("batch_size", [1, 2])
def test_int8_run_generative_matches_jax(scene, tmp_path, batch_size, kv):
    """2 scenes x 2 questions with both scene caches on: the jsonl equals
    the JAX engine's record for record."""
    infos = scene[0]
    qs = []
    for si in (1, 0):
        for i in range(2):
            q = _question(infos[si], f"question {i} about it", i)
            q["id"] = f"s{si}_q{i}_0"
            qs.append(q)
    kw = dict(prefix_cache_scenes=4, scene_cache_scenes=2, kv_cache_dtype=kv)
    jeng = _jax_engine(scene, **kw)
    jdrv.run_generative(jeng, qs, str(tmp_path / "jax.jsonl"),
                        batch_size=batch_size)
    eng = _torch_engine(scene, **kw)
    tdrv.run_generative(eng, qs, str(tmp_path / "torch.jsonl"),
                        batch_size=batch_size)
    assert eng.prefix_cache_stats == jeng.prefix_cache_stats == [2, 2]

    def read(name):
        with open(tmp_path / name) as f:
            return [json.loads(line) for line in f]

    assert read("torch.jsonl") == read("jax.jsonl")


def test_kv_cache_dtype_choices(scene):
    assert tdrv.EngineConfig().cache_dtype() == torch.bfloat16
    assert tdrv.EngineConfig(kv_cache_dtype="int8").cache_dtype() == \
        torch.int8
    assert tdrv.EngineConfig(kv_cache_dtype="int4").cache_dtype() == \
        tqwen.KV_INT4
    assert _torch_engine(scene, kv_cache_dtype="int4").cache_dtype == \
        tqwen.KV_INT4
    with pytest.raises(ValueError, match="kv_cache_dtype"):
        tdrv.EngineConfig(kv_cache_dtype="fp8").cache_dtype()


def test_int8_paths_run_without_jax(tmp_path):
    """Import the port and drive the int8 configuration (init_model(bits=8),
    int8 KV cache) through a miss, a B=1 hit and a B=2 suffix batch,
    checking that no JAX module was ever imported."""
    script = textwrap.dedent(f"""
        import os, sys
        sys.path[:0] = [{REPO!r}, {os.path.join(REPO, "tests")!r}]
        import torch
        torch.set_num_threads(1)
        from video3d_tpu_torch.config import DataConfig, ModelConfig
        from video3d_tpu_torch.eval.drivers import (EngineConfig,
                                                    InferenceEngine,
                                                    VideoProcessor)
        from video3d_tpu_torch.params import init_model
        from fixtures import FakeTokenizer, make_fake_scene

        root = {str(tmp_path)!r}
        info = make_fake_scene(root, n_frames=2)
        cfg = ModelConfig.tiny()
        tok = FakeTokenizer()
        params = init_model(cfg, "cpu", torch.Generator().manual_seed(0),
                            torch.float32, bits=8)
        assert params["llm"]["layers"][0]["mlp"]["w_up"]["q"].dtype == \\
            torch.int8
        engine = InferenceEngine(
            params, cfg, tok,
            VideoProcessor(DataConfig(
                video_folder=root,
                annotation_dir=os.path.join(root, "embodiedscan"),
                metadata_dir=os.path.join(root, "metadata"),
                frames_upbound=2)),
            engine_cfg=EngineConfig(max_new_tokens=3,
                                    eos_token_id=tok.eos_token_id,
                                    max_frames=2, buckets=(256,),
                                    prefix_cache_scenes=1,
                                    suffix_buckets=(32,),
                                    kv_cache_dtype="int8"),
            device="cpu")
        qs = [{{"video": info["sample_idx"],
                "conversations": [{{"from": "human", "value": text}},
                                  {{"from": "gpt", "value": "a chair"}}]}}
              for text in ("what is it", "where is it", "how big", "why")]
        answers = [engine.generate_answer(q) for q in qs[:2]]
        answers += engine.generate_answers_batch_prefix(qs[2:])
        assert all(isinstance(a, str) for a in answers), answers
        assert engine.prefix_cache_stats == [3, 1], engine.prefix_cache_stats
        entry = next(iter(engine._prefix_cache.values()))
        assert entry.cache.k.dtype == torch.int8
        bad = sorted(m for m in sys.modules
                     if m.split(".")[0] in ("jax", "video3d_tpu"))
        assert not bad, bad
        print("OK")
    """)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    res = subprocess.run([sys.executable, "-c", script], capture_output=True,
                         text=True, timeout=300, env=env)
    assert res.returncode == 0, res.stderr[-3000:]
    assert res.stdout.strip().endswith("OK")
