"""Scene caches of the port's engine against the JAX engine
(``device_geometry=True``) on synthetic scenes with the fake tokenizer, tiny
model in float32, bf16 KV cache: the scene-prefix KV cache (B = 1 hits and
scene-grouped B > 1 suffix batches, ``run_generative(batch_size=B)``), the
scene-feature cache, LRU eviction and fallbacks, the stored prefix's
ownership of its memory, the ``extra_prompt`` prompt repair, and a run of
the prefix path without JAX."""

import json
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from video3d_tpu.config import DataConfig, ModelConfig
from video3d_tpu.data.image_processor import SigLipImageProcessor
from video3d_tpu.data.video_processor import VideoProcessor
from video3d_tpu.eval import drivers as jdrv
from video3d_tpu.models import generate as jgen
from video3d_tpu.models import llava_video3d as jlv
from video3d_tpu.models import qwen2 as jqwen
from video3d_tpu.models.splice import KIND_TEXT
from video3d_tpu_torch.data.image_processor import \
    SigLipImageProcessor as TSigLipImageProcessor
from video3d_tpu_torch.data.video_processor import \
    VideoProcessor as TVideoProcessor
from video3d_tpu_torch.eval import drivers as tdrv
from video3d_tpu_torch.models import generate as tgen
from video3d_tpu_torch.models import llava_video3d as tlv
from video3d_tpu_torch.models import qwen2 as tqwen
from video3d_tpu_torch.params import from_jax_params

from fixtures import FakeTokenizer, make_fake_scene
from port_configs import port_config

torch.set_num_threads(1)

CFG = ModelConfig.tiny()
TCFG = port_config(CFG)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _question(info, text="what color is the chair", i=0):
    return {
        "id": f"q{i}_0", "video": info["sample_idx"],
        "conversations": [
            {"from": "human", "value": f"<image>\n{text}"},
            {"from": "gpt", "value": "brown"}],
        "metadata": {"dataset": "scanqa", "question_type": "what"},
    }


QUESTIONS = ["what color is the chair", "how many tables are there",
             "where is the lamp"]


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("data"))
    infos = [make_fake_scene(root, scene_id=f"scene{i:04d}_00", n_frames=3,
                             extend=(i > 0)) for i in range(3)]
    data_cfg = DataConfig(video_folder=root,
                          annotation_dir=os.path.join(root, "embodiedscan"),
                          metadata_dir=os.path.join(root, "metadata"),
                          frames_upbound=3)
    params = jlv.init_model(jax.random.PRNGKey(0), CFG)
    return infos, data_cfg, params


def _ecfg(module, tok, **kw):
    return module.EngineConfig(max_new_tokens=4, eos_token_id=tok.eos_token_id,
                               max_frames=3, buckets=(256,), stop_str="",
                               suffix_buckets=(32, 64), **kw)


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


def _count_video_io(monkeypatch):
    calls = {"io": 0}
    orig = TVideoProcessor.load_raw

    def counting(*a, **k):
        calls["io"] += 1
        return orig(*a, **k)

    monkeypatch.setattr(TVideoProcessor, "load_raw", counting)
    return calls


def test_prefix_answers_match_jax_and_plain(scene, monkeypatch):
    """B = 1: miss (full prefill, prefix stored), then two hits that prefill
    only their suffix; answers equal the port's plain engine and the JAX
    engine with its prefix cache on, and video IO runs once."""
    infos = scene[0]
    qs = [_question(infos[0], t, i) for i, t in enumerate(QUESTIONS)]
    plain_engine = _torch_engine(scene)
    plain = [plain_engine.generate_answer(q) for q in qs]
    jax_engine = _jax_engine(scene, prefix_cache_scenes=4)
    want = [jax_engine.generate_answer(q) for q in qs]
    cached = _torch_engine(scene, prefix_cache_scenes=4)
    calls = _count_video_io(monkeypatch)
    got = [cached.generate_answer(q) for q in qs]
    assert got == plain == want
    assert cached.prefix_cache_stats == [2, 1]
    assert calls["io"] == 1


def test_batch_prefix_matches_sequential(scene, monkeypatch):
    """A same-scene chunk without a prefix answers its first record alone
    (storing the prefix), then suffix-batches the rest; a second chunk is
    one pure B = 3 suffix batch."""
    infos = scene[0]
    qs = [_question(infos[0], t, i) for i, t in enumerate(QUESTIONS)]
    plain = _torch_engine(scene)
    want = [plain.generate_answer(q) for q in qs]
    cached = _torch_engine(scene, prefix_cache_scenes=4)
    calls = _count_video_io(monkeypatch)
    assert cached.generate_answers_batch_prefix(qs) == want
    assert calls["io"] == 1
    assert cached.prefix_cache_stats == [2, 1]
    assert cached.generate_answers_batch_prefix(qs) == want
    assert calls["io"] == 1
    assert cached.prefix_cache_stats == [5, 1]


@pytest.mark.parametrize("batch_size", [1, 2])
def test_run_generative_prefix_matches_jax(scene, tmp_path, batch_size):
    """2 scenes x 2 questions, prefix cache on: the port's jsonl equals the
    JAX engine's, record for record. batch_size=2 groups each scene into
    one chunk (a miss, then a suffix batch); at batch_size=1 the next
    question is prepared while the scene's miss runs, so its prep is
    upgraded to a hit when it starts (``_refresh_prep``)."""
    infos = scene[0]
    qs = []
    for si in (1, 0):
        for i in range(2):
            q = _question(infos[si], f"question {i} about it", i)
            q["id"] = f"s{si}_q{i}_0"
            qs.append(q)
    jdrv.run_generative(_jax_engine(scene, prefix_cache_scenes=4), qs,
                        str(tmp_path / "jax.jsonl"), batch_size=batch_size)
    eng = _torch_engine(scene, prefix_cache_scenes=4)
    times = tdrv.run_generative(eng, qs, str(tmp_path / "torch.jsonl"),
                                batch_size=batch_size)
    assert len(times) == 4
    assert eng.prefix_cache_stats == [2, 2]

    def read(name):
        with open(tmp_path / name) as f:
            return [json.loads(line) for line in f]

    assert read("torch.jsonl") == read("jax.jsonl")


@pytest.mark.parametrize("B", [1, 3])
def test_start_decode_prefix_matches_jax(scene, B):
    """Suffix prefill against a stored (layers, 1, P, KV*hd) prefix: next
    logits and cache contents against JAX ``start_decode_prefix``, then the
    greedy tokens of ``generate_from_state``."""
    params = scene[2]
    tp = from_jax_params(jax.tree.map(np.asarray, params), TCFG, device="cpu")
    lcfg = CFG.llm
    rng = np.random.default_rng(B)
    P, Ls, new = 12, 8, 4
    shape = (lcfg.num_hidden_layers, 1, P,
             lcfg.num_key_value_heads * lcfg.head_dim)
    pk = rng.normal(size=shape).astype(np.float32)
    pv = rng.normal(size=shape).astype(np.float32)
    ids = rng.integers(310, lcfg.vocab_size, (B, Ls))
    seq_len = P + np.asarray([Ls, 5, 3][:B], np.int32)
    pos = np.broadcast_to(P + np.arange(Ls), (B, Ls)).copy()
    kind = np.full((B, Ls), KIND_TEXT, np.int32)
    jbatch = jlv.Batch(
        images=None, patch_coords=None, text_ids=jnp.asarray(ids),
        kind=jnp.asarray(kind), vision_index=jnp.zeros((B, Ls), jnp.int32),
        labels=jnp.full((B, Ls), -100, jnp.int32),
        position_ids=jnp.asarray(pos),
        mrope_position_ids=jnp.asarray(np.broadcast_to(
            pos[..., None], (B, Ls, 3)).copy()),
        seq_len=jnp.asarray(seq_len))
    tbatch = tlv.Batch(
        images=None, patch_coords=None, text_ids=torch.from_numpy(ids),
        kind=torch.from_numpy(kind).long(),
        vision_index=torch.zeros((B, Ls), dtype=torch.long),
        position_ids=torch.from_numpy(pos),
        seq_len=torch.from_numpy(seq_len).long())
    mcl = P + Ls + new
    jstate = jgen.start_decode_prefix(
        params, CFG, jbatch, jqwen.KVCache(jnp.asarray(pk), jnp.asarray(pv)),
        prefix_len=P, max_cache_len=mcl, cache_dtype=jnp.float32)
    tstate = tgen.start_decode_prefix(
        tp, TCFG, tbatch, tqwen.KVCache(torch.from_numpy(pk),
                                       torch.from_numpy(pv)), P, mcl)
    np.testing.assert_allclose(tstate.next_logits.numpy(),
                               np.asarray(jstate.next_logits), rtol=0,
                               atol=1e-4)
    np.testing.assert_allclose(tstate.cache.k.numpy(),
                               np.asarray(jstate.cache.k), rtol=0, atol=1e-4)
    np.testing.assert_allclose(tstate.cache.v.numpy(),
                               np.asarray(jstate.cache.v), rtol=0, atol=1e-4)
    jres = jgen.generate_from_state(params, CFG, jstate, max_new_tokens=new,
                                    eos_token_id=101)
    tres = tgen.generate_from_state(tp, TCFG, tstate, max_new_tokens=new,
                                    eos_token_id=101)
    np.testing.assert_array_equal(tres.tokens.numpy(),
                                  np.asarray(jres.tokens))
    np.testing.assert_array_equal(tres.lengths.numpy(),
                                  np.asarray(jres.lengths))


def test_lru_eviction(scene):
    infos = scene[0]
    eng = _torch_engine(scene, prefix_cache_scenes=2)
    for info in infos:                       # 3 distinct scenes -> evict 1st
        eng.generate_answer(_question(info))
    assert list(eng._prefix_cache) == [infos[1]["sample_idx"],
                                       infos[2]["sample_idx"]]
    eng.generate_answer(_question(infos[0]))
    assert eng.prefix_cache_stats == [0, 4]
    eng.generate_answer(_question(infos[0]))
    assert eng.prefix_cache_stats == [1, 4]


def test_prompt_prefix_mismatch_falls_back(scene):
    """A question whose pre-image ids differ from the stored prefix's must
    not reuse it: it runs a full prefill (a second miss)."""
    infos = scene[0]
    q = _question(infos[0], i=1)
    q["conversations"][0]["value"] = "look carefully\n<image>\nwhere"
    eng, plain = (_torch_engine(scene, prefix_cache_scenes=2),
                  _torch_engine(scene))
    assert [eng.generate_answer(r) for r in (_question(infos[0]), q)] == \
        [plain.generate_answer(r) for r in (_question(infos[0]), q)]
    assert eng.prefix_cache_stats == [0, 2]


def test_oversized_suffix_falls_back(scene):
    infos = scene[0]
    q = _question(infos[0], text="why " * 80, i=1)   # > largest bucket
    eng, plain = (_torch_engine(scene, prefix_cache_scenes=2),
                  _torch_engine(scene))
    assert [eng.generate_answer(r) for r in (_question(infos[0]), q)] == \
        [plain.generate_answer(r) for r in (_question(infos[0]), q)]
    assert eng.prefix_cache_stats == [0, 2]


def test_scene_feature_cache(scene, monkeypatch):
    """scene_cache_scenes: answers identical, video IO and the tower run
    once for three questions on one scene."""
    infos = scene[0]
    qs = [_question(infos[0], t, i) for i, t in enumerate(QUESTIONS)]
    plain = _torch_engine(scene)
    want = [plain.generate_answer(q) for q in qs]
    eng = _torch_engine(scene, scene_cache_scenes=1)
    calls = _count_video_io(monkeypatch)
    tower = {"n": 0}
    orig = tlv.encode_video_pooled

    def counting(*a, **k):
        tower["n"] += 1
        return orig(*a, **k)

    monkeypatch.setattr(tlv, "encode_video_pooled", counting)
    assert [eng.generate_answer(q) for q in qs] == want
    assert tower["n"] == 1 and calls["io"] == 1
    assert eng.scene_cache_stats == [2, 1]


def test_stored_prefix_owns_its_memory(scene):
    """_store_prefix clones: the entry holds exactly its P slots, not a view
    that keeps (and shares) the whole request cache."""
    infos = scene[0]
    eng = _torch_engine(scene, prefix_cache_scenes=1)
    eng.generate_answer(_question(infos[0]))
    entry = eng._prefix_cache[infos[0]["sample_idx"]]
    for x in (entry.cache.k, entry.cache.v):
        assert x.shape[1:3] == (1, entry.prefix_len)
        assert x.untyped_storage().nbytes() == x.numel() * x.element_size()


def test_decode_after_hits_leaves_prefix_unchanged(scene):
    """_write_prefix copies into a fresh cache: decoding after a B = 1 hit
    and a B = 2 suffix batch never writes into the stored entry."""
    infos = scene[0]
    eng = _torch_engine(scene, prefix_cache_scenes=1)
    qs = [_question(infos[0], t, i) for i, t in enumerate(QUESTIONS)]
    eng.generate_answer(qs[0])
    entry = eng._prefix_cache[infos[0]["sample_idx"]]
    k0, v0 = entry.cache.k.clone(), entry.cache.v.clone()
    prep = eng.prepare_request(qs[1])
    assert prep["mode"] == "prefix"
    state = eng.start_request(prep)
    assert state.cache.k.untyped_storage().data_ptr() != \
        entry.cache.k.untyped_storage().data_ptr()
    eng._generate_from_state(state)
    eng.generate_answers_batch_prefix(qs[1:])
    assert eng.prefix_cache_stats == [3, 1]
    assert torch.equal(entry.cache.k, k0) and torch.equal(entry.cache.v, v0)


def test_extra_prompt_prompt_ids_match_jax(scene):
    """EngineConfig.extra_prompt is prepended to the question text, as the
    JAX engine does, so both build the same prompt ids."""
    infos = scene[0]
    extra = ("The video captures 3D spatial information of a scene. "
             "Please focus on the spatial relationships in the video "
             "and answer the following questions.")
    q = _question(infos[0])
    jax_engine = _jax_engine(scene, extra_prompt=extra)
    torch_engine = _torch_engine(scene, extra_prompt=extra)
    ids = torch_engine._tokenize_prompt(q)
    assert ids == jax_engine._tokenize_prompt(q)
    assert ids != _torch_engine(scene)._tokenize_prompt(q)
    assert torch_engine.generate_answer(q) == jax_engine.generate_answer(q)


def test_generate_answers_batch_matches_jax(scene):
    """The plain batched path (the fallback of the suffix batch) across two
    scenes against the JAX engine's."""
    infos = scene[0]
    qs = [_question(infos[0], QUESTIONS[0], 0),
          _question(infos[1], "where is the door", 1)]
    want = _jax_engine(scene).generate_answers_batch(qs)
    assert _torch_engine(scene).generate_answers_batch(qs) == want


def test_prefix_path_runs_without_jax(tmp_path):
    """Import the port and drive a miss, a B = 1 hit and a B = 2 suffix
    batch with a tiny random model, checking that no JAX module was ever
    imported."""
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
                            torch.float32)
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
                                    suffix_buckets=(32,)),
            device="cpu")
        qs = [{{"video": info["sample_idx"],
                "conversations": [{{"from": "human", "value": text}},
                                  {{"from": "gpt", "value": "a chair"}}]}}
              for text in ("what is it", "where is it", "how big", "why")]
        answers = [engine.generate_answer(q) for q in qs[:2]]
        answers += engine.generate_answers_batch_prefix(qs[2:])
        assert all(isinstance(a, str) for a in answers), answers
        assert engine.prefix_cache_stats == [3, 1], engine.prefix_cache_stats
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
