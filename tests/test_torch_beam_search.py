"""The port's beam search (``models/beam_search.py``) against the JAX
package's on the CPU, tiny float32 model, fake tokenizer, synthetic scene:

* ``generate_beam`` token ids and lengths identical to JAX's for K in
  {2, 4} over a ragged B=2 batch, both ``early_stopping`` values and
  length penalties other than 1, on the bf16 and the f32 cache (the EOS
  column of the head is scaled up, so beams finish at different steps and
  the hypotheses are ranked, not only the finalized running beams);
* the int8 cache: tokens identical to JAX's, as the int8 engine's greedy
  tokens are (``tests/test_torch_int8_engine.py``), and the reorder
  carrying every row's values and scales (int8, and int4's packed bytes);
* B3's split plan at B*K rows covers every live position of every beam
  once;
* the engine at ``num_beams`` 3: answers equal to the JAX engine's, the
  scene-prefix cache bypassed (no hit, no miss counted)."""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from video3d_tpu.config import DataConfig, ModelConfig
from video3d_tpu.data.image_processor import SigLipImageProcessor
from video3d_tpu.data.video_processor import VideoProcessor
from video3d_tpu.eval import drivers as jdrv
from video3d_tpu.models import beam_search as jbeam
from video3d_tpu.models import llava_video3d as jlv
from video3d_tpu_torch.data.image_processor import \
    SigLipImageProcessor as TSigLipImageProcessor
from video3d_tpu_torch.data.video_processor import \
    VideoProcessor as TVideoProcessor
from video3d_tpu_torch.eval import drivers as tdrv
from video3d_tpu_torch.kernels.decode_attention import decode_plan
from video3d_tpu_torch.models import beam_search as tbeam
from video3d_tpu_torch.models import qwen2 as tqwen
from video3d_tpu_torch.params import from_jax_params

from fixtures import FakeTokenizer, make_fake_scene
from port_configs import port_config

torch.set_num_threads(1)

CFG = ModelConfig.tiny()
TCFG = port_config(CFG)
NEW = 24
EOS_SCALE = 2.5      # the head's EOS column, scaled: beams end mid-run


def _question(info, text, i):
    return {"id": f"q{i}", "video": info["sample_idx"],
            "conversations": [{"from": "human", "value": f"<image>\n{text}"},
                              {"from": "gpt", "value": "brown"}],
            "metadata": {"dataset": "scanqa", "question_type": "what"}}


QUESTIONS = ("what color is the chair", "how many tables are next to the "
             "window on the left of the door")


def _engines(info, root, tok, params, **kw):
    data_cfg = DataConfig(video_folder=root,
                          annotation_dir=os.path.join(root, "embodiedscan"),
                          metadata_dir=os.path.join(root, "metadata"),
                          frames_upbound=3)
    ecfg = dict(max_new_tokens=NEW, eos_token_id=tok.eos_token_id,
                max_frames=3, buckets=(256,), stop_str="", **kw)
    jeng = jdrv.InferenceEngine(
        params, CFG, tok, VideoProcessor(data_cfg),
        SigLipImageProcessor(size=(CFG.vision.image_size,) * 2),
        jdrv.EngineConfig(**ecfg), device_geometry=True)
    teng = tdrv.InferenceEngine(
        from_jax_params(jax.tree.map(np.asarray, params), TCFG,
                        device="cpu"), TCFG, tok,
        TVideoProcessor(port_config(data_cfg)),
        TSigLipImageProcessor(size=(CFG.vision.image_size,) * 2),
        tdrv.EngineConfig(**ecfg), device="cpu")
    return jeng, teng


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("scene"))
    info = make_fake_scene(root, n_frames=3)
    tok = FakeTokenizer()
    params = jlv.init_model(jax.random.PRNGKey(0), CFG)
    head = np.asarray(params["llm"]["lm_head"]).copy()
    head[:, tok.eos_token_id] *= EOS_SCALE
    params["llm"]["lm_head"] = jnp.asarray(head)
    jeng, teng = _engines(info, root, tok, params)
    qs = [_question(info, q, i) for i, q in enumerate(QUESTIONS)]
    jbatch = jeng.prepare_answers_batch(qs)
    tbatch = teng.prepare_answers_batch(qs)
    assert len(set(tbatch.seq_len.tolist())) == 2          # ragged rows
    return info, root, tok, params, jeng, teng, jbatch, tbatch


CASES = [  # (K, early_stopping, length_penalty, cache)
    (2, False, 1.0, "bfloat16"),
    (2, True, 0.7, "bfloat16"),
    (4, False, 1.4, "bfloat16"),
    (4, True, 1.0, "float32"),
    (4, False, 0.8, "int8"),
]
DTYPES = {"bfloat16": (jnp.bfloat16, torch.bfloat16),
          "float32": (jnp.float32, torch.float32),
          "int8": (jnp.int8, torch.int8)}


@pytest.mark.parametrize("K,early,penalty,cache", CASES)
def test_generate_beam_matches_jax(setup, K, early, penalty, cache):
    _, _, tok, _, jeng, teng, jbatch, tbatch = setup
    jdt, tdt = DTYPES[cache]
    kw = dict(num_beams=K, max_new_tokens=NEW,
              eos_token_id=tok.eos_token_id, length_penalty=penalty,
              early_stopping=early)
    want = jbeam.generate_beam(jeng.params, CFG, jbatch, cache_dtype=jdt,
                               **kw)
    got = tbeam.generate_beam(teng.params, TCFG, tbatch, cache_dtype=tdt,
                              **kw)
    np.testing.assert_array_equal(got.tokens.numpy(),
                                  np.asarray(want.tokens))
    np.testing.assert_array_equal(got.lengths.numpy(),
                                  np.asarray(want.lengths))


def test_some_beams_finish_early(setup):
    """The EOS-scaled head makes hypotheses of their own: at K=4 a row's
    best answer ends before the budget, and both done tests end the rows
    before it (HF's highest-attainable-score test without
    ``early_stopping``, K hypotheses with it, no later)."""
    _, _, tok, _, _, teng, _, tbatch = setup
    runs = [tbeam.generate_beam(teng.params, TCFG, tbatch, num_beams=4,
                                max_new_tokens=NEW, early_stopping=early,
                                eos_token_id=tok.eos_token_id)
            for early in (False, True)]
    assert min(runs[0].lengths.tolist()) < NEW
    assert runs[1].steps <= runs[0].steps < NEW


@pytest.mark.parametrize("form", [torch.int8, tqwen.KV_INT4])
def test_reorder_carries_values_and_scales(form):
    """Every tensor of an int8 or int4 cache (packed bytes and f32 scales)
    follows its row: row r of the result is row idx[r] of the source."""
    llm = TCFG.llm
    cache = tqwen.KVCache.zeros(llm, 6, 5, dtype=form)
    g = torch.Generator().manual_seed(0)
    for t in cache:
        t.copy_(torch.randint(0, 100, t.shape, generator=g).to(t.dtype))
    spare = tqwen.KVCache(*(torch.empty_like(t) for t in cache))
    idx = torch.tensor([1, 1, 0, 5, 3, 3])
    out = tbeam._reorder_cache(cache, idx, spare)
    assert out is spare and out.k_scale is not None
    for src, dst in zip(cache, out):
        for r, s in enumerate(idx.tolist()):
            assert torch.equal(dst[:, r], src[:, s])
    assert tbeam.reorder_nbytes(cache) == 2 * sum(
        t.numel() * t.element_size() for t in cache)


def test_decode_plan_covers_every_beam_row():
    """B3 at B*K = 8 rows (B=2, K=4) at Qwen2-7B's 4 kv heads over an
    8704-slot cache on 132 SMs: its CTAs cover every live position of every
    row once."""
    plan = decode_plan(8, 4, 8704, 132)
    lens = [6812] * 4 + [6790] * 4
    cover = np.zeros(sum(lens), int)
    for p0, p1 in plan.ranges(lens):
        cover[p0:p1] += 1
    assert plan.batch == 8 and plan.counters == 32 and (cover == 1).all()
    rows = {b for _, b, _, _ in plan.segments(lens)}
    assert rows == set(range(8))


def test_engine_beam_answers_match_jax_and_bypass_the_prefix_cache(setup):
    info, root, tok, params, _, _, _, _ = setup
    jeng, teng = _engines(info, root, tok, params, num_beams=3,
                          length_penalty=0.9, prefix_cache_scenes=2)
    qs = [_question(info, q, i) for i, q in enumerate(QUESTIONS)]
    assert not teng._prefix_cache_on(qs[0])
    want = [jeng.generate_answer(q) for q in qs]
    got = [teng.generate_answer(q) for q in qs]
    assert got == want
    assert teng.prefix_cache_stats == [0, 0] and not teng._prefix_cache
    assert teng.generate_answers_batch_prefix(qs) == \
        jeng.generate_answers_batch_prefix(qs)
