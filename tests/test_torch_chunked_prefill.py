"""Sarathi-style chunked prefill in the port (``generate.ChunkedPrefill``
and the continuous batcher's ``chunked_prefill``), on the CPU:

* ``ChunkedPrefill`` at chunk lengths 16 / 24 / 64 / 128 (dividing the
  prompt or not, one chunk or many) against JAX's ``ChunkedPrefill`` and
  the port's ``start_decode``: next logits within 2e-2 (JAX's test's
  bound; the chunks attend the cache, the full prefill its raw K/V), the
  same argmax and the same 8 greedy ids after it; the same over an int8
  cache;
* the chunked batcher, dense and paged, answers as the sequential engine;
* with the prefix cache on, the cold admission chunks and stores the
  scene prefix; later hits stay atomic and share its pages;
* decode chunks run while a cold admission's job runs;
* a queued job can be cancelled."""

import os
import time
from dataclasses import replace

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from video3d_tpu.config import DataConfig, ModelConfig
from video3d_tpu.constants import IMAGE_TOKEN_INDEX
from video3d_tpu.models import generate as jgen
from video3d_tpu.models import llava_video3d as jlv
from video3d_tpu_torch.data.image_processor import \
    SigLipImageProcessor as TSigLipImageProcessor
from video3d_tpu_torch.data.video_processor import \
    VideoProcessor as TVideoProcessor
from video3d_tpu_torch.eval import drivers as tdrv
from video3d_tpu_torch.models import generate as tgen
from video3d_tpu_torch.params import from_jax_params
from video3d_tpu_torch.serve.batcher import ContinuousBatcher

from fixtures import FakeTokenizer, make_fake_scene
from port_configs import port_config
from test_torch_speculative import _batches

torch.set_num_threads(1)

CFG = ModelConfig.tiny()
TCFG = port_config(CFG)
MCL = 96
ATOL = 2e-2


@pytest.fixture(scope="module")
def setup():
    params = jlv.init_model(jax.random.PRNGKey(0), CFG)
    tparams = from_jax_params(jax.tree.map(np.asarray, params), TCFG,
                              device="cpu")
    jb, tb = _batches([[3, 4, IMAGE_TOKEN_INDEX, 5, 6, 8, 9, 10, 11]], 64)
    return params, tparams, jb, tb


def _run(cp) -> tgen.DecodeState:
    steps = 0
    while not cp.step():
        steps += 1
        assert steps <= cp.total_steps
    assert cp.done
    return cp.result()


def _greedy(tparams, state):
    _, toks = tgen.decode_chunk(tparams, TCFG, state, chunk=8,
                                eos_token_id=-1, capture=False)
    return toks.tolist()


@pytest.mark.parametrize("chunk_len", [16, 24, 64, 128])
def test_matches_jax_and_start_decode(setup, chunk_len):
    params, tparams, jb, tb = setup
    want = tgen.start_decode(tparams, TCFG, tb, MCL,
                             cache_dtype=torch.float32)
    cp = tgen.ChunkedPrefill(tparams, TCFG, tb, MCL, chunk_len=chunk_len,
                             cache_dtype=torch.float32)
    assert cp.total_steps == 1 + -(-int(tb.seq_len.max()) // chunk_len)
    got = _run(cp)
    jcp = jgen.ChunkedPrefill(params, CFG, jb, max_cache_len=MCL,
                              chunk_len=chunk_len, cache_dtype=jnp.float32)
    while not jcp.step():
        pass
    jgot = np.asarray(jcp.result().next_logits)
    np.testing.assert_allclose(got.next_logits.numpy(), jgot, rtol=0,
                               atol=ATOL)
    np.testing.assert_allclose(got.next_logits.numpy(),
                               want.next_logits.numpy(), rtol=0, atol=ATOL)
    assert int(got.next_logits.argmax()) == int(want.next_logits.argmax())
    assert torch.equal(got.pos, want.pos) and not got.done.any()
    assert _greedy(tparams, got) == _greedy(tparams, want)


def test_int8_cache(setup):
    """Over an int8 cache each chunk attends the quantized cache (the full
    prefill attends raw K/V): the same 8 greedy ids, next logits within
    2e-2."""
    _, tparams, _, tb = setup
    want = tgen.start_decode(tparams, TCFG, tb, MCL, cache_dtype=torch.int8)
    got = _run(tgen.ChunkedPrefill(tparams, TCFG, tb, MCL, chunk_len=16,
                                   cache_dtype=torch.int8))
    np.testing.assert_allclose(got.next_logits.numpy(),
                               want.next_logits.numpy(), rtol=0, atol=ATOL)
    assert got.cache.k.dtype == torch.int8
    assert _greedy(tparams, got) == _greedy(tparams, want)


# ---------------------------------------------------------------------------
# the batcher's chunked admissions
# ---------------------------------------------------------------------------

QS = ("what color is the chair", "how many tables are there",
      "where is the lamp")


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("data"))
    infos = [make_fake_scene(root, scene_id=f"scene{i:04d}_00", n_frames=3,
                             extend=(i > 0)) for i in range(2)]
    data_cfg = DataConfig(video_folder=root,
                          annotation_dir=os.path.join(root, "embodiedscan"),
                          metadata_dir=os.path.join(root, "metadata"),
                          frames_upbound=3)
    params = jlv.init_model(jax.random.PRNGKey(0), CFG)
    return infos, data_cfg, from_jax_params(jax.tree.map(np.asarray, params),
                                            TCFG, device="cpu")


def _engine(scene, prefix_scenes=0, **kw):
    _, data_cfg, tparams = scene
    tok = FakeTokenizer()
    return tdrv.InferenceEngine(
        tparams, TCFG, tok, TVideoProcessor(port_config(data_cfg)),
        TSigLipImageProcessor(size=(CFG.vision.image_size,) * 2),
        tdrv.EngineConfig(max_new_tokens=4, eos_token_id=tok.eos_token_id,
                          max_frames=3, buckets=(256,), stop_str="",
                          suffix_buckets=(32, 64),
                          prefix_cache_scenes=prefix_scenes, **kw),
        device="cpu")


def _record(info, question, i=0):
    return {"id": f"q{i}", "video": info["sample_idx"],
            "conversations": [{"from": "human",
                               "value": f"<image>\n{question}"},
                              {"from": "gpt", "value": None}]}


@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
def test_batcher_matches_sequential(scene, paged):
    """Cold admissions through the job pipeline (the prefix cache off):
    the sequential engine's answers; the pipeline drains."""
    infos = scene[0]
    eng = _engine(scene)
    records = [_record(infos[0], q, i) for i, q in enumerate(QS)]
    want = [eng.generate_answer(r) for r in records]
    b = ContinuousBatcher(eng, num_slots=2, chunk=2, paged=paged,
                          page_size=8, chunked_prefill=64)
    try:
        assert b.chunk_prefill == 64
        handles = [b.submit(r) for r in records]
        assert [h.result(eng._decode_text, timeout=600)
                for h in handles] == want
        assert b._job is None and not b._chunkq
    finally:
        b.shutdown()


def test_prefix_hits_stay_atomic_and_harvest(scene):
    """With the prefix cache on, the first (cold) admission chunks and
    stores the scene prefix (``finish_chunked``); later same-scene
    admissions take the atomic prefix path and share its pages."""
    infos = scene[0]
    plain = _engine(scene)
    records = [_record(infos[0], q, i) for i, q in enumerate(QS)]
    want = [plain.generate_answer(r) for r in records]
    eng = _engine(scene, 4)
    for r in records:
        eng._tokenize_prompt(r)
    b = ContinuousBatcher(eng, num_slots=2, chunk=2, paged=True,
                          page_size=8, chunked_prefill=64)
    try:
        got = [b.submit(records[0]).result(eng._decode_text, timeout=600)]
        assert eng.prefix_cache_stats == [0, 1]
        handles = [b.submit(r) for r in records[1:]]
        got += [h.result(eng._decode_text, timeout=600) for h in handles]
        assert got == want
        assert eng.prefix_cache_stats[0] >= 2
        assert b.prefix_share_stats[0] >= 2
    finally:
        b.shutdown()


def test_decode_flows_during_job(scene):
    """An in-flight stream keeps emitting while a cold admission runs its
    chunks (16 tokens a chunk)."""
    infos = scene[0]
    eng = _engine(scene)
    eng.ecfg = replace(eng.ecfg, max_new_tokens=96, eos_token_id=-1)
    b = ContinuousBatcher(eng, num_slots=2, chunk=2, chunked_prefill=16)
    try:
        r1 = b.submit(_record(infos[0], QS[0], 0))
        next(r1.text_stream(eng._decode_text))
        n_before = len(r1.tokens)
        r2 = b.submit(_record(infos[1], QS[1], 1))
        r2.result(eng._decode_text, timeout=600)
        assert len(r1.tokens) > n_before
        r1.cancel()
    finally:
        b.shutdown()


def test_cancel_queued_job(scene):
    """A queued job cancelled before it starts returns empty; the
    pipeline drains."""
    infos = scene[0]
    eng = _engine(scene)
    b = ContinuousBatcher(eng, num_slots=1, chunk=2, chunked_prefill=32)
    try:
        r1 = b.submit(_record(infos[0], QS[0], 0))
        r2 = b.submit(_record(infos[1], QS[1], 1))
        r2.cancel()
        assert isinstance(r1.result(eng._decode_text, timeout=600), str)
        assert r2.result(eng._decode_text, timeout=600) == ""
        deadline = time.time() + 30
        while time.time() < deadline and (b._job is not None or b._chunkq):
            time.sleep(0.05)
        assert b._job is None and not b._chunkq
    finally:
        b.shutdown()


def test_engine_chunked_request(scene):
    """``start_request_chunked`` of a full-mode prep is a ChunkedPrefill
    whose finished state decodes the engine's answer; ``finish_chunked``
    stores the prefix, after which a prep comes back finished (a prefix
    hit)."""
    infos = scene[0]
    eng = _engine(scene, 2)
    rec = _record(infos[0], QS[0])
    want = _engine(scene).generate_answer(rec)
    prep = eng.prepare_request(rec)
    cp = eng.start_request_chunked(prep, chunk_len=32)
    assert isinstance(cp, tgen.ChunkedPrefill)
    state = eng.finish_chunked(prep, _run(cp))
    assert eng._texts(eng._generate_from_state(state))[0] == want
    assert eng.prefix_cache_stats == [0, 1]
    hit = eng.start_request_chunked(eng.prepare_request(rec))
    assert isinstance(hit, tgen.DecodeState)
    assert eng.prefix_cache_stats == [1, 1]
