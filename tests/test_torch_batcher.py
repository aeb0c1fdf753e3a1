"""Continuous batcher of the port against the JAX ``ContinuousBatcher`` and
the port's sequential engine, on the CPU: tiny float32 model, fake
tokenizer, synthetic scenes. Answers in dense and paged mode, with and
without shared prefix pages; slot reuse; deferred admission on a tight
pool; the impossible footprint; cancellation in flight and while queued;
eviction freeing shared pages; the page accounting under churn; Scan2Cap
captions submitted with their boxes; and speculative mode and chunked
prefill switched on through the constructor.

FakeTokenizer numbers words in order of first use, so every engine first
tokenizes the questions in one fixed order (the sequential answers, or
``_tokenize_prompt``) before a batcher prepares them on its threads."""

import os
import random
import time

import numpy as np
import pytest
import torch

import jax

from video3d_tpu.config import DataConfig, ModelConfig
from video3d_tpu.data.image_processor import SigLipImageProcessor
from video3d_tpu.data.video_processor import VideoProcessor
from video3d_tpu.eval import drivers as jdrv
from video3d_tpu.models import llava_video3d as jlv
from video3d_tpu.serve.batcher import ContinuousBatcher as JaxBatcher
from video3d_tpu_torch.data.image_processor import \
    SigLipImageProcessor as TSigLipImageProcessor
from video3d_tpu_torch.data.video_processor import \
    VideoProcessor as TVideoProcessor
from video3d_tpu_torch.eval import drivers as tdrv
from video3d_tpu_torch.models.paged_kv import pages_needed
from video3d_tpu_torch.params import from_jax_params
from video3d_tpu_torch.serve.batcher import ContinuousBatcher

from fixtures import FakeTokenizer, make_fake_scene
from port_configs import port_config

torch.set_num_threads(1)

CFG = ModelConfig.tiny()
TCFG = port_config(CFG)
PAGE = 8        # small pages, so the tiny scene prefix spans full pages
QUESTIONS = ("what color is the chair", "how many tables are there",
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
    return infos, data_cfg, params, from_jax_params(
        jax.tree.map(np.asarray, params), TCFG, device="cpu")


def _ecfg(module, tok, prefix_scenes, kv="bfloat16"):
    return module.EngineConfig(
        max_new_tokens=4, eos_token_id=tok.eos_token_id, max_frames=3,
        buckets=(256,), stop_str="", suffix_buckets=(32, 64),
        prefix_cache_scenes=prefix_scenes, kv_cache_dtype=kv)


def _engine(scene, prefix_scenes=0, kv="bfloat16"):
    _, data_cfg, _, tparams = scene
    tok = FakeTokenizer()
    return tdrv.InferenceEngine(
        tparams, TCFG, tok, TVideoProcessor(port_config(data_cfg)),
        TSigLipImageProcessor(size=(CFG.vision.image_size,) * 2),
        _ecfg(tdrv, tok, prefix_scenes, kv), device="cpu")


def _jax_engine(scene, prefix_scenes=0, kv="bfloat16"):
    _, data_cfg, params, _ = scene
    tok = FakeTokenizer()
    return jdrv.InferenceEngine(
        params, CFG, tok, VideoProcessor(data_cfg),
        SigLipImageProcessor(size=(CFG.vision.image_size,) * 2),
        _ecfg(jdrv, tok, prefix_scenes, kv), device_geometry=True)


def _record(info, question, i=0):
    return {"id": f"q{i}", "video": info["sample_idx"],
            "conversations": [{"from": "human",
                               "value": f"<image>\n{question}"},
                              {"from": "gpt", "value": None}]}


def _wait(pred, seconds=60):
    deadline = time.time() + seconds
    while time.time() < deadline:
        if pred():
            return True
        time.sleep(0.02)
    return pred()


MODES = {"dense": dict(paged=False),
         "paged": dict(paged=True, page_size=PAGE),
         "paged_shared": dict(paged=True, page_size=PAGE),
         "paged_shared_int4": dict(paged=True, page_size=PAGE)}


@pytest.mark.parametrize("mode", list(MODES))
def test_answers_match_jax_batcher_and_sequential(scene, mode):
    """Three questions on one scene through two slots (the third reuses a
    slot): the port's batcher answers as the port's sequential engine and
    as the JAX batcher in the same mode. With the scene-prefix cache on
    (paged_shared), the first request misses and stores the prefix, the
    next two share its pool pages; paged_shared_int4 does so over int4
    pools (the port's packed uint8 pages, JAX's ``jnp.int4`` ones) and an
    int4 prefix entry."""
    infos = scene[0]
    prefix = 4 if mode.startswith("paged_shared") else 0
    kv = "int4" if mode.endswith("int4") else "bfloat16"
    records = [_record(infos[0], q, i) for i, q in enumerate(QUESTIONS)]
    plain = _engine(scene, kv=kv)
    want = [plain.generate_answer(r) for r in records]
    eng = _engine(scene, prefix, kv)
    jeng = _jax_engine(scene, prefix, kv)
    for r in records:                  # the same word ids in both
        eng._tokenize_prompt(r)
        jeng._tokenize_prompt(r)
    answers = []
    for make, e in ((ContinuousBatcher, eng), (JaxBatcher, jeng)):
        b = make(e, num_slots=2, chunk=2, **MODES[mode])
        if make is ContinuousBatcher and kv == "int4":
            assert b.state.cache.k.dtype == torch.uint8
        try:
            first = b.generate(records[0])     # the miss stores the prefix
            handles = [b.submit(r) for r in records[1:]]
            answers.append([first] + [h.result(e._decode_text, timeout=300)
                                      for h in handles])
            if prefix:
                assert b.prefix_share_stats == [2, 1]
        finally:
            b.shutdown()
    assert answers[0] == want
    assert answers[1] == want


def test_slots_and_pages_return(scene):
    """Five requests through two paged slots with per-request budgets: the
    tokens are the sequential engine's cut to each budget, and every slot
    and every page comes back."""
    infos = scene[0]
    eng = _engine(scene)
    records = [_record(infos[0], QUESTIONS[i % 3], i) for i in range(5)]
    want = []
    for i, r in enumerate(records):      # the sequential ids, cut to budget
        res = eng._generate(*eng._prepare_generation(r))
        n = min(int(res.lengths[0]), 2 + i % 3)
        want.append(res.tokens[0, :n].tolist())
    b = ContinuousBatcher(eng, num_slots=2, chunk=2, paged=True,
                          page_size=PAGE)
    try:
        full = b._alloc.available
        assert full == b.total_pages - 1
        handles = [b.submit(r, max_new_tokens=2 + i % 3)
                   for i, r in enumerate(records)]
        for h in handles:
            h.result(eng._decode_text, timeout=300)
        assert [h.tokens for h in handles] == want
        assert _wait(lambda: b._alloc.available == full)
        assert all(p is None for p in b._slot_pages)
        assert all(s is None for s in b.slots)
    finally:
        b.shutdown()


def test_deferred_admission_on_a_tight_pool(scene, monkeypatch):
    """A pool for one footprint: the second request defers until the first
    returns its pages, then answers right."""
    infos = scene[0]
    eng = _engine(scene)
    records = [_record(infos[0], q, i) for i, q in enumerate(QUESTIONS[:2])]
    want = [eng.generate_answer(r) for r in records]
    deferrals = []
    admit = ContinuousBatcher._admit

    def counting(self, *a):
        out = admit(self, *a)
        deferrals.append(out is ContinuousBatcher._DEFER)
        return out

    monkeypatch.setattr(ContinuousBatcher, "_admit", counting)
    need = pages_needed(256 + 4 + 2, PAGE)
    b = ContinuousBatcher(eng, num_slots=2, chunk=2, paged=True,
                          page_size=PAGE, total_pages=need + 1)
    try:
        handles = [b.submit(r) for r in records]
        assert [h.result(eng._decode_text, timeout=300)
                for h in handles] == want
        assert any(deferrals)
        assert not b._deferred
    finally:
        b.shutdown()


def test_impossible_footprint_fails_loudly(scene):
    b = ContinuousBatcher(_engine(scene), num_slots=1, chunk=2, paged=True,
                          page_size=PAGE, total_pages=2)
    try:
        h = b.submit(_record(scene[0][0], "hi"))
        with pytest.raises(ValueError, match="page pool"):
            h.result(b.engine._decode_text, timeout=120)
    finally:
        b.shutdown()


@pytest.mark.parametrize("paged", [False, True])
def test_cancel_in_flight_and_queued(scene, paged):
    """One slot: a long request is cancelled after its first tokens (it
    ends early and frees the slot and its pages); a request cancelled while
    queued never takes the slot; the next request answers right."""
    infos = scene[0]
    eng = _engine(scene)
    last = _record(infos[0], QUESTIONS[2], 2)
    want = eng.generate_answer(last)
    extra = dict(paged=True, page_size=PAGE) if paged else {}
    b = ContinuousBatcher(eng, num_slots=1, chunk=1, max_cache_len=400,
                          **extra)
    try:
        full = b._alloc.available if paged else None
        long = b.submit(_record(infos[0], QUESTIONS[0], 0),
                        max_new_tokens=100)
        queued = b.submit(_record(infos[0], QUESTIONS[1], 1))
        queued.cancel()
        stream = long.text_stream(eng._decode_text)
        next(stream)                       # the first tokens arrived
        long.cancel()
        list(stream)                       # ends early, no error
        assert 0 < len(long.tokens) < 100
        assert queued.result(eng._decode_text, timeout=120) == ""
        assert queued.tokens == []
        assert b.generate(last) == want
        if paged:
            assert _wait(lambda: b._alloc.available == full)
    finally:
        b.shutdown()


def test_eviction_frees_shared_pages(scene):
    """The engine's LRU of one scene: storing scene 1's prefix evicts scene
    0's; the batcher's hook drains it and scene 0's shared pages return,
    scene 1's stay held by the cache."""
    infos = scene[0]
    eng = _engine(scene, 1)
    b = ContinuousBatcher(eng, num_slots=2, chunk=2, paged=True,
                          page_size=PAGE)
    try:
        full = b._alloc.available
        r0 = _record(infos[0], QUESTIONS[0])
        b.generate(r0)                                 # miss: store
        b.generate(_record(infos[0], QUESTIONS[1]))    # hit: share
        key0, key1 = r0["video"], infos[1]["sample_idx"]
        assert key0 in b._shared
        eng.generate_answer(_record(infos[1], QUESTIONS[0]))   # evicts 0
        b.generate(_record(infos[1], QUESTIONS[1]))    # hit on scene 1
        assert _wait(lambda: key0 not in b._shared)
        n1 = len(b._shared[key1]["pages"])
        assert _wait(lambda: b._alloc.available == full - n1)
        assert eng.prefix_cache_stats == [2, 2]
    finally:
        b.shutdown()


def test_churn_accounting_invariant(scene):
    """Twelve requests over two scenes through two slots on the default
    pool, a quarter cancelled: the surviving answers are the engine's, and
    at rest free pages + shared-held pages == all pages, each shared entry
    held once (by the cache), no deferral left."""
    infos = scene[0]
    eng = _engine(scene, 4)
    recs, want = [], {}
    for i in range(12):
        info, q = infos[i % 2], QUESTIONS[i % 3]
        recs.append(_record(info, q, i))
        if (info["sample_idx"], q) not in want:
            want[info["sample_idx"], q] = eng.generate_answer(recs[-1])
    b = ContinuousBatcher(eng, num_slots=2, chunk=2, paged=True,
                          page_size=PAGE)
    try:
        full = b._alloc.available
        rng = random.Random(0)
        handles = [(i, b.submit(r), rng.random() < 0.25)
                   for i, r in enumerate(recs)]
        for _, h, cancel in handles:
            if cancel:
                h.cancel()
        for i, h, cancel in handles:
            out = h.result(eng._decode_text, timeout=600)
            if not cancel:
                assert out == want[infos[i % 2]["sample_idx"],
                                   QUESTIONS[i % 3]], i
        assert _wait(lambda: all(s is None for s in b.slots))
        held = sum(len(sh["pages"]) for sh in b._shared.values())
        assert _wait(lambda: b._alloc.available + held == full)
        assert all(sh["refs"] == 1 and not sh["dead"]
                   for sh in b._shared.values())
        assert len(b._shared) <= 2 and not b._deferred
    finally:
        b.shutdown()


def test_what_is_not_ported_raises(scene):
    """Speculative mode and chunked prefill, which raised before they were
    ported, now construct and answer: a draft given to the batcher (the
    engine's own first layer) turns speculation on, its dense rows grow
    by the verify's K+2 slack and chunking stays off; ``chunked_prefill``
    alone turns chunking on. Both answer as the sequential engine."""
    from video3d_tpu_torch.models import speculative as tspec

    infos = scene[0]
    eng = _engine(scene)
    rec = _record(infos[0], QUESTIONS[0])
    want = eng.generate_answer(rec)
    draft = tspec.self_draft_params(eng.params, 1)
    b = ContinuousBatcher(eng, num_slots=1, chunk=2, draft_params=draft,
                          draft_cfg=tspec.self_draft_config(TCFG.llm, 1),
                          chunked_prefill=64)
    try:
        assert b.spec and b.chunk_prefill == 0
        assert b.max_cache_len == max(eng.ecfg.buckets) \
            + eng.ecfg.max_new_tokens + eng.ecfg.speculative_k + 2
        assert b.submit(rec).result(eng._decode_text, timeout=300) == want
    finally:
        b.shutdown()
    b = ContinuousBatcher(eng, num_slots=1, chunk=2, chunked_prefill=64)
    try:
        assert not b.spec and b.chunk_prefill == 64
        assert b.submit(rec).result(eng._decode_text, timeout=300) == want
    finally:
        b.shutdown()


COORD = 302          # FakeTokenizer's <coord>


@pytest.mark.parametrize("mode", ["dense", "paged_shared"])
def test_box_input_captions_match_jax_and_engine(scene, mode):
    """Scan2Cap captions submitted with their boxes: the port's batcher
    gives the port's sequential engine's captions and the JAX batcher's
    in the same mode (paged_shared: the first caption misses and stores
    the prefix, the others are suffixes carrying the box PE)."""
    infos = scene[0]
    boxes = [np.asarray([0.4 * i, -0.3, 0.5 + 0.1 * i], np.float32)
             for i in range(3)]
    records = [_record(infos[0], f"describe the object at <coord> {q}", i)
               for i, q in enumerate(QUESTIONS)]
    prefix = 4 if mode == "paged_shared" else 0
    plain = _engine(scene)
    want = [plain.generate_answer(r, b, COORD)
            for r, b in zip(records, boxes)]
    eng = _engine(scene, prefix)
    jeng = _jax_engine(scene, prefix)
    for r in records:
        eng._tokenize_prompt(r)
        jeng._tokenize_prompt(r)
    seen = []           # the boxes the port's engine prepared with
    for name in ("prepare_request", "_prepare_generation"):
        real = getattr(eng, name)

        def spy(record, box_input=None, coord_token_id=None, _real=real):
            seen.append((record["id"], tuple(box_input), coord_token_id))
            return _real(record, box_input, coord_token_id)
        setattr(eng, name, spy)
    answers = []
    for make, e in ((ContinuousBatcher, eng), (JaxBatcher, jeng)):
        b = make(e, num_slots=2, chunk=2, **MODES[mode])
        try:
            first = b.generate(records[0], box_input=boxes[0],
                               coord_token_id=COORD)
            handles = [b.submit(r, box_input=bx, coord_token_id=COORD)
                       for r, bx in zip(records[1:], boxes[1:])]
            answers.append([first] + [h.result(e._decode_text, timeout=300)
                                      for h in handles])
        finally:
            b.shutdown()
    assert answers[0] == want == answers[1]
    assert sorted(seen) == [(r["id"], tuple(b), COORD)
                            for r, b in zip(records, boxes)]
