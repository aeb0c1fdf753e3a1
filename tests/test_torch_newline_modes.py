"""The FRAME, ONE_TOKEN and NO_TOKEN newline layouts of the port against
the JAX package on the CPU (``ModelConfig.tiny()``, f32): the spliceable
tokens of all four layouts (bit for bit without a PE); the token counts; at FRAME and
NO_TOKEN, which JAX runs everywhere, the engine's answers (B=1, a prefix
miss then a hit, the batched and prefix-batched paths, the paged
batcher's), grounding's scores and the collator's arrays equal to JAX's;
and ONE_TOKEN, whose tokens per frame JAX cannot count, refused by the
port's engine and Trainer with a ValueError."""

import json
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from video3d_tpu.config import DataConfig, ModelConfig, NewlinePosition, replace
from video3d_tpu.data import dataset as jds
from video3d_tpu.data.image_processor import SigLipImageProcessor
from video3d_tpu.data.video_processor import VideoProcessor
from video3d_tpu.eval import drivers as jdrv
from video3d_tpu.models import llava_video3d as jlv
from video3d_tpu.serve.batcher import ContinuousBatcher as JaxBatcher
from video3d_tpu_torch.data import dataset as tds
from video3d_tpu_torch.data.image_processor import \
    SigLipImageProcessor as TSigLipImageProcessor
from video3d_tpu_torch.data.video_processor import \
    VideoProcessor as TVideoProcessor
from video3d_tpu_torch.eval import drivers as tdrv
from video3d_tpu_torch.models import llava_video3d as tlv
from video3d_tpu_torch.params import from_jax_params
from video3d_tpu_torch.serve.batcher import ContinuousBatcher
from video3d_tpu_torch.train.optim import OptimConfig
from video3d_tpu_torch.train.trainer import Trainer, TrainingConfig

from fixtures import FakeTokenizer, make_fake_annotations, make_fake_scene
from port_configs import port_config

torch.set_num_threads(1)

RUNS = ("frame", "no_token")
TEXTS = ("what color is the chair", "how many tables are there",
         "where is the lamp")


def _cfg(pos: str) -> ModelConfig:
    return replace(ModelConfig.tiny(), newline_position=NewlinePosition(pos))


@pytest.fixture(scope="module")
def jparams():
    return jax.tree.map(np.asarray,
                        jlv.init_model(jax.random.PRNGKey(0), _cfg("grid")))


@pytest.mark.parametrize("pos", ["grid", "frame", "one_token", "no_token"])
def test_spliceable_matches_jax(jparams, pos):
    """The layout bit for bit without a PE; with the sin3d PE added to
    2e-5 relative (f32 ``sin``/``cos`` differ by an ulp between XLA and
    torch)."""
    cfg = _cfg(pos)
    rng = np.random.default_rng(0)
    pooled = rng.standard_normal((2, 3, 4, 64)).astype(np.float32)
    coords = rng.integers(0, 50, (2, 3, 2, 2, 3)).astype(np.float32)
    tp = from_jax_params(jparams, port_config(cfg), device="cpu")
    jpj = jax.tree.map(jnp.asarray, jparams)
    for pc, exact in ((None, True), (coords, False)):
        want = jlv.finish_video_tokens(
            jpj, cfg, jnp.asarray(pooled), None,
            None if pc is None else jnp.asarray(pc))
        got = tlv.finish_video_tokens(
            tp, port_config(cfg), torch.from_numpy(pooled), None,
            None if pc is None else torch.from_numpy(pc))
        w = np.asarray(want.spliceable)
        assert got.spliceable.shape == w.shape
        if exact:
            np.testing.assert_array_equal(got.spliceable.numpy(), w)
        else:
            err = np.abs(got.spliceable.numpy() - w).max()
            assert err <= 2e-5 * np.abs(w).max()
    assert got.spliceable.shape[1] == \
        port_config(cfg).total_vision_tokens(3) == cfg.total_vision_tokens(3)


def test_token_counts_at_the_flagship():
    """197 and 196 vision tokens a frame at g = 14."""
    counts = {}
    for pos in ("grid", "frame", "no_token"):
        cfg = port_config(replace(ModelConfig(),
                                  newline_position=NewlinePosition(pos)))
        counts[pos] = cfg.tokens_per_frame
    assert counts == {"grid": 210, "frame": 197, "no_token": 196}


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("data"))
    info = make_fake_scene(root, n_frames=2)
    dc = DataConfig(video_folder=root,
                    annotation_dir=os.path.join(root, "embodiedscan"),
                    metadata_dir=os.path.join(root, "metadata"),
                    frames_upbound=2)
    return root, info, dc


def _engines(data, jparams, pos, prefix=0):
    _, info, dc = data
    cfg = _cfg(pos)
    tok = FakeTokenizer()
    kw = dict(max_new_tokens=6, eos_token_id=tok.eos_token_id, max_frames=2,
              buckets=(256,), stop_str="", prefix_cache_scenes=prefix,
              suffix_buckets=(32, 64), ground_token_id=301, max_objects=8)
    jeng = jdrv.InferenceEngine(
        jax.tree.map(jnp.asarray, jparams), cfg, tok, VideoProcessor(dc),
        SigLipImageProcessor(size=(56, 56)), jdrv.EngineConfig(**kw),
        device_geometry=True)
    teng = tdrv.InferenceEngine(
        from_jax_params(jparams, port_config(cfg), device="cpu"),
        port_config(cfg), tok, TVideoProcessor(port_config(dc)),
        TSigLipImageProcessor(size=(56, 56)), tdrv.EngineConfig(**kw),
        device="cpu")
    qs = [{"id": f"q{i}", "video": info["sample_idx"],
           "conversations": [{"from": "human", "value": f"<image>\n{t}"},
                             {"from": "gpt", "value": None}]}
          for i, t in enumerate(TEXTS)]
    for q in qs:
        jeng._tokenize_prompt(q)
    return jeng, teng, qs


@pytest.mark.parametrize("pos", RUNS)
def test_answers_match_jax(data, jparams, pos):
    jeng, teng, qs = _engines(data, jparams, pos)
    jres = jeng._generate(*jeng._prepare_generation(qs[0]))
    tres = teng._generate(*teng._prepare_generation(qs[0]))
    np.testing.assert_array_equal(tres.tokens.numpy(),
                                  np.asarray(jres.tokens))
    assert teng.generate_answers_batch(qs[:2]) == \
        jeng.generate_answers_batch(qs[:2])


@pytest.mark.parametrize("pos", RUNS)
def test_prefix_hit_and_suffix_batch_match_jax(data, jparams, pos):
    """A miss stores the prefix (its length follows the layout), a B=1 hit
    and a B=2 suffix batch read it: ids equal to the miss's and JAX's."""
    jeng, teng, qs = _engines(data, jparams, pos, prefix=2)
    want = [jeng.generate_answer(q) for q in qs]
    got = [teng.generate_answer(q) for q in qs[:1]]
    entry = next(iter(teng._prefix_cache.values()))
    assert entry.num_frames == 2
    assert entry.prefix_len == next(iter(jeng._prefix_cache.values())) \
        .prefix_len
    got += teng.generate_answers_batch_prefix(qs[1:])
    assert got == want
    assert teng.prefix_cache_stats == [2, 1]
    plain = _engines(data, jparams, pos)[1]
    assert [plain.generate_answer(q) for q in qs] == want


@pytest.mark.parametrize("pos", RUNS)
def test_paged_batcher_matches_jax(data, jparams, pos):
    """The paged batcher with shared prefix pages: the two hits share the
    pages of the layout's prefix (as many as JAX's); answers equal JAX's
    batcher's."""
    jeng, teng, qs = _engines(data, jparams, pos, prefix=2)
    for q in qs:
        teng._tokenize_prompt(q)
    answers, shared, pages = [], [], []
    for make, e in ((ContinuousBatcher, teng), (JaxBatcher, jeng)):
        b = make(e, num_slots=2, chunk=2, paged=True, page_size=8)
        try:
            first = b.generate(qs[0])
            hs = [b.submit(q) for q in qs[1:]]
            answers.append([first] + [h.result(e._decode_text, timeout=300)
                                      for h in hs])
            shared.append(list(b.prefix_share_stats))
            P = next(iter(e._prefix_cache.values())).prefix_len
            pages.append(-(-P // 8))
        finally:
            b.shutdown()
    assert answers[0] == answers[1]
    assert shared[0] == shared[1] == [2, 1]
    assert pages[0] == pages[1]


@pytest.mark.parametrize("pos", RUNS)
def test_grounding_matches_jax(data, jparams, pos):
    jeng, teng, _ = _engines(data, jparams, pos)
    info = data[1]
    rec = {"id": "g0", "video": info["sample_idx"],
           "conversations": [{"from": "human",
                              "value": "<image>\nfind the chair"},
                             {"from": "gpt", "value": "<ground>"}]}
    js, jo = jeng.ground(rec)
    ts, to = teng.ground(rec)
    np.testing.assert_allclose(ts, np.asarray(js), rtol=1e-4, atol=1e-5)
    np.testing.assert_array_equal(to, np.asarray(jo))


@pytest.mark.parametrize("pos", RUNS)
def test_collator_matches_jax(data, pos):
    root, info, dc = data
    ann = make_fake_annotations(root, info["sample_idx"], n=2)
    ds = jds.SupervisedDataset(ann, FakeTokenizer(), dc,
                               image_processor=SigLipImageProcessor(
                                   size=(56, 56)))
    samples = [ds[0], ds[1]]
    cfg = _cfg(pos)
    want = jds.Collator(cfg, jds.CollatorConfig(max_len=200,
                                                frames_upbound=2))(samples)
    got = tds.Collator(port_config(cfg), tds.CollatorConfig(
        max_len=200, frames_upbound=2))(samples)
    assert set(got) == set(want)
    for k in want:
        if want[k] is not None:
            np.testing.assert_array_equal(np.asarray(got[k]),
                                          np.asarray(want[k]), err_msg=k)


def test_one_token_refused_as_jax_fails(data, jparams):
    """JAX's engine and collator raise in ``tokens_per_frame``; the port's
    engine refuses the layout before any work, and so does its Trainer."""
    jeng, teng, qs = _engines(data, jparams, "one_token")
    with pytest.raises(NotImplementedError):
        jeng.generate_answer(qs[0])
    with pytest.raises(ValueError, match="one_token"):
        teng.generate_answer(qs[0])
    with pytest.raises(ValueError, match="one_token"):
        teng.generate_answers_batch(qs[:2])
    with pytest.raises(ValueError, match="one_token"):
        teng.ground({"id": "g", "video": qs[0]["video"],
                     "conversations": [{"from": "human", "value": "x"},
                                       {"from": "gpt", "value": "<ground>"}]})
    with pytest.raises(ValueError, match="one_token"):
        Trainer(port_config(_cfg("one_token")), teng.params, [], None,
                OptimConfig(), TrainingConfig(output_dir=data[0]),
                device="cpu")
