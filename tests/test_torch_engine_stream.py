"""The engine's serving entry points against the JAX engine, tiny model in
float32 on the synthetic scene, one FakeTokenizer shared by every engine
(so all of them number words alike): multi-turn records (prompt ids, and
answers with the scene-prefix cache off and on), ``generate_answer_stream``
(the list of cumulative texts chunk by chunk), ``generate_answer_images``
(N = 1 and 2, by prompt and by ``conversations``, with per-call budgets) and
the host-geometry route (``device_geometry=False``). Greedy ids must be
equal; sampled answers are held to the port's own ``generate_answer`` under
the same settings, and to greedy at ``top_k=1``."""

import os

import numpy as np
import pytest
import torch
from PIL import Image

import jax

from video3d_tpu.config import DataConfig, ModelConfig
from video3d_tpu.data.image_processor import SigLipImageProcessor
from video3d_tpu.data.video_processor import VideoProcessor
from video3d_tpu.eval import drivers as jdrv
from video3d_tpu.models import llava_video3d as jlv
from video3d_tpu_torch.data.image_processor import \
    SigLipImageProcessor as TSigLipImageProcessor
from video3d_tpu_torch.data.video_processor import \
    VideoProcessor as TVideoProcessor
from video3d_tpu_torch.eval import drivers as tdrv
from video3d_tpu_torch.params import from_jax_params

from fixtures import FakeTokenizer, make_fake_scene
from port_configs import port_config

torch.set_num_threads(1)

CFG = ModelConfig.tiny()
TCFG = port_config(CFG)
MAX_NEW = 12


def _ecfg(mod, tok, **kw):
    return mod.EngineConfig(max_new_tokens=MAX_NEW,
                            eos_token_id=tok.eos_token_id, max_frames=3,
                            buckets=(256,), stop_str="", **kw)


class _Setup:
    """Both packages' engines over the same weights and scene."""

    def __init__(self, root):
        self.info = make_fake_scene(root, n_frames=3)
        self.data_cfg = DataConfig(
            video_folder=root,
            annotation_dir=os.path.join(root, "embodiedscan"),
            metadata_dir=os.path.join(root, "metadata"), frames_upbound=3)
        self.tok = FakeTokenizer()
        self.jparams = jlv.init_model(jax.random.PRNGKey(0), CFG)
        self.tparams = from_jax_params(jax.tree.map(np.asarray,
                                                    self.jparams),
                                       TCFG, device="cpu")

    def jax_engine(self, device_geometry=True, **kw):
        return jdrv.InferenceEngine(
            self.jparams, CFG, self.tok, VideoProcessor(self.data_cfg),
            SigLipImageProcessor(size=(CFG.vision.image_size,) * 2),
            _ecfg(jdrv, self.tok, **kw), device_geometry=device_geometry)

    def torch_engine(self, device_geometry=True, **kw):
        return tdrv.InferenceEngine(
            self.tparams, TCFG, self.tok,
            TVideoProcessor(port_config(self.data_cfg)),
            TSigLipImageProcessor(size=(CFG.vision.image_size,) * 2),
            _ecfg(tdrv, self.tok, **kw), device="cpu",
            device_geometry=device_geometry)


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    return _Setup(str(tmp_path_factory.mktemp("scene")))


def _recording(engine):
    """Record every id list the engine decodes to text (its greedy ids)."""
    seen = []
    inner = engine._decode_text

    def decode(toks):
        seen.append([int(t) for t in toks])
        return inner(toks)

    engine._decode_text = decode
    return seen


def _history(info, n_turns: int):
    turns = [{"from": "human", "value": "<image>\nwhat is in the room"},
             {"from": "gpt", "value": "a chair and a desk"},
             {"from": "human", "value": "what color is the chair"},
             {"from": "gpt", "value": "brown"},
             {"from": "human", "value": "where is the lamp"}]
    return {"video": info["sample_idx"],
            "conversations": turns[:n_turns] + [{"from": "gpt",
                                                 "value": None}]}


def _multi_turn_records(info):
    recs = [_history(info, 3), _history(info, 5)]
    # no sentinel in any turn: injected into turn 0
    bare = _history(info, 3)
    bare["conversations"][0] = {"from": "human",
                                "value": "what is in the room"}
    # a history that anchors <image> in a later turn: left where it is
    late = _history(info, 3)
    late["conversations"][0] = {"from": "human", "value": "hello there"}
    late["conversations"][2] = {"from": "human",
                                "value": "<image>\nwhat color is the chair"}
    return recs + [bare, late]


@pytest.mark.parametrize("extra_prompt", ["", "Answer briefly. "])
def test_multi_turn_prompt_ids_match_jax(setup, extra_prompt):
    je = setup.jax_engine(extra_prompt=extra_prompt)
    te = setup.torch_engine(extra_prompt=extra_prompt)
    for rec in _multi_turn_records(setup.info):
        assert te._tokenize_prompt(rec) == je._tokenize_prompt(rec)


@pytest.mark.parametrize("prefix", [0, 2])
def test_multi_turn_answers_match_jax(setup, prefix):
    """Multi-turn answers, the scene-prefix cache off and on (on: the
    first record stores the prefix, the others prefill only their growing
    suffix against it)."""
    je = setup.jax_engine(prefix_cache_scenes=prefix)
    te = setup.torch_engine(prefix_cache_scenes=prefix)
    jids, tids = _recording(je), _recording(te)
    recs = _multi_turn_records(setup.info)
    for rec in recs:
        assert te.generate_answer(rec) == je.generate_answer(rec)
    assert tids == jids and len(tids) == len(recs)
    if prefix:
        # the three histories anchored in turn 0 share the stored prefix
        assert te.prefix_cache_stats == je.prefix_cache_stats
        assert te.prefix_cache_stats[0] >= 2


@pytest.mark.parametrize("chunk,cut", [(4, None), (16, None), (4, 6),
                                       (16, 3)])
def test_stream_texts_match_jax(setup, chunk, cut):
    """The list of cumulative texts, chunk by chunk, with per-call cuts."""
    je, te = setup.jax_engine(), setup.torch_engine()
    for rec in (_history(setup.info, 1), _history(setup.info, 3)):
        want = list(je.generate_answer_stream(rec, chunk=chunk,
                                              max_new_tokens=cut))
        got = list(te.generate_answer_stream(rec, chunk=chunk,
                                             max_new_tokens=cut))
        assert got == want and got
        if cut is None:
            assert got[-1] == te.generate_answer(rec)


def test_stream_through_the_prefix_cache_matches_jax(setup):
    je = setup.jax_engine(prefix_cache_scenes=2)
    te = setup.torch_engine(prefix_cache_scenes=2)
    for rec in (_history(setup.info, 1), _history(setup.info, 3),
                _history(setup.info, 5)):
        assert list(te.generate_answer_stream(rec, chunk=4)) == \
            list(je.generate_answer_stream(rec, chunk=4))
    assert te.prefix_cache_stats == je.prefix_cache_stats == [2, 1]


def test_sampled_stream_matches_generate_answer(setup):
    """A sampled stream (per-call settings) against the port's own
    ``generate_answer`` with the same settings on its engine: the draws are
    a hash of (seed, step, row, token), so chunking does not change them;
    top_k = 1 gives the greedy answer."""
    rec = _history(setup.info, 3)
    greedy = setup.torch_engine().generate_answer(rec)
    sampled = setup.torch_engine(temperature=1.5, top_p=0.9, top_k=20)
    want = sampled.generate_answer(rec)
    te = setup.torch_engine()
    for chunk in (4, 5):
        got = list(te.generate_answer_stream(rec, chunk=chunk,
                                             temperature=1.5, top_p=0.9,
                                             top_k=20))
        assert got[-1] == want
    got = list(te.generate_answer_stream(rec, chunk=4, temperature=1.5,
                                         top_k=1))
    assert got[-1] == greedy


def _pil(seed: int, size=(56, 40)) -> Image.Image:
    rng = np.random.default_rng(seed)
    return Image.fromarray(rng.integers(0, 255, (size[1], size[0], 3),
                                        np.uint8))


@pytest.mark.parametrize("n_images", [1, 2])
def test_generate_answer_images_matches_jax(setup, n_images):
    je, te = setup.jax_engine(), setup.torch_engine()
    jids, tids = _recording(je), _recording(te)
    images = [_pil(i, (56 + 8 * i, 40)) for i in range(n_images)]
    convs = [{"from": "human", "value": "what is this"},
             {"from": "gpt", "value": "a test pattern"},
             {"from": "human", "value": "and the colours"}]
    calls = [dict(prompt="what changed between these"),
             dict(prompt="<image>\ncompare"),
             dict(prompt=None, conversations=convs),
             dict(prompt="describe", max_new_tokens=5),
             dict(prompt=None, conversations=convs, max_new_tokens=3)]
    for kw in calls:
        assert te.generate_answer_images(images=images, **kw) == \
            je.generate_answer_images(images=images, **kw)
    assert tids == jids and len(tids) == len(calls)
    with pytest.raises(ValueError, match="placeholders"):
        te.generate_answer_images("<image> <image> <image>", images)


def test_images_sampled_overrides_match_generate(setup):
    """Sampling overrides of ``generate_answer_images`` against the port's
    own ``_generate`` on an engine with those settings; top_k = 1 gives
    the greedy answer."""
    te = setup.torch_engine()
    sampled = setup.torch_engine(temperature=1.5, top_k=20)
    images = [_pil(3), _pil(4)]
    want = sampled.generate_answer_images("compare", images)
    assert te.generate_answer_images("compare", images, temperature=1.5,
                                     top_k=20) == want
    assert te.generate_answer_images("compare", images, temperature=1.5,
                                     top_k=1) == \
        te.generate_answer_images("compare", images)


def test_host_geometry_answers_match_jax(setup):
    """``device_geometry=False``: process_3d_video, patch means and the
    clip / round discretization (zero-padded to max_frames) against JAX's
    host route; its voxel ids against B1's plain version on the same
    scene."""
    je = setup.jax_engine(device_geometry=False)
    te = setup.torch_engine(device_geometry=False)
    jids, tids = _recording(je), _recording(te)
    recs = [_history(setup.info, 1), _history(setup.info, 3)]
    for rec in recs:
        assert te.generate_answer(rec) == je.generate_answer(rec)
    assert tids == jids
    V, images, patch = te._video_arrays(setup.info["sample_idx"])
    _, _, _, _, jpatch, _ = je._video_arrays(setup.info["sample_idx"])
    assert images.shape[1] == patch.shape[1] == 3
    np.testing.assert_array_equal(patch.numpy(), jpatch)
    Vd, _, dpatch = setup.torch_engine()._video_arrays(
        setup.info["sample_idx"])
    assert Vd == V
    share = float((dpatch[0, :V] != patch[0, :V]).any(-1).float().mean())
    assert share < 0.05, share
    # a batch of the two answers as each alone (JAX's batched path reads
    # only turn 0 of a multi-turn record; its sequential one, held above,
    # reads the whole history as the port's both do)
    assert te.generate_answers_batch(recs) == \
        [je.generate_answer(r) for r in recs]
