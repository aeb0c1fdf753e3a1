"""The llava3d voxel-dedup variant of the port against the JAX package on
the CPU: ``linearize_voxels`` and ``voxel_dedup_features`` bit for bit,
with no keys and with JAX's ``PRNGKey(0)`` draw fed in, at budgets above
and below the scene's unique voxels; ``encode_video_llava3d``; on
``ModelConfig.tiny()`` (f32, budget 24) the engine's answers with JAX's
draw fed in, token for token with the JAX engine's ``generate_answer``
(device and host geometry, the scene and prefix caches asked for but off,
beam search, the dense and paged batchers); the batched answers and
grounding, where the JAX engine ignores the variant or scores NaN, refused
by the port; and the collator's arrays, which lay a llava3d scene out as
the grid in both packages."""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from video3d_tpu.config import (DataConfig, ModelConfig, World3DConfig,
                                replace)
from video3d_tpu.data import dataset as jds
from video3d_tpu.data.image_processor import SigLipImageProcessor
from video3d_tpu.data.video_processor import VideoProcessor
from video3d_tpu.eval import drivers as jdrv
from video3d_tpu.models import llava_video3d as jlv
from video3d_tpu.ops import voxel_dedup as jvd
from video3d_tpu.serve.batcher import ContinuousBatcher as JaxBatcher
from video3d_tpu_torch.data import dataset as tds
from video3d_tpu_torch.data.image_processor import \
    SigLipImageProcessor as TSigLipImageProcessor
from video3d_tpu_torch.data.video_processor import \
    VideoProcessor as TVideoProcessor
from video3d_tpu_torch.eval import drivers as tdrv
from video3d_tpu_torch.models import llava_video3d as tlv
from video3d_tpu_torch.ops import voxel_dedup as tvd
from video3d_tpu_torch.params import from_jax_params
from video3d_tpu_torch.serve.batcher import ContinuousBatcher

from fixtures import FakeTokenizer, make_fake_annotations, make_fake_scene
from port_configs import port_config

torch.set_num_threads(1)

BUDGET = 24
CFG = replace(ModelConfig.tiny(), world_3d=replace(
    World3DConfig.from_reference_string("avg-discrete-llava3d"),
    llava3d_budget=BUDGET))
TEXTS = ("what color is the chair", "how many tables are there")


def _jax_keys(n: int) -> torch.Tensor:
    """The JAX engine's voxel draw (``eval/drivers.py:406-407``)."""
    return torch.from_numpy(np.asarray(
        jax.random.uniform(jax.random.PRNGKey(0), (n,))))


def test_linearize_voxels_matches_jax():
    c = np.random.default_rng(0).integers(0, 30, (5, 7, 3)).astype(np.float32)
    want = np.asarray(jvd.linearize_voxels(jnp.asarray(c), (31, 31, 12)))
    got = tvd.linearize_voxels(torch.from_numpy(c), (31, 31, 12))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("budget", [8, 24, 100])
@pytest.mark.parametrize("keyed", [False, True])
def test_voxel_dedup_bit_for_bit(budget, keyed):
    """60 patch rows over a 4^3 voxel span (about 40 unique voxels): the
    budgets cut them (8, 24) or cycle them (100)."""
    rng = np.random.default_rng(budget)
    P = 60
    f = rng.standard_normal((P, 16)).astype(np.float32)
    c = rng.integers(0, 4, (P, 3)).astype(np.float32)
    key = jax.random.PRNGKey(0) if keyed else None
    jf, jm = jvd.voxel_dedup_features(jnp.asarray(f), jnp.asarray(c),
                                      (10, 10, 10), budget, key)
    tf, tm = tvd.voxel_dedup_features(torch.from_numpy(f),
                                      torch.from_numpy(c), (10, 10, 10),
                                      budget, _jax_keys(P) if keyed else None)
    np.testing.assert_array_equal(tf.numpy(), np.asarray(jf))
    np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))
    unique = len(np.unique(c, axis=0))
    assert int(tm.sum()) == min(unique, budget)


def test_voxel_dedup_bf16_means_and_float64_loop():
    """bf16 features: the means summed in f32 and cast back, within bf16
    rounding of a float64 loop over the voxels (the chip's check)."""
    rng = np.random.default_rng(3)
    f = torch.from_numpy(rng.standard_normal((50, 8)).astype(np.float32)) \
        .to(torch.bfloat16)
    c = torch.from_numpy(rng.integers(0, 3, (50, 3)).astype(np.float32))
    out, mask = tvd.voxel_dedup_features(f, c, (5, 5, 5), budget=200)
    assert out.dtype == torch.bfloat16
    ids = tvd.linearize_voxels(c, (5, 5, 5)).numpy()
    f64 = f.double().numpy()
    uniq = np.unique(ids)
    want = np.stack([f64[ids == u].mean(0) for u in uniq])
    got = out[:len(uniq)].double().numpy()
    assert np.abs(got - want).max() <= 2 ** -8 * np.abs(want).max()
    assert int(mask.sum()) == len(uniq)


def test_default_order_keys_are_seeded():
    a, b = tvd.default_order_keys(10), tvd.default_order_keys(10)
    assert torch.equal(a, b) and a.dtype == torch.float32
    assert torch.equal(a, torch.rand(10, generator=torch.Generator()
                                     .manual_seed(0)))


@pytest.fixture(scope="module")
def jparams():
    return jax.tree.map(np.asarray, jlv.init_model(jax.random.PRNGKey(0),
                                                   CFG))


def test_encode_video_llava3d_matches_jax(jparams):
    rng = np.random.default_rng(1)
    images = rng.standard_normal((1, 2, 3, 56, 56)).astype(np.float32)
    coords = rng.integers(0, 3, (2, 2, 2, 3)).astype(np.float32)
    jf, jm = jlv.encode_video_llava3d(
        jax.tree.map(jnp.asarray, jparams), CFG, jnp.asarray(images),
        jnp.asarray(coords), key=jax.random.PRNGKey(0))
    tf, tm = tlv.encode_video_llava3d(
        from_jax_params(jparams, port_config(CFG), device="cpu"),
        port_config(CFG), torch.from_numpy(images),
        torch.from_numpy(coords), order_keys=_jax_keys(8))
    assert tf.shape == (BUDGET, 64)
    np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))
    np.testing.assert_allclose(tf.numpy(), np.asarray(jf), rtol=1e-5,
                               atol=1e-6)


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("data"))
    info = make_fake_scene(root, n_frames=3)
    dc = DataConfig(video_folder=root,
                    annotation_dir=os.path.join(root, "embodiedscan"),
                    metadata_dir=os.path.join(root, "metadata"),
                    frames_upbound=3)
    return root, info, dc


def _engines(data, jparams, geometry=True, **extra):
    _, info, dc = data
    tok = FakeTokenizer()
    kw = dict(max_new_tokens=5, eos_token_id=tok.eos_token_id, max_frames=3,
              buckets=(128,), stop_str="", **extra)
    jeng = jdrv.InferenceEngine(
        jax.tree.map(jnp.asarray, jparams), CFG, tok, VideoProcessor(dc),
        SigLipImageProcessor(size=(56, 56)), jdrv.EngineConfig(**kw),
        device_geometry=geometry)
    teng = tdrv.InferenceEngine(
        from_jax_params(jparams, port_config(CFG), device="cpu"),
        port_config(CFG), tok, TVideoProcessor(port_config(dc)),
        TSigLipImageProcessor(size=(56, 56)), tdrv.EngineConfig(**kw),
        device="cpu", device_geometry=geometry)
    teng._llava3d_order_keys = _jax_keys
    qs = [{"id": f"q{i}", "video": info["sample_idx"],
           "conversations": [{"from": "human", "value": f"<image>\n{t}"},
                             {"from": "gpt", "value": None}]}
          for i, t in enumerate(TEXTS)]
    for q in qs:
        jeng._tokenize_prompt(q)
    return jeng, teng, qs


@pytest.mark.parametrize("geometry", [True, False])
def test_answers_match_jax(data, jparams, geometry):
    """B1's voxel ids (device route) and the host route's: the block, the
    first-step ids and the answers equal JAX's with its draw fed in."""
    jeng, teng, qs = _engines(data, jparams, geometry)
    jb, jf = jeng._prepare_generation(qs[0])
    tb, tf = teng._prepare_generation(qs[0])
    assert tf.shape == (1, BUDGET, 64) and tb.images is None
    np.testing.assert_array_equal(tb.kind.numpy(), np.asarray(jb.kind))
    np.testing.assert_allclose(tf.numpy(), np.asarray(jf), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_array_equal(teng._generate(tb, tf).tokens.numpy(),
                                  np.asarray(jeng._generate(jb, jf).tokens))
    assert [teng.generate_answer(q) for q in qs] == \
        [jeng.generate_answer(q) for q in qs]


def test_caches_stay_off_and_beams_match_jax(data, jparams):
    """Scene and prefix caches asked for: neither stores a llava3d scene
    (both packages); beam search answers as JAX's."""
    jeng, teng, qs = _engines(data, jparams, scene_cache_scenes=2,
                              prefix_cache_scenes=2)
    want = [jeng.generate_answer(q) for q in qs]
    assert [teng.generate_answer(q) for q in qs] == want
    assert teng.scene_cache_stats == jeng.scene_cache_stats == [0, 0]
    assert teng.prefix_cache_stats == jeng.prefix_cache_stats == [0, 0]
    assert not teng._prefix_cache
    jeng, teng, qs = _engines(data, jparams, num_beams=2)
    assert teng.generate_answer(qs[0]) == jeng.generate_answer(qs[0])


@pytest.mark.parametrize("paged", [False, True])
def test_batchers_match_jax(data, jparams, paged):
    """The continuous batcher prepares llava3d requests through the same
    path; the port stores no prefix for them (JAX stores one it cannot
    read back correctly, so its requests here are all misses too)."""
    jeng, teng, qs = _engines(data, jparams, prefix_cache_scenes=2)
    for q in qs:
        teng._tokenize_prompt(q)
    kw = dict(paged=True, page_size=8) if paged else {}
    answers = []
    for make, e in ((ContinuousBatcher, teng), (JaxBatcher, jeng)):
        b = make(e, num_slots=2, chunk=2, **kw)
        try:
            hs = [b.submit(q) for q in qs]
            answers.append([h.result(e._decode_text, timeout=300)
                            for h in hs])
        finally:
            b.shutdown()
    assert answers[0] == answers[1]
    assert not teng._prefix_cache


def test_batched_and_grounding_refused(data, jparams):
    """JAX's batched path lays a llava3d scene out as the grid (the
    variant ignored: V * tokens_per_frame vision slots, not the budget)
    and its grounding scores every object NaN; the port refuses both."""
    jeng, teng, qs = _engines(data, jparams, ground_token_id=301,
                              max_objects=8)
    jbatch = jeng.prepare_answers_batch(qs)
    kinds = np.asarray(jbatch.kind)
    assert (kinds[0] == 2).sum() == 3 * CFG.tokens_per_frame != BUDGET
    rec = {"id": "g", "video": qs[0]["video"],
           "conversations": [{"from": "human",
                              "value": "<image>\nfind the chair"},
                             {"from": "gpt", "value": "<ground>"}]}
    scores, objects = jeng.ground(rec)
    # every object's score (the last entry scores the zero target)
    assert np.isnan(np.asarray(scores)[:len(objects)]).all()
    for call in (lambda: teng.generate_answers_batch(qs),
                 lambda: teng.generate_answers_batch_prefix(qs),
                 lambda: teng.ground(rec),
                 lambda: teng.ground_batch([rec])):
        with pytest.raises(ValueError, match="llava3d"):
            call()


def test_collator_matches_jax(data):
    """Training lays a llava3d scene out as the grid in both packages."""
    root, info, dc = data
    ann = make_fake_annotations(root, info["sample_idx"], n=2)
    ds = jds.SupervisedDataset(ann, FakeTokenizer(), dc,
                               image_processor=SigLipImageProcessor(
                                   size=(56, 56)))
    samples = [ds[0], ds[1]]
    want = jds.Collator(CFG, jds.CollatorConfig(max_len=200,
                                                frames_upbound=3))(samples)
    got = tds.Collator(port_config(CFG), tds.CollatorConfig(
        max_len=200, frames_upbound=3))(samples)
    for k in want:
        if want[k] is not None:
            np.testing.assert_array_equal(np.asarray(got[k]),
                                          np.asarray(want[k]), err_msg=k)
