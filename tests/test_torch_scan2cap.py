"""Scan2Cap's ``<coord>`` box input on the port's answer path against the
JAX package's on the CPU (``ModelConfig.tiny()``, float32, the JAX init's
weights through ``from_jax_params``): the box discretization, the
prefill and suffix logits with the box PE, and ``run_scan2cap``'s token
ids with the prefix cache off and on, alone and in batches."""

import json
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
from video3d_tpu.models import generate as jgen
from video3d_tpu.models import llava_video3d as jlv
from video3d_tpu_torch.data.image_processor import \
    SigLipImageProcessor as TSigLipImageProcessor
from video3d_tpu_torch.data.video_processor import \
    VideoProcessor as TVideoProcessor
from video3d_tpu_torch.eval import drivers as tdrv
from video3d_tpu_torch.models import generate as tgen
from video3d_tpu_torch.params import from_jax_params

from fixtures import FakeTokenizer, make_fake_scene
from port_configs import port_config

torch.set_num_threads(1)

CFG = ModelConfig.tiny()
TCFG = port_config(CFG)
COORD = 302          # FakeTokenizer's <coord>


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("data"))
    infos = [make_fake_scene(root, scene_id=f"scene{i:04d}_00", n_frames=3,
                             extend=i > 0, seed=i) for i in range(2)]
    data_cfg = DataConfig(video_folder=root,
                          annotation_dir=os.path.join(root, "embodiedscan"),
                          metadata_dir=os.path.join(root, "metadata"),
                          frames_upbound=3)
    return infos, data_cfg, jlv.init_model(jax.random.PRNGKey(0), CFG)


def _engines(scene, **kw):
    _, data_cfg, params = scene
    out = []
    for module in (tdrv, jdrv):
        tok = FakeTokenizer()
        ecfg = module.EngineConfig(
            max_new_tokens=4, eos_token_id=tok.eos_token_id, max_frames=3,
            buckets=(256,), stop_str="", suffix_buckets=(32, 64), **kw)
        if module is tdrv:
            out.append(tdrv.InferenceEngine(
                from_jax_params(jax.tree.map(np.asarray, params), TCFG,
                                device="cpu"), TCFG, tok,
                TVideoProcessor(port_config(data_cfg)),
                TSigLipImageProcessor(size=(CFG.vision.image_size,) * 2),
                ecfg, device="cpu"))
        else:
            out.append(jdrv.InferenceEngine(
                params, CFG, tok, VideoProcessor(data_cfg),
                SigLipImageProcessor(size=(CFG.vision.image_size,) * 2),
                ecfg, device_geometry=True))
    return out


def _caption(info, i, box=None):
    return {
        "id": f"c{i}", "video": info["sample_idx"],
        "box_input": list(info["boxes"][i % 3][:3] if box is None else box)
        + [0.5, 0.5, 0.5],
        "conversations": [
            {"from": "human", "value": "<image>\nDescribe the object at "
                                       f"<coord> {'briefly ' * (i % 2)}."},
            {"from": "gpt", "value": "a chair"}],
        "annotations": [f"a brown chair {i}", "a wooden chair"],
        "metadata": {"dataset": "scan2cap"}}


def test_discretize_box_matches_jax(scene):
    te, je = _engines(scene)
    for box in ([0.3, -1.26, 0.55], [20.0, -30.0, 9.0], [0.05, 0.15, -0.25]):
        b = np.asarray(box, np.float32)
        np.testing.assert_array_equal(te._discretize_box(b),
                                      je._discretize_box(b))


def test_box_input_reaches_the_prefill_logits(scene):
    """The full prefill of a <coord> question: the port's next logits equal
    JAX's (1e-4) with the box PE at the <coord> slot, and moving the box
    1 m moves them."""
    infos = scene[0]
    te, je = _engines(scene)
    q = _caption(infos[0], 0)
    box = np.asarray(q["box_input"][:3], np.float32)
    te._tokenize_prompt(q)
    je._tokenize_prompt(q)
    tb, tvf = te._prepare_generation(q, box, COORD)
    jb, jvf = je._prepare_generation(q, box, COORD)
    assert int(tb.coord_mask.sum()) == 1 and tb.box_input is not None
    tl, _, _ = tgen.prefill_multimodal(te.params, TCFG, tb, 300, tvf,
                                       torch.float32)
    jl, _, _ = jgen.prefill_multimodal(je.params, CFG, jb, 300, jnp.float32,
                                       jvf)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=0,
                               atol=1e-4)
    moved, _ = te._prepare_generation(q, box + np.float32(1.0), COORD)
    ml, _, _ = tgen.prefill_multimodal(te.params, TCFG, moved, 300, None,
                                       torch.float32)
    assert float((ml - tl).abs().max()) > 1e-3


@pytest.mark.parametrize("prefix", [0, 2])
@pytest.mark.parametrize("batch_size", [1, 2])
def test_run_scan2cap_matches_jax(scene, tmp_path, prefix, batch_size):
    """Five captions over two scenes: the jsonl records (token ids decoded,
    the annotations as ground truth) equal the JAX engine's, with the
    prefix cache off and on (the suffix batches carry their rows' boxes)."""
    infos = scene[0]
    qs = [_caption(infos[s], i) for i, s in enumerate((0, 0, 1, 0, 1))]
    te, je = _engines(scene, prefix_cache_scenes=prefix)
    for q in qs:                   # one word order for both tokenizers
        te._tokenize_prompt(q)
        je._tokenize_prompt(q)
    times = tdrv.run_scan2cap(te, qs, str(tmp_path / "t.jsonl"), COORD,
                              batch_size=batch_size)
    jdrv.run_generative(je, qs, str(tmp_path / "j.jsonl"),
                        gt_from_annotations=True, coord_token_id=COORD,
                        batch_size=batch_size)
    assert len(times) == len(qs)
    assert te.prefix_cache_stats == je.prefix_cache_stats

    def read(name):
        with open(tmp_path / name) as f:
            return [json.loads(line) for line in f]

    got, want = read("t.jsonl"), read("j.jsonl")
    assert got == want and len(got) == len(qs)
    assert {r["sample_id"]: r["gt_response"] for r in got} == \
        {q["id"]: q["annotations"] for q in qs}


def test_suffix_hit_matches_full_prefill(scene):
    """A B=1 prefix hit with a box: its suffix batch carries the
    discretized box, and its first-step logits are the full prefill's of
    the same question within 2e-3 (the suffix attends the prefix as
    stored in the bf16 cache, the full prefill its f32 K/V)."""
    infos = scene[0]
    te, _ = _engines(scene, prefix_cache_scenes=2)
    q0, q1 = _caption(infos[0], 0), _caption(infos[0], 1)
    te.generate_answer(q0, np.asarray(q0["box_input"][:3]), COORD)
    box = np.asarray(q1["box_input"][:3], np.float32)
    prep = te.prepare_request(q1, box, COORD)
    assert prep["mode"] == "prefix"
    np.testing.assert_array_equal(prep["batch"].box_input.numpy()[0],
                                  te._discretize_box(box))
    state = te.start_request(prep)
    full, vf = te._prepare_generation(q1, box, COORD)
    ref, _, _ = tgen.prefill_multimodal(te.params, TCFG, full, 300, vf,
                                        torch.bfloat16)
    np.testing.assert_allclose(state.next_logits.numpy(), ref.numpy(),
                               rtol=0, atol=2e-3)
