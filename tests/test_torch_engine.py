"""End to end: the port's InferenceEngine against the JAX engine
(``device_geometry=True``) on the synthetic scene with the fake tokenizer,
tiny model in float32. Greedy token ids and the jsonl answers must be
identical. Also: the port runs without importing JAX, and its entry
points default to the card."""

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
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def engine_kwargs(tok):
    return dict(max_new_tokens=8, eos_token_id=tok.eos_token_id,
                max_frames=3, buckets=(256,), stop_str="")


def questions(info):
    return [{
        "id": f"q{i}",
        "video": info["sample_idx"],
        "conversations": [
            {"from": "human", "value": f"<image>\nwhat color is chair {i}"},
            {"from": "gpt", "value": "brown"},
        ],
        "metadata": {"dataset": "scanqa", "question_type": "what"},
    } for i in range(2)]


@pytest.fixture(scope="module")
def engines(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("scene"))
    info = make_fake_scene(root, n_frames=3)
    data_cfg = DataConfig(video_folder=root,
                          annotation_dir=os.path.join(root, "embodiedscan"),
                          metadata_dir=os.path.join(root, "metadata"),
                          frames_upbound=3)
    tok = FakeTokenizer()
    ip = SigLipImageProcessor(size=(CFG.vision.image_size,) * 2)
    params = jlv.init_model(jax.random.PRNGKey(0), CFG)
    jax_engine = jdrv.InferenceEngine(
        params, CFG, tok, VideoProcessor(data_cfg), ip,
        jdrv.EngineConfig(**engine_kwargs(tok)), device_geometry=True)
    torch_engine = tdrv.InferenceEngine(
        from_jax_params(jax.tree.map(np.asarray, params), TCFG,
                        device="cpu"), TCFG, tok,
        TVideoProcessor(port_config(data_cfg)),
        TSigLipImageProcessor(size=(CFG.vision.image_size,) * 2),
        tdrv.EngineConfig(**engine_kwargs(tok)), device="cpu")
    return info, jax_engine, torch_engine


def test_greedy_tokens_identical(engines):
    info, jax_engine, torch_engine = engines
    for q in questions(info):
        jres = jax_engine._generate(*jax_engine._prepare_generation(q))
        tres = torch_engine._generate(*torch_engine._prepare_generation(q))
        np.testing.assert_array_equal(tres.tokens.numpy(),
                                      np.asarray(jres.tokens))
        np.testing.assert_array_equal(tres.lengths.numpy(),
                                      np.asarray(jres.lengths))


def test_scanqa_records_identical(engines, tmp_path):
    info, jax_engine, torch_engine = engines
    qs = questions(info)
    jdrv.run_scanqa(jax_engine, qs, str(tmp_path / "jax.jsonl"))
    times = tdrv.run_scanqa(torch_engine, qs, str(tmp_path / "torch.jsonl"))
    assert len(times) == 2

    def read(name):
        with open(tmp_path / name) as f:
            return [json.loads(line) for line in f]

    assert read("torch.jsonl") == read("jax.jsonl")


def test_entry_points_default_to_the_card(engines):
    """``InferenceEngine`` and ``from_jax_params`` called without a device
    resolve to the first CUDA card, as ``Trainer`` does; without one they
    raise and never hand back a CPU engine or CPU parameters."""
    _, _, torch_engine = engines
    e = torch_engine
    tree = jax.tree.map(np.asarray, jlv.init_model(jax.random.PRNGKey(0),
                                                   CFG))
    if torch.cuda.is_available():
        engine = tdrv.InferenceEngine(e.params, TCFG, e.tokenizer, e.vp)
        assert engine.device == torch.device("cuda", 0)
        params = from_jax_params(tree, TCFG)
        assert params["llm"]["norm"].device == torch.device("cuda", 0)
        return
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tdrv.InferenceEngine(e.params, TCFG, e.tokenizer, e.vp)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        from_jax_params(tree, TCFG)


def test_port_runs_without_jax(tmp_path):
    """Import the port, answer one question with a tiny random model, and
    check that no JAX module was ever imported."""
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
                                    max_frames=2, buckets=(256,)),
            device="cpu")
        answer = engine.generate_answer({{
            "video": info["sample_idx"],
            "conversations": [{{"from": "human", "value": "what is it"}},
                              {{"from": "gpt", "value": "a chair"}}]}})
        assert isinstance(answer, str)
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
