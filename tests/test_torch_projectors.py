"""The port's mm projector variants against the JAX package on the CPU:
``project_features`` of every variant (identity, linear, mlpNx_gelu,
mlpNx_resMx_gelu, the pooler at an even and an odd patch grid) to 1e-5
relative in f32, ``init_projector``'s keys, shapes and dtypes, and
``from_jax_params`` / ``init_model`` carrying the res blocks and the
pooler's convolution. On ``ModelConfig.tiny()``: the engine's greedy ids
of a res projector and of an identity projector (tower width = LLM width)
equal to the JAX engine's, and the pooler and a width-changing identity,
which JAX's video path cannot run, refused by the port's engine and
Trainer with a ValueError."""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from video3d_tpu.config import (DataConfig, ModelConfig, ProjectorConfig,
                                VisionConfig, replace)
from video3d_tpu.data.image_processor import SigLipImageProcessor
from video3d_tpu.data.video_processor import VideoProcessor
from video3d_tpu.eval import drivers as jdrv
from video3d_tpu.models import llava_video3d as jlv
from video3d_tpu_torch.data.image_processor import \
    SigLipImageProcessor as TSigLipImageProcessor
from video3d_tpu_torch.data.video_processor import \
    VideoProcessor as TVideoProcessor
from video3d_tpu_torch.eval import drivers as tdrv
from video3d_tpu_torch.models import llava_video3d as tlv
from video3d_tpu_torch.params import from_jax_params, init_model
from video3d_tpu_torch.train.optim import OptimConfig
from video3d_tpu_torch.train.trainer import Trainer, TrainingConfig

from fixtures import FakeTokenizer, make_fake_scene
from port_configs import port_config

torch.set_num_threads(1)

TYPES = ("identity", "linear", "mlp2x_gelu", "mlp3x_gelu", "mlp2x_res2x_gelu",
         "mlp1x_res1x_gelu", "pooler")


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def _jax_projector(ptype, cin=8, cout=16, seed=0):
    p = jlv.init_projector(jax.random.PRNGKey(seed), cin, cout,
                           projector_type=ptype)
    # non-trivial biases and LayerNorms, so every leaf counts
    rng = np.random.default_rng(seed)
    return jax.tree.map(
        lambda a: np.asarray(a) + 0.1 * rng.standard_normal(a.shape).astype(
            np.float32), p)


@pytest.mark.parametrize("ptype", TYPES)
def test_project_features_matches_jax(ptype):
    p = _jax_projector(ptype, cout=8 if ptype == "identity" else 16)
    hw = 5 if ptype == "pooler" else 3
    x = np.random.default_rng(1).standard_normal((2, hw * hw, 8)) \
        .astype(np.float32)
    want = np.asarray(jlv.project_features(
        jax.tree.map(jnp.asarray, p), jnp.asarray(x)))
    got = tlv.project_features(
        jax.tree.map(torch.from_numpy, p), torch.from_numpy(x))
    assert got.shape == want.shape
    assert _rel(got.numpy(), want) < 1e-5


@pytest.mark.parametrize("hw", [4, 5, 27])
def test_pooler_grids_match_jax(hw):
    """An even grid, an odd one (its last row and column dropped) and the
    so400m tower's 27 x 27 (13 x 13 out)."""
    p = _jax_projector("pooler", cin=6, cout=10, seed=hw)
    x = np.random.default_rng(hw).standard_normal((3, hw * hw, 6)) \
        .astype(np.float32)
    want = np.asarray(jlv.project_features(
        jax.tree.map(jnp.asarray, p), jnp.asarray(x)))
    got = tlv.project_features(jax.tree.map(torch.from_numpy, p),
                               torch.from_numpy(x))
    assert got.shape == want.shape == (3, (hw // 2) ** 2, 10)
    assert _rel(got.numpy(), want) < 1e-5


def test_res_block_normalizes_in_f32_and_casts_back():
    """bf16 input: the statistics in f32, the normalized input cast to
    bf16 before the affine, as JAX's ``_layer_norm``."""
    p = _jax_projector("mlp1x_res1x_gelu")
    x = np.random.default_rng(2).standard_normal((1, 9, 8)).astype(np.float32)
    pb = jax.tree.map(lambda a: jnp.asarray(a, jnp.bfloat16), p)
    want = np.asarray(jlv.project_features(
        pb, jnp.asarray(x, jnp.bfloat16)).astype(jnp.float32))
    tp = jax.tree.map(lambda a: torch.from_numpy(a).to(torch.bfloat16), p)
    got = tlv.project_features(tp, torch.from_numpy(x).to(torch.bfloat16))
    assert got.dtype == torch.bfloat16
    assert _rel(got.float().numpy(), want) < 2e-2


def _shapes(tree):
    if isinstance(tree, dict):
        return {k: _shapes(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_shapes(v) for v in tree]
    return tuple(tree.shape)


@pytest.mark.parametrize("ptype", TYPES)
def test_init_projector_shapes_match_jax(ptype):
    want = jlv.init_projector(jax.random.PRNGKey(0), 8, 16,
                              projector_type=ptype)
    got = tlv.init_projector(8, 16, "cpu", torch.Generator().manual_seed(0),
                             projector_type=ptype)
    assert _shapes(got) == _shapes(want)
    for leaf in jax.tree.leaves(got):
        assert leaf.dtype == torch.float32
    if ptype == "mlp2x_res2x_gelu":
        assert torch.equal(got["res"][1]["ln_s"], torch.ones(16))


def test_init_projector_unknown_type():
    with pytest.raises(ValueError):
        tlv.init_projector(8, 16, "cpu", torch.Generator(),
                           projector_type="mlp2x_relu")
    with pytest.raises(ValueError):
        jlv.init_projector(jax.random.PRNGKey(0), 8, 16,
                           projector_type="mlp2x_relu")


@pytest.mark.parametrize("ptype", ["mlp2x_res2x_gelu", "pooler"])
def test_from_jax_params_and_init_model_carry_variants(ptype):
    cfg = replace(ModelConfig.tiny(), projector=ProjectorConfig(ptype))
    jp = jax.tree.map(np.asarray, jlv.init_model(jax.random.PRNGKey(0), cfg))
    tp = from_jax_params(jp, port_config(cfg), device="cpu")
    assert _shapes(tp["projector"]) == _shapes(jp["projector"])
    for a, b in zip(jax.tree.leaves(tp["projector"]),
                    jax.tree.leaves(jp["projector"])):
        assert np.array_equal(a.numpy(), b)
    mine = init_model(port_config(cfg), "cpu",
                      torch.Generator().manual_seed(0), torch.float32)
    assert _shapes(mine["projector"]) == _shapes(jp["projector"])


# ----------------------------------------------------------------------
# the engine and the Trainer
# ----------------------------------------------------------------------

@pytest.fixture(scope="module")
def data(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("data"))
    info = make_fake_scene(root, n_frames=2)
    dc = DataConfig(video_folder=root,
                    annotation_dir=os.path.join(root, "embodiedscan"),
                    metadata_dir=os.path.join(root, "metadata"),
                    frames_upbound=2)
    return info, dc


def _cfg(ptype, width=None):
    cfg = replace(ModelConfig.tiny(), projector=ProjectorConfig(ptype))
    if width is not None:
        cfg = replace(cfg, vision=VisionConfig(
            hidden_size=width, intermediate_size=64, num_hidden_layers=2,
            num_attention_heads=4, image_size=56, patch_size=14))
    return cfg


def _engines(data, cfg):
    info, dc = data
    tok = FakeTokenizer()
    kw = dict(max_new_tokens=6, eos_token_id=tok.eos_token_id, max_frames=2,
              buckets=(256,), stop_str="", prefix_cache_scenes=2,
              suffix_buckets=(32, 64))
    jp = jax.tree.map(np.asarray, jlv.init_model(jax.random.PRNGKey(0), cfg))
    jeng = jdrv.InferenceEngine(
        jax.tree.map(jnp.asarray, jp), cfg, tok, VideoProcessor(dc),
        SigLipImageProcessor(size=(56, 56)), jdrv.EngineConfig(**kw),
        device_geometry=True)
    teng = tdrv.InferenceEngine(
        from_jax_params(jp, port_config(cfg), device="cpu"),
        port_config(cfg), tok, TVideoProcessor(port_config(dc)),
        TSigLipImageProcessor(size=(56, 56)), tdrv.EngineConfig(**kw),
        device="cpu")
    qs = [{"id": f"q{i}", "video": info["sample_idx"],
           "conversations": [{"from": "human", "value": f"<image>\n{t}"},
                             {"from": "gpt", "value": "brown"}]}
          for i, t in enumerate(("what color is the chair",
                                 "how many tables are there"))]
    return jeng, teng, qs


@pytest.mark.parametrize("ptype,width", [("mlp2x_res2x_gelu", None),
                                         ("identity", 64)])
def test_engine_answers_match_jax(data, ptype, width):
    """A miss then a prefix hit: token ids equal to the JAX engine's."""
    jeng, teng, qs = _engines(data, _cfg(ptype, width))
    for q in qs:
        jres = jeng._generate(*jeng._prepare_generation(q))
        tres = teng._generate(*teng._prepare_generation(q))
        np.testing.assert_array_equal(tres.tokens.numpy(),
                                      np.asarray(jres.tokens))
        assert teng.generate_answer(q) == jeng.generate_answer(q)
    assert teng.prefix_cache_stats == jeng.prefix_cache_stats == [1, 1]


@pytest.mark.parametrize("ptype,width", [("pooler", None),
                                         ("identity", None)])
def test_unrunnable_projectors_refused_as_jax_fails(data, ptype, width):
    """JAX's video path fails on the pooler (its halved grid cannot be
    pooled as the patch grid) and on an identity projector from the
    32-wide tower into the 64-wide LLM; the port refuses both in the
    engine's and the Trainer's constructors."""
    info, dc = data
    cfg = _cfg(ptype, width)
    jp = jlv.init_model(jax.random.PRNGKey(0), cfg)
    images = jnp.zeros((1, 2, 3, 56, 56), jnp.float32)
    coords = jnp.zeros((1, 2, 2, 2, 3), jnp.float32)
    with pytest.raises((TypeError, ValueError)):
        jlv.encode_video(jp, cfg, images, coords)
    tcfg = port_config(cfg)
    tp = init_model(tcfg, "cpu", torch.Generator().manual_seed(0),
                    torch.float32)
    with pytest.raises(ValueError, match=ptype):
        tdrv.InferenceEngine(tp, tcfg, FakeTokenizer(),
                             TVideoProcessor(port_config(dc)),
                             engine_cfg=tdrv.EngineConfig(), device="cpu")
    with pytest.raises(ValueError, match=ptype):
        Trainer(tcfg, tp, [], None, OptimConfig(),
                TrainingConfig(output_dir=str(data[1].video_folder)),
                device="cpu")
