"""The port's model builder against the JAX package's, on the CPU: every
family's config.json parsed as JAX parses it; ``load_pretrained_model``'s
three branches (a full checkpoint, projector-only over ``model_base``,
LoRA over ``model_base``) on directories the tests write, leaf for leaf
with JAX's loads; the export round trip bit for bit (bf16 -> f32 -> bf16);
greedy ids of an engine on the loaded model equal to the JAX engine's on
JAX's load of the same directory; ``load_dummy_model``; and the refusals
(no card without ``device``, an attention width that is not the hidden
size)."""

import json
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from video3d_tpu.config import DataConfig, ModelConfig, VisionConfig, replace
from video3d_tpu.data.image_processor import SigLipImageProcessor
from video3d_tpu.data.video_processor import VideoProcessor
from video3d_tpu.eval import drivers as jdrv
from video3d_tpu.models import builder as jb
from video3d_tpu_torch.data.image_processor import \
    SigLipImageProcessor as TSigLipImageProcessor
from video3d_tpu_torch.data.video_processor import \
    VideoProcessor as TVideoProcessor
from video3d_tpu_torch.eval import drivers as tdrv
from video3d_tpu_torch.models import builder as tb
from video3d_tpu_torch.models import quant as tquant
from video3d_tpu_torch.models import weights as tw
from video3d_tpu_torch.params import init_model

from fixtures import FakeTokenizer, make_fake_scene
from port_configs import port_config
from test_builder import build_fake_checkpoint
import test_builder_branches

torch.set_num_threads(1)

FAMILIES = {
    "qwen2": {"model_type": "qwen2", "vocab_size": 100, "hidden_size": 64,
              "intermediate_size": 96, "num_hidden_layers": 2,
              "num_attention_heads": 4, "num_key_value_heads": 2},
    "llama": {"model_type": "llama", "vocab_size": 100, "hidden_size": 64,
              "intermediate_size": 96, "num_hidden_layers": 2,
              "num_attention_heads": 4},
    "mistral": {"model_type": "mistral", "vocab_size": 100,
                "hidden_size": 64, "intermediate_size": 96,
                "num_hidden_layers": 2, "num_attention_heads": 4,
                "rope_theta": 1e6},
    "mixtral": {"model_type": "mixtral", "vocab_size": 100,
                "hidden_size": 64, "intermediate_size": 96,
                "num_hidden_layers": 2, "num_attention_heads": 4,
                "num_local_experts": 4, "num_experts_per_tok": 2},
    "qwen2_moe": {"model_type": "qwen2_moe", "vocab_size": 100,
                  "hidden_size": 64, "intermediate_size": 96,
                  "moe_intermediate_size": 32,
                  "shared_expert_intermediate_size": 48,
                  "num_hidden_layers": 2, "num_attention_heads": 4},
    "gemma": {"model_type": "gemma", "vocab_size": 100, "hidden_size": 64,
              "intermediate_size": 96, "num_hidden_layers": 2,
              "num_attention_heads": 4, "head_dim": 32,
              "hidden_activation": "gelu_pytorch_tanh"},
    "mpt": {"model_type": "mpt", "vocab_size": 100, "d_model": 64,
            "n_heads": 4, "n_layers": 2, "expansion_ratio": 4,
            "attn_config": {"alibi_bias_max": 4.0}},
}


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_configs_parse_as_jax(family):
    hf = dict(FAMILIES[family], world_position_embedding_type=
              "sample1-discrete-mrope", voxel_size=0.2,
              object_feature_type="patch27", ground_head_type="mlp",
              image_grid_pinpoints=[[384, 768], [768, 384]])
    assert tb.model_config_from_hf(hf) == \
        port_config(jb.model_config_from_hf(hf))
    assert tb.llm_config_from_hf(hf) == port_config(jb.llm_config_from_hf(hf))


def test_llava3d_string_parses():
    cfg = tb.model_config_from_hf(dict(
        FAMILIES["qwen2"], world_position_embedding_type="avg-discrete-llava3d"))
    assert cfg.world_3d.llava3d and cfg.world_3d.pos_embed.value == "none"


def _leaves_equal(t, j, path="", rtol=0.0):
    if isinstance(j, dict):
        assert set(t) == set(j), path
        for k in j:
            _leaves_equal(t[k], j[k], f"{path}/{k}", rtol)
    elif isinstance(j, (list, tuple)):
        assert len(t) == len(j), path
        for i, (a, b) in enumerate(zip(t, j)):
            _leaves_equal(a, b, f"{path}/{i}", rtol)
    else:
        want = np.asarray(j, np.float32)
        got = t.float().numpy()
        if rtol:
            np.testing.assert_allclose(got, want, rtol=rtol, atol=rtol,
                                       err_msg=path)
        else:
            np.testing.assert_array_equal(got, want, err_msg=path)


@pytest.fixture(scope="module")
def base(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("base") / "ckpt")
    build_fake_checkpoint(path)
    with open(os.path.join(path, "config.json")) as f:
        return path, json.load(f)


def test_full_checkpoint_matches_jax(base):
    path, _ = base
    _, jp, jcfg, jlen = jb.load_pretrained_model(path, dtype=jnp.float32,
                                                 load_tokenizer=False)
    tok, tp, tcfg, tlen = tb.load_pretrained_model(
        path, dtype=torch.float32, load_tokenizer=False, device="cpu")
    assert tok is None and tlen == jlen == 4096
    assert tcfg == port_config(jcfg)
    _leaves_equal(tp, jax.tree.map(np.asarray, jp))
    assert set(tp["ground_head"]) == {"obj", "query", "zero_target"}


def test_projector_only_branch_matches_jax(base, tmp_path):
    path, cfg = base
    proj = str(tmp_path / "projector_ckpt")
    os.makedirs(proj)
    with open(os.path.join(proj, "config.json"), "w") as f:
        json.dump(cfg, f)
    g = torch.Generator().manual_seed(7)
    torch.save({"model.mm_projector.0.weight": torch.randn(32, 24, generator=g),
                "model.mm_projector.0.bias": torch.randn(32, generator=g),
                "model.mm_projector.2.weight": torch.randn(32, 32, generator=g),
                "model.mm_projector.2.bias": torch.randn(32, generator=g)},
               os.path.join(proj, "mm_projector.bin"))
    _, jp, _, _ = jb.load_pretrained_model(proj, model_base=path,
                                           dtype=jnp.float32,
                                           load_tokenizer=False)
    _, tp, _, _ = tb.load_pretrained_model(proj, model_base=path,
                                           dtype=torch.float32,
                                           load_tokenizer=False,
                                           device="cpu")
    _leaves_equal(tp, jax.tree.map(np.asarray, jp))


def test_lora_branch_matches_jax(base, tmp_path):
    """peft adapters in ``adapter_model.safetensors`` (read by the port's
    reader) merged into the base, non-LoRA trainables laid over it."""
    path, cfg = base
    lora_dir, _, _, _ = test_builder_branches.TestLoraBranch()._make_lora_dir(tmp_path, cfg)
    _, jp, _, _ = jb.load_pretrained_model(lora_dir, model_base=path,
                                           dtype=jnp.float32,
                                           load_tokenizer=False)
    _, tp, _, _ = tb.load_pretrained_model(lora_dir, model_base=path,
                                           dtype=torch.float32,
                                           load_tokenizer=False,
                                           device="cpu")
    _leaves_equal(tp, jax.tree.map(np.asarray, jp), rtol=1e-6)
    with pytest.raises(Exception):
        tb.load_pretrained_model(lora_dir, dtype=torch.float32,
                                 load_tokenizer=False, device="cpu")
    with pytest.raises(KeyError):
        tb.merge_lora_into_state({}, lora_dir)


def test_strip_wrapper_prefixes_matches_jax():
    sd = {"base_model.model.model.mm_projector.0.weight": 1,
          "base_model.model.lm_head.weight": 2, "other": 3}
    assert tb._strip_wrapper_prefixes(sd) == jb._strip_wrapper_prefixes(sd)


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_export_round_trip_bit_for_bit(tmp_path, dtype):
    """init_model -> export (f32 safetensors + config.json) ->
    load_pretrained_model: every leaf equal to the original, and the
    configuration's knobs back."""
    cfg = replace(port_config(ModelConfig.tiny()),
                  vision=port_config(VisionConfig(
                      hidden_size=32, intermediate_size=64,
                      num_hidden_layers=2, num_attention_heads=4,
                      image_size=56, patch_size=14)))
    dt = getattr(torch, dtype)
    params = init_model(cfg, "cpu", torch.Generator().manual_seed(0), dt)
    out = str(tmp_path / "export")
    tw.export_llava_checkpoint(params, cfg.llm, cfg, out)
    _, loaded, lcfg, _ = tb.load_pretrained_model(
        out, dtype=dt, load_tokenizer=False, device="cpu",
        vision_config=cfg.vision)
    assert lcfg.world_3d == cfg.world_3d and lcfg.llm == cfg.llm

    def same(a, b, path=""):
        if isinstance(a, dict):
            assert set(a) == set(b), path
            for k in a:
                same(a[k], b[k], f"{path}/{k}")
        elif isinstance(a, list):
            for i, (x, y) in enumerate(zip(a, b)):
                same(x, y, f"{path}/{i}")
        else:
            assert a.dtype == b.dtype and torch.equal(a, b), path

    same(loaded, params)


def test_engine_on_a_loaded_model_matches_jax(tmp_path):
    """A tiny model exported by JAX to a directory: the port's load of it
    and JAX's load of it answer alike (f32)."""
    from video3d_tpu.models import llava_video3d as jlv
    from video3d_tpu.models.weights import export_llava_checkpoint

    path = str(tmp_path / "export")
    mc = replace(ModelConfig.tiny(), vision=VisionConfig(
        hidden_size=32, intermediate_size=64, num_hidden_layers=2,
        num_attention_heads=4, image_size=56, patch_size=14))
    export_llava_checkpoint(jlv.init_model(jax.random.PRNGKey(0), mc),
                            mc.llm, mc, path)
    root = str(tmp_path / "data")
    info = make_fake_scene(root, n_frames=2)
    dc = DataConfig(video_folder=root,
                    annotation_dir=os.path.join(root, "embodiedscan"),
                    metadata_dir=os.path.join(root, "metadata"),
                    frames_upbound=2)
    _, jp, jcfg, _ = jb.load_pretrained_model(
        path, dtype=jnp.float32, load_tokenizer=False,
        vision_config=mc.vision)
    _, tp, tcfg, _ = tb.load_pretrained_model(
        path, dtype=torch.float32, load_tokenizer=False, device="cpu",
        vision_config=port_config(mc.vision))
    assert tcfg == port_config(jcfg)
    tok = FakeTokenizer()
    kw = dict(max_new_tokens=5, eos_token_id=tok.eos_token_id, max_frames=2,
              buckets=(256,), stop_str="")
    S = jcfg.vision.image_size
    jeng = jdrv.InferenceEngine(jp, jcfg, tok, VideoProcessor(dc),
                                SigLipImageProcessor(size=(S, S)),
                                jdrv.EngineConfig(**kw),
                                device_geometry=True)
    teng = tdrv.InferenceEngine(tp, tcfg, tok,
                                TVideoProcessor(port_config(dc)),
                                TSigLipImageProcessor(size=(S, S)),
                                tdrv.EngineConfig(**kw), device="cpu")
    q = {"id": "q0", "video": info["sample_idx"],
         "conversations": [{"from": "human",
                            "value": "<image>\nwhat color is the chair"},
                           {"from": "gpt", "value": None}]}
    jres = jeng._generate(*jeng._prepare_generation(q))
    tres = teng._generate(*teng._prepare_generation(q))
    np.testing.assert_array_equal(tres.tokens.numpy(),
                                  np.asarray(jres.tokens))


def test_load_dummy_model(base, tmp_path):
    path, cfg = base
    d = tmp_path / "dummy"
    d.mkdir()
    cfg = dict(cfg, vision_config={
        "hidden_size": 32, "intermediate_size": 64, "num_hidden_layers": 2,
        "num_attention_heads": 4, "image_size": 56, "patch_size": 14})
    (d / "config.json").write_text(json.dumps(cfg))
    tok, p, mc = tb.load_dummy_model(str(d), bits=8, act="int8",
                                     load_tokenizer=False, device="cpu",
                                     dtype=torch.float32)
    assert tok is None and mc.vision.hidden_size == 32
    assert mc == port_config(jb.load_dummy_model(str(d),
                                                 load_tokenizer=False)[2])
    assert isinstance(p["llm"]["lm_head"], tquant.W8A8Weight)
    assert p["llm"]["embed_tokens"].shape == (160, 32)


def test_refusals(base, tmp_path):
    """No card without ``device``; a decoder whose attention width is not
    its hidden size (JAX's reshape fails) raises a ValueError. Another
    family's config over the checkpoint and resampler keys now load, as
    in JAX."""
    path, cfg = base
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tb.load_pretrained_model(path, load_tokenizer=False)
    with pytest.raises(ValueError, match="hidden size"):
        tb.load_pretrained_model(path, load_tokenizer=False, device="cpu",
                                 overwrite_config={"head_dim": 32})
    _, p, mc, _ = tb.load_pretrained_model(
        path, load_tokenizer=False, device="cpu",
        overwrite_config={"model_type": "llama"})
    assert mc.llm.rope_theta == 1e4 and "bq" in p["llm"]["layers"][0]["attn"]
    rs = tmp_path / "resampler"
    rs.mkdir()
    (rs / "config.json").write_text(json.dumps(dict(
        cfg, mm_resampler_type="spatial_pool")))
    state = tw.load_safetensors_dir(path)
    state["model.vision_resampler.pool.weight"] = torch.zeros(2, 2, 2, 2)
    state["model.vision_resampler.pool.bias"] = torch.zeros(2)
    tw.write_safetensors(state, str(rs / "model.safetensors"))
    _, p, _, _ = tb.load_pretrained_model(str(rs), load_tokenizer=False,
                                          device="cpu")
    assert p["resampler"]["conv_w"].shape == (8, 2)
