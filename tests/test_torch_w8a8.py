"""w8a8 (int8 weights, dynamic int8 activations) of the port against the
JAX package on the CPU: ``matmul_w8a8`` to f32 rounding (int32 sums past
2^24 included, bf16 inputs, 3-D inputs), ``quantize_tree(act="int8")`` leaf
for leaf, ``init_model(bits=8, act="int8")``'s tree, ``matmul`` over a
``LoraAdapted`` w8a8 base, the QLoRA and permanent-merge refusals, the
card route's row padding and its refusal of sizes off a multiple of 8 (on
``meta`` tensors), the decode graphs' plan and form, and the engine's
answers on ``quantize_tree(act="int8")``'d tiny f32 weights token for token
with the JAX engine's."""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from video3d_tpu.config import DataConfig, LLMConfig, ModelConfig
from video3d_tpu.data.image_processor import SigLipImageProcessor
from video3d_tpu.data.video_processor import VideoProcessor
from video3d_tpu.eval import drivers as jdrv
from video3d_tpu.models import llava_video3d as jlv
from video3d_tpu.models import quant as jquant
from video3d_tpu.models import qwen2 as jqwen
from video3d_tpu_torch.data.image_processor import \
    SigLipImageProcessor as TSigLipImageProcessor
from video3d_tpu_torch.data.video_processor import \
    VideoProcessor as TVideoProcessor
from video3d_tpu_torch.eval import drivers as tdrv
from video3d_tpu_torch.kernels import _build
from video3d_tpu_torch.models import decode_graph
from video3d_tpu_torch.models import quant as tquant
from video3d_tpu_torch.params import _convert, from_jax_params, init_model
from video3d_tpu_torch.train import lora as tlora
from video3d_tpu_torch.train.qlora import check_qlora_base

from fixtures import FakeTokenizer, make_fake_scene
from port_configs import port_config

torch.set_num_threads(1)

CFG = ModelConfig.tiny()
TCFG = port_config(CFG)


def _w8a8(rng, in_, out):
    w = rng.standard_normal((in_, out)).astype(np.float32)
    jw = jquant.quantize_weight(jnp.asarray(w), act="int8")
    tw = tquant.quantize_weight(torch.from_numpy(w), act="int8")
    return jw, tw


@pytest.mark.parametrize("shape", [(1, 64), (5, 64), (2, 3, 64), (40, 128)])
def test_matmul_w8a8_matches_jax(shape):
    rng = np.random.default_rng(len(shape) * 10 + shape[0])
    jw, tw = _w8a8(rng, shape[-1], 24)
    x = (3 * rng.standard_normal(shape)).astype(np.float32)
    x.reshape(-1, shape[-1])[0, :4] = 0.0
    want = np.asarray(jquant.matmul_w8a8(jnp.asarray(x), jw.q, jw.scale))
    got = tquant.matmul_w8a8(torch.from_numpy(x), tw.q, tw.scale)
    assert got.dtype == torch.float32 and got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-7, atol=0)
    np.testing.assert_array_equal(tquant.matmul(torch.from_numpy(x),
                                                tw).numpy(), got.numpy())


def test_int32_sums_past_2_to_the_24():
    """2048 inputs at +-127 x 127: |sum| up to 3.3e7 > 2^24, exact in
    int32 before the f32 scale."""
    rng = np.random.default_rng(7)
    in_, out = 2048, 16
    q = np.full((in_, out), 127, np.int8)
    q[:, 1::2] = -127
    scale = np.full((1, out), 0.25, np.float32)
    x = np.full((3, in_), 5.0, np.float32)
    x[1] = rng.uniform(-5, 5, in_)
    jscale = jnp.asarray(scale, jnp.bfloat16)
    want = np.asarray(jquant.matmul_w8a8(jnp.asarray(x), jnp.asarray(q),
                                         jscale))
    got = tquant.matmul_w8a8(torch.from_numpy(x), torch.from_numpy(q),
                             torch.from_numpy(scale).to(torch.bfloat16))
    assert abs(float(want[0, 0])) > 2 ** 24 * 0.25 * 5 / 127
    np.testing.assert_array_equal(got.numpy(), want)


def test_bf16_input_matches_jax():
    rng = np.random.default_rng(3)
    jw, tw = _w8a8(rng, 64, 32)
    x = rng.standard_normal((4, 64)).astype(np.float32)
    want = jquant.matmul_w8a8(jnp.asarray(x, jnp.bfloat16), jw.q, jw.scale)
    got = tquant.matmul_w8a8(torch.from_numpy(x).to(torch.bfloat16), tw.q,
                             tw.scale)
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(
        got.float().numpy(), np.asarray(want.astype(jnp.float32)))


def test_quantize_tree_act_int8_leaf_for_leaf():
    jp = jqwen.init_qwen2(jax.random.PRNGKey(3), LLMConfig.tiny())
    tree = _convert(jax.tree.map(np.asarray, jp), "cpu", None)
    jq = jquant.quantize_tree({"llm": jp}, act="int8")["llm"]
    tq = tquant.quantize_tree({"llm": tree}, act="int8")["llm"]
    pairs = [(tq["lm_head"], jq["lm_head"])]
    for tl, jl in zip(tq["layers"], jq["layers"]):
        pairs += [(tl["attn"][k], jl["attn"][k]) for k in ("wq", "wk", "wv",
                                                           "wo")]
        pairs += [(tl["mlp"][k], jl["mlp"][k]) for k in ("w_gate", "w_up",
                                                         "w_down")]
        assert torch.equal(tl["attn"]["bq"], torch.from_numpy(
            np.asarray(jl["attn"]["bq"])))
    for t, j in pairs:
        assert isinstance(t, tquant.W8A8Weight)
        np.testing.assert_array_equal(t.q.numpy(), np.asarray(j.q))
        np.testing.assert_array_equal(
            t.scale.float().numpy(), np.asarray(j.scale.astype(jnp.float32)))
        assert t.scale.dtype == torch.bfloat16
    assert tquant.is_quantized(tq["lm_head"])
    assert not tquant.is_quantized(tq["embed_tokens"])
    again = tquant.quantize_tree({"llm": tq}, act="int8")
    assert again["llm"]["lm_head"] is tq["lm_head"]


def test_init_model_w8a8_tree():
    """What quantize_tree(act="int8") makes of the init: the same leaves
    quantized, the same types; the tower and the head's embeddings stay
    dense."""
    p = init_model(TCFG, "cpu", torch.Generator().manual_seed(0),
                   torch.float32, bits=8, act="int8")
    ref = tquant.quantize_tree(init_model(
        TCFG, "cpu", torch.Generator().manual_seed(0), torch.float32),
        act="int8")
    for a, b in ((p["llm"]["lm_head"], ref["llm"]["lm_head"]),
                 (p["llm"]["layers"][1]["mlp"]["w_down"],
                  ref["llm"]["layers"][1]["mlp"]["w_down"])):
        assert isinstance(a, tquant.W8A8Weight)
        assert a.q.shape == b.q.shape and a.scale.shape == b.scale.shape
    assert isinstance(p["vision"]["layers"][0]["attn"]["wq"], torch.Tensor)
    with pytest.raises(ValueError):
        init_model(TCFG, "cpu", torch.Generator(), bits=4, act="int8")


def test_vision_patterns_quantize_the_tower():
    p = init_model(TCFG, "cpu", torch.Generator().manual_seed(0),
                   torch.float32)
    q = tquant.quantize_tree(p, patterns=tquant.VISION_PATTERNS, act="int8")
    layer = q["vision"]["layers"][0]
    assert all(isinstance(layer["attn"][k], tquant.W8A8Weight)
               for k in ("wq", "wk", "wv", "wo"))
    assert isinstance(layer["mlp"]["w2"], tquant.W8A8Weight)
    assert isinstance(q["vision"]["patch_embed"]["w"], torch.Tensor)
    assert isinstance(q["llm"]["lm_head"], torch.Tensor)


def test_lora_adapted_over_w8a8_matches_jax():
    """JAX ``matmul`` of a LoraAdapted: the w8a8 base product plus the
    low-rank delta times the scale."""
    rng = np.random.default_rng(5)
    jw, tw = _w8a8(rng, 64, 32)
    A = rng.standard_normal((64, 4)).astype(np.float32)
    B = rng.standard_normal((4, 32)).astype(np.float32)
    x = rng.standard_normal((3, 64)).astype(np.float32)
    want = np.asarray(jquant.matmul(jnp.asarray(x), jquant.LoraAdapted(
        jw, jnp.asarray(A), jnp.asarray(B), 2.0)))
    got = tquant.matmul(torch.from_numpy(x), tquant.LoraAdapted(
        tw, torch.from_numpy(A), torch.from_numpy(B), 2.0))
    # the f32 delta's sums round apart by an ulp of the largest outputs
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=1e-6 * np.abs(want).max())
    # apply_lora wraps the w8a8 leaves; QLoRA and a permanent merge refuse
    base = tquant.quantize_tree(init_model(
        TCFG, "cpu", torch.Generator().manual_seed(0), torch.float32),
        act="int8")
    lcfg = tlora.LoraConfig(r=2, alpha=4)
    lora = tlora.init_lora(torch.Generator().manual_seed(1), base, lcfg)
    adapted = tlora.apply_lora(base, lora, lcfg)
    wq = adapted["llm"]["layers"][0]["attn"]["wq"]
    assert isinstance(wq, tquant.LoraAdapted)
    assert isinstance(wq.base, tquant.W8A8Weight)
    with pytest.raises(TypeError, match="W8A8Weight"):
        check_qlora_base(base)
    with pytest.raises(TypeError, match="w8a8"):
        tlora.merge_lora_into_params(base, lora, lcfg)


def test_card_route_pads_rows_and_counts(monkeypatch):
    """On a non-CPU tensor (``meta`` here) the product pads fewer than
    W8A8_MIN_ROWS rows, counts one ``torch._int_mm`` call, and refuses
    inner or outer sizes off a multiple of 8 (no float fallback)."""
    calls = []
    real = torch._int_mm

    def spy(a, b):
        calls.append(tuple(a.shape))
        return real(a, b)

    monkeypatch.setattr(torch, "_int_mm", spy)
    _build.reset_launches()
    q = torch.zeros(64, 24, dtype=torch.int8, device="meta")
    for rows in (1, 8, 17, 40):
        y = tquant._int_mm(torch.zeros(rows, 64, dtype=torch.int8,
                                       device="meta"), q)
        assert y.shape == (rows, 24)
    assert calls == [(32, 64), (32, 64), (32, 64), (40, 64)]
    assert _build.LAUNCHES[tquant.W8A8_COUNT] == 4
    with pytest.raises(ValueError, match="multiples of 8"):
        tquant._int_mm(torch.zeros(2, 60, dtype=torch.int8, device="meta"),
                       torch.zeros(60, 24, dtype=torch.int8, device="meta"))
    _build.reset_launches()


def test_decode_graph_plan_and_form():
    p = init_model(TCFG, "cpu", torch.Generator().manual_seed(0),
                   torch.float32, bits=8, act="int8")
    assert decode_graph.weight_form(p) == "w8a8"
    w = p["llm"]["layers"][0]["attn"]["wq"]
    assert decode_graph._weight_plan(w, 1, 132) is None


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("data"))
    info = make_fake_scene(root, n_frames=3)
    dc = DataConfig(video_folder=root,
                    annotation_dir=os.path.join(root, "embodiedscan"),
                    metadata_dir=os.path.join(root, "metadata"),
                    frames_upbound=3)
    params = jquant.quantize_tree(jlv.init_model(jax.random.PRNGKey(0), CFG),
                                  act="int8")
    return info, dc, params


@pytest.mark.parametrize("prefix", [0, 2])
def test_engine_answers_match_jax(scene, prefix):
    """Two questions, without and with the scene-prefix cache (a miss,
    then a suffix hit through the w8a8 products)."""
    info, dc, params = scene
    tok = FakeTokenizer()
    kw = dict(max_new_tokens=5, eos_token_id=tok.eos_token_id, max_frames=3,
              buckets=(256,), stop_str="", prefix_cache_scenes=prefix,
              suffix_buckets=(32, 64))
    jeng = jdrv.InferenceEngine(
        params, CFG, tok, VideoProcessor(dc),
        SigLipImageProcessor(size=(56, 56)), jdrv.EngineConfig(**kw),
        device_geometry=True)
    teng = tdrv.InferenceEngine(
        from_jax_params(jax.tree.map(np.asarray, params), TCFG,
                        device="cpu"), TCFG, tok,
        TVideoProcessor(port_config(dc)),
        TSigLipImageProcessor(size=(56, 56)), tdrv.EngineConfig(**kw),
        device="cpu")
    assert isinstance(teng.params["llm"]["lm_head"], tquant.W8A8Weight)
    qs = [{"id": f"q{i}", "video": info["sample_idx"],
           "conversations": [{"from": "human", "value": f"<image>\n{t}"},
                             {"from": "gpt", "value": None}]}
          for i, t in enumerate(("what color is the chair",
                                 "how many tables are there"))]
    jres = jeng._generate(*jeng._prepare_generation(qs[0]))
    tres = teng._generate(*teng._prepare_generation(qs[0]))
    np.testing.assert_array_equal(tres.tokens.numpy(),
                                  np.asarray(jres.tokens))
    assert [teng.generate_answer(q) for q in qs] == \
        [jeng.generate_answer(q) for q in qs]
    assert teng.prefix_cache_stats == jeng.prefix_cache_stats


def test_flagship_w8a8_tower_and_llm():
    """The benchmark's ``--w8a8`` tree (JAX ``full_depth.py``'s): the LLM
    and the tower's projections as W8A8Weight, the tower running through
    the w8a8 products (``siglip`` dispatches through ``quant.matmul``)."""
    from video3d_tpu_torch.bench import flagship
    from video3d_tpu_torch.models import siglip

    p = flagship.init_params(TCFG, "cpu", dtype=torch.float32, w8a8=True)
    assert isinstance(p["llm"]["lm_head"], tquant.W8A8Weight)
    w1 = p["vision"]["layers"][0]["mlp"]["w1"]
    assert isinstance(w1, tquant.W8A8Weight) and w1.q.stride(0) == 1
    dense = flagship.init_params(TCFG, "cpu", dtype=torch.float32)
    x = torch.randn(2, 3, 56, 56, generator=torch.Generator().manual_seed(0))
    got = siglip.vision_tower_forward(p["vision"], x, TCFG.vision)
    want = siglip.vision_tower_forward(dense["vision"], x, TCFG.vision)
    assert got.shape == want.shape and bool(torch.isfinite(got).all())
    rel = float((got - want).abs().max() / want.abs().max())
    assert 0 < rel < 0.05
