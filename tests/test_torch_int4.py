"""The int4-weight configuration of the port against the JAX package, on the
CPU: ``quantize_weight_int4`` (packed bytes and bf16 scales bit for bit),
``unpack_int4``, the plain version of kernel B8 against the Pallas kernel
in interpret mode, ``matmul``'s int4 CPU branch, ``from_jax_params`` and
``init_model(bits=4)``, the dispatch rule of the int4 and int8 kernels, and
greedy engine tokens with ``quantize_tree(bits=4)``'d weights (bf16 KV
cache) through ``run_scanqa`` and the prefix path."""

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
from video3d_tpu.kernels import quant_matvec as jqm
from video3d_tpu.models import llava_video3d as jlv
from video3d_tpu.models import quant as jquant
from video3d_tpu.models import qwen2 as jqwen
from video3d_tpu_torch.data.image_processor import \
    SigLipImageProcessor as TSigLipImageProcessor
from video3d_tpu_torch.data.video_processor import \
    VideoProcessor as TVideoProcessor
from video3d_tpu_torch.eval import drivers as tdrv
from video3d_tpu_torch.kernels import _build
from video3d_tpu_torch.kernels import quant_matvec as tqm
from video3d_tpu_torch.models import quant as tquant
from video3d_tpu_torch.params import _convert, from_jax_params, init_model

from fixtures import FakeTokenizer, make_fake_scene
from port_configs import port_config

torch.set_num_threads(1)

CFG = ModelConfig.tiny()
TCFG = port_config(CFG)
# bf16 outputs: one bf16 ulp of |ref| (2^-7 relative at worst) plus a
# floor for outputs near zero; f32 outputs: summation order only
BF16_REL, BF16_ABS = 2.0 ** -7, 1e-3
F32_TOL = 1e-5


def _np(x: torch.Tensor) -> np.ndarray:
    """A tensor's bits as numpy (bf16 as its uint16 pattern)."""
    if x.dtype == torch.bfloat16:
        return x.view(torch.int16).numpy().view(np.uint16)
    return x.numpy()


def _jnp(x) -> np.ndarray:
    a = np.asarray(x)
    return a.view(np.uint16) if a.dtype.name == "bfloat16" else a


def _tensor(a) -> torch.Tensor:
    """A JAX / numpy array as a torch tensor, bf16 bit for bit."""
    a = np.array(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def _assert_same_int4(t: tquant.Int4Weight, j: jquant.Int4Weight, path=""):
    assert isinstance(t, tquant.Int4Weight), path
    assert t.dims == tuple(j.dims) and t.group == j.group, path
    assert t.q4.dtype == torch.int8 and t.scale4.dtype == torch.bfloat16
    np.testing.assert_array_equal(_np(t.q4), _jnp(j.q4), err_msg=path)
    np.testing.assert_array_equal(_np(t.scale4), _jnp(j.scale4), err_msg=path)


def _assert_same_tree(tp, jp, path=""):
    if isinstance(jp, jquant.Int4Weight):
        _assert_same_int4(tp, jp, path)
    elif isinstance(jp, dict):
        assert set(tp) == set(jp), path
        for k in jp:
            _assert_same_tree(tp[k], jp[k], f"{path}/{k}")
    elif isinstance(jp, (list, tuple)):
        assert len(tp) == len(jp), path
        for i, (a, b) in enumerate(zip(tp, jp)):
            _assert_same_tree(a, b, f"{path}/{i}")
    else:
        np.testing.assert_array_equal(_np(tp), _jnp(jp), err_msg=path)


def _weight(in_, out, seed):
    """N(0, 1) weights with an all-zero column (the 1e-12 floor) and a
    column whose first group has absmax 7, so its scale is 1 and the
    values +-2.5, 3.5, +-0.5 are ties of round half to even."""
    w = np.random.default_rng(seed).normal(size=(in_, out)).astype(np.float32)
    w[:, 3] = 0.0
    w[:, 5] = np.clip(w[:, 5], -1, 1)
    w[:7, 5] = [7.0, 2.5, -2.5, 3.5, 0.5, -0.5, 1.5]
    return w


@pytest.mark.parametrize("in_,out,group", [
    (96, 80, 512),        # input and output padded, one group
    (200, 8200, 64),      # out >= 8192 pads to 2048, ragged last group
    (1024, 512, 512),     # no padding
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantize_weight_int4_matches_jax(in_, out, group, dtype):
    w = _weight(in_, out, 0)
    jw = jquant.quantize_weight_int4(jnp.asarray(w, dtype), group=group)
    tw = tquant.quantize_weight_int4(
        torch.from_numpy(w).to(getattr(torch, dtype)), group=group)
    _assert_same_int4(tw, jw)
    assert tw.q4.shape[1] % (2048 if out >= 8192 else 512) == 0


def test_unpack_int4_round_trips_every_value():
    """Every (low, high) pair of values in [-7, 7] packs into one byte and
    unpacks to itself, as the JAX unpack_int4 does."""
    v = np.arange(-7, 8, dtype=np.int8)
    lo, hi = np.meshgrid(v, v, indexing="ij")
    q = np.stack([lo.ravel(), hi.ravel()])        # rows 0 and 1, 225 pairs
    packed = (torch.from_numpy(q[0::2]) & 0x0F) | \
        (torch.from_numpy(q[1::2]) << 4)
    np.testing.assert_array_equal(tqm.unpack_int4(packed).numpy(), q)
    np.testing.assert_array_equal(
        tqm.unpack_int4(packed).numpy(),
        np.asarray(jqm.unpack_int4(jnp.asarray(packed.numpy()))))


@pytest.mark.parametrize("rows", [1, 4, 8, 32])
def test_int4_matmul_plain_matches_jax_kernel(rows):
    """The plain version of B8 (x rounded to bf16, f32 product per group
    times its f32 scale, one rounding) against the Pallas kernel in
    interpret mode, in f32 (summation order) and bf16 (one ulp)."""
    in_, out, group = 1024, 512, 512
    jw = jquant.quantize_weight_int4(jnp.asarray(_weight(in_, out, 1)),
                                     group=group)
    q4, sc = _tensor(jw.q4), _tensor(jw.scale4)
    x = np.random.default_rng(rows).normal(size=(rows, in_)) \
        .astype(np.float32)
    for dtype in ("float32", "bfloat16"):
        got = tqm.int4_matmul(torch.from_numpy(x).to(getattr(torch, dtype)),
                              q4, sc, group)
        want = np.asarray(jqm.int4_matmul(
            jnp.asarray(x, dtype), jw.q4, jw.scale4, group=group,
            block_out=512, interpret=True), np.float32)
        assert got.shape == want.shape and str(got.dtype).endswith(dtype)
        err = np.abs(got.float().numpy() - want)
        if dtype == "float32":
            assert err.max() <= F32_TOL * np.abs(want).max()
        else:
            assert (err <= BF16_REL * np.abs(want) + BF16_ABS).all()


@pytest.mark.parametrize("dtype,tol", [("float32", 1e-5), ("bfloat16", 1e-2)])
def test_matmul_int4_cpu_branch_matches_jax(dtype, tol):
    """quant.matmul on an Int4Weight on the CPU: x padded to the packed
    width, the f32 dequantized product, y[..., :out] in x's dtype, as the
    JAX package's CPU branch. Tolerance: f32 summation order (f32), one
    bf16 ulp (bf16)."""
    rng = np.random.default_rng(2)
    w = rng.normal(size=(100, 72)).astype(np.float32)
    x = rng.normal(size=(3, 5, 100)).astype(np.float32)
    jw = jquant.quantize_weight_int4(jnp.asarray(w))
    tw = tquant.quantize_weight_int4(torch.from_numpy(w))
    got = tquant.matmul(torch.from_numpy(x).to(getattr(torch, dtype)), tw)
    want = np.asarray(jquant.matmul(jnp.asarray(x, dtype), jw), np.float32)
    assert got.shape == (3, 5, 72) and str(got.dtype).endswith(dtype)
    np.testing.assert_allclose(got.float().numpy(), want, rtol=tol, atol=tol)


def test_from_jax_params_carries_int4_bit_for_bit():
    """Every leaf of a quantize_tree(bits=4)'d bf16 tree carries across bit
    for bit; a ``dtype`` cast leaves the int4 scales in bf16."""
    params = jlv.init_model(jax.random.PRNGKey(0), CFG, dtype=jnp.bfloat16)
    q = jax.tree.map(np.asarray, jquant.quantize_tree(params, bits=4))
    tree = from_jax_params(q, TCFG, device="cpu")
    assert isinstance(tree["llm"]["lm_head"], tquant.Int4Weight)
    assert tquant.is_quantized(tree["llm"]["layers"][1]["mlp"]["w_down"])
    _assert_same_tree(tree, {k: q[k] for k in tree})
    f32 = from_jax_params(q, TCFG, device="cpu", dtype=torch.float32)
    assert f32["llm"]["norm"].dtype == torch.float32
    _assert_same_int4(f32["llm"]["lm_head"], q["llm"]["lm_head"])


def test_quantize_tree_int4_matches_jax():
    jp = jqwen.init_qwen2(jax.random.PRNGKey(3), CFG.llm)
    tree = _convert(jax.tree.map(np.asarray, jp), "cpu", None)
    jq = jquant.quantize_tree({"llm": jp}, bits=4)
    tq = tquant.quantize_tree({"llm": tree}, bits=4)
    _assert_same_tree(tq, jq)
    assert not tquant.is_quantized(tq["llm"]["embed_tokens"])
    again = tquant.quantize_tree(tq, bits=4)          # Int4Weight passes
    assert again["llm"]["lm_head"] is tq["llm"]["lm_head"]


def test_init_model_int4_is_quantize_tree_of_the_bf16_init():
    bf16 = init_model(TCFG, "cpu", torch.Generator().manual_seed(3))
    int4 = init_model(TCFG, "cpu", torch.Generator().manual_seed(3), bits=4)
    want = tquant.quantize_tree(bf16, bits=4)

    def same(a, b):
        if isinstance(a, tquant.Int4Weight):
            assert a.dims == b.dims and a.group == b.group
            assert torch.equal(a.q4, b.q4) and torch.equal(a.scale4, b.scale4)
        elif isinstance(a, dict):
            assert set(a) == set(b)
            for k in a:
                same(a[k], b[k])
        elif isinstance(a, list):
            for x, y in zip(a, b):
                same(x, y)
        else:
            assert a.dtype == b.dtype and torch.equal(a, b)

    same(int4, want)
    assert isinstance(int4["llm"]["layers"][0]["attn"]["wk"],
                      tquant.Int4Weight)
    assert int4["vision"]["layers"][0]["attn"]["wq"].dtype == torch.bfloat16


def test_dispatch_rule(monkeypatch):
    """On a device that is not the CPU, at most 32 rows of x go to a
    kernel: int4 to B8; int8 to B4's matvec at one row and >= 32768
    outputs, else to B4's B>1 form; more rows dequantize and run a dense
    matmul. A CPU tensor takes the plain arithmetic and launches nothing;
    a kernel wrapper given a tensor on a device without a kernel raises."""
    calls = []

    def fake(name):
        def kernel(x, w, scale, *args):
            calls.append((name, x.numel() // x.shape[-1]))
            return torch.empty((*x.shape[:-1], w.shape[1]), device=x.device,
                               dtype=x.dtype)
        return kernel

    for name in ("int4_matmul", "int8_matmul", "int8_matvec"):
        monkeypatch.setattr(tqm, name, fake(name))
    w4 = tquant.Int4Weight(torch.zeros(256, 512, dtype=torch.int8,
                                       device="meta"),
                           torch.zeros(1, 512, dtype=torch.bfloat16,
                                       device="meta"), (500, 500), 512)
    for shape in ((1, 1, 500), (8, 1, 500), (4, 8, 500), (33, 500)):
        y = tquant.matmul(torch.zeros(shape, device="meta"), w4)
        assert y.shape == (*shape[:-1], 500)
    assert calls == [("int4_matmul", 1), ("int4_matmul", 8),
                     ("int4_matmul", 32)]
    calls.clear()
    wide = {"q": torch.zeros(8, 32768, dtype=torch.int8, device="meta"),
            "scale": torch.zeros(1, 32768, device="meta")}
    narrow = {"q": torch.zeros(8, 512, dtype=torch.int8, device="meta"),
              "scale": torch.zeros(1, 512, device="meta")}
    for shape, w in (((1, 1, 8), wide), ((1, 1, 8), narrow),
                     ((2, 1, 8), wide), ((32, 8), narrow),
                     ((33, 8), narrow), ((3, 16, 8), wide)):
        tquant.matmul(torch.zeros(shape, device="meta"), w)
    assert calls == [("int8_matvec", 1), ("int8_matmul", 1),
                     ("int8_matmul", 2), ("int8_matmul", 32)]
    monkeypatch.undo()

    rng = np.random.default_rng(4)
    w = torch.from_numpy(rng.normal(size=(40, 600)).astype(np.float32))
    tw = tquant.quantize_weight_int4(w)
    x = torch.from_numpy(rng.normal(size=(2, 40)).astype(np.float32))
    before = dict(_build.LAUNCHES)
    got = tquant.matmul(x, tw)
    assert _build.LAUNCHES == before
    xp = torch.nn.functional.pad(x, (0, 512 - 40))
    dq = tqm.unpack_int4(tw.q4).float() * \
        tw.scale4.float().repeat_interleave(512, dim=0)
    np.testing.assert_array_equal(got.numpy(), (xp @ dq)[:, :600].numpy())
    with pytest.raises(ValueError, match="no kernel"):
        tqm.int4_matmul(torch.zeros(1, 512, device="meta",
                                    dtype=torch.bfloat16),
                        tw.q4.to("meta"), tw.scale4.to("meta"))


# ---- engine: greedy tokens of the int4 configuration against JAX

def _question(info, text, i):
    return {
        "id": f"q{i}_0", "video": info["sample_idx"],
        "conversations": [
            {"from": "human", "value": f"<image>\n{text}"},
            {"from": "gpt", "value": "brown"}],
        "metadata": {"dataset": "scanqa", "question_type": "what"},
    }


QUESTIONS = ["what color is the chair", "how many tables are there",
             "where is the lamp"]


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("data"))
    info = make_fake_scene(root, n_frames=3)
    data_cfg = DataConfig(video_folder=root,
                          annotation_dir=os.path.join(root, "embodiedscan"),
                          metadata_dir=os.path.join(root, "metadata"),
                          frames_upbound=3)
    params = jquant.quantize_tree(jlv.init_model(jax.random.PRNGKey(0), CFG),
                                  bits=4)
    return info, data_cfg, params


def _ecfg(module, tok, **kw):
    return module.EngineConfig(max_new_tokens=4, eos_token_id=tok.eos_token_id,
                               max_frames=3, buckets=(256,), stop_str="",
                               suffix_buckets=(32, 64), **kw)


def _engines(scene, **kw):
    _, data_cfg, params = scene
    tok = FakeTokenizer()
    jeng = jdrv.InferenceEngine(
        params, CFG, tok, VideoProcessor(data_cfg),
        SigLipImageProcessor(size=(CFG.vision.image_size,) * 2),
        _ecfg(jdrv, tok, **kw), device_geometry=True)
    tok = FakeTokenizer()
    teng = tdrv.InferenceEngine(
        from_jax_params(jax.tree.map(np.asarray, params), TCFG,
                        device="cpu"), TCFG, tok,
        TVideoProcessor(port_config(data_cfg)),
        TSigLipImageProcessor(size=(CFG.vision.image_size,) * 2),
        _ecfg(tdrv, tok, **kw), device="cpu")
    return jeng, teng


def test_int4_run_scanqa_matches_jax(scene, tmp_path):
    """B=1 without caches through run_scanqa: the jsonl records equal."""
    info = scene[0]
    qs = [_question(info, t, i) for i, t in enumerate(QUESTIONS[:2])]
    jeng, teng = _engines(scene)
    assert isinstance(teng.params["llm"]["lm_head"], tquant.Int4Weight)
    jdrv.run_scanqa(jeng, qs, str(tmp_path / "jax.jsonl"))
    tdrv.run_scanqa(teng, qs, str(tmp_path / "torch.jsonl"))

    def read(name):
        with open(tmp_path / name) as f:
            return [json.loads(line) for line in f]

    assert read("torch.jsonl") == read("jax.jsonl")


def test_int4_prefix_path_matches_jax(scene):
    """B=1: a miss stores the prefix, two hits prefill only their suffix;
    then a B=3 suffix batch over the shared prefix. Greedy token ids (the
    answers) and the cache stats equal the JAX engine's."""
    info = scene[0]
    qs = [_question(info, t, i) for i, t in enumerate(QUESTIONS)]
    jeng, teng = _engines(scene, prefix_cache_scenes=2)
    assert [teng.generate_answer(q) for q in qs] == \
        [jeng.generate_answer(q) for q in qs]
    assert teng.generate_answers_batch_prefix(qs) == \
        jeng.generate_answers_batch_prefix(qs)
    assert teng.prefix_cache_stats == jeng.prefix_cache_stats == [5, 1]
