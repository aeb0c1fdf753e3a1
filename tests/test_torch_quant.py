"""Weight-only int8 quantization of the port against the JAX package, on the
CPU: ``from_jax_params`` on bf16 and ``quantize_tree``'d trees (int8,
w8a8 and int4 leaves bit for bit), ``quantize_weight`` / ``quantize_tree`` / ``_quantize_kv`` (bit for
bit), ``matmul`` on int8 dicts, the plain version of kernel B4 against the
Pallas kernel in interpret mode, the B4 dispatch rule and the int8 init."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from video3d_tpu.config import LLMConfig, ModelConfig
from video3d_tpu.kernels.quant_matvec import int8_matmul as jax_int8_matmul
from video3d_tpu.models import llava_video3d as jlv
from video3d_tpu.models import quant as jquant
from video3d_tpu.models import qwen2 as jqwen
from video3d_tpu_torch.kernels import _build
from video3d_tpu_torch.kernels.quant_matvec import (int8_matmul,
                                                    int8_matmul_plain)
from video3d_tpu_torch.models import quant as tquant
from video3d_tpu_torch.models import qwen2 as tqwen
from video3d_tpu_torch.params import _convert, from_jax_params, init_model

from port_configs import port_config

torch.set_num_threads(1)

CFG = ModelConfig.tiny()
TCFG = port_config(CFG)


def _np(x: torch.Tensor) -> np.ndarray:
    """A tensor's bits as numpy (bf16 as its uint16 pattern)."""
    if x.dtype == torch.bfloat16:
        return x.view(torch.int16).numpy().view(np.uint16)
    return x.numpy()


def _jnp(x) -> np.ndarray:
    a = np.asarray(x)
    return a.view(np.uint16) if a.dtype.name == "bfloat16" else a


def _assert_same_tree(tp, jp, path=""):
    """Every leaf of the port tree ``tp`` equals the JAX leaf bit for bit,
    with the same dtype."""
    if isinstance(jp, dict):
        assert set(tp) == set(jp), path
        for k in jp:
            _assert_same_tree(tp[k], jp[k], f"{path}/{k}")
    elif isinstance(jp, (list, tuple)):
        assert len(tp) == len(jp), path
        for i, (a, b) in enumerate(zip(tp, jp)):
            _assert_same_tree(a, b, f"{path}/{i}")
    else:
        want = _jnp(jp)
        got = _np(tp)
        assert str(tp.dtype).split(".")[-1] == str(np.asarray(jp).dtype), path
        np.testing.assert_array_equal(got, want, err_msg=path)


def _used(tree):
    return {k: tree[k] for k in ("vision", "projector", "image_newline",
                                 "llm", "ground_head")}


def test_from_jax_params_bf16_and_int8_leaves():
    """A bf16 JAX tree (ml_dtypes bfloat16 leaves, which torch.from_numpy
    rejects) and its quantize_tree'd form (int8 q, bf16 scale) convert bit
    for bit."""
    params = jlv.init_model(jax.random.PRNGKey(0), CFG, dtype=jnp.bfloat16)
    host = jax.tree.map(np.asarray, params)
    _assert_same_tree(from_jax_params(host, TCFG, device="cpu"), _used(host))
    qhost = jax.tree.map(np.asarray, jquant.quantize_tree(params))
    qtree = from_jax_params(qhost, TCFG, device="cpu")
    assert tquant.is_quantized(qtree["llm"]["lm_head"])
    assert qtree["llm"]["layers"][0]["attn"]["wq"]["q"].dtype == torch.int8
    _assert_same_tree(qtree, _used(qhost))


def test_from_jax_params_carries_world_pe_mlp():
    """A bf16 tree of an MLP world-PE model: its ``world_pe_mlp`` leaves
    carry across bit for bit beside the rest."""
    from video3d_tpu.config import PosEmbedType, replace

    cfg = replace(CFG, world_3d=replace(CFG.world_3d,
                                        pos_embed=PosEmbedType.MLP))
    host = jax.tree.map(np.asarray, jlv.init_model(
        jax.random.PRNGKey(0), cfg, dtype=jnp.bfloat16))
    tree = from_jax_params(host, port_config(cfg), device="cpu")
    assert set(tree["world_pe_mlp"]) == {"w1", "b1", "ln_scale", "ln_bias",
                                         "w2", "b2"}
    _assert_same_tree(tree, dict(_used(host),
                                 world_pe_mlp=host["world_pe_mlp"]))


def test_from_jax_params_rejects_unported_weight_forms():
    """Every quantized form of the JAX package converts now: w8a8 weights
    into the port's W8A8Weight (int8 values and bf16 scales bit for bit),
    int4 weights into its Int4Weight."""
    params = jlv.init_model(jax.random.PRNGKey(0), CFG)
    jw = jquant.quantize_tree(params, act="int8")
    w8 = from_jax_params(jw, TCFG, device="cpu")["llm"]["layers"][1]["attn"][
        "wo"]
    assert isinstance(w8, tquant.W8A8Weight)
    want = jw["llm"]["layers"][1]["attn"]["wo"]
    assert np.array_equal(_np(w8.q), _jnp(want.q))
    assert np.array_equal(_np(w8.scale), _jnp(want.scale))
    int4 = from_jax_params(jquant.quantize_tree(params, bits=4), TCFG,
                           device="cpu")
    w = int4["llm"]["layers"][0]["mlp"]["w_up"]
    assert isinstance(w, tquant.Int4Weight) and w.q4.dtype == torch.int8


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantize_weight_matches_jax(dtype):
    rng = np.random.default_rng(0)
    w = rng.normal(size=(96, 80)).astype(np.float32)
    w[:, 3] = 0.0                       # an all-zero column: the 1e-12 floor
    # column 7 has scale 1: ties at +-2.5 and 3.5 round half to even
    w[:, 7] = np.clip(w[:, 7], -1, 1)
    w[:4, 7] = [127.0, 2.5, -2.5, 3.5]
    jw = jnp.asarray(w, dtype)
    tw = torch.from_numpy(w).to(getattr(torch, dtype))
    _assert_same_tree(tquant.quantize_weight(tw), jquant.quantize_weight(jw))


def test_quantize_tree_matches_jax():
    """The default patterns quantize exactly the LLM projections and the
    lm_head; the result and quantization_error equal the JAX package's."""
    jp = jqwen.init_qwen2(jax.random.PRNGKey(3), LLMConfig.tiny())
    tree = _convert(jax.tree.map(np.asarray, jp), "cpu", None)
    jq = jquant.quantize_tree({"llm": jp})
    tq = tquant.quantize_tree({"llm": tree})
    _assert_same_tree(tq, jq)
    assert not tquant.is_quantized(tq["llm"]["embed_tokens"])
    assert tquant.is_quantized(tq["llm"]["layers"][1]["mlp"]["w_down"])
    again = tquant.quantize_tree(tq)              # quantized dicts pass
    assert again["llm"]["lm_head"] is tq["llm"]["lm_head"]
    assert tquant.quantization_error({"llm": tree}, tq) == pytest.approx(
        jquant.quantization_error({"llm": jp}, jq), rel=1e-6)
    int4 = tquant.quantize_tree({"llm": tree}, bits=4)["llm"]["layers"][0][
        "attn"]["wq"]
    assert isinstance(int4, tquant.Int4Weight)
    assert int4.dims == tuple(tree["layers"][0]["attn"]["wq"].shape)
    w8 = tquant.quantize_tree({"llm": tree}, act="int8")["llm"]["lm_head"]
    jw8 = jquant.quantize_tree({"llm": jp}, act="int8")["llm"]["lm_head"]
    assert isinstance(w8, tquant.W8A8Weight)
    assert np.array_equal(_np(w8.q), _jnp(jw8.q))
    assert np.array_equal(_np(w8.scale), _jnp(jw8.scale))
    with pytest.raises(ValueError, match="bits 8"):
        tquant.quantize_tree(tree, bits=4, act="int8")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantize_kv_matches_jax(dtype):
    """Per-token, per-head int8 K/V values and f32 scales, bit for bit
    (including an all-zero head: the 1e-8 floor)."""
    rng = np.random.default_rng(1)
    x = rng.normal(size=(2, 9, 3, 16)).astype(np.float32)
    x[0, 2, 1] = 0.0
    jqv, jsc = jqwen._quantize_kv(jnp.asarray(x, dtype))
    tqv, tsc = tqwen._quantize_kv(torch.from_numpy(x).to(getattr(torch,
                                                                  dtype)))
    np.testing.assert_array_equal(tqv.numpy(), np.asarray(jqv))
    np.testing.assert_array_equal(tsc.numpy(), np.asarray(jsc))


@pytest.mark.parametrize("dtype,tol", [("float32", 1e-5), ("bfloat16", 1e-2)])
def test_matmul_int8_dict_matches_jax(dtype, tol):
    """quant.matmul on an int8 dict: (x @ q.to(x.dtype)) * scale.to(x.dtype)
    in x's dtype, as the JAX package's CPU path; dense weights pass as
    x @ w. Tolerance: f32 summation order (f32), one bf16 ulp (bf16)."""
    rng = np.random.default_rng(2)
    w = rng.normal(size=(64, 48)).astype(np.float32)
    x = rng.normal(size=(3, 5, 64)).astype(np.float32)
    jd = jquant.quantize_weight(jnp.asarray(w))
    td = tquant.quantize_weight(torch.from_numpy(w))
    tdt = getattr(torch, dtype)
    got = tquant.matmul(torch.from_numpy(x).to(tdt), td)
    want = jquant.matmul(jnp.asarray(x, dtype), jd)
    assert got.dtype == tdt
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), rtol=tol,
                               atol=tol)
    dense = tquant.matmul(torch.from_numpy(x), torch.from_numpy(w))
    np.testing.assert_allclose(dense.numpy(), x @ w, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("in_,out", [(64, 256), (128, 384), (3584, 512)])
def test_int8_matmul_plain_matches_jax_kernel(in_, out):
    """The plain version of B4 (f32 sum, f32 scale, one rounding) against
    the B=1 Pallas kernel in interpret mode, in f32 and bf16."""
    rng = np.random.default_rng(7)
    w = rng.normal(size=(in_, out)).astype(np.float32)
    x = rng.normal(size=(1, in_)).astype(np.float32)
    d = jquant.quantize_weight(jnp.asarray(w))
    q = torch.from_numpy(np.array(d["q"]))
    scale = torch.from_numpy(_jnp(d["scale"]).copy()).view(torch.bfloat16)
    for dtype, tol in (("float32", 1e-4), ("bfloat16", 1e-2)):
        got = int8_matmul(torch.from_numpy(x).to(getattr(torch, dtype)), q,
                          scale)
        want = jax_int8_matmul(jnp.asarray(x, dtype), d["q"], d["scale"],
                               interpret=True)
        assert got.shape == want.shape and str(got.dtype).endswith(dtype)
        np.testing.assert_allclose(got.float().numpy(),
                                   np.asarray(want, np.float32), rtol=tol,
                                   atol=tol)
    np.testing.assert_array_equal(
        int8_matmul_plain(torch.from_numpy(x), q, scale).numpy(),
        int8_matmul(torch.from_numpy(x), q, scale).numpy())


@pytest.mark.parametrize("lead", [(5,), (2, 3)])
def test_int8_matmul_b_gt_1_plain_matches_jax_kernel(lead):
    """The plain version of B4's B>1 form (f32 sum, f32 scale, one
    rounding) against the B>1 Pallas kernel (_int8_kernel) in interpret
    mode, in f32 (summation order) and bf16 (one bf16 ulp)."""
    in_, out = 256, 384
    rng = np.random.default_rng(9)
    w = rng.normal(size=(in_, out)).astype(np.float32)
    x = rng.normal(size=(*lead, in_)).astype(np.float32)
    d = jquant.quantize_weight(jnp.asarray(w))
    q = torch.from_numpy(np.array(d["q"]))
    scale = torch.from_numpy(_jnp(d["scale"]).copy()).view(torch.bfloat16)
    for dtype, tol in (("float32", 1e-4), ("bfloat16", 1e-2)):
        got = int8_matmul(torch.from_numpy(x).to(getattr(torch, dtype)), q,
                          scale)
        want = jax_int8_matmul(jnp.asarray(x, dtype), d["q"], d["scale"],
                               interpret=True)
        assert got.shape == want.shape == (*lead, out)
        assert str(got.dtype).endswith(dtype)
        np.testing.assert_allclose(got.float().numpy(),
                                   np.asarray(want, np.float32), rtol=tol,
                                   atol=tol)


def test_b4_dispatch_rule():
    """B4 takes one row with at least 32768 outputs (the vocab head at
    B=1); a CPU tensor always takes the plain dequant path and launches
    nothing; a non-CPU tensor without a kernel raises."""
    q = torch.zeros((8, 32768), dtype=torch.int8)
    small = torch.zeros((8, 32767), dtype=torch.int8)
    assert tquant.routes_to_matvec(torch.zeros(1, 1, 8), q)
    assert tquant.routes_to_matvec(torch.zeros(8), q)
    assert not tquant.routes_to_matvec(torch.zeros(2, 1, 8), q)
    assert not tquant.routes_to_matvec(torch.zeros(1, 3, 8), q)
    assert not tquant.routes_to_matvec(torch.zeros(1, 1, 8), small)
    rng = np.random.default_rng(4)
    d = tquant.quantize_weight(torch.from_numpy(
        rng.normal(size=(8, 32768)).astype(np.float32)))
    x = torch.from_numpy(rng.normal(size=(1, 1, 8)).astype(np.float32))
    before = dict(_build.LAUNCHES)
    got = tquant.matmul(x, d)
    assert _build.LAUNCHES == before
    want = (x @ d["q"].float()) * d["scale"].float()
    np.testing.assert_array_equal(got.numpy(), want.numpy())
    with pytest.raises(ValueError, match="no kernel"):
        int8_matmul(torch.zeros(1, 8, device="meta"), q, torch.zeros(1, 32768))


def test_init_model_int8_is_quantize_tree_of_the_bf16_init():
    """init_model(bits=8) draws the same random weights as the bf16 init
    and quantizes the LLM projections and lm_head layer by layer: the
    result equals quantize_tree of the bf16 tree."""
    cfg = TCFG
    bf16 = init_model(cfg, "cpu", torch.Generator().manual_seed(3))
    int8 = init_model(cfg, "cpu", torch.Generator().manual_seed(3), bits=8)
    want = tquant.quantize_tree(bf16)

    def same(a, b):
        if isinstance(a, dict):
            assert set(a) == set(b)
            for k in a:
                same(a[k], b[k])
        elif isinstance(a, list):
            for x, y in zip(a, b):
                same(x, y)
        else:
            assert a.dtype == b.dtype and torch.equal(a, b)

    same(int8, want)
    assert int8["llm"]["lm_head"]["q"].dtype == torch.int8
    assert int8["vision"]["layers"][0]["attn"]["wq"].dtype == torch.bfloat16
    int4 = init_model(cfg, "cpu", torch.Generator().manual_seed(3), bits=4)
    assert isinstance(int4["llm"]["lm_head"], tquant.Int4Weight)
    assert torch.equal(int4["llm"]["lm_head"].q4,
                       tquant.quantize_weight_int4(
                           bf16["llm"]["lm_head"]).q4)
