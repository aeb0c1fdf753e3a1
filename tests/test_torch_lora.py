"""The port's LoRA module (``train/lora.py``) and ``LoraAdapted`` weight
against the JAX package's on the CPU, at ``ModelConfig.tiny()`` with the
weights of one JAX ``init_model`` tree and JAX's adapters carried across
(``from_jax_tree``), never drawn again:

* the trainable tree's paths, shapes and None positions equal JAX's over
  dense, int8 and int4 bases;
* ``init_lora``'s draws: A ~ N(0, 0.02) (mean within 5e-4, std within 2%
  over 65536 draws), B = 0, reproducible from the generator's seed;
* ``apply_lora``: dense bases merged within 1e-6 of JAX's (f32), int8 and
  int4 bases wrapped lazily with the base bit for bit, and the lazy
  product within 1e-5 relative of JAX's;
* ``LoraAdapted`` products and their gradients (x, A, B) against
  ``jax.grad`` within 1e-5 relative (f32; the int4 base dequantized in f32
  on both sides);
* ``merge_lora_into_params``: the requantized int8 ``q`` and its scale bit
  for bit JAX's (the test's adapters are small dyadic numbers, so A @ B is
  exact in f32 on both sides and only the quantization is compared), a
  dense merge within 1e-6, int4 raises as in JAX;
* ``from_jax_params`` carries an ``apply_lora``'d JAX tree's
  ``LoraAdapted`` leaves across (base, factors, scale) bit for bit.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from video3d_tpu.config import ModelConfig
from video3d_tpu.models import llava_video3d as jlv
from video3d_tpu.models import quant as jquant
from video3d_tpu.train import lora as jlora
from video3d_tpu_torch.models import quant as tquant
from video3d_tpu_torch.params import from_jax_params, from_jax_tree
from video3d_tpu_torch.train import lora as tlora
from video3d_tpu_torch.train.optim import tree_leaves_with_path

from port_configs import port_config

torch.set_num_threads(1)

CFG = ModelConfig.tiny()
TCFG = port_config(CFG)
JLCFG = jlora.LoraConfig(r=4, alpha=8)
TLCFG = tlora.LoraConfig(r=4, alpha=8)


@pytest.fixture(scope="module")
def params():
    return jlv.init_model(jax.random.PRNGKey(0), CFG)


def _base(params, bits):
    return params if bits == 16 else jquant.quantize_tree(params, bits=bits)


def _host(tree):
    return jax.tree.map(np.asarray, tree)


def _port(tree):
    return from_jax_params(_host(tree), TCFG, device="cpu")


def _jax_trainable(params, bits, seed=1):
    """JAX's trainable tree with every B drawn nonzero (B = 0 would make
    every delta vanish)."""
    tr = jlora.init_lora_trainable(jax.random.PRNGKey(seed),
                                   _base(params, bits), JLCFG)
    rng = np.random.default_rng(seed + 100)

    def fill(path, x):
        if jax.tree_util.keystr(path).endswith("['B']"):
            return jnp.asarray(0.05 * rng.normal(size=x.shape), x.dtype)
        return x

    return jax.tree_util.tree_map_with_path(fill, tr)


def _jax_paths(tree):
    flat, _ = jax.tree_util.tree_flatten_with_path(tree)
    return [("/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                      for k in path), tuple(x.shape)) for path, x in flat]


def _none_paths(tree, prefix=""):
    if tree is None:
        return [prefix]
    if isinstance(tree, dict):
        return [p for k in sorted(tree) for p in _none_paths(
            tree[k], f"{prefix}/{k}" if prefix else k)]
    if isinstance(tree, (list, tuple)):
        return [p for i, v in enumerate(tree)
                for p in _none_paths(v, f"{prefix}/{i}")]
    return []


@pytest.mark.parametrize("bits", [16, 8, 4])
def test_trainable_paths_and_none_positions_match_jax(params, bits):
    jtr = jlora.init_lora_trainable(jax.random.PRNGKey(1),
                                    _base(params, bits), JLCFG)
    ttr = tlora.init_lora_trainable(torch.Generator().manual_seed(0),
                                    _port(_base(params, bits)), TLCFG)
    got = [(p, tuple(t.shape)) for p, t in tree_leaves_with_path(ttr)]
    assert got == _jax_paths(jtr)
    assert _none_paths(ttr) == _none_paths(jtr)
    assert any(p.endswith("attn/wq/A") for p, _ in got)
    assert ttr["vision"]["patch_embed"]["w"] is None
    assert ttr["llm"]["embed_tokens"] is None
    assert ttr["llm"]["lm_head"] is None
    assert set(ttr["projector"]) == {"b1", "b2", "w1", "w2"}
    assert all(t.dtype == torch.float32
               for _, t in tree_leaves_with_path(ttr))
    # the converter keeps JAX's None positions too
    conv = from_jax_tree(_host(jtr), device="cpu")
    assert _none_paths(conv) == _none_paths(jtr)
    assert tlora.lora_size(conv) == sum(
        int(x.size) for x in jax.tree_util.tree_leaves(jtr))


def test_init_lora_draws():
    w = torch.zeros(512, 256)
    tree = {"llm": {"layers": [{"attn": {"wq": w, "bq": torch.zeros(256)}}]}}
    cfg = tlora.LoraConfig()
    ad = tlora.init_lora(torch.Generator().manual_seed(3), tree, cfg)
    A = ad["llm"]["layers"][0]["attn"]["wq"]["A"]
    B = ad["llm"]["layers"][0]["attn"]["wq"]["B"]
    assert ad["llm"]["layers"][0]["attn"]["bq"] is None
    assert A.shape == (512, cfg.r) and B.shape == (cfg.r, 256)
    assert A.numel() == 65536 and not B.any()
    assert abs(float(A.mean())) < 5e-4
    assert abs(float(A.std()) / 0.02 - 1) < 0.02
    again = tlora.init_lora(torch.Generator().manual_seed(3), tree, cfg)
    assert torch.equal(again["llm"]["layers"][0]["attn"]["wq"]["A"], A)
    other = tlora.init_lora(torch.Generator().manual_seed(4), tree, cfg)
    assert not torch.equal(other["llm"]["layers"][0]["attn"]["wq"]["A"], A)
    assert cfg.r == 128 and cfg.alpha == 256 and cfg.scale == 2.0


@pytest.mark.parametrize("bits", [16, 8, 4])
def test_apply_lora_matches_jax(params, bits):
    base = _base(params, bits)
    jtr = _jax_trainable(params, bits)
    merged = jlora.apply_lora(base, jtr, JLCFG)
    got = tlora.apply_lora(_port(base), from_jax_tree(_host(jtr),
                                                      device="cpu"), TLCFG)
    x = np.random.default_rng(0).normal(
        size=(3, CFG.llm.hidden_size)).astype(np.float32)
    for name in ("wq", "wk"):
        jw = merged["llm"]["layers"][1]["attn"][name]
        tw = got["llm"]["layers"][1]["attn"][name]
        if bits == 16:
            np.testing.assert_allclose(tw.numpy(), np.asarray(jw),
                                       rtol=0, atol=1e-6)
        else:
            assert isinstance(jw, jquant.LoraAdapted)
            assert isinstance(tw, tquant.LoraAdapted)
            assert tw.scale == jw.scale == JLCFG.scale
            assert not tquant.is_quantized(tw)
            base_t = tw.base["q"] if bits == 8 else tw.base.q4
            base_j = jw.base["q"] if bits == 8 else jw.base.q4
            np.testing.assert_array_equal(base_t.numpy(), np.asarray(base_j))
        want = np.asarray(jquant.matmul(jnp.asarray(x), jw))
        y = tquant.matmul(torch.from_numpy(x), tw).numpy()
        np.testing.assert_allclose(y, want, rtol=0,
                                   atol=1e-5 * np.abs(want).max())
    # full trainables replace their leaves; untouched leaves are the base's
    np.testing.assert_array_equal(
        got["projector"]["w1"].numpy(), np.asarray(jtr["projector"]["w1"]))
    assert torch.equal(got["llm"]["embed_tokens"],
                       _port(base)["llm"]["embed_tokens"])


@pytest.mark.parametrize("bits", [16, 8, 4])
def test_lora_adapted_matmul_and_grads_match_jax(params, bits):
    base = _base(params, bits)["llm"]["layers"][0]["mlp"]["w_gate"]
    rng = np.random.default_rng(bits)
    din, dout = CFG.llm.hidden_size, CFG.llm.intermediate_size
    x = rng.normal(size=(2, 5, din)).astype(np.float32)
    A = (0.02 * rng.normal(size=(din, 4))).astype(np.float32)
    B = (0.05 * rng.normal(size=(4, dout))).astype(np.float32)
    g = rng.normal(size=(2, 5, dout)).astype(np.float32)

    def jloss(x, A, B):
        y = jquant.matmul(x, jquant.LoraAdapted(base, A, B, JLCFG.scale))
        return jnp.sum(y * g), y

    (_, jy), jgrads = jax.value_and_grad(jloss, argnums=(0, 1, 2),
                                         has_aux=True)(
        jnp.asarray(x), jnp.asarray(A), jnp.asarray(B))
    tbase = from_jax_tree(_host(base), device="cpu")
    tx, tA, tB = (torch.from_numpy(a).requires_grad_(True) for a in (x, A, B))
    y = tquant.matmul(tx, tquant.LoraAdapted(tbase, tA, tB, TLCFG.scale))
    (y * torch.from_numpy(g)).sum().backward()
    for got, want in zip((y.detach(), tx.grad, tA.grad, tB.grad),
                         (jy, *jgrads)):
        want = np.asarray(want)
        np.testing.assert_allclose(got.numpy(), want, rtol=0,
                                   atol=1e-5 * np.abs(want).max())


def _dyadic_trainable(params, bits):
    """JAX's trainable tree with A, B on a 1/64 grid of small values:
    A @ B is then exact in f32 in both frameworks."""
    tr = jlora.init_lora_trainable(jax.random.PRNGKey(1),
                                   _base(params, bits), JLCFG)
    rng = np.random.default_rng(7)

    def fill(path, x):
        key = jax.tree_util.keystr(path)
        if key.endswith("['A']") or key.endswith("['B']"):
            return jnp.asarray(rng.integers(-3, 4, size=x.shape) / 64.0,
                               jnp.float32)
        return x

    return jax.tree_util.tree_map_with_path(fill, tr)


@pytest.mark.parametrize("bits", [16, 8])
def test_merge_lora_into_params_matches_jax(params, bits):
    base = _base(params, bits)
    jtr = _dyadic_trainable(params, bits)
    want = jlora.merge_lora_into_params(base, jtr, JLCFG)
    got = tlora.merge_lora_into_params(
        _port(base), from_jax_tree(_host(jtr), device="cpu"), TLCFG)
    for layer in range(CFG.llm.num_hidden_layers):
        for grp, name in (("attn", "wq"), ("attn", "wv"), ("mlp", "w_down")):
            jw = want["llm"]["layers"][layer][grp][name]
            tw = got["llm"]["layers"][layer][grp][name]
            if bits == 8:
                np.testing.assert_array_equal(tw["q"].numpy(),
                                              np.asarray(jw["q"]))
                np.testing.assert_array_equal(
                    tw["scale"].float().numpy(),
                    np.asarray(jw["scale"], np.float32))
            else:
                np.testing.assert_allclose(tw.numpy(), np.asarray(jw),
                                           rtol=0, atol=1e-6)
    np.testing.assert_array_equal(got["projector"]["w2"].numpy(),
                                  np.asarray(want["projector"]["w2"]))


def test_merge_into_int4_raises_as_jax(params):
    base = _base(params, 4)
    jtr = _jax_trainable(params, 4)
    with pytest.raises(TypeError, match="int4"):
        jlora.merge_lora_into_params(base, jtr, JLCFG)
    with pytest.raises(TypeError, match="int4"):
        tlora.merge_lora_into_params(
            _port(base), from_jax_tree(_host(jtr), device="cpu"), TLCFG)


@pytest.mark.parametrize("bits", [8, 4])
def test_from_jax_params_carries_lora_adapted(params, bits):
    jtr = _jax_trainable(params, bits)
    adapted = jlora.apply_lora(_base(params, bits), jtr, JLCFG)
    tree = _port(adapted)
    for i in range(CFG.llm.num_hidden_layers):
        for grp, names in (("attn", ("wq", "wk", "wv", "wo")),
                           ("mlp", ("w_gate", "w_up", "w_down"))):
            for name in names:
                jw = adapted["llm"]["layers"][i][grp][name]
                tw = tree["llm"]["layers"][i][grp][name]
                assert isinstance(tw, tquant.LoraAdapted)
                assert tw.scale == jw.scale
                np.testing.assert_array_equal(tw.A.numpy(), np.asarray(jw.A))
                np.testing.assert_array_equal(tw.B.numpy(), np.asarray(jw.B))
                if bits == 8:
                    np.testing.assert_array_equal(tw.base["q"].numpy(),
                                                  np.asarray(jw.base["q"]))
                else:
                    assert tw.base.dims == tuple(jw.base.dims)
                    np.testing.assert_array_equal(tw.base.q4.numpy(),
                                                  np.asarray(jw.base.q4))
    # quantize_tree passes an adapted tree through, as JAX's does
    again = tquant.quantize_tree(tree, bits=8)
    assert again["llm"]["layers"][0]["attn"]["wq"] is \
        tree["llm"]["layers"][0]["attn"]["wq"]
    assert tquant.is_quantized(tree["llm"]["lm_head"])
