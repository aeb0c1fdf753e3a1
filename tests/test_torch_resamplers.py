"""The vision resamplers in the port against the JAX package, on the CPU in
float32: spatial_pool (average, max, conv), masked_drop on JAX's own noise
draw, the perceiver and the Q-Former (random trees from JAX's inits carried
across), ``apply_resampler``'s dispatch, ``convert_resampler`` on state
dicts in the reference's naming, and ``load_pretrained_model`` of a
checkpoint with resampler keys."""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from video3d_tpu.models import builder as jb
from video3d_tpu.models import resampler as jrs
from video3d_tpu.models import weights as jw
from video3d_tpu_torch.models import builder as tb
from video3d_tpu_torch.models import resampler as trs
from video3d_tpu_torch.models import weights as tw
from video3d_tpu_torch.params import from_jax_tree

from test_builder import build_fake_checkpoint

torch.set_num_threads(1)

ATOL = 2e-5


def _t(tree):
    return from_jax_tree(jax.tree.map(np.asarray, tree), device="cpu")


def close(got, want, atol=ATOL):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=0, atol=atol)


def _feats(shape, seed=0):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


@pytest.mark.parametrize("mode", ["average", "max", "conv"])
@pytest.mark.parametrize("grid,hw", [(8, (112, 112)), (7, (98, 98))])
def test_spatial_pool_matches_jax(mode, grid, hw):
    jp = jrs.init_spatial_pool(jax.random.PRNGKey(0), 12, 20, mode=mode)
    x = _feats((2, grid * grid, 12))
    want = jrs.spatial_pool(jp, jnp.asarray(x), hw, mode=mode)
    got = trs.spatial_pool(_t(jp), torch.from_numpy(x), hw, mode=mode)
    assert got.shape == want.shape
    close(got, want)


def test_masked_drop_on_jax_noise():
    """The port's masked_drop fed the noise JAX draws from its key keeps
    the tokens JAX keeps; random_masking's mask and restore ids too."""
    x = _feats((3, 16, 8))
    key = jax.random.PRNGKey(7)
    want = jrs.masked_drop(jnp.asarray(x), key, ratio=0.25)
    noise = np.asarray(jax.random.uniform(key, x.shape[:2]))
    got = trs.masked_drop(torch.from_numpy(x), torch.from_numpy(noise),
                          ratio=0.25)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    jm = jrs.random_masking(jnp.asarray(x), 5, jnp.asarray(noise))
    tm = trs.random_masking(torch.from_numpy(x), 5, torch.from_numpy(noise))
    for a, b in zip(tm, jm):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    # the modes that take no draw, and a draw from a torch.Generator
    np.testing.assert_array_equal(
        trs.masked_drop(torch.from_numpy(x), training=False).numpy(), x)
    assert trs.masked_drop(torch.from_numpy(x), mode="cls_only").shape == \
        (3, 1, 8)
    gen = torch.Generator().manual_seed(0)
    kept = trs.masked_drop(torch.from_numpy(x), generator=gen, num_keep=6,
                           mode="range")
    assert kept.shape == (3, 6, 8)
    rows = {tuple(r) for r in x.reshape(-1, 8).tolist()}
    assert all(tuple(r) in rows for r in kept.reshape(-1, 8).tolist())


def test_perceiver_matches_jax():
    jp = jrs.init_perceiver(jax.random.PRNGKey(1), 32, depth=2,
                            num_latents=6, dim_head=8, heads=4)
    x = _feats((2, 10, 32))
    want = jrs._perceiver_attention(jp["layers"][0]["attn"], jnp.asarray(x),
                                    jnp.asarray(_feats((2, 6, 32), 1)), 4)
    got = trs._perceiver_attention(_t(jp)["layers"][0]["attn"],
                                   torch.from_numpy(x),
                                   torch.from_numpy(_feats((2, 6, 32), 1)), 4)
    close(got, want)
    close(trs.perceiver_resampler(_t(jp), torch.from_numpy(x), heads=4),
          jrs.perceiver_resampler(jp, jnp.asarray(x), heads=4))


def test_qformer_matches_jax():
    jp = jrs.init_qformer(jax.random.PRNGKey(2), 20, num_latents=5,
                          num_layers=3, hidden=48, intermediate=96)
    # non-zero query tokens (JAX's init leaves them zero)
    jp["query_tokens"] = jnp.asarray(_feats((5, 48), 3))
    x = _feats((2, 9, 20))
    close(trs.qformer_resampler(_t(jp), torch.from_numpy(x), num_heads=12),
          jrs.qformer_resampler(jp, jnp.asarray(x), num_heads=12), 5e-5)


@pytest.mark.parametrize("kind", [None, "identity", "spatial_pool",
                                  "masked_drop", "perceiver", "qformer"])
def test_apply_resampler_dispatch_matches_jax(kind):
    x = _feats((2, 64, 32))
    key = jax.random.PRNGKey(3)
    jp = {"spatial_pool": lambda: {},
          "perceiver": lambda: jrs.init_perceiver(key, 32, depth=1,
                                                  num_latents=4),
          "qformer": lambda: jrs.init_qformer(key, 32, num_latents=4,
                                              num_layers=2)}.get(
        kind, lambda: {})()
    want = jrs.apply_resampler(kind, jp, jnp.asarray(x), images_hw=(112, 112),
                               rng=key, training=True)
    noise = torch.from_numpy(np.asarray(jax.random.uniform(key, (2, 64))))
    got = trs.apply_resampler(kind, _t(jp), torch.from_numpy(x),
                              images_hw=(112, 112), noise=noise,
                              training=True)
    close(got, want, 5e-5)
    with pytest.raises(ValueError, match="Unknown resampler"):
        trs.apply_resampler("nonsense", {}, torch.from_numpy(x))


def perceiver_state(dim=32, inner=64, n=6, depth=2, seed=0,
                    prefix="model.vision_resampler."):
    rng = np.random.default_rng(seed)
    st = {prefix + "perceiver.latents": rng.normal(size=(n, dim)),
          prefix + "perceiver.norm.weight": 1 + 0.1 * rng.normal(size=dim),
          prefix + "perceiver.norm.bias": 0.1 * rng.normal(size=dim)}
    for i in range(depth):
        p = f"{prefix}perceiver.layers.{i}."
        for ln in ("0.norm_media", "0.norm_latents", "1.0"):
            st[f"{p}{ln}.weight"] = 1 + 0.1 * rng.normal(size=dim)
            st[f"{p}{ln}.bias"] = 0.1 * rng.normal(size=dim)
        st[p + "0.to_q.weight"] = 0.2 * rng.normal(size=(inner, dim))
        st[p + "0.to_kv.weight"] = 0.2 * rng.normal(size=(2 * inner, dim))
        st[p + "0.to_out.weight"] = 0.2 * rng.normal(size=(dim, inner))
        st[p + "1.1.weight"] = 0.2 * rng.normal(size=(4 * dim, dim))
        st[p + "1.3.weight"] = 0.2 * rng.normal(size=(dim, 4 * dim))
    return {k: np.asarray(v, np.float32) for k, v in st.items()}


def qformer_state(width=20, hidden=48, n=5, layers=2, seed=0,
                  prefix="model.vision_resampler."):
    rng = np.random.default_rng(seed)
    st = {prefix + "ln_vision.weight": 1 + 0.1 * rng.normal(size=width),
          prefix + "ln_vision.bias": 0.1 * rng.normal(size=width),
          prefix + "query_tokens": rng.normal(size=(1, n, hidden)),
          prefix + "Qformer.bert.embeddings.LayerNorm.weight":
          1 + 0.1 * rng.normal(size=hidden),
          prefix + "Qformer.bert.embeddings.LayerNorm.bias":
          0.1 * rng.normal(size=hidden)}

    def attn(p, kv):
        for n_, d in (("query", hidden), ("key", kv), ("value", kv)):
            st[f"{p}self.{n_}.weight"] = 0.2 * rng.normal(size=(hidden, d))
            st[f"{p}self.{n_}.bias"] = 0.1 * rng.normal(size=hidden)
        st[p + "output.dense.weight"] = 0.2 * rng.normal(size=(hidden, hidden))
        st[p + "output.dense.bias"] = 0.1 * rng.normal(size=hidden)
        st[p + "output.LayerNorm.weight"] = 1 + 0.1 * rng.normal(size=hidden)
        st[p + "output.LayerNorm.bias"] = 0.1 * rng.normal(size=hidden)

    for i in range(layers):
        p = f"{prefix}Qformer.bert.encoder.layer.{i}."
        attn(p + "attention.", hidden)
        if i % 2 == 0:
            attn(p + "crossattention.", width)
        st[p + "intermediate_query.dense.weight"] = \
            0.2 * rng.normal(size=(2 * hidden, hidden))
        st[p + "intermediate_query.dense.bias"] = \
            0.1 * rng.normal(size=2 * hidden)
        st[p + "output_query.dense.weight"] = \
            0.2 * rng.normal(size=(hidden, 2 * hidden))
        st[p + "output_query.dense.bias"] = 0.1 * rng.normal(size=hidden)
        st[p + "output_query.LayerNorm.weight"] = \
            1 + 0.1 * rng.normal(size=hidden)
        st[p + "output_query.LayerNorm.bias"] = 0.1 * rng.normal(size=hidden)
    return {k: np.asarray(v, np.float32) for k, v in st.items()}


def _leaves_equal(t, j, path=""):
    if isinstance(j, dict):
        assert set(t) == set(j), path
        for k in j:
            _leaves_equal(t[k], j[k], f"{path}/{k}")
    elif isinstance(j, (list, tuple)):
        assert len(t) == len(j), path
        for i, (a, b) in enumerate(zip(t, j)):
            _leaves_equal(a, b, f"{path}/{i}")
    else:
        np.testing.assert_array_equal(t.numpy(), np.asarray(j), err_msg=path)


def test_convert_resampler_matches_jax():
    rng = np.random.default_rng(4)
    pool = {"model.vision_resampler.pool.weight":
            rng.normal(size=(20, 12, 2, 2)).astype(np.float32),
            "model.vision_resampler.pool.bias":
            rng.normal(size=20).astype(np.float32)}
    for kind, st in (("spatial_pool", pool), ("spatial_pool", {}),
                     ("masked_drop", {}), ("perceiver", perceiver_state()),
                     ("qformer", qformer_state())):
        want = jax.tree.map(np.asarray, jw.convert_resampler(st, kind))
        got = tw.convert_resampler(st, kind, device="cpu")
        _leaves_equal(got, want, kind)
    x = _feats((2, 64, 12))
    close(trs.spatial_pool(tw.convert_resampler(pool, "spatial_pool",
                                                device="cpu"),
                           torch.from_numpy(x), (112, 112), mode="conv"),
          jrs.spatial_pool(jw.convert_resampler(pool, "spatial_pool"),
                           jnp.asarray(x), (112, 112), mode="conv"))
    with pytest.raises(ValueError, match="Unknown resampler"):
        tw.convert_resampler({}, "nonsense", device="cpu")


def test_load_pretrained_model_with_resampler_keys(tmp_path):
    """A checkpoint whose config names a perceiver and holds its keys: the
    port's load carries ``params["resampler"]`` as JAX's load does."""
    path = str(tmp_path / "ckpt")
    build_fake_checkpoint(path)
    with open(os.path.join(path, "config.json")) as f:
        cfg = json.load(f)
    cfg["mm_resampler_type"] = "perceiver"
    with open(os.path.join(path, "config.json"), "w") as f:
        json.dump(cfg, f)
    state = tw.load_safetensors_dir(path)
    state.update({k: torch.from_numpy(v) for k, v in
                  perceiver_state().items()})
    os.remove(os.path.join(path, "model.safetensors"))
    tw.write_safetensors(state, os.path.join(path, "model.safetensors"))
    _, jparams, jcfg, _ = jb.load_pretrained_model(path, dtype=jnp.float32,
                                                   load_tokenizer=False)
    _, tparams, tcfg, _ = tb.load_pretrained_model(
        path, dtype=torch.float32, load_tokenizer=False, device="cpu")
    assert tcfg.resampler_type == jcfg.resampler_type == "perceiver"
    _leaves_equal(tparams["resampler"],
                  jax.tree.map(np.asarray, jparams["resampler"]))
    x = _feats((1, 9, 32))
    close(trs.perceiver_resampler(tparams["resampler"], torch.from_numpy(x)),
          jrs.perceiver_resampler(jparams["resampler"], jnp.asarray(x)))


def _shapes(tree):
    if isinstance(tree, dict):
        return {k: _shapes(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_shapes(v) for v in tree]
    return tuple(tree.shape)


def test_inits_match_jax_shapes():
    """The port's random inits (drawn from a torch.Generator) give JAX's
    trees, shape for shape."""
    gen = torch.Generator().manual_seed(0)
    key = jax.random.PRNGKey(0)
    pairs = (
        (trs.init_spatial_pool(12, 20, "cpu", gen),
         jrs.init_spatial_pool(key, 12, 20)),
        (trs.init_perceiver(32, "cpu", gen, depth=2, num_latents=6),
         jrs.init_perceiver(key, 32, depth=2, num_latents=6)),
        (trs.init_qformer(20, "cpu", gen, num_latents=5, num_layers=3,
                          hidden=48, intermediate=96),
         jrs.init_qformer(key, 20, num_latents=5, num_layers=3, hidden=48,
                          intermediate=96)))
    for got, want in pairs:
        assert _shapes(got) == _shapes(jax.tree.map(np.asarray, want))
