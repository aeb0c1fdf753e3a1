"""The other vision towers in the port against the JAX package, on the CPU
in float32 at test widths: CLIP (``select_layer``) and CLIP under S2, the
HF towers' hidden states with every ``feature_select`` mode, OpenCLIP,
ImageBind's vision trunk, their converters on state dicts the test builds
in each checkpoint's naming, and ``build_vision_tower``'s dispatch."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from video3d_tpu.config import VisionConfig
from video3d_tpu.models import clip as jclip
from video3d_tpu.models import hf_vision as jhf
from video3d_tpu.models import imagebind as jib
from video3d_tpu.models import weights as jw
from video3d_tpu.ops import resize as jresize
from video3d_tpu_torch.models import clip as tclip
from video3d_tpu_torch.models import hf_vision as thf
from video3d_tpu_torch.models import imagebind as tib
from video3d_tpu_torch.models import weights as tw
from video3d_tpu_torch.ops import resize as tresize
from video3d_tpu_torch.params import from_jax_tree

from port_configs import port_config

torch.set_num_threads(1)

ATOL = 2e-5     # f32 towers of a few layers, other reduction orders
CFG = VisionConfig(hidden_size=32, intermediate_size=64, num_hidden_layers=3,
                   num_attention_heads=4, image_size=28, patch_size=14)
TCFG = port_config(CFG)


def close(got, want, atol=ATOL):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=0, atol=atol)


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


def _encoder_layers(st, rng, prefix, n, D, I, names):
    ln1, ln2, attn, fc1, fc2 = names
    for i in range(n):
        p = prefix.format(i)
        for ln in (ln1, ln2):
            st[p + ln + ".weight"] = 1 + 0.1 * rng.normal(size=D)
            st[p + ln + ".bias"] = 0.1 * rng.normal(size=D)
        if attn == "in_proj":
            st[p + "attn.in_proj_weight"] = 0.2 * rng.normal(size=(3 * D, D))
            st[p + "attn.in_proj_bias"] = 0.1 * rng.normal(size=3 * D)
            st[p + "attn.out_proj.weight"] = 0.2 * rng.normal(size=(D, D))
            st[p + "attn.out_proj.bias"] = 0.1 * rng.normal(size=D)
        else:
            for n_ in ("q_proj", "k_proj", "v_proj", "out_proj"):
                st[f"{p}self_attn.{n_}.weight"] = \
                    0.2 * rng.normal(size=(D, D))
                st[f"{p}self_attn.{n_}.bias"] = 0.1 * rng.normal(size=D)
        st[p + fc1 + ".weight"] = 0.2 * rng.normal(size=(I, D))
        st[p + fc1 + ".bias"] = 0.1 * rng.normal(size=I)
        st[p + fc2 + ".weight"] = 0.2 * rng.normal(size=(D, I))
        st[p + fc2 + ".bias"] = 0.1 * rng.normal(size=D)


def _f32(st):
    return {k: np.asarray(v, np.float32) for k, v in st.items()}


def hf_clip_state(cfg, seed=0, prefix="vision_model."):
    rng = np.random.default_rng(seed)
    D, ps = cfg.hidden_size, cfg.patch_size
    st = {prefix + "embeddings.patch_embedding.weight":
          0.1 * rng.normal(size=(D, 3, ps, ps)),
          prefix + "embeddings.class_embedding": rng.normal(size=D),
          prefix + "embeddings.position_embedding.weight":
          0.1 * rng.normal(size=(cfg.num_patches + 1, D)),
          prefix + "pre_layrnorm.weight": 1 + 0.1 * rng.normal(size=D),
          prefix + "pre_layrnorm.bias": 0.1 * rng.normal(size=D)}
    _encoder_layers(st, rng, prefix + "encoder.layers.{}.",
                    cfg.num_hidden_layers, D, cfg.intermediate_size,
                    ("layer_norm1", "layer_norm2", "hf", "mlp.fc1",
                     "mlp.fc2"))
    return _f32(st)


def hf_siglip_state(cfg, seed=0):
    rng = np.random.default_rng(seed)
    D, ps = cfg.hidden_size, cfg.patch_size
    p = "vision_model."
    st = {p + "embeddings.patch_embedding.weight":
          0.1 * rng.normal(size=(D, 3, ps, ps)),
          p + "embeddings.patch_embedding.bias": 0.1 * rng.normal(size=D),
          p + "embeddings.position_embedding.weight":
          0.1 * rng.normal(size=(cfg.num_patches, D))}
    _encoder_layers(st, rng, p + "encoder.layers.{}.", cfg.num_hidden_layers,
                    D, cfg.intermediate_size,
                    ("layer_norm1", "layer_norm2", "hf", "mlp.fc1",
                     "mlp.fc2"))
    return _f32(st)


def open_clip_state(cfg, seed=0):
    rng = np.random.default_rng(seed)
    D, ps = cfg.hidden_size, cfg.patch_size
    st = {"visual.conv1.weight": 0.1 * rng.normal(size=(D, 3, ps, ps)),
          "visual.class_embedding": rng.normal(size=D),
          "visual.positional_embedding":
          0.1 * rng.normal(size=(cfg.num_patches + 1, D)),
          "visual.ln_pre.weight": 1 + 0.1 * rng.normal(size=D),
          "visual.ln_pre.bias": 0.1 * rng.normal(size=D)}
    _encoder_layers(st, rng, "visual.transformer.resblocks.{}.",
                    cfg.num_hidden_layers, D, cfg.intermediate_size,
                    ("ln_1", "ln_2", "in_proj", "mlp.c_fc", "mlp.c_proj"))
    return _f32(st)


def imagebind_state(cfg, seed=0):
    rng = np.random.default_rng(seed)
    D, ps = cfg.hidden_size, cfg.patch_size
    n_tok = (cfg.image_size // ps) ** 2 + 1
    pre, trunk = "modality_preprocessors.vision.", "modality_trunks.vision."
    head = "modality_heads.vision."
    st = {pre + "rgbt_stem.proj.1.weight":
          0.1 * rng.normal(size=(D, 3, 2, ps, ps)),
          pre + "cls_token": rng.normal(size=(1, 1, D)),
          pre + "pos_embedding_helper.pos_embed":
          0.1 * rng.normal(size=(1, n_tok, D)),
          trunk + "pre_transformer_layer.0.weight":
          1 + 0.1 * rng.normal(size=D),
          trunk + "pre_transformer_layer.0.bias": 0.1 * rng.normal(size=D),
          head + "0.weight": 1 + 0.1 * rng.normal(size=D),
          head + "0.bias": 0.1 * rng.normal(size=D),
          head + "2.weight": 0.2 * rng.normal(size=(cfg.out_dim, D))}
    _encoder_layers(st, rng, trunk + "blocks.{}.", cfg.num_hidden_layers, D,
                    D * cfg.mlp_ratio,
                    ("norm_1", "norm_2", "in_proj", "mlp.fc1", "mlp.fc2"))
    return _f32(st)


def _pixels(B, S, seed=1):
    return np.random.default_rng(seed).normal(size=(B, 3, S, S)) \
        .astype(np.float32)


@pytest.fixture(scope="module")
def clip_trees():
    st = hf_clip_state(CFG)
    return (jax.tree.map(np.asarray, jclip.convert_clip(st, CFG)),
            tclip.convert_clip(st, TCFG, device="cpu"))


def test_convert_clip_matches_jax(clip_trees):
    _leaves_equal(clip_trees[1], clip_trees[0])


@pytest.mark.parametrize("select_layer", [-2, -1, 1])
def test_clip_tower_matches_jax(clip_trees, select_layer):
    jp, tp = clip_trees
    px = _pixels(2, 28)
    want = jclip.clip_tower_forward(jp, jnp.asarray(px), CFG,
                                    select_layer=select_layer)
    got = tclip.clip_tower_forward(tp, torch.from_numpy(px), TCFG,
                                   select_layer=select_layer)
    assert got.shape == (2, CFG.num_patches, CFG.hidden_size)
    close(got, want)


@pytest.mark.parametrize("sizes", [(5, 9), (12, 28), (28, 28), (9, 5)])
def test_bicubic_and_area_match_jax(sizes):
    a, b = sizes
    np.testing.assert_array_equal(tresize.bicubic_resize_matrix(a, b),
                                  jresize.bicubic_resize_matrix(a, b))
    x = _pixels(2, a)
    close(tresize.bicubic_resize(torch.from_numpy(x), b, b),
          jresize.bicubic_resize(jnp.asarray(x), b, b), 1e-5)
    y = _pixels(1, 12)
    close(tresize.area_downsample(torch.from_numpy(y), 4),
          jresize.area_downsample(jnp.asarray(y), 4), 1e-6)


def test_clip_s2_matches_jax(clip_trees):
    """S2 at (28, 56, 84) over the 28-pixel tower: chessboard split, the
    tower per tile, merge, area downsample and the channel concat."""
    jp, tp = clip_trees
    px = _pixels(2, 84)
    scales = (28, 56, 84)
    want = jclip.clip_s2_forward(jp, jnp.asarray(px), CFG, scales=scales)
    got = tclip.clip_s2_forward(tp, torch.from_numpy(px), TCFG, scales=scales)
    assert got.shape == (2, CFG.num_patches, 3 * CFG.hidden_size)
    close(got, want, 5e-5)


@pytest.mark.parametrize("family", ["clip", "siglip"])
@pytest.mark.parametrize("feature", ["patch", "cls_patch", "slicefour_patch",
                                     "slicefour_cls_patch"])
def test_hf_tower_feature_select_matches_jax(family, feature):
    cfg = VisionConfig(hidden_size=32, intermediate_size=64,
                       num_hidden_layers=7, num_attention_heads=4,
                       image_size=28, patch_size=14)
    if family == "clip":
        st = hf_clip_state(cfg)
        jp = jclip.convert_clip(st, cfg)
        tp = tclip.convert_clip(st, port_config(cfg), device="cpu")
    else:
        st = hf_siglip_state(cfg)
        jp = jw.convert_siglip(st, cfg)
        tp = tw.convert_siglip(st, port_config(cfg), device="cpu")
    px = _pixels(2, 28)
    want = jhf.hf_vision_tower_forward(jp, jnp.asarray(px), cfg,
                                       family=family, select_layer=-2,
                                       select_feature=feature)
    got = thf.hf_vision_tower_forward(tp, torch.from_numpy(px),
                                      port_config(cfg), family=family,
                                      select_layer=-2,
                                      select_feature=feature)
    close(got, want)


@pytest.mark.parametrize("quick_gelu", [False, True])
def test_open_clip_matches_jax(quick_gelu):
    st = open_clip_state(CFG)
    jp = jhf.convert_open_clip(st)
    tp = thf.convert_open_clip(st, device="cpu")
    _leaves_equal(tp, jax.tree.map(np.asarray, jp))
    px = _pixels(2, 28)
    for feature in ("patch", "cls_patch"):
        want = jhf.open_clip_tower_forward(jp, jnp.asarray(px), CFG,
                                           select_feature=feature,
                                           quick_gelu=quick_gelu)
        got = thf.open_clip_tower_forward(tp, torch.from_numpy(px), TCFG,
                                          select_feature=feature,
                                          quick_gelu=quick_gelu)
        close(got, want)


def test_imagebind_matches_jax():
    cfg = jib.ImageBindConfig.tiny()
    tcfg = tib.ImageBindConfig.tiny()
    st = imagebind_state(cfg)
    jp = jib.convert_imagebind(st, cfg)
    tp = tib.convert_imagebind(st, tcfg, device="cpu")
    _leaves_equal(tp, jax.tree.map(np.asarray, jp))
    px = _pixels(3, 28)
    want = jib.imagebind_vision_forward(jp, jnp.asarray(px), cfg)
    got = tib.imagebind_vision_forward(tp, torch.from_numpy(px), tcfg)
    assert got.shape == (3, 1, cfg.out_dim)
    close(got, want)
    np.testing.assert_allclose(got.norm(dim=-1).numpy(), 1.0, rtol=1e-6)
    # a random tower from JAX's init carries across and runs alike
    ji = jax.tree.map(np.asarray, jib.init_imagebind(jax.random.PRNGKey(0),
                                                     cfg))
    close(tib.imagebind_vision_forward(from_jax_tree(ji, device="cpu"),
                                       torch.from_numpy(px), tcfg),
          jib.imagebind_vision_forward(ji, jnp.asarray(px), cfg))
    assert dataclasses.asdict(tib.ImageBindConfig()) == \
        dataclasses.asdict(jib.ImageBindConfig())


@pytest.mark.parametrize("name,family,maker", [
    ("google/siglip-so400m-patch14-384", "siglip", hf_siglip_state),
    ("hf:openai/clip-vit-large-patch14", "hf", hf_clip_state),
    # a 'siglip' substring wins over the 'hf:' prefix (the reference's
    # order of rules)
    ("hf:google/siglip-base", "siglip", hf_siglip_state),
    ("open_clip_hub:ViT-H-14", "open_clip", open_clip_state),
    ("openai/clip-vit-large-patch14-336", "clip", hf_clip_state),
])
def test_build_vision_tower_dispatch_matches_jax(name, family, maker):
    jt = jhf.build_vision_tower(name, CFG)
    tt = thf.build_vision_tower(name, TCFG, device="cpu")
    assert jt.family == tt.family == family
    st = maker(CFG)
    px = _pixels(2, 28)
    close(tt.forward(tt.convert(st), torch.from_numpy(px)),
          jt.forward(jt.convert(st), jnp.asarray(px)))


def test_build_vision_tower_s2_and_imagebind():
    jt = jhf.build_vision_tower("openai/clip", CFG, use_s2=True,
                                s2_scales="56,28")
    tt = thf.build_vision_tower("openai/clip", TCFG, use_s2=True,
                                s2_scales="56,28", device="cpu")
    assert jt.family == tt.family == "clip_s2"
    st = hf_clip_state(CFG)
    px = _pixels(1, 56)
    close(tt.forward(tt.convert(st), torch.from_numpy(px)),
          jt.forward(jt.convert(st), jnp.asarray(px)), 5e-5)
    tib_tower = thf.build_vision_tower("imagebind_huge", device="cpu")
    assert tib_tower.family == "imagebind" and tib_tower.cfg is None
    with pytest.raises(ValueError, match="Unknown vision tower"):
        thf.build_vision_tower("nonsense-tower", device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            thf.build_vision_tower("openai/clip", TCFG)


def test_random_towers_have_the_converted_layout():
    """``init_clip`` draws the tree ``convert_clip`` reads, and
    ``init_imagebind`` JAX's ``init_imagebind`` tree, shape for shape."""
    def shapes(tree):
        if isinstance(tree, dict):
            return {k: shapes(v) for k, v in tree.items()}
        if isinstance(tree, (list, tuple)):
            return [shapes(v) for v in tree]
        return tuple(tree.shape)

    gen = torch.Generator().manual_seed(0)
    assert shapes(tclip.init_clip(TCFG, "cpu", gen)) == shapes(
        tclip.convert_clip(hf_clip_state(CFG), TCFG, device="cpu"))
    cfg = jib.ImageBindConfig.tiny()
    assert shapes(tib.init_imagebind(tib.ImageBindConfig.tiny(), "cpu",
                                     gen)) == shapes(jax.tree.map(
        np.asarray, jib.init_imagebind(jax.random.PRNGKey(0), cfg)))
