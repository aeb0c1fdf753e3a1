"""The port's 2D-image (anyres) path against the JAX package on the CPU:
the host tiling (``data/anyres.py``) and the gather plans bit for bit,
the feature arrangement (unpad, newlines, the ``anyres_max_N`` bilinear
shrink, the ``flat`` / ``spatial`` / ``nobase`` merges) and the batched
and per-image encoders to 2e-5 relative on f32 ``ModelConfig.tiny()``,
and ``generate_answer_image``'s greedy ids equal to the JAX engine's in
each aspect and merge."""

import numpy as np
import pytest
import torch
from PIL import Image

import jax
import jax.numpy as jnp

from video3d_tpu.config import DataConfig, ModelConfig
from video3d_tpu.data import anyres as jar
from video3d_tpu.data.image_processor import SigLipImageProcessor
from video3d_tpu.data.video_processor import VideoProcessor
from video3d_tpu.eval import drivers as jdrv
from video3d_tpu.models import anyres as jam
from video3d_tpu.models import llava_video3d as jlv
from video3d_tpu_torch.data import anyres as tar
from video3d_tpu_torch.data.image_processor import \
    SigLipImageProcessor as TSigLipImageProcessor
from video3d_tpu_torch.data.video_processor import \
    VideoProcessor as TVideoProcessor
from video3d_tpu_torch.eval import drivers as tdrv
from video3d_tpu_torch.models import anyres as tam
from video3d_tpu_torch.params import from_jax_params

from fixtures import FakeTokenizer
from port_configs import port_config

torch.set_num_threads(1)

CFG = ModelConfig.tiny()
TCFG = port_config(CFG)
PIN = [[112, 56], [56, 112], [112, 112]]
PINPOINTS = [[384, 384], [768, 384], [384, 768], [768, 768], [1152, 384]]
HW = 4              # the tiny tower: 56 / 14 patches per side
RTOL = 2e-5


def random_image(w, h, seed):
    rng = np.random.default_rng(seed)
    return Image.fromarray(rng.integers(0, 255, (h, w, 3), dtype=np.uint8))


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


@pytest.fixture(scope="module")
def jparams():
    return jax.tree.map(np.asarray, jlv.init_model(jax.random.PRNGKey(0),
                                                   CFG))


# ----------------------------------------------------------------------
# host tiling, bit for bit
# ----------------------------------------------------------------------


def test_resolution_grid_and_range_syntax():
    rng = np.random.default_rng(0)
    for _ in range(50):
        size = (int(rng.integers(50, 2000)), int(rng.integers(50, 2000)))
        assert tar.select_best_resolution(size, PINPOINTS) == \
            jar.select_best_resolution(size, PINPOINTS)
    for pin in (PINPOINTS, "(1x1),...,(3x3)", "[[384, 768], [768, 384]]"):
        assert tar.get_anyres_image_grid_shape((640, 480), pin, 384) == \
            jar.get_anyres_image_grid_shape((640, 480), pin, 384)
        assert tar.parse_grid_pinpoints(pin, 384) == \
            jar.parse_grid_pinpoints(pin, 384)


@pytest.mark.parametrize("w,h", [(640, 480), (100, 900), (384, 384),
                                 (1300, 299)])
def test_pil_helpers_match_jax(w, h):
    img = random_image(w, h, w)
    pairs = [
        (tar.resize_and_pad_image(img, (768, 384)),
         jar.resize_and_pad_image(img, (768, 384))),
        (tar.expand2square(img, (127, 127, 127)),
         jar.expand2square(img, (127, 127, 127))),
        (tar.resize_and_center_crop(img, 384),
         jar.resize_and_center_crop(img, 384)),
    ]
    for a, b in pairs:
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    for overlap in (0.0, 0.5):
        if min(w, h) < 384:
            continue
        ours = tar.extract_patches(img, 384, overlap)
        theirs = jar.extract_patches(img, 384, overlap)
        assert len(ours) == len(theirs)
        for a, b in zip(ours, theirs):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    tiles = tar.divide_to_patches(tar.resize_and_pad_image(img, (768, 384)),
                                  384)
    want = jar.divide_to_patches(jar.resize_and_pad_image(img, (768, 384)),
                                 384)
    assert len(tiles) == len(want) == 2
    for a, b in zip(tiles, want):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


@pytest.mark.parametrize("aspect", ["anyres", "anyres_max_4", "highres",
                                    "crop_split", "pad", "square"])
def test_process_images_2d_matches_jax(aspect):
    """Every aspect's tiles, bit for bit (the port's processor is a copy
    of JAX's; the JAX processor here checks the copy)."""
    jproc = SigLipImageProcessor(size=(56, 56))
    tproc = TSigLipImageProcessor(size=(56, 56))
    pin = "56,112" if aspect == "highres" else PIN
    img = random_image(177, 121, 3)
    kw = dict(crop_resolution=112, split_resolution=56)
    got = tar.process_images_2d([img], tproc, aspect, pin, **kw)
    want = jar.process_images_2d([img], jproc, aspect, pin, **kw)
    got = got[0] if isinstance(got, list) else got
    want = want[0] if isinstance(want, list) else want
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


# ----------------------------------------------------------------------
# arrangement, gather plans and encoders
# ----------------------------------------------------------------------


def _feats(n_tiles, seed=0, D=16):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(n_tiles + 1, HW * HW, D)).astype(np.float32),
            rng.normal(size=(D,)).astype(np.float32))


ARRANGE = [
    ((640, 480), "anyres", "spatial_unpad", PIN),
    ((100, 900), "anyres", "spatial_unpad", PIN),
    ((600, 300), "anyres", "spatial", [[112, 56]]),
    ((640, 480), "anyres", "spatial_unpad_nobase", PIN),
    ((500, 500), "highres", "spatial_unpad", None),
    ((256, 256), "crop_split", "flat", None),
    ((800, 790), "anyres_max_4", "spatial_unpad", [[224, 224]]),
]


@pytest.mark.parametrize("image_size,aspect,merge,pin", ARRANGE)
def test_arrange_and_gather_plan_match_jax(image_size, aspect, merge, pin):
    """``arrange_anyres_features`` against JAX's (the shrink to 2e-5, the
    rest bit for bit), and the gather plan, bit for bit, except for
    ``anyres_max_N``, which both refuse to plan."""
    if aspect.startswith("anyres"):
        npw, nph = jar.get_anyres_image_grid_shape(image_size, pin, 56)
    else:
        npw = nph = 2
    feats, newline = _feats(npw * nph, seed=len(merge))
    want = np.asarray(jam.arrange_anyres_features(
        jnp.asarray(feats), image_size, pin, 56, HW, jnp.asarray(newline),
        image_aspect_ratio=aspect, patch_merge_type=merge))
    got = tam.arrange_anyres_features(
        torch.from_numpy(feats), image_size, pin, 56, HW,
        torch.from_numpy(newline), image_aspect_ratio=aspect,
        patch_merge_type=merge).numpy()
    assert got.shape == want.shape
    if aspect.startswith("anyres_max"):
        assert got.shape[0] < (npw * nph + 1) * HW * HW   # it shrank
        assert _rel(got, want) <= RTOL
        with pytest.raises(NotImplementedError, match="no gather plan"):
            tam.build_anyres_gather_plan(image_size, pin, 56, HW, aspect,
                                         merge)
        return
    np.testing.assert_array_equal(got, want)
    g, m = tam.build_anyres_gather_plan(image_size, pin, 56, HW, aspect,
                                        merge)
    jg, jm = jam.build_anyres_gather_plan(image_size, pin, 56, HW, aspect,
                                          merge)
    for a, b in ((g, jg), (m, jm)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


def test_unpad_image_matches_jax():
    x = np.arange(3 * 8 * 12, dtype=np.float32).reshape(3, 8, 12)
    for size in ((640, 480), (100, 900), (300, 300)):
        np.testing.assert_array_equal(
            tam.unpad_image(torch.from_numpy(x), size).numpy(),
            np.asarray(jam.unpad_image(jnp.asarray(x), size)))


def test_encoders_match_jax(jparams):
    """The batched gather-plan encoder and the per-image encoder against
    JAX's, on two images of different grids (zero-padded tiles and plan
    rows)."""
    tp = from_jax_params(jparams, TCFG, device="cpu")
    jp = jax.tree.map(jnp.asarray, jparams)
    proc = SigLipImageProcessor(size=(56, 56))
    sizes = [(300, 200), (120, 500)]
    tiles_list = [jar.process_anyres_image(random_image(*sz, seed=i), proc,
                                           PIN) for i, sz in enumerate(sizes)]
    plans = [jam.build_anyres_gather_plan(sz, PIN, 56, HW) for sz in sizes]
    maxT = max(t.shape[0] for t in tiles_list)
    Tv = max(p[0].shape[0] for p in plans)
    tiles = np.zeros((2, maxT, 3, 56, 56), np.float32)
    gather = np.zeros((2, Tv), np.int32)
    nl = np.zeros((2, Tv), bool)
    valid = np.zeros((2, Tv), bool)
    for b, (t, (g, m)) in enumerate(zip(tiles_list, plans)):
        tiles[b, :t.shape[0]] = t
        gather[b, :len(g)] = g
        nl[b, :len(m)] = m
        valid[b, :len(g)] = True
    want = np.asarray(jam.encode_image_2d_batch(
        jp, CFG, jnp.asarray(tiles), jnp.asarray(gather), jnp.asarray(nl),
        jnp.asarray(valid)))
    got = tam.encode_image_2d_batch(
        tp, TCFG, torch.from_numpy(tiles), torch.from_numpy(gather).long(),
        torch.from_numpy(nl), torch.from_numpy(valid)).numpy()
    assert _rel(got, want) <= RTOL
    for b, (t, sz) in enumerate(zip(tiles_list, sizes)):
        one = tam.encode_image_2d(tp, TCFG, torch.from_numpy(t), sz,
                                  PIN).numpy()
        jone = np.asarray(jam.encode_image_2d(jp, CFG, jnp.asarray(t), sz,
                                              PIN))
        assert _rel(one, jone) <= RTOL
        np.testing.assert_array_equal(got[b, :one.shape[0]], one)
        assert not got[b, one.shape[0]:].any()   # padding rows zeroed


# ----------------------------------------------------------------------
# the engine
# ----------------------------------------------------------------------


@pytest.fixture(scope="module")
def engines(jparams, tmp_path_factory):
    root = str(tmp_path_factory.mktemp("img"))
    tok = FakeTokenizer()
    kw = dict(max_new_tokens=5, eos_token_id=tok.eos_token_id,
              buckets=(256,), stop_str="")
    jeng = jdrv.InferenceEngine(
        jax.tree.map(jnp.asarray, jparams), CFG, tok,
        VideoProcessor(DataConfig(video_folder=root)),
        SigLipImageProcessor(size=(56, 56)), jdrv.EngineConfig(**kw),
        device_geometry=False)
    teng = tdrv.InferenceEngine(
        from_jax_params(jparams, TCFG, device="cpu"), TCFG, tok,
        TVideoProcessor(port_config(DataConfig(video_folder=root)),
                        device="cpu"),
        TSigLipImageProcessor(size=(56, 56)), tdrv.EngineConfig(**kw),
        device="cpu")
    return jeng, teng


def _ids(engine):
    """Record the token ids an engine decodes into text."""
    seen = []
    decode = engine._decode_text

    def record(toks):
        seen.append([int(t) for t in toks])
        return decode(toks)

    engine._decode_text = record
    return seen


@pytest.mark.parametrize("aspect,merge,pin,size", [
    ("anyres", "spatial_unpad", PIN, (300, 200)),
    ("anyres", "spatial", PIN, (120, 300)),
    ("anyres", "spatial_unpad_nobase", PIN, (300, 200)),
    ("anyres_max_2", "spatial_unpad", [[112, 112]], (80, 200)),
    ("highres", "spatial_unpad", "56,112", (150, 140)),
    ("crop_split", "flat", None, (130, 170)),
    ("pad", None, None, (90, 60)),
])
def test_generate_answer_image_matches_jax(engines, aspect, merge, pin,
                                           size):
    jeng, teng = engines
    jids, tids = _ids(jeng), _ids(teng)
    img = random_image(*size, seed=sum(size))
    kw = dict(image_aspect_ratio=aspect, grid_pinpoints=pin,
              patch_merge_type=merge, crop_resolution=112,
              split_resolution=56)
    want = jeng.generate_answer_image("what color is the chair", img, **kw)
    got = teng.generate_answer_image("what color is the chair", img, **kw)
    assert tids == jids and len(tids) == 1
    assert got == want
