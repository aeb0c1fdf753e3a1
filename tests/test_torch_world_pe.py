"""The port's world-position variants against the JAX package on the CPU:
the min-max and sampled coordinate poolings and the average / max token
pools (``ops/geometry.py``), the n-point sin3d and the MLP world PEs
(``ops/pos_embed.py``), all to 2e-5 relative in f32; the collator's arrays
for min-max, sample-N and mrope batches, bit for bit; and on
``ModelConfig.tiny()`` in f32 with each variant, ``forward_hidden`` and
the loss to 1e-4 relative, and three train steps' loss and grad_norm to
1e-4 as ``tests/test_torch_train_step.py`` holds them. The engine: a
ScanQA answer of an MLP-PE and of an mrope model token for token with the
JAX engine's, and a min-max model, which the JAX engine cannot answer,
refused by the port."""

import json
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from video3d_tpu.config import (DataConfig, ModelConfig, PosEmbedType,
                                World3DConfig, replace)
from video3d_tpu.data import dataset as jds
from video3d_tpu.data.image_processor import SigLipImageProcessor
from video3d_tpu.data.video_processor import VideoProcessor
from video3d_tpu.eval import drivers as jdrv
from video3d_tpu.models import llava_video3d as jlv
from video3d_tpu.ops import geometry as jgeo
from video3d_tpu.ops import pos_embed as jpe
from video3d_tpu.train import optim as joptim
from video3d_tpu.train import train_step as jts
from video3d_tpu_torch.config import PosEmbedType as TPosEmbedType
from video3d_tpu_torch.data import dataset as tds
from video3d_tpu_torch.data.image_processor import \
    SigLipImageProcessor as TSigLipImageProcessor
from video3d_tpu_torch.data.video_processor import \
    VideoProcessor as TVideoProcessor
from video3d_tpu_torch.eval import drivers as tdrv
from video3d_tpu_torch.models import llava_video3d as tlv
from video3d_tpu_torch.ops import geometry as tgeo
from video3d_tpu_torch.ops import pos_embed as tpe
from video3d_tpu_torch.params import from_jax_params, init_model
from video3d_tpu_torch.train import optim as toptim
from video3d_tpu_torch.train import train_step as tts
from video3d_tpu_torch.train.trainer import to_batch

from fixtures import FakeTokenizer, make_fake_annotations, make_fake_scene
from port_configs import port_config

torch.set_num_threads(1)

BASE = ModelConfig.tiny()
# the reference's variant strings (llava_arch.py:395-429)
VARIANTS = ("minmax-discrete-sin3d", "sample9-discrete-sin3d",
            "sample5-discrete-sin3d", "avg-discrete-mlp",
            "sample1-discrete-mrope")
TRAINED = ("minmax-discrete-sin3d", "sample9-discrete-sin3d",
           "avg-discrete-mlp", "sample1-discrete-mrope")
OPT = dict(total_steps=4, learning_rate=1e-3, warmup_ratio=0.0)
RTOL = 2e-5


def variant(name: str) -> ModelConfig:
    return replace(BASE, world_3d=World3DConfig.from_reference_string(name))


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


@pytest.fixture(scope="module")
def jparams():
    """One JAX init with the MLP PE: the other variants use the same tree
    without its ``world_pe_mlp`` leaves (JAX draws them from their own
    key, so the rest of the tree is the same)."""
    return jax.tree.map(np.asarray, jlv.init_model(
        jax.random.PRNGKey(0), variant("avg-discrete-mlp")))


def _params_for(tree, cfg):
    return {k: v for k, v in tree.items()
            if k != "world_pe_mlp" or cfg.world_3d.pos_embed
            == PosEmbedType.MLP}


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("data"))
    info = make_fake_scene(root, n_frames=2)
    ann = make_fake_annotations(root, info["sample_idx"], n=2)
    with open(ann) as f:
        records = json.load(f)
    records[1]["conversations"][0]["value"] += " on the left of the door"
    with open(ann, "w") as f:
        json.dump(records, f)
    dc = DataConfig(video_folder=root,
                    annotation_dir=os.path.join(root, "embodiedscan"),
                    metadata_dir=os.path.join(root, "metadata"),
                    frames_upbound=2)
    jset = jds.SupervisedDataset(ann, FakeTokenizer(), dc,
                                 image_processor=SigLipImageProcessor(
                                     size=(56, 56)))
    samples = [jset[0], jset[1]]
    return root, info, dc, samples


def _collate(cfg, samples):
    jarr = jds.Collator(cfg, jds.CollatorConfig(max_len=160,
                                                frames_upbound=2))(samples)
    tarr = tds.Collator(port_config(cfg), tds.CollatorConfig(
        max_len=160, frames_upbound=2))(samples)
    return jarr, tarr


# ----------------------------------------------------------------------
# geometry and the PEs
# ----------------------------------------------------------------------


@pytest.mark.parametrize("pool", ["minmax", "sample9", "sample5", "sample1",
                                  "average", "max"])
def test_poolings_match_jax(pool):
    rng = np.random.default_rng(0)
    if pool in ("average", "max"):
        x = rng.normal(size=(3, 27 * 27, 8)).astype(np.float32)
        want = jgeo.pool_2d_tokens(jnp.asarray(x), 27, 2, pool)
        got = tgeo.pool_2d_tokens(torch.from_numpy(x), 27, 2, pool)
        assert got.shape == (3, 13 * 13, 8)
    else:
        wc = rng.uniform(-5, 5, size=(2, 60, 58, 3)).astype(np.float32)
        if pool == "minmax":
            want = jgeo.minmax_coordinate_in_patch(jnp.asarray(wc), 27)
            got = tgeo.minmax_coordinate_in_patch(torch.from_numpy(wc), 27)
            assert got.shape == (2, 2, 2, 2, 3)
            assert bool((got[..., 0, :] <= got[..., 1, :]).all())
        else:
            n = int(pool[-1])
            want = jgeo.sample_n_points(jnp.asarray(wc), n, 27)
            got = tgeo.sample_n_points(torch.from_numpy(wc), n, 27)
            assert got.shape == ((2, 2, 2, n, 3) if n > 1 else (2, 2, 2, 3))
    assert _rel(got.numpy(), want) <= RTOL


@pytest.mark.parametrize("D,n", [(3584, 2), (3584, 9), (64, 2), (69, 1)])
def test_sin3d_points_match_jax(D, n):
    """D = 3584 with two points gives 597 features per axis (odd)."""
    rng = np.random.default_rng(D + n)
    shape = (2, 11, n, 3) if n > 1 else (2, 11, 3)
    coords = np.round(rng.uniform(0, 300, size=shape)).astype(np.float32)
    want = jpe.sin3d_position_embedding(jnp.asarray(coords), D, n_points=n)
    got = tpe.sin3d_position_embedding(torch.from_numpy(coords), D,
                                       n_points=n)
    assert got.shape == (2, 11, D)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=RTOL)


@pytest.mark.parametrize("n", [1, 2])
def test_mlp_position_embedding_matches_jax(n):
    key = jax.random.PRNGKey(3)
    jp = jax.tree.map(np.asarray, jpe.init_mlp_position_embedding(key, 48))
    rng = np.random.default_rng(n)
    jp["b1"] = rng.normal(size=jp["b1"].shape).astype(np.float32)
    jp["ln_scale"] = rng.uniform(0.5, 1.5, jp["ln_scale"].shape).astype(
        np.float32)
    shape = (2, 7, n, 3) if n > 1 else (2, 7, 3)
    coords = np.round(rng.uniform(0, 300, size=shape)).astype(np.float32)
    want = jpe.mlp_position_embedding(jax.tree.map(jnp.asarray, jp),
                                      jnp.asarray(coords), n)
    got = tpe.mlp_position_embedding(
        {k: torch.from_numpy(v) for k, v in jp.items()},
        torch.from_numpy(coords), n)
    assert got.shape == tuple(want.shape)
    assert _rel(got.numpy(), want) <= RTOL


def test_init_mlp_position_embedding():
    """JAX's shapes, dtypes and ranges from an explicit generator; an MLP
    model draws the leaves after every other leaf, which stay as a sin3d
    model's of the same seed."""
    g = torch.Generator().manual_seed(0)
    p = tpe.init_mlp_position_embedding(48, "cpu", g)
    want = jpe.init_mlp_position_embedding(jax.random.PRNGKey(0), 48)
    assert {k: tuple(v.shape) for k, v in p.items()} == \
        {k: tuple(v.shape) for k, v in want.items()}
    assert float(p["w1"].abs().max()) <= 3 ** -0.5
    assert float(p["w2"].abs().max()) <= 512 ** -0.5
    assert float(p["w2"].std()) > 0.5 * 512 ** -0.5 / 3 ** 0.5
    assert not p["b1"].any() and not p["ln_bias"].any()
    assert bool((p["ln_scale"] == 1).all())
    tcfg = port_config(variant("avg-discrete-mlp"))
    mlp = init_model(tcfg, "cpu", torch.Generator().manual_seed(5),
                     torch.float32)
    sin = init_model(port_config(BASE), "cpu",
                     torch.Generator().manual_seed(5), torch.float32)
    assert set(mlp) == set(sin) | {"world_pe_mlp"}
    assert torch.equal(mlp["llm"]["lm_head"], sin["llm"]["lm_head"])


@pytest.mark.parametrize("name", ["avg-discrete-sin3d", "sample1-sin3d",
                                  "minmax-discrete-sin3d"])
def test_pool_and_discretize_coords_matches_jax(name):
    """The single-point poolings (patch means, the centre pixel), with and
    without the voxel discretization; an n-point pooling has no such
    route in either package."""
    cfg = replace(BASE, world_3d=World3DConfig.from_reference_string(name))
    wc = np.random.default_rng(2).uniform(
        -16, 16, size=(1, 2, 56, 56, 3)).astype(np.float32)
    got = lambda: tlv.pool_and_discretize_coords(torch.from_numpy(wc),
                                                 port_config(cfg))
    if cfg.world_3d.pooling.n_points > 1:
        with pytest.raises(KeyError):
            jlv.pool_and_discretize_coords(jnp.asarray(wc), cfg)
        with pytest.raises(ValueError, match="single-point"):
            got()
        return
    want = np.asarray(jlv.pool_and_discretize_coords(jnp.asarray(wc), cfg))
    assert got().shape == want.shape == (1, 2, 2, 2, 3)
    np.testing.assert_allclose(got().numpy(), want, rtol=RTOL, atol=0)


def test_world_position_embedding_dispatch(jparams):
    coords = np.round(np.random.default_rng(1).uniform(
        0, 300, size=(2, 5, 3))).astype(np.float32)
    for name in ("avg-discrete-sin3d", "avg-discrete-mlp"):
        cfg = variant(name)
        jp = _params_for(jparams, cfg)
        want = jlv.world_position_embedding(jax.tree.map(jnp.asarray, jp),
                                            jnp.asarray(coords), cfg)
        got = tlv.world_position_embedding(
            from_jax_params(jp, port_config(cfg), device="cpu"),
            torch.from_numpy(coords), port_config(cfg))
        assert _rel(got.numpy(), want) <= RTOL, name


# ----------------------------------------------------------------------
# the collator, the forward and the train steps
# ----------------------------------------------------------------------


@pytest.mark.parametrize("name", VARIANTS)
def test_collator_arrays_match_jax(data, name):
    jarr, tarr = _collate(variant(name), data[3])
    assert set(tarr) == set(jarr)
    for key, want in jarr.items():
        np.testing.assert_array_equal(np.asarray(tarr[key]),
                                      np.asarray(want), err_msg=key)
        assert np.asarray(tarr[key]).dtype == np.asarray(want).dtype, key
    n = variant(name).world_3d.pooling.n_points
    assert tarr["patch_coords"].shape[-2:] == ((n, 3) if n > 1 else (2, 3))
    if name.endswith("mrope"):
        # the vision rows carry voxel ids on the three axes
        vis = tarr["kind"] == 2
        ids = tarr["mrope_position_ids"][vis]
        assert (ids[:, 0] != ids[:, 1]).any()


@pytest.mark.parametrize("name", VARIANTS)
def test_forward_and_loss_match_jax(data, jparams, name):
    cfg = variant(name)
    tcfg = port_config(cfg)
    jarr, tarr = _collate(cfg, data[3])
    jp = _params_for(jparams, cfg)
    jbatch = jlv.Batch(**{k: jnp.asarray(v) for k, v in jarr.items()
                          if k in jlv.Batch._fields and v is not None})
    jh, _ = jlv.forward_hidden(jax.tree.map(jnp.asarray, jp), cfg, jbatch)
    jloss, _ = jts.loss_fn(jax.tree.map(jnp.asarray, jp), cfg, jbatch,
                           remat=False)
    tp = from_jax_params(jp, tcfg, device="cpu")
    tbatch = to_batch(tarr, "cpu")
    th, _ = tlv.forward_hidden(tp, tcfg, tbatch)
    tloss, _ = tts.loss_fn(tp, tcfg, tbatch, remat=False)
    assert _rel(th.detach().numpy(), jh) <= 1e-4
    np.testing.assert_allclose(float(tloss), float(jloss), rtol=1e-4)
    if tcfg.world_3d.pos_embed == TPosEmbedType.MROPE:
        assert tbatch.mrope_position_ids.dtype == torch.long


@pytest.mark.parametrize("name", TRAINED)
def test_three_f32_steps_match_jax(data, jparams, name):
    cfg = variant(name)
    tcfg = port_config(cfg)
    jarr, tarr = _collate(cfg, data[3])
    jp = _params_for(jparams, cfg)
    jstate_params = jax.tree.map(jnp.array, jp)   # the JAX step donates it
    jtx = joptim.build_optimizer(jstate_params, joptim.OptimConfig(**OPT))
    jstate = jts.create_train_state(jstate_params, jtx)
    jbatch = jlv.Batch(**{k: jnp.asarray(v) for k, v in jarr.items()
                          if k in jlv.Batch._fields and v is not None})
    tp = from_jax_params(jp, tcfg, device="cpu")
    ttx = toptim.build_optimizer(tp, toptim.OptimConfig(**OPT))
    tstate = tts.create_train_state(tp, ttx)
    tbatch = to_batch(tarr, "cpu")
    before = {k: v.clone() for k, v in tp.get("world_pe_mlp", {}).items()}
    for step in range(3):
        jstate, jm = jts.train_step(jstate, jbatch, cfg, jtx, remat=False,
                                    scan_layers=False)
        tstate, tm = tts.train_step(tstate, tbatch, tcfg, ttx, remat=True)
        for k in ("lm_loss", "grad_norm"):
            np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-4,
                                       err_msg=f"step {step} {k}")
    for k, v in before.items():      # the MLP PE trains
        assert not torch.equal(tstate.params["world_pe_mlp"][k], v), k


# ----------------------------------------------------------------------
# the engine
# ----------------------------------------------------------------------


def _engines(data, jparams, name):
    root, info, dc, _ = data
    cfg = variant(name)
    tok = FakeTokenizer()
    kw = dict(max_new_tokens=6, eos_token_id=tok.eos_token_id, max_frames=2,
              buckets=(256,), stop_str="")
    jp = _params_for(jparams, cfg)
    jeng = jdrv.InferenceEngine(
        jax.tree.map(jnp.asarray, jp), cfg, tok, VideoProcessor(dc),
        SigLipImageProcessor(size=(56, 56)), jdrv.EngineConfig(**kw),
        device_geometry=True)
    teng = tdrv.InferenceEngine(
        from_jax_params(jp, port_config(cfg), device="cpu"),
        port_config(cfg), tok, TVideoProcessor(port_config(dc)),
        TSigLipImageProcessor(size=(56, 56)), tdrv.EngineConfig(**kw),
        device="cpu")
    q = {"id": "q0", "video": info["sample_idx"],
         "conversations": [{"from": "human",
                            "value": "<image>\nwhat color is the chair"},
                           {"from": "gpt", "value": "brown"}]}
    return jeng, teng, q


@pytest.mark.parametrize("name", ["avg-discrete-mlp",
                                  "sample1-discrete-mrope"])
def test_engine_answers_match_jax(data, jparams, name):
    """The MLP PE of B1's voxel ids (AVG and SAMPLE1 take the device
    route, as in JAX), and an mrope model, whose engine batches carry text
    positions on the three axes, as the JAX engine's do."""
    jeng, teng, q = _engines(data, jparams, name)
    jres = jeng._generate(*jeng._prepare_generation(q))
    tres = teng._generate(*teng._prepare_generation(q))
    np.testing.assert_array_equal(tres.tokens.numpy(),
                                  np.asarray(jres.tokens))
    assert teng.generate_answer(q) == jeng.generate_answer(q)


def test_engine_refuses_minmax_as_jax_fails(data, jparams):
    """The JAX engine pools one mean per patch for every pooling, so a
    min-max model fails in its n-point PE; the port refuses it up front."""
    jeng, teng, q = _engines(data, jparams, "minmax-discrete-sin3d")
    with pytest.raises(TypeError, match="reshape"):
        jeng.generate_answer(q)
    with pytest.raises(ValueError, match="minmax coordinate pooling"):
        teng.generate_answer(q)


def test_mlp_pe_with_minmax_fails_as_in_jax(jparams):
    """The MLP PE of two points per patch gives two rows per patch in JAX,
    whose add to the patch features cannot broadcast; the port refuses
    the configuration by name."""
    cfg = variant("minmax-discrete-mlp")
    coords = np.ones((1, 2, 2, 2, 2, 3), np.float32)
    with pytest.raises(TypeError, match="broadcasting"):
        jlv.finish_video_tokens(jax.tree.map(jnp.asarray, jparams), cfg,
                                jnp.zeros((1, 2, 4, 64)),
                                jnp.zeros((1, 2, 16, 64)),
                                jnp.asarray(coords))
    tp = from_jax_params(jparams, port_config(cfg), device="cpu")
    with pytest.raises(ValueError, match="one point per patch"):
        tlv.finish_video_tokens(tp, port_config(cfg), torch.zeros(1, 2, 4, 64),
                                torch.zeros(1, 2, 16, 64),
                                torch.from_numpy(coords))
