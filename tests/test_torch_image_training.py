"""The port's 2D-image training modality against the JAX package on the
CPU (the reference's image branch, train_3d.py:1130-1171): the dataset's
image items (anyres tiles) and the collator's static gather-plan batch bit
for bit, then on f32 ``ModelConfig.tiny()`` ``forward_hidden`` and the
loss to 1e-4 relative, three train steps' loss and grad_norm to 1e-4 as
``tests/test_torch_train_step.py`` holds them, the vision tower's leaves
moved by them, and the port's batched vision block equal to its
per-image encode."""

import json

import numpy as np
import pytest
import torch
from PIL import Image

import jax
import jax.numpy as jnp

from video3d_tpu.config import DataConfig, ModelConfig, replace
from video3d_tpu.data import dataset as jds
from video3d_tpu.data.image_processor import SigLipImageProcessor
from video3d_tpu.models import llava_video3d as jlv
from video3d_tpu.train import optim as joptim
from video3d_tpu.train import train_step as jts
from video3d_tpu_torch.data import dataset as tds
from video3d_tpu_torch.data.image_processor import \
    SigLipImageProcessor as TSigLipImageProcessor
from video3d_tpu_torch.models import anyres as tam
from video3d_tpu_torch.models import llava_video3d as tlv
from video3d_tpu_torch.models.splice import KIND_VISION
from video3d_tpu_torch.params import from_jax_params
from video3d_tpu_torch.train import optim as toptim
from video3d_tpu_torch.train import train_step as tts
from video3d_tpu_torch.train.trainer import to_batch

from fixtures import FakeTokenizer
from port_configs import port_config

torch.set_num_threads(1)

PIN = ((112, 56), (56, 112), (112, 112))
CFG = replace(ModelConfig.tiny(), image_grid_pinpoints=PIN,
              image_aspect_ratio="anyres", mm_patch_merge_type="spatial_unpad")
TCFG = port_config(CFG)
SIZES = [(300, 200), (120, 400)]
OPT = dict(total_steps=4, learning_rate=1e-3, warmup_ratio=0.0)


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    root = tmp_path_factory.mktemp("imgtrain")
    rng = np.random.default_rng(0)
    for i, (w, h) in enumerate(SIZES):
        Image.fromarray(rng.integers(0, 255, (h, w, 3), dtype=np.uint8)).save(
            root / f"img{i}.png")
    with open(root / "data.json", "w") as f:
        json.dump([{"id": i, "image": f"img{i}.png",
                    "metadata": {"dataset": "scanqa"},
                    "conversations": [
                        {"from": "human", "value": "<image>\nwhat is shown"},
                        {"from": "gpt", "value": "a synthetic test pattern"}]}
                   for i in range(2)], f)
    dc = DataConfig(video_folder=str(root), image_folder=str(root),
                    image_aspect_ratio="anyres", image_grid_pinpoints=PIN,
                    add_spatial_instruction=False)
    jset = jds.SupervisedDataset(str(root / "data.json"), FakeTokenizer(), dc,
                                 image_processor=SigLipImageProcessor(
                                     size=(56, 56)))
    tset = tds.SupervisedDataset(str(root / "data.json"), FakeTokenizer(),
                                 port_config(dc),
                                 image_processor=TSigLipImageProcessor(
                                     size=(56, 56)))
    jitems, titems = [jset[0], jset[1]], [tset[0], tset[1]]
    jarr = jds.Collator(CFG, jds.CollatorConfig(max_len=256))(jitems)
    tarr = tds.Collator(TCFG, tds.CollatorConfig(max_len=256))(titems)
    params = jax.tree.map(np.asarray, jlv.init_model(jax.random.PRNGKey(0),
                                                     CFG))
    return jset, tset, jitems, titems, jarr, tarr, params


def test_items_collator_and_lengths_match_jax(data):
    jset, tset, jitems, titems, jarr, tarr, _ = data
    assert tset.lengths == jset.lengths
    assert tset.modality_lengths == jset.modality_lengths
    for j, t in zip(jitems, titems):
        assert set(t) == set(j)
        assert t["image_size"] == j["image_size"]
        for key in ("input_ids", "labels", "image_tiles"):
            np.testing.assert_array_equal(np.asarray(t[key]),
                                          np.asarray(j[key]), err_msg=key)
    assert set(tarr) == set(jarr)
    for key, want in jarr.items():
        if want is None:
            assert tarr[key] is None, key
            continue
        np.testing.assert_array_equal(tarr[key], want, err_msg=key)
        assert tarr[key].dtype == want.dtype, key
    # each row's spliced vision slots are its own plan's valid rows
    for row in range(2):
        assert int((tarr["kind"][row] == KIND_VISION).sum()) == \
            int(tarr["vision_valid"][row].sum())


def test_forward_and_loss_match_jax(data):
    *_, jarr, tarr, params = data
    jbatch = jlv.Batch(**{k: (jnp.asarray(v) if v is not None else None)
                          for k, v in jarr.items()
                          if k in jlv.Batch._fields})
    jp = jax.tree.map(jnp.asarray, params)
    jh, _ = jlv.forward_hidden(jp, CFG, jbatch)
    jloss, _ = jts.loss_fn(jp, CFG, jbatch, remat=False)
    tp = from_jax_params(params, TCFG, device="cpu")
    tbatch = to_batch(tarr, "cpu")
    assert tbatch.images is None and tbatch.patch_coords is None
    th, vt = tlv.forward_hidden(tp, TCFG, tbatch, remat=True)
    tloss, _ = tts.loss_fn(tp, TCFG, tbatch, remat=False)
    assert vt is None
    np.testing.assert_allclose(th.detach().numpy(), np.asarray(jh), rtol=0,
                               atol=1e-4 * float(np.abs(jh).max()))
    np.testing.assert_allclose(float(tloss), float(jloss), rtol=1e-4)
    # the batched gather equals each image's dynamic arrangement
    block = tam.encode_image_2d_batch(tp, TCFG, tbatch.image_tiles,
                                      tbatch.vision_gather,
                                      tbatch.vision_newline,
                                      tbatch.vision_valid)
    for row, size in enumerate(SIZES):
        n_tiles = int((tarr["image_tiles"][row] != 0).any(
            axis=(1, 2, 3)).sum())
        one = tam.encode_image_2d(tp, TCFG, tbatch.image_tiles[row, :n_tiles],
                                  size, PIN)
        np.testing.assert_array_equal(block[row, :one.shape[0]].numpy(),
                                      one.numpy())


def test_three_f32_steps_match_jax(data):
    *_, jarr, tarr, params = data
    jbatch = jlv.Batch(**{k: (jnp.asarray(v) if v is not None else None)
                          for k, v in jarr.items()
                          if k in jlv.Batch._fields})
    jp = jax.tree.map(jnp.array, params)           # the JAX step donates it
    jtx = joptim.build_optimizer(jp, joptim.OptimConfig(**OPT))
    jstate = jts.create_train_state(jp, jtx)
    tp = from_jax_params(params, TCFG, device="cpu")
    ttx = toptim.build_optimizer(tp, toptim.OptimConfig(**OPT))
    tstate = tts.create_train_state(tp, ttx)
    tbatch = to_batch(tarr, "cpu")
    before = tp["vision"]["patch_embed"]["w"].clone()
    for step in range(3):
        jstate, jm = jts.train_step(jstate, jbatch, CFG, jtx, remat=False,
                                    scan_layers=False)
        tstate, tm = tts.train_step(tstate, tbatch, TCFG, ttx, remat=True)
        for k in ("lm_loss", "grad_norm"):
            np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-4,
                                       err_msg=f"step {step} {k}")
    # the tower's leaves received gradients through the tiles
    assert not torch.equal(tstate.params["vision"]["patch_embed"]["w"],
                           before)


def test_trainer_evaluate_and_lora_run_image_batches(data, tmp_path):
    """``Trainer.evaluate()`` over the image records (one per batch, f32)
    equals the mean of JAX's per-image losses to 1e-4, and a LoRA
    ``Trainer.train()`` over them takes its mini-steps with finite losses
    and moves its adapters (the learning rate is 0 at the first update, so
    after two updates only B has moved)."""
    from video3d_tpu_torch.train.optim import (OptimConfig,
                                               tree_leaves_with_path)
    from video3d_tpu_torch.train.trainer import Trainer, TrainingConfig

    jset, tset, jitems, _, _, _, params = data
    jp = jax.tree.map(jnp.asarray, params)
    col = jds.Collator(CFG, jds.CollatorConfig(max_len=256))
    want = []
    for item in jitems:
        arr = col([item])
        jbatch = jlv.Batch(**{k: (jnp.asarray(v) if v is not None else None)
                              for k, v in arr.items()
                              if k in jlv.Batch._fields})
        want.append(float(jts.loss_fn(jp, CFG, jbatch, remat=False)[0]))

    def trainer(out, **kw):
        return Trainer(TCFG, from_jax_params(params, TCFG, device="cpu"),
                       tset, tds.Collator(TCFG, tds.CollatorConfig(
                           max_len=256)),
                       OptimConfig(total_steps=4, learning_rate=1e-2),
                       TrainingConfig(output_dir=str(tmp_path / out),
                                      group_by="none", bf16=False,
                                      gradient_accumulation_steps=1, **kw),
                       device="cpu")

    ev = trainer("eval").evaluate()
    assert ev["eval_batches"] == 2
    np.testing.assert_allclose(ev["eval_loss"], np.mean(want), rtol=1e-4)
    tr = trainer("lora", lora_r=4, lora_alpha=8)
    initial = {p: t.clone() for p, t in tree_leaves_with_path(
        tr.state.params)}
    state = tr.train(resume=False)
    assert state.step == 2
    moved = {p for p, t in tree_leaves_with_path(state.params)
             if not torch.equal(t, initial[p])}
    assert any(p.endswith("/B") for p in moved)
    assert not any(p.endswith("/A") for p in moved)
    assert np.isfinite(tr.evaluate()["eval_loss"])
