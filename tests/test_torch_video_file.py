"""The port's real-video-file modality against the JAX package on the CPU:
``load_video_file`` (cv2, the decord sampling contract) and
``time_instruction`` bit for bit, the dataset's video-file items and the
collator's arrays bit for bit, ``forward_hidden``, the loss and three f32
train steps to 1e-4 relative on ``ModelConfig.tiny()`` with the world PE
off (the reference's plain-video path), and
``generate_answer_video_file``'s greedy ids equal to the JAX engine's.
Skips where the JAX package's own test does: no mp4 encoder in cv2."""

import json
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from video3d_tpu.config import DataConfig, ModelConfig, PosEmbedType, replace
from video3d_tpu.data import dataset as jds
from video3d_tpu.data import video_file as jvf
from video3d_tpu.data.image_processor import SigLipImageProcessor
from video3d_tpu.data.video_processor import VideoProcessor
from video3d_tpu.eval import drivers as jdrv
from video3d_tpu.models import llava_video3d as jlv
from video3d_tpu.train import optim as joptim
from video3d_tpu.train import train_step as jts
from video3d_tpu_torch.data import dataset as tds
from video3d_tpu_torch.data import video_file as tvf
from video3d_tpu_torch.data.image_processor import \
    SigLipImageProcessor as TSigLipImageProcessor
from video3d_tpu_torch.data.video_processor import \
    VideoProcessor as TVideoProcessor
from video3d_tpu_torch.eval import drivers as tdrv
from video3d_tpu_torch.models import llava_video3d as tlv
from video3d_tpu_torch.params import from_jax_params
from video3d_tpu_torch.train import optim as toptim
from video3d_tpu_torch.train import train_step as tts
from video3d_tpu_torch.train.trainer import to_batch

from fixtures import FakeTokenizer, make_fake_scene
from port_configs import port_config

torch.set_num_threads(1)

CFG = ModelConfig.tiny()
PLAIN = replace(CFG, world_3d=replace(CFG.world_3d,
                                      pos_embed=PosEmbedType.NONE))
OPT = dict(total_steps=4, learning_rate=1e-3, warmup_ratio=0.0)


@pytest.fixture(scope="module")
def video_path(tmp_path_factory):
    import cv2

    path = str(tmp_path_factory.mktemp("vid") / "clip.mp4")
    w = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"mp4v"), 24.0,
                        (64, 48))
    if not w.isOpened():
        pytest.skip("no mp4 encoder in this cv2 build")
    rng = np.random.default_rng(0)
    for i in range(72):                       # 3 s @ 24 fps
        frame = np.full((48, 64, 3), i * 3 % 256, np.uint8)
        frame[:8, :8] = rng.integers(0, 255, (8, 8, 3), dtype=np.uint8)
        w.write(frame)
    w.release()
    if not os.path.exists(path) or os.path.getsize(path) == 0:
        pytest.skip("cv2 mp4 write produced nothing")
    return path


@pytest.fixture(scope="module")
def jparams():
    return jax.tree.map(np.asarray, jlv.init_model(jax.random.PRNGKey(0),
                                                   CFG))


@pytest.mark.parametrize("fps,upbound,force", [(1, 0, False), (12, 5, True),
                                               (24, 0, False)])
def test_loader_matches_jax(video_path, fps, upbound, force):
    got = tvf.load_video_file(video_path, fps, upbound, force)
    want = jvf.load_video_file(video_path, fps, upbound, force)
    np.testing.assert_array_equal(got[0], want[0])
    assert got[1:] == want[1:]
    if (fps, upbound) == (1, 0):
        assert got[3] == 3 and got[2] == "0.00s,1.00s,2.00s"


def test_time_instruction_matches_jax():
    for args in ((3.0, 3, "0.00s,1.00s,2.00s"), (12.345, 7, "0.50s")):
        assert tvf.time_instruction(*args) == jvf.time_instruction(*args)


@pytest.fixture(scope="module")
def batches(video_path, tmp_path_factory):
    """The dataset items of two video-file records (one with a longer
    question, so the rows are ragged) through both packages, with the
    time instruction on, and both collators' arrays."""
    ann = str(tmp_path_factory.mktemp("ann") / "ann.json")
    with open(ann, "w") as f:
        json.dump([{"id": f"v{i}", "video": video_path,
                    "conversations": [
                        {"from": "human", "value": q},
                        {"from": "gpt", "value": "a gradient ramps up"}]}
                   for i, q in enumerate(["<image>\nwhat happens",
                                          "what happens to the corner"])],
                  f)
    dc = DataConfig(video_folder="", annotation_dir="", metadata_dir="",
                    frames_upbound=3, add_time_instruction=True)
    jset = jds.SupervisedDataset(ann, FakeTokenizer(), dc,
                                 image_processor=SigLipImageProcessor(
                                     size=(56, 56)))
    tset = tds.SupervisedDataset(ann, FakeTokenizer(), port_config(dc),
                                 image_processor=TSigLipImageProcessor(
                                     size=(56, 56)))
    jitems, titems = [jset[0], jset[1]], [tset[0], tset[1]]
    col = dict(max_len=224, frames_upbound=3)
    jarr = jds.Collator(PLAIN, jds.CollatorConfig(**col))(jitems)
    tarr = tds.Collator(port_config(PLAIN), tds.CollatorConfig(**col))(
        titems)
    return jitems, titems, jarr, tarr


def test_dataset_items_and_collator_match_jax(batches):
    jitems, titems, jarr, tarr = batches
    for j, t in zip(jitems, titems):
        assert set(t) == set(j)
        for key in ("input_ids", "labels", "images", "world_coords",
                    "objects", "video_size"):
            np.testing.assert_array_equal(np.asarray(t[key]),
                                          np.asarray(j[key]), err_msg=key)
        assert t["video_size"] == 3 and not t["world_coords"].any()
        assert len(t["input_ids"]) > 30    # the time instruction is in
    assert set(tarr) == set(jarr)
    for key, want in jarr.items():
        np.testing.assert_array_equal(np.asarray(tarr[key]),
                                      np.asarray(want), err_msg=key)
    assert len(set(tarr["seq_len"].tolist())) == 2


def test_forward_loss_and_three_f32_steps_match_jax(batches, jparams):
    _, _, jarr, tarr = batches
    tcfg = port_config(PLAIN)
    jbatch = jlv.Batch(**{k: jnp.asarray(v) for k, v in jarr.items()
                          if k in jlv.Batch._fields and v is not None})
    tbatch = to_batch(tarr, "cpu")
    jp = jax.tree.map(jnp.array, jparams)          # the JAX step donates it
    tp = from_jax_params(jparams, tcfg, device="cpu")
    jh, _ = jlv.forward_hidden(jp, PLAIN, jbatch)
    th, _ = tlv.forward_hidden(tp, tcfg, tbatch)
    np.testing.assert_allclose(th.detach().numpy(), np.asarray(jh), rtol=0,
                               atol=1e-4 * float(np.abs(jh).max()))
    jtx = joptim.build_optimizer(jp, joptim.OptimConfig(**OPT))
    jstate = jts.create_train_state(jp, jtx)
    ttx = toptim.build_optimizer(tp, toptim.OptimConfig(**OPT))
    tstate = tts.create_train_state(tp, ttx)
    losses = []
    for step in range(3):
        jstate, jm = jts.train_step(jstate, jbatch, PLAIN, jtx, remat=False,
                                    scan_layers=False)
        tstate, tm = tts.train_step(tstate, tbatch, tcfg, ttx, remat=True)
        for k in ("lm_loss", "grad_norm"):
            np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-4,
                                       err_msg=f"step {step} {k}")
        losses.append(float(tm["lm_loss"]))
    assert losses[2] != losses[0]


def test_generate_answer_video_file_matches_jax(video_path, jparams,
                                                tmp_path_factory):
    """Greedy ids equal to the JAX engine's, with and without the time
    instruction; the per-call configuration leaves the engine's alone."""
    root = str(tmp_path_factory.mktemp("scene"))
    make_fake_scene(root, n_frames=3)
    dc = DataConfig(video_folder=root,
                    annotation_dir=os.path.join(root, "embodiedscan"),
                    metadata_dir=os.path.join(root, "metadata"),
                    frames_upbound=3)
    tok = FakeTokenizer()
    kw = dict(max_new_tokens=5, eos_token_id=tok.eos_token_id, max_frames=3,
              buckets=(256,), stop_str="")
    tcfg = port_config(CFG)
    jeng = jdrv.InferenceEngine(
        jax.tree.map(jnp.asarray, jparams), CFG, tok, VideoProcessor(dc),
        SigLipImageProcessor(size=(56, 56)), jdrv.EngineConfig(**kw))
    teng = tdrv.InferenceEngine(
        from_jax_params(jparams, tcfg, device="cpu"), tcfg, tok,
        TVideoProcessor(port_config(dc), device="cpu"),
        TSigLipImageProcessor(size=(56, 56)), tdrv.EngineConfig(**kw),
        device="cpu")
    seen = {}
    for name, eng in (("jax", jeng), ("torch", teng)):
        decode = eng._decode_text
        seen[name] = []

        def record(toks, decode=decode, out=seen[name]):
            out.append([int(t) for t in toks])
            return decode(toks)

        eng._decode_text = record
    for time_instr in (True, False):
        want = jeng.generate_answer_video_file("what happens here",
                                               video_path,
                                               add_time_instruction=time_instr)
        got = teng.generate_answer_video_file("what happens here",
                                              video_path,
                                              add_time_instruction=time_instr)
        assert got == want
    assert seen["torch"] == seen["jax"] and len(seen["torch"]) == 2
    assert teng.cfg is tcfg
    batch, plain = teng.prepare_video_file("what happens", video_path)
    assert plain.world_3d.pos_embed.value == "none"
    assert batch.images.shape[:2] == (1, 3) and batch.patch_coords is None
