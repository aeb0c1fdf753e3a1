"""The port's ``train_step`` against the JAX package's on
``ModelConfig.tiny()``: the same weights (``from_jax_params``), the same
collated batch of two ragged rows (``make_fake_scene`` + ``FakeTokenizer``)
and the same optimizer settings. Three float32 steps: loss and grad_norm
per step within 1e-4 relative (f32, other reduction orders; the attention
backward is B6's plain version against XLA's autodiff of the plain
attention). One step with bf16 compute over f32 master weights: loss within
1e-3 and grad_norm within 5e-3 relative (the frameworks round bf16 products
and sums at different points; the two read 2.5e-5 and 1.9e-4 apart when
this test was written)."""

import json
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from video3d_tpu.config import DataConfig, ModelConfig
from video3d_tpu.data import dataset as jds
from video3d_tpu.data.image_processor import SigLipImageProcessor
from video3d_tpu.models import llava_video3d as jlv
from video3d_tpu.train import optim as joptim
from video3d_tpu.train import train_step as jts
from video3d_tpu_torch.params import from_jax_params
from video3d_tpu_torch.train import optim as toptim
from video3d_tpu_torch.train import train_step as tts
from video3d_tpu_torch.train.trainer import to_batch

from fixtures import FakeTokenizer, make_fake_annotations, make_fake_scene
from port_configs import port_config

torch.set_num_threads(1)

CFG = ModelConfig.tiny()
TCFG = port_config(CFG)
USED = ("vision", "projector", "image_newline", "llm")
OPT = dict(total_steps=4, learning_rate=1e-3, warmup_ratio=0.0)


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("data"))
    info = make_fake_scene(root, n_frames=2)
    ann = make_fake_annotations(root, info["sample_idx"], n=2)
    with open(ann) as f:
        records = json.load(f)
    # a longer question in row 1, so the batch's rows are ragged
    records[1]["conversations"][0]["value"] += " on the left of the door"
    with open(ann, "w") as f:
        json.dump(records, f)
    dc = DataConfig(video_folder=root,
                    annotation_dir=os.path.join(root, "embodiedscan"),
                    metadata_dir=os.path.join(root, "metadata"),
                    frames_upbound=2)
    ds = jds.SupervisedDataset(ann, FakeTokenizer(), dc,
                               image_processor=SigLipImageProcessor(
                                   size=(56, 56)))
    col = jds.Collator(CFG, jds.CollatorConfig(max_len=160, frames_upbound=2))
    arrays = col([ds[0], ds[1]])
    assert len(set(arrays["seq_len"].tolist())) == 2      # ragged rows
    jbatch = jlv.Batch(**{k: jnp.asarray(v) for k, v in arrays.items()
                          if k in jlv.Batch._fields and v is not None})
    full = jlv.init_model(jax.random.PRNGKey(0), CFG)
    jparams = {k: full[k] for k in USED}
    return arrays, jbatch, jparams


def _run(setup, steps, compute):
    arrays, jbatch, params = setup
    jparams = jax.tree.map(jnp.array, params)     # the JAX step donates it
    jtx = joptim.build_optimizer(jparams, joptim.OptimConfig(**OPT))
    jstate = jts.create_train_state(jparams, jtx)
    tparams = from_jax_params(jax.tree.map(np.asarray, params), TCFG,
                              device="cpu")
    ttx = toptim.build_optimizer(tparams, toptim.OptimConfig(**OPT))
    tstate = tts.create_train_state(tparams, ttx)
    tbatch = to_batch(arrays, "cpu")
    out = []
    for _ in range(steps):
        jstate, jm = jts.train_step(
            jstate, jbatch, CFG, jtx, remat=False, scan_layers=False,
            compute_dtype=jnp.bfloat16 if compute else None)
        tstate, tm = tts.train_step(
            tstate, tbatch, TCFG, ttx, remat=True,
            compute_dtype=torch.bfloat16 if compute else None)
        out.append({k: (float(tm[k]), float(jm[k]))
                    for k in ("lm_loss", "grad_norm")})
    return out, tstate, jstate


def test_three_f32_steps_match_jax(setup):
    out, tstate, jstate = _run(setup, 3, compute=False)
    for step, m in enumerate(out):
        for key, (got, want) in m.items():
            np.testing.assert_allclose(got, want, rtol=1e-4,
                                       err_msg=f"step {step} {key}")
    # the losses moved: updates were applied (learning rate > 0 from the
    # first step with warmup_ratio 0)
    assert out[2]["lm_loss"][0] != out[0]["lm_loss"][0]
    assert tstate.step == 3


def test_bf16_compute_step_matches_jax(setup):
    (m,), tstate, _ = _run(setup, 1, compute=True)
    np.testing.assert_allclose(*m["lm_loss"], rtol=1e-3)
    np.testing.assert_allclose(*m["grad_norm"], rtol=5e-3)
    # the master weights stay f32
    assert tstate.params["llm"]["lm_head"].dtype == torch.float32


def test_cast_to_compute_keeps_non_f32_leaves():
    tree = {"a": torch.zeros(2), "b": [torch.zeros(2, dtype=torch.int8)],
            "c": torch.zeros(2, dtype=torch.bfloat16)}
    out = tts.cast_to_compute(tree)
    assert out["a"].dtype == torch.bfloat16
    assert out["b"][0].dtype == torch.int8
    assert out["c"] is tree["c"]
