"""The port's DPO modules (``train/dpo.py``, ``train/dpo_data.py``) against
the JAX package's on the CPU, at ``ModelConfig.tiny()`` with the weights of
JAX ``init_model`` trees (``from_jax_params``):

* ``sequence_logprob`` with IGNORE_INDEX positions (and a row with none
  supervised) within 1e-5 relative (f32 log-softmax sums);
* ``dpo_loss`` and its metrics with and without label smoothing within
  1e-6;
* ``DPODataset`` / ``DPOCollator``: both sides' arrays bit for bit JAX's;
* three ``dpo_train_step``s with AdamW (learning rate 0 at the first
  update, so the third step reads the moved policy), the policy from one
  init and the reference from another: each step's ``dpo_loss`` and
  ``reward_margin`` within 1e-4 (f32 compute) or 5e-3 (bf16 compute over
  f32 masters) times the loss, ``reward_accuracy`` equal, the reference's
  leaves bit for bit unchanged, the policy's moved. In bf16 the two
  frameworks' log-probabilities come from bf16 logits summed over the
  response; their losses lay 8.5e-4 and margins 1.7e-3 apart (relative to
  the loss) when this was written, f32 ones 6e-6;
* with the policy equal to the reference the loss is log 2 and the margin
  0.
"""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from video3d_tpu.config import DataConfig, ModelConfig
from video3d_tpu.data import dataset as jds
from video3d_tpu.data.image_processor import SigLipImageProcessor
from video3d_tpu.data.video_processor import VideoProcessor
from video3d_tpu.models import llava_video3d as jlv
from video3d_tpu.train import dpo as jdpo
from video3d_tpu.train import dpo_data as jdpo_data
from video3d_tpu.train import optim as joptim
from video3d_tpu.train.train_step import create_train_state as jcreate
from video3d_tpu_torch.constants import IGNORE_INDEX
from video3d_tpu_torch.data import dataset as tds
from video3d_tpu_torch.data.image_processor import \
    SigLipImageProcessor as TSigLipImageProcessor
from video3d_tpu_torch.data.video_processor import \
    VideoProcessor as TVideoProcessor
from video3d_tpu_torch.params import from_jax_params
from video3d_tpu_torch.train import dpo as tdpo
from video3d_tpu_torch.train import dpo_data as tdpo_data
from video3d_tpu_torch.train import optim as toptim
from video3d_tpu_torch.train.optim import tree_leaves
from video3d_tpu_torch.train.train_step import create_train_state
from video3d_tpu_torch.train.trainer import to_batch

from fixtures import FakeTokenizer, make_fake_scene
from port_configs import port_config

torch.set_num_threads(1)

CFG = ModelConfig.tiny()
TCFG = port_config(CFG)
OPT = dict(total_steps=4, learning_rate=1e-3, warmup_ratio=0.0)


def test_sequence_logprob_masks_ignore():
    rng = np.random.default_rng(0)
    logits = rng.normal(size=(3, 7, 11)).astype(np.float32)
    labels = rng.integers(0, 11, size=(3, 7))
    labels[0, :4] = IGNORE_INDEX
    labels[1, ::2] = IGNORE_INDEX
    labels[2, 1:] = IGNORE_INDEX                # nothing supervised
    want = np.asarray(jdpo.sequence_logprob(jnp.asarray(logits),
                                            jnp.asarray(labels)))
    got = tdpo.sequence_logprob(torch.from_numpy(logits),
                                torch.from_numpy(labels)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    assert got[2] == 0.0
    # a masked position's logits do not count
    moved = logits.copy()
    moved[0, :3] += 5.0
    again = tdpo.sequence_logprob(torch.from_numpy(moved),
                                  torch.from_numpy(labels)).numpy()
    assert again[0] == got[0]


@pytest.mark.parametrize("smoothing", [0.0, 0.1])
def test_dpo_loss_matches_jax(smoothing):
    rng = np.random.default_rng(1)
    lps = [rng.normal(size=5).astype(np.float32) * 3 for _ in range(4)]
    loss, metrics = jdpo.dpo_loss(*map(jnp.asarray, lps), jdpo.DPOConfig(
        beta=0.2, label_smoothing=smoothing))
    tloss, tmetrics = tdpo.dpo_loss(*map(torch.from_numpy, lps),
                                    tdpo.DPOConfig(beta=0.2,
                                                   label_smoothing=smoothing))
    np.testing.assert_allclose(float(tloss), float(loss), rtol=1e-6)
    assert set(tmetrics) == set(metrics)
    for k in metrics:
        np.testing.assert_allclose(float(tmetrics[k]), float(metrics[k]),
                                   rtol=1e-6, atol=1e-7, err_msg=k)


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("data"))
    info = make_fake_scene(root, n_frames=2)
    dc = DataConfig(video_folder=root,
                    annotation_dir=os.path.join(root, "embodiedscan"),
                    metadata_dir=os.path.join(root, "metadata"),
                    frames_upbound=2)
    records = [{"id": "p0", "video": info["sample_idx"],
                "prompt": "what color is the chair",
                "chosen": "brown wooden chair", "rejected": "blue sofa"},
               {"id": "p1", "video": info["sample_idx"],
                "prompt": "<image>\nhow many lamps are there",
                "chosen": "two", "rejected": "none at all"}]
    jset = jdpo_data.DPODataset(records, FakeTokenizer(), VideoProcessor(dc),
                                SigLipImageProcessor(size=(56, 56)),
                                frames_upbound=2)
    tset = tdpo_data.DPODataset(
        records, FakeTokenizer(), TVideoProcessor(port_config(dc),
                                                  device="cpu"),
        TSigLipImageProcessor(size=(56, 56)), frames_upbound=2)
    jcol = jdpo_data.DPOCollator(jds.Collator(CFG, jds.CollatorConfig(
        max_len=160, frames_upbound=2)))
    tcol = tdpo_data.DPOCollator(tds.Collator(TCFG, tds.CollatorConfig(
        max_len=160, frames_upbound=2)))
    return jset, jcol, tset, tcol


def test_dpo_data_matches_jax(data):
    jset, jcol, tset, tcol = data
    assert len(tset) == len(jset) == 2
    for rec in jset.records:
        assert tdpo_data.dpo_record_to_conversations(rec) == \
            jdpo_data.dpo_record_to_conversations(rec)
    jpairs = [jset[i] for i in range(2)]
    tpairs = [tset[i] for i in range(2)]
    for jp, tp in zip(jpairs, tpairs):
        for js, ts in zip(jp, tp):
            assert set(ts) == set(js)
            for k in ("input_ids", "labels", "images", "world_coords"):
                np.testing.assert_array_equal(np.asarray(ts[k]),
                                              np.asarray(js[k]), err_msg=k)
    for jside, tside in zip(jcol(jpairs), tcol(tpairs)):
        assert set(tside) == set(jside)
        for k, want in jside.items():
            np.testing.assert_array_equal(np.asarray(tside[k]),
                                          np.asarray(want), err_msg=k)
    chosen, rejected = tcol(tpairs)
    assert (chosen["labels"] != rejected["labels"]).any()


def _pair(arrays, device="cpu"):
    return tuple(to_batch(a, device) for a in arrays)


def _jbatch(a):
    return jlv.Batch(**{k: jnp.asarray(v) for k, v in a.items()
                        if k in jlv.Batch._fields and v is not None})


@pytest.mark.parametrize("compute", ["float32", "bfloat16"])
def test_dpo_train_steps_match_jax(data, compute):
    jset, jcol, tset, tcol = data
    jarrays = jcol([jset[0], jset[1]])
    tarrays = tcol([tset[0], tset[1]])
    policy = jlv.init_model(jax.random.PRNGKey(0), CFG)
    ref = jlv.init_model(jax.random.PRNGKey(5), CFG)
    tpolicy = from_jax_params(jax.tree.map(np.array, policy), TCFG,
                              device="cpu")
    tref = from_jax_params(jax.tree.map(np.array, ref), TCFG, device="cpu")
    ref_before = [t.clone() for t in tree_leaves(tref)]
    policy_before = [t.clone() for t in tree_leaves(tpolicy)]
    jtx = joptim.build_optimizer(policy, joptim.OptimConfig(**OPT))
    ttx = toptim.build_optimizer(tpolicy, toptim.OptimConfig(**OPT))
    jstate, tstate = jcreate(policy, jtx), create_train_state(tpolicy, ttx)
    jcdt = jnp.bfloat16 if compute == "bfloat16" else None
    tcdt = torch.bfloat16 if compute == "bfloat16" else None
    rel = 5e-3 if compute == "bfloat16" else 1e-4
    dcfg = (jdpo.DPOConfig(beta=0.5), tdpo.DPOConfig(beta=0.5))
    jpair = tuple(_jbatch(a) for a in jarrays)
    for step in range(3):
        jstate, jm = jdpo.dpo_train_step(jstate, ref, jpair, CFG, dcfg[0],
                                         jtx, remat=False,
                                         compute_dtype=jcdt)
        tstate, tm = tdpo.dpo_train_step(tstate, tref, _pair(tarrays), TCFG,
                                         dcfg[1], ttx, remat=True,
                                         compute_dtype=tcdt)
        assert set(tm) == set(jm) | {"grad_norm"}
        scale = abs(float(jm["dpo_loss"]))
        for k in ("dpo_loss", "reward_margin"):
            np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=0,
                                       atol=rel * scale,
                                       err_msg=f"step {step} {k}")
        assert float(tm["reward_accuracy"]) == float(jm["reward_accuracy"])
        assert np.isfinite(float(tm["grad_norm"]))
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(tref),
                                                 ref_before))
    moved = [not torch.equal(a, b) for a, b in zip(
        tree_leaves(tstate.params), policy_before)]
    assert sum(moved) > len(moved) // 2
    assert all(t.dtype == torch.float32 for t in tree_leaves(tstate.params))


def test_policy_equal_to_reference_reads_log_two(data):
    _, _, tset, tcol = data
    tarrays = tcol([tset[0]])
    params = from_jax_params(jax.tree.map(
        np.array, jlv.init_model(jax.random.PRNGKey(0), CFG)), TCFG,
        device="cpu")
    loss, metrics = tdpo.dpo_step_loss(params, params, TCFG,
                                       *_pair(tarrays), tdpo.DPOConfig())
    np.testing.assert_allclose(float(loss), np.log(2.0), rtol=1e-6)
    assert float(metrics["reward_margin"]) == 0.0
    assert float(metrics["reward_accuracy"]) == 0.0
