"""The port's grounding train step against the JAX package's on the CPU, at
``ModelConfig.tiny()`` (INFONCE head) with the weights of one JAX
``init_model`` tree, ground head included (``from_jax_params``):

* ``infonce_loss`` / ``bce_ground_loss`` against JAX's with -inf pads and
  a zero target, within 1e-6 (f32 logsumexps in another order), and the
  gradient reaching a padded object's feature finite (zero);
* the collator's grounding arrays bit for bit equal to JAX's (a
  multi-label Multi3DRefer row and a row whose label is past its objects);
* two f32 ground mini-steps against JAX's ``Trainer._ground_step_fn``:
  loss and grad_norm within 1e-4 relative (f32, other reduction orders),
  the ground head's leaves moved, every parameter finite; one with bf16
  compute over f32 master weights within BF16_REL (1e-2) relative, not
  ``test_torch_train_step.py``'s 1e-3 / 5e-3: the head's cosines are bf16
  and the loss divides them by 0.07, so one bf16 ulp of a cosine (2^-9
  near 0.1-1) moves a logit by up to 0.028; on these queries each
  framework's bf16 loss lies 0.03-0.7% from the f32 loss, and the two
  lay 3.3e-3 (loss) and 4.4e-3 (grad_norm) apart when this was written;
* a mixed ScanQA + ScanRefer ``Trainer.train()`` (four mini-steps, two per
  update): per-step metric keys equal to JAX's, losses within 1e-4;
* ``evaluate()`` against JAX's within 1e-5 relative;
* JAX's ground step uses batch row 0 only, and so does the port's; the
  MLP / SCORE heads' (N,) scores do not meet the (N+1,) target, in JAX
  (which cannot trace it) and in the port (a ValueError naming the head).
"""

import dataclasses
import json
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from video3d_tpu.config import DataConfig, GroundHeadType, ModelConfig
from video3d_tpu.data import dataset as jds
from video3d_tpu.data.image_processor import SigLipImageProcessor
from video3d_tpu.models import llava_video3d as jlv
from video3d_tpu.parallel.mesh import create_mesh
from video3d_tpu.train import optim as joptim
from video3d_tpu.train import trainer as jtrainer
from video3d_tpu_torch.config import GroundHeadType as THead
from video3d_tpu_torch.data import dataset as tds
from video3d_tpu_torch.data.image_processor import \
    SigLipImageProcessor as TSigLipImageProcessor
from video3d_tpu_torch.models import llava_video3d as tlv
from video3d_tpu_torch.params import from_jax_params
from video3d_tpu_torch.train import optim as toptim
from video3d_tpu_torch.train import trainer as ttrainer
from video3d_tpu_torch.train.optim import tree_leaves

from fixtures import FakeTokenizer, make_fake_scene
from port_configs import port_config

torch.set_num_threads(1)

CFG = ModelConfig.tiny()
TCFG = port_config(CFG)
GROUND = 301         # FakeTokenizer's <ground>
MAX_OBJECTS = 6      # the fake scene has 5: one padded slot
OPT = dict(total_steps=4, learning_rate=1e-3, warmup_ratio=0.0)
BF16_REL = 1e-2
KEYS = ("world_coords_full", "objects", "objects_valid", "ground_slot",
        "box_label_hot")


def _records(info):
    """Two ScanQA questions, a ScanRefer query and a Multi3DRefer query."""
    qa = [{"id": f"q{i}", "video": info["sample_idx"],
           "conversations": [
               {"from": "human", "value": f"<image>\nWhat is object {i} ?"},
               {"from": "gpt", "value": f"a brown chair {i}"}],
           "metadata": {"dataset": "scanqa"}} for i in range(2)]
    refer = [{"id": f"g{i}", "video": info["sample_idx"],
              "conversations": [
                  {"from": "human", "value": f"<image>\nIdentify the {w}"},
                  {"from": "gpt", "value": "<ground>"}],
              "metadata": {"dataset": ds, "object_id": obj}}
             for i, (w, ds, obj) in enumerate((
                 ("chair", "scanrefer", 1),
                 ("chairs by the wall", "multi3drefer", [0, 2, 4])))]
    return qa + refer


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("data"))
    info = make_fake_scene(root, n_frames=2)
    records = _records(info)
    paths = {}
    for name, recs in (("mixed", records), ("qa", records[:2]),
                       ("ground", records[2:])):
        paths[name] = os.path.join(root, f"{name}.json")
        with open(paths[name], "w") as f:
            json.dump(recs, f)
    dc = DataConfig(video_folder=root,
                    annotation_dir=os.path.join(root, "embodiedscan"),
                    metadata_dir=os.path.join(root, "metadata"),
                    frames_upbound=2)
    return root, paths, dc, jlv.init_model(jax.random.PRNGKey(0), CFG)


def _col_cfg(module):
    return module.CollatorConfig(max_len=160, frames_upbound=2,
                                 max_objects=MAX_OBJECTS,
                                 ground_token_id=GROUND)


def _data(setup, name):
    """(JAX dataset, its collator, port dataset, its collator), each with a
    fresh FakeTokenizer (the two number words alike when used alike)."""
    _, paths, dc, _ = setup
    jset = jds.SupervisedDataset(paths[name], FakeTokenizer(), dc,
                                 image_processor=SigLipImageProcessor(
                                     size=(56, 56)))
    tset = tds.SupervisedDataset(paths[name], FakeTokenizer(),
                                 port_config(dc),
                                 image_processor=TSigLipImageProcessor(
                                     size=(56, 56)))
    return (jset, jds.Collator(CFG, _col_cfg(jds)), tset,
            tds.Collator(TCFG, _col_cfg(tds)))


def _trainers(setup, name, out, bf16=False, accumulate=1, **tc):
    """A JAX and a port Trainer from the same weights and settings."""
    jset, jcol, tset, tcol = _data(setup, name)
    # the loops load samples on threads: number every word first, in order
    for i in range(len(jset)):
        jset[i], tset[i]
    params = setup[3]
    common = dict(output_dir=out, save_steps=1000, group_by="none",
                  gradient_accumulation_steps=accumulate, bf16=bf16, **tc)
    jtr = jtrainer.Trainer(
        CFG, jax.tree.map(jnp.array, params), jset, jcol,
        joptim.OptimConfig(**OPT), jtrainer.TrainingConfig(**common),
        mesh=create_mesh(dp=1, fsdp=1, tp=1, devices=jax.devices()[:1]))
    ttr = ttrainer.Trainer(
        TCFG, from_jax_params(jax.tree.map(np.asarray, params), TCFG,
                              device="cpu"),
        tset, tcol, toptim.OptimConfig(**OPT),
        ttrainer.TrainingConfig(**common), device="cpu")
    return jtr, ttr


# ---------------------------------------------------------------------------
# losses
# ---------------------------------------------------------------------------

def _scores(rng, n_valid, n_pad):
    s = rng.normal(size=n_valid + n_pad + 1).astype(np.float32) * 0.3
    s[n_valid:n_valid + n_pad] = -np.inf
    return s


@pytest.mark.parametrize("labels", [[1], [0, 2, 3], []])
def test_infonce_loss_matches_jax(labels):
    """-inf pads, one or several positives, and the zero target (no
    positive: the last slot set)."""
    rng = np.random.default_rng(len(labels))
    s = _scores(rng, 5, 2)
    t = np.zeros_like(s)
    t[labels if labels else [len(s) - 1]] = 1.0
    want = float(jlv.infonce_loss(jnp.asarray(s), jnp.asarray(t), 0.07))
    got = tlv.infonce_loss(torch.from_numpy(s), torch.from_numpy(t), 0.07)
    np.testing.assert_allclose(float(got), want, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("labels", [[1], [0, 2, 3], []])
def test_bce_ground_loss_matches_jax(labels):
    rng = np.random.default_rng(10 + len(labels))
    s = _scores(rng, 5, 2)[:-1]            # the MLP / SCORE heads' (N,)
    t = np.zeros(len(s) + 1, np.float32)
    t[labels if labels else [len(s)]] = 1.0
    want = float(jlv.bce_ground_loss(jnp.asarray(s), jnp.asarray(t)))
    got = tlv.bce_ground_loss(torch.from_numpy(s), torch.from_numpy(t))
    np.testing.assert_allclose(float(got), want, rtol=1e-6, atol=1e-6)


def test_padded_object_gradient_is_finite_and_matches_jax(setup):
    """The gradient of the InfoNCE loss through ``ground_scores`` into the
    (N, D) object features: zero at padded objects (scored -inf), finite
    everywhere, and JAX's within 1e-5 of its largest entry."""
    params = setup[3]
    gh = params["ground_head"]
    D = CFG.llm.hidden_size
    rng = np.random.default_rng(3)
    feats = rng.normal(size=(MAX_OBJECTS, D)).astype(np.float32)
    query = rng.normal(size=(D,)).astype(np.float32)
    valid = np.arange(MAX_OBJECTS) < 4
    target = np.zeros(MAX_OBJECTS + 1, np.float32)
    target[2] = 1.0

    def jloss(f):
        sc = jlv.ground_scores({"ground_head": gh}, jnp.asarray(query), f,
                               jnp.asarray(valid), CFG)
        return jlv.infonce_loss(sc, jnp.asarray(target), 0.07)

    want = np.asarray(jax.grad(jloss)(jnp.asarray(feats)))
    tgh = from_jax_params(jax.tree.map(np.asarray, params), TCFG,
                          device="cpu")["ground_head"]
    f = torch.from_numpy(feats).requires_grad_(True)
    sc = tlv.ground_scores({"ground_head": tgh}, torch.from_numpy(query), f,
                           torch.from_numpy(valid), TCFG)
    tlv.infonce_loss(sc, torch.from_numpy(target), 0.07).backward()
    got = f.grad.numpy()
    assert np.isfinite(got).all()
    assert not got[~valid].any()
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-5 * np.abs(want).max())


# ---------------------------------------------------------------------------
# the collator
# ---------------------------------------------------------------------------

def test_collate_grounding_matches_jax(setup):
    """A Multi3DRefer row (labels 0, 2, 4) and a row whose label (9) is past
    its objects (the zero target): every array bit for bit JAX's."""
    jset, jcol, tset, tcol = _data(setup, "ground")
    jrows = [jset[1], dict(jset[0], box_label=[9])]
    trows = [tset[1], dict(tset[0], box_label=[9])]
    jout, tout = jcol(jrows), tcol(trows)
    assert set(tout) == set(jout) and set(KEYS) <= set(tout)
    for key, want in jout.items():
        np.testing.assert_array_equal(np.asarray(tout[key]),
                                      np.asarray(want), err_msg=key)
        assert np.asarray(tout[key]).dtype == np.asarray(want).dtype, key
    hot = tout["box_label_hot"]
    assert hot[0].tolist() == [1, 0, 1, 0, 1, 0, 0]
    assert hot[1].tolist() == [0] * MAX_OBJECTS + [1]
    assert tout["objects_valid"].sum(1).tolist() == [5, 5]
    assert (tout["ground_slot"] > 0).all()


# ---------------------------------------------------------------------------
# the ground mini-step
# ---------------------------------------------------------------------------

def _ground_steps(setup, tmp_path, bf16, steps=1):
    """``steps`` ground mini-steps of the Multi3DRefer query in both
    frameworks: [(JAX metrics, port metrics)] per step, the port's ground
    head before them (cloned) and its state after."""
    jtr, ttr = _trainers(setup, "ground", str(tmp_path), bf16=bf16)
    arrays = jtr.collator([jtr.dataset[1]])
    before = [t.clone()
              for t in tree_leaves(ttr.state.params["ground_head"])]
    jstate, tstate, out = jtr.state, ttr.state, []
    for _ in range(steps):
        with jtr.mesh:
            jstate, jm = jtr._ground_step_fn(
                jstate, jtr._to_batch(arrays),
                *[jnp.asarray(arrays[k]) for k in KEYS])
        tstate, tm = ttr._ground_step_fn(
            tstate, ttrainer.to_batch(arrays, "cpu"),
            ttrainer.ground_extras(arrays, "cpu"))
        out.append((jm, tm))
    return out, before, tstate


def test_f32_ground_steps_match_jax(setup, tmp_path):
    """Two steps (the schedule's learning rate is 0 at the first update):
    each step's metrics JAX's, the ground head moved by the second."""
    out, before, state = _ground_steps(setup, tmp_path, bf16=False, steps=2)
    for step, (jm, tm) in enumerate(out):
        assert set(tm) == set(jm) == {"ground_loss", "grad_norm"}
        for key in jm:
            np.testing.assert_allclose(float(tm[key]), float(jm[key]),
                                       rtol=1e-4, err_msg=f"{step} {key}")
        assert np.isfinite(float(tm["grad_norm"])) and \
            float(tm["grad_norm"]) > 0
    assert all(torch.isfinite(t).all() for t in tree_leaves(state.params))
    head = tree_leaves(state.params["ground_head"])
    assert len(head) == len(before) == 13
    assert all(not torch.equal(a, b) for a, b in zip(head, before))


def test_bf16_compute_ground_step_matches_jax(setup, tmp_path):
    [(jm, tm)], _, state = _ground_steps(setup, tmp_path, bf16=True)
    np.testing.assert_allclose(float(tm["ground_loss"]),
                               float(jm["ground_loss"]), rtol=BF16_REL)
    np.testing.assert_allclose(float(tm["grad_norm"]),
                               float(jm["grad_norm"]), rtol=BF16_REL)
    assert state.params["ground_head"]["obj"]["w1"].dtype == torch.float32


def test_ground_step_uses_row_zero_only(setup, tmp_path):
    """As JAX's: rows 1.. of a ground batch are computed and dropped, so
    another query in row 1 changes neither the loss nor the gradients."""
    _, ttr = _trainers(setup, "ground", str(tmp_path))
    ds, col = ttr.dataset, ttr.collator
    losses = []
    for other in (0, 1):
        arrays = col([ds[1], ds[other]])
        loss, _ = ttrainer.grounding_loss_fn(
            ttr.state.params, TCFG, ttrainer.to_batch(arrays, "cpu"),
            ttrainer.ground_extras(arrays, "cpu"), remat=False)
        losses.append(float(loss))
    assert losses[0] == losses[1]


@pytest.mark.parametrize("head", [GroundHeadType.MLP, GroundHeadType.SCORE])
def test_mlp_and_score_heads_have_no_ground_step(setup, head):
    """Their (N,) scores do not broadcast against the (N+1,) target: JAX's
    loss raises while tracing, the port's step names the head."""
    with pytest.raises(ValueError):
        jlv.infonce_loss(jnp.zeros(MAX_OBJECTS),
                         jnp.zeros(MAX_OBJECTS + 1), 0.07)
    tcfg = dataclasses.replace(TCFG, ground_head=THead[head.name])
    with pytest.raises(ValueError, match=head.name):
        ttrainer.grounding_loss_fn({}, tcfg, None, None)


# ---------------------------------------------------------------------------
# the loop and evaluate()
# ---------------------------------------------------------------------------

def test_mixed_train_follows_jax(setup, tmp_path):
    """ScanQA and ScanRefer records in one epoch (seeded order, batches of
    one, two mini-steps per update): each step's metric keys are JAX's
    (lm_loss or ground_loss, and grad_norm) and its values within 1e-4."""
    logs = {}
    for side in ("jax", "port"):
        out = str(tmp_path / side)
        jtr, ttr = _trainers(setup, "mixed", out, accumulate=2,
                             metrics_file=os.path.join(out, "m.jsonl"))
        tr = jtr if side == "jax" else ttr
        tr.train(resume=False)
        with open(os.path.join(out, "m.jsonl")) as f:
            logs[side] = [json.loads(line) for line in f]
    assert len(logs["port"]) == len(logs["jax"]) == 4
    kinds = set()
    for t, j in zip(logs["port"], logs["jax"]):
        keys = set(j) - {"step", "epoch", "step_time_s"}
        assert set(t) - {"step", "epoch", "step_time_s"} == keys
        kinds.add(tuple(sorted(keys)))
        for k in keys:
            np.testing.assert_allclose(t[k], j[k], rtol=1e-4,
                                       err_msg=f"step {j['step']} {k}")
    assert kinds == {("grad_norm", "lm_loss"), ("grad_norm", "ground_loss")}


def test_evaluate_matches_jax(setup, tmp_path):
    jtr, ttr = _trainers(setup, "qa", str(tmp_path))
    want = jtr.evaluate()
    got = ttr.evaluate()
    assert got["eval_batches"] == want["eval_batches"] == 2
    np.testing.assert_allclose(got["eval_loss"], want["eval_loss"],
                               rtol=1e-5)
    assert ttr.evaluate(max_batches=1)["eval_batches"] == 1
