"""The port's ``Trainer`` on the CPU at ``ModelConfig.tiny()``: steps with
checkpoints, the metrics jsonl and the final bf16 export; bitwise resume (2
steps, SIGTERM, resume, 2 more == 4 straight steps, MultiSteps state and
pos-skipping offsets included); SIGTERM -> checkpoint -> return (as
``tests/test_train.py::TestPreemption``); the paths not ported raise, and
``lora_r`` builds a LoRA trainer."""

import json
import os
import signal
import threading

import numpy as np
import pytest
import torch

from video3d_tpu_torch.config import DataConfig, ModelConfig
from video3d_tpu_torch.data.dataset import (Collator, CollatorConfig,
                                            SupervisedDataset)
from video3d_tpu_torch.data.image_processor import SigLipImageProcessor
from video3d_tpu_torch.params import init_model
from video3d_tpu_torch.train import checkpoint as ckpt
from video3d_tpu_torch.train.optim import OptimConfig, tree_leaves
from video3d_tpu_torch.train.trainer import (Trainer, TrainingConfig,
                                             ground_extras)

from fixtures import FakeTokenizer, make_fake_annotations, make_fake_scene

torch.set_num_threads(1)

CFG = ModelConfig.tiny()


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("data"))
    info = make_fake_scene(root, n_frames=2)
    ann = make_fake_annotations(root, info["sample_idx"], n=2)
    dc = DataConfig(video_folder=root,
                    annotation_dir=os.path.join(root, "embodiedscan"),
                    metadata_dir=os.path.join(root, "metadata"),
                    frames_upbound=2)
    ds = SupervisedDataset(ann, FakeTokenizer(), dc,
                           image_processor=SigLipImageProcessor(size=(56, 56)))
    return ds, Collator(CFG, CollatorConfig(max_len=160, frames_upbound=2))


def _trainer(data, out, **tkw):
    ds, col = data
    kw = dict(output_dir=out, num_epochs=2, group_by="none", seed=7,
              save_steps=1000, pos_skipping_range=4)
    kw.update(tkw)
    return Trainer(CFG, init_model(CFG, "cpu",
                                   torch.Generator().manual_seed(0),
                                   torch.float32),
                   ds, col, OptimConfig(total_steps=4, learning_rate=1e-3),
                   TrainingConfig(**kw), device="cpu")


def _record(trainer, log, interrupt_at=None):
    """Log each step's batch; fire SIGTERM as step ``interrupt_at`` runs."""
    orig = trainer._step_fn

    def stepper(state, batch):
        log.append((batch.text_ids.clone(), batch.position_ids.clone()))
        if interrupt_at is not None and len(log) == interrupt_at:
            os.kill(os.getpid(), signal.SIGTERM)
        return orig(state, batch)

    trainer._step_fn = stepper


def test_steps_checkpoints_metrics_and_export(data, tmp_path):
    out = str(tmp_path / "out")
    metrics = str(tmp_path / "m" / "metrics.jsonl")
    tr = _trainer(data, out, num_epochs=1, save_steps=1, metrics_file=metrics)
    state = tr.train(resume=False)
    assert state.step == 2
    assert ckpt.latest_checkpoint(out).endswith("checkpoint-2")
    with open(metrics) as f:
        rows = [json.loads(line) for line in f]
    assert [r["step"] for r in rows] == [1, 2]
    assert all(np.isfinite(r["lm_loss"]) and r["grad_norm"] > 0
               for r in rows)
    export = torch.load(os.path.join(out, "model", ckpt.PARAMS_FILE),
                        weights_only=True)
    assert all(t.dtype == torch.bfloat16 for t in tree_leaves(export))
    assert all(t.dtype == torch.float32 for t in tree_leaves(state.params))


def test_resumed_run_matches_uninterrupted_bitwise(data, tmp_path):
    log_a = []
    tr_a = _trainer(data, str(tmp_path / "a"))
    _record(tr_a, log_a)
    state_a = tr_a.train(resume=False)
    assert state_a.step == 4 and len(log_a) == 4

    out_b = str(tmp_path / "b")
    log_b = []
    tr_b = _trainer(data, out_b)
    _record(tr_b, log_b, interrupt_at=2)
    assert tr_b.train(resume=False).step == 2
    assert ckpt.latest_checkpoint(out_b).endswith("checkpoint-2")
    tr_b2 = _trainer(data, out_b)
    _record(tr_b2, log_b)
    state_b = tr_b2.train(resume=True)
    assert state_b.step == 4 and len(log_b) == 4
    for (ia, pa), (ib, pb) in zip(log_a, log_b):
        assert torch.equal(ia, ib) and torch.equal(pa, pb)

    def tensors(state):
        return tree_leaves(state.params) + [
            t for t in tree_leaves([state.opt_state.acc_grads])] + [
            t for g in state.opt_state.inner_opt_state.values()
            for t in g.mu + g.nu]

    assert state_a.opt_state.gradient_step == state_b.opt_state.gradient_step
    for a, b in zip(tensors(state_a), tensors(state_b)):
        assert torch.equal(a, b)


def test_sigterm_checkpoints_and_exits(data, tmp_path):
    """SIGTERM mid-training: the trainer saves a checkpoint at the next
    step boundary and returns instead of dying uncheckpointed."""
    out = str(tmp_path / "out")
    tr = _trainer(data, out, num_epochs=1000)
    timer = threading.Timer(1.0, lambda: os.kill(os.getpid(),
                                                 signal.SIGTERM))
    timer.start()
    try:
        state = tr.train(resume=False)
    finally:
        timer.cancel()
    assert ckpt.latest_checkpoint(out) is not None
    assert state.step < 2000
    assert not os.path.isdir(os.path.join(out, "model"))


def test_unported_paths_raise(data):
    # LoRA is ported (tests/test_torch_qlora.py trains it): lora_r builds
    # a trainable tree of adapters over a frozen bf16 base
    tr = _trainer(data, "unused", lora_r=8)
    assert set(tr.state.params["llm"]["layers"][0]["attn"]["wq"]) == \
        {"A", "B"}
    assert tr.base_params["llm"]["embed_tokens"].dtype == torch.bfloat16
    with pytest.raises(NotImplementedError, match="A12"):
        _trainer(data, "unused", dp=2)
    # a batch with a ground slot carries its extras to the ground step
    # (tests/test_torch_ground_train.py trains on them)
    tr = _trainer(data, "unused")
    arrays = tr.collator([tr.dataset[0]])
    assert ground_extras(arrays, "cpu") is None
    extras = ground_extras(dict(
        arrays, ground_slot=np.full(1, 7, np.int32),
        world_coords_full=np.zeros((1, 2, 56, 56, 3), np.float32),
        objects=np.zeros((1, 3, 6), np.float32),
        objects_valid=np.ones((1, 3), bool),
        box_label_hot=np.eye(1, 4, 3, dtype=np.float32)), "cpu")
    assert extras.ground_slot.dtype == torch.long
    assert int(extras.ground_slot[0]) == 7
    assert extras.box_label_hot.shape == (1, 4)
