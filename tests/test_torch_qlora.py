"""The port's QLoRA module (``train/qlora.py``) and ``Trainer``'s LoRA mode
against the JAX package's on the CPU, at ``ModelConfig.tiny()`` (INFONCE
ground head) with the weights of one JAX ``init_model`` tree and JAX's
trainable trees carried across (``from_jax_tree``), never drawn again.
Everything runs in f32 (``bf16=False``: the base stays f32 or is quantized
from f32, the masters f32); tolerances are relative:

* ``qlora_loss_fn``'s loss within 1e-5 and its gradients of every
  trainable leaf within 1e-4 of the largest over int8 and int4 bases
  (f32 sums in other orders);
* three ``Trainer.train()`` LoRA steps at ``lora_bits`` 16 / 8 / 4 from
  JAX's initial trainable tree: each step's ``lm_loss`` and ``grad_norm``
  within 1e-4 of JAX's, the frozen base bit for bit unchanged, the
  trainables but the ground head moved by the last update (the
  schedule's learning rate is 0 at the first), ``lora.json`` equal to JAX's, and the export read back by
  ``load_lora_export`` equal to the final trainable tree (None positions
  kept);
* a QLoRA resume from a checkpoint (trees holding None) bit for bit an
  uninterrupted run;
* the LoRA ground mini-step (int8 base) within 1e-4 of JAX's, twice;
* ``evaluate()`` against JAX's ``eval_loss_lora`` within 1e-5;
* a prequantized base passes through the trainer unchanged;
* the engine's answers over lazily adapted int8 weights (an export served
  by ``maybe_merge_lora``) identical to the JAX engine's over JAX's
  ``apply_lora``'d tree, and a bits-16 export merged as JAX merges it.
"""

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
from video3d_tpu.data.video_processor import VideoProcessor
from video3d_tpu.eval import drivers as jdrv
from video3d_tpu.models import llava_video3d as jlv
from video3d_tpu.models import quant as jquant
from video3d_tpu.parallel.mesh import create_mesh
from video3d_tpu.train import lora as jlora
from video3d_tpu.train import optim as joptim
from video3d_tpu.train import qlora as jqlora
from video3d_tpu.train import trainer as jtrainer
from video3d_tpu_torch.data import dataset as tds
from video3d_tpu_torch.data.image_processor import \
    SigLipImageProcessor as TSigLipImageProcessor
from video3d_tpu_torch.data.video_processor import \
    VideoProcessor as TVideoProcessor
from video3d_tpu_torch.eval import drivers as tdrv
from video3d_tpu_torch.models import quant as tquant
from video3d_tpu_torch.params import from_jax_params, from_jax_tree
from video3d_tpu_torch.train import checkpoint as tckpt
from video3d_tpu_torch.train import lora as tlora
from video3d_tpu_torch.train import optim as toptim
from video3d_tpu_torch.train import qlora as tqlora
from video3d_tpu_torch.train import trainer as ttrainer
from video3d_tpu_torch.train.optim import tree_leaves, tree_leaves_with_path
from video3d_tpu_torch.train.train_step import create_train_state

from fixtures import FakeTokenizer, make_fake_scene
from port_configs import port_config

torch.set_num_threads(1)

CFG = ModelConfig.tiny()
TCFG = port_config(CFG)
GROUND = 301         # FakeTokenizer's <ground>
MAX_OBJECTS = 6
OPT = dict(total_steps=4, learning_rate=1e-3, warmup_ratio=0.0)
LORA = dict(lora_r=4, lora_alpha=8)
KEYS = ("world_coords_full", "objects", "objects_valid", "ground_slot",
        "box_label_hot")


def _records(info):
    qa = [{"id": f"q{i}", "video": info["sample_idx"],
           "conversations": [
               {"from": "human", "value": f"<image>\nWhat is object {i} ?"},
               {"from": "gpt", "value": f"a brown chair {i}"}],
           "metadata": {"dataset": "scanqa"}} for i in range(3)]
    refer = [{"id": "g0", "video": info["sample_idx"],
              "conversations": [
                  {"from": "human", "value": "<image>\nIdentify the chair"},
                  {"from": "gpt", "value": "<ground>"}],
              "metadata": {"dataset": "scanrefer", "object_id": 1}}]
    return qa + refer


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("data"))
    info = make_fake_scene(root, n_frames=2)
    records = _records(info)
    paths = {}
    for name, recs in (("qa", records[:3]), ("ground", records[3:])):
        paths[name] = os.path.join(root, f"{name}.json")
        with open(paths[name], "w") as f:
            json.dump(recs, f)
    dc = DataConfig(video_folder=root,
                    annotation_dir=os.path.join(root, "embodiedscan"),
                    metadata_dir=os.path.join(root, "metadata"),
                    frames_upbound=2)
    return info, paths, dc, jlv.init_model(jax.random.PRNGKey(0), CFG)


def _col_cfg(module):
    return module.CollatorConfig(max_len=160, frames_upbound=2,
                                 max_objects=MAX_OBJECTS,
                                 ground_token_id=GROUND)


def _data(setup, name):
    _, paths, dc, _ = setup
    jset = jds.SupervisedDataset(paths[name], FakeTokenizer(), dc,
                                 image_processor=SigLipImageProcessor(
                                     size=(56, 56)))
    tset = tds.SupervisedDataset(paths[name], FakeTokenizer(),
                                 port_config(dc),
                                 image_processor=TSigLipImageProcessor(
                                     size=(56, 56)))
    # the loops load samples on threads: number every word first, in order
    for i in range(len(jset)):
        jset[i], tset[i]
    return (jset, jds.Collator(CFG, _col_cfg(jds)), tset,
            tds.Collator(TCFG, _col_cfg(tds)))


def _trainers(setup, name, out, params=None, **tc):
    """A JAX and a port LoRA Trainer on the same weights and settings, the
    port's trainable tree replaced by (a copy of) JAX's initial one."""
    jset, jcol, tset, tcol = _data(setup, name)
    params = setup[3] if params is None else params
    common = dict(output_dir=out, save_steps=1000, group_by="none",
                  gradient_accumulation_steps=1, bf16=False, **LORA, **tc)
    jtr = jtrainer.Trainer(
        CFG, jax.tree.map(jnp.array, params), jset, jcol,
        joptim.OptimConfig(**OPT), jtrainer.TrainingConfig(
            **{**common, "output_dir": os.path.join(out, "jax")}),
        mesh=create_mesh(dp=1, fsdp=1, tp=1, devices=jax.devices()[:1]))
    ttr = ttrainer.Trainer(
        TCFG, from_jax_params(jax.tree.map(np.asarray, params), TCFG,
                              device="cpu"),
        tset, tcol, toptim.OptimConfig(**OPT), ttrainer.TrainingConfig(
            **{**common, "output_dir": os.path.join(out, "port")}),
        device="cpu")
    # JAX donates its state to the step: copy its trainables first
    ttr.state = create_train_state(
        from_jax_tree(jax.tree.map(np.array, jtr.state.params),
                      device="cpu"), ttr.tx)
    return jtr, ttr


def _jax_trainable(base, seed=1):
    """JAX's trainable tree over ``base`` with every B drawn nonzero."""
    tr = jlora.init_lora_trainable(jax.random.PRNGKey(seed), base,
                                   jlora.LoraConfig(**_lcfg()))
    rng = np.random.default_rng(seed + 100)

    def fill(path, x):
        if jax.tree_util.keystr(path).endswith("['B']"):
            return jnp.asarray(0.05 * rng.normal(size=x.shape), x.dtype)
        return x

    return jax.tree_util.tree_map_with_path(fill, tr)


def _lcfg():
    return dict(r=LORA["lora_r"], alpha=LORA["lora_alpha"])


def _host(tree):
    return jax.tree.map(np.asarray, tree)


# ---------------------------------------------------------------------------
# the QLoRA loss
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("bits", [8, 4])
def test_qlora_loss_and_adapter_grads_match_jax(setup, bits):
    jset, jcol, _, _ = _data(setup, "qa")
    arrays = jcol([jset[0]])
    base = jquant.quantize_tree(setup[3], bits=bits)
    jqlora.check_qlora_base(base)
    jtr = _jax_trainable(base)
    jbatch = jlv.Batch(**{k: (jnp.asarray(v) if v is not None else None)
                          for k, v in arrays.items()
                          if k in jlv.Batch._fields})
    (jloss, _), jgrads = jax.value_and_grad(
        jqlora.qlora_loss_fn, has_aux=True)(
        jtr, base, CFG, jbatch, jlora.LoraConfig(**_lcfg()), remat=False,
        compute_dtype=None)

    tbase = from_jax_params(_host(base), TCFG, device="cpu")
    tqlora.check_qlora_base(tbase)
    ttr = from_jax_tree(_host(jtr), device="cpu")
    leaves = tree_leaves(ttr)
    for t in leaves:
        t.requires_grad_(True)
    loss, metrics = tqlora.qlora_loss_fn(
        ttr, tbase, TCFG, ttrainer.to_batch(arrays, "cpu"),
        tlora.LoraConfig(**_lcfg()), remat=False, compute_dtype=None)
    # the ground head does not reach the LM loss: zeros, as in JAX
    grads = [torch.zeros_like(t) if g is None else g for t, g in zip(
        leaves, torch.autograd.grad(loss, leaves, allow_unused=True))]
    np.testing.assert_allclose(float(loss.detach()), float(jloss),
                               rtol=1e-5)
    assert set(metrics) == {"lm_loss"}
    want = jax.tree_util.tree_leaves(jgrads)
    assert len(want) == len(grads)
    top = max(float(np.abs(np.asarray(w)).max()) for w in want)
    for (path, _), g, w in zip(tree_leaves_with_path(ttr), grads, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0,
                                   atol=1e-4 * top, err_msg=path)
    # the adapters on the quantized projections have gradients
    gd = dict(zip([p for p, _ in tree_leaves_with_path(ttr)], grads))
    assert float(gd["llm/layers/0/attn/wq/A"].abs().max()) > 0


def test_check_qlora_base_refuses_other_weight_forms():
    class W8A8Weight:
        pass

    with pytest.raises(TypeError, match="W8A8Weight"):
        tqlora.check_qlora_base({"llm": {"w": W8A8Weight()}})
    tqlora.check_qlora_base({"llm": {"w": torch.zeros(2, 2),
                                     "q": {"q": torch.zeros(2, 2),
                                           "scale": torch.zeros(1, 2)}}})


# ---------------------------------------------------------------------------
# the trainer's LoRA mode
# ---------------------------------------------------------------------------

def _metrics(path):
    with open(path) as f:
        return [json.loads(line) for line in f]


@pytest.mark.parametrize("bits", [16, 8, 4])
def test_trainer_lora_steps_match_jax(setup, tmp_path, bits):
    """Three LM steps: metrics JAX's, the base frozen, the export and its
    ``lora.json`` as JAX's, read back equal to the final trainables."""
    out = str(tmp_path)
    jtr, ttr = _trainers(setup, "qa", out, lora_bits=bits,
                         metrics_file=None)
    for tr, side in ((jtr, "jax"), (ttr, "port")):
        tr.tcfg.metrics_file = os.path.join(out, f"{side}.jsonl")
    base_before = [t.clone() for t in tree_leaves(ttr.base_params)
                   if isinstance(t, torch.Tensor)]
    initial = [t.clone() for t in tree_leaves(ttr.state.params)]
    wq = ttr.base_params["llm"]["layers"][0]["attn"]["wq"]
    if bits == 8:
        assert wq["q"].dtype == torch.int8
    elif bits == 4:
        assert isinstance(wq, tquant.Int4Weight)
    jtr.train(resume=False)
    state = ttr.train(resume=False)
    want, got = (_metrics(os.path.join(out, f"{s}.jsonl"))
                 for s in ("jax", "port"))
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        for key in ("lm_loss", "grad_norm"):
            np.testing.assert_allclose(g[key], w[key], rtol=1e-4,
                                       err_msg=f"step {w['step']} {key}")
    base_after = [t for t in tree_leaves(ttr.base_params)
                  if isinstance(t, torch.Tensor)]
    assert all(torch.equal(a, b) for a, b in zip(base_after, base_before))
    final = tree_leaves(state.params)
    moved = [not torch.equal(a, b) for a, b in zip(final, initial)]
    # LM steps leave the ground head without a gradient
    assert moved == [not p.startswith("ground_head")
                     for p, _ in tree_leaves_with_path(state.params)]

    with open(os.path.join(out, "jax", tlora.LORA_FILE)) as f:
        jmeta = json.load(f)
    with open(os.path.join(out, "port", tlora.LORA_FILE)) as f:
        assert json.load(f) == jmeta == {"r": 4, "alpha": 8, "bits": bits}
    lora, lcfg, got_bits = tlora.load_lora_export(
        os.path.join(out, "port", "model"), ttr.base_params)
    assert (lcfg.r, lcfg.alpha, got_bits) == (4, 8, bits)
    assert [p for p, _ in tree_leaves_with_path(lora)] == \
        [p for p, _ in tree_leaves_with_path(state.params)]
    assert lora["vision"]["patch_embed"]["w"] is None
    assert all(torch.equal(a, b) for a, b in zip(
        tree_leaves(lora), tree_leaves(state.params)))
    export = torch.load(os.path.join(out, "port", "model",
                                     tckpt.PARAMS_FILE), weights_only=True)
    assert all(t.dtype == torch.float32 for t in tree_leaves(export))


def test_export_round_trip_keeps_bf16_and_rejects_other_bases(setup,
                                                             tmp_path):
    """bf16 compute over f32 masters: the export is bf16; it loads back
    against its base, and against a base of another width it raises."""
    jset, jcol, tset, tcol = _data(setup, "qa")
    params = from_jax_params(jax.tree.map(np.asarray, setup[3]), TCFG,
                             device="cpu")
    tr = ttrainer.Trainer(
        TCFG, params, tset, tcol, toptim.OptimConfig(**OPT),
        ttrainer.TrainingConfig(output_dir=str(tmp_path), save_steps=1000,
                                group_by="none", num_epochs=1,
                                gradient_accumulation_steps=1, bf16=True,
                                lora_bits=8, **LORA), device="cpu")
    assert tr.base_params["llm"]["embed_tokens"].dtype == torch.bfloat16
    state = tr.train(resume=False)
    assert state.step == 3
    lora, _, bits = tlora.load_lora_export(str(tmp_path / "model"),
                                           tr.base_params)
    assert bits == 8
    for a, b in zip(tree_leaves(lora), tree_leaves(state.params)):
        assert a.dtype == torch.bfloat16 and b.dtype == torch.float32
        assert torch.equal(a, b.to(torch.bfloat16))
    with open(tmp_path / tlora.LORA_FILE, "w") as f:
        json.dump({"r": 8, "alpha": 16, "bits": 8}, f)
    with pytest.raises(ValueError, match="does not fit"):
        tlora.load_lora_export(str(tmp_path / "model"), tr.base_params)


def test_lora_resume_matches_uninterrupted_bitwise(setup, tmp_path):
    """QLoRA (int8) with checkpoints of trees that hold None: three steps
    straight against two, a resume from checkpoint-2 and the third."""
    _, _, tset, tcol = _data(setup, "qa")
    params = from_jax_params(jax.tree.map(np.asarray, setup[3]), TCFG,
                             device="cpu")

    def run(out, resume=False):
        tr = ttrainer.Trainer(
            TCFG, params, tset, tcol, toptim.OptimConfig(**OPT),
            ttrainer.TrainingConfig(output_dir=out, save_steps=1,
                                    group_by="none", num_epochs=1,
                                    gradient_accumulation_steps=2,
                                    lora_bits=8, **LORA), device="cpu")
        return tr.train(resume=resume)

    want = run(str(tmp_path / "a"))
    out = str(tmp_path / "b")
    run(out)
    os.remove(os.path.join(out, "checkpoint-3", tckpt.STATE_FILE))
    os.rmdir(os.path.join(out, "checkpoint-3"))
    got = run(out, resume=True)
    assert got.step == want.step == 3
    assert got.params["vision"]["patch_embed"]["w"] is None
    assert got.opt_state.mini_step == want.opt_state.mini_step == 1
    for a, b in zip(tree_leaves(got.params), tree_leaves(want.params)):
        assert torch.equal(a, b)
    for a, b in zip(got.opt_state.acc_grads, want.opt_state.acc_grads):
        assert torch.equal(a, b)


def test_lora_ground_steps_match_jax(setup, tmp_path):
    jtr, ttr = _trainers(setup, "ground", str(tmp_path), lora_bits=8)
    arrays = jtr.collator([jtr.dataset[0]])
    jstate, tstate = jtr.state, ttr.state
    before = [t.clone() for t in tree_leaves(tstate.params["ground_head"])]
    for step in range(2):
        with jtr.mesh:
            jstate, jm = jtr._ground_step_fn(
                jstate, jtr._to_batch(arrays),
                *[jnp.asarray(arrays[k]) for k in KEYS])
        tstate, tm = ttr._ground_step_fn(
            tstate, ttrainer.to_batch(arrays, "cpu"),
            ttrainer.ground_extras(arrays, "cpu"))
        assert set(tm) == set(jm) == {"ground_loss", "grad_norm"}
        for key in jm:
            np.testing.assert_allclose(float(tm[key]), float(jm[key]),
                                       rtol=1e-4, err_msg=f"{step} {key}")
    head = tree_leaves(tstate.params["ground_head"])
    assert all(not torch.equal(a, b) for a, b in zip(head, before))


def test_lora_evaluate_matches_jax(setup, tmp_path):
    jtr, ttr = _trainers(setup, "qa", str(tmp_path), lora_bits=4)
    want, got = jtr.evaluate(), ttr.evaluate()
    assert got["eval_batches"] == want["eval_batches"] == 3
    np.testing.assert_allclose(got["eval_loss"], want["eval_loss"],
                               rtol=1e-5)


def test_prequantized_base_passes_through_unchanged(setup):
    """A base that arrives int8 already is neither quantized again nor
    cast: ``q`` and the bf16 scales are ``quantize_tree``'s of the bf16
    tree, as in JAX's trainer."""
    bf16 = from_jax_params(jax.tree.map(np.asarray, setup[3]), TCFG,
                           device="cpu", dtype=torch.bfloat16)
    pre = tquant.quantize_tree(bf16, bits=8)
    tr = ttrainer.Trainer(
        TCFG, pre, None, None, toptim.OptimConfig(total_steps=1),
        ttrainer.TrainingConfig(output_dir="unused", lora_bits=8, **LORA),
        device="cpu")
    wq = tr.base_params["llm"]["layers"][0]["attn"]["wq"]
    ref = pre["llm"]["layers"][0]["attn"]["wq"]
    assert wq["q"].dtype == torch.int8 and wq["scale"].dtype == torch.bfloat16
    assert torch.equal(wq["q"], ref["q"])
    assert torch.equal(wq["scale"], ref["scale"])
    jpre = jquant.quantize_tree(jax.tree.map(
        lambda x: x.astype(jnp.bfloat16), setup[3]), bits=8)
    np.testing.assert_array_equal(
        wq["q"].numpy(), np.asarray(jpre["llm"]["layers"][0]["attn"]["wq"]
                                    ["q"]))


# ---------------------------------------------------------------------------
# serving an export
# ---------------------------------------------------------------------------

QUESTIONS = ["what color is the chair", "where is the lamp"]


def _question(info, text, i):
    return {"id": f"q{i}_0", "video": info["sample_idx"],
            "conversations": [
                {"from": "human", "value": f"<image>\n{text}"},
                {"from": "gpt", "value": "brown"}],
            "metadata": {"dataset": "scanqa", "question_type": "what"}}


def _ecfg(module, tok):
    return module.EngineConfig(max_new_tokens=4,
                               eos_token_id=tok.eos_token_id, max_frames=2,
                               buckets=(256,), stop_str="",
                               suffix_buckets=(32, 64))


def _export(tmp_path, tree, bits):
    run = str(tmp_path / f"run{bits}")
    tckpt.save_params_only(run, from_jax_tree(_host(tree), device="cpu"))
    with open(os.path.join(run, tlora.LORA_FILE), "w") as f:
        json.dump({**_lcfg(), "bits": bits}, f)
    return os.path.join(run, "model")


@pytest.mark.parametrize("bits", [8, 16])
def test_served_export_answers_match_jax(setup, tmp_path, bits):
    """bits 8: ``maybe_merge_lora`` quantizes the base and keeps the
    adapters lazy (``LoraAdapted`` over the int8 projections), bits 16
    merges them; the answers equal the JAX engine's over JAX's
    ``apply_lora`` / ``merge_lora_into_params`` of the same trees."""
    info, _, dc, params = setup
    lcfg = jlora.LoraConfig(**_lcfg())
    base = jquant.quantize_tree(params, bits=8) if bits == 8 else params
    jtr = _jax_trainable(base, seed=3)
    served = (jlora.apply_lora(base, jtr, lcfg) if bits == 8
              else jlora.merge_lora_into_params(base, jtr, lcfg))
    tparams = tlora.maybe_merge_lora(
        from_jax_params(_host(params), TCFG, device="cpu"),
        _export(tmp_path, jtr, bits))
    wq = tparams["llm"]["layers"][0]["attn"]["wq"]
    if bits == 8:
        assert isinstance(wq, tquant.LoraAdapted)
        assert tquant.is_quantized(wq.base)
    else:
        assert isinstance(wq, torch.Tensor)
    assert tlora.maybe_merge_lora(tparams, None) is tparams
    qs = [_question(info, t, i) for i, t in enumerate(QUESTIONS)]
    tok = FakeTokenizer()
    jeng = jdrv.InferenceEngine(
        served, CFG, tok, VideoProcessor(dc),
        SigLipImageProcessor(size=(CFG.vision.image_size,) * 2),
        _ecfg(jdrv, tok), device_geometry=True)
    want = [jeng.generate_answer(q) for q in qs]
    tok = FakeTokenizer()
    eng = tdrv.InferenceEngine(
        tparams, TCFG, tok, TVideoProcessor(port_config(dc)),
        TSigLipImageProcessor(size=(CFG.vision.image_size,) * 2),
        _ecfg(tdrv, tok), device="cpu")
    assert [eng.generate_answer(q) for q in qs] == want
