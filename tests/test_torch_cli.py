"""The port's command line (``python -m video3d_tpu_torch.cli``) on the
CPU, mirroring ``tests/test_cli.py``: ``--help``; the checkpoint's
config.json and the flag overrides; ``eval-scanqa`` on a tiny checkpoint
exported by the JAX package, its answers equal to the JAX CLI's on the
same directory (plain, ``--w8a8``, ``--prefix-cache 0``); ``eval-scanqa
--load-format dummy`` on a config-only directory; a two-step ``train``
and a QLoRA ``train`` whose export ``eval-scanqa --lora-path`` serves;
and the refusals (``--bits`` without LoRA, meshes, no card without
``--device``). The tokenizer loader is patched to the fixture's
FakeTokenizer in both CLIs."""

import json
import os
import subprocess
import sys

import pytest
import torch

import jax

import video3d_tpu.cli as jcli
import video3d_tpu_torch.cli as tcli
from video3d_tpu.config import ModelConfig
from video3d_tpu.models import llava_video3d as jlv
from video3d_tpu.models.weights import export_llava_checkpoint

from fixtures import FakeTokenizer, make_fake_annotations, make_fake_scene

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def env(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("data"))
    info = make_fake_scene(root, n_frames=3)
    cfg = ModelConfig.tiny()
    ckpt = str(tmp_path_factory.mktemp("ckpt") / "export")
    export_llava_checkpoint(jlv.init_model(jax.random.PRNGKey(0), cfg),
                            cfg.llm, cfg, ckpt)
    return root, info, ckpt


@pytest.fixture(autouse=True)
def fake_tokenizers(monkeypatch):
    monkeypatch.setattr(jcli, "_load_tokenizer", lambda p: FakeTokenizer())
    monkeypatch.setattr(tcli, "_load_tokenizer", lambda p: FakeTokenizer())


def data_flags(root, extra=()):
    return ["--video-folder", root,
            "--embodiedscan-folder", os.path.join(root, "embodiedscan"),
            "--metadata-folder", os.path.join(root, "metadata"),
            "--max-frame-num", "3", *extra]


def _questions(tmp_path, info, n=2):
    qfile = str(tmp_path / "questions.json")
    with open(qfile, "w") as f:
        json.dump([{
            "id": f"q{i}_0", "video": info["sample_idx"],
            "conversations": [
                {"from": "human", "value": f"<image>\nwhat is here {i}"},
                {"from": "gpt", "value": "chair"}],
            "metadata": {"dataset": "scanqa", "question_type": "what",
                         "answers": ["chair"]}} for i in range(n)], f)
    return qfile


def _answers(path):
    with open(path) as f:
        return [json.loads(line) for line in f]


def test_help_lists_the_commands():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-m", "video3d_tpu_torch.cli",
                          "--help"], capture_output=True, text=True,
                         timeout=120, env=env, cwd=REPO)
    assert out.returncode == 0
    for cmd in ("train", "eval-scanqa", "eval-sqa3d", "eval-scan2cap",
                "eval-scanrefer", "eval-multi3drefer"):
        assert cmd in out.stdout
    out = subprocess.run([sys.executable, "-m", "video3d_tpu_torch.cli",
                          "eval-scanqa", "--help"], capture_output=True,
                         text=True, timeout=120, env=env, cwd=REPO)
    for flag in ("--load-format", "--w8a8", "--lora-path", "--device",
                 "--load-in-4bit", "--prefix-cache"):
        assert flag in out.stdout


def test_load_model_reads_config_json_and_overrides(env):
    _, _, ckpt = env
    args = tcli.build_parser().parse_args(
        ["eval-scanqa", "--model-path", ckpt, "--question-file", "x",
         "--answer-file", "y", "--voxel-size", "0.25",
         "--world-position-embedding-type", "avg-mlp"])
    params, cfg = tcli._load_model(args, torch.device("cpu"))
    assert cfg.llm.hidden_size == 64
    assert cfg.world_3d.voxel.voxel_size == 0.25
    assert not cfg.world_3d.discrete
    assert {"vision", "llm", "projector"} <= set(params)
    args.world_position_embedding_type = "avg-discrete-foo"
    with pytest.raises(SystemExit):
        tcli._load_model(args, torch.device("cpu"))


@pytest.mark.parametrize("extra", [(), ("--w8a8",), ("--prefix-cache", "0")])
def test_eval_scanqa_matches_jax_cli(env, tmp_path, extra):
    root, info, ckpt = env
    qfile = _questions(tmp_path, info)
    out = {}
    for name, main, dev in (("jax", jcli.main, ()),
                            ("torch", tcli.main, ("--device", "cpu"))):
        afile = str(tmp_path / f"{name}.jsonl")
        main(["eval-scanqa", "--model-path", ckpt, "--question-file", qfile,
              "--answer-file", afile, "--max-new-tokens", "4", *extra, *dev,
              *data_flags(root)])
        out[name] = _answers(afile)
    assert len(out["torch"]) == 2
    assert [r["pred_response"] for r in out["torch"]] == \
        [r["pred_response"] for r in out["jax"]]
    assert [r["sample_id"] for r in out["torch"]] == ["q0_0", "q1_0"]


def test_eval_load_format_dummy(env, tmp_path):
    root, info, ckpt = env
    d = tmp_path / "dummy"
    d.mkdir()
    with open(os.path.join(ckpt, "config.json")) as f:
        hf = json.load(f)
    hf["vision_config"] = {"hidden_size": 32, "intermediate_size": 64,
                           "num_hidden_layers": 2, "num_attention_heads": 4,
                           "image_size": 56, "patch_size": 14}
    (d / "config.json").write_text(json.dumps(hf))
    afile = str(tmp_path / "a.jsonl")
    tcli.main(["eval-scanqa", "--model-path", str(d), "--question-file",
               _questions(tmp_path, info, 1), "--answer-file", afile,
               "--max-new-tokens", "4", "--load-format", "dummy",
               "--load-in-8bit", "--device", "cpu", *data_flags(root)])
    records = _answers(afile)
    assert len(records) == 1 and isinstance(records[0]["pred_response"], str)


def test_train_two_steps(env, tmp_path):
    root, info, ckpt = env
    ann = make_fake_annotations(root, info["sample_idx"], n=2)
    out = str(tmp_path / "run")
    metrics = os.path.join(out, "metrics.jsonl")
    tcli.main(["train", "--model-path", ckpt, "--data-path", ann,
               "--output-dir", out, "--num-epochs", "1",
               "--gradient-accumulation-steps", "1", "--max-len", "160",
               "--global-batch-size", "1", "--group-by", "none",
               "--metrics-file", metrics, "--device", "cpu",
               *data_flags(root)])
    steps = _answers(metrics)
    assert [s["step"] for s in steps] == [1, 2]
    assert all(s["lm_loss"] == s["lm_loss"] for s in steps)
    assert os.path.isfile(os.path.join(out, "model", "params.pt"))


def test_qlora_train_then_eval_with_adapters(env, tmp_path):
    root, info, ckpt = env
    ann = make_fake_annotations(root, info["sample_idx"], n=2)
    out = str(tmp_path / "run_qlora")
    tcli.main(["train", "--model-path", ckpt, "--data-path", ann,
               "--output-dir", out, "--num-epochs", "1",
               "--gradient-accumulation-steps", "1", "--max-len", "160",
               "--global-batch-size", "1", "--group-by", "none",
               "--lora-enable", "--lora-r", "4", "--lora-alpha", "8",
               "--bits", "8", "--device", "cpu", *data_flags(root)])
    assert os.path.isfile(os.path.join(out, "lora.json"))
    afile = str(tmp_path / "a_lora.jsonl")
    tcli.main(["eval-scanqa", "--model-path", ckpt, "--lora-path",
               os.path.join(out, "model"), "--question-file",
               _questions(tmp_path, info, 1), "--answer-file", afile,
               "--max-new-tokens", "4", "--device", "cpu",
               *data_flags(root)])
    assert len(_answers(afile)) == 1


def test_refusals(env, tmp_path):
    root, info, ckpt = env
    ann = make_fake_annotations(root, info["sample_idx"], n=2)
    with pytest.raises(SystemExit):
        tcli.main(["train", "--model-path", ckpt, "--data-path", ann,
                   "--output-dir", str(tmp_path / "x"), "--bits", "8",
                   "--device", "cpu", *data_flags(root)])
    with pytest.raises(NotImplementedError, match="A12"):
        tcli.main(["eval-scanqa", "--model-path", ckpt, "--question-file",
                   "q", "--answer-file", "a", "--tp", "2", "--device", "cpu"])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tcli.main(["eval-scanqa", "--model-path", ckpt,
                       "--question-file", "q", "--answer-file", "a"])


def test_worker_launcher_loads_the_checkpoint(env):
    """The worker's ``--load-format auto`` (its default) reads the
    checkpoint through the builder; ``--w8a8`` quantizes it so."""
    from video3d_tpu_torch.models.quant import W8A8Weight
    from video3d_tpu_torch.serve import model_worker as tmw

    _, _, ckpt = env
    args = tmw.build_parser().parse_args(
        ["--model-path", ckpt, "--device", "cpu", "--w8a8",
         "--max-frame-num", "3"])
    engine, adapters = tmw.build_worker_engines(args, FakeTokenizer())
    assert engine.cfg.llm.hidden_size == 64 and adapters == {}
    assert isinstance(engine.params["llm"]["lm_head"], W8A8Weight)
    assert engine.params["vision"]["layers"][0]["mlp"]["w1"].dtype == \
        torch.float32
