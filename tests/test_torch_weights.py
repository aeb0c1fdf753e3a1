"""The port's checkpoint converters and its safetensors reader and writer,
on the CPU: the reader and writer against the ``safetensors`` package both
ways (every dtype the format has here, bf16 included); ``convert_qwen2``,
``convert_siglip``, ``vision_config_from_state``, ``convert_projector`` (every
projector variant) and ``convert_llava_checkpoint`` (with the ground head)
against the JAX converters on state dicts the tests build, leaf for leaf;
``export_llava_checkpoint``'s state against JAX's (contiguous f32, (out,
in)); and the refusal to export an MPT or a MoE tree, as JAX fails to."""

import json
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from video3d_tpu.config import ModelConfig, ProjectorConfig, replace
from video3d_tpu.models import llava_video3d as jlv
from video3d_tpu.models import weights as jw
from video3d_tpu_torch.models import weights as tw
from video3d_tpu_torch.params import from_jax_params

from port_configs import port_config

torch.set_num_threads(1)

CFG = ModelConfig.tiny()
TCFG = port_config(CFG)


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        if x.dtype == torch.bfloat16:
            return x.view(torch.int16).numpy().view(np.uint16)
        return x.numpy()
    a = np.asarray(x)
    return a.view(np.uint16) if a.dtype.name == "bfloat16" else a


def _same_tree(t, j, path=""):
    if isinstance(j, dict):
        assert set(t) == set(j), path
        for k in j:
            _same_tree(t[k], j[k], f"{path}/{k}")
    elif isinstance(j, (list, tuple)):
        assert len(t) == len(j), path
        for i, (a, b) in enumerate(zip(t, j)):
            _same_tree(a, b, f"{path}/{i}")
    else:
        assert t.is_contiguous(), path
        np.testing.assert_array_equal(_np(t), _np(j), err_msg=path)


def _tensors():
    g = torch.Generator().manual_seed(0)
    return {"a.f32": torch.randn(3, 5, generator=g),
            "b.bf16": torch.randn(7, generator=g).to(torch.bfloat16),
            "c.f16": torch.randn(2, 2, generator=g).to(torch.float16),
            "d.i8": torch.randint(-128, 127, (4, 3), dtype=torch.int8,
                                  generator=g),
            "e.i32": torch.randint(-99, 99, (6,), dtype=torch.int32,
                                   generator=g),
            "f.i64": torch.arange(5),
            "g.u8": torch.arange(9, dtype=torch.uint8).reshape(3, 3),
            "h.bool": torch.tensor([True, False, True]),
            "i.f64": torch.randn(2, generator=g, dtype=torch.float64),
            "j.scalar": torch.tensor(3.5)}


def test_reader_reads_the_package_files(tmp_path):
    st = pytest.importorskip("safetensors.torch")
    want = _tensors()
    path = str(tmp_path / "pkg.safetensors")
    st.save_file(want, path, metadata={"format": "pt"})
    got = tw.read_safetensors(path)
    assert set(got) == set(want)
    for k, v in want.items():
        assert got[k].dtype == v.dtype and got[k].shape == v.shape, k
        assert torch.equal(got[k], v), k


def test_package_reads_the_writers_files(tmp_path):
    st = pytest.importorskip("safetensors.torch")
    stn = pytest.importorskip("safetensors.numpy")
    want = _tensors()
    path = str(tmp_path / "mine.safetensors")
    n = tw.write_safetensors(want, path)
    assert n == os.path.getsize(path)
    got = st.load_file(path)
    for k, v in want.items():
        assert got[k].dtype == v.dtype and torch.equal(got[k], v), k
    arr = {"x": np.arange(12, dtype=np.float32).reshape(3, 4)}
    tw.write_safetensors(arr, path)
    np.testing.assert_array_equal(stn.load_file(path)["x"], arr["x"])
    assert torch.equal(tw.read_safetensors(path)["x"],
                       torch.from_numpy(arr["x"]))


def test_load_safetensors_dir_merges_shards(tmp_path):
    tw.write_safetensors({"a": torch.ones(2)}, str(tmp_path / "1.safetensors"))
    tw.write_safetensors({"b": torch.zeros(3)},
                         str(tmp_path / "2.safetensors"))
    (tmp_path / "config.json").write_text("{}")
    got = tw.load_safetensors_dir(str(tmp_path))
    assert set(got) == {"a", "b"}


@pytest.fixture(scope="module", params=["mlp2x_gelu", "linear",
                                        "mlp2x_res2x_gelu", "pooler"])
def exported(request):
    """JAX's export of a tiny model with each projector variant: the HF
    state the converters read."""
    cfg = replace(CFG, projector=ProjectorConfig(request.param))
    params = jax.tree.map(np.asarray,
                          jlv.init_model(jax.random.PRNGKey(0), cfg))
    rng = np.random.default_rng(1)
    params = jax.tree.map(
        lambda a: a + 0.01 * rng.standard_normal(a.shape).astype(a.dtype),
        params)
    return cfg, params, jw.export_llava_checkpoint(params, cfg.llm, cfg)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_convert_llava_checkpoint_matches_jax(exported, dtype):
    cfg, _, state = exported
    want = jw.convert_llava_checkpoint(state, cfg.llm, cfg.vision,
                                       dtype=getattr(jnp, dtype),
                                       ground_head=True)
    got = tw.convert_llava_checkpoint(state, TCFG.llm, TCFG.vision,
                                      dtype=getattr(torch, dtype),
                                      ground_head=True, device="cpu")
    _same_tree(got, want)


def test_converters_match_jax(exported):
    cfg, _, state = exported
    _same_tree(tw.convert_qwen2(state, TCFG.llm, device="cpu"),
               jw.convert_qwen2(state, cfg.llm))
    pre = "model.vision_tower.vision_tower.vision_model."
    _same_tree(tw.convert_siglip(state, TCFG.vision, prefix=pre,
                                 device="cpu"),
               jw.convert_siglip(state, cfg.vision, prefix=pre))
    _same_tree(tw.convert_projector(state, dtype=torch.bfloat16,
                                    device="cpu"),
               jw.convert_projector(state, dtype=jnp.bfloat16))
    assert port_config(jw.vision_config_from_state(state)) == \
        tw.vision_config_from_state(state)
    # torch tensors as the state's leaves (the reader's output)
    tstate = {k: torch.from_numpy(v) for k, v in state.items()}
    _same_tree(tw.convert_projector(tstate, device="cpu"),
               jw.convert_projector(state))


def test_export_matches_jax(exported, tmp_path):
    """The port's export of the same tree: the JAX export's keys, f32
    contiguous (out, in) values, and the files round-trip."""
    cfg, params, want = exported
    tparams = from_jax_params(params, TCFG, device="cpu")
    got = tw.export_llava_checkpoint(tparams, TCFG.llm, TCFG,
                                     str(tmp_path / "ex"))
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == torch.float32 and got[k].is_contiguous(), k
        np.testing.assert_array_equal(got[k].numpy(), want[k], err_msg=k)
    jw.export_llava_checkpoint(params, cfg.llm, cfg, str(tmp_path / "jx"))
    with open(tmp_path / "ex" / "config.json") as f, \
            open(tmp_path / "jx" / "config.json") as g:
        assert json.load(f) == json.load(g)
    back = tw.read_safetensors(str(tmp_path / "ex" / "model.safetensors"))
    for k in want:
        assert torch.equal(back[k], got[k]), k


def test_mpt_and_moe_checkpoints_refused(exported):
    """MPT and MoE checkpoints convert now (``tests/test_torch_mpt.py``,
    ``tests/test_torch_moe.py``); what stays refused is their export,
    whose layout holds a dense gated MLP only (JAX's fails on both)."""
    cfg, _, state = exported
    tree = tw.convert_llava_checkpoint(state, TCFG.llm, TCFG.vision,
                                       device="cpu")
    moe = dict(tree["llm"]["layers"][1])
    moe["moe"] = moe.pop("mlp")
    mpt = dict(tree["llm"]["layers"][1])
    mpt["mlp"] = {k: v for k, v in mpt["mlp"].items() if k != "w_gate"}
    for layer in (moe, mpt):
        llm = dict(tree["llm"], layers=[tree["llm"]["layers"][0], layer])
        with pytest.raises(ValueError, match="dense gated MLP"):
            tw.export_llava_checkpoint({**tree, "llm": llm}, TCFG.llm)


def test_converters_default_to_the_card(exported):
    _, _, state = exported
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tw.convert_projector(state)
