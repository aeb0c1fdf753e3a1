"""The port's sparse-MoE block (``models/moe.py``) against the JAX
package's on the CPU in float32: ``moe_block`` with and without the shared
expert and with ``norm_topk_prob`` on and off; the Qwen2-MoE and Mixtral
layer converters and ``convert_qwen2`` on an HF-layout state the test
builds; and one LM training step of a Qwen2-MoE model (loss and gradient
norm) against JAX's ``train_step``."""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from video3d_tpu.config import DataConfig, MoEConfig
from video3d_tpu.data import dataset as jds
from video3d_tpu.data.image_processor import SigLipImageProcessor
from video3d_tpu.models import llava_video3d as jlv
from video3d_tpu.models import moe as jmoe
from video3d_tpu.models import weights as jw
from video3d_tpu.train import optim as joptim
from video3d_tpu.train import train_step as jts
from video3d_tpu_torch.models import moe as tmoe
from video3d_tpu_torch.models import weights as tw
from video3d_tpu_torch.params import from_jax_params, from_jax_tree
from video3d_tpu_torch.train import optim as toptim
from video3d_tpu_torch.train import train_step as tts
from video3d_tpu_torch.train.trainer import to_batch

from family_configs import jax_params, model_config
from fixtures import FakeTokenizer, make_fake_annotations, make_fake_scene
from port_configs import port_config

torch.set_num_threads(1)

ATOL = 1e-5     # f32 sums over a few dozen products


def _leaves_close(t, j, path="", atol=0.0):
    if isinstance(j, dict):
        assert set(t) == set(j), path
        for k in j:
            _leaves_close(t[k], j[k], f"{path}/{k}", atol)
    elif isinstance(j, list):
        assert len(t) == len(j), path
        for i, (a, b) in enumerate(zip(t, j)):
            _leaves_close(a, b, f"{path}/{i}", atol)
    else:
        np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=0,
                                   atol=atol, err_msg=path)


@pytest.mark.parametrize("shared,norm_topk", [(True, False), (True, True),
                                              (False, True), (False, False)])
def test_moe_block_matches_jax(shared, norm_topk):
    cfg = model_config("qwen2_moe").llm
    moe = MoEConfig(num_experts=6, num_experts_per_tok=2,
                    moe_intermediate_size=24,
                    shared_expert_intermediate_size=40 if shared else None,
                    norm_topk_prob=norm_topk)
    jp = jmoe.init_moe_block(jax.random.PRNGKey(3), cfg, moe)
    assert ("shared" in jp) == shared
    x = np.random.default_rng(0).normal(size=(2, 5, cfg.hidden_size)) \
        .astype(np.float32)
    want = np.asarray(jmoe.moe_block(jp, jnp.asarray(x), moe))
    got = tmoe.moe_block(from_jax_tree(jax.tree.map(np.asarray, jp),
                                       device="cpu"),
                         torch.from_numpy(x), port_config(moe))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=ATOL)


def test_routing_picks_top_k_experts():
    """The dense routing matrix holds k non-zeros per token, at the k
    largest probabilities, summing to 1 under norm_topk_prob."""
    cfg = MoEConfig(num_experts=5, num_experts_per_tok=2,
                    moe_intermediate_size=8, norm_topk_prob=True)
    logits = torch.tensor([[0.1, 2.0, -1.0, 1.5, 0.0],
                           [3.0, -2.0, 0.5, 0.4, 2.9]])
    w = tmoe.routing_weights(logits, port_config(cfg), torch.float32)
    assert (w > 0).sum(-1).tolist() == [2, 2]
    assert w[0, 1] > 0 and w[0, 3] > 0 and w[1, 0] > 0 and w[1, 4] > 0
    np.testing.assert_allclose(w.sum(-1).numpy(), [1.0, 1.0], rtol=1e-6)


def _hf_moe_state(cfg, mixtral: bool, rng):
    """An HF-layout (out, in) state of a 2-layer MoE decoder without the
    attention and embeddings the converters do not read."""
    D, moe = cfg.hidden_size, cfg.moe
    I, E = moe.moe_intermediate_size, moe.num_experts
    st = {}
    for i in range(cfg.num_hidden_layers):
        if mixtral:
            p = f"model.layers.{i}.block_sparse_moe."
            names = (("w1", I, D), ("w3", I, D), ("w2", D, I))
        else:
            p = f"model.layers.{i}.mlp."
            names = (("gate_proj", I, D), ("up_proj", I, D),
                     ("down_proj", D, I))
            S = moe.shared_expert_intermediate_size
            st[p + "shared_expert.gate_proj.weight"] = rng.normal(size=(S, D))
            st[p + "shared_expert.up_proj.weight"] = rng.normal(size=(S, D))
            st[p + "shared_expert.down_proj.weight"] = rng.normal(size=(D, S))
            st[p + "shared_expert_gate.weight"] = rng.normal(size=(1, D))
        st[p + "gate.weight"] = rng.normal(size=(E, D))
        for e in range(E):
            for name, o, n in names:
                st[f"{p}experts.{e}.{name}.weight"] = rng.normal(size=(o, n))
    return {k: v.astype(np.float32) for k, v in st.items()}


@pytest.mark.parametrize("family", ["qwen2_moe", "mixtral"])
def test_layer_converters_match_jax(family):
    cfg = model_config(family).llm
    mixtral = family == "mixtral"
    state = _hf_moe_state(cfg, mixtral, np.random.default_rng(4))
    jconv = jmoe.convert_mixtral_layer if mixtral else jmoe.convert_moe_layer
    tconv = tmoe.convert_mixtral_layer if mixtral else tmoe.convert_moe_layer
    for i in range(cfg.num_hidden_layers):
        want = jconv(state, i, cfg.moe)
        got = tconv(state, i, port_config(cfg.moe), device="cpu")
        _leaves_close(got, jax.tree.map(np.asarray, want))


@pytest.mark.parametrize("family", ["qwen2_moe", "mixtral"])
def test_convert_qwen2_reads_moe_checkpoints(family):
    """A whole MoE checkpoint (attention, norms, embeddings and the expert
    layers) through convert_qwen2: the port's tree equals JAX's."""
    cfg = model_config(family)
    rng = np.random.default_rng(5)
    state = _hf_moe_state(cfg.llm, family == "mixtral", rng)
    tree = jax_params(cfg)["llm"]
    D, V = cfg.llm.hidden_size, cfg.llm.vocab_size
    state["model.embed_tokens.weight"] = rng.normal(size=(V, D))
    state["lm_head.weight"] = rng.normal(size=(V, D))
    state["model.norm.weight"] = rng.normal(size=(D,))
    for i, layer in enumerate(tree["layers"]):
        p = f"model.layers.{i}."
        for n, key in (("q_proj", "wq"), ("k_proj", "wk"), ("v_proj", "wv"),
                       ("o_proj", "wo")):
            state[f"{p}self_attn.{n}.weight"] = layer["attn"][key].T
        for n, key in (("q_proj", "bq"), ("k_proj", "bk"), ("v_proj", "bv")):
            if key in layer["attn"]:
                state[f"{p}self_attn.{n}.bias"] = layer["attn"][key]
        state[p + "input_layernorm.weight"] = layer["input_layernorm"]
        state[p + "post_attention_layernorm.weight"] = \
            layer["post_attention_layernorm"]
    state = {k: np.asarray(v, np.float32) for k, v in state.items()}
    want = jax.tree.map(np.asarray, jw.convert_qwen2(state, cfg.llm))
    got = tw.convert_qwen2(state, port_config(cfg.llm), device="cpu")
    _leaves_close(got, want)
    assert all("moe" in layer and "mlp" not in layer
               for layer in got["layers"])


@pytest.fixture(scope="module")
def lm_batch(tmp_path_factory):
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
    ds = jds.SupervisedDataset(ann, FakeTokenizer(), dc,
                               image_processor=SigLipImageProcessor(
                                   size=(56, 56)))
    cfg = model_config("qwen2_moe")
    col = jds.Collator(cfg, jds.CollatorConfig(max_len=160,
                                               frames_upbound=2))
    return cfg, col([ds[0], ds[1]])


def test_train_step_matches_jax(lm_batch):
    """One f32 LM step of a Qwen2-MoE model: loss and gradient norm within
    1e-4 relative of JAX's ``train_step`` (autograd through the dense
    routing against XLA's)."""
    cfg, arrays = lm_batch
    full = jax_params(cfg)
    used = {k: full[k] for k in ("vision", "projector", "image_newline",
                                 "llm")}
    opt = dict(total_steps=4, learning_rate=1e-3, warmup_ratio=0.0)
    jparams = jax.tree.map(jnp.array, used)
    jtx = joptim.build_optimizer(jparams, joptim.OptimConfig(**opt))
    jstate = jts.create_train_state(jparams, jtx)
    jbatch = jlv.Batch(**{k: jnp.asarray(v) for k, v in arrays.items()
                          if k in jlv.Batch._fields and v is not None})
    _, jm = jts.train_step(jstate, jbatch, cfg, jtx, remat=False,
                           scan_layers=False, compute_dtype=None)
    tcfg = port_config(cfg)
    tparams = from_jax_params(used, tcfg, device="cpu")
    ttx = toptim.build_optimizer(tparams, toptim.OptimConfig(**opt))
    _, tm = tts.train_step(tts.create_train_state(tparams, ttx),
                           to_batch(arrays, "cpu"), tcfg, ttx, remat=False,
                           compute_dtype=None)
    for key in ("lm_loss", "grad_norm"):
        np.testing.assert_allclose(float(tm[key]), float(jm[key]),
                                   rtol=1e-4, err_msg=key)
