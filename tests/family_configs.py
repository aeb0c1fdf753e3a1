"""Tiny decoder families shared by the family parity tests: each family's
``config.json`` fields at test widths, parsed by the JAX builder, the JAX
model tree made for it (a MoE family's layers get ``init_moe_block`` in
place of their dense MLP), and the JAX and port engines over one scene."""

import os

import jax
import numpy as np
import torch

from video3d_tpu.config import DataConfig, ModelConfig, replace
from video3d_tpu.data.image_processor import SigLipImageProcessor
from video3d_tpu.data.video_processor import VideoProcessor
from video3d_tpu.eval import drivers as jdrv
from video3d_tpu.models import builder as jb
from video3d_tpu.models import llava_video3d as jlv
from video3d_tpu.models import moe as jmoe
from video3d_tpu_torch.data.image_processor import \
    SigLipImageProcessor as TSigLipImageProcessor
from video3d_tpu_torch.data.video_processor import \
    VideoProcessor as TVideoProcessor
from video3d_tpu_torch.eval import drivers as tdrv
from video3d_tpu_torch.params import from_jax_params

from fixtures import FakeTokenizer
from port_configs import port_config

torch.set_num_threads(1)

_BASE = {"vocab_size": 512, "hidden_size": 64, "intermediate_size": 128,
         "num_hidden_layers": 2, "num_attention_heads": 4,
         "max_position_embeddings": 1024}

#: config.json fields of each family at test widths (head_dim 16, and
#: Gemma's 256)
FAMILIES = {
    "llama": dict(_BASE, model_type="llama", num_key_value_heads=2),
    "mistral": dict(_BASE, model_type="mistral", num_key_value_heads=2,
                    rope_theta=1e6),
    "gemma": dict(_BASE, model_type="gemma", num_key_value_heads=1,
                  head_dim=16, hidden_activation="gelu_pytorch_tanh"),
    # Gemma's head width: 2 query heads of 256 on one kv head
    "gemma_hd256": dict(_BASE, model_type="gemma", hidden_size=512,
                        intermediate_size=256, num_attention_heads=2,
                        num_key_value_heads=1, head_dim=256,
                        hidden_activation="gelu_pytorch_tanh"),
    "mixtral": dict(_BASE, model_type="mixtral", num_key_value_heads=2,
                    num_local_experts=4, num_experts_per_tok=2),
    "qwen2_moe": dict(_BASE, model_type="qwen2_moe", num_key_value_heads=4,
                      num_experts=6, num_experts_per_tok=2,
                      moe_intermediate_size=32,
                      shared_expert_intermediate_size=48),
    "mpt": {"model_type": "mpt", "vocab_size": 512, "d_model": 64,
            "n_heads": 4, "n_layers": 2, "expansion_ratio": 2,
            "max_seq_len": 1024, "attn_config": {"alibi_bias_max": 8.0}},
}


def model_config(family: str) -> ModelConfig:
    """ModelConfig.tiny() with the family's decoder, as JAX parses it."""
    return replace(ModelConfig.tiny(),
                   llm=jb.llm_config_from_hf(FAMILIES[family]))


def jax_params(cfg: ModelConfig, seed: int = 0):
    """JAX ``init_model`` for ``cfg``; a MoE decoder's layers take
    ``moe.init_moe_block`` in place of the dense MLP ``init_qwen2``
    draws. Leaves as numpy arrays."""
    params = jlv.init_model(jax.random.PRNGKey(seed), cfg)
    if cfg.llm.moe is not None:
        for i, layer in enumerate(params["llm"]["layers"]):
            del layer["mlp"]
            layer["moe"] = jmoe.init_moe_block(
                jax.random.PRNGKey(100 + i), cfg.llm, cfg.llm.moe)
    return jax.tree.map(np.asarray, params)


def data_config(root: str, frames: int = 2) -> DataConfig:
    return DataConfig(video_folder=root,
                      annotation_dir=os.path.join(root, "embodiedscan"),
                      metadata_dir=os.path.join(root, "metadata"),
                      frames_upbound=frames)


def _ecfg(module, tok, **kw):
    return module.EngineConfig(max_new_tokens=4,
                               eos_token_id=tok.eos_token_id, max_frames=2,
                               buckets=(256,), stop_str="",
                               suffix_buckets=(32, 64), **kw)


def engines(cfg: ModelConfig, params, data_cfg: DataConfig, **kw):
    """(JAX engine, port engine on the CPU) over the same f32 tree, each
    with its own FakeTokenizer."""
    size = (cfg.vision.image_size,) * 2
    jtok, ttok = FakeTokenizer(), FakeTokenizer()
    jeng = jdrv.InferenceEngine(params, cfg, jtok, VideoProcessor(data_cfg),
                                SigLipImageProcessor(size=size),
                                _ecfg(jdrv, jtok, **kw),
                                device_geometry=True)
    tcfg = port_config(cfg)
    teng = tdrv.InferenceEngine(
        from_jax_params(params, tcfg, device="cpu"), tcfg, ttok,
        TVideoProcessor(port_config(data_cfg)),
        TSigLipImageProcessor(size=size), _ecfg(tdrv, ttok, **kw),
        device="cpu")
    return jeng, teng


def question(info, text: str, i: int = 0) -> dict:
    return {"id": f"q{i}", "video": info["sample_idx"],
            "conversations": [{"from": "human", "value": f"<image>\n{text}"},
                              {"from": "gpt", "value": None}]}


QUESTIONS = ("what color is the chair", "how many tables are there")


def hf_llm_state(cfg: ModelConfig, llm) -> dict:
    """The HF-layout (out, in) state of a JAX decoder tree (numpy leaves)
    of the family of ``cfg``: Qwen2 / LLaMA keys with Qwen2-MoE's
    ``mlp.gate`` / ``mlp.experts`` / shared expert or Mixtral's
    ``block_sparse_moe``, or MPT's ``transformer.*`` with the fused Wqkv
    and the head tied to ``wte``."""
    st = {}
    if cfg.llm.position_embedding == "alibi":
        st["transformer.wte.weight"] = llm["embed_tokens"]
        st["transformer.norm_f.weight"] = llm["norm"]
        for i, lay in enumerate(llm["layers"]):
            p = f"transformer.blocks.{i}."
            a = lay["attn"]
            st[p + "norm_1.weight"] = lay["input_layernorm"]
            st[p + "norm_2.weight"] = lay["post_attention_layernorm"]
            st[p + "attn.Wqkv.weight"] = np.concatenate(
                [a["wq"].T, a["wk"].T, a["wv"].T])
            st[p + "attn.out_proj.weight"] = a["wo"].T
            st[p + "ffn.up_proj.weight"] = lay["mlp"]["w_up"].T
            st[p + "ffn.down_proj.weight"] = lay["mlp"]["w_down"].T
        return {k: np.ascontiguousarray(v, np.float32) for k, v in st.items()}
    st["model.embed_tokens.weight"] = llm["embed_tokens"]
    st["model.norm.weight"] = llm["norm"]
    st["lm_head.weight"] = llm["lm_head"].T
    mixtral = cfg.llm.moe is not None and \
        cfg.llm.moe.shared_expert_intermediate_size is None
    for i, lay in enumerate(llm["layers"]):
        p = f"model.layers.{i}."
        a = lay["attn"]
        st[p + "input_layernorm.weight"] = lay["input_layernorm"]
        st[p + "post_attention_layernorm.weight"] = \
            lay["post_attention_layernorm"]
        for n, key in (("q_proj", "wq"), ("k_proj", "wk"), ("v_proj", "wv"),
                       ("o_proj", "wo")):
            st[f"{p}self_attn.{n}.weight"] = a[key].T
        for n, key in (("q_proj", "bq"), ("k_proj", "bk"), ("v_proj", "bv")):
            if key in a:
                st[f"{p}self_attn.{n}.bias"] = a[key]
        if "moe" not in lay:
            for n, key in (("gate_proj", "w_gate"), ("up_proj", "w_up"),
                           ("down_proj", "w_down")):
                st[f"{p}mlp.{n}.weight"] = lay["mlp"][key].T
            continue
        m = lay["moe"]
        mp = p + ("block_sparse_moe." if mixtral else "mlp.")
        st[mp + "gate.weight"] = m["router"].T
        names = (("w1", "w_gate"), ("w3", "w_up"), ("w2", "w_down")) \
            if mixtral else (("gate_proj", "w_gate"), ("up_proj", "w_up"),
                             ("down_proj", "w_down"))
        for e in range(m["router"].shape[1]):
            for n, key in names:
                st[f"{mp}experts.{e}.{n}.weight"] = m["experts"][key][e].T
        if "shared" in m:
            for n, key in (("gate_proj", "w_gate"), ("up_proj", "w_up"),
                           ("down_proj", "w_down")):
                st[f"{mp}shared_expert.{n}.weight"] = m["shared"][key].T
            st[mp + "shared_expert_gate.weight"] = m["shared_gate"].T
    return {k: np.ascontiguousarray(v, np.float32) for k, v in st.items()}


def write_family_checkpoint(path: str, family: str, seed: int = 0):
    """A LLaVA checkpoint directory of ``family`` at test widths, written
    with the port's own safetensors writer: config.json (the family's
    fields), the decoder's HF keys, and the tower, projector and newline
    of the port's export. Returns the JAX tree it was made from."""
    import json

    from video3d_tpu_torch.models import weights as tw

    cfg = model_config(family)
    params = jax_params(cfg, seed)
    os.makedirs(path, exist_ok=True)
    glue = from_jax_params(
        {**params, "llm": {k: params["llm"][k] for k in
                           ("embed_tokens", "norm", "lm_head")}
         | {"layers": []}}, port_config(replace(cfg, llm=replace(
             cfg.llm, num_hidden_layers=0))), device="cpu")
    state = {k: v for k, v in tw.export_llava_checkpoint(
        glue, port_config(cfg.llm)).items()
        if not k.startswith(("model.embed_tokens", "model.norm", "lm_head"))}
    state.update(hf_llm_state(cfg, params["llm"]))
    tw.write_safetensors(state, os.path.join(path, "model.safetensors"))
    with open(os.path.join(path, "config.json"), "w") as f:
        json.dump(FAMILIES[family], f)
    return params
