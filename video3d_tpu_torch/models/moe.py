"""Sparse mixture-of-experts decoder blocks (Qwen2-MoE with its shared
expert, Mixtral without one), in PyTorch: counterpart of
``video3d_tpu/models/moe.py``.

A router linear D -> E scores each token; the top-k softmax probabilities
(renormalised over the chosen experts when ``norm_topk_prob``) weight the
SwiGLU experts' outputs; Qwen2-MoE adds a shared SwiGLU expert gated by
``sigmoid(x @ shared_gate)``.

The formulation is JAX's: the experts are stacked (E, D, I) and EVERY
expert runs on every token, weighted by a dense (T, E) routing matrix that
is zero where a token was not routed. That is exact, and it is a plain
product outside any kernel, in JAX (XLA) as here (``torch.einsum``). A
routed form that gathers each expert's tokens, E / k times less work, is
speed work for a later change (ROADMAP).
"""

from __future__ import annotations

from typing import Any, Dict, Mapping

import torch
import torch.nn.functional as F

from video3d_tpu_torch.config import LLMConfig, MoEConfig

Params = Dict[str, Any]


def _swiglu(x: torch.Tensor, w_gate: torch.Tensor, w_up: torch.Tensor,
            w_down: torch.Tensor) -> torch.Tensor:
    return (F.silu(x @ w_gate) * (x @ w_up)) @ w_down


def routing_weights(logits: torch.Tensor, cfg: MoEConfig,
                    dtype: torch.dtype) -> torch.Tensor:
    """(T, E) router logits -> the dense (T, E) routing matrix in ``dtype``:
    the f32 softmax's top-k probabilities (renormalised when
    ``norm_topk_prob``) at the chosen experts, zero elsewhere
    (``torch.topk`` sorts as ``jax.lax.top_k`` does)."""
    probs = torch.softmax(logits.to(torch.float32), dim=-1)
    topv, topi = torch.topk(probs, cfg.num_experts_per_tok, dim=-1)
    if cfg.norm_topk_prob:
        topv = topv / topv.sum(dim=-1, keepdim=True)
    return torch.zeros_like(probs).scatter(-1, topi, topv).to(dtype)


def moe_block(p: Params, x: torch.Tensor, cfg: MoEConfig) -> torch.Tensor:
    """x (B, L, D) -> (B, L, D).

    p: {router (D, E), experts {w_gate (E, D, I), w_up (E, D, I), w_down
    (E, I, D)}, and for Qwen2-MoE shared {w_gate, w_up, w_down} (2-D) and
    shared_gate (D, 1)}.
    """
    B, L, D = x.shape
    xt = x.reshape(-1, D)
    weights = routing_weights(xt @ p["router"], cfg, x.dtype)
    ex = p["experts"]
    gate = torch.einsum("td,edi->tei", xt, ex["w_gate"])
    up = torch.einsum("td,edi->tei", xt, ex["w_up"])
    expert_out = torch.einsum("tei,eid->ted", F.silu(gate) * up,
                              ex["w_down"])
    routed = torch.einsum("te,ted->td", weights, expert_out)
    if "shared" in p:
        sh = p["shared"]
        shared = _swiglu(xt, sh["w_gate"], sh["w_up"], sh["w_down"])
        routed = routed + shared * torch.sigmoid(xt @ p["shared_gate"])
    return routed.reshape(B, L, D)


def init_moe_block(llm: LLMConfig, cfg: MoEConfig, device,
                   generator: torch.Generator,
                   dtype=torch.float32) -> Params:
    """Random init with the JAX package's distribution (N(0, 0.02) for
    every matrix), made on ``device`` from ``generator``; the shared expert
    and its gate only where ``shared_expert_intermediate_size`` is set."""
    D, I = llm.hidden_size, cfg.moe_intermediate_size
    E, S = cfg.num_experts, cfg.shared_expert_intermediate_size

    def w(*shape):
        return torch.empty(shape, device=device, dtype=dtype).normal_(
            0.0, 0.02, generator=generator)

    out = {"router": w(D, E),
           "experts": {"w_gate": w(E, D, I), "w_up": w(E, D, I),
                       "w_down": w(E, I, D)}}
    if S is not None:
        out["shared"] = {"w_gate": w(D, S), "w_up": w(D, S),
                         "w_down": w(S, D)}
        out["shared_gate"] = w(D, 1)
    return out


def _stack(r, prefix: str, name: str, n: int) -> torch.Tensor:
    return torch.stack([r.lin(f"{prefix}experts.{e}.{name}.weight")
                        for e in range(n)])


def convert_moe_layer(state: Mapping[str, Any], layer_idx: int,
                      cfg: MoEConfig, prefix: str = "", dtype=torch.float32,
                      device=None) -> Params:
    """An HF ``Qwen2MoeForCausalLM`` layer's ``mlp`` -> the
    :func:`moe_block` tree on ``device`` (default: the card)."""
    from video3d_tpu_torch.models.weights import _Reader
    from video3d_tpu_torch.params import resolve_device

    r = _Reader(state, prefix, resolve_device(device), dtype)
    p = f"model.layers.{layer_idx}.mlp."
    return {
        "router": r.lin(p + "gate.weight"),
        "experts": {"w_gate": _stack(r, p, "gate_proj", cfg.num_experts),
                    "w_up": _stack(r, p, "up_proj", cfg.num_experts),
                    "w_down": _stack(r, p, "down_proj", cfg.num_experts)},
        "shared": {"w_gate": r.lin(p + "shared_expert.gate_proj.weight"),
                   "w_up": r.lin(p + "shared_expert.up_proj.weight"),
                   "w_down": r.lin(p + "shared_expert.down_proj.weight")},
        "shared_gate": r.lin(p + "shared_expert_gate.weight"),
    }


def convert_mixtral_layer(state: Mapping[str, Any], layer_idx: int,
                          cfg: MoEConfig, prefix: str = "",
                          dtype=torch.float32, device=None) -> Params:
    """An HF ``MixtralForCausalLM`` layer's ``block_sparse_moe`` -> the
    :func:`moe_block` tree (w1 = gate, w3 = up, w2 = down; no shared
    expert)."""
    from video3d_tpu_torch.models.weights import _Reader
    from video3d_tpu_torch.params import resolve_device

    r = _Reader(state, prefix, resolve_device(device), dtype)
    p = f"model.layers.{layer_idx}.block_sparse_moe."
    return {
        "router": r.lin(p + "gate.weight"),
        "experts": {"w_gate": _stack(r, p, "w1", cfg.num_experts),
                    "w_up": _stack(r, p, "w3", cfg.num_experts),
                    "w_down": _stack(r, p, "w2", cfg.num_experts)},
    }
