"""Training step: a loss with rematerialization, gradients, optimizer
update. Counterpart of ``video3d_tpu/train/train_step.py`` on one device
(no mesh, no ``scan_layers``): :func:`optimizer_step` takes the loss as a
function of the parameters, so the LM step (:func:`train_step`) and the
trainer's grounding step share the gradient and optimizer code.

The step mutates the state it is given: gradients are taken with
``torch.autograd.grad`` over the parameter leaves, the optimizer computes
the update in the gradients' buffers, and the update is added to the
parameters in place (JAX donates the state instead). Only floating leaves
get gradients; each leaf requires grad only inside the step.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, NamedTuple, Tuple

import torch
from torch.profiler import record_function

from video3d_tpu_torch.config import ModelConfig
from video3d_tpu_torch.models import llava_video3d as lv3d
from video3d_tpu_torch.models.qwen2 import lm_head as qwen2_lm_head
from video3d_tpu_torch.train.optim import (apply_updates, global_norm,
                                           tree_leaves, tree_unflatten)


class TrainState(NamedTuple):
    params: Any
    opt_state: Any
    step: int


def create_train_state(params, tx) -> TrainState:
    return TrainState(params=params, opt_state=tx.init(params), step=0)


def cast_to_compute(params, compute_dtype=torch.bfloat16):
    """f32 MASTER params cast to the compute dtype at point of use (the
    reference's DeepSpeed bf16 mode: the optimizer owns the f32 copy, the
    forward/backward run in bf16). The cast is differentiable: the bf16
    gradient of each copy accumulates into its f32 leaf as f32. Non-f32
    leaves pass through unchanged."""
    if isinstance(params, dict):
        return {k: cast_to_compute(v, compute_dtype)
                for k, v in params.items()}
    if isinstance(params, (list, tuple)):
        return [cast_to_compute(v, compute_dtype) for v in params]
    if isinstance(params, torch.Tensor) and params.dtype == torch.float32:
        return params.to(compute_dtype)
    return params


def loss_fn(params, cfg: ModelConfig, batch: lv3d.Batch, remat: bool = True,
            force_chunked_ce: bool = False, compute_dtype=None
            ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    if compute_dtype is not None:
        params = cast_to_compute(params, compute_dtype)
    hidden, _ = lv3d.forward_hidden(params, cfg, batch, remat=remat)
    # the JAX dispatch: more than 2 GiB of f32 logits -> the chunked loss,
    # which never holds the (B, L, vocab) logits
    B, L, _ = hidden.shape
    if force_chunked_ce or B * L * cfg.llm.vocab_size * 4 > 2 << 30:
        lm = lv3d.chunked_language_model_loss(params, hidden, batch.labels,
                                              chunk=min(512, L))
    else:
        lm = lv3d.language_model_loss(qwen2_lm_head(params["llm"], hidden),
                                      batch.labels)
    return lm, {"lm_loss": lm}


def optimizer_step(state: TrainState, tx, objective: Callable
                   ) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
    """One optimizer (mini-)step of ``objective(params) -> (loss,
    metrics)``: the gradients of ``loss`` over the floating leaves (zeros
    for leaves it does not reach), ``metrics["grad_norm"]`` their global
    norm, and ``tx``'s update added to the parameters in place. The two
    halves run under ``torch.profiler.record_function`` ranges
    ``train_step/loss_and_grads`` and ``train_step/optimizer`` (cheap when
    no profiler runs)."""
    leaves = tree_leaves(state.params)
    wants = [t.is_floating_point() for t in leaves]
    for t, w in zip(leaves, wants):
        t.requires_grad_(w)
    try:
        with record_function("train_step/loss_and_grads"):
            loss, metrics = objective(state.params)
            diff = [t for t, w in zip(leaves, wants) if w]
            got = iter(torch.autograd.grad(loss, diff, allow_unused=True))
    finally:
        for t in leaves:
            t.requires_grad_(False)
    grads = []
    for t, w in zip(leaves, wants):
        g = next(got) if w else None
        grads.append(torch.zeros_like(t) if g is None else g)
    metrics = {k: v.detach() for k, v in metrics.items()}
    with record_function("train_step/optimizer"):
        metrics["grad_norm"] = global_norm(grads)
        updates, opt_state = tx.update(tree_unflatten(state.params, grads),
                                       state.opt_state, state.params)
        params = apply_updates(state.params, updates)
    return TrainState(params, opt_state, state.step + 1), metrics


def train_step(state: TrainState, batch: lv3d.Batch, cfg: ModelConfig, tx,
               remat: bool = True, force_chunked_ce: bool = False,
               compute_dtype=None
               ) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
    """One LM optimizer (mini-)step (:func:`optimizer_step` of
    :func:`loss_fn`). Returns (new_state, metrics); the state's tensors
    are updated in place. ``compute_dtype=torch.bfloat16`` with f32
    ``state.params`` gives mixed-precision training (f32 master weights,
    bf16 compute; see :func:`cast_to_compute`). ``metrics["grad_norm"]``
    is the global norm of the raw gradients."""
    return optimizer_step(state, tx, lambda p: loss_fn(
        p, cfg, batch, remat, force_chunked_ce, compute_dtype))
