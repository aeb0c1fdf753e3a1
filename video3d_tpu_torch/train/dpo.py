"""DPO (Direct Preference Optimization): the loss and the training step,
counterpart of ``video3d_tpu/train/dpo.py`` (the reference's optional DPO
stage, train_dpo.py + the vendored trl DPOTrainer): sigmoid DPO on chosen /
rejected response pairs against a frozen reference policy,

    L = -log sigmoid(beta * ((pi_c - ref_c) - (pi_r - ref_r)))

where each term sums the response tokens' log-probabilities (IGNORE_INDEX
masked). The step shares ``train_step.optimizer_step`` with the LM and
ground steps; the reference's forwards run under ``torch.no_grad()`` (JAX's
``stop_gradient``).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from video3d_tpu_torch.config import ModelConfig
from video3d_tpu_torch.constants import IGNORE_INDEX
from video3d_tpu_torch.models import llava_video3d as lv3d
from video3d_tpu_torch.train.train_step import (TrainState, cast_to_compute,
                                                optimizer_step)


@dataclasses.dataclass(frozen=True)
class DPOConfig:
    beta: float = 0.1
    label_smoothing: float = 0.0


def sequence_logprob(logits: torch.Tensor,
                     labels: torch.Tensor) -> torch.Tensor:
    """(B, L, V) logits and (B, L) labels -> (B,) summed log-probabilities
    of the supervised (non-IGNORE) next tokens, in float32."""
    shift_labels = labels[:, 1:]
    mask = shift_labels != IGNORE_INDEX
    safe = torch.where(mask, shift_labels, torch.zeros_like(shift_labels))
    logp = torch.log_softmax(logits[:, :-1].float(), dim=-1)
    tok = torch.gather(logp, -1, safe[..., None].long())[..., 0]
    return (tok * mask).sum(dim=-1)


def dpo_loss(policy_chosen_lp: torch.Tensor,
             policy_rejected_lp: torch.Tensor, ref_chosen_lp: torch.Tensor,
             ref_rejected_lp: torch.Tensor, cfg: DPOConfig
             ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Sigmoid DPO (Rafailov et al. 2023) with trl's label smoothing:
    the mean loss, the share of pairs whose implicit reward prefers the
    chosen answer, and the mean reward margin."""
    chosen_ratio = policy_chosen_lp - ref_chosen_lp
    rejected_ratio = policy_rejected_lp - ref_rejected_lp
    logits = cfg.beta * (chosen_ratio - rejected_ratio)
    loss = (-F.logsigmoid(logits) * (1 - cfg.label_smoothing)
            - F.logsigmoid(-logits) * cfg.label_smoothing).mean()
    return loss, {
        "dpo_loss": loss,
        "reward_accuracy": (logits > 0).float().mean(),
        "reward_margin": (cfg.beta * (chosen_ratio - rejected_ratio)).mean(),
    }


def dpo_step_loss(params, ref_params, model_cfg: ModelConfig,
                  chosen: lv3d.Batch, rejected: lv3d.Batch,
                  dpo_cfg: DPOConfig, remat: bool = True):
    """The DPO loss of one (chosen, rejected) batch pair: the policy's two
    forwards record gradients, the reference's run without."""

    def logprob(p, batch):
        return sequence_logprob(lv3d.forward(p, model_cfg, batch,
                                             remat=remat), batch.labels)

    pc, pr = logprob(params, chosen), logprob(params, rejected)
    with torch.no_grad():
        rc, rr = logprob(ref_params, chosen), logprob(ref_params, rejected)
    return dpo_loss(pc, pr, rc, rr, dpo_cfg)


def dpo_train_step(state: TrainState, ref_params, batch_pair,
                   model_cfg: ModelConfig, dpo_cfg: DPOConfig, tx,
                   remat: bool = True, compute_dtype=None
                   ) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
    """One optimizer step of :func:`dpo_step_loss` (``optimizer_step``:
    the state's tensors are updated in place; metrics are ``dpo_loss``'s
    and ``grad_norm``). ``compute_dtype=torch.bfloat16`` with f32
    ``state.params`` keeps f32 masters and computes in bf16; the reference
    is then cast to the same dtype (JAX ``dpo.py:92-97``), so both sides'
    log-ratios come from one precision."""
    chosen, rejected = batch_pair
    if compute_dtype is not None:
        ref_params = cast_to_compute(ref_params, compute_dtype)

    def objective(p):
        if compute_dtype is not None:
            p = cast_to_compute(p, compute_dtype)
        return dpo_step_loss(p, ref_params, model_cfg, chosen, rejected,
                             dpo_cfg, remat)

    return optimizer_step(state, tx, objective)
