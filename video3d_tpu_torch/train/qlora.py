"""QLoRA: LoRA fine-tuning over a frozen quantized base, counterpart of
``video3d_tpu/train/qlora.py`` (the reference's bits 4 / 8 + lora_enable
branch, train_3d.py:1588-1657).

The base tree is int8- or int4-quantized (``models/quant.py``) and stays
frozen; only the LoRA factors and the extra trainables are trained.
:func:`~video3d_tpu_torch.train.lora.apply_lora` wraps each quantized
projection in a lazy ``LoraAdapted``, which ``quant.matmul`` evaluates as
``matmul(x, base) + ((x @ A) @ B) * scale``. A training product has more
rows than the weight-streaming kernels take, so its base term dequantizes
into the compute dtype and runs a dense matmul, through which the gradient
of x is exact. At full width the int8 base is ~9 GB and the int4 one ~5.5
GB against ~16 GB in bf16: the 28-layer model fine-tunes on one card.

Weight-only quantization only: a base whose activations are rounded (JAX's
w8a8) would have a zero gradient almost everywhere, and
:func:`check_qlora_base` refuses any weight form that is not plain or
weight-only quantized.
"""

from __future__ import annotations

from typing import Any, Dict, NamedTuple, Tuple

import torch

from video3d_tpu_torch.config import ModelConfig
from video3d_tpu_torch.models import llava_video3d as lv3d
from video3d_tpu_torch.models import quant
from video3d_tpu_torch.train.lora import LoraConfig, apply_lora
from video3d_tpu_torch.train.optim import tree_leaves
from video3d_tpu_torch.train.train_step import (TrainState, cast_to_compute,
                                                loss_fn, optimizer_step)


class QLoraState(NamedTuple):
    lora: Any           # the trainable {"A", "B"} / None tree
    opt_state: Any      # the optimizer's state over ``lora`` only
    step: int


def check_qlora_base(params) -> None:
    """Raise TypeError for a base weight that is neither plain nor
    weight-only quantized (int8 dict, ``Int4Weight``, or one of those
    adapted): JAX refuses its w8a8 weights so, because rounding
    activations has a zero gradient and would starve every layer below of
    signal."""
    bad = [type(w).__name__ for w in tree_leaves(params)
           if not isinstance(w, (torch.Tensor, quant.Int4Weight,
                                 quant.LoraAdapted))]
    if bad:
        names = "/".join(sorted(set(bad)))
        raise TypeError(
            f"QLoRA over w8a8 weights is unsupported ({len(bad)} {names} "
            "leaves): activation rounding has zero gradient. Quantize the "
            "base with act='none' (weight-only int8) instead.")


def qlora_loss_fn(lora, qparams, cfg: ModelConfig, batch: lv3d.Batch,
                  lcfg: LoraConfig, remat: bool = True,
                  force_chunked_ce: bool = False,
                  compute_dtype=torch.bfloat16
                  ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """The LM loss of the base with the trainable tree applied:
    ``compute_dtype`` casts the f32 master trainables at use
    (``cast_to_compute``); the base is used as it is (its quantized leaves
    carry their scales; frozen f32 norms may stay f32)."""
    if compute_dtype is not None:
        lora = cast_to_compute(lora, compute_dtype)
    merged = apply_lora(qparams, lora, lcfg)
    return loss_fn(merged, cfg, batch, remat=remat,
                   force_chunked_ce=force_chunked_ce, compute_dtype=None)


def qlora_train_step(state: QLoraState, qparams, batch: lv3d.Batch,
                     cfg: ModelConfig, tx, lcfg: LoraConfig,
                     remat: bool = True, force_chunked_ce: bool = False,
                     compute_dtype=torch.bfloat16
                     ) -> Tuple[QLoraState, Dict[str, torch.Tensor]]:
    """One optimizer (mini-)step over the trainable tree only
    (``optimizer_step`` of :func:`qlora_loss_fn`): ``qparams`` is read,
    never written; the state's tensors are updated in place."""
    new, metrics = optimizer_step(
        TrainState(state.lora, state.opt_state, state.step), tx,
        lambda lo: qlora_loss_fn(lo, qparams, cfg, batch, lcfg, remat,
                                 force_chunked_ce, compute_dtype))
    return QLoraState(new.params, new.opt_state, new.step), metrics


def create_qlora_state(lora, tx) -> QLoraState:
    return QLoraState(lora=lora, opt_state=tx.init(lora), step=0)
