"""Training loop on one device: task-aware batching, grad accumulation,
logging, checkpoint / resume, preemption.

Counterpart of ``video3d_tpu/train/trainer.py`` (the reference recipe,
train_3d.py::train + LLaVATrainer): generative batches train the LM
cross-entropy, grounding batches (ScanRefer / Multi3DRefer) the InfoNCE
ground head exactly like the reference's ``predict_box`` path
(llava_qwen.py:302-331); f32 master weights with bf16 compute,
rematerialization, ``MultiSteps`` accumulation over both kinds of
mini-step, the epoch order of the samplers, resume that skips the batches
already trained, ``use_pos_skipping``, a metrics jsonl, SIGTERM ->
checkpoint -> exit, the final bf16 export, and ``evaluate()``. With
``lora_r > 0`` it fine-tunes LoRA adapters and the reference's non-LoRA
trainables over a frozen bf16 base, int8- or int4-quantized with
``lora_bits`` 8 or 4 (QLoRA, ``train/lora.py``, ``train/qlora.py``), and
exports the trainable tree beside ``lora.json``. Not ported, and raising
``NotImplementedError`` with its ROADMAP item: meshes (``dp``, ``tp``,
``sp`` > 1, A12). The loop runs on the card unless the caller passes a
CPU device.
"""

from __future__ import annotations

import dataclasses
import json
import os
import signal
import time
from typing import Dict, NamedTuple, Optional

import numpy as np
import torch

from video3d_tpu_torch.config import GroundHeadType, ModelConfig
from video3d_tpu_torch.models import llava_video3d as lv3d
from video3d_tpu_torch.models import quant
from video3d_tpu_torch.params import (check_card_path, check_config,
                                      resolve_device)
from video3d_tpu_torch.train import checkpoint as ckpt
from video3d_tpu_torch.train.lora import (LORA_FILE, LoraConfig, apply_lora,
                                          init_lora_trainable)
from video3d_tpu_torch.train.optim import (MultiSteps, OptimConfig,
                                           build_optimizer)
from video3d_tpu_torch.train.prefetch import BatchPrefetcher
from video3d_tpu_torch.train.qlora import check_qlora_base, qlora_loss_fn
from video3d_tpu_torch.train.samplers import (
    batches_from_order, get_length_grouped_indices,
    get_modality_length_grouped_indices, get_task_length_grouped_indices)
from video3d_tpu_torch.train.train_step import (TrainState,
                                                cast_to_compute,
                                                create_train_state, loss_fn,
                                                optimizer_step, train_step)


@dataclasses.dataclass
class TrainingConfig:
    output_dir: str = "checkpoints/run"
    num_epochs: int = 1
    per_device_batch_size: int = 1
    gradient_accumulation_steps: int = 2
    save_steps: int = 1000
    logging_steps: int = 1
    metrics_file: Optional[str] = None     # jsonl metrics log (wandb-free)
    seed: int = 0
    # task_length | length | modality_length | none
    group_by: str = "task_length"
    bf16: bool = True
    # f32 MASTER weights with bf16 compute (the reference's DeepSpeed-bf16
    # semantics, scripts/zero3.json: fp32 master/optimizer partitions).
    # False stores params in bf16 outright, which at the recipe's lr=1e-5
    # rounds away most AdamW updates.
    master_f32: bool = True
    remat: bool = True
    dp: int = 1
    tp: int = 1
    sp: int = 1
    # use_pos_skipping (llava_arch.py:823-829): during training, add random
    # offsets to position ids before/after a random split point. 0 disables.
    pos_skipping_range: int = 0
    # LoRA fine-tuning (reference train_3d.py:1588-1657 lora_enable):
    # lora_r > 0 trains {"A","B"} adapters on the LLM projections plus the
    # reference's non-LoRA trainables (projector / ground head /
    # image_newline) with the base FROZEN in bf16; lora_bits 8 or 4 also
    # quantizes the frozen base (QLoRA, the bitsandbytes bits-4/8 branch)
    lora_r: int = 0
    lora_alpha: int = 0        # 0 -> 2 * lora_r
    lora_bits: int = 16        # 16 = bf16 frozen base; 8 / 4 = quantized
    # the ground mini-step's loss is this times the InfoNCE loss
    grounding_loss_weight: float = 1.0


def apply_pos_skipping(position_ids: np.ndarray, skip_range: int,
                       rng: np.random.Generator) -> np.ndarray:
    """use_pos_skipping (llava_arch.py:823-829): pick a random split point,
    add ``left_add`` to ids before it and ``right_add >= left_add`` after."""
    L = position_ids.shape[1]
    split = int(rng.integers(0, L + 1))
    left_add = int(rng.integers(0, skip_range + 1))
    right_add = int(rng.integers(left_add, skip_range + 1))
    out = position_ids.copy()
    out[:, :split] += left_add
    out[:, split:] += right_add
    return out


def _tensor(arrays: Dict[str, np.ndarray], name: str, device, dtype=None):
    x = torch.from_numpy(np.asarray(arrays[name]))
    return x.to(device=device, dtype=dtype or x.dtype)


def to_batch(arrays: Dict[str, np.ndarray], device) -> lv3d.Batch:
    """The collator's host arrays -> a model ``Batch`` on ``device`` (a
    grounding batch's extras: :func:`ground_extras`). A field the
    collator does not give, or gives as None (``images`` and
    ``patch_coords`` of a 2D-image batch, the anyres fields of a video
    batch, ``box_input`` of an image batch), stays None; index arrays
    become int64 (the mrope ids too: they are positions on the device)."""

    def t(name, dtype=None):
        if arrays.get(name) is None:
            return None
        return _tensor(arrays, name, device, dtype)

    return lv3d.Batch(
        images=t("images"), patch_coords=t("patch_coords"),
        text_ids=t("text_ids", torch.long), kind=t("kind"),
        vision_index=t("vision_index", torch.long),
        position_ids=t("position_ids"), seq_len=t("seq_len"),
        labels=t("labels", torch.long), coord_mask=t("coord_mask"),
        box_input=t("box_input"),
        mrope_position_ids=t("mrope_position_ids", torch.long),
        image_tiles=t("image_tiles"),
        vision_gather=t("vision_gather", torch.long),
        vision_newline=t("vision_newline"), vision_valid=t("vision_valid"))


class GroundExtras(NamedTuple):
    """A grounding batch's targets beside its ``Batch`` (JAX passes the
    same five arrays to its ground step)."""

    world_coords: torch.Tensor    # (B, V, S, S, 3) per-pixel coordinates
    objects: torch.Tensor         # (B, N, 6) padded proposals
    objects_valid: torch.Tensor   # (B, N) bool
    ground_slot: torch.Tensor     # (B,) int64 spliced <ground> index
    box_label_hot: torch.Tensor   # (B, N+1) multi-hot, slot N zero target


def ground_extras(arrays: Dict[str, np.ndarray],
                  device) -> Optional[GroundExtras]:
    """The grounding extras of a collated batch on ``device``, or None for
    a batch without a ``ground_slot`` (a generative batch)."""
    if "ground_slot" not in arrays:
        return None
    return GroundExtras(*(
        _tensor(arrays, name, device, torch.long if name == "ground_slot"
                else None)
        for name in ("world_coords_full", "objects", "objects_valid",
                     "ground_slot", "box_label_hot")))


def grounding_loss_fn(params, cfg: ModelConfig, batch: lv3d.Batch,
                      extras: GroundExtras, remat: bool = True):
    """InfoNCE grounding loss of batch row 0 (JAX ``grounding_loss_fn``,
    llava_qwen.py:294-331): the full forward of the whole batch, then the
    scores of row 0's objects at its ``<ground>`` slot. As in JAX, rows 1..
    of a larger batch are computed and dropped. Only the INFONCE head has
    this loss: the MLP and SCORE heads score (N,) objects against the
    (N+1,) target, which JAX cannot trace either."""
    if cfg.ground_head != GroundHeadType.INFONCE:
        raise ValueError(f"the grounding train step needs the INFONCE "
                         f"ground head, not {cfg.ground_head.name}")
    scores = lv3d.grounding_forward(
        params, cfg, batch, extras.world_coords[0], extras.objects[0],
        extras.objects_valid[0], extras.ground_slot[0], remat=remat)
    loss = lv3d.infonce_loss(scores, extras.box_label_hot[0],
                             cfg.ground_head_temperature)
    return loss, {"ground_loss": loss}


def _cast_tree(tree, src: torch.dtype, dst: torch.dtype, device):
    if isinstance(tree, quant.Int4Weight):
        return quant.Int4Weight(tree.q4.to(device), tree.scale4.to(device),
                                tree.dims, tree.group)
    if isinstance(tree, dict):
        return {k: _cast_tree(v, src, dst, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_cast_tree(v, src, dst, device) for v in tree]
    if isinstance(tree, torch.Tensor):
        tree = tree.to(device)
        return tree.to(dst) if tree.dtype == src else tree
    return tree


def _upcast_state(state, device):
    """bf16 leaves of a restored state -> f32 (the master copy)."""
    if isinstance(state, torch.Tensor):
        return _cast_tree(state, torch.bfloat16, torch.float32, device)
    if isinstance(state, tuple) and hasattr(state, "_fields"):
        return type(state)(*(_upcast_state(x, device) for x in state))
    if isinstance(state, dict):
        return {k: _upcast_state(v, device) for k, v in state.items()}
    if isinstance(state, (list, tuple)):
        return [_upcast_state(v, device) for v in state]
    return state


class Trainer:
    def __init__(self, model_cfg: ModelConfig, params, dataset, collator,
                 optim_cfg: OptimConfig, train_cfg: TrainingConfig,
                 device=None):
        if max(train_cfg.dp, train_cfg.tp, train_cfg.sp) > 1:
            raise NotImplementedError("data / tensor / sequence parallel "
                                      "meshes are not ported (ROADMAP A12)")
        # the projectors and the newline layout JAX's collator and train
        # step fail on are refused before any work
        lv3d.check_projector(model_cfg, params.get("projector"))
        lv3d.check_newline_layout(model_cfg)
        self.cfg = model_cfg
        self.tcfg = train_cfg
        self.dataset = dataset
        self.collator = collator
        self.device = resolve_device(device)
        # every decoder family trains (MPT's ALiBi through the plain
        # attention and autograd); on the card a head width without B2
        # with the logsumexp and B6 forms (they take 128 and Gemma's 256)
        # is refused here
        check_config(model_cfg)
        check_card_path(model_cfg, self.device, "training")
        # bf16 + master_f32 (default): params stay f32 (the optimizer's
        # master copy; bf16 imports are upcast) and are cast to bf16 at use
        # inside the step. bf16 alone: params stored bf16 outright.
        self._compute_dtype = torch.bfloat16 if train_cfg.bf16 else None
        self._lora_cfg = None
        self.base_params = None
        if train_cfg.lora_r:
            # LoRA / QLoRA: the trainable tree is the adapters and the
            # non-LoRA trainables; the base is frozen (bf16: no master copy
            # for weights that never update), int8 / int4 with lora_bits
            self._lora_cfg = LoraConfig(
                r=train_cfg.lora_r,
                alpha=train_cfg.lora_alpha or 2 * train_cfg.lora_r)
            base = _cast_tree(params, torch.float32 if train_cfg.bf16
                              else None, torch.bfloat16, self.device)
            if train_cfg.lora_bits in (8, 4):
                base = quant.quantize_tree(base, bits=train_cfg.lora_bits)
                check_qlora_base(base)
            master = (torch.float32 if train_cfg.master_f32
                      or not train_cfg.bf16 else torch.bfloat16)
            params = init_lora_trainable(
                torch.Generator(device=self.device).manual_seed(
                    train_cfg.seed), base, self._lora_cfg, dtype=master)
            if master == torch.bfloat16:
                self._compute_dtype = None     # trainables already bf16
            self.base_params = base
        elif train_cfg.bf16 and train_cfg.master_f32:
            params = _cast_tree(params, torch.bfloat16, torch.float32,
                                self.device)
        elif train_cfg.bf16:
            params = _cast_tree(params, torch.float32, torch.bfloat16,
                                self.device)
            self._compute_dtype = None      # params already bf16
        else:
            params = _cast_tree(params, None, None, self.device)
        base_tx = build_optimizer(params, optim_cfg)
        if train_cfg.gradient_accumulation_steps > 1:
            self.tx = MultiSteps(base_tx,
                                 train_cfg.gradient_accumulation_steps)
        else:
            self.tx = base_tx
        self.state = create_train_state(params, self.tx)
        self._step_fn = self._step
        self._ground_step_fn = self._ground_step

    def _merged(self, trainable):
        """LoRA mode: the trainable tree (cast to the compute dtype) over
        the frozen base (JAX ``_merged``): dense bases merged, quantized
        ones lazy ``LoraAdapted`` leaves."""
        if self._compute_dtype is not None:
            trainable = cast_to_compute(trainable, self._compute_dtype)
        return apply_lora(self.base_params, trainable, self._lora_cfg)

    def _step(self, state: TrainState, batch: lv3d.Batch):
        if self._lora_cfg is not None:
            return optimizer_step(state, self.tx, lambda tr: qlora_loss_fn(
                tr, self.base_params, self.cfg, batch, self._lora_cfg,
                remat=self.tcfg.remat, compute_dtype=self._compute_dtype))
        return train_step(state, batch, self.cfg, self.tx,
                          remat=self.tcfg.remat,
                          compute_dtype=self._compute_dtype)

    def _ground_step(self, state: TrainState, batch: lv3d.Batch,
                     extras: GroundExtras):
        """A grounding mini-step (JAX ``_build_ground_step``): the weighted
        InfoNCE loss through the same optimizer as the LM steps, so
        ``MultiSteps`` counts both kinds of mini-step alike. Metrics: the
        unweighted ``ground_loss`` and ``grad_norm``."""
        w = self.tcfg.grounding_loss_weight
        cdt = self._compute_dtype

        def objective(p):
            if self._lora_cfg is not None:
                p = self._merged(p)
            elif cdt is not None:
                p = cast_to_compute(p, cdt)
            loss, metrics = grounding_loss_fn(p, self.cfg, batch, extras,
                                              self.tcfg.remat)
            return w * loss, metrics

        return optimizer_step(state, self.tx, objective)

    # ------------- data order -------------

    def _epoch_order(self, rng: np.random.Generator):
        bs = self.tcfg.per_device_batch_size
        if self.tcfg.group_by == "task_length":
            order = get_task_length_grouped_indices(
                self.dataset.task_lengths, bs, 1, rng)
        elif self.tcfg.group_by == "length":
            order = get_length_grouped_indices(self.dataset.lengths, bs, 1,
                                               rng)
        elif self.tcfg.group_by == "modality_length":
            order = get_modality_length_grouped_indices(
                self.dataset.modality_lengths, bs, 1, rng)
        else:
            order = list(rng.permutation(len(self.dataset)))
        return batches_from_order(order, bs)

    def _to_batch(self, arrays: Dict[str, np.ndarray]) -> lv3d.Batch:
        return to_batch(arrays, self.device)

    # ------------- evaluation (llava_trainer_eval.py equivalent) -------------

    @torch.no_grad()
    def evaluate(self, eval_dataset=None,
                 max_batches: Optional[int] = None) -> Dict[str, float]:
        """Mean LM loss over ``eval_dataset`` (default the training set)
        in consecutive batches of ``per_device_batch_size``, without
        updates or remat (JAX ``evaluate``; in LoRA mode its
        ``eval_loss_lora``: the loss of the merged tree)."""
        dataset = eval_dataset or self.dataset
        bs = self.tcfg.per_device_batch_size
        losses = []
        for s in range(0, len(dataset) - bs + 1, bs):
            if max_batches is not None and len(losses) >= max_batches:
                break
            batch = self._to_batch(self.collator(
                [dataset[i] for i in range(s, s + bs)]))
            if self._lora_cfg is not None:
                loss = loss_fn(self._merged(self.state.params), self.cfg,
                               batch, remat=False, compute_dtype=None)[0]
            else:
                loss = loss_fn(self.state.params, self.cfg, batch,
                               remat=False,
                               compute_dtype=self._compute_dtype)[0]
            losses.append(float(loss))
        return {"eval_loss": float(np.mean(losses)) if losses
                else float("nan"), "eval_batches": len(losses)}

    # ------------- main loop -------------

    def train(self, resume: bool = True) -> TrainState:
        start_step = 0
        if resume:
            latest = ckpt.latest_checkpoint(self.tcfg.output_dir)
            if latest:
                print(f"[trainer] resuming from {latest}")
                self.state = ckpt.restore_checkpoint(latest, self.state)
                if self.tcfg.bf16 and self.tcfg.master_f32:
                    # a checkpoint of a pure-bf16 run restores bf16 leaves:
                    # upcast them back to the f32 master copy
                    self.state = _upcast_state(self.state, self.device)
                start_step = int(self.state.step)

        rng = np.random.default_rng(self.tcfg.seed)
        global_step = start_step
        consumed = 0        # batches drawn from the data order since epoch 0
        metrics_f = None
        if self.tcfg.metrics_file:
            parent = os.path.dirname(os.path.abspath(self.tcfg.metrics_file))
            os.makedirs(parent, exist_ok=True)
            metrics_f = open(self.tcfg.metrics_file, "a")

        # Preemption safety: the first SIGTERM / SIGINT requests a
        # checkpoint at the next step boundary, then the loop returns so
        # auto-resume continues.
        preempted = {"flag": False}

        def _on_term(signum, frame):
            print(f"[trainer] signal {signum}: checkpoint at next step "
                  "boundary, then exit")
            preempted["flag"] = True

        prev_handlers = {}
        try:
            for sig in (signal.SIGTERM, signal.SIGINT):
                prev_handlers[sig] = signal.signal(sig, _on_term)
        except ValueError:           # not the main thread
            prev_handlers = {}

        def restore_handlers():
            for sig, h in prev_handlers.items():
                signal.signal(sig, h)
            if metrics_f:
                metrics_f.close()

        for epoch in range(self.tcfg.num_epochs):
            order = self._epoch_order(rng)
            if not order:
                print(f"[trainer] WARNING: epoch {epoch} has no batches "
                      f"(dataset of {len(self.dataset)} < one "
                      f"'{self.tcfg.group_by}' megabatch after drop-last)")
            # skip already-trained batches on resume (HF Trainer's
            # skip_first_batches, train_3d.py:1863-1864): `consumed` counts
            # batches drawn from the seed-replayed epoch order across epochs
            to_run = []
            for batch_idx in order:
                consumed += 1
                if consumed > start_step:
                    to_run.append(batch_idx)
            prefetcher = BatchPrefetcher(self.dataset, self.collator, to_run)
            for arrays in prefetcher:
                if self.tcfg.pos_skipping_range:
                    arrays = dict(arrays)
                    # per-step derived rng (seed, step): a resumed run
                    # applies the offsets an uninterrupted run would
                    ps_rng = np.random.default_rng(
                        (self.tcfg.seed, global_step))
                    arrays["position_ids"] = apply_pos_skipping(
                        arrays["position_ids"],
                        self.tcfg.pos_skipping_range, ps_rng)
                batch = self._to_batch(arrays)
                extras = ground_extras(arrays, self.device)
                t0 = time.time()
                if extras is not None:
                    self.state, metrics = self._ground_step_fn(
                        self.state, batch, extras)
                else:
                    self.state, metrics = self._step_fn(self.state, batch)
                global_step += 1
                if global_step % self.tcfg.logging_steps == 0:
                    vals = {k: float(v) for k, v in metrics.items()}
                    step_time = time.time() - t0
                    print(f"[trainer] step {global_step} "
                          f"{vals} ({step_time:.2f}s)")
                    if metrics_f:
                        metrics_f.write(json.dumps(
                            {"step": global_step, "epoch": epoch,
                             "step_time_s": step_time, **vals}) + "\n")
                        metrics_f.flush()
                if preempted["flag"] or \
                        global_step % self.tcfg.save_steps == 0:
                    path = ckpt.save_checkpoint(self.tcfg.output_dir,
                                                global_step, self.state)
                    print(f"[trainer] saved {path}")
                if preempted["flag"]:
                    prefetcher.close()
                    restore_handlers()
                    print(f"[trainer] preempted at step {global_step}; "
                          "checkpoint saved, exiting for resume")
                    return self.state
        restore_handlers()
        # final export in bf16 (the reference's
        # stage3_gather_16bit_weights_on_model_save, zero3.json:32): the f32
        # master copy is an optimizer detail, not the published model
        export = self.state.params
        if self.tcfg.bf16 and self.tcfg.master_f32:
            export = _cast_tree(export, torch.float32, torch.bfloat16,
                                self.device)
        ckpt.save_params_only(self.tcfg.output_dir, export)
        if self._lora_cfg is not None:
            # the exported tree holds adapters and non-LoRA trainables (the
            # reference's split save, llava_trainer.py:560-578); alpha / r
            # is not recoverable from the adapter shapes, so record it
            with open(os.path.join(self.tcfg.output_dir, LORA_FILE),
                      "w") as f:
                json.dump({"r": self._lora_cfg.r,
                           "alpha": self._lora_cfg.alpha,
                           "bits": self.tcfg.lora_bits}, f)
        return self.state
