"""ScanQA-style generative inference driver of the PyTorch port:
counterpart of the generative half of ``video3d_tpu/eval/drivers.py``.

Per question: eval-style ChatML ids with an empty assistant turn, the
scene's frames and raw depths, per-patch voxel ids through the fused
geometry kernel, the static splice plan, greedy generation, and one jsonl
record, in the same format as the JAX driver. Host code (tokenization,
frame IO, image preprocessing, splice planning) is imported from
``video3d_tpu``; the JAX driver module itself imports ``jax.numpy``, so this
one stands alone.
"""

from __future__ import annotations

import json
import os
import time
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from video3d_tpu.config import ModelConfig
from video3d_tpu.constants import DEFAULT_IMAGE_TOKEN
from video3d_tpu.data.image_processor import SigLipImageProcessor
from video3d_tpu.data.tokenization import preprocess_qwen_eval
from video3d_tpu.data.video_processor import VideoProcessor
from video3d_tpu.models.splice import build_splice_plan
from video3d_tpu_torch.kernels.fused_geometry import fused_patch_voxel_coords
from video3d_tpu_torch.models import llava_video3d as lv3d
from video3d_tpu_torch.models.generate import GenerateResult, generate_greedy

DEFAULT_BUCKETS = (1024, 2048, 4096, 8192, 16384)


def pick_bucket(n: int, buckets: Sequence[int] = DEFAULT_BUCKETS) -> int:
    for b in buckets:
        if n <= b:
            return b
    return buckets[-1]


@dataclass
class EngineConfig:
    """Generation settings of the answer path (greedy, bf16 KV cache)."""

    max_new_tokens: int = 512
    eos_token_id: int = 151645          # <|im_end|>
    max_frames: int = 32
    buckets: Tuple[int, ...] = DEFAULT_BUCKETS
    stop_str: str = "<|im_end|>"


class InferenceEngine:
    """One model on one device answering ScanQA-style records.

    ``params`` come from :func:`video3d_tpu_torch.params.init_model` or
    :func:`~video3d_tpu_torch.params.from_jax_params` and live on
    ``device``. Voxel ids always come from the fused geometry kernel on the
    raw depths (the JAX engine's ``device_geometry=True`` path).
    """

    def __init__(self, params, model_cfg: ModelConfig, tokenizer,
                 video_processor: VideoProcessor,
                 image_processor: Optional[SigLipImageProcessor] = None,
                 engine_cfg: Optional[EngineConfig] = None,
                 device="cpu"):
        self.params = params
        self.cfg = model_cfg
        self.tokenizer = tokenizer
        self.vp = video_processor
        self.ip = image_processor or SigLipImageProcessor(
            size=(model_cfg.vision.image_size,) * 2)
        self.ecfg = engine_cfg or EngineConfig()
        self.device = torch.device(device)
        self.dtype = params["llm"]["embed_tokens"].dtype

    def _video_arrays_device(self, video_id: str):
        """Frames + voxel ids of the V sampled frames. Unlike the JAX engine,
        which zero-pads to ``max_frames`` for a static shape, only the V real
        frames are kept: the splice plan indexes only their tokens, so the
        tower runs on V frames."""
        mc = self.cfg
        S = mc.vision.image_size
        g = -(-mc.vision.num_patches_per_side // mc.spatial_pool_stride)
        raw = self.vp.load_raw(video_id, self.ip, force_sample=True,
                               frames_upbound=self.ecfg.max_frames)
        V = raw["video_size"]
        dev = self.device
        vox = mc.world_3d.voxel
        patch = fused_patch_voxel_coords(
            torch.from_numpy(np.ascontiguousarray(raw["depths"][:V],
                                                  np.int32)).to(dev),
            torch.from_numpy(np.asarray(raw["intrinsic"], np.float32)).to(dev),
            torch.from_numpy(np.asarray(raw["poses"][:V], np.float32)).to(dev),
            crop=S, grid=g, min_xyz=vox.min_xyz_range,
            max_xyz=vox.max_xyz_range, voxel=vox.voxel_size,
            discretize=mc.world_3d.discrete)
        images = torch.from_numpy(
            np.ascontiguousarray(raw["images"][:V], np.float32))[None]
        return V, images.to(dev), patch[None]

    def _video_arrays(self, video_id: str):
        if self.cfg.world_3d.pooling.n_points != 1:
            raise NotImplementedError("only avg coordinate pooling is ported")
        return self._video_arrays_device(video_id)

    def _question_text(self, record) -> str:
        qs = record["conversations"][0]["value"]
        if DEFAULT_IMAGE_TOKEN not in qs:
            qs = f"{DEFAULT_IMAGE_TOKEN}\n{qs}"
        return qs

    def _tokenize_prompt(self, record):
        """Prompt ids with an empty assistant turn (single human turn)."""
        if len(record["conversations"]) > 2:
            raise NotImplementedError("multi-turn records are not ported")
        question = {"from": "human", "value": self._question_text(record)}
        return preprocess_qwen_eval(
            [question, {"from": "gpt", "value": None}], self.tokenizer)

    def _build_batch(self, ids, V: int, images, patch) -> lv3d.Batch:
        mc = self.cfg
        g = -(-mc.vision.num_patches_per_side // mc.spatial_pool_stride)
        T = mc.tokens_per_frame
        L = pick_bucket(len(ids) + V * T + self.ecfg.max_new_tokens,
                        self.ecfg.buckets)
        plan = build_splice_plan([ids], None, [V], tokens_per_frame=T,
                                 max_len=L, grid_side=g,
                                 truncate_to=mc.tokenizer_model_max_length)
        dev = self.device

        def t(a, dtype=torch.long):
            return torch.from_numpy(np.asarray(a)).to(device=dev, dtype=dtype)

        return lv3d.Batch(
            images=images.to(self.dtype), patch_coords=patch,
            text_ids=t(plan.text_ids), kind=t(plan.kind),
            vision_index=t(plan.vision_index),
            position_ids=t(plan.position_ids), seq_len=t(plan.seq_len))

    def _prepare_generation(self, record) -> lv3d.Batch:
        """record -> device batch (the host half of a request)."""
        ids = self._tokenize_prompt(record)
        V, images, patch = self._video_arrays(record["video"])
        return self._build_batch(ids, V, images, patch)

    def _generate(self, batch, vision_features=None) -> GenerateResult:
        return generate_greedy(self.params, self.cfg, batch,
                               max_new_tokens=self.ecfg.max_new_tokens,
                               eos_token_id=self.ecfg.eos_token_id,
                               vision_features=vision_features)

    def _decode_text(self, toks) -> str:
        text = self.tokenizer.decode(toks, skip_special_tokens=True).strip()
        if self.ecfg.stop_str and text.endswith(self.ecfg.stop_str):
            text = text[: -len(self.ecfg.stop_str)].strip()
        return text

    def _answer(self, batch) -> str:
        res = self._generate(batch)
        toks = res.tokens[0, : int(res.lengths[0])].cpu().numpy()
        return self._decode_text(toks)

    def generate_answer(self, record) -> str:
        return self._answer(self._prepare_generation(record))


def _append_jsonl(path: str, record: dict) -> None:
    """Locked append (several driver processes may share one file)."""
    import fcntl

    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "a") as f:
        fcntl.flock(f, fcntl.LOCK_EX)
        try:
            f.write(json.dumps(record) + "\n")
            f.flush()
        finally:
            fcntl.flock(f, fcntl.LOCK_UN)


def run_generative(engine: InferenceEngine, questions: Sequence[dict],
                   answer_file: str) -> List[float]:
    """ScanQA-style loop, one question at a time. A worker thread prepares
    question i+1 (frame IO, geometry, tokenization, splice plan) while the
    device generates question i. Returns seconds per question, prep
    excluded, as the JAX driver times it."""
    if not questions:
        return []
    times = []
    with ThreadPoolExecutor(max_workers=1) as ex:
        fut = ex.submit(engine._prepare_generation, questions[0])
        for i, line in enumerate(questions):
            prepared = fut.result()
            if i + 1 < len(questions):
                fut = ex.submit(engine._prepare_generation, questions[i + 1])
            t0 = time.time()
            text = engine._answer(prepared)
            times.append(time.time() - t0)
            _append_jsonl(answer_file, {
                "dataset": line["metadata"]["dataset"],
                "sample_id": line["id"],
                "prompt": line["conversations"][0]["value"],
                "pred_response": text,
                "gt_response": line["conversations"][1]["value"],
                "question_type": line["metadata"].get("question_type"),
            })
    return times


def run_scanqa(engine, questions, answer_file):
    return run_generative(engine, questions, answer_file)
