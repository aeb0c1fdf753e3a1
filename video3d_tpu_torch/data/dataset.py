"""Supervised dataset + static-shape collator.

Dataset semantics follow the reference ``LazySupervisedDataset``
(train_3d.py:996-1312): yaml/json multi-dataset mixes with
first/end/random:N sampling strategies, the spatial-instruction prompt
rewrite, Scan2Cap ``box_input``, ScanRefer/Multi3DRefer ``box_label``, and a
retry ladder for faulty samples. The collator replaces the reference's
dynamic padding (train_3d.py:1315-1366) with the static splice plan of
:mod:`video3d_tpu_torch.models.splice`, padding frames to ``frames_upbound`` and
text to a fixed bucket so the jitted step never recompiles.

The port's own copy of ``video3d_tpu/data/dataset.py``: ``load_data_mix``,
``SupervisedDataset`` and the collator's video path as there, with the
patch coordinates pooled by the port's torch ``average_coordinate_in_patch``
on the CPU. Not ported, and raising ``NotImplementedError`` with their
ROADMAP item when their inputs appear: real video files and 2D-image
samples and batches (A11), the min-max and sampled coordinate poolings
(A1), mrope position ids (A2). Grounding batches carry the JAX collator's
extras (objects, box labels, ground slots).
"""

from __future__ import annotations

import json
import math
import os
import random
import re
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from video3d_tpu_torch.config import (CoordPooling, DataConfig, ModelConfig,
                                      PosEmbedType)
from video3d_tpu_torch.constants import DEFAULT_IMAGE_TOKEN
from video3d_tpu_torch.data.tokenization import preprocess_qwen
from video3d_tpu_torch.data.video_processor import VideoProcessor
from video3d_tpu_torch.models.splice import build_splice_plan
from video3d_tpu_torch.ops import geometry

SPATIAL_INSTRUCTION = ("The video captures 3D spatial information of a scene. "
                       "Please focus on the spatial relationships in the video "
                       "and answer the following questions.")

TASK_MAPPING = {"scanqa": 0, "sqa3d": 0, "scan2cap": 1,
                "scanrefer": 2, "multi3drefer": 2}


def load_data_mix(data_path: str) -> List[dict]:
    """json / jsonl / yaml-mix loading with sampling strategies
    (train_3d.py:1011-1084)."""
    import yaml

    records: List[dict] = []

    def load_one(path: str) -> List[dict]:
        if path.endswith(".jsonl"):
            with open(path) as f:
                return [json.loads(line) for line in f if line.strip()]
        with open(path) as f:
            return json.load(f)

    if "{" in data_path and "}" in data_path:
        base, pattern = re.match(r"^(.*)\{(.*)\}\.json$", data_path).groups()
        for name in pattern.split(","):
            records.extend(load_one(f"{base}{name}.json"))
    elif data_path.endswith(".yaml"):
        with open(data_path) as f:
            datasets = yaml.safe_load(f)["datasets"]
        for ds in datasets:
            cur = load_one(ds["json_path"])
            strategy = ds.get("sampling_strategy", "all")
            number = None
            if ":" in strategy:
                strategy, num_s = strategy.split(":")
                number = (math.ceil(int(num_s.rstrip("%")) * len(cur) / 100)
                          if "%" in num_s else int(num_s))
            if strategy == "first" and number is not None:
                cur = cur[:number]
            elif strategy == "end" and number is not None:
                cur = cur[-number:]
            elif strategy == "random" and number is not None:
                random.shuffle(cur)
                cur = cur[:number]
            records.extend(cur)
    else:
        records.extend(load_one(data_path))
    return records


class SupervisedDataset:
    """Lazy per-sample tokenization + 3D video loading."""

    def __init__(self, data_path: str, tokenizer, data_cfg: DataConfig,
                 video_processor: Optional[VideoProcessor] = None,
                 image_processor=None, max_retries: int = 3):
        from video3d_tpu_torch.data.image_processor import \
            SigLipImageProcessor

        self.records = load_data_mix(data_path)
        self.tokenizer = tokenizer
        self.cfg = data_cfg
        self.image_processor = image_processor or SigLipImageProcessor()
        self.video_processor = video_processor or VideoProcessor(data_cfg)
        self.max_retries = max_retries

    def __len__(self) -> int:
        return len(self.records)

    # -------- sampler length properties (train_3d.py:1089-1129) --------

    @property
    def lengths(self) -> List[int]:
        out = []
        for s in self.records:
            img = 128 if "image" in s else 0
            out.append(sum(len(c["value"].split()) for c in s["conversations"]) + img)
        return out

    @property
    def modality_lengths(self) -> List[int]:
        mapping = {"scanrefer": 1, "multi3drefer": 1, "scanqa": 2, "sqa3d": 2,
                   "scan2cap": 3}
        # records outside the 5-task mix (video files, images, plain text)
        # group as generic QA — the reference's samplers only ever see the
        # 3D mix, so any stable default preserves task-purity for it
        return [mapping.get(
            s.get("metadata", {}).get("dataset", "").lower(), 2)
            for s in self.records]

    @property
    def task_lengths(self) -> List[tuple]:
        out = []
        for s in self.records:
            n = sum(len(c["value"].split()) for c in s["conversations"])
            task = TASK_MAPPING.get(
                s.get("metadata", {}).get("dataset", "").lower(), 0)
            out.append((task, n))
        return out

    # -------- item assembly --------

    def _get_item(self, i: int) -> Dict[str, Any]:
        rec = self.records[i]
        conversations = [dict(c) for c in rec["conversations"]]
        dataset_name = rec.get("metadata", {}).get("dataset", "").lower()

        out: Dict[str, Any] = {"id": rec.get("id", i), "dataset": dataset_name}

        if "video" in rec and str(rec["video"]).lower().endswith(
                (".mp4", ".avi", ".mov", ".mkv", ".webm")):
            raise NotImplementedError("real video files (data/video_file.py) "
                                      "are not ported (ROADMAP A11)")
        if "image" in rec and "video" not in rec:
            raise NotImplementedError("2D-image samples (data/anyres.py) are "
                                      "not ported (ROADMAP A11)")
        if "video" in rec:
            video_dict = self.video_processor.process_3d_video(
                rec["video"], self.image_processor,
                force_sample=True, frames_upbound=self.cfg.frames_upbound)
            out["images"] = video_dict["images"]
            out["world_coords"] = video_dict["world_coords"]
            out["objects"] = video_dict["objects"]
            out["video_size"] = video_dict["video_size"]

            if dataset_name == "scan2cap":
                out["box_input"] = np.asarray(rec["box_input"][:3], np.float32)

            if self.cfg.add_spatial_instruction:
                first = conversations[0]["value"].replace(DEFAULT_IMAGE_TOKEN, "")
                conversations[0]["value"] = (
                    f"{DEFAULT_IMAGE_TOKEN}\n{SPATIAL_INSTRUCTION}\n{first}")

        tok = preprocess_qwen([conversations], self.tokenizer,
                              has_image="video" in rec or "image" in rec)
        out["input_ids"] = tok["input_ids"][0]
        out["labels"] = tok["labels"][0]

        if dataset_name in ("scanrefer", "multi3drefer"):
            box_label = rec["metadata"]["object_id"]
            out["box_label"] = [int(b) for b in
                                (box_label if isinstance(box_label, list) else [box_label])]
        return out

    def __getitem__(self, i: int) -> Dict[str, Any]:
        """Retry ladder: same sample then next samples (train_3d.py:1173-1204).
        A record of a kind the port does not run raises at once."""
        for attempt in range(self.max_retries):
            try:
                return self._get_item(i)
            except NotImplementedError:
                raise
            except Exception as e:  # noqa: BLE001
                print(f"[dataset] try {attempt} sample {i} failed: {e}")
        for off in range(1, self.max_retries + 1):
            j = min(i + off, len(self) - 1)
            try:
                return self._get_item(j)
            except NotImplementedError:
                raise
            except Exception as e:  # noqa: BLE001
                print(f"[dataset] fallback sample {j} failed: {e}")
        raise RuntimeError(f"could not load any sample near index {i}")


@dataclass
class CollatorConfig:
    max_len: int = 8192            # static text+vision bucket
    frames_upbound: int = 32
    max_objects: int = 150
    pad_token_id: int = 151643
    coord_token_id: Optional[int] = None
    ground_token_id: Optional[int] = None


class Collator:
    """Samples -> static-shape model Batch (+ grounding extras)."""

    def __init__(self, model_cfg: ModelConfig, col_cfg: CollatorConfig):
        self.model_cfg = model_cfg
        self.cfg = col_cfg

    def __call__(self, samples: Sequence[Dict[str, Any]]) -> Dict[str, np.ndarray]:
        mc = self.model_cfg
        B = len(samples)
        if any("image_tiles" in s for s in samples):
            raise NotImplementedError("2D-image batches (anyres gather plans) "
                                      "are not ported (ROADMAP A11)")
        V = self.cfg.frames_upbound
        S = mc.vision.image_size
        g = -(-mc.vision.num_patches_per_side // mc.spatial_pool_stride)
        T = mc.tokens_per_frame

        images = np.zeros((B, V, 3, S, S), np.float32)
        coords = np.zeros((B, V, S, S, 3), np.float32)
        num_frames = []
        box_inputs = np.zeros((B, 3), np.float32)
        has_box_input = False
        for b, s in enumerate(samples):
            v = int(s["video_size"])
            images[b, :v] = s["images"][:v]
            coords[b, :v] = s["world_coords"][:v]
            num_frames.append(v)
            if s.get("box_input") is not None:
                box_inputs[b] = s["box_input"]
                has_box_input = True

        # Patch coords pooled (torch, on the CPU) + discretized on host
        vox = mc.world_3d.voxel
        flat = torch.from_numpy(coords.reshape(B * V, S, S, 3))
        ps = S // g
        pooling = mc.world_3d.pooling
        if pooling != CoordPooling.AVG:
            raise NotImplementedError(f"{pooling.value} coordinate pooling is "
                                      f"not ported (ROADMAP A1)")
        if mc.world_3d.pos_embed == PosEmbedType.MROPE:
            raise NotImplementedError("mrope world positions are not ported "
                                      "(ROADMAP A2)")
        pooled = geometry.average_coordinate_in_patch(flat, patch_size=ps)
        patch_coords = pooled.numpy().reshape(B, V, g, g, 3)
        if mc.world_3d.discrete:
            patch_coords = np.clip(patch_coords, vox.min_xyz_range, vox.max_xyz_range)
            patch_coords = np.round(
                (patch_coords - np.asarray(vox.min_xyz_range, np.float32)) / vox.voxel_size)
            box_inputs = np.clip(box_inputs, vox.min_xyz_range, vox.max_xyz_range)
            box_inputs = np.round(
                (box_inputs - np.asarray(vox.min_xyz_range, np.float32)) / vox.voxel_size)

        plan = build_splice_plan(
            [s["input_ids"] for s in samples],
            [s["labels"] for s in samples],
            num_frames, tokens_per_frame=T, max_len=self.cfg.max_len,
            grid_side=g, coord_token_id=self.cfg.coord_token_id,
            truncate_to=mc.tokenizer_model_max_length)

        out = {
            "images": images,
            "patch_coords": patch_coords.astype(np.float32),
            "text_ids": plan.text_ids,
            "kind": plan.kind,
            "vision_index": plan.vision_index,
            "labels": plan.labels,
            "position_ids": plan.position_ids,
            "mrope_position_ids": plan.mrope_position_ids,
            "seq_len": plan.seq_len,
            "coord_mask": plan.coord_mask,
            "box_input": box_inputs if has_box_input else np.zeros((B, 3), np.float32),
        }

        return self._collate_grounding(samples, out, coords, plan)

    def _collate_grounding(self, samples, out, coords, plan):
        """Grounding extras (ScanRefer / Multi3DRefer; JAX
        ``_collate_grounding``): the (B, N, 6) padded proposals and their
        mask, the (B, N+1) multi-hot box labels (slot N, the zero target,
        set when no label is below the sample's n objects,
        llava_qwen.py:305-306), the per-pixel world coordinates and, with a
        ``ground_token_id``, each row's first label position equal to it
        (0 when none). An ungrounded batch passes through unchanged."""
        B = len(samples)
        if not any("box_label" in s for s in samples):
            return out
        N = self.cfg.max_objects
        obj = np.zeros((B, N, 6), np.float32)
        obj_valid = np.zeros((B, N), bool)
        box_hot = np.zeros((B, N + 1), np.float32)
        world = np.zeros_like(coords)
        for b, s in enumerate(samples):
            boxes = np.asarray(s.get("objects", []), np.float32).reshape(-1, 6)
            n = min(len(boxes), N)
            obj[b, :n] = boxes[:n]
            obj_valid[b, :n] = True
            labels = [l for l in s.get("box_label", []) if 0 <= l < n]
            if labels:
                box_hot[b, labels] = 1.0
            else:
                box_hot[b, N] = 1.0
            v = int(s["video_size"])
            world[b, :v] = s["world_coords"][:v]
        out.update({"objects": obj, "objects_valid": obj_valid,
                    "box_label_hot": box_hot, "world_coords_full": world})
        if self.cfg.ground_token_id is not None:
            slots = np.zeros((B,), np.int32)
            for b in range(B):
                hits = np.nonzero(plan.labels[b] == self.cfg.ground_token_id)[0]
                slots[b] = hits[0] if len(hits) else 0
            out["ground_slot"] = slots
        return out
