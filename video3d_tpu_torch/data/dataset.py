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
``SupervisedDataset`` (3D scenes, real video files, 2D images) and the
collator's video and image paths as there, with the patch coordinates
pooled (means, min-max pairs or sampled points) by the port's torch
geometry on the CPU. Grounding batches carry the JAX collator's extras
(objects, box labels, ground slots).
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
            # a real video file: the legacy LLaVA-Video modality
            # (train.py:1194). No world coordinates exist: they are zeros,
            # and the model should run with the world PE 'none'.
            from video3d_tpu_torch.data.video_file import (load_video_file,
                                                           time_instruction)

            path = rec["video"]
            if self.cfg.video_folder and not os.path.isabs(path):
                path = os.path.join(self.cfg.video_folder, path)
            frames, vtime, ftime, n = load_video_file(
                path, self.cfg.video_fps, self.cfg.frames_upbound,
                force_sample=True)
            images = self.image_processor.preprocess(list(frames))
            S = images.shape[-1]
            out["images"] = np.asarray(images, np.float32)
            out["world_coords"] = np.zeros((len(images), S, S, 3), np.float32)
            out["objects"] = np.zeros((0, 6), np.float32)
            out["video_size"] = len(images)
            if self.cfg.add_time_instruction:
                first = conversations[0]["value"].replace(
                    DEFAULT_IMAGE_TOKEN, "")
                conversations[0]["value"] = (
                    f"{DEFAULT_IMAGE_TOKEN}\n"
                    f"{time_instruction(vtime, n, ftime)}\n{first}")
        elif "video" in rec:
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

        elif "image" in rec:
            # a 2D image (train_3d.py:1130-1171): tiled by the configured
            # aspect mode
            from PIL import Image

            from video3d_tpu_torch.data.anyres import process_images_2d

            path = rec["image"]
            if self.cfg.image_folder:
                path = os.path.join(self.cfg.image_folder, path)
            img = Image.open(path).convert("RGB")
            tiles = np.asarray(process_images_2d(
                [img], self.image_processor, self.cfg.image_aspect_ratio,
                self.cfg.image_grid_pinpoints)[0], np.float32)
            if tiles.ndim == 3:            # plain / pad single-view modes
                tiles = tiles[None]
            out["image_tiles"] = tiles
            out["image_size"] = img.size

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
            if not all("image_tiles" in s for s in samples):
                raise ValueError("mixed image/video batches are not "
                                 "supported: use group_by=modality_length "
                                 "(llava_trainer.py:122-173)")
            return self._collate_images(samples)
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
        if pooling == CoordPooling.AVG:
            pooled = geometry.average_coordinate_in_patch(flat, patch_size=ps)
        elif pooling == CoordPooling.MINMAX:
            pooled = geometry.minmax_coordinate_in_patch(flat, patch_size=ps)
        else:
            pooled = geometry.sample_n_points(flat, pooling.n_points,
                                              patch_size=ps)
        n_pts = pooling.n_points
        tail = (g, g, n_pts, 3) if n_pts > 1 else (g, g, 3)
        patch_coords = pooled.numpy().reshape(B, V, *tail)
        mrope = mc.world_3d.pos_embed == PosEmbedType.MROPE
        if mc.world_3d.discrete or mrope:
            patch_coords = np.clip(patch_coords, vox.min_xyz_range, vox.max_xyz_range)
            patch_coords = np.round(
                (patch_coords - np.asarray(vox.min_xyz_range, np.float32)) / vox.voxel_size)
            box_inputs = np.clip(box_inputs, vox.min_xyz_range, vox.max_xyz_range)
            box_inputs = np.round(
                (box_inputs - np.asarray(vox.min_xyz_range, np.float32)) / vox.voxel_size)

        if mrope and n_pts != 1:
            raise ValueError("mrope requires a single coord per patch")
        plan = build_splice_plan(
            [s["input_ids"] for s in samples],
            [s["labels"] for s in samples],
            num_frames, tokens_per_frame=T, max_len=self.cfg.max_len,
            grid_side=g, coord_token_id=self.cfg.coord_token_id,
            mrope_coords=list(patch_coords) if mrope else None,
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

    def _collate_images(self, samples: Sequence[Dict[str, Any]]
                        ) -> Dict[str, Any]:
        """A 2D-image batch: per-sample anyres gather plans padded to the
        batch's longest (static shapes), and per-sample splice plans of one
        "frame" of that sample's vision tokens, stacked. Image batches
        carry no grounding extras."""
        from video3d_tpu_torch.models.anyres import build_anyres_gather_plan

        mc = self.model_cfg
        B = len(samples)
        S = mc.vision.image_size
        hw = mc.vision.num_patches_per_side
        merge = mc.mm_patch_merge_type
        plans = []
        for s in samples:
            if s["image_tiles"].shape[0] == 1:
                # single view (plain / pad): the base features, + a newline
                # when the merge unpads (llava_arch.py:631-634)
                g = np.arange(hw * hw, dtype=np.int32)
                m = np.zeros((hw * hw,), bool)
                if "unpad" in merge:
                    g = np.concatenate([g, np.zeros((1,), np.int32)])
                    m = np.concatenate([m, np.ones((1,), bool)])
                plans.append((g, m))
            else:
                plans.append(build_anyres_gather_plan(
                    s["image_size"], mc.image_grid_pinpoints, S, hw,
                    image_aspect_ratio=mc.image_aspect_ratio,
                    patch_merge_type=merge))
        maxT = max(s["image_tiles"].shape[0] for s in samples)
        Tv = max(p[0].shape[0] for p in plans)
        tiles = np.zeros((B, maxT, 3, S, S), np.float32)
        gather = np.zeros((B, Tv), np.int32)
        nl_mask = np.zeros((B, Tv), bool)
        valid = np.zeros((B, Tv), bool)
        rows = []
        for b, (s, (g, m)) in enumerate(zip(samples, plans)):
            tiles[b, :s["image_tiles"].shape[0]] = s["image_tiles"]
            gather[b, :len(g)] = g
            nl_mask[b, :len(m)] = m
            valid[b, :len(g)] = True
            rows.append(build_splice_plan(
                [s["input_ids"]], [s["labels"]], [1],
                tokens_per_frame=len(g), max_len=self.cfg.max_len,
                grid_side=hw, truncate_to=mc.tokenizer_model_max_length))

        def stack(attr):
            return np.concatenate([getattr(r, attr) for r in rows], axis=0)

        return {
            "images": None, "patch_coords": None,
            "image_tiles": tiles, "vision_gather": gather,
            "vision_newline": nl_mask, "vision_valid": valid,
            **{k: stack(k) for k in (
                "text_ids", "kind", "vision_index", "labels",
                "position_ids", "mrope_position_ids", "seq_len",
                "coord_mask")},
        }

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
