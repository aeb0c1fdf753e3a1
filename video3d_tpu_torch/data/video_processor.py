"""Scene-as-video host pipeline: metadata loading, frame sampling, depth /
pose IO, world-coordinate computation, RGB+coord alignment.

The port's own copy of ``video3d_tpu/data/video_processor.py``: uniform
sampling, the offline max-coverage JSON and, for scenes missing from it,
exact greedy max-coverage selection on the device (``ops/mc_select.py``,
on ``device``: the first CUDA card unless the caller names one) as there;
packed scene bundles are not ported (ROADMAP A11, item 6b) and raise. Depth PNGs are
read with PIL.

Semantics mirror the reference ``VideoProcessor``
(the reference llava/video_utils.py:71-358) with a typed config instead of
substring flags, and two compute paths:

  * ``process_3d_video`` — parity path: everything computed on host (numpy),
    returning the same dict the reference returns (images, world_coords,
    video_size, boundry, objects).
  * ``load_raw`` — device path: returns depths/intrinsics/poses so the
    decode -> unproject -> voxelize -> PE chain runs fused on device
    (the reference's per-sample CPU hot loop, SURVEY.md §3.1).
"""

from __future__ import annotations

import json
import os
import pickle
from typing import Dict, List, Optional, Sequence

import numpy as np
from PIL import Image

from video3d_tpu_torch.config import DataConfig, FrameSampling


def load_matrix_from_txt(path: str, shape=(4, 4)) -> np.ndarray:
    """Whitespace-separated matrix file (video_utils.py:30-35)."""
    with open(path) as f:
        vals = [float(v) for v in f.read().split()]
    return np.asarray(vals).reshape(shape)


def unproject_np(intrinsics: np.ndarray, poses: np.ndarray,
                 depths: np.ndarray) -> np.ndarray:
    """Host (numpy) twin of ops.geometry.unproject (video_utils.py:38-68)."""
    V, H, W = depths.shape
    if intrinsics.ndim == 2:
        intrinsics = np.broadcast_to(intrinsics, (V, 4, 4))
    u = np.arange(W, dtype=np.float32)[None, None, :]
    v = np.arange(H, dtype=np.float32)[None, :, None]
    fx = intrinsics[:, 0, 0][:, None, None].astype(np.float32)
    fy = intrinsics[:, 1, 1][:, None, None].astype(np.float32)
    cx = intrinsics[:, 0, 2][:, None, None].astype(np.float32)
    cy = intrinsics[:, 1, 2][:, None, None].astype(np.float32)
    z = depths.astype(np.float32) / 1000.0
    x = (u - cx) * z / fx
    y = (v - cy) * z / fy
    cam = np.stack([x, y, z, np.ones_like(z)], axis=-1)
    world = np.einsum("vij,vhwj->vhwi", poses.astype(np.float32), cam)
    return world[..., :3] / world[..., 3:4]


def load_depth_png(path: str) -> np.ndarray:
    """A 16-bit grayscale depth PNG -> (H, W) uint16 array, read with PIL
    (the values the JAX package's native decoder gives)."""
    with Image.open(path) as im:
        return np.asarray(im).astype(np.uint16)


def resize_nearest_np(arr: np.ndarray, out_hw) -> np.ndarray:
    """cv2.INTER_NEAREST rule: src = floor(dst * in/out) (host twin)."""
    H, W = arr.shape[-3], arr.shape[-2]
    oh, ow = out_hw
    ri = np.minimum(np.arange(oh) * H // oh, H - 1)
    ci = np.minimum(np.arange(ow) * W // ow, W - 1)
    return arr[..., ri, :, :][..., :, ci, :]


class VideoProcessor:
    """Loads EmbodiedScan per-scene metadata + object boxes + mc-sampling
    artifacts and turns a scene id into model-ready frames.

    File layout (identical to the reference data/ tree):
      {annotation_dir}/embodiedscan_infos_{split}.pkl
      {metadata_dir}/scannet_{split}_{gt|pred}_box.json
      {metadata_dir}/scannet_select_frames.json       (mc sampling)
      {metadata_dir}/pcd_discrete_0.1.pkl             (mc 'norm' clamping)
    """

    def __init__(self, cfg: DataConfig, splits=("train", "val", "test"),
                 device=None):
        self.cfg = cfg
        self.device = device     # of the on-device mc fallback (None: cuda:0)
        self.scene: Dict[str, dict] = {}
        for split in splits:
            path = os.path.join(cfg.annotation_dir, f"embodiedscan_infos_{split}.pkl")
            if not os.path.exists(path):
                continue
            with open(path, "rb") as f:
                for item in pickle.load(f)["data_list"]:
                    if item["sample_idx"].startswith("scannet"):
                        self.scene[item["sample_idx"]] = item

        self.scan2obj: Dict[str, list] = {}
        for split in ("train", "val"):
            box_type = "gt" if split == "train" else cfg.val_box_type
            path = os.path.join(cfg.metadata_dir, f"scannet_{split}_{box_type}_box.json")
            if os.path.exists(path):
                with open(path) as f:
                    self.scan2obj.update(json.load(f))

        self.mc_sampling: Dict[str, dict] = {}
        self.pc_min: Dict[str, np.ndarray] = {}
        self.pc_max: Dict[str, np.ndarray] = {}
        is_mc = cfg.frame_sampling in (FrameSampling.MC, FrameSampling.MC_RATIO90,
                                       FrameSampling.MC_RATIO95)
        self._pc_voxels = None
        if is_mc:
            sf_path = os.path.join(cfg.metadata_dir,
                                   "scannet_select_frames.json")
            if os.path.exists(sf_path):
                with open(sf_path) as f:
                    for dd in json.load(f):
                        self.mc_sampling[dd["video_id"]] = dd
            # scenes absent from the JSON (or the whole file absent) fall
            # back to ON-DEVICE exact greedy selection per scene — see
            # _mc_on_device (+72 ms per scene at the flagship pool,
            # BENCH_NOTES r4; the reference REQUIRES the offline JSON,
            # video_utils.py:104-118)
        if is_mc or cfg.normalize_coords:
            pcd_path = os.path.join(cfg.metadata_dir, "pcd_discrete_0.1.pkl")
            if os.path.exists(pcd_path):
                with open(pcd_path, "rb") as f:
                    pc_data = pickle.load(f)
                if is_mc:
                    self._pc_voxels = pc_data     # mc fallback universe
                for scene_id, pts in pc_data.items():
                    arr = np.asarray(list(pts), dtype=np.float64)
                    self.pc_min[scene_id] = arr.min(axis=0) / 10.0
                    self.pc_max[scene_id] = arr.max(axis=0) / 10.0

    # ---------------- frame sampling ----------------

    def sample_frame_files(self, video_id: str, force_sample: bool = False,
                           frames_upbound: int = 0) -> List[str]:
        """Uniform sampling over the scene's image list (video_utils.py:162-194)."""
        meta = self.scene[video_id]
        frame_files = [os.path.join(self.cfg.video_folder, img["img_path"])
                       for img in meta["images"]]
        n = frames_upbound if force_sample else 10
        idx = np.linspace(0, len(frame_files) - 1, n).astype(int)
        return [frame_files[i] for i in idx]

    def _mc_on_device(self, video_id: str, max_frames: int = 32) -> dict:
        """Exact greedy max-coverage ordering computed on ``self.device``
        for a scene with no offline select-frames entry (ops/mc_select.py).
        Same contract as the offline artifact: candidate pool is every
        2nd frame (all frames when that yields < 32,
        max_coverage_sampling.py:30-33), per-frame voxels are full-res
        round(xyz / 0.1) with no clamp, the cover universe is the scene
        point cloud's voxel set, ties break to the lowest frame index (the
        offline tool's random tie-break is the one documented deviation);
        the pool is padded to a multiple of 16 frames outside every scene
        grid, as the JAX package pads it for its compile cache."""
        import torch

        from video3d_tpu_torch.ops import geometry
        from video3d_tpu_torch.ops.mc_select import greedy_select_frames
        from video3d_tpu_torch.params import resolve_device

        scene_id = video_id.split("/")[-1]
        if self._pc_voxels is None or scene_id not in self._pc_voxels:
            raise KeyError(
                f"{video_id}: no select-frames entry and no scene voxel "
                f"set in pcd_discrete_0.1.pkl — run "
                f"scripts/preprocessing/prepare_data.sh step 4")
        dev = resolve_device(self.device)
        meta = self.scene[video_id]
        frame_files = [os.path.join(self.cfg.video_folder, img["img_path"])
                       for img in meta["images"]][::2]
        if len(frame_files) < 32:
            frame_files = [os.path.join(self.cfg.video_folder,
                                        img["img_path"])
                           for img in meta["images"]]
        V = len(frame_files)
        depths, intr, poses = self.load_frame_geometry(video_id, frame_files)
        wc = geometry.unproject(torch.from_numpy(intr).to(dev),
                                torch.from_numpy(poses).to(dev),
                                torch.from_numpy(depths).to(dev))
        # 0.1 m: the voxel size of the artifact pair (pcd_discrete_0.1.pkl /
        # select_frames; the reference's --voxel_size default)
        fv = torch.round(wc / 0.1).to(torch.int32).reshape(V, -1, 3)
        Vp = -(-V // 16) * 16
        if Vp != V:
            fv = torch.cat([fv, torch.full((Vp - V, fv.shape[1], 3), 2 ** 28,
                                           dtype=torch.int32, device=dev)])
        scene_vox = torch.from_numpy(np.asarray(
            list(self._pc_voxels[scene_id]), dtype=np.int32)).to(dev)
        order, gains, num_all = greedy_select_frames(
            fv, scene_vox, max_frames=min(max_frames, Vp))
        keep = [(int(i), int(g)) for i, g in zip(order.tolist(),
                                                  gains.tolist())
                if 0 <= int(i) < V]
        return {"video_id": video_id,
                "frame_files": [frame_files[i] for i, _ in keep],
                "voxel_nums": [g for _, g in keep],
                "num_all_voxels": int(num_all)}

    def sample_frame_files_mc(self, video_id: str,
                              frames_upbound: int = 32) -> List[str]:
        """Max-coverage prefix until the voxel-coverage ratio is reached,
        then chronological sort (video_utils.py:131-159). Scenes missing
        from the offline JSON are selected ON DEVICE (memoized)."""
        mc = self.mc_sampling.get(video_id)
        if mc is None:
            mc = self._mc_on_device(video_id)
            self.mc_sampling[video_id] = mc
        frame_files = list(mc["frame_files"][:frames_upbound])
        voxel_nums = mc["voxel_nums"][:frames_upbound]

        ratio = {FrameSampling.MC: 1.0, FrameSampling.MC_RATIO90: 0.9,
                 FrameSampling.MC_RATIO95: 0.95}[self.cfg.frame_sampling]
        if ratio != 1.0:
            out, cc = [], 0
            for ff, vn in zip(frame_files, voxel_nums):
                out.append(ff)
                cc += vn
                if cc >= mc["num_all_voxels"] * ratio:
                    break
            frame_files = out
        frame_files.sort(key=lambda f: int(f.split("/")[-1].split(".")[0]))
        return frame_files

    def select_frames(self, video_id: str, force_sample: bool = False,
                      frames_upbound: int = 0) -> List[str]:
        if self.cfg.frame_sampling == FrameSampling.UNIFORM:
            return self.sample_frame_files(video_id, force_sample, frames_upbound)
        return self.sample_frame_files_mc(video_id, frames_upbound)

    # ---------------- geometry IO ----------------

    def load_frame_geometry(self, video_id: str, frame_files: Sequence[str]):
        """Read per-frame depth PNG (mm uint16) + pose txt; compose axis
        alignment (video_utils.py:196-228). Uses packed scene bundles when
        ``cfg.packed_dir`` is set (tools/pack_scenes.py)."""
        if self.cfg.packed_dir is not None:
            raise NotImplementedError(
                "packed scene bundles (tools/pack_scenes.py) are not ported "
                "(ROADMAP A11, item 6b)")
        meta = self.scene[video_id]
        axis_align = np.asarray(meta["axis_align_matrix"], np.float64)
        intrinsic = np.asarray(meta["depth_cam2img"], np.float64)

        depths, poses = [], []
        for fp in frame_files:
            depths.append(load_depth_png(fp.replace(".jpg", ".png")).astype(np.int32))
            poses.append(axis_align @ load_matrix_from_txt(fp.replace("jpg", "txt")))
        return (np.stack(depths), intrinsic.astype(np.float32),
                np.stack(poses).astype(np.float32))

    def calculate_world_coords(self, video_id: str, frame_files: Sequence[str],
                               do_normalize: bool = False) -> np.ndarray:
        depths, intrinsic, poses = self.load_frame_geometry(video_id, frame_files)
        wc = unproject_np(intrinsic, poses, depths)
        if do_normalize:
            scene_id = video_id.split("/")[-1]
            wc = np.maximum(wc, self.pc_min[scene_id].astype(np.float32))
            wc = np.minimum(wc, self.pc_max[scene_id].astype(np.float32))
        return wc

    # ---------------- full parity pipeline ----------------

    def preprocess(self, video_id: str, image_processor,
                   force_sample: bool = False, frames_upbound: int = 0,
                   strategy: Optional[str] = None) -> dict:
        """Frames + aligned coords + boundary + objects (video_utils.py:242-326)."""
        strategy = strategy or self.cfg.crop_strategy
        frame_files = self.select_frames(video_id, force_sample, frames_upbound)
        wc = self.calculate_world_coords(video_id, frame_files,
                                         do_normalize=self.cfg.normalize_coords)
        V, H, W, _ = wc.shape

        flat = wc.reshape(-1, 3)
        boundry = np.array([flat[:, 0].min(), flat[:, 0].max(),
                            flat[:, 1].min(), flat[:, 1].max(),
                            flat[:, 2].min(), flat[:, 2].max()], np.float32)

        images = []
        for fp in frame_files:
            with Image.open(fp) as img:
                images.append(img.convert("RGB"))

        crop = image_processor.crop_size["width"]
        if strategy == "resize":
            images = [im.resize((crop, crop)) for im in images]
            coords = resize_nearest_np(wc, (crop, crop))
        elif strategy == "center_crop":
            new_h = crop
            new_w = int(W * (crop / H))
            images = [im.resize((new_w, new_h)) for im in images]
            coords = resize_nearest_np(wc, (new_h, new_w))
            left = (new_w - crop) // 2
            top = (new_h - crop) // 2
            images = [im.crop((left, top, left + crop, top + crop)) for im in images]
            coords = coords[:, top:top + crop, left:left + crop, :]
        else:
            raise ValueError(strategy)

        objects = np.asarray(self.scan2obj.get(video_id, []), np.float32)
        return {
            "images": images,
            "world_coords": coords,
            "video_size": len(images),
            "boundry": boundry,
            "objects": objects,
        }

    def process_3d_video(self, video_id: str, image_processor,
                         force_sample: bool = False, frames_upbound: int = 0,
                         strategy: Optional[str] = None) -> dict:
        out = self.preprocess(video_id, image_processor, force_sample,
                              frames_upbound, strategy)
        out["images"] = image_processor.preprocess(out["images"])
        return out

    # ---------------- device-geometry path ----------------

    def load_raw(self, video_id: str, image_processor,
                 force_sample: bool = False, frames_upbound: int = 0) -> dict:
        """Raw depths/poses/intrinsics + preprocessed RGB; geometry then runs
        fused on device (kernels.fused_geometry)."""
        frame_files = self.select_frames(video_id, force_sample, frames_upbound)
        depths, intrinsic, poses = self.load_frame_geometry(video_id, frame_files)
        images = []
        for fp in frame_files:
            with Image.open(fp) as img:
                images.append(img.convert("RGB"))
        # RGB still resized on host (PIL bicubic parity); coords on device.
        crop = image_processor.crop_size["width"]
        H, W = depths.shape[1:]
        new_w = int(W * (crop / H))
        left = (new_w - crop) // 2
        images = [im.resize((new_w, crop)).crop((left, 0, left + crop, crop))
                  for im in images]
        return {
            "images": image_processor.preprocess(images),
            "depths": depths,
            "intrinsic": intrinsic,
            "poses": poses,
            "objects": np.asarray(self.scan2obj.get(video_id, []), np.float32),
            "video_size": len(frame_files),
        }


def merge_video_dict(video_dict_list: Sequence[dict]) -> dict:
    """Stack per-sample video dicts (video_utils.py:361-373)."""
    out: dict = {"box_input": []}
    for k in video_dict_list[0]:
        if k in ("world_coords", "images", "objects"):
            out[k] = np.stack([vd[k] for vd in video_dict_list])
        elif k == "box_input":
            for vd in video_dict_list:
                if vd[k] is not None:
                    out["box_input"].append(vd[k])
    out["box_input"] = np.asarray(out["box_input"], np.float32)
    return out
