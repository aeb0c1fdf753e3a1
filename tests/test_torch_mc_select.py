"""The port's on-device max-coverage selection (``video3d_tpu_torch/ops/
mc_select.py``) against ``video3d_tpu.ops.mc_select`` on the CPU: exact
``order`` / ``gains`` / ``num_all`` on random scenes, on voxel pairs that
collided under the retired spatial hash, with padded ``scene_valid``, with
the ratio early exit and with ties; ``select_prefix_by_ratio``; and the
``VideoProcessor`` fallback for a scene missing from
``scannet_select_frames.json`` (mirroring ``tests/test_data_pipeline.py``),
against the JAX processor, including the ``KeyError`` without a pcd entry.
"""

import os
import pickle
import shutil

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from video3d_tpu.config import DataConfig as JDataConfig
from video3d_tpu.config import FrameSampling as JFrameSampling
from video3d_tpu.data.video_processor import VideoProcessor as JVideoProcessor
from video3d_tpu.ops import mc_select as jmc
from video3d_tpu_torch.data.video_processor import VideoProcessor
from video3d_tpu_torch.ops import mc_select as tmc

from fixtures import make_fake_scene
from port_configs import port_config

torch.set_num_threads(1)


def _both(frame_vox, scene_vox, max_frames, valid=None, ratio=1.0):
    j = jmc.greedy_select_frames(
        jnp.asarray(frame_vox), jnp.asarray(scene_vox), max_frames=max_frames,
        scene_valid=None if valid is None else jnp.asarray(valid),
        ratio=ratio)
    t = tmc.greedy_select_frames(
        torch.from_numpy(frame_vox), torch.from_numpy(scene_vox),
        max_frames=max_frames,
        scene_valid=None if valid is None else torch.from_numpy(valid),
        ratio=ratio)
    for a, b in zip(j, t):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())
    assert t[0].dtype == t[1].dtype == t[2].dtype == torch.int32
    return t


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("max_frames", [4, 12])
def test_random_scenes_match_jax(seed, max_frames):
    rng = np.random.default_rng(seed)
    V, N, M = 10, 300, 400
    scene = rng.integers(0, 12, size=(M, 3)).astype(np.int32)
    # frames see a window of the scene plus voxels outside it (and floats)
    frames = (rng.integers(-2, 14, size=(V, N, 3))
              + rng.uniform(0, 0.9, size=(V, N, 3))).astype(np.float32)
    order, gains, num_all = _both(frames, scene, max_frames)
    assert int(num_all) > 0 and int(gains[0]) > 0


def test_hash_colliding_voxels_stay_distinct():
    """Voxel pairs that collided under the old 2^20 spatial hash
    (tests/test_lora_dpo_mc.py:168) are two members."""
    mask = (1 << 20) - 1
    seen, pair = {}, None
    for x in range(2048):
        for y in range(8):
            h = ((x * 73856093) ^ (y * 19349663)) & mask
            if h in seen and seen[h] != (x, y):
                pair = (seen[h], (x, y))
                break
            seen[h] = (x, y)
        if pair:
            break
    (x1, y1), (x2, y2) = pair
    va, vb = np.array([x1, y1, 0]), np.array([x2, y2, 0])
    scene = np.stack([va, vb]).astype(np.int32)
    frames = np.stack([np.broadcast_to(va, (4, 3)),
                       np.broadcast_to(vb, (4, 3))]).astype(np.int32)
    order, gains, num_all = _both(frames, scene, 2)
    assert int(num_all) == 2
    assert gains.tolist() == [1, 1]


def test_padded_scene_valid():
    scene = np.array([[1, 1, 1], [2, 2, 2], [9, 9, 9], [9, 9, 9]], np.int32)
    valid = np.array([True, True, False, False])
    frames = np.array([[[1, 1, 1], [9, 9, 9]],
                       [[2, 2, 2], [2, 2, 2]]], np.int32)
    order, gains, num_all = _both(frames, scene, 2, valid=valid)
    assert int(num_all) == 2 and gains.tolist() == [1, 1]


@pytest.mark.parametrize("ratio", [0.9, 0.95])
def test_ratio_early_exit(ratio):
    rng = np.random.default_rng(5)
    scene = rng.integers(0, 10, size=(500, 3)).astype(np.int32)
    frames = rng.integers(0, 10, size=(12, 300, 3)).astype(np.int32)
    order, gains, _ = _both(frames, scene, 12, ratio=ratio)
    assert int((order < 0).sum()) > 0           # stopped before 12 picks
    assert int(gains[order < 0].abs().sum()) == 0


def test_ties_go_to_the_lowest_frame():
    scene = np.array([[0, 0, 0], [1, 0, 0], [2, 0, 0]], np.int32)
    frames = np.array([[[1, 0, 0]] * 2, [[0, 0, 0]] * 2, [[1, 0, 0]] * 2,
                       [[0, 0, 0], [2, 0, 0]]], np.int32)
    order, gains, _ = _both(frames, scene, 4)
    assert order.tolist() == [3, 0, 1, 2]
    assert gains.tolist() == [2, 1, 0, 0]


def test_select_prefix_by_ratio_matches_jax():
    order = np.array([3, 0, 2, 1], np.int32)
    gains = np.array([50, 30, 15, 5], np.int32)
    for ratio in (0.5, 0.9, 1.0):
        assert tmc.select_prefix_by_ratio(order, gains, 100, ratio) \
            == jmc.select_prefix_by_ratio(order, gains, 100, ratio)
    assert tmc.select_prefix_by_ratio(torch.from_numpy(order),
                                      torch.from_numpy(gains),
                                      torch.tensor(100), 0.9) == [0, 2, 3]


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("data"))
    info = make_fake_scene(root, n_frames=6)
    info["root"] = root
    return info


def _cfgs(root):
    jcfg = JDataConfig(video_folder=root,
                       annotation_dir=os.path.join(root, "embodiedscan"),
                       metadata_dir=os.path.join(root, "metadata"),
                       frames_upbound=4,
                       frame_sampling=JFrameSampling.MC_RATIO95)
    return jcfg, port_config(jcfg)


def test_video_processor_fallback_matches_jax(scene, tmp_path):
    """The data tree without the select-frames artifact, with a pcd voxel
    set of a third of the frames' voxel union (as test_data_pipeline.py's
    fallback test builds it): the port selects the same frames with the
    same gains and total as the JAX processor."""
    from video3d_tpu.tools.max_coverage import frame_voxel_sets

    root = str(tmp_path / "nosel")
    shutil.copytree(scene["root"], root)
    os.remove(os.path.join(root, "metadata", "scannet_select_frames.json"))
    jcfg, tcfg = _cfgs(root)
    vp = JVideoProcessor(jcfg)
    sid = scene["sample_idx"]
    files = [os.path.join(root, m["img_path"])
             for m in vp.scene[sid]["images"]]
    union = sorted(set().union(*frame_voxel_sets(vp, sid, files).values()))
    pcd_path = os.path.join(root, "metadata", "pcd_discrete_0.1.pkl")
    with open(pcd_path, "rb") as f:
        pcd = pickle.load(f)
    pcd[sid.split("/")[-1]] = union[::3]
    with open(pcd_path, "wb") as f:
        pickle.dump(pcd, f)

    jvp = JVideoProcessor(jcfg)
    tvp = VideoProcessor(tcfg, device="cpu")
    assert tvp.select_frames(sid, True, 4) == jvp.select_frames(sid, True, 4)
    jm, tm = jvp.mc_sampling[sid], tvp.mc_sampling[sid]
    for key in ("frame_files", "voxel_nums", "num_all_voxels"):
        assert tm[key] == jm[key], key
    assert len(tm["frame_files"]) == 6 and tm["num_all_voxels"] > 0


def test_video_processor_fallback_without_pcd_raises(scene, tmp_path):
    root = str(tmp_path / "nopcd")
    shutil.copytree(scene["root"], root)
    os.remove(os.path.join(root, "metadata", "scannet_select_frames.json"))
    with open(os.path.join(root, "metadata", "pcd_discrete_0.1.pkl"),
              "wb") as f:
        pickle.dump({}, f)
    _, tcfg = _cfgs(root)
    with pytest.raises(KeyError, match="prepare_data"):
        VideoProcessor(tcfg, device="cpu").select_frames(
            scene["sample_idx"], True, 4)


def test_video_processor_fallback_defaults_to_the_card(scene, tmp_path,
                                                        monkeypatch):
    """Without ``device`` the fallback resolves the first CUDA card and
    raises where there is none (no silent CPU fallback)."""
    root = str(tmp_path / "nosel")
    shutil.copytree(scene["root"], root)
    os.remove(os.path.join(root, "metadata", "scannet_select_frames.json"))
    _, tcfg = _cfgs(root)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        VideoProcessor(tcfg).select_frames(scene["sample_idx"], True, 4)
