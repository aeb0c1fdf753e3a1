"""The port's benchmark line, counterpart of the reference ``bench.py``:

    python -m video3d_tpu_torch.bench [--device cpu] [--tiny] [--iters 10]

Prints ONE JSON line with the reference's keys: ``metric``, ``value`` (the
steady-state frames/s), ``unit``, ``vs_baseline``, ``baseline_fps`` and ``flagship`` {``chain32_int8``,
``prefix32_int8_b8``}; and the card it ran on (``device``: ``nvidia-smi``'s
name and power limit) and ``hbm_read_gbps``, the best L2-flushed read rate
of the HBM stream probes (kernel B9; null on the CPU).

* steady state (the headline): Video-3D-LLM users ask ~50-200 questions per
  scene and the engine caches the scene's tower features, so each question
  pays geometry (kernel B1) -> world PE -> splice -> prefill of 1792 tokens
  (V=8 frames, 4 full-width Qwen2 decoder layers, bf16); cold start adds
  the full 26-layer tower (in ``metric``);
* ``flagship``: the V=32 chain and the B=8 scene-prefix steady state at
  full depth with int8 weights (``bench/flagship.py``);
* ``vs_baseline``: steady-state frames/s over the live best-of-5 frames/s
  of the reference's torch-CPU geometry preprocessing on this host
  (:func:`bench_reference_cpu`, the reference ``bench.py``'s function).

MFU is read against the H100's 989 TFLOP/s bf16 (data sheet). Without
CUDA it exits non-zero unless ``--device cpu`` is passed; ``--tiny`` runs
the CPU test configuration (``flagship.full_cfg(tiny=True)``, 2 frames).
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import sys
import time
from typing import Dict, Optional

import torch

from video3d_tpu_torch.bench import flagship, timing
from video3d_tpu_torch.config import LLMConfig, ModelConfig, VisionConfig
from video3d_tpu_torch.models import llava_video3d as lv3d
from video3d_tpu_torch.params import init_model

V_FRAMES = 8
LLM_LAYERS = 4      # full-width Qwen2 blocks
# 16 prompt + 8 x 210 vision tokens = 1696 in the tightest 128-multiple
PREFILL_LEN = 1792
TINY_FRAMES = 2


def bench_config(tiny: bool = False) -> ModelConfig:
    if tiny:
        return flagship.full_cfg(tiny=True)
    return ModelConfig(vision=VisionConfig(),
                       llm=dataclasses.replace(
                           LLMConfig(), num_hidden_layers=LLM_LAYERS))


@torch.inference_mode()
def warm_scalar(params, cfg: ModelConfig, depths, intr, poses, pooled, raw,
                length: int = PREFILL_LEN) -> torch.Tensor:
    """Steady state: geometry (B1) -> world PE + grid layout over the cached
    tower features -> splice -> prefill; the f32 sum of the hidden state one
    past the vision tokens."""
    vox = flagship.patch_voxels(cfg, depths, intr, poses)
    vt = lv3d.finish_video_tokens(params, cfg, pooled, raw, vox[None])
    hidden = flagship.prefill_hidden(params, cfg, vt.spliceable, length)
    return hidden[:, flagship.PROMPT + vt.spliceable.shape[1]].float().sum()


@torch.inference_mode()
def cold_scalar(params, cfg: ModelConfig, depths, intr, poses, images,
                length: int = PREFILL_LEN) -> torch.Tensor:
    """First question on a scene: the steady state plus the full tower."""
    return flagship.chain_scalar(params, cfg, depths, intr, poses, images,
                                 length)


@torch.inference_mode()
def pooled_features(params, cfg: ModelConfig, images):
    return lv3d.encode_video_pooled(params, cfg, images)


def bench_device(params, cfg: ModelConfig, device, frames: int = V_FRAMES,
                 iters: int = 10, length: int = PREFILL_LEN):
    """(steady-state frames/s, cold frames/s); every timed call's inputs
    shifted by its index, as the reference's loops do."""
    depths, intr, poses, images = flagship.scan_tensors(
        flagship.make_scan(frames), device)
    pooled, raw = pooled_features(params, cfg, images)
    out = []
    warm = timing.wall_ms(flagship.perturbed(
        lambda i: out.append(warm_scalar(
            params, cfg, depths + i, intr, poses, pooled + i * 1e-8,
            raw + i * 1e-8, length))), iters, device)
    cold = timing.wall_ms(flagship.perturbed(
        lambda i: out.append(cold_scalar(
            params, cfg, depths + i, intr, poses, images + i * 1e-7,
            length))), iters, device)
    total = float(sum(out))
    if total != total:
        raise AssertionError("bench: NaN in the pipelines' outputs")
    return frames / warm * 1e3, frames / cold * 1e3


def _timed(fn) -> float:
    t0 = time.perf_counter()
    fn()
    return time.perf_counter() - t0


def bench_reference_cpu(frames: int = V_FRAMES) -> float:
    """Frames/s of the reference's torch-CPU geometry preprocessing
    (video_utils.py:38-68,196-238,286-308 + llava_arch.py:213-272 +
    position_encoding.py:17-49) on this host, best of 5: the reference
    ``bench.py``'s own function."""
    import torch.nn.functional as F

    depths, intr, poses, _ = flagship.make_scan(frames)
    depths_t = torch.tensor(depths)
    intr_t = torch.tensor(intr).unsqueeze(0).repeat(frames, 1, 1)
    poses_t = torch.tensor(poses)
    H, W, crop = flagship.DEPTH_H, flagship.DEPTH_W, flagship.CROP

    def unproject(intrinsics, poses, depths):
        Vn, H, W = depths.shape
        y, x = torch.meshgrid(torch.arange(H), torch.arange(W), indexing="ij")
        x = x.unsqueeze(0).repeat(Vn, 1, 1).view(Vn, H * W)
        y = y.unsqueeze(0).repeat(Vn, 1, 1).view(Vn, H * W)
        fx = intrinsics[:, 0, 0].unsqueeze(-1)
        fy = intrinsics[:, 1, 1].unsqueeze(-1)
        cx = intrinsics[:, 0, 2].unsqueeze(-1)
        cy = intrinsics[:, 1, 2].unsqueeze(-1)
        z = depths.view(Vn, H * W) / 1000
        x = (x - cx) * z / fx
        y = (y - cy) * z / fy
        cam = torch.stack([x, y, z, torch.ones_like(x)], -1)
        world = (poses @ cam.permute(0, 2, 1)).permute(0, 2, 1)
        return (world[..., :3] / world[..., 3:]).view(Vn, H, W, 3)

    def nn_resize(coords, out_hw):
        oh, ow = out_hw
        H, W = coords.shape[0], coords.shape[1]
        ri = (torch.arange(oh) * H // oh).clamp(max=H - 1)
        ci = (torch.arange(ow) * W // ow).clamp(max=W - 1)
        return coords[ri][:, ci]

    def once():
        wc = unproject(intr_t.float(), poses_t.float(), depths_t.float())
        new_w = int(W * (crop / H))
        res = [nn_resize(c, (crop, new_w)) for c in wc]
        left = (new_w - crop) // 2
        res = torch.stack([c[:, left:left + crop] for c in res])
        t = res[:, :-6, :-6, :].permute(0, 3, 1, 2)
        patch = F.avg_pool2d(t, 27, 27).permute(0, 2, 3, 1)
        mn = torch.tensor([-15.0, -15.0, -5.0])
        mx = torch.tensor([15.0, 15.0, 5.0])
        vox = ((torch.clamp(patch, mn, mx) - mn) / 0.1).round()
        x = vox.reshape(1, -1, 3)
        num_feats = 3584 // 3
        dim_t = 10000 ** (2 * (torch.arange(num_feats).float() // 2)
                          / num_feats)
        parts = []
        for a in range(3):
            pos = x[:, :, a][..., None] / dim_t
            parts.append(torch.stack((pos[:, :, 0::2].sin(),
                                      pos[:, :, 1::2].cos()),
                                     dim=3).flatten(2))
        return torch.cat(parts, dim=2)

    once()  # warm
    # best-of-5: the host's load varies from run to run; the fastest
    # baseline is the largest honest denominator
    dt = min(_timed(once) for _ in range(5))
    return frames / dt


def bench_flagship(params, cfg: ModelConfig, device, chain_iters: int = 3,
                   prefix_iters: int = 20,
                   v_frames: int = flagship.V_FRAMES) -> Dict:
    """The reference's ``flagship`` field on a full-depth int8 model."""
    chain = flagship.run_chain(params, cfg, device, iters=chain_iters,
                               v_frames=v_frames)
    prefix = flagship.run_prefix(params, cfg, device, B=8,
                                 iters=prefix_iters, v_frames=v_frames)
    return {"chain32_int8": {k: chain[k] for k in (
                "frames_per_s", "chain_ms", "prefill_len",
                "mfu_pct_bf16peak")},
            "prefix32_int8_b8": {k: prefix[k] for k in (
                "question_ms", "chunk_ms", "prefix_len", "suffix_bucket")}}


def bench_line(warm_fps: float, cold_fps: float, flag: Dict, ref_fps: float,
               device: Dict, hbm_gbps: Optional[float],
               frames: int = V_FRAMES) -> Dict:
    return {
        "metric": (f"frames/s, steady-state question: depth -> voxel (kernel "
                   f"B1) -> world PE -> splice -> prefill-{PREFILL_LEN} with "
                   f"scene-cached SigLIP features (V={frames}, "
                   f"{LLM_LAYERS} full-width Qwen2 blocks, bf16; cold start "
                   f"incl. the full 26-layer tower: {cold_fps} f/s) on "
                   f"{device['name']} at {device['power_limit']}. "
                   "vs_baseline divides by the live best-of-5 torch-CPU "
                   "reference preprocessing frames/s on this host. The "
                   "'flagship' field: V=32, 28-layer int8 Qwen2-7B, the "
                   "chain and the B=8 scene-prefix steady state."),
        "value": warm_fps,
        "unit": "frames/s",
        "vs_baseline": warm_fps / ref_fps,
        "baseline_fps": {"live": ref_fps},
        "flagship": flag,
        "device": device,
        "hbm_read_gbps": hbm_gbps,
    }


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda:0")
    ap.add_argument("--tiny", action="store_true")
    ap.add_argument("--iters", type=int, default=10)
    a = ap.parse_args(argv)
    device = torch.device(a.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("bench: no CUDA device; pass --device cpu to run "
                         "on the CPU")
    if device.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    frames = TINY_FRAMES if a.tiny else V_FRAMES
    v32 = TINY_FRAMES if a.tiny else flagship.V_FRAMES
    cfg = bench_config(a.tiny)
    dtype = flagship.compute_dtype(device)
    params = init_model(cfg, device,
                        torch.Generator(device=device).manual_seed(0), dtype)
    warm_fps, cold_fps = bench_device(params, cfg, device, frames, a.iters)
    del params
    fcfg = flagship.full_cfg(a.tiny)
    fparams = flagship.init_params(fcfg, device, dtype=dtype)
    flag = bench_flagship(fparams, fcfg, device,
                          prefix_iters=max(1, a.iters * 2), v_frames=v32,
                          chain_iters=max(1, a.iters // 3))
    del fparams
    hbm = None
    if device.type == "cuda":
        from video3d_tpu_torch.bench.probes import measured_read_gbps

        with contextlib.redirect_stdout(sys.stderr):   # stdout: one line
            hbm = measured_read_gbps(device)
    print(json.dumps(bench_line(warm_fps, cold_fps, flag,
                                bench_reference_cpu(frames),
                                timing.device_info(device), hbm, frames)))



if __name__ == "__main__":
    main()
