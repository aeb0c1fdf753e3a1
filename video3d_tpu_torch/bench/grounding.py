"""The grounding path (ScanRefer, Multi3DRefer) at full depth on one card:
counterpart of the JAX package's ``scripts/bench/grounding.py``.

    python -m video3d_tpu_torch.bench.grounding cold|prefix [--frames 8]
        [--batch B] [--iters N] [--device cuda:0]

* ``cold``: ms per question of the full grounding forward: tower, full
  prefill, object patch masks, object features and the ground head, at
  B=1 (``grounding_forward``); ``--batch B`` scores B same-scene queries
  with one prefill (``grounding_forward_batch``).
* ``prefix``: ms per question with the scene-prefix KV and object-feature
  cache: a 64-token suffix holding the ``<ground>`` token over an int8
  prefix (``generate.ground_suffix``), B rows at once.

28-layer Qwen2-7B with int8 projections and head, the bf16 SigLIP tower and
an INFONCE ground head (``flagship.init_params``), 128 proposals, random
inputs from a seed. Each timed call sees its inputs shifted by its index;
the figure is the median of CUDA-event times (``timing.median_ms``), not
the JAX script's ``fori_loop``. ``V3D_BENCH_TINY=1`` selects the small CPU
test configuration, as in ``bench/flagship.py``.
"""

from __future__ import annotations

import argparse
import json
from typing import Dict

import numpy as np
import torch

from video3d_tpu_torch.bench import flagship, timing
from video3d_tpu_torch.constants import IMAGE_TOKEN_INDEX
from video3d_tpu_torch.models import generate
from video3d_tpu_torch.models import llava_video3d as lv3d
from video3d_tpu_torch.models import qwen2
from video3d_tpu_torch.models.splice import (build_splice_plan,
                                             slice_suffix_plan, vision_end)

PROMPT_IDS = 15
N_OBJECTS = 128          # ScanRefer's proposal count scale (max_objects)


def _long(a, device, B: int = 1) -> torch.Tensor:
    a = np.asarray(a)
    return torch.from_numpy(np.array(np.broadcast_to(
        a, (B,) + a.shape[1:]))).to(device=device, dtype=torch.long)


def plan_batch(cfg, V: int, B: int, device):
    """(batch of B identical rows, plan): ``PROMPT_IDS`` ids, the video,
    30 ids, the last real token the ``<ground>`` query slot (the ScanRefer
    prompt's shape)."""
    T = cfg.tokens_per_frame
    g = -(-cfg.vision.num_patches_per_side // cfg.spatial_pool_stride)
    ids = [10] * PROMPT_IDS + [IMAGE_TOKEN_INDEX] + [20] * 30
    L = flagship.bucket(len(ids) + V * T)
    plan = build_splice_plan([ids], None, [V], tokens_per_frame=T, max_len=L,
                             grid_side=g)
    batch = lv3d.Batch(images=None, patch_coords=None,
                       text_ids=_long(plan.text_ids, device, B),
                       kind=_long(plan.kind, device, B),
                       vision_index=_long(plan.vision_index, device, B),
                       position_ids=_long(plan.position_ids, device, B),
                       seq_len=_long(plan.seq_len, device, B))
    return batch, plan


def scene_arrays(cfg, V: int, B: int, device, seed: int = 0):
    """The JAX script's synthetic scene, B copies: N(0, 1) images, pixel
    coordinates in [-5, 5) m, voxel ids in [0, 300), ``N_OBJECTS`` boxes
    (centers in [-4, 4) m, sizes in [0.3, 2) m), all valid."""
    rng = np.random.default_rng(seed)
    S = cfg.vision.image_size
    g = -(-cfg.vision.num_patches_per_side // cfg.spatial_pool_stride)
    boxes = np.zeros((B, N_OBJECTS, 6), np.float32)
    boxes[..., :3] = rng.uniform(-4, 4, (B, N_OBJECTS, 3))
    boxes[..., 3:] = rng.uniform(0.3, 2.0, (B, N_OBJECTS, 3))
    arrays = (rng.normal(size=(B, V, 3, S, S)).astype(np.float32),
              rng.uniform(-5, 5, size=(B, V, S, S, 3)).astype(np.float32),
              rng.uniform(0, 300, size=(B, V, g, g, 3)).astype(np.float32),
              boxes, np.ones((B, N_OBJECTS), bool))
    return tuple(torch.from_numpy(a).to(device) for a in arrays)


def _median_ms(call, iters: int, device) -> float:
    """CUDA-event median on the card, the host clock on the CPU."""
    if device.type == "cuda":
        return timing.median_ms(call, iters, device=device)
    return timing.wall_ms(call, iters, device)


def _shift_ids(batch, i: int, rows: bool = False) -> torch.Tensor:
    r = torch.arange(batch.text_ids.shape[0],
                     device=batch.text_ids.device)[:, None] if rows else 0
    return torch.where(batch.kind == 1, (batch.text_ids + i + r) % 997 + 20,
                       batch.text_ids)


@torch.inference_mode()
def cold_scalar(params, cfg, batch, images, wc, patch, boxes, valid,
                slot: int, i: int = 0) -> torch.Tensor:
    """Iteration ``i`` of the cold mode: text ids and images shifted by i;
    1e-6 x the sum of the scores."""
    b = batch._replace(text_ids=_shift_ids(batch, i),
                       images=images + i * 1e-6, patch_coords=patch)
    B = images.shape[0]
    if B == 1:
        s = lv3d.grounding_forward(params, cfg, b, wc[0], boxes[0], valid[0],
                                   slot)
    else:
        s = lv3d.grounding_forward_batch(params, cfg, b, wc, boxes, valid,
                                         [slot] * B)
    return s.float().sum() * 1e-6


def run_cold(params, cfg, device, V: int = 8, B: int = 1,
             iters: int = 5) -> Dict:
    batch, plan = plan_batch(cfg, V, B, device)
    images, wc, patch, boxes, valid = scene_arrays(cfg, V, B, device)
    images = images.to(params["llm"]["norm"].dtype)
    slot = int(plan.seq_len[0]) - 1
    out = []
    ms = _median_ms(flagship.perturbed(
        lambda i: out.append(cold_scalar(params, cfg, batch, images, wc,
                                         patch, boxes, valid, slot, i))),
        iters, device)
    if not all(bool(torch.isfinite(x)) for x in out):
        raise AssertionError("ground cold: non-finite scores")
    return {"mode": f"ground_cold_28L_int8_v{V}_b{B}",
            "question_ms": ms / B, "chunk_ms": ms,
            "prefill_len": int(batch.text_ids.shape[1]),
            "objects": N_OBJECTS}


def prefix_inputs(cfg, V: int, B: int, device, seed: int = 0):
    """(suffix batch of B rows, int8 prefix with 0.01 scales, P, the
    ``<ground>`` slot, N(0, 1) object features, valid) of the prefix mode."""
    batch, plan = plan_batch(cfg, V, 1, device)
    P = vision_end(plan)
    suf = slice_suffix_plan(plan, P, flagship.SUFFIX)
    slot = int(plan.seq_len[0]) - 1
    sbatch = lv3d.Batch(images=None, patch_coords=None,
                        text_ids=_long(suf.text_ids, device, B),
                        kind=_long(suf.kind, device, B),
                        vision_index=_long(suf.vision_index, device, B),
                        position_ids=_long(suf.position_ids, device, B),
                        seq_len=_long(suf.seq_len, device, B))
    lc = cfg.llm
    shape = (lc.num_hidden_layers, 1, P, lc.num_key_value_heads * lc.head_dim)
    sshape = shape[:3] + (lc.num_key_value_heads, 1)
    prefix = qwen2.KVCache(
        torch.zeros(shape, dtype=torch.int8, device=device),
        torch.zeros(shape, dtype=torch.int8, device=device),
        torch.full(sshape, 0.01, dtype=torch.float32, device=device),
        torch.full(sshape, 0.01, dtype=torch.float32, device=device))
    rng = np.random.default_rng(seed)
    feats = torch.from_numpy(rng.normal(size=(N_OBJECTS, lc.hidden_size))
                             .astype(np.float32)).to(device)
    valid = torch.ones(N_OBJECTS, dtype=torch.bool, device=device)
    return sbatch, prefix, P, slot, feats, valid


@torch.inference_mode()
def prefix_scalar(params, cfg, sbatch, prefix, P: int, slot: int, feats,
                  valid, i: int = 0) -> torch.Tensor:
    """Iteration ``i`` of the prefix mode: suffix ids shifted by i and the
    row, scales and features by i * 1e-8; 1e-6 x the sum of the scores."""
    eps = i * 1e-8
    cache = qwen2.KVCache(prefix.k, prefix.v, prefix.k_scale + eps,
                          prefix.v_scale + eps)
    s = generate.ground_suffix(
        params, cfg, sbatch._replace(text_ids=_shift_ids(sbatch, i, True)),
        cache, P, P + flagship.SUFFIX, torch.int8,
        (feats + eps).to(params["llm"]["norm"].dtype), valid, slot)
    return s.float().sum() * 1e-6


def run_prefix(params, cfg, device, V: int = 8, B: int = 1,
               iters: int = 20) -> Dict:
    sbatch, prefix, P, slot, feats, valid = prefix_inputs(cfg, V, B, device)
    out = []
    ms = _median_ms(flagship.perturbed(lambda i: out.append(prefix_scalar(
        params, cfg, sbatch, prefix, P, slot, feats, valid, i))), iters,
        device)
    if not all(bool(torch.isfinite(x)) for x in out):
        raise AssertionError("ground prefix: non-finite scores")
    return {"mode": f"ground_prefix_28L_int8_v{V}_b{B}",
            "question_ms": ms / B, "chunk_ms": ms, "prefix_len": P,
            "suffix_bucket": flagship.SUFFIX, "objects": N_OBJECTS, "B": B}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("mode", choices=["cold", "prefix"])
    ap.add_argument("--frames", type=int, default=8)
    ap.add_argument("--batch", type=int, default=1)
    ap.add_argument("--iters", type=int, default=None)
    ap.add_argument("--device", default="cuda:0")
    a = ap.parse_args(argv)
    device = torch.device(a.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("grounding: no CUDA device (pass --device cpu)")
    cfg = flagship.full_cfg()
    params = flagship.init_params(cfg, device,
                                  dtype=flagship.compute_dtype(device))
    kw = {} if a.iters is None else {"iters": a.iters}
    run = run_cold if a.mode == "cold" else run_prefix
    res = run(params, cfg, device, V=a.frames, B=a.batch, **kw)
    res["device"] = timing.device_info(device)
    print(json.dumps(res))


if __name__ == "__main__":
    main()
