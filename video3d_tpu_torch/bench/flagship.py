"""The 32-frame flagship at full depth (28-layer Qwen2-7B with int8
projections and head, 26-layer SigLIP-so400m tower in bf16), on one card.
Counterpart of the JAX package's ``scripts/bench/flagship32.py`` and of the
configuration and decode helpers of ``scripts/bench/full_depth.py``:

    python -m video3d_tpu_torch.bench.flagship chain|stages|prefix|
        mc-chain|ctx32k [--batch 8] [--pool 64] [--len 32768]

* ``chain``: V=32 geometry (kernel B1) -> tower -> projector -> pool ->
  world PE -> splice -> prefill of 16 + 32 x 210 tokens in the 6784 bucket;
  frames/s and MFU against the H100's 989 TFLOP/s bf16 (data sheet).
* ``stages``: the same chain as three separately timed stages.
* ``prefix``: the scene-prefix steady state: a 64-token suffix bucket over
  an int8 6736-token prefix (``start_decode_prefix``), B rows at once.
* ``mc-chain``: on-device exact max-coverage selection of 32 frames from a
  64-frame pool (``ops/mc_select.py``) inside the chain; the picks are
  checked against a CPU run on the same voxels.
* ``ctx32k``: a 32768-token prefill in chunks of 4096 over an int8 KV
  cache (the folded flash kernel), the model's maximum length.

The weights are random, from a seeded generator on the device:
``params.init_model(cfg, device, gen, torch.bfloat16, bits=8)``. Every
function takes its parameters, so a caller holding the model (``chip_smoke``
phase 11) reuses it. ``V3D_BENCH_TINY=1`` selects the CPU test
configuration of the JAX script (1 tower layer, a 4-layer 256-wide
decoder). ``--w8a8`` (int8 activations, ROADMAP A3) and ``--tower-pad``
(ROADMAP A0b) are not ported and raise; the TPU-only ``mc-profile`` mode and
``--occ-impl mm`` / ``--no-shared-prefix`` A/B switches are left out.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
from typing import Dict, Optional

import numpy as np
import torch

from video3d_tpu_torch.bench import timing
from video3d_tpu_torch.config import LLMConfig, ModelConfig, VisionConfig
from video3d_tpu_torch.constants import IMAGE_TOKEN_INDEX
from video3d_tpu_torch.kernels.fused_geometry import fused_patch_voxel_coords
from video3d_tpu_torch.models import generate
from video3d_tpu_torch.models import llava_video3d as lv3d
from video3d_tpu_torch.models import qwen2
from video3d_tpu_torch.models.splice import (build_splice_plan,
                                             slice_suffix_plan, vision_end)
from video3d_tpu_torch.ops import geometry
from video3d_tpu_torch.ops.mc_select import greedy_select_frames

V_FRAMES = 32
DEPTH_H, DEPTH_W = 480, 640
CROP = 384
PROMPT = 16
SUFFIX = 64            # suffix bucket of the prefix mode


def full_cfg(tiny: Optional[bool] = None) -> ModelConfig:
    """Qwen2-7B + SigLIP-so400m, or (``tiny``; default: the environment's
    ``V3D_BENCH_TINY``) the JAX script's CPU test configuration."""
    if tiny is None:
        tiny = bool(os.environ.get("V3D_BENCH_TINY"))
    if tiny:
        return ModelConfig(
            vision=dataclasses.replace(VisionConfig(), num_hidden_layers=1),
            llm=dataclasses.replace(LLMConfig(), num_hidden_layers=4,
                                    hidden_size=256, intermediate_size=512,
                                    num_attention_heads=4,
                                    num_key_value_heads=2, head_dim=64,
                                    mrope_section=(16, 8, 8),
                                    vocab_size=2048))
    return ModelConfig(vision=VisionConfig(), llm=LLMConfig())


def init_params(cfg: ModelConfig, device, seed: int = 0,
                dtype=torch.bfloat16):
    """int8 LLM projections and head, a ``dtype`` tower, on ``device``."""
    from video3d_tpu_torch.params import init_model

    return init_model(cfg, device,
                      torch.Generator(device=device).manual_seed(seed),
                      dtype, bits=8)


def bucket(n: int, align: int = 128) -> int:
    return -(-n // align) * align


def make_scan(v_frames: int, seed: int = 0):
    """The JAX scripts' synthetic scan: depths (V, 480, 640) int32 in
    [200, 8000) mm, one intrinsic, identity rotations with translations in
    [-2, 2) m, N(0, 1) images (1, V, 3, 384, 384); numpy, from ``seed``."""
    rng = np.random.default_rng(seed)
    depths = rng.integers(200, 8000,
                          size=(v_frames, DEPTH_H, DEPTH_W)).astype(np.int32)
    intr = np.eye(4, dtype=np.float32)
    intr[0, 0] = intr[1, 1] = 577.87
    intr[0, 2], intr[1, 2] = 319.5, 239.5
    poses = np.stack([np.eye(4, dtype=np.float32)] * v_frames)
    poses[:, :3, 3] = rng.uniform(-2, 2, (v_frames, 3)).astype(np.float32)
    images = rng.normal(size=(1, v_frames, 3, CROP, CROP)).astype(np.float32)
    return depths, intr, poses, images


def scan_tensors(scan, device):
    return tuple(torch.from_numpy(a).to(device) for a in scan)


def chain_flops(cfg: ModelConfig, v: int, prefill_len: int) -> float:
    """Matmul FLOPs of the chain (geometry and splice left out: they are
    bandwidth-bound), as the JAX script counts them."""
    vc, lc = cfg.vision, cfg.llm
    n_patch = vc.num_patches_per_side ** 2
    d, i = vc.hidden_size, vc.intermediate_size
    tower = vc.num_hidden_layers * (
        2 * n_patch * (4 * d * d + 2 * d * i) + 2 * 2 * n_patch * n_patch * d)
    tower *= v
    proj = v * 2 * n_patch * (d * lc.hidden_size
                              + lc.hidden_size * lc.hidden_size)
    D, I = lc.hidden_size, lc.intermediate_size
    kvd = lc.num_key_value_heads * lc.head_dim
    per_tok = 2 * (2 * D * D + 2 * D * kvd + 3 * D * I)
    attn = 2 * 2 * prefill_len * prefill_len * D / 2
    llm = lc.num_hidden_layers * (prefill_len * per_tok + attn)
    return tower + proj + llm


def prefill_flops(cfg: ModelConfig, length: int) -> float:
    lc = cfg.llm
    D, I = lc.hidden_size, lc.intermediate_size
    kvd = lc.num_key_value_heads * lc.head_dim
    per_tok = 2 * (2 * D * D + 2 * D * kvd + 3 * D * I)
    return lc.num_hidden_layers * (length * per_tok
                                   + 2 * 2 * length * length * D / 2)


def patch_voxels(cfg: ModelConfig, depths, intr, poses) -> torch.Tensor:
    """(V, g, g, 3) voxel ids of the pooled patches: kernel B1."""
    vox = cfg.world_3d.voxel
    g = -(-cfg.vision.num_patches_per_side // cfg.spatial_pool_stride)
    return fused_patch_voxel_coords(depths, intr, poses, crop=CROP, grid=g,
                                    min_xyz=vox.min_xyz_range,
                                    max_xyz=vox.max_xyz_range,
                                    voxel=vox.voxel_size)


def prefill_hidden(params, cfg: ModelConfig, spliceable: torch.Tensor,
                   length: int) -> torch.Tensor:
    """[16 prompt slots][vision tokens][zeros] in a ``length`` bucket,
    positions 0..length-1, through the decoder (causal, no cache)."""
    D = spliceable.shape[-1]
    embeds = torch.zeros((1, length, D), dtype=spliceable.dtype,
                         device=spliceable.device)
    embeds[:, PROMPT:PROMPT + spliceable.shape[1]] = spliceable
    pos = torch.arange(length, device=spliceable.device)[None, :, None] \
        .expand(1, length, 3)
    return qwen2.qwen2_forward(params["llm"], cfg.llm, embeds, pos)


@torch.inference_mode()
def chain_scalar(params, cfg: ModelConfig, depths, intr, poses, images,
                 length: int) -> torch.Tensor:
    """The whole chain; the f32 sum of the hidden state one past the vision
    tokens."""
    vox = patch_voxels(cfg, depths, intr, poses)
    vt = lv3d.encode_video(params, cfg, images, vox[None])
    hidden = prefill_hidden(params, cfg, vt.spliceable, length)
    return hidden[:, PROMPT + vt.spliceable.shape[1]].float().sum()


def perturbed(fn, *args):
    """A call of ``fn(i, *args)`` per invocation, i = 0, 1, ...: each timed
    call sees inputs shifted by its index, as the JAX loops do."""
    count = [0]

    def call():
        out = fn(count[0], *args)
        count[0] += 1
        return out
    return call


def run_chain(params, cfg: ModelConfig, device, iters: int = 3,
              v_frames: int = V_FRAMES) -> Dict:
    L = bucket(PROMPT + v_frames * cfg.tokens_per_frame)
    depths, intr, poses, images = scan_tensors(make_scan(v_frames), device)
    out = []
    ms = timing.wall_ms(perturbed(
        lambda i: out.append(chain_scalar(params, cfg, depths + i, intr,
                                          poses, images + i * 1e-6, L))),
        iters, device)
    total = float(sum(out))
    if total != total:
        raise AssertionError("chain: NaN")
    fl = chain_flops(cfg, v_frames, L)
    return {"mode": "chain32_int8", "frames_per_s": v_frames / ms * 1e3,
            "chain_ms": ms, "prefill_len": L, "tflop_per_chain": fl / 1e12,
            "mfu_pct_bf16peak": 100 * fl / (ms * 1e-3)
            / timing.H100_BF16_FLOPS}


@torch.inference_mode()
def stage_geometry(cfg, depths, intr, poses):
    return patch_voxels(cfg, depths, intr, poses)


@torch.inference_mode()
def stage_tower(params, cfg, images, vox):
    return lv3d.encode_video(params, cfg, images, vox[None]).spliceable


@torch.inference_mode()
def stage_prefill(params, cfg, spliceable, length):
    return prefill_hidden(params, cfg, spliceable, length)[:, -1] \
        .float().sum()


def run_stages(params, cfg: ModelConfig, device, iters: int = 5,
               v_frames: int = V_FRAMES) -> Dict:
    L = bucket(PROMPT + v_frames * cfg.tokens_per_frame)
    depths, intr, poses, images = scan_tensors(make_scan(v_frames), device)
    vox = stage_geometry(cfg, depths, intr, poses)
    spl = stage_tower(params, cfg, images, vox)
    res = {"mode": "stages32_int8", "prefill_len": L}
    res["geometry_ms"] = timing.wall_ms(perturbed(
        lambda i: stage_geometry(cfg, depths + i, intr, poses)), iters,
        device)
    res["tower_proj_pool_ms"] = timing.wall_ms(perturbed(
        lambda i: stage_tower(params, cfg, images + i * 1e-6, vox)), iters,
        device)
    res["pe_splice_prefill_ms"] = timing.wall_ms(perturbed(
        lambda i: stage_prefill(params, cfg, spl + i * 1e-6, L)), iters,
        device)
    return res


def prefix_inputs(cfg: ModelConfig, B: int, device,
                  v_frames: int = V_FRAMES):
    """(suffix batch of B rows, int8 prefix KVCache with 0.01 scales,
    prefix length P, cache length) of the JAX script's prefix mode."""
    T = cfg.tokens_per_frame
    g = -(-cfg.vision.num_patches_per_side // cfg.spatial_pool_stride)
    L = bucket(PROMPT + v_frames * T)
    ids = [10] * 15 + [IMAGE_TOKEN_INDEX] + [20] * 30
    plan = build_splice_plan([ids], None, [v_frames], tokens_per_frame=T,
                             max_len=L, grid_side=g)
    P = vision_end(plan)
    suf = slice_suffix_plan(plan, P, SUFFIX)

    def tile(a):
        a = np.asarray(a)
        return torch.from_numpy(np.ascontiguousarray(np.broadcast_to(
            a, (B,) + a.shape[1:]))).to(device=device, dtype=torch.long)

    batch = lv3d.Batch(images=None, patch_coords=None,
                       text_ids=tile(suf.text_ids), kind=tile(suf.kind),
                       vision_index=tile(suf.vision_index),
                       position_ids=tile(suf.position_ids),
                       seq_len=tile(suf.seq_len))
    lc = cfg.llm
    shape = (lc.num_hidden_layers, 1, P, lc.num_key_value_heads * lc.head_dim)
    sshape = shape[:3] + (lc.num_key_value_heads, 1)
    prefix = qwen2.KVCache(
        torch.zeros(shape, dtype=torch.int8, device=device),
        torch.zeros(shape, dtype=torch.int8, device=device),
        torch.full(sshape, 0.01, dtype=torch.float32, device=device),
        torch.full(sshape, 0.01, dtype=torch.float32, device=device))
    return batch, prefix, P, L + 512


@torch.inference_mode()
def prefix_scalar(params, cfg: ModelConfig, batch, prefix, P: int,
                  max_cache_len: int, i: int = 0) -> torch.Tensor:
    """Iteration ``i`` of the prefix mode: suffix ids shifted by i and the
    row, scales by i * 1e-8; 1e-6 x the sum of the next-token logits."""
    rows = torch.arange(batch.text_ids.shape[0],
                        device=batch.text_ids.device)[:, None]
    ids = torch.where(batch.kind == 1,
                      (batch.text_ids + i + rows) % 997 + 20, batch.text_ids)
    eps = i * 1e-8
    cache = qwen2.KVCache(prefix.k, prefix.v, prefix.k_scale + eps,
                          prefix.v_scale + eps)
    st = generate.start_decode_prefix(
        params, cfg, batch._replace(text_ids=ids), cache, prefix_len=P,
        max_cache_len=max_cache_len, cache_dtype=torch.int8)
    return st.next_logits.float().sum() * 1e-6


def run_prefix(params, cfg: ModelConfig, device, B: int = 1,
               iters: int = 20, v_frames: int = V_FRAMES) -> Dict:
    batch, prefix, P, mcl = prefix_inputs(cfg, B, device, v_frames)
    ms = timing.wall_ms(perturbed(
        lambda i: prefix_scalar(params, cfg, batch, prefix, P, mcl, i)),
        iters, device)
    return {"mode": f"prefix32_int8_b{B}", "chunk_ms": ms,
            "question_ms": ms / B, "prefix_len": P, "suffix_bucket": SUFFIX,
            "B": B}


def mc_scene(seed: int = 7, n: int = 40000) -> np.ndarray:
    """The synthetic scene point-cloud voxel universe of the JAX script."""
    rng = np.random.default_rng(seed)
    return rng.integers(120, 180, size=(n, 3)).astype(np.int32)


@torch.inference_mode()
def pool_voxels(cfg: ModelConfig, depths, intr, poses) -> torch.Tensor:
    """(pool, H*W, 3) full-resolution voxel ids of the candidate frames."""
    vox = cfg.world_3d.voxel
    wc = geometry.unproject(intr, poses, depths)
    return geometry.discrete_coords(wc, vox.min_xyz_range, vox.max_xyz_range,
                                    vox.voxel_size).reshape(
                                        depths.shape[0], -1, 3)


@torch.inference_mode()
def mc_chain_scalar(params, cfg: ModelConfig, depths, intr, poses, images,
                    scene_vox, length: int, v_frames: int):
    """Select ``v_frames`` of the pool by exact greedy max coverage, then
    the chain over the picked frames in pick order; returns (the chain's
    scalar + 1e-9 x the gains' sum, the picks)."""
    order, gains, _ = greedy_select_frames(
        pool_voxels(cfg, depths, intr, poses), scene_vox,
        max_frames=v_frames)
    idx = order.long()
    vox = patch_voxels(cfg, depths[idx], intr, poses[idx])
    vt = lv3d.encode_video(params, cfg, images[:, idx], vox[None])
    hidden = prefill_hidden(params, cfg, vt.spliceable, length)
    return (hidden[:, PROMPT + vt.spliceable.shape[1]].float().sum()
            + gains.sum().float() * 1e-9), order


def run_mc_chain(params, cfg: ModelConfig, device, pool: int = 64,
                 iters: int = 2, v_frames: int = V_FRAMES) -> Dict:
    L = bucket(PROMPT + v_frames * cfg.tokens_per_frame)
    depths, intr, poses, images = scan_tensors(make_scan(pool), device)
    scene = torch.from_numpy(mc_scene()).to(device)
    picks = []
    ms = timing.wall_ms(perturbed(
        lambda i: picks.append((i, mc_chain_scalar(
            params, cfg, depths + i, intr, poses, images + i * 1e-6, scene,
            L, v_frames)[1]))), iters, device)
    # the picks of each timed call against a CPU run on the same voxels
    for i, order in picks[-iters:]:
        fv = pool_voxels(cfg, depths + i, intr, poses).cpu()
        ref = greedy_select_frames(fv, scene.cpu(), max_frames=v_frames)[0]
        if not torch.equal(order.cpu(), ref):
            raise AssertionError(f"mc-chain: picks on {device} "
                                 f"{order.tolist()} differ from the CPU's "
                                 f"{ref.tolist()}")
    return {"mode": "mcchain32_int8", "frames_per_s": v_frames / ms * 1e3,
            "chain_ms": ms, "pool": pool, "selected": v_frames,
            "prefill_len": L, "picks_equal_cpu": True}


@torch.inference_mode()
def ctx_scalar(llm, cfg: ModelConfig, ids: torch.Tensor, chunk: int,
               cache_dtype=torch.int8) -> torch.Tensor:
    """Chunked prefill of ``ids`` (L,) over a KV cache of L slots (int8 in
    the benchmark): each chunk's K/V are written at its positions and its
    queries attend the cache causally (the folded flash kernel); the f32
    sum of the last chunk's last hidden state."""
    L = ids.shape[0]
    dev = ids.device
    emb = qwen2.embed_tokens(llm, ids)[None]
    cache = qwen2.KVCache.zeros(cfg.llm, 1, L, dtype=cache_dtype, device=dev)
    kv_len = torch.full((1,), L, dtype=torch.long, device=dev)
    out = None
    for start in range(0, L, chunk):
        cpos = (start + torch.arange(chunk, device=dev))[None]
        hidden = qwen2.qwen2_forward(
            llm, cfg.llm, emb[:, start:start + chunk],
            cpos[..., None].expand(1, chunk, 3), kv_cache=cache,
            cache_positions=cpos, kv_len=kv_len, contiguous_update=True)
        out = hidden[:, -1].float().sum()
    return out


def ctx_ids(cfg: ModelConfig, L: int, device) -> torch.Tensor:
    return torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.llm.vocab_size, size=(L,))).to(device)


def run_ctx32k(params, cfg: ModelConfig, device, L: int = 32768,
               iters: int = 1, chunk: int = 4096, warmup: int = 1) -> Dict:
    if L % chunk:
        raise ValueError(f"ctx32k: {L} tokens are not whole chunks of "
                         f"{chunk}")
    ids = ctx_ids(cfg, L, device)
    vocab = cfg.llm.vocab_size
    ms = timing.wall_ms(perturbed(
        lambda i: ctx_scalar(params["llm"], cfg, (ids + i) % vocab, chunk)),
        iters, device, warmup=warmup)
    fl = prefill_flops(cfg, L)
    return {"mode": "ctx32k_int8_chunked", "L": L, "chunk": chunk,
            "prefill_s": ms / 1e3, "tok_per_s": L / ms * 1e3,
            "tflop": fl / 1e12,
            "mfu_pct_bf16peak": 100 * fl / (ms * 1e-3)
            / timing.H100_BF16_FLOPS}


def compute_dtype(device) -> torch.dtype:
    """bf16 on the card; f32 on the CPU, whose bf16 products are slow."""
    return torch.bfloat16 if torch.device(device).type == "cuda" \
        else torch.float32


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("mode", choices=["chain", "stages", "mc-chain", "prefix",
                                     "ctx32k"])
    ap.add_argument("--device", default="cuda:0")
    ap.add_argument("--batch", type=int, default=1)
    ap.add_argument("--pool", type=int, default=64)
    ap.add_argument("--len", type=int, default=32768)
    ap.add_argument("--w8a8", action="store_true")
    ap.add_argument("--tower-pad", type=int, default=0)
    a = ap.parse_args(argv)
    if a.w8a8:
        raise NotImplementedError("w8a8 (int8 activations) is not ported "
                                  "(ROADMAP A3)")
    if a.tower_pad:
        raise NotImplementedError("VisionConfig.tower_pad_seq (the tower's "
                                  "padded attention) is not ported (ROADMAP "
                                  "A0b)")
    device = torch.device(a.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("flagship: no CUDA device (pass --device cpu)")
    cfg = full_cfg()
    params = init_params(cfg, device, dtype=compute_dtype(device))
    if a.mode == "chain":
        res = run_chain(params, cfg, device)
    elif a.mode == "stages":
        res = run_stages(params, cfg, device)
    elif a.mode == "mc-chain":
        res = run_mc_chain(params, cfg, device, pool=a.pool)
    elif a.mode == "prefix":
        res = run_prefix(params, cfg, device, B=a.batch)
    else:
        res = run_ctx32k(params, cfg, device, L=a.len)
    res["device"] = timing.device_info(device)
    print(json.dumps(res))


if __name__ == "__main__":
    main()
