"""Where the time of one training mini-step goes, on one CUDA GPU:

    python3 scripts/torch_port/profile_train_step.py [--layers 4]
        [--frames 32] [--max-len 8192] [--device cuda]

The configuration of ``chip_smoke.py`` phase 7: ``ModelConfig()`` with
``--layers`` decoder layers, f32 master weights from a seeded generator,
bf16 compute, remat, ``MultiSteps`` of two, one ScanQA-style record of the
synthetic ``--frames``-frame 480x640 scene at ``--max-len``. Runs two
mini-steps through ``train_step`` (the first a warm-up), then profiles an
accumulating mini-step and an emitting one (the optimizer update) with
``torch.profiler``. Prints, for each, the wall time of its two halves
(``train_step/loss_and_grads`` and ``train_step/optimizer``), the device
time per kernel group (B2 with the logsumexp, B6, matrix
products, softmax, reductions, copies, other elementwise kernels) and the
device busy share (the kernels' merged intervals over the mini-step's wall
time). Writes ``chiprun_out/profile_train_step.json``.
``--device cpu`` with small sizes rehearses the script (device times then
read 0).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
sys.path[:0] = [ROOT, os.path.join(ROOT, "tests")]

GROUPS = (("B2 with lse", ("flash_fwd_kernel",)),
          ("B6", ("flash_bwd_kernel",)),
          ("matrix products", ("gemm", "gemv", "xmma", "cutlass", "nvjet",
                               "cublas", "sm90_")),
          ("softmax", ("softmax", "Softmax")),
          ("reductions", ("reduce",)),
          ("copies and fills", ("Memcpy", "Memset", "copy", "fill")),
          ("other elementwise", ("",)))


def _group(name: str) -> str:
    for group, keys in GROUPS:
        if any(k in name for k in keys):
            return group
    return GROUPS[-1][0]


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--layers", type=int, default=4)
    ap.add_argument("--frames", type=int, default=32)
    ap.add_argument("--max-len", type=int, default=8192)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--tiny", action="store_true",
                    help="ModelConfig.tiny() (a CPU rehearsal)")
    args = ap.parse_args()
    import torch
    from torch.profiler import ProfilerActivity, profile

    from fixtures import FakeTokenizer, make_fake_annotations, make_fake_scene
    from video3d_tpu_torch.config import DataConfig, ModelConfig
    from video3d_tpu_torch.data.dataset import (Collator, CollatorConfig,
                                                SupervisedDataset)
    from video3d_tpu_torch.data.image_processor import SigLipImageProcessor
    from video3d_tpu_torch.params import init_model
    from video3d_tpu_torch.train.optim import (MultiSteps, OptimConfig,
                                               build_optimizer)
    from video3d_tpu_torch.train.train_step import (create_train_state,
                                                    train_step)
    from video3d_tpu_torch.train.trainer import to_batch

    dev = torch.device(args.device)
    cuda = dev.type == "cuda"

    def sync():
        if cuda:
            torch.cuda.synchronize()

    cfg = ModelConfig.tiny() if args.tiny else ModelConfig()
    cfg = dataclasses.replace(cfg, llm=dataclasses.replace(
        cfg.llm, num_hidden_layers=args.layers))
    S = cfg.vision.image_size
    with tempfile.TemporaryDirectory() as root:
        info = make_fake_scene(root, n_frames=args.frames, H=480, W=640)
        ann = make_fake_annotations(root, info["sample_idx"], n=1)
        ds = SupervisedDataset(ann, FakeTokenizer(), DataConfig(
            video_folder=root,
            annotation_dir=os.path.join(root, "embodiedscan"),
            metadata_dir=os.path.join(root, "metadata"),
            frames_upbound=args.frames),
            image_processor=SigLipImageProcessor(size=(S, S)))
        col = Collator(cfg, CollatorConfig(max_len=args.max_len,
                                           frames_upbound=args.frames))
        batch = to_batch(col([ds[0]]), dev)
    params = init_model(cfg, dev, torch.Generator(device=dev).manual_seed(0),
                        torch.float32)
    tx = MultiSteps(build_optimizer(params, OptimConfig(total_steps=4)), 2)
    state = create_train_state(params, tx)

    def step():
        return train_step(state, batch, cfg, tx, remat=True,
                          compute_dtype=torch.bfloat16)

    for _ in range(2):                       # warm-up: one whole update
        state, _ = step()
    sync()
    result = {"tokens": int(batch.seq_len.sum()),
              "layers": f"{cfg.vision.num_hidden_layers}+{args.layers}"}
    if cuda:
        result["device"] = torch.cuda.get_device_name(0)
    for kind in ("accumulating mini-step", "emitting mini-step"):
        activities = [ProfilerActivity.CPU] + (
            [ProfilerActivity.CUDA] if cuda else [])
        with profile(activities=activities) as prof:
            t0 = time.perf_counter()
            state, _ = step()
            sync()
            wall = time.perf_counter() - t0
        ranges, groups, spans = {}, {g: 0.0 for g, _ in GROUPS}, []
        for ev in prof.events():
            if ev.name.startswith("train_step/"):
                # the ranges' host spans; their device-side annotations
                # are not kernels
                if ev.device_type.name == "CPU":
                    ranges[ev.name] = ranges.get(ev.name, 0.0) \
                        + ev.cpu_time_total / 1e3
            elif ev.device_type.name == "CUDA":
                groups[_group(ev.name)] += ev.time_range.elapsed_us() / 1e3
                spans.append((ev.time_range.start, ev.time_range.end))
        n_kernels = len(spans)
        busy, end = 0.0, float("-inf")
        for a, b in sorted(spans):
            if b > end:
                busy += (b - max(a, end)) / 1e3
                end = b
        result[kind] = {
            "wall_ms": wall * 1e3, "ranges_ms": ranges,
            "device_ms_by_group": groups, "kernels": n_kernels,
            "device_busy_share": busy / (wall * 1e3)}
        print(f"{kind}: wall {wall * 1e3:.1f} ms; "
              + ", ".join(f"{k} {v:.1f} ms" for k, v in ranges.items())
              + f"; {n_kernels} kernels, device busy "
              f"{busy / (wall * 1e3):.1%}", flush=True)
        for g, ms in groups.items():
            print(f"  {g}: {ms:.2f} ms", flush=True)
    out = os.path.join(ROOT, "chiprun_out")
    os.makedirs(out, exist_ok=True)
    with open(os.path.join(out, "profile_train_step.json"), "w") as f:
        json.dump(result, f, indent=1)
    print(json.dumps(result))


if __name__ == "__main__":
    main()
