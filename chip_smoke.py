"""Smoke run of the PyTorch + CUDA port (``video3d_tpu_torch``) on one
NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which raises on failure (the process then exits non-zero):

1. Preconditions: a CUDA device, its name and power limit (nvidia-smi), TF32
   off for float32 products and convolutions.
2. Build: compiles ``video3d_tpu_torch/csrc/*.cu`` with nvcc (printed
   seconds, ptxas report in ``chiprun_out/ptxas.txt``).
3. Kernels against their plain PyTorch versions at the main path's shapes:
   fused geometry (B1), flash prefill attention (B2), split-K decode
   attention (B3); max error and median times (CUDA events).
4. Main path: the ScanQA answer path at full width (``ModelConfig()``:
   26-layer SigLIP-so400m, 28-layer Qwen2-7B, bf16, random weights from a
   seeded generator) answers two questions on a synthetic 32-frame 480x640
   scene through ``run_scanqa``; kernel launch counts must match the path.

Prints a ``{"kernels": [...]}`` line and, last, the result line
``{"ok": true, "device": {...}}``. Without a CUDA device it exits non-zero
and prints no result.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
OUT_DIR = os.path.join(ROOT, "chiprun_out")

KERNEL_INFO = {
    "fused_geometry": ("video3d_tpu_torch/csrc/fused_geometry.cu",
                       "video3d_tpu/kernels/fused_geometry.py:41"),
    "flash_attention": ("video3d_tpu_torch/csrc/flash_attention.cu",
                        "video3d_tpu/kernels/flash_attention.py:64"),
    "decode_attention": ("video3d_tpu_torch/csrc/decode_attention.cu",
                         "video3d_tpu/kernels/decode_attention.py:68"),
}


def preconditions():
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    sys.path.insert(0, ROOT)


def build():
    from video3d_tpu_torch.kernels import _build

    path = _build.build()
    os.makedirs(OUT_DIR, exist_ok=True)
    with open(os.path.join(OUT_DIR, "ptxas.txt"), "w") as f:
        f.write(_build.build_log)
    _build.library()
    print(f"build: {_build.build_seconds:.1f} s -> {os.path.relpath(path, ROOT)}",
          flush=True)


def _median_ms(fn, iters: int) -> float:
    import torch

    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    times.sort()
    return times[len(times) // 2]


def _check(name: str, ok: bool, detail: str) -> None:
    print(f"  {name}: {detail}", flush=True)
    if not ok:
        raise AssertionError(f"{name} failed: {detail}")


def _random_poses(g, V: int):
    """(V, 4, 4) rigid poses: random rotations, translations in [-2, 2] m."""
    import torch

    a = torch.randn(V, 3, 3, generator=g, dtype=torch.float64)
    rot, _ = torch.linalg.qr(a)
    poses = torch.zeros(V, 4, 4, dtype=torch.float64)
    poses[:, :3, :3] = rot
    poses[:, :3, 3] = torch.rand(V, 3, generator=g, dtype=torch.float64) * 4 - 2
    poses[:, 3, 3] = 1.0
    return poses.to(torch.float32)


def check_geometry(dev):
    import torch

    from video3d_tpu_torch.kernels import fused_geometry as fg

    g = torch.Generator().manual_seed(1)
    V, H, W = 32, 480, 640
    depths = torch.randint(500, 5000, (V, H, W), generator=g,
                           dtype=torch.int32).to(dev)
    intr = torch.eye(4)
    intr[0, 0], intr[1, 1], intr[0, 2], intr[1, 2] = 577.87, 577.87, 319.5, 239.5
    intr = intr.to(dev)
    poses = _random_poses(g, V).to(dev)
    args = dict(crop=384, grid=14)
    ids = fg.fused_patch_voxel_coords(depths, intr, poses, **args)
    ref = fg.reference_patch_voxel_coords(depths, intr, poses, **args)
    diff = (ids - ref).abs()
    frac = float((diff > 0).float().mean())
    _check("B1 voxel ids", frac <= 1e-3 and float(diff.max()) <= 1,
           f"{frac:.2e} of ids differ, max |d| {float(diff.max()):.0f}")
    wc = fg.fused_patch_voxel_coords(depths, intr, poses, discretize=False,
                                     **args)
    wc_ref = fg.reference_patch_voxel_coords(depths, intr, poses,
                                             discretize=False, **args)
    err = float((wc - wc_ref).abs().max())
    _check("B1 world coords", err <= 1e-3, f"max |d| {err:.2e} m")
    return err, (
        _median_ms(lambda: fg.fused_patch_voxel_coords(depths, intr, poses,
                                                       **args), 20),
        _median_ms(lambda: fg.reference_patch_voxel_coords(depths, intr,
                                                           poses, **args), 5))


def check_flash(dev):
    import torch

    from video3d_tpu_torch.kernels import flash_attention as fa

    g = torch.Generator(device=dev).manual_seed(2)
    H, KV, hd = 28, 4, 128

    def case(B, L, lengths):
        # |v| < ~2.5 keeps |out| below 4, where one bf16 ulp is 1.6e-2
        q = torch.randn(B, L, H, hd, generator=g, device=dev).to(torch.bfloat16)
        k = torch.randn(B, L, KV, hd, generator=g, device=dev).to(torch.bfloat16)
        v = (0.5 * torch.randn(B, L, KV, hd, generator=g,
                               device=dev)).to(torch.bfloat16)
        lens = torch.tensor(lengths, dtype=torch.int32, device=dev)
        out = fa.flash_attention(q, k, v, lengths=lens)
        ref = fa.flash_attention_plain(q, k, v, lengths=lens)
        err = max(float((out[b, :n].float() - ref[b, :n].float()).abs().max())
                  for b, n in enumerate(lengths))
        finite = bool(torch.isfinite(out.float()).all())
        _check(f"B2 B={B} L={L} lengths={lengths}", err <= 2e-2 and finite,
               f"max |d| {err:.2e} on rows < length, finite={finite}")
        return err, (q, k, v, lens)

    err, main = case(1, 8192, [6780])
    case(1, 1000, [1000])
    case(2, 2048, [2048, 1111])
    q, k, v, lens = main
    return err, (
        _median_ms(lambda: fa.flash_attention(q, k, v, lengths=lens), 10),
        _median_ms(lambda: fa.flash_attention_plain(q, k, v, lengths=lens), 3))


def check_decode(dev):
    import torch

    from video3d_tpu_torch.kernels import decode_attention as da

    g = torch.Generator(device=dev).manual_seed(3)
    NL, H, KV, hd, S, layer = 28, 28, 4, 128, 8704, 27
    worst = 0.0
    timed = None
    for lens in ([6812], [8704, 6812, 300, 4097]):
        B = len(lens)
        q = torch.randn(B, 1, H, hd, generator=g, device=dev).to(torch.bfloat16)
        k_all = torch.randn(NL, B, S, KV * hd, generator=g,
                            device=dev).to(torch.bfloat16)
        v_all = torch.randn(NL, B, S, KV * hd, generator=g,
                            device=dev).to(torch.bfloat16)
        kv_len = torch.tensor(lens, dtype=torch.int32, device=dev)
        out = da.decode_attention(q, k_all, v_all, kv_len, layer, KV)
        ref = da.decode_attention_plain(q, k_all, v_all, kv_len, layer, KV)
        err = float((out.float() - ref.float()).abs().max())
        _check(f"B3 B={B} kv_len={lens}", err <= 2e-2, f"max |d| {err:.2e}")
        worst = max(worst, err)
        if timed is None:
            timed = (q, k_all, v_all, kv_len)
        del k_all, v_all
    q, k_all, v_all, kv_len = timed
    return worst, (
        _median_ms(lambda: da.decode_attention(q, k_all, v_all, kv_len,
                                               layer, KV), 50),
        _median_ms(lambda: da.decode_attention_plain(q, k_all, v_all, kv_len,
                                                     layer, KV), 10))


def check_kernels():
    import torch

    dev = torch.device("cuda", 0)
    rows = {}
    for name, fn in (("fused_geometry", check_geometry),
                     ("flash_attention", check_flash),
                     ("decode_attention", check_decode)):
        print(f"{name}:", flush=True)
        err, (ms, plain_ms) = fn(dev)
        print(f"  {name}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms",
              flush=True)
        rows[name] = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms}
        torch.cuda.empty_cache()
    return rows


def _scanqa_questions(video_id: str):
    return [{
        "id": f"smoke{i}",
        "video": video_id,
        "conversations": [
            {"from": "human", "value": f"<image>\n{text}"},
            {"from": "gpt", "value": "a brown wooden chair"},
        ],
        "metadata": {"dataset": "scanqa", "question_type": "what"},
    } for i, text in enumerate(("What color is the chair next to the desk?",
                                "How many pillows are on the bed?"))]


def run_main_path():
    """Answer two questions at full width through ``run_scanqa``; returns the
    kernel launch counts of that run."""
    import torch

    sys.path.insert(0, os.path.join(ROOT, "tests"))
    from fixtures import FakeTokenizer, make_fake_scene

    from video3d_tpu_torch.config import DataConfig, ModelConfig
    from video3d_tpu_torch.eval.drivers import (EngineConfig, InferenceEngine,
                                                VideoProcessor, run_scanqa)
    from video3d_tpu_torch.kernels import _build
    from video3d_tpu_torch.models import generate as gen
    from video3d_tpu_torch.models import llava_video3d as lv3d
    from video3d_tpu_torch.params import init_model

    class RecordingEngine(InferenceEngine):
        """Keeps every GenerateResult so the run can be checked."""

        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            self.results = []

        def _generate(self, batch, vision_features=None):
            res = super()._generate(batch, vision_features)
            self.results.append(res)
            return res

    dev = torch.device("cuda", 0)
    cfg = ModelConfig()
    t0 = time.perf_counter()
    params = init_model(cfg, dev, torch.Generator(device=dev).manual_seed(0),
                        torch.bfloat16)
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in _leaves(params))
    print(f"main path: ModelConfig() {cfg.vision.num_hidden_layers}+"
          f"{cfg.llm.num_hidden_layers} layers, {n_params / 1e9:.3f} B "
          f"bf16 parameters initialised on the card in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    max_new = 32
    with tempfile.TemporaryDirectory() as root:
        info = make_fake_scene(root, n_frames=32, H=480, W=640)
        tok = FakeTokenizer()
        engine = RecordingEngine(
            params, cfg, tok,
            VideoProcessor(DataConfig(
                video_folder=root,
                annotation_dir=os.path.join(root, "embodiedscan"),
                metadata_dir=os.path.join(root, "metadata"),
                frames_upbound=32)),
            engine_cfg=EngineConfig(max_new_tokens=max_new,
                                    eos_token_id=tok.eos_token_id,
                                    max_frames=32, stop_str=""),
            device=dev)
        qs = _scanqa_questions(info["sample_idx"])
        engine.generate_answer(qs[0])                 # warm-up, not counted
        engine.results.clear()
        answer_file = os.path.join(root, "scanqa.jsonl")
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _build.reset_launches()
        t0 = time.perf_counter()
        times = run_scanqa(engine, qs, answer_file)
        wall = time.perf_counter() - t0
        launches = dict(_build.LAUNCHES)
        peak = torch.cuda.max_memory_allocated()
        with open(answer_file) as f:
            records = [json.loads(line) for line in f]

        # checks of what came out
        _check("answer records", len(records) == 2 and all(
            isinstance(r["pred_response"], str) for r in records),
            f"{len(records)} jsonl records")
        forwards = 0
        for res in engine.results:
            n = int(res.lengths[0])
            toks = res.tokens[0, :n]
            _check("emitted ids",
                   bool(((toks >= 0) & (toks < cfg.llm.vocab_size)).all()),
                   f"{n} ids in [0, {cfg.llm.vocab_size})")
            forwards += min(n + 1, max_new)
        L = cfg.llm.num_hidden_layers
        expected = {"fused_geometry": 2, "flash_attention": 2 * L,
                    "decode_attention": L * forwards}
        _check("launch counts", launches == expected,
               f"{launches}, expected {expected} ({forwards} decode forwards)")
        print(f"  per-request seconds (prep excluded): "
              f"{[round(t, 4) for t in times]}; wall for 2 requests "
              f"(prep included) {wall:.3f} s; peak device memory "
              f"{peak / 2**30:.2f} GiB", flush=True)

        # a separately timed request: vision, LLM prefill, decode
        batch = engine._prepare_generation(qs[1])
        seq_len = int(batch.seq_len[0])
        with torch.inference_mode():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            vis = lv3d.encode_video(params, cfg, batch.images,
                                    batch.patch_coords).spliceable
            torch.cuda.synchronize()
            t_vis = time.perf_counter() - t0
            t0 = time.perf_counter()
            logits, _, _ = gen.prefill_multimodal(
                params, cfg, batch, batch.text_ids.shape[1] + max_new,
                vision_features=vis)
            torch.cuda.synchronize()
            t_pre = time.perf_counter() - t0
        _check("prefill logits", logits.shape == (1, cfg.llm.vocab_size)
               and bool(torch.isfinite(logits.float()).all()),
               f"shape {tuple(logits.shape)}, all finite")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = engine._generate(batch, vis)
        steps = min(int(res.lengths[0]) + 1, max_new)
        torch.cuda.synchronize()
        t_gen = time.perf_counter() - t0
        decode_ms = (t_gen - t_pre) / steps * 1e3
        print(f"  vision (tower+projector+pool+PE, {batch.images.shape[1]} "
              f"frames) {t_vis * 1e3:.1f} ms; LLM prefill {seq_len} tokens "
              f"(bucket {batch.text_ids.shape[1]}) {t_pre * 1e3:.1f} ms = "
              f"{seq_len / t_pre:.0f} tokens/s; decode {decode_ms:.2f} "
              f"ms/token over {steps} steps", flush=True)
    return launches


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, list):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


def main() -> None:
    preconditions()
    import torch

    build()
    rows = check_kernels()
    launches = run_main_path()
    kernels = []
    for name, (source, replaces) in KERNEL_INFO.items():
        kernels.append({"name": name, "route": "cuda", "source": source,
                        "replaces": replaces, "launches": launches[name],
                        **rows[name]})
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
