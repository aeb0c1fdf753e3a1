"""A/B of B4's one-row int8 matvec (``int8_matvec``, the B=1 vocab head)
and B1 (``fused_geometry``) between two source trees, on one CUDA GPU:

    python3 scripts/torch_port/matvec_geometry_ab.py --parent DIR
        [--iters 30] [--steps 8] [--no-answers]

``DIR`` holds another tree's ``video3d_tpu_torch`` package (for example a
``git archive`` of the parent commit, unpacked under the git-ignored
``.rehearsal/``). Turns: parent, change, change, parent; each turn is a
fresh process that imports one tree's package and builds its kernels (into
that tree's ``_build/``), then:

1. B4's matvec at the vocab head (x (1, 1, 3584) bf16, the int8 (3584,
   152064) weight quantized by the tree's ``quantize_weight`` from N(0,
   0.02) draws of a seeded generator): within one bf16 ulp of the f32
   plain version, ms warm and with the L2 flushed (median of ``--iters``
   CUDA-event timings, each call queued behind a ~1 ms spin kernel), beside
   B4's B>1 form on the same one-row head and B9b's probe of the same
   weight (``bench/probes.py``).
2. B1 at the main path's shape (V=32 480x640 int32 depths, crop 384, grid
   14): voxel ids (at most 1e-3 differ, by at most 1) and world coordinates
   (1e-3 m) against the plain version, ms warm and flushed, and the
   benchmark's ``geometry`` stage (``bench/flagship.py``: the host's wall
   ms of a call on perturbed depths, launches and wrapper included).
3. Unless ``--no-answers``: ``chip_smoke.py`` phase 6's B=1 int8 ScanQA
   answers (``init_model(bits=8)`` from seed 0, the int8 KV cache, the
   synthetic 32-frame scene, the two questions of ``run_main_path``), as
   the token ids each generate call emitted.
4. ``profile_paged_decode.py --bits 8 --slots 1``: the device ms of a B=1
   int8 decode step (dense and paged), by kernel group (B4's matvec among
   them), under ``torch.profiler``, in a process of its own.

Prints one JSON object (per quantity the four turns, the change's best
flushed time over the parent's, the answers equal across turns or not,
with the digest phase 6 prints for them: ``chip_smoke._tokens_digest``) and
writes it to ``chiprun_out/matvec_geometry_ab.json``. Exits non-zero when a
tree's output is out of bounds or the answers differ.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import subprocess
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
PROFILE = os.path.join(ROOT, "scripts", "torch_port",
                       "profile_paged_decode.py")
HEAD = (3584, 152064)
GEOMETRY = (32, 480, 640, 384, 14)      # V, H, W, crop, grid


def _matvec(dev, iters: int) -> dict:
    import torch

    from video3d_tpu_torch.bench import probes, timing
    from video3d_tpu_torch.kernels import quant_matvec as qm
    from video3d_tpu_torch.models.quant import quantize_weight

    g = torch.Generator(device=dev).manual_seed(6)
    in_, out = HEAD
    d = quantize_weight((0.02 * torch.randn(in_, out, generator=g,
                                             device=dev)).to(torch.bfloat16))
    q, scale = d["q"], d["scale"]
    del d
    x = torch.randn(1, 1, in_, generator=g, device=dev).to(torch.bfloat16)
    ref = qm.int8_matmul_plain(x.float(), q, scale)
    res = {}
    for name, fn in (("B4 matvec", qm.int8_matvec),
                     ("B4 B>1 at one row", qm.int8_matmul)):
        y = fn(x, q, scale)
        res[name] = {
            "ulps": float(((y.float() - ref).abs()
                           / (2.0 ** -7 * ref.abs() + 1e-4)).max()),
            "ms": timing.median_ms(lambda: fn(x, q, scale), iters),
            "ms_l2_flushed": timing.median_ms(
                lambda: fn(x, q, scale), iters, flush_l2_cache=True)}
    del q, scale, x, ref
    torch.cuda.empty_cache()
    line = probes.probe_matvec(dev, iters=iters)[0]
    res["B9b"] = {"ms": line["ms_warm"], "ms_l2_flushed": line["ms"]}
    torch.cuda.empty_cache()
    return res


def _geometry(dev, iters: int) -> dict:
    import torch

    from video3d_tpu_torch.bench import flagship, timing
    from video3d_tpu_torch.config import ModelConfig
    from video3d_tpu_torch.kernels import fused_geometry as fg

    V, H, W, crop, grid = GEOMETRY
    g = torch.Generator().manual_seed(1)
    depths = torch.randint(500, 5000, (V, H, W), generator=g,
                           dtype=torch.int32).to(dev)
    intr = torch.eye(4)
    intr[0, 0] = intr[1, 1] = 0.9 * W
    intr[0, 2], intr[1, 2] = W / 2 - 0.5, H / 2 - 0.5
    a, _ = torch.linalg.qr(torch.randn(V, 3, 3, generator=g))
    poses = torch.eye(4).repeat(V, 1, 1)
    poses[:, :3, :3] = a
    poses[:, :3, 3] = torch.rand(V, 3, generator=g) * 4 - 2
    intr, poses = intr.to(dev), poses.to(dev)

    def call(fn, **kw):
        return fn(depths, intr, poses, crop=crop, grid=grid, **kw)
    ids = call(fg.fused_patch_voxel_coords)
    diff = (ids - call(fg.reference_patch_voxel_coords)).abs()
    wc = call(fg.fused_patch_voxel_coords, discretize=False)
    wc_err = float((wc - call(fg.reference_patch_voxel_coords,
                              discretize=False)).abs().max())
    cfg = ModelConfig()
    scan = flagship.scan_tensors(flagship.make_scan(V), dev)
    stage = timing.wall_ms(flagship.perturbed(
        lambda i: flagship.stage_geometry(cfg, scan[0] + i, *scan[1:3])),
        iters, dev)
    return {"ids_differ": float((diff > 0).float().mean()),
            "ids_max_diff": float(diff.max()), "world_max_err_m": wc_err,
            "ms": timing.median_ms(lambda: call(fg.fused_patch_voxel_coords),
                                   iters),
            "ms_l2_flushed": timing.median_ms(
                lambda: call(fg.fused_patch_voxel_coords), iters,
                flush_l2_cache=True),
            "geometry_stage_wall_ms": stage}


def _answers(dev) -> list:
    """Phase 6's B=1 int8 ScanQA answers: the token ids of each generate
    call of ``chip_smoke.run_main_path``'s two questions (after its
    warm-up)."""
    import torch

    sys.path += [ROOT, os.path.join(ROOT, "tests")]     # after the tree
    import chip_smoke
    from fixtures import make_fake_scene

    from video3d_tpu_torch.config import ModelConfig
    from video3d_tpu_torch.params import init_model

    cfg = ModelConfig()
    params = init_model(cfg, dev, torch.Generator(device=dev).manual_seed(0),
                        torch.bfloat16, bits=8)
    with tempfile.TemporaryDirectory() as root:
        info = make_fake_scene(root, scene_id="scene0000_00", n_frames=32,
                               H=480, W=640)
        engine = chip_smoke._make_engine(params, cfg, root,
                                         kv_cache_dtype="int8")
        qs = chip_smoke._questions(info["sample_idx"],
                                   chip_smoke.SCANQA_TEXTS, "smoke")
        engine.generate_answer(qs[0])           # warm-up, as in phase 6
        engine.results.clear()
        for q in qs:
            engine.generate_answer(q)
        return [[res.tokens[b, :n].tolist()
                 for b, n in enumerate(res.lengths.tolist())]
                for res in engine.results]


def turn(tree: str, iters: int, answers: bool) -> dict:
    """One tree's checks and times, in this process."""
    sys.path.insert(0, tree)
    import torch

    from video3d_tpu_torch.kernels import quant_matvec as qm

    assert qm.__file__.startswith(os.path.abspath(tree)), qm.__file__
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    res = {"matvec": _matvec(dev, iters), "geometry": _geometry(dev, iters)}
    if answers:
        res["answers"] = _answers(dev)
    return res


def _run(cmd) -> dict:
    out = subprocess.run(cmd, capture_output=True, text=True)
    if out.returncode:
        raise SystemExit(f"matvec_geometry_ab: {' '.join(cmd)} failed:\n"
                         f"{out.stdout[-4000:]}{out.stderr[-4000:]}")
    return json.loads(out.stdout.strip().splitlines()[-1])


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--parent",
                    help="a tree holding the other video3d_tpu_torch")
    ap.add_argument("--iters", type=int, default=30)
    ap.add_argument("--steps", type=int, default=8,
                    help="decode steps of the profiled chunk")
    ap.add_argument("--no-answers", action="store_true",
                    help="skip phase 6's B=1 int8 answers")
    ap.add_argument("--turn", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.turn:
        print(json.dumps(turn(args.turn, args.iters, not args.no_answers)))
        return
    if not args.parent:
        ap.error("--parent DIR is required")
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("matvec_geometry_ab: needs a CUDA device")
    trees = {"parent": os.path.abspath(args.parent), "change": ROOT}
    turns = ["parent", "change", "change", "parent"]
    runs, steps = [], []
    for tag in turns:
        runs.append(_run(
            [sys.executable, os.path.abspath(__file__), "--turn", trees[tag],
             "--iters", str(args.iters)]
            + (["--no-answers"] if args.no_answers else [])))
        step = _run([sys.executable, PROFILE, "--bits", "8", "--slots", "1",
                     "--steps", str(args.steps), "--package", trees[tag]])
        steps.append({k: step[k] for k in ("dense", "paged")})
    result = {"device": torch.cuda.get_device_name(0), "turns": turns}
    ok = True
    for part, names in (("matvec", runs[0]["matvec"]), ("geometry", None)):
        for name in names or [None]:
            rows = [r[part][name] if name else r[part] for r in runs]
            flushed = [row["ms_l2_flushed"] for row in rows]
            entry = {k: [row[k] for row in rows] for k in rows[0]}
            entry["change / parent, flushed"] = min(flushed[1:3]) \
                / min(flushed[0], flushed[3])
            entry["change / parent, warm"] = \
                min(row["ms"] for row in rows[1:3]) \
                / min(rows[0]["ms"], rows[3]["ms"])
            result[f"{part} {name}" if name else part] = entry
            if "ulps" in rows[0]:
                ok &= all(row["ulps"] <= 1.0 for row in rows)
    ok &= all(r["geometry"]["ids_differ"] <= 1e-3
              and r["geometry"]["ids_max_diff"] <= 1
              and r["geometry"]["world_max_err_m"] <= 1e-3 for r in runs)
    result["decode step"] = {
        step: {"device_ms_per_step": [sum(s[step][
                   "device_ms_per_step_by_group"].values()) for s in steps],
               "B4 matvec ms per step": [s[step][
                   "device_ms_per_step_by_group"]["B4 int8 matvec"]
                   for s in steps],
               "wall_ms_per_step": [s[step]["wall_ms_per_step"]
                                    for s in steps]}
        for step in ("dense", "paged")}
    if not args.no_answers:
        same = all(r["answers"] == runs[0]["answers"] for r in runs)
        digest = hashlib.sha1()           # as chip_smoke._tokens_digest
        for call in runs[0]["answers"]:
            for row in call:
                digest.update(json.dumps(row).encode())
        result["answers"] = {"equal across turns": same,
                             "sha1": digest.hexdigest()[:12],
                             "token ids": runs[0]["answers"]}
        ok &= same
    result["within bounds"] = ok
    result["nvidia-smi"] = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True,
        text=True).stdout.strip()
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(ROOT, "chiprun_out", "matvec_geometry_ab.json"),
              "w") as f:
        json.dump(result, f, indent=1)
    print(json.dumps(result))
    if not ok:
        raise SystemExit("matvec_geometry_ab: a tree is out of bounds or "
                         "the answers differ")


if __name__ == "__main__":
    main()
