"""A/B of the 8-slot decode step between source trees, on one CUDA GPU:

    python3 scripts/torch_port/decode_ab.py --tree parent=DIR [--tree ...]
        [--bits 8] [--steps 8] [profile_paged_decode.py options]

Each ``--tree NAME=DIR`` names another tree holding ``video3d_tpu_torch``
(for example an unpacked ``git archive`` of the parent commit). The
decode step of ``profile_paged_decode.py`` (the paged step of
``chip_smoke.py`` phase 8 and the dense 8-slot step of phases 5 / 6, in
the ``--bits`` configuration) runs in a fresh process per turn, in the
order: the other trees, this tree twice, the other trees reversed (parent,
change, change, parent for one tree). Each turn builds its tree's kernels
and prints the wall ms per step (host clock, synchronised), the kernels per
step, the device busy share and the device ms per step. Other options go
to ``profile_paged_decode.py`` (``--device cpu --tiny`` rehearses the A/B).

Prints one JSON object and writes it to ``chiprun_out/decode_ab_<bits>.json``.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
PROFILE = os.path.join(ROOT, "scripts", "torch_port", "profile_paged_decode.py")


def _turn(package: str, bits: int, steps: int, extra) -> dict:
    res = subprocess.run(
        [sys.executable, PROFILE, "--bits", str(bits), "--steps", str(steps),
         "--package", package, *extra], capture_output=True, text=True)
    if res.returncode != 0:
        raise SystemExit(f"decode_ab: {package} failed:\n{res.stdout}"
                         f"{res.stderr[-4000:]}")
    full = json.loads(res.stdout.strip().splitlines()[-1])
    out = {}
    for step in ("paged", "dense"):
        r = full[step]
        out[step] = {
            "wall_ms_per_step": r["wall_ms_per_step"],
            "kernels_per_step": r["kernels_per_step"],
            "device_busy_share": r["device_busy_share"],
            "device_ms_per_step": sum(
                r["device_ms_per_step_by_group"].values()),
            "device_ms_per_step_by_group": r["device_ms_per_step_by_group"]}
    return out


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--tree", action="append", required=True,
                    help="NAME=DIR of another tree holding video3d_tpu_torch")
    ap.add_argument("--bits", type=int, default=8, choices=(16, 8, 4))
    ap.add_argument("--steps", type=int, default=8)
    args, extra = ap.parse_known_args()
    others = [t.split("=", 1) for t in args.tree]
    trees = dict(others, change=ROOT)
    turns = ([n for n, _ in others] + ["change", "change"]
             + [n for n, _ in reversed(others)])
    result = {"bits": args.bits, "steps": args.steps, "turns": []}
    for name in turns:
        r = _turn(os.path.abspath(trees[name]), args.bits, args.steps, extra)
        print(f"{name}: paged {r['paged']['wall_ms_per_step']:.2f} ms/step "
              f"(device {r['paged']['device_ms_per_step']:.2f}), dense "
              f"{r['dense']['wall_ms_per_step']:.2f} ms/step (device "
              f"{r['dense']['device_ms_per_step']:.2f})", flush=True)
        result["turns"].append({"tree": name, **r})
    if shutil.which("nvidia-smi"):
        result["nvidia-smi"] = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True,
            text=True).stdout.strip()
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(ROOT, "chiprun_out",
                           f"decode_ab_{args.bits}.json"), "w") as f:
        json.dump(result, f, indent=1)
    print(json.dumps(result))


if __name__ == "__main__":
    main()
