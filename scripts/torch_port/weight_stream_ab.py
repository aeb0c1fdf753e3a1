"""A/B of the port's weight-streaming kernels, B4's B>1 form
(``int8_matmul``) and B8 (``int4_matmul``), between two source trees, on
one CUDA GPU:

    python3 scripts/torch_port/weight_stream_ab.py --parent DIR [--iters 20]
        [--shapes all|NAME,...]

``DIR`` holds another tree's ``video3d_tpu_torch`` package (for example a
``git archive`` of the parent commit, unpacked). Each turn is a fresh
process that imports one tree's package, builds its kernels (into that
tree's ``_build/``) and, at every Qwen2-7B decode projection shape (wq /
wo, wk / wv, w_gate / w_up, w_down) and the vocab head, at 1, 8 and 32 rows
of x, in both weight forms (int8; int4 padded as the model pads it): holds
the kernel's output to its plain version run in f32 on the same values
(within one bf16 ulp), and times it (median of ``--iters`` CUDA-event
timings, each call queued behind a ~1 ms spin kernel; warm, and with the
L2 flushed before each call: a decode step reads each weight from HBM).
Weights come from N(0, 0.02) draws of a seeded generator, quantized by the
tree's own ``quantize_weight`` / ``quantize_weight_int4``; x likewise.

Turns: parent, change, change, parent. Prints one JSON object (per case
the four turns' ms, flushed ms and error ratios, and the change's flushed
ms over the parent's, best turn against best turn) and writes it to
``chiprun_out/weight_stream_ab.json``.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
SHAPES = (("wq / wo", 3584, 3584), ("wk / wv", 3584, 512),
          ("w_gate / w_up", 3584, 18944), ("w_down", 18944, 3584),
          ("lm_head", 3584, 152064))
ROWS = (1, 8, 32)


def turn(tree: str, iters: int, names) -> dict:
    """One tree's checks and times, in this process."""
    sys.path.insert(0, tree)
    import torch

    from video3d_tpu_torch.bench import timing
    from video3d_tpu_torch.kernels import quant_matvec as qm
    from video3d_tpu_torch.models.quant import (quantize_weight,
                                                quantize_weight_int4)

    assert qm.__file__.startswith(os.path.abspath(tree)), qm.__file__
    dev = torch.device("cuda", 0)
    ms, ms_flushed, ulps = {}, {}, {}
    for what, in_, out in SHAPES:
        if what not in names:
            continue
        g = torch.Generator(device=dev).manual_seed(in_ + out)
        w = (0.02 * torch.randn(in_, out, generator=g,
                                device=dev)).to(torch.bfloat16)
        d = quantize_weight(w)
        w4 = quantize_weight_int4(w)
        del w
        forms = (("int8", d["q"], d["scale"], qm.int8_matmul,
                  qm.int8_matmul_plain),
                 ("int4", w4.q4, w4.scale4, qm.int4_matmul,
                  qm.int4_matmul_plain))
        for form, q, sc, kernel, plain in forms:
            width = 2 * q.shape[0] if form == "int4" else in_
            for B in ROWS:
                x = torch.randn(B, width, generator=g,
                                device=dev).to(torch.bfloat16)
                name = f"{form} {what} B={B}"
                y = kernel(x, q, sc)
                ref = plain(x.float(), q, sc)
                ulps[name] = float(((y.float() - ref).abs()
                                    / (2.0 ** -7 * ref.abs() + 1e-4)).max())
                del y, ref
                ms[name] = timing.median_ms(lambda: kernel(x, q, sc), iters)
                ms_flushed[name] = timing.median_ms(
                    lambda: kernel(x, q, sc), iters, flush_l2_cache=True)
        del d, w4, forms
        torch.cuda.empty_cache()
    return {"ms": ms, "ms_l2_flushed": ms_flushed, "ulps": ulps,
            "within_bounds": all(u <= 1.0 for u in ulps.values())}


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--parent",
                    help="a tree holding the other video3d_tpu_torch")
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--shapes", default="all",
                    help="comma-separated shape names (default all)")
    ap.add_argument("--turn", help=argparse.SUPPRESS)
    args = ap.parse_args()
    names = [s for s, _, _ in SHAPES] if args.shapes == "all" \
        else args.shapes.split(",")
    if args.turn:
        print(json.dumps(turn(args.turn, args.iters, names)))
        return
    if not args.parent:
        ap.error("--parent DIR is required")
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("weight_stream_ab: needs a CUDA device")
    trees = {"parent": os.path.abspath(args.parent), "change": ROOT}
    turns = ["parent", "change", "change", "parent"]
    runs = []
    for tag in turns:
        res = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--turn", trees[tag],
             "--iters", str(args.iters), "--shapes", ",".join(names)],
            capture_output=True, text=True)
        if res.returncode:
            raise SystemExit(f"{tag} turn failed:\n{res.stdout}"
                             f"{res.stderr[-4000:]}")
        runs.append(json.loads(res.stdout.strip().splitlines()[-1]))
    result = {"device": torch.cuda.get_device_name(0), "turns": turns}
    for name in runs[0]["ms"]:
        flushed = [r["ms_l2_flushed"][name] for r in runs]
        result[name] = {
            "ms": [r["ms"][name] for r in runs], "ms L2 flushed": flushed,
            "ulps": [r["ulps"][name] for r in runs],
            "change / parent, flushed": min(flushed[1:3])
            / min(flushed[0], flushed[3])}
    result["within bounds"] = [r["within_bounds"] for r in runs]
    result["nvidia-smi"] = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True,
        text=True).stdout.strip()
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(ROOT, "chiprun_out", "weight_stream_ab.json"),
              "w") as f:
        json.dump(result, f, indent=1)
    print(json.dumps(result))
    if not all(result["within bounds"]):
        raise SystemExit("weight_stream_ab: a tree's output is out of bounds")


if __name__ == "__main__":
    main()
