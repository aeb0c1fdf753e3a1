"""A/B of the port's flash kernels B2 (prefill, and with the logsumexp) and
B6 (backward) between two source trees, on one CUDA GPU:

    python3 scripts/torch_port/flash_prefill_ab.py --parent DIR [--iters 20]
        [--hd 128|256]

``DIR`` holds another tree's ``video3d_tpu_torch`` package (for example a
``git archive`` of the parent commit, unpacked). Each turn is a fresh
process that imports one tree's package, builds its kernels (into that
tree's ``_build/``) and, at B=1, L=8192, length 6780, causal, H=28, KV=4,
hd=128 (chip_smoke.py's phase-3 shape; ``--hd 256``: Gemma-2B's H=8,
KV=1, hd=256, the shape of phase 3's hd-256 training rows):

1. holds the tree's ``flash_attention``, ``flash_attention_fwd`` and
   ``flash_attention_bwd`` against the plain versions run in f32 on the same
   bf16 values (bf16 output <= 2e-2, lse <= 1e-3, each gradient <= 2e-2 of
   its largest magnitude). The trees' arithmetic differs, so their outputs
   are held to the plain version and not to each other bit for bit;
2. times each (median of ``--iters`` CUDA-event timings, each call queued
   behind a ~1 ms spin kernel so the events time the device work): B6 as
   the wrapper runs it, delta and whatever the tree's kernels need around
   them included.

Turns: parent, change, change, parent. Prints one JSON object and writes it
to ``chiprun_out/flash_prefill_ab.json``. The SASS of the kernels that must
not change is compared by ``sass_ab.py``.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
SHAPES = {128: (1, 8192, 28, 4, 6780),     # hd -> B, L, H, KV, length
          256: (1, 8192, 8, 1, 6780)}
BF16_ATOL, LSE_ATOL, B6_REL = 2e-2, 1e-3, 2e-2


def _median_ms(fn, iters: int) -> float:
    import torch

    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(1_000_000)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return sorted(times)[len(times) // 2]


def turn(tree: str, iters: int, hd: int) -> dict:
    """One tree's checks and times at head width ``hd``, in this
    process."""
    sys.path.insert(0, tree)
    import torch

    from video3d_tpu_torch.kernels import flash_attention as fa

    assert fa.__file__.startswith(os.path.abspath(tree)), fa.__file__
    dev = torch.device("cuda", 0)
    g = torch.Generator(device=dev).manual_seed(2)
    B, L, H, KV, n = SHAPES[hd]
    q = (3.0 * torch.randn(B, L, H, hd, generator=g, device=dev)).bfloat16()
    k = torch.randn(B, L, KV, hd, generator=g, device=dev).bfloat16()
    v = (0.5 * torch.randn(B, L, KV, hd, generator=g, device=dev)).bfloat16()
    do = torch.randn(B, L, H, hd, generator=g, device=dev).bfloat16()
    lens = torch.tensor([n], dtype=torch.int32, device=dev)

    out = fa.flash_attention(q, k, v, lengths=lens)
    out_lse, lse = fa.flash_attention_fwd(q, k, v, lens)
    grads = fa.flash_attention_bwd(q, k, v, out_lse, lse, do, lens)
    qf, kf, vf = q.float(), k.float(), v.float()
    ref, ref_lse = fa.flash_attention_fwd_plain(qf, kf, vf, lens)
    err = {"flash_attention": float((out[:, :n].float()
                                     - ref[:, :n]).abs().max()),
           "flash_attention_lse": float((lse - ref_lse).abs().max())}
    del ref
    ref_grads = fa.flash_attention_bwd_plain(qf, kf, vf, out_lse.float(), lse,
                                             do.float(), lens)
    err["flash_attention_bwd"] = max(
        float((a.float() - b).abs().max() / b.abs().max())
        for a, b in zip(grads, ref_grads))
    del ref_grads, grads
    ok = (err["flash_attention"] <= BF16_ATOL
          and err["flash_attention_lse"] <= LSE_ATOL
          and err["flash_attention_bwd"] <= B6_REL)
    ms = {"flash_attention": _median_ms(
              lambda: fa.flash_attention(q, k, v, lengths=lens), iters),
          "flash_attention_lse": _median_ms(
              lambda: fa.flash_attention_fwd(q, k, v, lens), iters),
          "flash_attention_bwd": _median_ms(
              lambda: fa.flash_attention_bwd(q, k, v, out_lse, lse, do, lens),
              iters)}
    return {"ms": ms, "max_err": err, "within_bounds": ok}


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--parent",
                    help="a tree holding the other video3d_tpu_torch")
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--hd", type=int, choices=sorted(SHAPES), default=128)
    ap.add_argument("--turn", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.turn:
        print(json.dumps(turn(args.turn, args.iters, args.hd)))
        return
    if not args.parent:
        ap.error("--parent DIR is required")
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("flash_prefill_ab: needs a CUDA device")
    trees = {"parent": os.path.abspath(args.parent), "change": ROOT}
    turns = ["parent", "change", "change", "parent"]
    runs = []
    for tag in turns:
        res = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--turn", trees[tag],
             "--iters", str(args.iters), "--hd", str(args.hd)],
            capture_output=True, text=True)
        if res.returncode:
            raise SystemExit(f"{tag} turn failed:\n{res.stdout}{res.stderr}")
        runs.append(json.loads(res.stdout.strip().splitlines()[-1]))
    B, L, H, KV, n = SHAPES[args.hd]
    result = {"device": torch.cuda.get_device_name(0), "shape": {
        "B": B, "L": L, "H": H, "KV": KV, "length": n, "hd": args.hd,
        "causal": True}, "turns": turns}
    for name in runs[0]["ms"]:
        result[f"{name} ms"] = [r["ms"][name] for r in runs]
        result[f"{name} max err"] = [r["max_err"][name] for r in runs]
    result["within bounds"] = [r["within_bounds"] for r in runs]
    result["nvidia-smi"] = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True,
        text=True).stdout.strip()
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    name = "flash_prefill_ab" + ("" if args.hd == 128 else f"_hd{args.hd}")
    with open(os.path.join(ROOT, "chiprun_out", name + ".json"), "w") as f:
        json.dump(result, f, indent=1)
    print(json.dumps(result))
    if not all(result["within bounds"]):
        raise SystemExit("flash_prefill_ab: a tree's output is out of bounds")


if __name__ == "__main__":
    main()
