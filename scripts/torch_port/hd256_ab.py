"""A/B of the head-width-256 attention kernels (B2 folded and B7:
``csrc/attention_hd256.cu``; B2's prefill form:
``csrc/flash_attention_hd256.cu``; B3: ``csrc/decode_sm90.cuh``; B5:
``csrc/shared_prefix_hd256.cu``; a parent tree may hold others) between two
source trees, on one CUDA GPU:

    python3 scripts/torch_port/hd256_ab.py --parent DIR [--iters 30]

``DIR`` holds another tree's ``video3d_tpu_torch`` package (for example a
``git archive`` of the parent commit, unpacked). Each turn is a fresh
process that imports one tree's package, builds its kernels (into that
tree's ``_build/``) and times the forms both trees have at ``chip_smoke.py``
phase 3's shapes, at Gemma-2B's heads (8 query heads on 1 kv head, head_dim
256, seeded bf16 inputs, the same in every turn): B2's prefill form (B=1,
L=8192, length 6780), B2 folded (64 queries at 6716 over layer 17 of an
18-layer cache of 8224 slots) and B3 (kv_len 6812 of 8704, layer 17); a
tree that has them also times B7 (8 slots of ~6.8k aliasing 52 prefix pages
of 128, layer 17 of 18-layer pools), B5 (B=8, L=64, a 6716-token prefix),
B3 over an int8 and an int4 cache and at B=8 (eight rows of 6812), and B5
over an int8 and an int4 prefix (the values quantized by the tree's own
cache write, ``quantize_rows``, from the same bf16 inputs). Each time is
the median of ``--iters`` CUDA-event timings, each
call queued behind a ~1 ms spin kernel, warm and with the L2 flushed before
each call. The first turn of a tree that compiled prints the kernel's
ptxas report (registers, spills).

Turns: parent, change, change, parent. Prints each form's times per turn
and writes them to ``chiprun_out/hd256_ab.json``.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
H, KV, HD, NL = 8, 1, 256, 18
PAGED_LENS = [6780, 6801, 0, 6750, 6912, 6790, 6760, 6845]
PAGE, PREFIX_PAGES, MAXP = 128, 52, 56
SUFFIX_LENS = [64, 40, 17, 64, 33, 50, 8, 60]
PREFIX = 6716


def _cases(dev):
    """(name, call, iters) of every form this tree has."""
    import torch

    from video3d_tpu_torch.kernels import decode_attention as da
    from video3d_tpu_torch.kernels import flash_attention as fa
    from video3d_tpu_torch.kernels import paged_attention as pa
    from video3d_tpu_torch.kernels import attention_hd256 as h256

    g = torch.Generator(device=dev).manual_seed(0)

    def bf(*shape):
        return torch.randn(*shape, generator=g, device=dev).bfloat16()

    def i32(values):
        return torch.tensor(values, dtype=torch.int32, device=dev)

    # every input is made here, once: a tensor built inside a timed call
    # would add a host-to-device copy to its time
    layer = NL - 1
    lens, flen, offs, dlen = i32([6780]), i32([6756]), i32([6716]), \
        i32([6812])
    q, k, v = bf(1, 8192, H, HD), bf(1, 8192, KV, HD), bf(1, 8192, KV, HD)
    qf, kc, vc = bf(1, 64, H, HD), bf(NL, 1, 8224, KV * HD), \
        bf(NL, 1, 8224, KV * HD)
    qd, kd, vd = bf(1, 1, H, HD), bf(NL, 1, 8704, KV * HD), \
        bf(NL, 1, 8704, KV * HD)
    out = [("B2 hd256", lambda: fa.flash_attention(q, k, v, lengths=lens),
            10),
           ("B2 folded hd256", lambda: fa.flash_attention_gqa_folded(
               qf, kc, vc, flen, offs, layer, KV), 50),
           ("B3 hd256", lambda: da.decode_attention(qd, kd, vd, dlen, layer,
                                                    KV), 50)]
    if "paged_hd256" not in dir(h256):
        return out
    S = len(PAGED_LENS)
    own = MAXP - PREFIX_PAGES
    P = 1 + PREFIX_PAGES + S * own
    table = torch.zeros(S, MAXP, dtype=torch.int32)
    table[:, :PREFIX_PAGES] = torch.arange(1, 1 + PREFIX_PAGES)
    table[:, PREFIX_PAGES:] = torch.arange(1 + PREFIX_PAGES, P).reshape(S,
                                                                        own)
    qp, table, plens = bf(S, 1, H, HD), table.to(dev), i32(PAGED_LENS)
    kp, vp = bf(NL, P, PAGE, KV * HD), bf(NL, P, PAGE, KV * HD)
    B = len(SUFFIX_LENS)
    qs, pk, pv = bf(B, 64, H, HD), bf(PREFIX, KV, HD), bf(PREFIX, KV, HD)
    sk, sv, slens = bf(B, 64, KV, HD), bf(B, 64, KV, HD), i32(SUFFIX_LENS)
    out += [("B7 hd256", lambda: pa.paged_decode_attention(
                qp, kp, vp, table, plens, layer, KV), 50),
            ("B5 hd256", lambda: fa.flash_attention_shared_prefix(
                qs, pk, pv, sk, sv, slens), 10)]
    from video3d_tpu_torch.models.qwen2 import quantize_rows

    # B3 at B=8 (eight rows of 6812) and the quantized forms of B3 and B5
    q8, k8c, v8c = bf(8, 1, H, HD), bf(2, 8, 8704, KV * HD), \
        bf(2, 8, 8704, KV * HD)
    lens8 = i32([6812] * 8)
    out.append(("B3 hd256 B=8", lambda: da.decode_attention(
        q8, k8c, v8c, lens8, 1, KV), 50))
    for bits, storage in ((8, torch.int8), (4, torch.uint8)):
        kq, ks = quantize_rows(kd.reshape(NL, 1, 8704, KV, HD), storage)
        vq, vs = quantize_rows(vd.reshape(NL, 1, 8704, KV, HD), storage)
        pkq, pks = quantize_rows(pk, storage)
        pvq, pvs = quantize_rows(pv, storage)
        pkq, pvq = (x.reshape(PREFIX, KV, -1) for x in (pkq, pvq))
        out += [(f"B3 hd256 int{bits}", lambda kq=kq, vq=vq, ks=ks, vs=vs:
                 da.decode_attention(qd, kq, vq, dlen, layer, KV, ks, vs),
                 50),
                (f"B5 hd256 int{bits}", lambda pkq=pkq, pvq=pvq, pks=pks,
                 pvs=pvs: fa.flash_attention_shared_prefix(
                     qs, pkq, pvq, sk, sv, slens, pks, pvs), 10)]
    return out


def _turn(tree: str, tag: str) -> dict:
    """One turn in this process: ``tree``'s package, every form timed."""
    sys.path.insert(0, os.path.abspath(tree))
    import torch

    import video3d_tpu_torch
    from video3d_tpu_torch.bench import timing
    from video3d_tpu_torch.kernels import _build

    got = os.path.dirname(os.path.dirname(video3d_tpu_torch.__file__))
    if got != os.path.abspath(tree):
        raise SystemExit(f"imported {got}, not {tree}")
    dev = torch.device("cuda", 0)
    times = {}
    for name, fn, iters in _cases(dev):
        fn()
        torch.cuda.synchronize()
        warm = timing.median_ms(fn, iters)
        flushed = timing.median_ms(fn, iters, flush_l2_cache=True)
        times[name] = (warm, flushed)
        print(f"  {tag} {name}: {warm:.4f} ms warm, {flushed:.4f} ms L2 "
              f"flushed", flush=True)
    log = _build.build_log.splitlines()
    for i, line in enumerate(log):
        if ("attention_hd256" in line or "shared_prefix_hd256" in line
                or "Li256E" in line) and "Compiling entry" in line:
            print("  ptxas:", " | ".join(x.strip() for x in log[i:i + 4]),
                  flush=True)
    return times


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--parent")
    ap.add_argument("--iters", type=int, default=30)
    ap.add_argument("--turn", nargs=2, metavar=("TREE", "TAG"),
                    help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.turn:
        print("TIMES " + json.dumps(_turn(*args.turn)), flush=True)
        return
    if not args.parent:
        ap.error("--parent DIR is required")
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("hd256_ab: needs a CUDA device")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    print(card, flush=True)
    turns = []
    for tag, tree in (("parent", args.parent), ("change", ROOT),
                      ("change", ROOT), ("parent", args.parent)):
        res = subprocess.run([sys.executable, os.path.abspath(__file__),
                              "--turn", tree, tag], capture_output=True,
                             text=True)
        sys.stdout.write(res.stdout)
        if res.returncode != 0:
            raise SystemExit(f"{tag} turn failed:\n{res.stderr}")
        line = [x for x in res.stdout.splitlines()
                if x.startswith("TIMES ")][-1]
        turns.append({"tag": tag, "times": json.loads(line[6:])})
    out = os.path.join(ROOT, "chiprun_out")
    os.makedirs(out, exist_ok=True)
    with open(os.path.join(out, "hd256_ab.json"), "w") as f:
        json.dump({"card": card, "turns": turns}, f, indent=1)


if __name__ == "__main__":
    main()
