"""A/B of the port's decode-attention kernels, B3 (flat cache) and B7 (page
pools), in their bf16, int8 and int4 cache forms, between two source
trees, on one CUDA GPU:

    python3 scripts/torch_port/decode_attention_ab.py --parent DIR
        [--iters 30] [--only NAME ...]

``DIR`` holds another tree's ``video3d_tpu_torch`` package (for example a
``git archive`` of the parent commit, unpacked). Each turn is a fresh
process that imports one tree's package, builds its kernels (into that
tree's ``_build/``), and at every shape below holds the kernel against its
plain version run in f32 on the same values (bf16 output <= 2e-2), calls it
twice (the same bits?) and times it: the median of ``--iters`` CUDA-event
timings, each call queued behind a ~1 ms spin kernel, warm and with the L2
flushed before each call. Shapes (Qwen2-7B: H 28, KV 4, hd 128, layer 27
of 28-layer stacked caches or pools, the inputs of ``chip_smoke.py``
phase 3, made from seeded generators, the same in every turn):

* B3 at phase 3's B=1 row (kv_len 6812 of 8704) and phase 5's B=8 rows
  (~6.8k each of 8704), each form; phase 11's B=1 32760 row of 32768, int8;
* B7 at phase 3's serving shape (8 slots of ~6.8k aliasing 52 prefix pages
  of 128, one slot empty), each form; phase 11's 1 x 32760 + 7 x ~520
  mix (pages of 128, none shared), int8.

Turns: parent, change, change, parent. Prints each shape's times per turn,
the ratio of the best flushed change turn to the best flushed parent turn,
the bytes (B7: DRAM bytes, the aliased pages once, and logical bytes, each
slot's), the share of the data-sheet byte bound, and writes everything to
``chiprun_out/decode_attention_ab.json``.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
BF16_ATOL = 2e-2
HBM_BYTES_PER_S = 3.35e12       # data sheet, H100 SXM at 700 W
H, KV, HD, NL = 28, 4, 128, 28
DENSE_S = 8704
B8_LENS = [6780, 6801, 6750, 6912, 6790, 6760, 6845, 6812]
FORMS = {"bf16": 16, "int8": 8, "int4": 4}


def _shapes():
    """(name, kernel, form, what) of every timed call."""
    out = []
    for form in FORMS:
        out.append((f"B3 {form} B=1 kv_len 6812", "B3", form, "b1"))
    for form in FORMS:
        out.append((f"B3 {form} B=8 kv_len ~6.8k", "B3", form, "b8"))
    out.append(("B3 int8 B=1 kv_len 32760 of 32768", "B3", "int8", "long"))
    for form in FORMS:
        out.append((f"B7 {form} 8 slots ~6.8k, 52 shared pages", "B7", form,
                    "serve"))
    out.append(("B7 int8 1 x 32760 + 7 x ~520", "B7", "int8", "mix"))
    return out


def _flat_inputs(g, dev, form, lens, S):
    """q, the stacked (NL, B, S, ...) cache of the form (chip_smoke's
    inputs: peaked queries, values at half scale), kv_len, layer, KV, and
    the scales."""
    import torch

    import chip_smoke as cs

    B = len(lens)
    q = (cs.Q_SCALE * torch.randn(B, 1, H, HD, generator=g,
                                  device=dev)).to(torch.bfloat16)
    kv_len = torch.tensor(lens, dtype=torch.int32, device=dev)
    if form == "bf16":
        k = torch.empty(NL, B, S, KV * HD, dtype=torch.bfloat16, device=dev)
        v = torch.empty_like(k)
        for i in range(NL):
            k[i] = torch.randn(B, S, KV * HD, generator=g, device=dev)
            v[i] = 0.5 * torch.randn(B, S, KV * HD, generator=g, device=dev)
        return (q, k, v, kv_len, NL - 1, KV, None, None)
    bits = FORMS[form]
    k, ks = cs._int8_cache(g, dev, (NL, B, S), KV, HD, bits=bits)
    v, vs = cs._int8_cache(g, dev, (NL, B, S), KV, HD, v_scale=0.5,
                           bits=bits)
    return (q, k, v, kv_len, NL - 1, KV, ks, vs)


def _flat_bytes(args) -> float:
    q, k, _, kv_len, _, _, ks, _ = args
    n = sum(kv_len.tolist())
    per = 2 * k.shape[-1] * k.element_size() + (2 * KV * 4 if ks is not None
                                                  else 0)
    return n * per + 2 * q.numel() * 2 + kv_len.numel() * 4


def _paged_bytes(args, shared_pages: int, page: int):
    """(DRAM bytes: the shared pages once; logical bytes: every slot's
    positions) of a B7 call."""
    q, k, _, table, kv_len, _, _, ks, _ = args
    lens = kv_len.tolist()
    per = 2 * k.shape[-1] * k.element_size() + (2 * KV * 4 if ks is not None
                                                 else 0)
    shared = shared_pages * page
    unique = (min(shared, max(lens)) if shared else 0) + sum(
        max(n - shared, 0) for n in lens)
    fixed = 2 * q.numel() * 2 + table.numel() * 4 + kv_len.numel() * 4
    return unique * per + fixed, sum(lens) * per + fixed


def turn(tree: str, iters: int, only) -> dict:
    """One tree's checks and times, in this process."""
    sys.path.insert(0, tree)
    sys.path.insert(1, ROOT)
    import torch

    import chip_smoke as cs
    from video3d_tpu_torch.bench import timing
    from video3d_tpu_torch.kernels import decode_attention as da
    from video3d_tpu_torch.kernels import paged_attention as pa

    assert da.__file__.startswith(os.path.abspath(tree)), da.__file__
    dev = torch.device("cuda", 0)
    res = {}
    for seed, (name, kernel, form, what) in enumerate(_shapes()):
        if only and not any(o in name for o in only):
            continue
        g = torch.Generator(device=dev).manual_seed(100 + seed)
        if kernel == "B3":
            lens, S = {"b1": ([6812], DENSE_S), "b8": (B8_LENS, DENSE_S),
                       "long": ([32760], 32768)}[what]
            args = _flat_inputs(g, dev, form, lens, S)
            call, plain = da.decode_attention, da.decode_attention_plain
            dram = logical = _flat_bytes(args)
        else:
            if what == "serve":
                args = cs._paged_inputs(g, dev, form)
                dram, logical = _paged_bytes(args, cs.PAGED_PREFIX_PAGES,
                                             cs.PAGED_PAGE)
            else:
                lens = cs.LONG_PAGED_LENS
                own = [min(256, -(-(n + 16) // cs.PAGED_PAGE)) for n in lens]
                args = cs._paged_inputs(g, dev, form, lens=lens,
                                        prefix_pages=0, maxp=256, own=own)
                dram, logical = _paged_bytes(args, 0, cs.PAGED_PAGE)
            call, plain = pa.paged_decode_attention, pa.paged_attention_plain
        out = call(*args)
        again = call(*args)
        ref = plain(args[0].float(), *args[1:])
        err = float((out.float() - ref).abs().max())
        res[name] = {
            "max_err": err, "same_bits": bool(torch.equal(out, again)),
            "ms": timing.median_ms(lambda: call(*args), iters),
            "ms_l2_flushed": timing.median_ms(lambda: call(*args), iters,
                                              flush_l2_cache=True),
            "dram_bytes": dram, "logical_bytes": logical,
            "bound_ms": dram / HBM_BYTES_PER_S * 1e3}
        del args, out, again, ref
        torch.cuda.empty_cache()
    return res


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--parent",
                    help="a tree holding the other video3d_tpu_torch")
    ap.add_argument("--iters", type=int, default=30)
    ap.add_argument("--only", nargs="*", default=(),
                    help="time only the shapes whose names hold one of these")
    ap.add_argument("--turn", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.turn:
        print(json.dumps(turn(args.turn, args.iters, args.only)))
        return
    if not args.parent:
        ap.error("--parent DIR is required")
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("decode_attention_ab: needs a CUDA device")
    trees = {"parent": os.path.abspath(args.parent), "change": ROOT}
    turns = ["parent", "change", "change", "parent"]
    runs = []
    for tag in turns:
        res = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--turn", trees[tag],
             "--iters", str(args.iters), "--only", *args.only],
            capture_output=True, text=True, cwd=ROOT)
        if res.returncode:
            raise SystemExit(f"{tag} turn failed:\n{res.stdout}"
                             f"{res.stderr[-6000:]}")
        runs.append(json.loads(res.stdout.strip().splitlines()[-1]))
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    result = {"device": torch.cuda.get_device_name(0), "nvidia-smi": smi,
              "turns": turns, "shapes": {}}
    ok = True
    for name in runs[0]:
        rows = [r[name] for r in runs]
        par = min(r["ms_l2_flushed"] for t, r in zip(turns, rows)
                  if t == "parent")
        chg = min(r["ms_l2_flushed"] for t, r in zip(turns, rows)
                  if t == "change")
        entry = {"ms": [r["ms"] for r in rows],
                 "ms_l2_flushed": [r["ms_l2_flushed"] for r in rows],
                 "max_err": [r["max_err"] for r in rows],
                 "same_bits": [r["same_bits"] for r in rows],
                 "change_over_parent_flushed": chg / par,
                 "dram_bytes": rows[0]["dram_bytes"],
                 "logical_bytes": rows[0]["logical_bytes"],
                 "bound_ms": rows[0]["bound_ms"],
                 "change_share_of_bound": rows[0]["bound_ms"] / chg}
        ok &= all(e <= BF16_ATOL for e in entry["max_err"])
        result["shapes"][name] = entry
        print(f"{name}: flushed {['%.4f' % x for x in entry['ms_l2_flushed']]}"
              f" warm {['%.4f' % x for x in entry['ms']]} ms; change / "
              f"parent {chg / par:.3f}; {chg / rows[0]['bound_ms']:.1f}x "
              f"the bound; err {max(entry['max_err']):.2e}; same bits "
              f"{entry['same_bits']}", flush=True)
    result["within bounds"] = ok
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(ROOT, "chiprun_out", "decode_attention_ab.json"),
              "w") as f:
        json.dump(result, f, indent=1)
    print(json.dumps(result))
    if not ok:
        raise SystemExit("decode_attention_ab: a tree's output is out of "
                         "bounds")


if __name__ == "__main__":
    main()
