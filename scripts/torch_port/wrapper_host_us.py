"""Host microseconds per call of the weight-streaming wrappers (B4's B>1
form ``int8_matmul``, B8 ``int4_matmul``) and of ``quant.matmul`` around
them, beside a bf16 ``x @ w`` (the bf16 configuration's call), and of the
decode-attention wrappers (B3 ``decode_attention``, B7
``paged_decode_attention``, bf16 and int8 caches), on one CUDA GPU:

    python3 scripts/torch_port/wrapper_host_us.py [--package DIR] [--tag T]

At the decode projections' shapes (x of 8 rows; w_gate, w_down, wq of
``ModelConfig()``), each call is timed on the host clock: 200 calls
issued while a spin kernel keeps the device busy, so that no call waits on
the device, the median of three such runs. For a tree whose wrappers have
them (``stream_plan``), the pieces of a call are timed too: the argument
checks, the plan (cached), the output allocation, the stream's workspace
and counters (allocated once per stream), the stream lookup, the ctypes
call that encodes the tensor maps and launches the kernel, and the launch
count. The decode-attention wrappers are timed at chip_smoke.py phase 3's
shapes (B3: B=1 over a 28-layer cache of 8704 slots; B7: 8 slots over the
serving pools), with their pieces where the tree has them (``decode_plan``:
the checks, the plan, the output, the stream's workspace and counters, the
ctypes call, the launch count). ``--package DIR`` imports the port from
another tree
(for example an unpacked ``git archive`` of another commit), so two trees
are compared by running the script once per tree, in turns.

Writes ``chiprun_out/wrapper_host_us_<tag>.json``.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
SHAPES = (("w_gate", 3584, 18944), ("w_down", 18944, 3584),
          ("wq", 3584, 3584))
SPIN_CYCLES = 100_000_000     # ~50 ms of device time


def _host_us(fn, calls: int = 200, runs: int = 3) -> float:
    """Host microseconds per call of fn, the median of ``runs`` runs of
    ``calls`` calls, each issued while a ~50 ms spin kernel keeps the
    device busy, so that no call waits on the device, and timed on the
    host clock."""
    import torch

    fn()
    torch.cuda.synchronize()
    per = []
    for _ in range(runs):
        torch.cuda._sleep(SPIN_CYCLES)
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        per.append((time.perf_counter() - t0) / calls * 1e6)
        torch.cuda.synchronize()
    return sorted(per)[runs // 2]


def _attention_wrappers(dev, g) -> dict:
    """Host us per call of B3 and B7's wrappers (bf16 and int8 caches) at
    phase 3's shapes, and of the pieces of a B3 call where the tree plans
    its grid with ``decode_plan``."""
    import torch

    sys.path.insert(1, ROOT)
    import chip_smoke as cs
    from video3d_tpu_torch.kernels import _build
    from video3d_tpu_torch.kernels import decode_attention as da
    from video3d_tpu_torch.kernels import paged_attention as pa

    out = {}
    NL, H, KV, hd, S = 28, 28, 4, 128, 8704
    q = torch.randn(1, 1, H, hd, generator=g, device=dev).bfloat16()
    kv_len = torch.tensor([6812], dtype=torch.int32, device=dev)
    for form in ("bf16", "int8"):
        if form == "bf16":
            k = torch.randn(NL, 1, S, KV * hd, generator=g,
                            device=dev).bfloat16()
            ks = None
        else:
            k, ks = cs._int8_cache(g, dev, (NL, 1, S), KV, hd)
        args = (q, k, k, kv_len, NL - 1, KV, ks, ks)
        r = {"decode_attention": _host_us(lambda: da.decode_attention(
            *args))}
        if hasattr(da, "decode_plan"):
            from video3d_tpu_torch.kernels import _launch

            stream = da._stream(dev)
            sms = _launch.sm_count(0)
            plan = da.decode_plan(1, KV, S, sms)
            name = "decode_attention" + ("" if form == "bf16" else "_int8")
            fn = getattr(_build.library(), "v3d_" + name)
            o = torch.empty_like(q)
            split = da.split_args(plan, dev, stream)
            scales = (ks.data_ptr(), ks.data_ptr()) if ks is not None else ()
            r.update({
                "splits": plan.splits,
                "checks": _host_us(lambda: da.check_cache(
                    "decode_attention", q, k, k, ks, ks, KV)),
                "decode_plan (cached)": _host_us(
                    lambda: da.decode_plan(1, KV, S, sms)),
                "allocate out": _host_us(lambda: torch.empty_like(q)),
                "workspace and counters (per stream)": _host_us(
                    lambda: da.split_args(plan, dev, stream)),
                "raw stream": _host_us(lambda: da._stream(dev)),
                "ctypes call (launch)": _host_us(lambda: fn(
                    q.data_ptr(), k.data_ptr(), k.data_ptr(), *scales,
                    kv_len.data_ptr(), o.data_ptr(), *split, NL - 1, 1, S,
                    H, KV, plan.splits, float(hd ** -0.5), stream)),
                "count_launch": _host_us(
                    lambda: _build.count_launch(name))})
        out[f"B3 {form} B=1"] = r
        print("B3", form, json.dumps(r), flush=True)
        del k, ks, args
        pargs = cs._paged_inputs(g, dev, form)
        r = {"paged_decode_attention": _host_us(
            lambda: pa.paged_decode_attention(*pargs))}
        out[f"B7 {form} 8 slots"] = r
        print("B7", form, json.dumps(r), flush=True)
        del pargs
        torch.cuda.empty_cache()
    return out


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--package", default=ROOT,
                    help="the tree whose video3d_tpu_torch is timed")
    ap.add_argument("--tag", default="change")
    args = ap.parse_args()
    sys.path.insert(0, os.path.abspath(args.package))
    import torch

    from video3d_tpu_torch.kernels import _build
    from video3d_tpu_torch.kernels import quant_matvec as qm
    from video3d_tpu_torch.models import quant

    dev = torch.device("cuda", 0)
    _build.library()
    g = torch.Generator(device=dev).manual_seed(0)
    result = {"tag": args.tag, "package": os.path.abspath(args.package),
              "device": torch.cuda.get_device_name(0)}
    for what, in_, out in SHAPES:
        w = (0.02 * torch.randn(in_, out, generator=g, device=dev)).bfloat16()
        d = quant.quantize_weight(w)
        w4 = quant.quantize_weight_int4(w)
        x = torch.randn(8, 1, in_, generator=g, device=dev).bfloat16()
        r = {"int8_matmul": _host_us(lambda: qm.int8_matmul(
                 x, d["q"], d["scale"])),
             "quant.matmul int8": _host_us(lambda: quant.matmul(x, d)),
             "int4_matmul": _host_us(lambda: qm.int4_matmul(
                 x, w4.q4, w4.scale4)),
             "quant.matmul int4": _host_us(lambda: quant.matmul(x, w4)),
             "bf16 x @ w": _host_us(lambda: x @ w)}
        if hasattr(qm, "stream_plan"):         # the pieces of one call
            from video3d_tpu_torch.kernels import _launch

            args8 = (("x", x, torch.bfloat16), ("q", d["q"], torch.int8),
                     ("scale", d["scale"], torch.bfloat16))
            stream = qm._stream(0)
            sms = _launch.sm_count(0)
            plan = qm.stream_plan(8, in_, out, sms, 8)
            y = torch.empty((8, 1, out), dtype=x.dtype, device=dev)
            ws = _launch.workspace(dev, stream, plan.workspace_bytes)
            ctr = _launch.arrival_counters(dev, stream,
                                           plan.tiles * qm.STREAM_PAIRS)
            fn = _build.library().v3d_int8_matmul
            r.update({
                "ctas": plan.ctas,
                "checks": _host_us(lambda: qm._device_checks(
                    "int8_matmul", x, args8)),
                "stream_plan (cached)": _host_us(
                    lambda: qm.stream_plan(8, in_, out, sms, 8)),
                "allocate y": _host_us(lambda: torch.empty(
                    (8, 1, out), dtype=x.dtype, device=dev)),
                "workspace and counters (per stream)": _host_us(lambda: (
                    _launch.workspace(dev, stream, plan.workspace_bytes),
                    _launch.arrival_counters(dev, stream, plan.tiles * 4))),
                "raw stream": _host_us(lambda: qm._stream(0)),
                "ctypes call (maps, launch)": _host_us(lambda: fn(
                    x.data_ptr(), d["q"].data_ptr(), d["scale"].data_ptr(),
                    y.data_ptr(), ws.data_ptr(), ws.numel() * 4,
                    ctr.data_ptr(), 8, in_, out, plan.ctas, stream)),
                "count_launch": _host_us(
                    lambda: _build.count_launch("int8_matmul"))})
        result[what] = r
        print(args.tag, what, json.dumps(r), flush=True)
    result.update(_attention_wrappers(dev, g))
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(ROOT, "chiprun_out",
                           f"wrapper_host_us_{args.tag}.json"), "w") as f:
        json.dump(result, f, indent=1)


if __name__ == "__main__":
    main()
