"""Host microseconds per call of the weight-streaming wrappers (B4's B>1
form ``int8_matmul``, B8 ``int4_matmul``) and of ``quant.matmul`` around
them, beside a bf16 ``x @ w`` (the bf16 configuration's call), on one CUDA
GPU:

    python3 scripts/torch_port/wrapper_host_us.py [--package DIR] [--tag T]

At the decode projections' shapes (x of 8 rows; w_gate, w_down, wq of
``ModelConfig()``), each call is timed on the host clock: 200 calls
issued while a spin kernel keeps the device busy, so that no call waits on
the device, the median of three such runs. For a tree whose wrappers have
them (``stream_plan``), the pieces of a call are timed too: the argument
checks, the plan (cached), the output allocation, the stream's workspace
and counters (allocated once per stream), the stream lookup, the ctypes
call that encodes the tensor maps and launches the kernel, and the launch
count. ``--package DIR`` imports the port from another tree
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
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(ROOT, "chiprun_out",
                           f"wrapper_host_us_{args.tag}.json"), "w") as f:
        json.dump(result, f, indent=1)


if __name__ == "__main__":
    main()
