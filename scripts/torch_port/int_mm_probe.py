"""The w8a8 product's library call, ``torch._int_mm``, on one CUDA GPU:

    python3 scripts/torch_port/int_mm_probe.py

1. Exactness: at rows 1-64 of a (rows, 3584) x (3584, 512) int8 product
   (the rows under ``quant.W8A8_MIN_ROWS`` zero-padded, as ``quant._int_mm``
   does), the card's int32 sums against the exact float64 product on the
   CPU, and the CPU's own ``torch._int_mm`` against the same; the count of
   wrong sums of each.
2. Layouts: median device ms (``bench/timing.median_ms``: CUDA events,
   each call behind a ~1 ms spin kernel) of ``torch._int_mm`` with the
   weight row-major (in, out) and output-major (the (in, out) view of a
   contiguous (out, in) tensor, ``quant.W8A8Weight``'s layout), beside a
   bf16 ``x @ w``, at Qwen2-7B's decode shapes (32 rows: w_gate, w_down,
   the vocab head) and a 6784-row prefill of w_gate, with the CUDA
   kernels each layout launches (``torch.profiler``).

Prints the card's name and power limit first and one JSON line last.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))

from video3d_tpu_torch.bench import timing  # noqa: E402
from video3d_tpu_torch.models import quant  # noqa: E402

ROWS = (1, 8, 16, 17, 24, 31, 32, 33, 48, 64)
SHAPES = ((32, 3584, 18944), (32, 18944, 3584), (32, 3584, 152064),
          (6784, 3584, 18944))


def _exactness(dev) -> dict:
    g = torch.Generator().manual_seed(0)
    out = {}
    for rows in ROWS:
        a = torch.randint(-127, 128, (rows, 3584), dtype=torch.int8,
                          generator=g)
        b = torch.randint(-127, 128, (3584, 512), dtype=torch.int8,
                          generator=g)
        exact = (a.double() @ b.double()).to(torch.int32)
        card = quant._int_mm(a.to(dev), b.to(dev)).cpu()
        cpu = torch._int_mm(a, b)
        out[rows] = {"card_wrong": int((card != exact).sum()),
                     "cpu_int_mm_wrong": int((cpu != exact).sum())}
    return out


def _kernels(fn) -> list:
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return [e.name[:80] for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CUDA]


def _layouts(dev) -> list:
    g = torch.Generator(device=dev).manual_seed(1)
    rows = []
    for M, K, N in SHAPES:
        a = torch.randint(-127, 128, (M, K), dtype=torch.int8, device=dev,
                          generator=g)
        row_major = torch.randint(-127, 128, (K, N), dtype=torch.int8,
                                  device=dev, generator=g)
        out_major = row_major.t().contiguous().t()
        ab, wb = a.bfloat16(), row_major.bfloat16()
        same = torch.equal(torch._int_mm(a, row_major),
                           torch._int_mm(a, out_major))
        rows.append({
            "shape": [M, K, N], "same_sums": same,
            "row_major_ms": timing.median_ms(
                lambda: torch._int_mm(a, row_major), 10),
            "out_major_ms": timing.median_ms(
                lambda: torch._int_mm(a, out_major), 10),
            "bf16_ms": timing.median_ms(lambda: ab @ wb, 10),
            "row_major_kernels": _kernels(
                lambda: torch._int_mm(a, row_major)),
            "out_major_kernels": _kernels(
                lambda: torch._int_mm(a, out_major))})
        print(json.dumps(rows[-1]), flush=True)
    return rows


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("int_mm_probe: no CUDA device")
    dev = torch.device("cuda", 0)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    res = {"torch": torch.__version__, "cuda": torch.version.cuda,
           "exactness": _exactness(dev), "layouts": _layouts(dev)}
    print(json.dumps(res))


if __name__ == "__main__":
    main()
