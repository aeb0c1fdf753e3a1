"""Timing rules of the port's benchmark and of ``chip_smoke.py``.

* :func:`median_ms`: the median of CUDA-event times of single calls, each
  queued behind a ~1 ms spin kernel so the events time the device work and
  not the host's launch overhead; with ``flush_l2_cache`` a 256 MB buffer
  is written before each call, so the call finds its inputs in HBM and not
  in the 50 MB L2 (a decode kernel's 14 MB of K/V would otherwise stay
  there from one call to the next). The buffer lives for that one
  ``median_ms`` call only, so no later peak-memory figure counts it.
* :func:`wall_ms`: host clock around ``iters`` calls of a whole pipeline,
  synchronized at both ends (what a caller waits for).
* :func:`device_info`: the card's name and power limit as ``nvidia-smi``
  reports them; every number the benchmark prints sits beside them.

The peak rates are one H100 SXM's from NVIDIA's data sheet (dense, at its
700 W limit); a card set to a lower power limit runs slower under load.
"""

from __future__ import annotations

import subprocess
import time
from typing import Callable, Dict, Optional

import torch

#: data-sheet peaks of one H100 SXM: bf16 dense tensor-core FLOP/s, f32
#: FLOP/s outside the tensor cores, HBM bytes/s
H100_BF16_FLOPS = 989e12
H100_F32_FLOPS = 67e12
H100_HBM_BYTES = 3.35e12

#: cycles of the spin kernel queued before each timed call (~1 ms)
SPIN_CYCLES = 2_000_000
#: bytes written to evict the 50 MB L2 before a flushed call
FLUSH_BYTES = 256 << 20


def median_ms(fn: Callable[[], object], iters: int,
              flush_l2_cache: bool = False,
              device: Optional[torch.device] = None) -> float:
    """Median device ms of ``fn()`` over ``iters`` calls after one warm-up
    call; ``flush_l2_cache``: FLUSH_BYTES are written before every timed
    call, so whatever ``fn`` read before is out of the L2."""
    device = device or torch.device("cuda", torch.cuda.current_device())
    flush = (torch.empty(FLUSH_BYTES, dtype=torch.uint8, device=device)
             if flush_l2_cache else None)
    fn()
    torch.cuda.synchronize(device)
    times = []
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        if flush is not None:
            flush.zero_()
        torch.cuda._sleep(SPIN_CYCLES)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    times.sort()
    return times[len(times) // 2]


def synchronize(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def wall_ms(fn: Callable[[], object], iters: int, device: torch.device,
            warmup: int = 1) -> float:
    """Mean host ms per call of ``fn()`` over ``iters`` calls, after
    ``warmup`` calls, synchronized before and after."""
    for _ in range(warmup):
        fn()
    synchronize(device)
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    synchronize(device)
    return (time.perf_counter() - t0) * 1e3 / iters


def device_info(device: torch.device) -> Dict[str, str]:
    """{"name", "power_limit"}: ``nvidia-smi --query-gpu=name,power.limit``
    for a CUDA device (its index), or the CPU named as such."""
    if device.type != "cuda":
        return {"name": "cpu", "power_limit": "none"}
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()
    name, limit = (s.strip() for s in out[device.index or 0].split(","))
    return {"name": name, "power_limit": limit}
