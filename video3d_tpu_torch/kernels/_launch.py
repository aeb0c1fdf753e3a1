"""Launch-time state shared by the kernels' wrappers: SM counts, and per
(device, stream) buffers that grow on demand and are reused by every later
launch on that stream: arrival counters that the split kernels leave
zeroed, and f32 workspaces for split products.

Launches on one stream run in order, so they can share a buffer; a later
CUDA-graph capture finds it already allocated. Nothing here runs at import
time (the CPU tests import every module of the port)."""

from __future__ import annotations

import functools
import threading

import torch

_lock = threading.Lock()
_counters = {}     # (device, stream) -> int32 counters, zeroed
_workspaces = {}   # (device, stream) -> float32 workspace


@functools.lru_cache(maxsize=None)
def sm_count(index: int) -> int:
    """SMs of CUDA device ``index``, looked up once."""
    return torch.cuda.get_device_properties(index).multi_processor_count


def _allocate(n: int, dtype, device, zeroed: bool) -> torch.Tensor:
    """The one allocation of a buffer (a test counts them)."""
    make = torch.zeros if zeroed else torch.empty
    return make(n, dtype=dtype, device=device)


def _grown(buffers: dict, device, stream: int, n: int, dtype,
           zeroed: bool) -> torch.Tensor:
    key = (str(device), stream)
    with _lock:
        buf = buffers.get(key)
        if buf is None or buf.numel() < n:
            buf = buffers[key] = _allocate(max(n, 1024), dtype, device,
                                           zeroed)
    return buf


def arrival_counters(device, stream: int, n: int) -> torch.Tensor:
    """At least n zeroed int32 arrival counters for split launches on one
    stream: zeroed once, then left zeroed by every launch (the last CTA of
    each tile resets its own), so a launch needs no memset."""
    return _grown(_counters, device, stream, n, torch.int32, True)


def workspace(device, stream: int, nbytes: int) -> torch.Tensor:
    """An f32 workspace of at least ``nbytes`` bytes for the split launches
    on one stream (each launch writes what it reads)."""
    return _grown(_workspaces, device, stream, -(-nbytes // 4),
                  torch.float32, False)
