"""Launch-time state shared by the kernels' wrappers: SM counts, and per
(device, stream) buffers that grow on demand and are reused by every later
launch on that stream: arrival counters that the split kernels leave
zeroed, and f32 workspaces for split products.

Launches on one stream run in order, so they can share a buffer. A
CUDA graph keeps reading the addresses it was captured with, so:

* a capture must find its stream's buffers already at their largest size
  (:func:`reserve`); a request to grow one during a capture raises;
* a buffer that grows later is replaced for the launches that follow, and
  the graphs captured before keep the old one alive themselves
  (:func:`held`, kept with each graph by ``models/decode_graph.py``).

Nothing here runs at import time (the CPU tests import every module of the
port)."""

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


def _capturing() -> bool:
    """Whether this thread's current CUDA stream is being captured."""
    return torch.cuda.is_available() and \
        torch.cuda.is_current_stream_capturing()


def _grown(buffers: dict, device, stream: int, n: int, dtype,
           zeroed: bool) -> torch.Tensor:
    key = (str(device), stream)
    with _lock:
        buf = buffers.get(key)
        if buf is None or buf.numel() < n:
            if _capturing():
                raise RuntimeError(
                    f"a launch during CUDA-graph capture asks stream "
                    f"{stream} for {n} elements of {dtype}, more than it "
                    f"reserved ({0 if buf is None else buf.numel()}): "
                    f"_launch.reserve the step's sizes before capturing")
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


def reserve(device, stream: int, counters: int,
            workspace_bytes: int) -> None:
    """Make ``stream``'s arrival counters and workspace at least this
    large, before a CUDA-graph capture on it (the sizes of the captured
    launches' plans: ``decode_plan(...).counters`` / ``.workspace_bytes``,
    the weight-streaming plans' tiles and workspace)."""
    arrival_counters(device, stream, counters)
    workspace(device, stream, workspace_bytes)


def held(device, stream: int) -> tuple:
    """The buffers launches on ``stream`` use now: what a graph captured
    on it reads, so the graph keeps them for as long as it can replay."""
    key = (str(device), stream)
    with _lock:
        return tuple(b for b in (_counters.get(key), _workspaces.get(key))
                     if b is not None)
