"""The decode loops as captured CUDA graphs: the counterpart of the JAX
package's jitted loops, each compiled to one device program
(``generate_from_state``'s ``lax.while_loop``, ``decode_chunk`` and
``paged_decode_chunk``'s ``lax.scan``).

On the card, a chunk of decode steps is captured once into a
``torch.cuda.CUDAGraph`` and then replayed: the host launches one graph per
chunk instead of every kernel of every step. A graph reads and writes the
addresses it was captured with, so it runs on a *static* state whose
tensors (``next_logits``, ``pos``, ``done``, the cache or the pools and
``lens``) are updated in place, and writes its tokens into a static
(S, chunk) buffer. The state of a graph is held by an :class:`Entry` of a
:class:`DecodeGraphs` holder:

* a decode chunk (the batcher's persistent state) *adopts* the caller's
  state: the entry holds those very tensors, and admission writes them in
  place between replays;
* ``generate_from_state`` (a fresh prefill per call) *copies* the caller's
  state into the entry of its shapes, whose first caller's cache became the
  entry's own, so later calls of the same shapes replay the same graphs.

Each graph is known by a :class:`GraphKey`. The first chunk of a key runs
eagerly on the holder's capture stream (the warm-up: lazy initialisation,
cuBLAS's handle and workspace for that stream, the kernels' buffers), the
stream's split buffers are reserved at the largest plans of the step
(:func:`step_buffers`, ``_launch.reserve``), and the same chunk is
captured, with ``capture_error_mode="thread_local"`` (the batcher decodes
from its own thread). Every later chunk of that key replays, on the same
stream, so all work that uses the stream's split buffers runs in its
order; each graph keeps the buffers it was captured with
(``_launch.held``), so a later warm-up that grows them frees nothing a
graph reads. The warm-up's launches are real and count once; a capture
launches nothing, and its launch counts, held with the graph, are added
once per replay. A capture or replay failure raises: there is no eager
retry.

A decode loop runs captured only when its caller passes a holder (the
engine, the batcher and the benchmarks keep one); without one it runs
eagerly, since a graph captured for one call would never replay. A holder
serves one thread at a time (its ``lock``) and keeps at most MAX_ENTRIES
static states, least recently used dropped first.
"""

from __future__ import annotations

import contextlib
import threading
import time
from collections import OrderedDict
from typing import Callable, Dict, NamedTuple, Optional, Tuple

import torch

from video3d_tpu_torch.kernels import _build, _launch
from video3d_tpu_torch.kernels import quant_matvec as qm
from video3d_tpu_torch.kernels.decode_attention import decode_plan
from video3d_tpu_torch.models import quant

#: decode steps per captured chunk of ``generate_from_state`` (the
#: batcher's chunk; PERF.md records the choice)
DECODE_CHUNK = 8
#: entries (static states and their graphs) a holder keeps, least recently
#: used dropped first: an engine's keys are its batch's rows (1 to 8 at
#: ``run_generative``'s ``batch_size`` of 8; a scene's first question and
#: its last chunk take the others) at one cache length (a 32-frame
#: prompt's bucket), so 8 keeps every key of such a pass (PERF.md gives
#: the keys a pass made and the memory the entries hold)
MAX_ENTRIES = 8


class GraphKey(NamedTuple):
    """What a captured decode chunk depends on: equal keys replay one
    graph."""

    kind: str              # "generate", "dense" or "paged"
    slots: int             # rows of the state
    chunk: Optional[int]   # steps of the graph (None: an entry's key)
    cache_form: str        # "bf16", "int8", "int4" (or another dtype)
    layout: str            # "dense" or "paged"
    weight_form: str       # "bf16", "int8", "int4" (or another dtype)
    cache_shape: tuple     # dense (layers, S, length, width); paged the
                           # pools' and the page table's shapes
    storage: tuple         # data_ptr of every state tensor and the weights
    eos: int
    warp: Optional[tuple] = None   # sampling settings (None: greedy)


_CACHE_FORMS = {torch.bfloat16: "bf16", torch.int8: "int8",
                torch.uint8: "int4"}


def _dtype_name(dtype) -> str:
    return str(dtype).replace("torch.", "")


def weight_form(params) -> str:
    """The weights' form by the head ("bf16", "int8", "int4", "w8a8"), with
    "+lora" when the decoder's projections are ``LoraAdapted`` (the head
    is never adapted)."""
    head = params["llm"]["lm_head"]
    if isinstance(head, quant.Int4Weight):
        form = "int4"
    elif isinstance(head, quant.W8A8Weight):
        form = "w8a8"
    elif quant.is_quantized(head):
        form = "int8"
    else:
        form = _CACHE_FORMS.get(head.dtype, _dtype_name(head.dtype))
    layers = params["llm"].get("layers") or [{}]
    if any(isinstance(w, quant.LoraAdapted)
           for w in layers[0].get("attn", {}).values()):
        form += "+lora"
    return form


def state_tensors(state):
    """Every tensor of a dense or paged decode state, in a fixed order."""
    out = [state.next_logits]
    out += [t for t in state.cache if t is not None]
    out += [t for t in state[2:] if isinstance(t, torch.Tensor)]
    return out


def graph_key(kind: str, params, state, chunk: Optional[int],
              eos: int, warp: Optional[tuple] = None) -> GraphKey:
    """``warp``: the decode's sampling settings, as JAX's static
    ``temperature`` / ``top_p`` / ``top_k`` (and here the seed), or None
    when greedy: a greedy and a sampled chunk never share a graph."""
    cache = state.cache
    paged = hasattr(cache, "page_table")
    shape = ((tuple(cache.k.shape), tuple(cache.page_table.shape)) if paged
             else tuple(cache.k.shape))
    storage = tuple(t.data_ptr() for t in state_tensors(state)) + \
        (params["llm"]["embed_tokens"].data_ptr(),)
    return GraphKey(kind, int(state.next_logits.shape[0]), chunk,
                    _CACHE_FORMS.get(cache.k.dtype,
                                     _dtype_name(cache.k.dtype)),
                    "paged" if paged else "dense", weight_form(params),
                    shape, storage, int(eos), warp)


def _weight_plan(w, rows: int, sms: int):
    """The plan of the weight-streaming kernel ``quant.matmul`` sends a
    ``rows``-row product with ``w`` to on the card, or None (a dense
    weight, or more rows than the kernels take). A ``LoraAdapted`` weight
    is planned by its base: its low-rank delta is two dense products. A
    ``W8A8Weight`` streams through no kernel of the port (its product is
    ``torch._int_mm``)."""
    if isinstance(w, quant.LoraAdapted):
        w = w.base
    if rows > quant.KERNEL_MAX_ROWS or not quant.is_quantized(w) \
            or isinstance(w, quant.W8A8Weight):
        return None
    if isinstance(w, quant.Int4Weight):
        return qm.stream_plan(rows, 2 * w.q4.shape[0], w.q4.shape[1], sms, 4)
    in_, out = w["q"].shape
    if rows == 1 and out >= quant.MATVEC_MIN_OUT:
        return qm.matvec_plan(in_, out, sms)
    return qm.stream_plan(rows, in_, out, sms, 8)


def step_buffers(params, cfg, rows: int, cap: int,
                 sms: int) -> Tuple[int, int]:
    """(arrival counters, workspace bytes) one decode step of ``rows`` rows
    over ``cap`` positions per row (a paged step: ``maxp * page``) asks of
    its stream: the largest of the plans of B3 / B7 (``decode_plan`` at the
    model's head width, over ``cap`` positions a row: a paged step's
    ``maxp * page``) and of the weight-streaming kernels at every
    projection and the head (a MoE layer's expert stacks stay dense). The
    plans read shapes alone, so a captured step allocates nothing and
    reads no kv_len or page table on the host."""
    llm_cfg = cfg.llm
    plan = decode_plan(rows, llm_cfg.num_key_value_heads, cap, sms,
                       llm_cfg.head_dim)
    counters, nbytes = plan.counters, plan.workspace_bytes
    llm = params["llm"]
    layer = llm["layers"][0]
    for w in (*layer["attn"].values(), *layer.get("mlp", {}).values(),
              llm["lm_head"]):
        p = _weight_plan(w, rows, sms)
        if p is not None and p.workspace_bytes:
            counters = max(counters, p.tiles * qm.STREAM_PAIRS)
            nbytes = max(nbytes, p.workspace_bytes)
    return counters, nbytes


class CudaGraph:
    """One ``torch.cuda.CUDAGraph`` captured on ``stream``."""

    def __init__(self, stream):
        self.graph = torch.cuda.CUDAGraph()
        self.stream = stream

    def capture(self, body: Callable[[], None]) -> None:
        with torch.cuda.graph(self.graph, stream=self.stream,
                              capture_error_mode="thread_local"):
            body()

    def replay(self) -> None:
        self.graph.replay()


class Replay(NamedTuple):
    graph: object
    launches: Dict[str, int]   # kernel launches of one replay
    buffers: tuple             # the split buffers it reads (_launch.held)


class Entry:
    """A static state, the buffers its graphs write (tokens per chunk
    length; ``lengths`` for ``generate_from_state``) and its graphs by
    chunk length. Holds the weights its graphs read."""

    def __init__(self, state, params, lengths=None):
        self.state = state
        self.params = params
        self.lengths = lengths
        self.toks: Dict[int, torch.Tensor] = {}
        self.graphs: Dict[int, Replay] = {}

    def tokens(self, n: int) -> torch.Tensor:
        """The static (S, n) token buffer of n-step chunks."""
        buf = self.toks.get(n)
        if buf is None:
            buf = self.toks[n] = torch.empty(
                (self.state.next_logits.shape[0], n), dtype=torch.long,
                device=self.state.next_logits.device)
        return buf


class DecodeGraphs:
    """The captured decode chunks of one owner (an engine, a batcher state,
    a benchmark), with the static states they run on. ``graph_type``
    stands in for :class:`CudaGraph` in tests."""

    def __init__(self, device, graph_type=None):
        self.device = torch.device(device)
        if self.device.type == "cuda" and self.device.index is None:
            # the kernels key their buffers by their tensors' "cuda:i"
            self.device = torch.device("cuda", torch.cuda.current_device())
        self.stream = (torch.cuda.Stream(self.device)
                       if self.device.type == "cuda" else None)
        # the key of the capture stream's split buffers in ``_launch``
        self.stream_id = (self.stream.cuda_stream
                          if self.stream is not None else None)
        self._graph_type = graph_type or CudaGraph
        self._entries: "OrderedDict[GraphKey, Entry]" = OrderedDict()
        self.lock = threading.RLock()
        self.keys_seen = set()       # every entry key asked for
        self.captures = 0
        self.replays = 0
        self.evictions = 0
        self.capture_seconds = 0.0   # host time of the captures
        self.pool_bytes = 0          # device memory reserved by captures

    def stats(self) -> dict:
        """Keys asked for, captures (misses), replays (hits), evictions,
        and the device bytes the held states and the graphs' pools keep."""
        own = sum(t.numel() * t.element_size()
                  for e in self._entries.values() if e.lengths is not None
                  for t in state_tensors(e.state))
        return {"keys": len(self.keys_seen), "entries": len(self._entries),
                "captures": self.captures, "replays": self.replays,
                "evictions": self.evictions, "held_state_bytes": own,
                "pool_bytes": self.pool_bytes}

    def _put(self, key: GraphKey, entry: Entry) -> Entry:
        self._entries[key] = entry
        while len(self._entries) > MAX_ENTRIES:
            self._entries.popitem(last=False)   # its graphs go with it
            self.evictions += 1
        return entry

    def adopt(self, kind: str, params, state, eos: int,
              warp: Optional[tuple] = None) -> Entry:
        """The entry whose static state is ``state`` itself (a decode
        chunk's persistent state)."""
        key = graph_key(kind, params, state, None, eos, warp)
        self.keys_seen.add(key)
        entry = self._entries.get(key)
        if entry is None:
            return self._put(key, Entry(state, params))
        self._entries.move_to_end(key)
        return entry

    def bind(self, params, state, eos: int,
             warp: Optional[tuple] = None) -> Entry:
        """The entry of ``generate_from_state`` for a dense state of these
        shapes, holding a copy of ``state`` (the first caller's cache
        becomes the entry's own) and zeroed lengths."""
        key = graph_key("generate", params, state, None, eos, warp)
        key = key._replace(storage=key.storage[-1:])
        self.keys_seen.add(key)
        entry = self._entries.get(key)
        if entry is None:
            own = type(state)(state.next_logits.clone(), state.cache,
                              state.pos.long().clone(), state.done.clone(),
                              state.step.clone())
            return self._put(key, Entry(own, params, torch.zeros(
                own.pos.shape, dtype=torch.long, device=own.pos.device)))
        self._entries.move_to_end(key)
        own = entry.state
        if own.cache.k.data_ptr() != state.cache.k.data_ptr():
            for dst, src in zip(own.cache, state.cache):
                if dst is not None:
                    dst.copy_(src)
        own.next_logits.copy_(state.next_logits)
        own.pos.copy_(state.pos)
        own.done.copy_(state.done)
        own.step.copy_(state.step)
        entry.lengths.zero_()
        return entry

    @contextlib.contextmanager
    def _on_capture_stream(self):
        if self.stream is None:
            yield
            return
        here = torch.cuda.current_stream(self.device)
        self.stream.wait_stream(here)
        with torch.cuda.stream(self.stream):
            yield
        here.wait_stream(self.stream)

    def _reserved(self, release: bool = False) -> int:
        """Device bytes the caching allocator holds; ``release``: its free
        cache returned first (as the capture itself does on entry), so the
        growth across a capture is the graph's pool."""
        if self.stream is None:
            return 0
        if release:
            torch.cuda.synchronize(self.device)
            torch.cuda.empty_cache()
        return torch.cuda.memory_reserved(self.device)

    def run(self, entry: Entry, n: int, body: Callable[[], None],
            buffers: Callable[[], Tuple[int, int]]) -> None:
        """One n-step chunk of ``entry`` on the capture stream: a replay of
        its graph, or, the first time, the warm-up (``body()`` itself) and
        the capture. ``buffers()``: :func:`step_buffers` of the step."""
        replay = entry.graphs.get(n)
        if replay is not None:
            with self._on_capture_stream():
                replay.graph.replay()
            _build.add_launches(replay.launches)
            self.replays += 1
            return
        with self._on_capture_stream():
            body()
            if self.stream_id is not None:
                _launch.reserve(self.device, self.stream_id, *buffers())
        graph = self._graph_type(self.stream)
        reserved = self._reserved(release=True)
        t0 = time.perf_counter()
        with _build.capturing_launches() as launches:
            graph.capture(body)
        self.capture_seconds += time.perf_counter() - t0
        self.pool_bytes += max(0, self._reserved() - reserved)
        held = (_launch.held(self.device, self.stream_id)
                if self.stream_id is not None else ())
        entry.graphs[n] = Replay(graph, launches, held)
        self.captures += 1


def resolve_capture(capture: Optional[bool], device,
                    graphs: Optional[DecodeGraphs]) -> bool:
    """Whether a decode loop runs captured: by default when the caller
    passes a holder (``graphs``) and the device is CUDA. Asked for on
    another device, or without a holder to keep the graphs, it raises."""
    on_card = torch.device(device).type == "cuda"
    if capture is None:
        return on_card and graphs is not None
    if capture and not on_card:
        raise ValueError(f"a captured decode loop needs a CUDA device, not "
                         f"{device} (pass capture=False)")
    if capture and graphs is None:
        raise ValueError("a captured decode loop keeps its graphs in a "
                         "holder: pass graphs=DecodeGraphs(device)")
    return bool(capture)
