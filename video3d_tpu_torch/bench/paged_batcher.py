"""Dense vs paged S-slot decode (the serving cache), steady state.
Counterpart of the JAX package's ``scripts/bench/paged_batcher.py``:

    python -m video3d_tpu_torch.bench.paged_batcher dense|paged [--slots 8]
        [--cache-len 4096] [--chunk 256] [--int8] [--layers 28 --w-int8]
        [--page 128] [--long-slots 1]

``--long-slots`` slots sit at ``cache_len - chunk - 8`` live tokens, the
rest at 512 (the mix paging exists for). ``dense`` decodes over one cache
row of ``cache_len`` slots per slot (kernel B3); ``paged`` over a page pool
sized for the mix, each slot holding the pages it needs (kernel B7), and
prints the pool's size against the dense rows'. One warm-up chunk, then the
slots are set back to their lengths and one timed chunk runs; ms per step
and tokens/s over all slots, on the host clock around a synchronized chunk.
On the card the chunk runs twice over: captured (the warm-up captures a
CUDA graph of the chunk, the timed chunk replays it: ``models/
decode_graph.py``) and uncaptured (one launch per kernel from the host),
one line each (the CPU: the uncaptured line only). ``--full-grid`` (the TPU kernel's grid A/B)
is not ported (ROADMAP A0b). The JAX script's two 32k rows:

    dense --slots 1 --cache-len 32768 --int8 --layers 28 --w-int8
    paged --slots 8 --cache-len 32768 --long-slots 1 --int8 --layers 28 --w-int8
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import time
from typing import Dict

import numpy as np
import torch

from video3d_tpu_torch.bench import timing
from video3d_tpu_torch.config import ModelConfig
from video3d_tpu_torch.models import generate, qwen2
from video3d_tpu_torch.models.decode_graph import DecodeGraphs
from video3d_tpu_torch.models.paged_kv import (PageAllocator, pages_needed,
                                               set_slot_pages)


def make_cfg(layers: int = 8) -> ModelConfig:
    cfg = ModelConfig()
    return dataclasses.replace(cfg, llm=dataclasses.replace(
        cfg.llm, num_hidden_layers=layers))


def init_llm(cfg: ModelConfig, device, w_int8: bool, seed: int = 0):
    """{"llm": ...}: random bf16 decoder weights (int8 projections and head
    with ``w_int8``) from a seeded generator on ``device``."""
    gen = torch.Generator(device=device).manual_seed(seed)
    return {"llm": qwen2.init_qwen2(cfg.llm, device, gen, torch.bfloat16,
                                    bits=8 if w_int8 else 16)}


def slot_lens(slots: int, cache_len: int, chunk: int,
              long_slots: int) -> np.ndarray:
    lens = np.full((slots,), 512, np.int32)
    lens[:max(1, long_slots)] = cache_len - chunk - 8
    return lens


def dense_state(cfg: ModelConfig, lens: np.ndarray, cache_len: int,
                cache_dtype, device):
    state = generate.empty_decode_state(cfg, len(lens), cache_len,
                                        cache_dtype=cache_dtype,
                                        device=device)
    state.pos.copy_(torch.from_numpy(lens))
    state.done.zero_()
    return state


def paged_state(cfg: ModelConfig, lens: np.ndarray, cache_len: int,
                chunk: int, page: int, cache_dtype, device):
    """The pool sized for the actual mix (+ one chunk of growth), each slot
    holding ``pages_needed(len + chunk + 8)`` pages; returns (state, pool
    pages)."""
    max_pages = cache_len // page
    total = 1 + sum(pages_needed(int(n) + chunk + 8, page) for n in lens)
    state = generate.empty_paged_state(cfg, len(lens), total, page,
                                       max_pages, cache_dtype=cache_dtype,
                                       device=device)
    alloc = PageAllocator(total)
    for s, n in enumerate(lens):
        set_slot_pages(state.cache, s,
                       alloc.alloc(pages_needed(int(n) + chunk + 8, page)))
    state.cache.lens.copy_(torch.from_numpy(lens))
    state.done.zero_()
    return state, total


def _gib(*ts) -> float:
    return sum(t.numel() * t.element_size() for t in ts) / 2 ** 30


def run(params, cfg: ModelConfig, mode: str, device, slots: int = 8,
        cache_len: int = 4096, chunk: int = 256, int8: bool = False,
        page: int = 128, long_slots: int = 1,
        capture: bool = False) -> Dict:
    """One row: ``capture`` replays the timed chunk as a CUDA graph."""
    cache_dtype = torch.int8 if int8 else torch.bfloat16
    lens = slot_lens(slots, cache_len, chunk, long_slots)
    kw = ({"graphs": DecodeGraphs(device)} if capture
          else {"capture": False})
    res = {"mode": f"{mode}{'_int8' if int8 else ''}"
                   f"{'_w8' if isinstance(params['llm']['lm_head'], dict) else ''}"
                   f"_{cfg.llm.num_hidden_layers}L_c{cache_len}"
                   f"_long{long_slots}{'_graph' if capture else ''}",
           "slots": slots, "chunk": chunk, "captured": capture}
    if mode == "dense":
        state = dense_state(cfg, lens, cache_len, cache_dtype, device)
        res["kv_hbm_gib"] = _gib(state.cache.k, state.cache.v)

        def step(st):
            return generate.decode_chunk(params, cfg, st, chunk=chunk,
                                         eos_token_id=-1, **kw)

        def rewind(st):
            st.pos.copy_(torch.from_numpy(lens))
    else:
        state, total = paged_state(cfg, lens, cache_len, chunk, page,
                                   cache_dtype, device)
        gib = _gib(state.cache.k, state.cache.v)
        res.update(kv_hbm_gib=gib, pool_pages=total,
                   dense_rows_gib=gib * slots * (cache_len // page) / total)

        def step(st):
            return generate.paged_decode_chunk(params, cfg, st, chunk=chunk,
                                               eos_token_id=-1, **kw)

        def rewind(st):
            st.cache.lens.copy_(torch.from_numpy(lens))
    state, _ = step(state)                       # warm-up (and capture)
    with torch.inference_mode():                 # the chunk's tensors are
        rewind(state)                            # inference tensors
    timing.synchronize(device)
    t0 = time.perf_counter()
    state, toks = step(state)
    timing.synchronize(device)
    dt = time.perf_counter() - t0
    res.update(ms_per_step=dt * 1e3 / chunk,
               tok_per_s_total=slots * chunk / dt,
               last_tokens=toks[:, -1].tolist())
    return res


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("mode", choices=["dense", "paged"])
    ap.add_argument("--device", default="cuda:0")
    ap.add_argument("--slots", type=int, default=8)
    ap.add_argument("--cache-len", type=int, default=4096)
    ap.add_argument("--chunk", type=int, default=256)
    ap.add_argument("--int8", action="store_true")
    ap.add_argument("--layers", type=int, default=8)
    ap.add_argument("--w-int8", action="store_true")
    ap.add_argument("--page", type=int, default=128)
    ap.add_argument("--long-slots", type=int, default=1)
    ap.add_argument("--full-grid", action="store_true")
    a = ap.parse_args(argv)
    if a.full_grid:
        raise NotImplementedError("--full-grid (the TPU kernel's grid A/B, "
                                  "RAGGED_GRID) is not ported (ROADMAP A0b)")
    device = torch.device(a.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("paged_batcher: no CUDA device (pass --device cpu)")
    cfg = make_cfg(a.layers)
    params = init_llm(cfg, device, a.w_int8)
    info = timing.device_info(device)
    for capture in ([True, False] if device.type == "cuda" else [False]):
        res = run(params, cfg, a.mode, device, a.slots, a.cache_len, a.chunk,
                  a.int8, a.page, a.long_slots, capture)
        res["device"] = info
        print(json.dumps(res), flush=True)


if __name__ == "__main__":
    main()
