"""Where the time of a paged decode step goes, against the dense step, on
one CUDA GPU:

    python3 scripts/torch_port/profile_paged_decode.py [--bits 16|8|4]
        [--slots 8] [--steps 8] [--device cuda] [--package DIR]

The decode of ``chip_smoke.py`` phase 8: the Qwen2-7B decoder of
``ModelConfig()`` (random weights from a seeded generator; ``--bits 8``
gives the int8 configuration, int8 projections and lm_head through B4's
B>1 form and an int8 KV cache; ``--bits 4`` the int4 configuration, int4
projections and lm_head through B8 and a bf16 KV cache), ``--slots`` slots of ~6.8k tokens that share a 52-page scene
prefix (pages of 128). The same lengths go into a paged state (the pool
of ``models/paged_kv.py``, read by B7) and a dense one (stacked cache rows
of 8224 positions, read by B3), filled with random K/V. After a warm-up
chunk of each, one ``paged_decode_chunk`` and one ``decode_chunk`` of
``--steps`` steps are timed (host clock, synchronised), then one more of
each runs under ``torch.profiler``, whose host-side recording slows the
step. Prints, for each, the wall ms per step without the profiler, kernels
per step, the device busy share (the kernels' merged intervals over that
wall time), the device ms per step by kernel group (attention kernel,
matrix products, index and copy kernels, other elementwise) and the B7 /
B3 kernels' launches per step by name. Writes
``chiprun_out/profile_paged_decode_<bits>.json``. ``--package DIR`` imports
the port from another tree (``DIR/video3d_tpu_torch``, for example an
unpacked ``git archive`` of the parent commit; ``decode_ab.py`` runs it so).
``--device cpu --tiny`` rehearses the script (device times then read 0).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

# B7 and B3: split_decode_kernel over PagedRows / FlatRows; a parent tree's
# paged_partial_kernel, paged_combine_kernel, decode_partial_kernel and
# decode_combine_kernel (decode_ab.py profiles other trees too)
GROUPS = (("B7 paged attention", ("paged_", "PagedRows")),
          ("B3 decode attention", ("decode_partial", "decode_combine",
                                   "FlatRows")),
          # row_stream_kernel; a parent tree's int8_matvec_kernel
          ("B4 int8 matvec", ("row_stream_kernel", "int8_matvec")),
          # weight_stream_kernel; a parent tree's stream_kernel and
          # combine_kernel (decode_ab.py profiles other trees too)
          ("B4 B>1 (int8) / B8 (int4) weight streaming",
           ("weight_stream_kernel", "stream_kernel", "combine_kernel")),
          ("matrix products", ("gemm", "gemv", "xmma", "cutlass", "nvjet",
                               "cublas", "sm90_")),
          ("index and copy kernels", ("index", "scatter", "gather",
                                      "Memcpy", "Memset", "copy", "fill")),
          ("other elementwise", ("",)))
PAGE, PREFIX_PAGES, PREFIX = 128, 52, 6733


def _group(name: str) -> str:
    for group, keys in GROUPS:
        if any(k in name for k in keys):
            return group
    return GROUPS[-1][0]


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--bits", type=int, default=16, choices=(16, 8, 4))
    ap.add_argument("--slots", type=int, default=8)
    ap.add_argument("--steps", type=int, default=8)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--tiny", action="store_true",
                    help="ModelConfig.tiny() (a CPU rehearsal)")
    ap.add_argument("--package", default=ROOT,
                    help="the tree whose video3d_tpu_torch is profiled")
    args = ap.parse_args()
    sys.path.insert(0, os.path.abspath(args.package))
    import torch
    from torch.profiler import ProfilerActivity, profile

    from video3d_tpu_torch.config import ModelConfig
    from video3d_tpu_torch.models import generate as gen
    from video3d_tpu_torch.models import qwen2
    from video3d_tpu_torch.models.paged_kv import pages_needed

    dev = torch.device(args.device)
    cuda = dev.type == "cuda"

    def sync():
        if cuda:
            torch.cuda.synchronize()

    cfg = ModelConfig.tiny() if args.tiny else ModelConfig()
    dtype = torch.int8 if args.bits == 8 else torch.bfloat16
    g = torch.Generator(device=dev).manual_seed(0)
    params = {"llm": qwen2.init_qwen2(cfg.llm, dev, g, torch.bfloat16,
                                      args.bits)}
    S = args.slots
    lens = [PREFIX + 20 + 17 * s for s in range(S)]
    need = pages_needed(max(lens) + args.steps * 2 + 1, PAGE)
    own = need - PREFIX_PAGES
    paged = gen.empty_paged_state(cfg, S, 1 + PREFIX_PAGES + S * own, PAGE,
                                  need, dtype, device=dev)
    dense = gen.empty_decode_state(cfg, S, need * PAGE, dtype, device=dev)
    with torch.inference_mode():
        for t in (paged.cache.k, paged.cache.v, dense.cache.k,
                  dense.cache.v):
            if dtype == torch.int8:
                t.random_(-127, 128, generator=g)
            else:
                t.normal_(generator=g)
        for t in (paged.cache.k_scale, paged.cache.v_scale,
                  dense.cache.k_scale, dense.cache.v_scale):
            if t is not None:
                t.fill_(0.01)
        for s, n in enumerate(lens):
            first = 1 + PREFIX_PAGES + s * own
            paged.cache.page_table[s] = torch.tensor(
                list(range(1, 1 + PREFIX_PAGES))
                + list(range(first, first + own)), dtype=torch.int32)
            paged.cache.lens[s] = n
            dense.pos[s] = n
        logits = torch.randn(S, cfg.llm.vocab_size, generator=g, device=dev)
        paged.next_logits.copy_(logits)
        dense.next_logits.copy_(logits)
        paged.done.fill_(False)
        dense.done.fill_(False)
    eos = -1                               # no row finishes
    states = {"paged": paged, "dense": dense}
    chunk_fns = {"paged": gen.paged_decode_chunk, "dense": gen.decode_chunk}
    for name, fn in chunk_fns.items():     # warm-up
        states[name], _ = fn(params, cfg, states[name], 1, eos)
    sync()
    result = {"slots": S, "lens": lens, "bits": args.bits,
              "kv_cache": str(dtype), "steps": args.steps}
    if cuda:
        result["device"] = torch.cuda.get_device_name(0)
    for name, fn in chunk_fns.items():
        sync()
        t0 = time.perf_counter()
        states[name], toks = fn(params, cfg, states[name], args.steps, eos)
        toks.tolist()
        sync()
        wall = time.perf_counter() - t0
        activities = [ProfilerActivity.CPU] + (
            [ProfilerActivity.CUDA] if cuda else [])
        with profile(activities=activities) as prof:
            states[name], toks = fn(params, cfg, states[name], args.steps,
                                    eos)
            toks.tolist()
            sync()
        groups, spans = {k: 0.0 for k, _ in GROUPS}, []
        attention = {}      # the attention kernels' names: launches
        for ev in prof.events():
            if ev.device_type.name == "CUDA":
                group = _group(ev.name)
                groups[group] += ev.time_range.elapsed_us() / 1e3
                spans.append((ev.time_range.start, ev.time_range.end))
                if group.startswith(("B7", "B3")):
                    attention[ev.name] = attention.get(ev.name, 0) + 1
        busy, end = 0.0, float("-inf")
        for a, b in sorted(spans):
            if b > end:
                busy += (b - max(a, end)) / 1e3
                end = b
        n = args.steps
        result[name] = {
            "wall_ms_per_step": wall * 1e3 / n,
            "kernels_per_step": len(spans) / n,
            "device_busy_share": busy / (wall * 1e3),
            "device_ms_per_step_by_group": {k: v / n
                                            for k, v in groups.items()},
            "attention_launches_per_step": {k: v / n
                                            for k, v in attention.items()}}
        print(f"{name}: {wall * 1e3 / n:.2f} ms per step of {S} slots; "
              f"{len(spans) / n:.0f} kernels per step, device busy "
              f"{busy / (wall * 1e3):.1%}", flush=True)
        for k, v in groups.items():
            print(f"  {k}: {v / n:.3f} ms per step", flush=True)
    out = os.path.join(ROOT, "chiprun_out")
    os.makedirs(out, exist_ok=True)
    with open(os.path.join(out, f"profile_paged_decode_{args.bits}.json"),
              "w") as f:
        json.dump(result, f, indent=1)
    print(json.dumps(result))


if __name__ == "__main__":
    main()
