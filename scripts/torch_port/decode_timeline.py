"""Timelines inside the decode-attention kernel (B3 / B7,
``csrc/decode_sm90.cuh``) on one CUDA GPU:

    python3 scripts/torch_port/decode_timeline.py [--iters 30]

The script copies ``video3d_tpu_torch`` into a temporary directory, adds
``%globaltimer`` stores to the copy's kernel at fixed points (kernel entry;
the CTA's walk read from kv_len; the prologue's copies issued; q
converted; for warp 0's first 24 blocks: the copy issue started and ended,
the block landed and was computed; the stream ended; the slices announced;
the merge done) and two ``extern "C"`` entries that read the stores back,
builds it, and runs warm calls at ``chip_smoke.py`` phase 3's shapes (2
cache layers): B3 bf16 / int8 / int4 at B=1 (kv_len 6812) and B=8 (~6.8k
each), B7 bf16 / int8 / int4 over the 8 serving slots, B3 bf16 with every
row empty (the fixed cost of a launch), and B3 at B=1 over 11-33 splits
per kv head (the split count against the merge). For each it prints the
median and worst CTA of every phase, in us from the first CTA's start, and
the call's warm and L2-flushed ms; everything goes to
``chiprun_out/decode_timeline.json``. The anchors follow the kernel's
source: the script raises if one is missing.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import shutil
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
SLOTS = 128            # trace words per CTA
MAX_CTAS = 600

# (anchor in decode_sm90.cuh, text inserted after it)
PROBES = [
    ("namespace v3d_decode {\n",
     f"static __device__ unsigned long long g_trace[{MAX_CTAS} * {SLOTS}];\n"
     "__device__ __forceinline__ unsigned long long gtime() {\n"
     "  unsigned long long t;\n"
     "  asm volatile(\"mov.u64 %0, %%globaltimer;\" : \"=l\"(t));\n"
     "  return t;\n}\n"
     f"#define TR(slot) g_trace[(blockIdx.y * p.splits + blockIdx.x) * "
     f"{SLOTS} + (slot)] = gtime()\n"),
    ("  const uint32_t ring_s = smem_u32(ring);\n",
     "  if (tid == 0) TR(0);\n"),
    ("  bool more = walk.next(sg);\n", "  if (tid == 0) TR(101);\n"),
    ("  for (int k = 0; k < kDepth - 1; ++k) issue();\n",
     "  if (tid == 0) TR(102);\n"),
    ("  q_frags<T>(p, raw, qb);\n", "  if (tid == 0) TR(103);\n"),
    ("    while (use.has && use.seg == si) {\n",
     "      if (tid == 0 && used < 24) TR(1 + used);\n"),
    ("      issue();                                // block used + kDepth - 1\n",
     "      if (tid == 0 && used < 24) TR(25 + used);\n"),
    ("      cp_async_wait<kDepth - 1>();            // block `used` has landed\n"
     "      __syncwarp();\n",
     "      if (tid == 0 && used < 24) TR(49 + used);\n"),
    ("      __syncwarp();                           // before its slot is refilled\n",
     "      if (tid == 0 && used < 24) TR(73 + used);\n"),
    ("    more = walk.next(sg);\n  }\n",
     f"  if (tid == 0) {{\n    TR(97);\n    g_trace[(blockIdx.y * p.splits + "
     f"blockIdx.x) * {SLOTS} + 100] = used;\n  }}\n"),
    ("  named_sync(kMergeBar, kThreads);\n  int phase = 0;\n",
     "  if (tid == 0) TR(98);\n"),
    ("                base, merge_capacity<T>(), merge_bar, phase);\n",
     "  if (tid == 0) TR(99);\n"),
]
READ_BACK = '''
extern "C" int {name}(void* dst, long long bytes) {{
  return static_cast<int>(cudaMemcpyFromSymbol(dst, v3d_decode::g_trace,
                                               bytes));
}}
extern "C" int {name}_clear() {{
  static unsigned long long zeros[{n}];
  return static_cast<int>(cudaMemcpyToSymbol(v3d_decode::g_trace, zeros,
                                             sizeof(zeros)));
}}
'''


def instrumented_copy(dst: str) -> None:
    """The package at dst/video3d_tpu_torch with the probes in."""
    pkg = os.path.join(dst, "video3d_tpu_torch")
    shutil.copytree(os.path.join(ROOT, "video3d_tpu_torch"), pkg,
                    ignore=shutil.ignore_patterns("_build", "__pycache__"))
    path = os.path.join(pkg, "csrc", "decode_sm90.cuh")
    src = open(path).read()
    for anchor, text in PROBES:
        if src.count(anchor) != 1:
            raise SystemExit(f"decode_timeline: anchor not found once: "
                             f"{anchor!r}")
        src = src.replace(anchor, anchor + text)
    open(path, "w").write(src)
    for cu, name in (("decode_attention.cu", "v3d_decode_trace"),
                     ("paged_attention.cu", "v3d_paged_trace")):
        with open(os.path.join(pkg, "csrc", cu), "a") as f:
            f.write(READ_BACK.format(name=name, n=MAX_CTAS * SLOTS))


def _summary(t, ctas: int) -> dict:
    """Median and worst CTA of each phase, us from the first start."""
    import numpy as np

    t = t[:ctas].astype(np.int64)
    t0 = t[:, 0].min()

    def at(k):
        v = t[:, k]
        v = v[v > 0]
        return [] if v.size == 0 else (v - t0) / 1e3

    def mm(v):
        return None if len(v) == 0 else [float(np.median(v)), float(max(v))]

    out = {"walk read (kv_len)": mm(at(101)), "prologue issued": mm(at(102)),
           "q converted": mm(at(103)), "stream ended": mm(at(97)),
           "slices announced": mm(at(98)), "merge done": mm(at(99))}
    issue, land, comp = [], [], []
    for c in range(ctas):
        for q in range(min(int(t[c, 100]), 24)):
            if t[c, 1 + q] and t[c, 73 + q]:
                issue.append((t[c, 25 + q] - t[c, 1 + q]) / 1e3)
                land.append((t[c, 49 + q] - t[c, 25 + q]) / 1e3)
                comp.append((t[c, 73 + q] - t[c, 49 + q]) / 1e3)
    out.update({"block: copies issued": mm(issue),
                "block: wait to land": mm(land),
                "block: computed": mm(comp)})
    merges = [(t[c, 99] - t[c, 98]) / 1e3 for c in range(ctas)
              if t[c, 99] and t[c, 98]]
    out["merge (last CTA of a row)"] = mm(merges)
    return out


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--iters", type=int, default=30)
    args = ap.parse_args()
    tmp = tempfile.mkdtemp(prefix="decode_timeline_")
    instrumented_copy(tmp)
    sys.path.insert(0, tmp)
    sys.path.insert(1, ROOT)
    import numpy as np
    import torch

    import chip_smoke as cs
    from video3d_tpu_torch.bench import timing
    from video3d_tpu_torch.kernels import _build
    from video3d_tpu_torch.kernels import decode_attention as da
    from video3d_tpu_torch.kernels import paged_attention as pa

    if not torch.cuda.is_available():
        raise SystemExit("decode_timeline: needs a CUDA device")
    cs.CACHE_LAYERS = 2
    dev = torch.device("cuda", 0)
    lib = _build.library()
    buf = np.zeros(MAX_CTAS * SLOTS, dtype=np.uint64)
    for name in ("v3d_decode_trace", "v3d_paged_trace"):
        getattr(lib, name).argtypes = [ctypes.c_void_p, ctypes.c_longlong]
    result = {"device": torch.cuda.get_device_name(0), "calls": {}}

    def run(label, kind, fn, ctas):
        fn()
        torch.cuda.synchronize()
        getattr(lib, f"v3d_{kind}_trace_clear")()
        fn()
        torch.cuda.synchronize()
        getattr(lib, f"v3d_{kind}_trace")(buf.ctypes.data, buf.nbytes)
        r = {"ms warm": timing.median_ms(fn, args.iters),
             "ms L2 flushed": timing.median_ms(fn, args.iters,
                                               flush_l2_cache=True),
             **_summary(buf.reshape(MAX_CTAS, SLOTS), ctas)}
        result["calls"][label] = r
        print(label, json.dumps(r), flush=True)

    g = torch.Generator(device=dev).manual_seed(3)
    NL, H, KV, hd, S = 2, 28, 4, 128, 8704
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    empty = torch.zeros(1, dtype=torch.int32, device=dev)
    q = torch.randn(1, 1, H, hd, generator=g, device=dev).bfloat16()
    k = torch.randn(NL, 1, S, KV * hd, generator=g, device=dev).bfloat16()
    run("B3 bf16, every row empty", "decode",
        lambda: da.decode_attention(q, k, k, empty, 1, KV), sms)
    for B, lens in ((1, [6812]), (8, cs.B8_LENS)):
        q = (cs.Q_SCALE * torch.randn(B, 1, H, hd, generator=g,
                                      device=dev)).bfloat16()
        kv_len = torch.tensor(lens, dtype=torch.int32, device=dev)
        for form in ("bf16", "int8", "int4"):
            if form == "bf16":
                k = torch.randn(NL, B, S, KV * hd, generator=g,
                                device=dev).bfloat16()
                ks = None
            else:
                k, ks = cs._int8_cache(g, dev, (NL, B, S), KV, hd,
                                       bits=8 if form == "int8" else 4)
            call = (lambda a=(q, k, k, kv_len, 1, KV, ks, ks):
                    da.decode_attention(*a))
            run(f"B3 {form} B={B}", "decode", call, sms)
            if B == 1 and form == "bf16":
                plan = da.decode_plan
                for splits in (33, 26, 22, 16, 11):
                    da.decode_plan = (lambda b_, kv_, cap, n, s=splits:
                                      da.DecodePlan(b_, kv_, cap, s))
                    run(f"B3 bf16 B=1, {splits} splits", "decode", call,
                        splits * KV)
                da.decode_plan = plan
            del k, ks
            torch.cuda.empty_cache()
    for form in ("bf16", "int8", "int4"):
        pargs = cs._paged_inputs(g, dev, form)
        run(f"B7 {form} 8 slots", "paged",
            lambda a=pargs: pa.paged_decode_attention(*a), sms)
        del pargs
        torch.cuda.empty_cache()
    result["card"] = timing.device_info(dev)
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(ROOT, "chiprun_out", "decode_timeline.json"),
              "w") as f:
        json.dump(result, f, indent=1, default=str)
    shutil.rmtree(tmp, ignore_errors=True)


if __name__ == "__main__":
    main()
