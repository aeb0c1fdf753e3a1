"""A/B of B9a (``kv_probe``, the int8 K/V read probe) between two source
trees, on one CUDA GPU:

    python3 scripts/torch_port/kv_probe_ab.py --parent DIR [--iters 50]
        [--sizes] [--timeline]

``DIR`` holds another tree's ``video3d_tpu_torch`` package (for example a
``git archive`` of the parent commit, unpacked under the git-ignored
``.rehearsal/``). Besides the parent and this tree, the script times one
variant built from a copy of this tree's package in a temporary directory:
``evict first``, whose bulk copies carry an L2 evict-first cache hint.
Turns: parent, change, evict first, evict first, change, parent; each
turn is a fresh process that imports one tree's package and builds its
kernels (into that tree's ``_build/``), then runs B9a on the probe
script's inputs (int8 K and V of (32768, 4, 128) from ``bench/probes.py``'s
seeded generator) at blocks of 4096, 8192 and 16384 tokens: rows and
checksums equal to the plain version and to a second call (the same bits),
the plain version skipping each block's last row different (the control),
and the median of ``--iters`` CUDA-event times under three conditions of
the L2: warm (the 33.6 MB of inputs stay in the 50 MB L2 from one call to
the next), flushed dirty (``timing.median_ms``'s flush: 256 MB written
before each call, so the L2 is full of dirty lines) and flushed clean (256
MB read before each call: the L2 full of clean lines, as after a decode
step's weight reads).

With ``--sizes`` this tree's turns also time B9a at 4096-token blocks over
other sequence lengths (the time against the bytes: the rate beyond a
fixed intercept) and, as the timing's floor, one PyTorch ``add_`` on 16
floats.

With ``--timeline`` a last turn runs a copy of this tree whose B9a kernel
stores ``%globaltimer`` at fixed points of each CTA (entry; the mbarriers
set up; the producer's first copy issued; the first slot landed; the
stream summed; the checksums added) and splits the call, warm and flushed
dirty, into: the CUDA-event time outside the CTAs' span (launch and
drain), the spread of the CTAs' starts, set-up, the first copy's latency,
the stream and the tail (median and worst CTA, us).

Prints one JSON object (per block size and tree the turns' times, the
best dirty-flushed time of each tree, the share of the bound: the 33.6 MB
over the data sheet's 3.35 TB/s) with the card's name and power limit, and
writes it to ``chiprun_out/kv_probe_ab.json``. Exits non-zero when a
tree's rows or checksums differ from the plain version, from a repeat, or
the control does not differ.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import shutil
import subprocess
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
BSS = (4096, 8192, 16384)
TRACE_SLOTS = 8        # timestamps per CTA
MAX_CTAS = 256         # csrc/stream_probe.cu kMaxCtas

_PLAIN_COPY = (
    '      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "\n'
    '      "[%0], [%1], %2, [%3];" ::"r"(smem_u32(dst)),\n'
    '      "l"(src), "r"(bytes), "r"(smem_u32(bar))\n'
    '      : "memory");\n')
# (anchor in csrc/stream_probe.cu, replacement) of each variant
VARIANTS = {
    "evict first": [(
        "  asm volatile(\n" + _PLAIN_COPY,
        "  uint64_t policy;\n"
        "  asm volatile(\"createpolicy.fractional.L2::evict_first.b64 %0, "
        "1.0;\" : \"=l\"(policy));\n"
        "  asm volatile(\n"
        '      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"\n'
        '      ".L2::cache_hint [%0], [%1], %2, [%3], %4;" ::"r"(smem_u32(dst)),\n'
        '      "l"(src), "r"(bytes), "r"(smem_u32(bar)), "l"(policy)\n'
        '      : "memory");\n')],
}
# (anchor, text inserted after it) of the timeline copy
TIMELINE = [
    ("namespace v3d_kvprobe {\n\nusing namespace v3d_sm90;\n",
     f"static __device__ unsigned long long g_kvtrace[{MAX_CTAS} * "
     f"{TRACE_SLOTS}];\n"
     "__device__ __forceinline__ unsigned long long gtime() {\n"
     "  unsigned long long t;\n"
     "  asm volatile(\"mov.u64 %0, %%globaltimer;\" : \"=l\"(t));\n"
     "  return t;\n}\n"
     f"#define TR(slot) g_kvtrace[blockIdx.x * {TRACE_SLOTS} + (slot)] = "
     "gtime()\n"),
    ("  const int g0 = u0 / a.units_per_block;   // the first block touched\n",
     "  if (tid == 0) TR(0);\n"),
    ("  if (tid < kMaxTouched) part[tid] = 0u;\n  __syncthreads();\n",
     "  if (tid == 0) TR(1);\n"),
    ("        bulk_load(ring + s * kUnit, src, kUnit, &full[s]);\n",
     "        if (i == 0) TR(2);\n"),
    ("    mbar_wait(&full[s], (i / kSlots) & 1);\n",
     "    if (tid == 0 && i == 0) TR(3);\n"),
    ("  flush(acc, &part[g - g0], lane);\n  named_sync(1, kConsumers);\n",
     "  if (tid == 0) TR(4);\n"),
    ("  if (tid <= g - g0) atomicAdd(a.checksum + g0 + tid, part[tid]);\n",
     "  if (tid == 0) TR(5);\n"),
]
READ_BACK = f'''
extern "C" int v3d_kvtrace(void* dst, long long bytes) {{
  return static_cast<int>(cudaMemcpyFromSymbol(dst, v3d_kvprobe::g_kvtrace,
                                               bytes));
}}
extern "C" int v3d_kvtrace_clear() {{
  static unsigned long long zeros[{MAX_CTAS * TRACE_SLOTS}];
  return static_cast<int>(cudaMemcpyToSymbol(v3d_kvprobe::g_kvtrace, zeros,
                                             sizeof(zeros)));
}}
'''


def patched_copy(dst: str, edits, inserts=(), append: str = "") -> str:
    """This tree's package at dst/video3d_tpu_torch with ``edits``
    (anchor -> replacement) and ``inserts`` (text after an anchor) applied
    to ``csrc/stream_probe.cu`` and ``append`` added to it; returns dst."""
    pkg = os.path.join(dst, "video3d_tpu_torch")
    shutil.copytree(os.path.join(ROOT, "video3d_tpu_torch"), pkg,
                    ignore=shutil.ignore_patterns("_build", "__pycache__"))
    path = os.path.join(pkg, "csrc", "stream_probe.cu")
    src = open(path).read()
    for anchor, text in [*edits, *((a, a + t) for a, t in inserts)]:
        if src.count(anchor) != 1:
            raise SystemExit(f"kv_probe_ab: anchor not found once: "
                             f"{anchor!r}")
        src = src.replace(anchor, text)
    open(path, "w").write(src + append)
    return dst


def _median_ms(fn, iters: int, flush=None) -> float:
    """``timing.median_ms`` with any ``flush()`` before each timed call."""
    import torch

    from video3d_tpu_torch.bench import timing

    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        if flush is not None:
            flush()
        torch.cuda._sleep(timing.SPIN_CYCLES)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    times.sort()
    return times[len(times) // 2]


def _conditions(fn, iters: int, dev) -> dict:
    """Warm, dirty-flushed and clean-flushed medians of ``fn``."""
    import torch

    from video3d_tpu_torch.bench import timing

    buf = torch.ones(timing.FLUSH_BYTES // 4, dtype=torch.int32, device=dev)
    out = {"ms": _median_ms(fn, iters),
           "ms_l2_flushed": timing.median_ms(fn, iters, flush_l2_cache=True),
           "ms_l2_flushed_clean": _median_ms(
               fn, iters, lambda: buf.sum(dtype=torch.int32))}
    del buf
    return out


def _sizes(sp, probes, dev, iters: int) -> dict:
    """B9a over S tokens of K and V, and the timing's floor."""
    import torch

    x = torch.zeros(16, device=dev)
    out = {"floor: add_ on 16 floats": {
        "ok": True, **_conditions(lambda: x.add_(1), iters, dev)}}
    g = torch.Generator(device=dev).manual_seed(3)
    for S in (8192, 16384, 65536, 131072):
        kv = probes._int8(g, (2, S, probes.KV, probes.HD), dev)
        k, v = kv[0], kv[1]
        t = torch.zeros(probes.HD, device=dev)
        ref = sp.kv_probe_plain(k, v, t, 4096)
        ok = all(torch.equal(a, b)
                 for a, b in zip(sp.kv_probe(k, v, t, 4096), ref))
        out[f"S {S} ({kv.numel()} bytes)"] = {
            "ok": ok, **_conditions(lambda: sp.kv_probe(k, v, t, 4096),
                                    iters, dev)}
        del kv, k, v
    return out


def _inputs(dev):
    import torch

    from video3d_tpu_torch.bench import probes

    g = torch.Generator(device=dev).manual_seed(0)
    kv = probes._int8(g, (2, probes.S, probes.KV, probes.HD), dev)
    t = torch.full((probes.HD,), 1e-6, dtype=torch.float32, device=dev)
    return kv[0], kv[1], t


def _turn(iters: int, sizes: bool) -> dict:
    import torch

    from video3d_tpu_torch.bench import probes
    from video3d_tpu_torch.kernels import stream_probe as sp

    dev = torch.device("cuda", 0)
    k, v, t = _inputs(dev)
    out = {}
    for bs in BSS:
        ref = sp.kv_probe_plain(k, v, t, bs)
        control = sp.kv_probe_plain(k, v, t, bs, True)
        a, b = sp.kv_probe(k, v, t, bs), sp.kv_probe(k, v, t, bs)
        ok = all(torch.equal(x, y) for x, y in zip(a, ref)) and \
            all(torch.equal(x, y) for x, y in zip(a, b)) and \
            not torch.equal(control[1], a[1])
        out[f"bs {bs}"] = {
            "ok": ok, **_conditions(lambda: sp.kv_probe(k, v, t, bs),
                                    iters, dev)}
    if sizes:
        out.update(_sizes(sp, probes, dev, iters))
    return out


def _timeline(iters: int) -> dict:
    """Per-phase times of B9a at 4096-token blocks from the instrumented
    copy on ``sys.path``, warm and dirty-flushed."""
    import numpy as np
    import torch

    from video3d_tpu_torch.bench import timing
    from video3d_tpu_torch.kernels import _build
    from video3d_tpu_torch.kernels import stream_probe as sp

    dev = torch.device("cuda", 0)
    k, v, t = _inputs(dev)
    lib = _build.library()
    lib.v3d_kvtrace.argtypes = [ctypes.c_void_p, ctypes.c_longlong]
    ctas = sp.kv_probe_plan(*k.shape, 4096,
                            torch.cuda.get_device_properties(0)
                            .multi_processor_count).ctas
    buf = np.zeros(MAX_CTAS * TRACE_SLOTS, dtype=np.uint64)
    flush = torch.empty(timing.FLUSH_BYTES, dtype=torch.uint8, device=dev)
    names = ["CTA starts spread", "set-up (mbarriers)",
             "first copy issued", "first copy landed", "stream summed",
             "checksums added"]
    out = {}
    for cond in ("warm", "flushed dirty"):
        rows = {n: [] for n in ["event ms", "outside the CTAs' span",
                                *names]}
        sp.kv_probe(k, v, t, 4096)
        for _ in range(iters):
            lib.v3d_kvtrace_clear()
            if cond != "warm":
                flush.zero_()
            torch.cuda._sleep(timing.SPIN_CYCLES)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            sp.kv_probe(k, v, t, 4096)
            end.record()
            end.synchronize()
            lib.v3d_kvtrace(buf.ctypes.data, buf.nbytes)
            tr = buf.reshape(MAX_CTAS, TRACE_SLOTS)[:ctas].astype(np.int64)
            t0 = tr[:, 0].min()
            ms = start.elapsed_time(end)
            rows["event ms"].append(ms)
            rows["outside the CTAs' span"].append(
                ms * 1e3 - (tr[:, 5].max() - t0) / 1e3)
            rows["CTA starts spread"].append((tr[:, 0].max() - t0) / 1e3)
            for i, n in enumerate(names[1:], start=1):
                d = (tr[:, i] - tr[:, i - 1 if i != 3 else 1]) / 1e3
                rows[n].append([float(np.median(d)), float(d.max())])
        out[cond] = {n: (float(np.median(r)) if n in (
            "event ms", "outside the CTAs' span", "CTA starts spread")
            else np.median(np.asarray(r), axis=0).tolist())
            for n, r in rows.items()}
    out["phases"] = ("us; per CTA [median, worst] of the step from the "
                     "point before (first copy landed: from set-up), "
                     "over the calls' medians")
    return out


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--parent")
    ap.add_argument("--iters", type=int, default=50)
    ap.add_argument("--sizes", action="store_true",
                    help="also B9a over other lengths, and the floor")
    ap.add_argument("--timeline", action="store_true",
                    help="also the phases of each CTA, from %%globaltimer")
    ap.add_argument("--turn", help=argparse.SUPPRESS)
    ap.add_argument("--trace", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.turn:
        sys.path.insert(0, args.turn)
        print(json.dumps(_timeline(args.iters) if args.trace
                         else _turn(args.iters, args.sizes)))
        return
    if not args.parent:
        raise SystemExit("--parent DIR is required")
    sys.path.insert(0, ROOT)
    from video3d_tpu_torch.bench.timing import device_info

    import torch
    info = device_info(torch.device("cuda", 0))
    tmp = tempfile.mkdtemp(prefix="kv_probe_ab_")
    trees = {"parent": os.path.abspath(args.parent), "change": ROOT}
    for i, (name, edits) in enumerate(VARIANTS.items()):
        trees[name] = patched_copy(os.path.join(tmp, str(i)), edits)
    order = ["parent", "change", *VARIANTS, *reversed(VARIANTS), "change",
             "parent"]
    turns = []
    try:
        for tag in order:
            proc = subprocess.run(
                [sys.executable, os.path.abspath(__file__), "--turn",
                 trees[tag], "--iters", str(args.iters)]
                + (["--sizes"] if args.sizes and tag == "change" else []),
                capture_output=True, text=True, cwd=trees[tag])
            if proc.returncode != 0:
                raise SystemExit(f"{tag} turn failed:\n{proc.stderr[-4000:]}")
            turns.append((tag, json.loads(
                proc.stdout.strip().splitlines()[-1])))
        timeline = None
        if args.timeline:
            traced = patched_copy(os.path.join(tmp, "timeline"), [],
                                  TIMELINE, READ_BACK)
            proc = subprocess.run(
                [sys.executable, os.path.abspath(__file__), "--turn",
                 traced, "--trace", "--iters", str(args.iters)],
                capture_output=True, text=True, cwd=traced)
            if proc.returncode != 0:
                raise SystemExit(f"timeline failed:\n{proc.stderr[-4000:]}")
            timeline = json.loads(proc.stdout.strip().splitlines()[-1])
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    bound_ms = 2 * 32768 * 4 * 128 / 3.35e12 * 1e3
    result = {"device": info, "bound_ms": bound_ms, "rows": {}}
    ok = True
    best = {}
    for tag, rows in turns:
        for name, r in rows.items():
            ok &= r["ok"]
            result["rows"].setdefault(name, []).append({"tree": tag, **r})
            if name.startswith("bs "):
                key = (tag, name)
                if key not in best or r["ms_l2_flushed"] < best[key]:
                    best[key] = r["ms_l2_flushed"]
    result["best flushed"] = {
        f"{tag} {name}": {"ms_l2_flushed": ms,
                          "share_of_bound": bound_ms / ms}
        for (tag, name), ms in sorted(best.items())}
    if timeline is not None:
        result["timeline, bs 4096"] = timeline
    result["ok"] = ok
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(ROOT, "chiprun_out", "kv_probe_ab.json"),
              "w") as f:
        json.dump(result, f, indent=1)
    print(json.dumps(result))
    if not ok:
        raise SystemExit("a tree's rows or checksums are out of bounds")


if __name__ == "__main__":
    main()
