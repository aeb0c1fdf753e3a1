"""A/B of the port's cached-chunk attention kernels, B2 folded and B5, in
their bf16, int8 and int4 cache forms, between two source trees, on one
CUDA GPU:

    python3 scripts/torch_port/chunk_attention_ab.py --parent DIR
        [--iters 20] [--profile]

``DIR`` holds another tree's ``video3d_tpu_torch`` package (for example a
``git archive`` of the parent commit, unpacked). Each turn is a fresh
process that imports one tree's package, builds its kernels (into that
tree's ``_build/``) and:

1. at ``chip_smoke.py`` phase 3's shapes (B2 folded: B=1, a 64-query chunk
   at offset 6716 of layer 27 of a (28, 1, 8224, KV * hd) cache, kv_len
   6756; B5: B=8, L=64, a 6716-position prefix; H=28, KV=4, hd=128) and at
   the ``ctx32k`` chunk shape (B2 folded int8: a 4096-query chunk at
   offsets 0 and 28672 of a (28, 1, 32768, KV * hd) int8 cache), holds each
   form against its plain version run in f32 on the same values (bf16
   output <= 2e-2; the ctx32k chunks on their first and last 512 queries)
   and times it (median of ``--iters`` CUDA-event timings, each call queued
   behind a ~1 ms spin kernel; warm, and with the L2 flushed before each
   call);
2. with ``--profile``, runs one 4096-token chunk of the benchmark's ctx32k
   prefill (``bench/flagship.py``: Qwen2-7B, int8 weights and an int8 KV
   cache of 32768 slots, the chunk at offset 28672) under
   ``torch.profiler`` and splits its device time by kernel group.

Inputs are made in this script from seeded generators, the same in every
turn. Turns: parent, change, change, parent. Prints one JSON object and
writes it to ``chiprun_out/chunk_attention_ab.json``. The SASS of the
kernels that must not change is compared by ``sass_ab.py``.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
BF16_ATOL = 2e-2
Q_SCALE, FOCUS = 3.0, 11.0
H, KV, HD = 28, 4, 128
FOLDED = (28, 8224, 64, 6716, 6756)        # layers, S, L, offset, kv_len
PREFIX = (8, 64, 6716)                      # B, L, P
SUFFIX_LENS = [64, 40, 17, 64, 33, 50, 8, 60]
CTX = (28, 32768, 4096, (0, 28672), 512)    # layers, S, L, offsets, rows
GROUPS = (("cached-chunk attention (B2 folded)",
           ("chunk_kernel", "flash_folded_kernel")),
          ("matrix products", ("gemm", "gemv", "xmma", "cutlass", "nvjet",
                               "cublas", "sm90_", "stream_kernel")),
          ("other", ("",)))


def _quantized(g, dev, lead, bits, v_scale=1.0, edit=None):
    """A flat (*lead, KV*hd) int8 cache, or an int4 one packed two values
    per byte, and its (*lead, KV, 1) f32 scales, one leading index at a
    time: per (position, kv head) absmax / qmax, values rounded."""
    import torch

    qmax = 127 if bits == 8 else 7
    vals = torch.empty((*lead, KV * HD * bits // 8),
                       dtype=torch.int8 if bits == 8 else torch.uint8,
                       device=dev)
    scales = torch.empty((*lead, KV, 1), dtype=torch.float32, device=dev)
    for i in range(lead[0]):
        x = (v_scale * torch.randn(*lead[1:], KV, HD, generator=g,
                                   device=dev)).bfloat16().float()
        if edit is not None:
            edit(i, x)
        s = x.abs().amax(-1, keepdim=True).clamp_min(1e-8) / qmax
        q = torch.round(x / s).clamp(-qmax, qmax).to(torch.int8)
        if bits == 4:
            q = ((q[..., 1::2] << 4) | (q[..., 0::2] & 0x0F)).view(
                torch.uint8)
        vals[i] = q.reshape(*lead[1:], -1)
        scales[i] = s
    return vals, scales


def _query(g, dev, B, L):
    import torch

    q = Q_SCALE * torch.randn(B, L, H, HD, generator=g, device=dev)
    q[..., 0] += FOCUS
    return q.bfloat16()


def _cache(g, dev, bits, NL, S, spans):
    """K and V of a stacked (NL, 1, S, KV*hd) cache (and scales), the keys
    of each (offset, end) span of the last layer focused."""
    import torch

    def focus(i, x):
        if i == NL - 1:
            for o, n in spans:
                x[0, o:n, :, 0] += FOCUS
    if bits == 16:
        k = torch.randn(NL, 1, S, KV, HD, generator=g, device=dev)
        for o, n in spans:
            k[NL - 1, 0, o:n, :, 0] += FOCUS
        v = 0.5 * torch.randn(NL, 1, S, KV, HD, generator=g, device=dev)
        return (k.reshape(NL, 1, S, -1).bfloat16(),
                v.reshape(NL, 1, S, -1).bfloat16(), None, None)
    k, ks = _quantized(g, dev, (NL, 1, S), bits, edit=focus)
    v, vs = _quantized(g, dev, (NL, 1, S), bits, v_scale=0.5)
    return k, v, ks, vs


def turn(tree: str, iters: int, profile: bool) -> dict:
    """One tree's checks, times and profile, in this process."""
    sys.path.insert(0, tree)
    import torch

    from video3d_tpu_torch.bench import timing
    from video3d_tpu_torch.kernels import flash_attention as fa
    from video3d_tpu_torch.kernels.attention import \
        mha_shared_prefix_reference

    assert fa.__file__.startswith(os.path.abspath(tree)), fa.__file__
    dev = torch.device("cuda", 0)
    ms, ms_flushed, err = {}, {}, {}

    def timed(name, fn):
        ms[name] = timing.median_ms(fn, iters)
        ms_flushed[name] = timing.median_ms(fn, iters, flush_l2_cache=True)

    NL, S, L, off, n = FOLDED
    for bits in (16, 8, 4):
        g = torch.Generator(device=dev).manual_seed(10 + bits)
        form = {16: "", 8: "_int8", 4: "_int4"}[bits]
        q = _query(g, dev, 1, L)
        k, v, ks, vs = _cache(g, dev, bits, NL, S, [(off, n)])
        lens = torch.tensor([n], dtype=torch.int32, device=dev)
        offs = torch.tensor([off], dtype=torch.int32, device=dev)
        args = (q, k, v, lens, offs, NL - 1, KV, ks, vs)
        out = fa.flash_attention_gqa_folded(*args)
        ref = fa.flash_attention_gqa_folded_plain(q.float(), *args[1:])
        name = "flash_attention_folded" + form
        err[name] = float((out[:, :n - off].float()
                           - ref[:, :n - off]).abs().max())
        timed(name, lambda: fa.flash_attention_gqa_folded(*args))
        del k, v, ks, vs, ref

        B, Ls, P = PREFIX
        q = _query(g, dev, B, Ls)
        if bits == 16:
            pk = torch.randn(P, KV, HD, generator=g, device=dev).bfloat16()
            pv = (0.5 * torch.randn(P, KV, HD, generator=g,
                                    device=dev)).bfloat16()
            pks = pvs = None
        else:
            pk, pks = _quantized(g, dev, (1, P), bits)
            pv, pvs = _quantized(g, dev, (1, P), bits, v_scale=0.5)
            pk, pks, pv, pvs = (t[0].reshape(P, KV, -1)
                                for t in (pk, pks, pv, pvs))
        sk = torch.randn(B, Ls, KV, HD, generator=g, device=dev)
        sk[..., 0] += FOCUS
        sk = sk.bfloat16()
        sv = (0.5 * torch.randn(B, Ls, KV, HD, generator=g,
                                device=dev)).bfloat16()
        slens = torch.tensor(SUFFIX_LENS, dtype=torch.int32, device=dev)
        args = (q, pk, pv, sk, sv, slens, pks, pvs)
        out = fa.flash_attention_shared_prefix(*args)
        ref = mha_shared_prefix_reference(q.float(), *args[1:])
        name = "shared_prefix_attention" + form
        err[name] = max(float((out[b, :m].float() - ref[b, :m]).abs().max())
                        for b, m in enumerate(SUFFIX_LENS))
        timed(name, lambda: fa.flash_attention_shared_prefix(*args))
        del args, out, ref
        torch.cuda.empty_cache()

    NL, S, L, offsets, rows = CTX
    g = torch.Generator(device=dev).manual_seed(40)
    k, v, ks, vs = _cache(g, dev, 8, NL, S, [(o, o + L) for o in offsets])
    lens = torch.tensor([S], dtype=torch.int32, device=dev)
    for o in offsets:
        q = _query(g, dev, 1, L)
        offs = torch.tensor([o], dtype=torch.int32, device=dev)
        args = (q, k, v, lens, offs, NL - 1, KV, ks, vs)
        out = fa.flash_attention_gqa_folded(*args)
        name = f"flash_attention_folded_int8 ctx32k chunk at {o}"
        err[name] = 0.0
        for first in (0, L - rows):
            ref = fa.flash_attention_gqa_folded_plain(
                q[:, first:first + rows].float(), k, v, lens, offs + first,
                NL - 1, KV, ks, vs)
            err[name] = max(err[name], float(
                (out[:, first:first + rows].float() - ref).abs().max()))
        timed(name, lambda: fa.flash_attention_gqa_folded(*args))
    del k, v, ks, vs, args, out, ref
    torch.cuda.empty_cache()
    res = {"ms": ms, "ms_l2_flushed": ms_flushed, "max_err": err,
           "within_bounds": all(e <= BF16_ATOL for e in err.values())}
    if profile:
        res["profile"] = _profile_ctx_chunk(dev)
    return res


def _profile_ctx_chunk(dev) -> dict:
    """Device ms by kernel group of one 4096-token ctx32k chunk (the last,
    at offset 28672 of the 32768-slot int8 cache) of Qwen2-7B with int8
    weights, after one unprofiled run of the same chunk."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from video3d_tpu_torch.bench import flagship
    from video3d_tpu_torch.models import qwen2

    cfg = flagship.full_cfg(tiny=False)
    params = flagship.init_params(cfg, dev)
    llm = params["llm"]
    L, chunk = 32768, 4096
    start = L - chunk
    ids = flagship.ctx_ids(cfg, chunk, dev)
    cache = qwen2.KVCache.zeros(cfg.llm, 1, L, dtype=torch.int8, device=dev)
    kv_len = torch.full((1,), L, dtype=torch.long, device=dev)
    cpos = (start + torch.arange(chunk, device=dev))[None]

    @torch.inference_mode()
    def run():
        emb = qwen2.embed_tokens(llm, ids)[None]
        return qwen2.qwen2_forward(
            llm, cfg.llm, emb, cpos[..., None].expand(1, chunk, 3),
            kv_cache=cache, cache_positions=cpos, kv_len=kv_len,
            contiguous_update=True)

    run()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    groups = {g: 0.0 for g, _ in GROUPS}
    kernels = 0
    for ev in prof.events():
        if ev.device_type != torch.autograd.DeviceType.CUDA:
            continue
        kernels += 1
        for g, keys in GROUPS:
            if any(k in ev.name for k in keys):
                groups[g] += ev.time_range.elapsed_us() / 1e3
                break
    return {"device_ms": groups, "device_ms_total": sum(groups.values()),
            "kernels": kernels}


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--parent",
                    help="a tree holding the other video3d_tpu_torch")
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--profile", action="store_true")
    ap.add_argument("--turn", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.turn:
        print(json.dumps(turn(args.turn, args.iters, args.profile)))
        return
    if not args.parent:
        ap.error("--parent DIR is required")
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chunk_attention_ab: needs a CUDA device")
    trees = {"parent": os.path.abspath(args.parent), "change": ROOT}
    turns = ["parent", "change", "change", "parent"]
    runs = []
    for tag in turns:
        res = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--turn", trees[tag],
             "--iters", str(args.iters)]
            + (["--profile"] if args.profile else []),
            capture_output=True, text=True)
        if res.returncode:
            raise SystemExit(f"{tag} turn failed:\n{res.stdout}{res.stderr}")
        runs.append(json.loads(res.stdout.strip().splitlines()[-1]))
    result = {"device": torch.cuda.get_device_name(0), "turns": turns}
    for name in runs[0]["ms"]:
        result[f"{name} ms"] = [r["ms"][name] for r in runs]
        result[f"{name} ms L2 flushed"] = [r["ms_l2_flushed"][name]
                                           for r in runs]
        result[f"{name} max err"] = [r["max_err"][name] for r in runs]
    result["within bounds"] = [r["within_bounds"] for r in runs]
    if args.profile:
        result["ctx32k chunk profile"] = [r["profile"] for r in runs]
    result["nvidia-smi"] = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True,
        text=True).stdout.strip()
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(ROOT, "chiprun_out", "chunk_attention_ab.json"),
              "w") as f:
        json.dump(result, f, indent=1)
    print(json.dumps(result))
    if not all(result["within bounds"]):
        raise SystemExit("chunk_attention_ab: a tree's output is out of "
                         "bounds")


if __name__ == "__main__":
    main()
