"""HBM read-rate probes of the port (kernel B9), one CLI for the three probe
scripts of the JAX package's benchmark, with their shapes and modes:

    python -m video3d_tpu_torch.bench.probes kv [--bss 4096,8192,16384]
    python -m video3d_tpu_torch.bench.probes matvec [--probe-dtype bfloat16]
    python -m video3d_tpu_torch.bench.probes stream [--ks 1,2,3,4]
        [--contig | --split-same] [--bo 1536]
    (each also takes --check)

* ``kv`` (``scripts/bench/kv_probe.py``): int8 K and V of (32768, 4, 128)
  in blocks of ``bs`` tokens (B9a);
* ``matvec`` (``scripts/bench/int8_matvec.py --probe``): the (3584, 152064)
  vocab-head weight, int8 or bf16, in (3584, bo) column blocks (B9b);
* ``stream`` (``scripts/bench/stream_probe.py``): K such int8 weights at
  once, strided or pre-tiled contiguous (B9c), or ``--split-same``: K
  streams over one weight at column offsets j OUT / K (B9d).

The block width ``bo`` starts at ``--bo`` and steps down by 128 until it
divides the columns (of each of the K parts, split form); the TPU scripts'
VMEM budget on it does not apply here. Each line prints ms per call with the
L2 flushed before every call and warm (the same inputs again, L2-resident
where they fit in its 50 MB), and GB/s of the flushed time; each probe checks
its result (rows and checksums) against its plain version first. With
``--check`` (``chip_smoke.py`` phase 3) each line also holds its controls,
plain versions with one part broken that must differ from the kernel, and
times the plain version and the checksum half as one PyTorch call.
:func:`measured_read_gbps` is the best flushed rate of the large forms, the
measured read ceiling that ``chip_smoke.py`` reads the byte-bound kernels
against beside the data sheet's 3.35 TB/s.
"""

from __future__ import annotations

import argparse
import json
from typing import Dict, List, Sequence

import torch

from video3d_tpu_torch.bench import timing
from video3d_tpu_torch.kernels import stream_probe as sp

S, KV, HD = 32768, 4, 128           # the 32k int8 KV cache of B9a
IN, OUT = 3584, 152064              # Qwen2-7B's vocab head (B9b-d)


def _int8(gen, shape, device):
    return torch.randint(-127, 128, shape, generator=gen, dtype=torch.int8,
                         device=device)


def block_width(bo: int, cols: int) -> int:
    while cols % bo:
        bo -= 128
    return bo


def _verify(name: str, got, ref) -> None:
    for a, b, what in zip(got, ref, ("rows", "checksums")):
        if not torch.equal(a, b):
            raise AssertionError(f"{name}: {what} differ from the plain "
                                 f"version")


def _nbytes(*tensors) -> int:
    return sum(x.numel() * x.element_size() for x in tensors)


def _measure(name: str, fn, plain, nbytes: int, iters: int,
             device: torch.device, t: torch.Tensor, controls=None,
             library=None) -> Dict:
    """One probe line: ``fn()`` (the kernel on a CUDA device) must give
    the plain version's rows and checksums; ``nbytes`` are the streamed
    bytes its GB/s count. With ``controls`` ({what: a plain version with one
    part broken}, ``--check``) the row counts, for each control, the rows
    and checksums that differ from the kernel's (> 0: caught), and on the
    card it also times the plain version and ``library``, the checksum half
    as one PyTorch call. ``io_bytes``: the streams, ``t`` and the outputs,
    the bytes of a bound."""
    got = fn()
    ref = plain()
    _verify(name, got, ref)
    row = {"probe": name, "bytes": nbytes,
           "io_bytes": nbytes + _nbytes(t, *got),
           "max_abs_err": float((got[0] - ref[0]).abs().max())}
    if controls:
        row["caught"] = {}
        for what, control in controls.items():
            bad = control()
            rows = int((bad[0] != got[0]).any(dim=-1).sum())
            sums = int((bad[1] != got[1]).sum())
            row["caught"][what] = rows + sums
            print(f"{name} control, {what}: {rows} of {got[0].shape[0]} "
                  f"rows and {sums} of {got[1].numel()} checksums differ "
                  f"(must be > 0)", flush=True)
    if device.type == "cuda":
        ms = timing.median_ms(fn, iters, flush_l2_cache=True, device=device)
        warm = timing.median_ms(fn, iters, device=device)
        row.update(ms=ms, ms_warm=warm, gbps=nbytes / ms / 1e6,
                   gbps_warm=nbytes / warm / 1e6)
        lib = ""
        if controls:
            row["plain_ms"] = timing.median_ms(plain, 3, device=device)
            row["library_ms"] = timing.median_ms(library, iters,
                                                 device=device)
            row["library_ms_flushed"] = timing.median_ms(
                library, iters, flush_l2_cache=True, device=device)
            lib = (f"; plain {row['plain_ms']:.4f} ms, the checksums as one "
                   f"PyTorch call {row['library_ms']:.4f} ms warm, "
                   f"{row['library_ms_flushed']:.4f} flushed")
        print(f"{name}: rows and checksums equal the plain version; "
              f"{ms:.4f} ms/call L2 flushed, {warm:.4f} warm  "
              f"{row['gbps']:.0f} GB/s flushed, {row['gbps_warm']:.0f} "
              f"warm{lib}", flush=True)
    else:
        print(f"{name}: rows and checksums equal the plain version (CPU: "
              f"not timed)", flush=True)
    return row


def probe_kv(device: torch.device, bss: Sequence[int] = (4096, 8192, 16384),
             iters: int = 50, seq: int = S, check: bool = False
             ) -> List[Dict]:
    """B9a over int8 K and V of (seq, KV, HD); ``check``: with the control
    (each block's checksum without its last row) and the yardsticks."""
    g = torch.Generator(device=device).manual_seed(0)
    kv = _int8(g, (2, seq, KV, HD), device)     # one allocation: one sum
    k, v = kv[0], kv[1]
    rows = []
    for i, bs in enumerate(bss):
        t = torch.full((HD,), i * 1e-6, dtype=torch.float32, device=device)
        nj = seq // bs
        rows.append(_measure(
            f"fold bs={bs} ({nj} steps)",
            lambda: sp.kv_probe(k, v, t, bs),
            lambda: sp.kv_probe_plain(k, v, t, bs), kv.numel(), iters,
            device, t, check and {
                "checksum skipping each block's last row":
                    lambda: sp.kv_probe_plain(k, v, t, bs, True)},
            lambda: kv.view(torch.int32).view(2, nj, -1).sum(2)))
    return rows


def probe_matvec(device: torch.device, dtype: str = "int8", bo: int = 1536,
                 iters: int = 50, shape=(IN, OUT), check: bool = False
                 ) -> List[Dict]:
    """B9b over one (IN, OUT) weight of ``dtype``; ``check`` as
    :func:`probe_kv`."""
    g = torch.Generator(device=device).manual_seed(0)
    q = _int8(g, shape, device).to(getattr(torch, dtype))
    bo = block_width(bo, shape[1])
    G = shape[1] // bo
    t = torch.full((1, 1), 1e-6, dtype=torch.float32, device=device)
    return [_measure(
        f"probe(bo={bo}, {dtype})", lambda: sp.matvec_probe(q, t, bo),
        lambda: sp.matvec_probe_plain(q, t, bo), _nbytes(q), iters, device,
        t, check and {"checksum skipping each block's last row":
                      lambda: sp.matvec_probe_plain(q, t, bo, True)},
        lambda: q.view(torch.int32).view(shape[0], G, -1).sum((0, 2)))]


def probe_stream(device: torch.device, ks: Sequence[int] = (1, 2, 3, 4),
                 bo: int = 1536, iters: int = 50, contig: bool = False,
                 split_same: bool = False, shape=(IN, OUT),
                 check: bool = False) -> List[Dict]:
    """B9c (K weights, strided or ``contig`` slabs) or, ``split_same``,
    B9d (K streams over one weight); ``check`` as :func:`probe_kv`, and
    for B9d also the control reading every stream one block late."""
    g = torch.Generator(device=device).manual_seed(0)
    IN_, OUT_ = shape
    rows = []
    if split_same:
        q = _int8(g, shape, device)
        for K in ks:
            b = block_width(bo, OUT_ // K)
            gk = OUT_ // (K * b)
            t = torch.full((1, 1), K * 1e-6, dtype=torch.float32,
                           device=device)
            rows.append(_measure(
                f"K={K} split-same (bo={b})",
                lambda: sp.split_probe(q, t, b, K),
                lambda: sp.split_probe_plain(q, t, b, K), q.numel(), iters,
                device, t, check and {
                    "checksum skipping each block's last row":
                        lambda: sp.split_probe_plain(q, t, b, K, True),
                    "column offsets one block late":
                        lambda: sp.split_probe_plain(q, t, b, K, shift=1)},
                lambda: q.view(torch.int32).view(IN_, K, gk, -1)
                .sum((0, 3))))
        return rows
    b = block_width(bo, OUT_)
    G = OUT_ // b
    qk = _int8(g, (max(ks), IN_, OUT_), device)     # reused across K
    if contig:
        qk = sp.tile_contig(qk, b)
    qs = list(qk)
    for K in ks:
        t = torch.full((1, 1), K * 1e-6, dtype=torch.float32, device=device)
        rows.append(_measure(
            f"K={K} (bo={b}{', contig' if contig else ''})",
            lambda: sp.stream_probe(qs[:K], t, b, contig),
            lambda: sp.stream_probe_plain(qs[:K], t, b, contig),
            K * qs[0].numel(), iters, device, t, check and {
                "checksum skipping each block's last row":
                    lambda: sp.stream_probe_plain(qs[:K], t, b, contig,
                                                  skip_last_row=True)},
            (lambda: qk[:K].view(torch.int32).view(K, G, -1).sum(2))
            if contig else
            (lambda: qk[:K].view(torch.int32).view(K, IN_, G, -1)
             .sum((1, 3)))))
    return rows


def measured_read_gbps(device: torch.device, iters: int = 10) -> float:
    """The best L2-flushed read rate, GB/s, of B9's large forms: the int8
    vocab head strided (one stream) and pre-tiled contiguous (two
    streams), and split over two streams."""
    rows = (probe_matvec(device, iters=iters)
            + probe_stream(device, ks=(2,), iters=iters, contig=True)
            + probe_stream(device, ks=(2,), iters=iters, split_same=True))
    return max(r["gbps"] for r in rows)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("mode", choices=["kv", "matvec", "stream"])
    ap.add_argument("--device", default="cuda:0")
    ap.add_argument("--iters", type=int, default=50)
    ap.add_argument("--bss", default="4096,8192,16384")
    ap.add_argument("--bo", type=int, default=1536)
    ap.add_argument("--probe-dtype", default="int8",
                    choices=("int8", "bfloat16"))
    ap.add_argument("--ks", default="1,2,3,4")
    ap.add_argument("--contig", action="store_true")
    ap.add_argument("--split-same", action="store_true")
    ap.add_argument("--check", action="store_true",
                    help="also hold broken plain versions (controls) "
                         "against the kernel and time the plain version "
                         "and the checksums as one PyTorch call")
    a = ap.parse_args(argv)
    device = torch.device(a.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("probes: no CUDA device (pass --device cpu to check "
                         "the plain versions only)")
    info = timing.device_info(device)
    print(f"{info['name']}, {info['power_limit']}", flush=True)
    if a.mode == "kv":
        rows = probe_kv(device, [int(s) for s in a.bss.split(",")], a.iters,
                        check=a.check)
    elif a.mode == "matvec":
        rows = probe_matvec(device, a.probe_dtype, a.bo, a.iters,
                            check=a.check)
    else:
        rows = probe_stream(device, [int(s) for s in a.ks.split(",")], a.bo,
                            a.iters, a.contig, a.split_same, check=a.check)
    print(json.dumps({"device": info, "probes": rows}))


if __name__ == "__main__":
    main()
