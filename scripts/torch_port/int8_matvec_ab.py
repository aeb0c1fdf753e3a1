"""A/B of the port's B=1 int8 matvec (kernel B4, ``csrc/int8_matvec.cu``)
between two source trees, on one CUDA GPU:

    python3 scripts/torch_port/int8_matvec_ab.py --parent DIR [--iters 50]

``DIR`` holds another tree's ``video3d_tpu_torch/csrc`` (for example a
``git archive`` of the parent commit, unpacked). Each tree's
``int8_matvec.cu`` and ``common.cu`` are compiled with the flags of
``video3d_tpu_torch/kernels/_build.py``:

1. SASS: ``int8_matvec.cu`` of each tree to a cubin, ``cuobjdump -sass``;
   the opcode sequences (operands dropped) of ``int8_matvec_kernel`` are
   compared.
2. Time: each tree's shared library, loaded with ctypes, runs
   ``v3d_int8_matvec`` at the vocab head (x (1, 3584) bf16, q (3584,
   152064) int8, a bf16 (1, 152064) scale) in turns parent, change,
   change, parent (median of ``--iters`` CUDA-event timings each); the
   outputs must be equal.

Prints one JSON object and writes it to ``chiprun_out/int8_matvec_ab.json``.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
sys.path[:0] = [ROOT, os.path.dirname(os.path.abspath(__file__))]

from sass_ab import _pick, _sass_functions  # noqa: E402


def _build_tree(csrc: str, out_dir: str, tag: str, nvcc: str, flags):
    src = os.path.join(csrc, "int8_matvec.cu")
    cubin = os.path.join(out_dir, f"{tag}.int8_matvec.cubin")
    subprocess.run([nvcc, *flags, "-cubin", "-o", cubin, src], check=True,
                   capture_output=True)
    objs = []
    for name in ("int8_matvec.cu", "common.cu"):
        obj = os.path.join(out_dir, f"{tag}.{name}.o")
        subprocess.run([nvcc, *flags, "-c", "-o", obj,
                        os.path.join(csrc, name)], check=True,
                       capture_output=True)
        objs.append(obj)
    lib = os.path.join(out_dir, f"lib{tag}.so")
    subprocess.run([nvcc, "-shared", "-o", lib, *objs], check=True)
    dll = ctypes.CDLL(lib)
    P, I = ctypes.c_void_p, ctypes.c_int
    dll.v3d_int8_matvec.argtypes = [P, P, P, P, I, I, P]
    dll.v3d_int8_matvec.restype = I
    return cubin, dll


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--parent", required=True,
                    help="a tree holding the other video3d_tpu_torch/csrc")
    ap.add_argument("--iters", type=int, default=50)
    args = ap.parse_args()
    import torch

    from video3d_tpu_torch.kernels import _build
    from video3d_tpu_torch.models.quant import quantize_weight

    if not torch.cuda.is_available():
        raise SystemExit("int8_matvec_ab: needs a CUDA device")
    nvcc = _build._nvcc()
    cuobjdump = os.path.join(os.path.dirname(nvcc), "cuobjdump")
    flags = [f for f in _build.NVCC_FLAGS if f != "-Xptxas=-v"]
    trees = {"parent": os.path.join(args.parent, "video3d_tpu_torch", "csrc"),
             "change": str(_build.SRC_DIR)}
    result = {"device": torch.cuda.get_device_name(0)}
    with tempfile.TemporaryDirectory() as tmp:
        built = {tag: _build_tree(path, tmp, tag, nvcc, flags)
                 for tag, path in trees.items()}
        ops = {tag: _pick(_sass_functions(cubin, cuobjdump),
                          r"int8_matvec_kernel")
               for tag, (cubin, _) in built.items()}
        result["sass int8_matvec_kernel"] = {
            "instructions": {t: len(o) for t, o in ops.items()},
            "same_opcodes": ops["parent"] == ops["change"]}

        dev = torch.device("cuda", 0)
        g = torch.Generator(device=dev).manual_seed(6)
        in_, out = 3584, 152064
        d = quantize_weight((0.02 * torch.randn(in_, out, generator=g,
                                                 device=dev)).bfloat16())
        x = torch.randn(1, in_, generator=g, device=dev).bfloat16()
        outs = {}

        def run(tag):
            y = torch.empty(1, out, device=dev, dtype=torch.bfloat16)
            err = built[tag][1].v3d_int8_matvec(
                x.data_ptr(), d["q"].data_ptr(), d["scale"].data_ptr(),
                y.data_ptr(), in_, out,
                torch.cuda.current_stream().cuda_stream)
            if err:
                raise RuntimeError(f"{tag}: CUDA error {err}")
            outs[tag] = y

        def median_ms(tag):
            run(tag)
            torch.cuda.synchronize()
            times = []
            for _ in range(args.iters):
                a = torch.cuda.Event(enable_timing=True)
                b = torch.cuda.Event(enable_timing=True)
                a.record()
                run(tag)
                b.record()
                b.synchronize()
                times.append(a.elapsed_time(b))
            return sorted(times)[len(times) // 2]

        turns = ["parent", "change", "change", "parent"]
        result["matvec ms, turns " + ", ".join(turns)] = [
            median_ms(t) for t in turns]
        result["outputs equal"] = bool(torch.equal(outs["parent"],
                                                   outs["change"]))
    result["nvidia-smi"] = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True).stdout.strip()
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(ROOT, "chiprun_out", "int8_matvec_ab.json"),
              "w") as f:
        json.dump(result, f, indent=1)
    print(json.dumps(result))


if __name__ == "__main__":
    main()
