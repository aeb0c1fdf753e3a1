"""A/B of the port's inference B2 prefill kernel between two source trees,
on one CUDA GPU:

    python3 scripts/torch_port/flash_prefill_ab.py --parent DIR [--iters 20]

``DIR`` holds another tree's ``video3d_tpu_torch/csrc`` (for example a
``git archive`` of the parent commit, unpacked). Both trees' ``csrc/*.cu``
are compiled with the flags of ``video3d_tpu_torch/kernels/_build.py``:

1. SASS: ``flash_attention.cu`` of each tree to a cubin, ``cuobjdump -sass``;
   the opcode sequences (operands dropped) of the inference prefill kernel
   (``flash_fwd_kernel``, in this tree the ``kLse = false`` instantiation)
   are compared, and so are those of the GQA-folded kernels.
2. Time: each tree's shared library, loaded with ctypes, runs
   ``v3d_flash_attention`` at B=1, L=8192, length 6780, H=28, KV=4, hd=128,
   causal, in turns parent, change, change, parent (median of ``--iters``
   CUDA-event timings each); the two outputs must be equal.

Prints one JSON object and writes it to ``chiprun_out/flash_prefill_ab.json``.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import re
import subprocess
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
sys.path.insert(0, ROOT)


def _sass_functions(cubin: str, cuobjdump: str) -> dict:
    """Function name -> list of opcodes of its SASS."""
    text = subprocess.run([cuobjdump, "-sass", cubin], capture_output=True,
                          text=True, check=True).stdout
    funcs, name = {}, None
    for line in text.splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            name = m.group(1)
            funcs[name] = []
            continue
        m = re.match(
            r"\s*/\*[0-9a-f]{4,}\*/\s+(@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)", line)
        if name and m:
            funcs[name].append(m.group(2))
    return funcs


def _pick(funcs: dict, pattern: str) -> list:
    names = [n for n in funcs if re.search(pattern, n)]
    if len(names) != 1:
        raise RuntimeError(f"{pattern}: {len(names)} of the functions "
                           f"{sorted(funcs)}")
    return funcs[names[0]]


def _build_tree(csrc: str, out_dir: str, tag: str, nvcc: str, flags):
    cubin = os.path.join(out_dir, f"{tag}.flash.cubin")
    subprocess.run([nvcc, *flags, "-cubin", "-o", cubin,
                    os.path.join(csrc, "flash_attention.cu")], check=True,
                   capture_output=True)
    objs = []
    for src in sorted(f for f in os.listdir(csrc) if f.endswith(".cu")):
        obj = os.path.join(out_dir, f"{tag}.{src}.o")
        subprocess.run([nvcc, *flags, "-c", "-o", obj,
                        os.path.join(csrc, src)], check=True,
                       capture_output=True)
        objs.append(obj)
    lib = os.path.join(out_dir, f"lib{tag}.so")
    subprocess.run([nvcc, "-shared", "-o", lib, *objs], check=True)
    dll = ctypes.CDLL(lib)
    P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    dll.v3d_flash_attention.argtypes = [P, P, P, P, P, I, I, I, I, I, I, F, P]
    dll.v3d_flash_attention.restype = I
    return cubin, dll


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--parent", required=True,
                    help="a tree holding the other video3d_tpu_torch/csrc")
    ap.add_argument("--iters", type=int, default=20)
    args = ap.parse_args()
    import torch

    from video3d_tpu_torch.kernels import _build

    if not torch.cuda.is_available():
        raise SystemExit("flash_prefill_ab: needs a CUDA device")
    nvcc = _build._nvcc()
    cuobjdump = os.path.join(os.path.dirname(nvcc), "cuobjdump")
    flags = [f for f in _build.NVCC_FLAGS if f != "-Xptxas=-v"]
    trees = {"parent": os.path.join(args.parent, "video3d_tpu_torch", "csrc"),
             "change": str(_build.SRC_DIR)}
    result = {"device": torch.cuda.get_device_name(0)}
    with tempfile.TemporaryDirectory() as tmp:
        built = {tag: _build_tree(path, tmp, tag, nvcc, flags)
                 for tag, path in trees.items()}
        sass = {tag: _sass_functions(cubin, cuobjdump)
                for tag, (cubin, _) in built.items()}
        for kernel, pattern in (
                ("prefill", r"flash_fwd_kernel(ILb0EEEv|E)P"),
                ("folded bf16", r"flash_folded_kernelI13__nv_bfloat16E"),
                ("folded int8", r"flash_folded_kernelIaE")):
            ops = {tag: _pick(f, pattern) for tag, f in sass.items()}
            result[f"sass {kernel}"] = {
                "instructions": {t: len(o) for t, o in ops.items()},
                "same_opcodes": ops["parent"] == ops["change"]}

        dev = torch.device("cuda", 0)
        g = torch.Generator(device=dev).manual_seed(2)
        B, L, H, KV, hd, n = 1, 8192, 28, 4, 128, 6780
        q = torch.randn(B, L, H, hd, generator=g, device=dev).bfloat16()
        k = torch.randn(B, L, KV, hd, generator=g, device=dev).bfloat16()
        v = (0.5 * torch.randn(B, L, KV, hd, generator=g,
                               device=dev)).bfloat16()
        lens = torch.tensor([n], dtype=torch.int32, device=dev)
        outs = {}

        def run(tag):
            out = torch.empty_like(q)
            err = built[tag][1].v3d_flash_attention(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), lens.data_ptr(),
                out.data_ptr(), B, L, L, H, KV, 1, float(hd ** -0.5),
                torch.cuda.current_stream().cuda_stream)
            if err:
                raise RuntimeError(f"{tag}: CUDA error {err}")
            outs[tag] = out

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
        result["prefill ms, turns " + ", ".join(turns)] = [
            median_ms(t) for t in turns]
        result["outputs equal"] = bool(torch.equal(outs["parent"],
                                                   outs["change"]))
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    result["nvidia-smi"] = smi
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(ROOT, "chiprun_out", "flash_prefill_ab.json"),
              "w") as f:
        json.dump(result, f, indent=1)
    print(json.dumps(result))


if __name__ == "__main__":
    main()
