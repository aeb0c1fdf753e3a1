"""SASS A/B of every kernel of the port between two source trees, on a
machine with the CUDA toolkit (no GPU work):

    python3 scripts/torch_port/sass_ab.py --parent DIR

``DIR`` holds another tree's ``video3d_tpu_torch/csrc`` (for example a
``git archive`` of the parent commit, unpacked). Every ``csrc/*.cu`` of
both trees is compiled to a cubin with the flags of
``video3d_tpu_torch/kernels/_build.py`` (one ``nvcc`` per source, all at
once); ``cuobjdump -sass`` gives each kernel's opcode sequence (operands
dropped) and ptxas its registers and spill bytes. For every kernel the
parent has, the opcode sequences and the registers and spills must be
equal (a kernel whose template gained a last parameter is matched at that
parameter's 0: the parent's ``kernel<M>`` is this tree's ``kernel<M, 0>``,
or at 128 where the parameter is a head width: the parent's ``kernel<T,
Map>`` is this tree's ``kernel<T, Map, 128>``; one whose template lost its
last parameter is matched the other way: the parent's ``kernel<M, C, 0>``
is this tree's ``kernel<M, C>``, and the parent's instantiations at
another value of it are gone); kernels only in
this tree (new instantiations) are listed with their instruction counts,
registers and spills.

Prints one JSON object and writes it to ``chiprun_out/sass_ab.json``.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import shutil
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
    """The opcodes of the one function whose name matches ``pattern``."""
    names = [n for n in funcs if re.search(pattern, n)]
    if len(names) != 1:
        raise RuntimeError(f"{pattern}: {len(names)} of the functions "
                           f"{sorted(funcs)}")
    return funcs[names[0]]


def _ptxas(log: str) -> dict:
    """Kernel name -> (registers, spill store bytes) from a ptxas -v log."""
    out, name = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            name = m.group(1)
            out[name] = [None, 0]
        m = re.search(r"(\d+) bytes spill stores", line)
        if m and name:
            out[name][1] = int(m.group(1))
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            out[name][0] = int(m.group(1))
    return out


def _compile(csrc: str, out_dir: str, tag: str, nvcc: str, flags):
    """Start one nvcc per source: [(source, cubin, process)]."""
    jobs = []
    for src in sorted(f for f in os.listdir(csrc) if f.endswith(".cu")):
        cubin = os.path.join(out_dir, f"{tag}.{src}.cubin")
        jobs.append((src, cubin, subprocess.Popen(
            [nvcc, *flags, "-Xptxas=-v", "-cubin", "-o", cubin,
             os.path.join(csrc, src)], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True)))
    return jobs


def _demangle(names, cuda_bin: str) -> dict:
    filt = os.path.join(cuda_bin, "cu++filt")
    if not os.path.exists(filt):
        filt = shutil.which("c++filt")
    if not filt or not names:
        return {n: n for n in names}
    res = subprocess.run([filt], input="\n".join(names), capture_output=True,
                         text=True)
    plain = res.stdout.splitlines()
    return dict(zip(names, plain)) if len(plain) == len(names) \
        else {n: n for n in names}


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--parent", required=True,
                    help="a tree holding the other video3d_tpu_torch/csrc")
    args = ap.parse_args()
    from video3d_tpu_torch.kernels import _build

    nvcc = _build._nvcc()
    cuda_bin = os.path.dirname(nvcc)
    cuobjdump = os.path.join(cuda_bin, "cuobjdump")
    flags = [f for f in _build.NVCC_FLAGS if f != "-Xptxas=-v"]
    trees = {"parent": os.path.join(args.parent, "video3d_tpu_torch", "csrc"),
             "change": str(_build.SRC_DIR)}
    sass, regs = {}, {}
    with tempfile.TemporaryDirectory() as tmp:
        jobs = {tag: _compile(path, tmp, tag, nvcc, flags)
                for tag, path in trees.items()}
        for tag, tag_jobs in jobs.items():
            sass[tag], regs[tag] = {}, {}
            for src, cubin, proc in tag_jobs:
                log = proc.communicate()[0]
                if proc.returncode != 0:
                    raise SystemExit(f"nvcc failed on {tag} {src}:\n{log}")
                funcs, props = _sass_functions(cubin, cuobjdump), _ptxas(log)
                # the mangled names of anonymous namespaces differ between
                # trees: key kernels by source file and demangled name
                names = _demangle(sorted(set(funcs) | set(props)), cuda_bin)
                sass[tag].update({f"{src}: {names[n]}": ops
                                  for n, ops in funcs.items()})
                regs[tag].update({f"{src}: {names[n]}": r
                                  for n, r in props.items()})
    # a template parameter added last, whose 0 keeps the old code (the
    # hd-256 kernel's cache form): the parent's kernel<M> is the change's
    # kernel<M, 0>; or whose 128 does (the decode template's head width):
    # the parent's kernel<T, Map> is the change's kernel<T, Map, 128>;
    # and a template parameter dropped last (the hd-256 kernel's kLse): the
    # parent's kernel<M, C, 0> is the change's kernel<M, C>
    for name in list(sass["parent"]):
        zero = "(int)0" if "(int)" in name else "0"
        extended = re.sub(r"<([^<>]*)>\(", rf"<\1, {zero}>(", name, count=1)
        # (a Map such as <unnamed>::FlatRows nests brackets: the template's
        # arguments end at the first ">(")
        widths = [name.replace(">(", f", {c}128>(", 1) for c in ("", "(int)")]
        dropped = re.sub(rf"<([^<>]*), {re.escape(zero)}>\(", r"<\1>(", name,
                         count=1)
        if name in sass["change"]:
            continue
        for other in (extended, *widths, dropped):
            if other != name and other in sass["change"]:
                sass["parent"][other] = sass["parent"].pop(name)
                regs["parent"][other] = regs["parent"].pop(name, None)
                break
    same, changed, new = [], [], {}
    for name, ops in sorted(sass["change"].items()):
        r = regs["change"].get(name, [None, None])
        if name not in sass["parent"]:
            new[name] = {"instructions": len(ops), "registers": r[0],
                         "spill_store_bytes": r[1]}
        elif sass["parent"][name] == ops:
            same.append(name)
        else:
            changed.append({"kernel": name, "instructions": {
                "parent": len(sass["parent"][name]), "change": len(ops)}})
        if name in sass["parent"] and regs["parent"].get(name) != r:
            changed.append({"kernel": name, "registers, spills": {
                "parent": regs["parent"].get(name), "change": r}})
    missing = [n for n in sass["parent"] if n not in sass["change"]]
    result = {"kernels with the same opcodes": len(same),
              "kernels whose opcodes changed": changed,
              "kernels gone": missing, "new kernels": new,
              "same": same,
              "registers (change)": {n: r[0] for n, r in
                                     regs["change"].items()},
              "spill store bytes (change)": {
                  n: r[1] for n, r in regs["change"].items() if r[1]}}
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(ROOT, "chiprun_out", "sass_ab.json"), "w") as f:
        json.dump(result, f, indent=1)
    print(json.dumps({k: v for k, v in result.items()
                      if k not in ("same", "registers (change)")}))


if __name__ == "__main__":
    main()
