"""Build and load the hand-written Hopper kernels (``csrc/*.cu``).

Each ``csrc/*.cu`` compiles with its own ``nvcc`` process, all started
together, and the objects link into ONE shared library with a plain C
interface, loaded through ``ctypes``. The library builds at first use from
the package's own sources into ``video3d_tpu_torch/_build/`` (git-ignored),
named by a hash of the sources, so an edited kernel never loads a stale
binary. Nothing here runs at import time: the CPU tests import every module
of the port on a host without ``nvcc``.

The Hopper kernels that read through TMA (``flash_sm90.cuh``) encode their
tensor maps with the driver's ``cuTensorMapEncodeTiled``, which they get
from ``cudaGetDriverEntryPoint``: the library links the CUDA runtime only,
no ``-lcuda``.

Each C entry point launches on the stream it is given, allocates nothing and
returns ``cudaGetLastError()``; :func:`check` turns a non-zero code into an
exception. :data:`LAUNCHES` counts kernel launches per wrapper, so a caller
can show that a run really went through the kernels. A wrapper called while
its thread captures a CUDA graph launches nothing: its count goes to the
capture (:func:`capturing_launches`), and every replay of the graph adds
the capture's counts once (:func:`add_launches`).
"""

from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, Optional

_PKG = Path(__file__).resolve().parent.parent
SRC_DIR = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas=-v")

#: launches per kernel wrapper; each wrapper adds one where it launches
LAUNCHES: Dict[str, int] = {"fused_geometry": 0, "flash_attention": 0,
                            "flash_attention_folded": 0,
                            "decode_attention": 0,
                            "shared_prefix_attention": 0,
                            "int8_matvec": 0, "decode_attention_int8": 0,
                            "flash_attention_folded_int8": 0,
                            "shared_prefix_attention_int8": 0,
                            "flash_attention_lse": 0,
                            "flash_attention_bwd": 0,
                            "paged_attention": 0, "paged_attention_int8": 0,
                            "int8_matmul": 0, "int4_matmul": 0,
                            "decode_attention_int4": 0,
                            "flash_attention_folded_int4": 0,
                            "shared_prefix_attention_int4": 0,
                            "paged_attention_int4": 0,
                            "stream_probe_kv": 0, "stream_probe_one": 0,
                            "stream_probe_multi": 0,
                            "stream_probe_split": 0,
                            "flash_attention_hd256": 0,
                            "flash_attention_folded_hd256": 0,
                            "decode_attention_hd256": 0,
                            "paged_attention_hd256": 0,
                            "shared_prefix_attention_hd256": 0,
                            "flash_attention_folded_hd256_int8": 0,
                            "flash_attention_folded_hd256_int4": 0,
                            "decode_attention_hd256_int8": 0,
                            "decode_attention_hd256_int4": 0,
                            "paged_attention_hd256_int8": 0,
                            "paged_attention_hd256_int4": 0,
                            "shared_prefix_attention_hd256_int8": 0,
                            "shared_prefix_attention_hd256_int4": 0,
                            "flash_attention_lse_hd256": 0,
                            "flash_attention_bwd_hd256": 0,
                            # not a kernel of the port: the w8a8
                            # product's torch._int_mm calls on the card
                            "int_mm_w8a8": 0}

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_L = ctypes.c_longlong
#: C signatures: name -> argtypes (every entry returns a cudaError_t as int)
_SIGNATURES = {
    # depths, intrinsic, intrinsic stride, poses, out, V, H, W, crop,
    # new_w, left, grid, patch, min xyz, max xyz, voxel, discretize, stream
    "v3d_fused_geometry": [_P, _P, _I, _P, _P, _I, _I, _I, _I, _I, _I, _I,
                           _I, _F, _F, _F, _F, _F, _F, _F, _I, _P],
    # q, k, v, lengths, out, B, L, S, H, KV, causal, sm_scale, stream
    "v3d_flash_attention": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                            _F, _P],
    # q, k_all, v_all, lengths, q_off, out, layer, B, L, S, H, KV,
    # sm_scale, workspace, workspace bytes, counters, splits, stream
    "v3d_flash_attention_folded": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I,
                                   _I, _I, _F, _P, _L, _P, _I, _P],
    # q, k_all, v_all, kv_len, out, workspace, workspace bytes, counters,
    # layer, B, S, H, KV, splits, sm_scale, stream
    "v3d_decode_attention": [_P, _P, _P, _P, _P, _P, _L, _P, _I, _I, _I,
                             _I, _I, _I, _F, _P],
    # q, pk, pv, sk, sv, out, B, L, P, H, KV, sm_scale, workspace,
    # workspace bytes, counters, splits, stream
    "v3d_shared_prefix_attention": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I,
                                    _I, _F, _P, _L, _P, _I, _P],
    # x, q, scale, y, workspace, workspace bytes, counters, the CTAs'
    # first units (host), in, out, ctas, stream
    "v3d_int8_matvec": [_P, _P, _P, _P, _P, _L, _P, _P, _I, _I, _I, _P],
    # q, k_all, v_all, k_scale, v_scale, kv_len, out, workspace,
    # workspace bytes, counters, layer, B, S, H, KV, splits, sm_scale,
    # stream
    "v3d_decode_attention_int8": [_P, _P, _P, _P, _P, _P, _P, _P, _L, _P,
                                  _I, _I, _I, _I, _I, _I, _F, _P],
    # q, k_all, v_all, k_scale, v_scale, lengths, q_off, out, layer, B, L,
    # S, H, KV, sm_scale, workspace, workspace bytes, counters, splits,
    # stream
    "v3d_flash_attention_folded_int8": [_P, _P, _P, _P, _P, _P, _P, _P, _I,
                                        _I, _I, _I, _I, _I, _F, _P, _L, _P,
                                        _I, _P],
    # q, pk, pv, pk_scale, pv_scale, sk, sv, out, B, L, P, H, KV, sm_scale,
    # workspace, workspace bytes, counters, splits, stream
    "v3d_shared_prefix_attention_int8": [_P, _P, _P, _P, _P, _P, _P, _P, _I,
                                         _I, _I, _I, _I, _F, _P, _L, _P, _I,
                                         _P],
    # q, k, v, lengths, out, lse, B, L, S, H, KV, causal, sm_scale, stream
    "v3d_flash_attention_lse": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                                _I, _F, _P],
    # q, k, v, dout, rows (lse and delta), lengths, dq (f32 scratch), dk,
    # dv, B, L, S, H, KV, causal, sm_scale, stream
    "v3d_flash_attention_bwd": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I,
                                _I, _I, _I, _I, _F, _P],
    # q, k_pages, v_pages, table, kv_len, out, workspace, workspace
    # bytes, counters, layer, B, P, page, maxp, H, KV, splits, sm_scale,
    # stream
    "v3d_paged_attention": [_P, _P, _P, _P, _P, _P, _P, _L, _P, _I, _I, _I,
                            _I, _I, _I, _I, _I, _F, _P],
    # q, k_pages, v_pages, k_scale, v_scale, table, kv_len, out,
    # workspace, workspace bytes, counters, layer, B, P, page, maxp, H, KV,
    # splits, sm_scale, stream
    "v3d_paged_attention_int8": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _L, _P,
                                 _I, _I, _I, _I, _I, _I, _I, _I, _F, _P],
    # x, q, scale, y, workspace, workspace bytes, counters, rows, in, out,
    # ctas, stream
    "v3d_int8_matmul": [_P, _P, _P, _P, _P, _L, _P, _I, _I, _I, _I, _P],
    # x, packed, scales, y, workspace, workspace bytes, counters, rows,
    # in_p, out_p, group, ctas, stream
    "v3d_int4_matmul": [_P, _P, _P, _P, _P, _L, _P, _I, _I, _I, _I, _I,
                        _P],
    # p0, p1, p2, p3, t, out, checksum, K, step_bytes, stride, rows, vecs,
    # rows_per_cta, nsteps, nout, rep, sum_form, t_len, elem_bf16, stream
    "v3d_stream_probe": [_P, _P, _P, _P, _P, _P, _P, _I, _L, _L, _I, _I, _I,
                         _I, _I, _I, _I, _I, _I, _P],
    # k, v, t, out, checksum, begins (host), ctas, units_per_stream,
    # units_per_block, hd, stream
    "v3d_kv_probe": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P],
    # q, k, v, lens, q_off, out, workspace, mode (1: folded), B, L, S, H,
    # KV, splits, split_keys, sm_scale, stream
    "v3d_attention_hd256": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                            _I, _I, _I, _F, _P],
    # q, k, v, k_scale, v_scale, lens, q_off, out, workspace, mode, bits, B,
    # L, S, H, KV, splits, split_keys, sm_scale, stream
    "v3d_attention_hd256_quant": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I,
                                  _I, _I, _I, _I, _I, _I, _I, _F, _P],
    # q, k, v, dout, rows (lse and delta), lengths, dq (f32 scratch), dk /
    # dv partials (f32), B, L, S, H, KV, splits, causal, sm_scale, stream
    "v3d_flash_attention_bwd_hd256": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _I,
                                      _I, _I, _I, _I, _I, _I, _F, _P],
}
# the hd-256 prefill forms take the hd-128 ones' arguments
_SIGNATURES.update({f"{n}_hd256{lse}": _SIGNATURES[n + lse]
                    for n in ("v3d_flash_attention",) for lse in ("", "_lse")})
# the int4-cache instantiations take the int8 ones' arguments
_SIGNATURES.update({f"v3d_{n}_int4": _SIGNATURES[f"v3d_{n}_int8"]
                    for n in ("decode_attention", "flash_attention_folded",
                              "shared_prefix_attention", "paged_attention")})
# B3, B7 and B5 at head width 256 take their hd-128 forms' arguments
_SIGNATURES.update({f"v3d_{n}_hd256{form}": _SIGNATURES[f"v3d_{n}{form}"]
                    for n in ("decode_attention", "paged_attention",
                              "shared_prefix_attention")
                    for form in ("", "_int8", "_int4")})

_lock = threading.Lock()
_count_lock = threading.Lock()   # wrappers launch from several threads
_capture = threading.local()     # .counts: this thread's capture, or None
_lib: Optional[ctypes.CDLL] = None
#: seconds the last compile took (0.0 until this process compiled)
build_seconds = 0.0
#: compiler output of the last build (ptxas register / smem report)
build_log = ""


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = os.path.join(cuda_home, "bin", "nvcc")
    if os.path.exists(cand):
        return cand
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels build only on a "
                           "machine with the CUDA toolkit")
    return found


def _sources():
    return sorted(SRC_DIR.glob("*.cu")) + sorted(SRC_DIR.glob("*.cuh"))


def library_path() -> Path:
    h = hashlib.sha256()
    for p in _sources():
        h.update(p.name.encode())
        h.update(p.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"libv3d_kernels-{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile ``csrc/*.cu`` into the shared library unless it exists: one
    ``nvcc -c`` per source, all running at once, then one link."""
    global build_seconds, build_log
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    tag = f"{out.stem}.{os.getpid()}"
    objs, procs = [], []
    t0 = time.perf_counter()
    for src in sorted(SRC_DIR.glob("*.cu")):
        obj = BUILD_DIR / f"{tag}.{src.stem}.o"
        objs.append(obj)
        procs.append((src.name, subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    logs, failed = [], []
    for name, proc in procs:
        logs.append(f"== {name}\n{proc.communicate()[0]}")
        if proc.returncode != 0:
            failed.append(name)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    if not failed:
        res = subprocess.run([nvcc, "-shared", "-o", str(tmp),
                              *map(str, objs)],
                             capture_output=True, text=True)
        logs.append(f"== link\n{res.stdout}{res.stderr}")
        if res.returncode != 0:
            failed.append("link")
    for obj in objs:
        obj.unlink(missing_ok=True)
    build_seconds = time.perf_counter() - t0
    build_log = "".join(logs)
    if failed:
        raise RuntimeError(f"nvcc failed ({', '.join(failed)}):\n{build_log}")
    os.replace(tmp, out)
    return out


def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first call)."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            lib.v3d_error_string.argtypes = [ctypes.c_int]
            lib.v3d_error_string.restype = ctypes.c_char_p
            _lib = lib
    return _lib


def check(err: int, name: str) -> None:
    """Raise if a C entry point returned a CUDA error."""
    if err != 0:
        msg = library().v3d_error_string(err).decode()
        raise RuntimeError(f"{name}: CUDA error {err} ({msg})")


def count_launch(name: str) -> None:
    counts = getattr(_capture, "counts", None)
    if counts is not None:        # recorded into a graph, not launched
        counts[name] = counts.get(name, 0) + 1
        return
    with _count_lock:
        LAUNCHES[name] += 1


@contextlib.contextmanager
def capturing_launches():
    """Within the block, this thread's wrappers count into the yielded
    dict (the launches a CUDA graph captures) instead of LAUNCHES."""
    counts: Dict[str, int] = {}
    _capture.counts = counts
    try:
        yield counts
    finally:
        _capture.counts = None


def add_launches(counts: Dict[str, int]) -> None:
    """Count the launches of one replay of a captured graph."""
    with _count_lock:
        for name, n in counts.items():
            LAUNCHES[name] += n


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0
