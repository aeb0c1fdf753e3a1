"""The B=1 int8 weight-only matvec (kernel B4) and its plain PyTorch
version.

:func:`int8_matmul` dispatches on the device of ``x``: a CPU tensor runs
:func:`int8_matmul_plain`; a CUDA tensor launches ``csrc/int8_matvec.cu``
or raises. Counterpart of ``video3d_tpu/kernels/quant_matvec.py::
int8_matmul`` in its B=1 form (``_int8_mv_kernel``); the B>1 form
(``_int8_kernel``) is off every path the port runs (``models/quant.py``
dispatches only one row) and is not ported.
"""

from __future__ import annotations

import torch

from video3d_tpu_torch.kernels import _build

COLS_PER_THREAD = 16     # int8 columns one thread streams (csrc kCols)


def int8_matmul_plain(x: torch.Tensor, q: torch.Tensor,
                      scale: torch.Tensor) -> torch.Tensor:
    """x (..., in) @ q (in, out) int8 with a (1, out) scale -> (..., out)
    in x's dtype: the product summed in float32, times the float32 scale,
    rounded once, as ``_int8_mv_kernel`` does."""
    y = (x.to(torch.float32) @ q.to(torch.float32)) * scale.to(torch.float32)
    return y.to(x.dtype)


def int8_matmul(x: torch.Tensor, q: torch.Tensor,
                scale: torch.Tensor) -> torch.Tensor:
    """One row: x (..., in) with a single row, q (in, out) int8, scale
    (1, out) -> (..., out) in x's dtype."""
    if x.device.type == "cpu":
        return int8_matmul_plain(x, q, scale)
    if x.device.type != "cuda":
        raise ValueError(f"int8_matmul: no kernel for device {x.device}")
    in_, out = q.shape
    if (x.numel() != in_ or x.shape[-1] != in_ or scale.shape != (1, out)
            or out % COLS_PER_THREAD):
        raise ValueError(f"int8_matmul: unsupported shapes x "
                         f"{tuple(x.shape)} q {tuple(q.shape)} scale "
                         f"{tuple(scale.shape)}")
    for name, t, dt in (("x", x, torch.bfloat16), ("q", q, torch.int8),
                        ("scale", scale, torch.bfloat16)):
        if t.dtype != dt or not t.is_contiguous() or t.device != x.device \
                or t.data_ptr() % 16:
            raise ValueError(f"int8_matmul: {name} must be a contiguous, "
                             f"16-byte aligned {dt} tensor on {x.device}")
    y = torch.empty((*x.shape[:-1], out), dtype=x.dtype, device=x.device)
    err = _build.library().v3d_int8_matvec(
        x.data_ptr(), q.data_ptr(), scale.data_ptr(), y.data_ptr(), in_, out,
        torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(err, "int8_matmul")
    _build.count_launch("int8_matvec")
    return y
