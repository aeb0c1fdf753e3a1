"""Weight-streaming products with quantized weights and their plain PyTorch
versions: kernel B4 (int8, ``_int8_mv_kernel`` at one row and
``_int8_kernel`` at 1-32 rows) and kernel B8 (int4, ``_int4_kernel``).

Each wrapper dispatches on the device of ``x``: a CPU tensor runs the plain
version; a CUDA tensor launches the kernel or raises. Counterpart of
``video3d_tpu/kernels/quant_matvec.py``:

* :func:`int8_matvec` -- B4's one-row form (``csrc/int8_matvec.cu``), the
  B=1 vocab head;
* :func:`int8_matmul` -- B4's B>1 form (``csrc/int8_matmul.cu``), 1-32
  rows, the int8 configuration's decode projections;
* :func:`int4_matmul` -- B8 (``csrc/int4_matmul.cu``), 1-32 rows, every
  int4 decode projection and head.

B4's B>1 form and B8 share one template (``csrc/weight_stream.cuh``) that
reads each weight byte from HBM once for up to 16 rows of x and unpacks it
in registers into bf16 tensor-core products.
"""

from __future__ import annotations

import torch

from video3d_tpu_torch.kernels import _build

COLS_PER_THREAD = 16     # int8 columns one thread of B4's matvec streams
STREAM_COLS = 8          # weight columns per 8-byte load of the streaming kernels
STREAM_TILE = 64         # output columns per block of the streaming kernels
STREAM_CHUNK = 512       # inputs per split unit (and the int4 group) there
MAX_ROWS = 32            # rows of x the streaming kernels take
ROWS_PER_BLOCK = 16      # rows of x one block streams the weight for

_entries = {}        # C entry point -> ctypes function
_split_counts = {}   # (device, rows, out, chunks) -> splits


def pack_int4(q: torch.Tensor, dim: int = 0) -> torch.Tensor:
    """int8 values in [-7, 7] -> int8 bytes with ``dim`` halved: byte p
    holds index 2p in its low nibble and 2p + 1 in its high nibble, each
    two's complement. ``dim=0``: the (in, out) int4 weights (JAX
    ``quantize_weight_int4``); ``dim=-1``: the int4 KV cache, two channels
    of a token row per byte."""
    d = dim % q.dim()
    pairs = q.unflatten(d, (q.shape[d] // 2, 2))
    return (pairs.select(d + 1, 0) & 0x0F) | (pairs.select(d + 1, 1) << 4)


def unpack_int4(packed: torch.Tensor, dim: int = 0) -> torch.Tensor:
    """The inverse of :func:`pack_int4` (int8 or uint8 bytes) -> int8
    values in [-7, 7] with ``dim`` doubled, as the JAX ``unpack_int4``
    along dim 0: index 2p from the low nibble of byte p, 2p + 1 from its
    high nibble, each sign-extended."""
    c = packed.to(torch.int32)
    lo = (c << 28) >> 28
    hi = (c << 24) >> 28
    d = dim % packed.dim()
    return torch.stack([lo, hi], dim=d + 1).flatten(d, d + 1).to(torch.int8)


def int8_matmul_plain(x: torch.Tensor, q: torch.Tensor,
                      scale: torch.Tensor) -> torch.Tensor:
    """x (..., in) @ q (in, out) int8 with a (1, out) scale -> (..., out)
    in x's dtype, as the JAX ``int8_matmul`` computes it: the product
    summed in float32, times the float32 scale, rounded once; one row of x
    enters in float32 (``_int8_mv_kernel``), more rows rounded to bf16
    first (``_int8_kernel``)."""
    xf = x.to(torch.float32)
    if x.numel() != x.shape[-1]:
        xf = x.to(torch.bfloat16).to(torch.float32)
    y = (xf @ q.to(torch.float32)) * scale.to(torch.float32)
    return y.to(x.dtype)


def int4_matmul_plain(x: torch.Tensor, packed: torch.Tensor,
                      scales: torch.Tensor, group: int = 512) -> torch.Tensor:
    """x (..., in_p) @ int4-packed (in_p/2, out_p) with (in_p/group, out_p)
    scales -> (..., out_p) in x's dtype, as ``_int4_kernel`` computes it: x
    rounded to bf16, one float32 product per input group of the bf16 rows
    against the group's nibbles, each times that group's float32 scale,
    summed in float32, rounded once."""
    *lead, in_p = x.shape
    n_g, out_p = scales.shape
    xg = x.reshape(-1, n_g, group).to(torch.bfloat16).to(torch.float32)
    nib = unpack_int4(packed).to(torch.float32).reshape(n_g, group, out_p)
    part = torch.bmm(xg.transpose(0, 1), nib)            # (n_g, rows, out_p)
    y = (part * scales.to(torch.float32)[:, None, :]).sum(dim=0)
    return y.reshape(*lead, out_p).to(x.dtype)


def _device_checks(name: str, x: torch.Tensor, tensors) -> int:
    """Raise unless x is on a CUDA device and every (arg, tensor, dtype) is
    a contiguous, 16-byte aligned tensor of that dtype on x's device;
    returns the device index."""
    if x.device.type != "cuda":
        raise ValueError(f"{name}: no kernel for device {x.device}")
    index = x.get_device()
    for arg, t, dt in tensors:
        if t.dtype != dt or not t.is_contiguous() \
                or t.get_device() != index or t.data_ptr() % 16:
            raise ValueError(f"{name}: {arg} must be a contiguous, 16-byte "
                             f"aligned {dt} tensor on {x.device}")
    return index


def _entry(name: str):
    """The C entry point ``name`` of the kernel library (built on first
    use), looked up once."""
    fn = _entries.get(name)
    if fn is None:
        fn = _entries[name] = getattr(_build.library(), name)
    return fn


def _stream(index: int) -> int:
    """The current CUDA stream of device ``index``, as a raw handle."""
    return torch._C._cuda_getCurrentRawStream(index)


def int8_matvec(x: torch.Tensor, q: torch.Tensor,
                scale: torch.Tensor) -> torch.Tensor:
    """B4's one-row matvec: x (..., in) with a single row, q (in, out)
    int8, scale (1, out) -> (..., out) in x's dtype."""
    if x.device.type == "cpu":
        return int8_matmul_plain(x, q, scale)
    in_, out = q.shape
    if (x.numel() != in_ or x.shape[-1] != in_ or scale.shape != (1, out)
            or out % COLS_PER_THREAD):
        raise ValueError(f"int8_matvec: unsupported shapes x "
                         f"{tuple(x.shape)} q {tuple(q.shape)} scale "
                         f"{tuple(scale.shape)}")
    index = _device_checks("int8_matvec", x, (("x", x, torch.bfloat16),
                                              ("q", q, torch.int8),
                                              ("scale", scale,
                                               torch.bfloat16)))
    y = torch.empty((*x.shape[:-1], out), dtype=x.dtype, device=x.device)
    err = _entry("v3d_int8_matvec")(
        x.data_ptr(), q.data_ptr(), scale.data_ptr(), y.data_ptr(), in_, out,
        _stream(index))
    _build.check(err, "int8_matvec")
    _build.count_launch("int8_matvec")
    return y


def _splits(index: int, rows: int, out: int, chunks: int) -> int:
    """Input chunks are split over this many blocks per output tile (each
    writes a float32 partial, summed in order by a second pass) until the
    grid has about four 128-thread blocks per SM; 1 when the output tiles
    alone fill the card. Computed once per (device, rows, out, chunks)."""
    key = (index, rows, out, chunks)
    splits = _split_counts.get(key)
    if splits is None:
        sms = torch.cuda.get_device_properties(index).multi_processor_count
        tiles = -(-rows // ROWS_PER_BLOCK) * -(-out // STREAM_TILE)
        want = min(chunks, max(1, -(-4 * sms // tiles)))
        per = -(-chunks // want)
        splits = _split_counts[key] = -(-chunks // per)
    return splits


def _launch_stream(name: str, entry: str, index: int, x: torch.Tensor,
                   w: torch.Tensor, scale: torch.Tensor, in_: int, out: int,
                   extra=()):
    """Launch a weight-streaming kernel on x (..., in_) -> (..., out); the
    float32 partials of a split product go to a workspace, which a
    product of one split does without."""
    rows = x.numel() // max(in_, 1)
    if not 1 <= rows <= MAX_ROWS:
        raise ValueError(f"{name}: {rows} rows of x; the kernel takes 1-"
                         f"{MAX_ROWS}")
    splits = _splits(index, rows, out, -(-in_ // STREAM_CHUNK))
    y = torch.empty((*x.shape[:-1], out), dtype=x.dtype, device=x.device)
    ws = None
    if splits > 1:
        ws = torch.empty((splits, rows, out), dtype=torch.float32,
                         device=x.device)
    err = _entry(entry)(
        x.data_ptr(), w.data_ptr(), scale.data_ptr(), y.data_ptr(),
        None if ws is None else ws.data_ptr(), rows, in_, out, *extra,
        splits, _stream(index))
    _build.check(err, name)
    _build.count_launch(name)
    return y


def int8_matmul(x: torch.Tensor, q: torch.Tensor,
                scale: torch.Tensor) -> torch.Tensor:
    """B4's B>1 form: x (..., in) with 1-32 rows, q (in, out) int8, scale
    (1, out) -> (..., out) in x's dtype."""
    if x.device.type == "cpu":
        return int8_matmul_plain(x, q, scale)
    in_, out = q.shape
    if (x.shape[-1] != in_ or scale.shape != (1, out) or out % STREAM_COLS
            or in_ % 2):
        raise ValueError(f"int8_matmul: unsupported shapes x "
                         f"{tuple(x.shape)} q {tuple(q.shape)} scale "
                         f"{tuple(scale.shape)}")
    index = _device_checks("int8_matmul", x, (("x", x, torch.bfloat16),
                                              ("q", q, torch.int8),
                                              ("scale", scale,
                                               torch.bfloat16)))
    return _launch_stream("int8_matmul", "v3d_int8_matmul", index, x, q,
                          scale, in_, out)


def int4_matmul(x: torch.Tensor, packed: torch.Tensor, scales: torch.Tensor,
                group: int = 512) -> torch.Tensor:
    """B8: x (..., in_p) with 1-32 rows @ int4-packed (in_p/2, out_p) with
    (in_p/group, out_p) bf16 scales -> (..., out_p) in x's dtype."""
    if x.device.type == "cpu":
        return int4_matmul_plain(x, packed, scales, group)
    half, out_p = packed.shape
    in_p = 2 * half
    if (x.shape[-1] != in_p or group % STREAM_CHUNK or in_p % group
            or scales.shape != (in_p // group, out_p)
            or out_p % STREAM_TILE):
        raise ValueError(f"int4_matmul: unsupported shapes x "
                         f"{tuple(x.shape)} packed {tuple(packed.shape)} "
                         f"scales {tuple(scales.shape)} group {group}")
    index = _device_checks("int4_matmul", x, (("x", x, torch.bfloat16),
                                              ("packed", packed, torch.int8),
                                              ("scales", scales,
                                               torch.bfloat16)))
    return _launch_stream("int4_matmul", "v3d_int4_matmul", index, x, packed,
                          scales, in_p, out_p, (group,))
