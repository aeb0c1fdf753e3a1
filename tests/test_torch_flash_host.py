"""Host logic of the Hopper flash kernels (B2's prefill form and B6), on the
CPU: B6's packed per-row inputs, delta, and its launch glue with a
stand-in library (the f32 dQ scratch zeroed before the launch and rounded
to bf16 after; the shapes handed to the C entry, which encodes the tensor
maps and plans the grid itself)."""

import ctypes

import numpy as np
import pytest
import torch

from video3d_tpu_torch.kernels import _build
from video3d_tpu_torch.kernels import flash_attention as fa


def test_bwd_rows_pack_lse_and_delta():
    rng = np.random.default_rng(2)
    lse = torch.from_numpy(rng.normal(size=(2, 3, 129)).astype(np.float32))
    delta = torch.from_numpy(rng.normal(size=(2, 3, 129)).astype(np.float32))
    rows = fa.bwd_rows(lse, delta)
    assert rows.shape == (2, 3, 2, 132) and rows.dtype == torch.float32
    assert torch.equal(rows[:, :, 0, :129], lse * fa.LOG2E)
    assert torch.equal(rows[:, :, 1, :129], delta)
    assert float(rows[..., 129:].abs().max()) == 0.0


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_bwd_delta_leaves_its_inputs(dtype):
    """delta = rowsum(dO * O) in f32, (B, H, L); dO and O are not written,
    also when dO is already f32."""
    rng = np.random.default_rng(3)
    out = torch.from_numpy(rng.normal(size=(2, 5, 3, 128))
                           .astype(np.float32)).to(dtype)
    do = torch.from_numpy(rng.normal(size=(2, 5, 3, 128))
                          .astype(np.float32)).to(dtype)
    out0, do0 = out.clone(), do.clone()
    delta = fa.bwd_delta(out, do)
    assert torch.equal(out, out0) and torch.equal(do, do0)
    assert delta.shape == (2, 3, 5) and delta.dtype == torch.float32
    ref = (do.double() * out.double()).sum(-1).transpose(1, 2)
    np.testing.assert_allclose(delta.numpy(), ref.numpy(), rtol=1e-5,
                               atol=1e-5)


class _Library:
    """Stands in for the kernel library: records each call's arguments and
    runs ``body`` on them."""

    def __init__(self, body):
        self.calls, self.body = [], body

    def __getattr__(self, name):
        if not name.startswith("v3d_"):
            raise AttributeError(name)

        def entry(*args):
            self.calls.append((name, args))
            self.body(name, args)
            return 0
        return entry


def _floats(ptr: int, n: int) -> np.ndarray:
    return np.ctypeslib.as_array((ctypes.c_float * n).from_address(ptr))


def test_bwd_launch_zeroes_the_dq_scratch_and_rounds_it():
    B, L, H, KV, hd = 2, 129, 4, 2, 128
    rng = np.random.default_rng(1)
    bf = lambda *s: torch.from_numpy(  # noqa: E731
        rng.normal(size=s).astype(np.float32)).bfloat16()
    q, k, v, do = bf(B, L, H, hd), bf(B, L, KV, hd), bf(B, L, KV, hd), \
        bf(B, L, H, hd)
    lse = torch.from_numpy(rng.normal(size=(B, H, L)).astype(np.float32))
    delta = torch.from_numpy(rng.normal(size=(B, H, L)).astype(np.float32))
    lens = torch.tensor([129, 1])
    added = rng.normal(size=B * L * H * hd).astype(np.float32)
    seen = {}

    def body(name, args):
        dq = _floats(args[6], B * L * H * hd)
        seen["zeroed"] = bool((dq == 0).all())
        seen["rows"] = _floats(args[4], B * H * 2 * fa.rows_len(L)).copy()
        seen["dims"] = args[9:15]
        dq += added                       # what the kernel's reductions add

    lib = _Library(body)
    before = _build.LAUNCHES["flash_attention_bwd"]
    dq, dk, dv = fa._bwd_launch(lib, 0, q, k, v, do, lse, delta, lens, True)
    assert [c[0] for c in lib.calls] == ["v3d_flash_attention_bwd"]
    assert len(lib.calls[0][1]) == len(
        _build._SIGNATURES["v3d_flash_attention_bwd"])
    assert _build.LAUNCHES["flash_attention_bwd"] == before + 1
    assert seen["zeroed"]
    np.testing.assert_array_equal(seen["rows"],
                                  fa.bwd_rows(lse, delta).numpy().ravel())
    assert seen["dims"] == (B, L, L, H, KV, 1)
    assert dq.dtype == torch.bfloat16 and dq.shape == q.shape
    assert torch.equal(dq, torch.from_numpy(added).reshape(q.shape)
                       .bfloat16())
    assert dk.shape == k.shape and dv.shape == v.shape
    args = lib.calls[0][1]
    assert args[:4] == (q.data_ptr(), k.data_ptr(), v.data_ptr(),
                        do.data_ptr())
    assert args[7:9] == (dk.data_ptr(), dv.data_ptr())
