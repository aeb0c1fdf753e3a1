"""The port's CUDA kernels against their plain PyTorch versions, on the GPU
at small shapes. Marked ``cuda``; they skip without a CUDA device. Run on a
machine with one (no JAX needed there):

    python -m pytest tests/test_torch_cuda.py -m cuda --noconftest -q
"""

import pytest
import torch

from video3d_tpu_torch.kernels import _build
from video3d_tpu_torch.kernels import decode_attention as da
from video3d_tpu_torch.kernels import flash_attention as fa
from video3d_tpu_torch.kernels import fused_geometry as fg

pytestmark = pytest.mark.cuda

BF16_ATOL = 2e-2   # bf16 outputs of magnitude < 4: about one ulp


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", 0)


def _launched(name, fn):
    before = _build.LAUNCHES[name]
    out = fn()
    torch.cuda.synchronize()
    assert _build.LAUNCHES[name] == before + 1
    return out


@pytest.mark.parametrize("discretize", [True, False])
def test_fused_geometry_kernel(dev, discretize):
    g = torch.Generator().manual_seed(0)
    V, H, W = 3, 480, 640
    depths = torch.randint(200, 8000, (V, H, W), generator=g,
                           dtype=torch.int32).to(dev)
    intr = torch.eye(4)
    intr[0, 0], intr[1, 1], intr[0, 2], intr[1, 2] = 577.87, 577.87, 319.5, 239.5
    a, _ = torch.linalg.qr(torch.randn(V, 3, 3, generator=g))
    poses = torch.eye(4).repeat(V, 1, 1)
    poses[:, :3, :3] = a
    poses[:, :3, 3] = torch.rand(V, 3, generator=g) * 4 - 2
    args = (depths, intr.to(dev), poses.to(dev))
    got = _launched("fused_geometry", lambda: fg.fused_patch_voxel_coords(
        *args, discretize=discretize))
    ref = fg.reference_patch_voxel_coords(*args, discretize=discretize)
    diff = (got - ref).abs()
    if discretize:
        assert float((diff > 0).float().mean()) <= 1e-3
        assert float(diff.max()) <= 1
    else:
        assert float(diff.max()) <= 1e-3


@pytest.mark.parametrize("causal", [True, False])
def test_flash_kernel(dev, causal):
    g = torch.Generator(device=dev).manual_seed(1)
    B, L, H, KV, hd = 2, 300, 4, 2, 128
    q = torch.randn(B, L, H, hd, generator=g, device=dev).bfloat16()
    k = torch.randn(B, L, KV, hd, generator=g, device=dev).bfloat16()
    v = (0.5 * torch.randn(B, L, KV, hd, generator=g, device=dev)).bfloat16()
    lens = torch.tensor([300, 150], dtype=torch.int32, device=dev)
    got = _launched("flash_attention", lambda: fa.flash_attention(
        q, k, v, lengths=lens, causal=causal))
    ref = fa.flash_attention_plain(q, k, v, lengths=lens, causal=causal)
    assert bool(torch.isfinite(got.float()).all())
    for b, n in enumerate((300, 150)):
        assert float((got[b, :n].float() - ref[b, :n].float()).abs().max()) \
            <= BF16_ATOL


def test_decode_kernel(dev):
    g = torch.Generator(device=dev).manual_seed(2)
    NL, B, S, H, KV, hd, layer = 2, 3, 600, 8, 2, 128, 1
    q = torch.randn(B, 1, H, hd, generator=g, device=dev).bfloat16()
    k_all = torch.randn(NL, B, S, KV * hd, generator=g, device=dev).bfloat16()
    v_all = torch.randn(NL, B, S, KV * hd, generator=g, device=dev).bfloat16()
    kv_len = torch.tensor([600, 257, 1], dtype=torch.int32, device=dev)
    got = _launched("decode_attention", lambda: da.decode_attention(
        q, k_all, v_all, kv_len, layer, KV))
    ref = da.decode_attention_plain(q, k_all, v_all, kv_len, layer, KV)
    assert float((got.float() - ref.float()).abs().max()) <= BF16_ATOL


def test_wrappers_reject_what_the_kernels_do_not_take(dev):
    q = torch.zeros(1, 64, 4, 128, device=dev)             # float32
    kv = torch.zeros(1, 64, 2, 128, device=dev)
    with pytest.raises(ValueError):
        fa.flash_attention(q, kv, kv)
    qb = torch.zeros(1, 64, 4, 64, device=dev, dtype=torch.bfloat16)
    kvb = torch.zeros(1, 64, 2, 64, device=dev, dtype=torch.bfloat16)
    with pytest.raises(ValueError):                        # head dim 64
        fa.flash_attention(qb, kvb, kvb)
    cache = torch.zeros(2, 1, 16, 256, device=dev, dtype=torch.bfloat16)
    q1 = torch.zeros(1, 1, 4, 128, device=dev, dtype=torch.bfloat16)
    with pytest.raises(ValueError):                        # no layer 2
        da.decode_attention(q1, cache, cache,
                            torch.ones(1, dtype=torch.int32, device=dev), 2, 2)
