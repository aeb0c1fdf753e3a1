"""SigLIP vision tower (so400m-patch14-384) in PyTorch: counterpart of
``video3d_tpu/models/siglip.py``.

Same parameter layout as the JAX tree (matrices stored (in, out), used as
``x @ w``): ``patch_embed {w (3*ps*ps, D), b}``, ``pos_embed (N, D)``,
``layers[i] {ln1, attn {wq,bq,wk,bk,wv,bv,wo,bo}, ln2, mlp {w1,b1,w2,b2}}``.
The tower's attention is plain matmul + softmax, as the JAX package keeps
it (a dense einsum, not a kernel). ``vision_tower_forward(remat=True)``
runs each encoder layer under ``torch.utils.checkpoint`` (training).
"""

from __future__ import annotations

from typing import Any, Dict

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from video3d_tpu_torch.config import VisionConfig
from video3d_tpu_torch.models.quant import matmul as _mm

Params = Dict[str, Any]


def _layer_norm(x, scale, bias, eps):
    x32 = x.to(torch.float32)
    mean = x32.mean(dim=-1, keepdim=True)
    var = ((x32 - mean) ** 2).mean(dim=-1, keepdim=True)
    y = (x32 - mean) * torch.rsqrt(var + eps)
    return (y * scale + bias).to(x.dtype)


def gelu_tanh(x):
    """'gelu_pytorch_tanh' activation."""
    return F.gelu(x, approximate="tanh")


def patchify(pixel_values: torch.Tensor, patch_size: int) -> torch.Tensor:
    """(B, 3, H, W) -> (B, num_patches, 3*ps*ps) in (c, kh, kw) order;
    trailing pixels beyond a multiple of ps are dropped (valid conv)."""
    B, C, H, W = pixel_values.shape
    gh, gw = H // patch_size, W // patch_size
    x = pixel_values[:, :, :gh * patch_size, :gw * patch_size]
    x = x.reshape(B, C, gh, patch_size, gw, patch_size)
    x = x.permute(0, 2, 4, 1, 3, 5)                 # (B, gh, gw, C, ps, ps)
    return x.reshape(B, gh * gw, C * patch_size * patch_size)


def attention(p: Params, x: torch.Tensor, num_heads: int) -> torch.Tensor:
    """Bidirectional multi-head attention over the patch tokens."""
    B, N, D = x.shape
    hd = D // num_heads
    q = (_mm(x, p["wq"]) + p["bq"]).reshape(B, N, num_heads, hd) \
        .transpose(1, 2)
    k = (_mm(x, p["wk"]) + p["bk"]).reshape(B, N, num_heads, hd) \
        .transpose(1, 2)
    v = (_mm(x, p["wv"]) + p["bv"]).reshape(B, N, num_heads, hd) \
        .transpose(1, 2)
    scores = (q @ k.transpose(-1, -2)) * (hd ** -0.5)
    probs = torch.softmax(scores.to(torch.float32), dim=-1).to(x.dtype)
    out = (probs @ v).transpose(1, 2).reshape(B, N, D)
    return _mm(out, p["wo"]) + p["bo"]


def encoder_layer(p: Params, x: torch.Tensor, cfg: VisionConfig) -> torch.Tensor:
    h = _layer_norm(x, p["ln1"]["scale"], p["ln1"]["bias"], cfg.layer_norm_eps)
    x = x + attention(p["attn"], h, cfg.num_attention_heads)
    h = _layer_norm(x, p["ln2"]["scale"], p["ln2"]["bias"], cfg.layer_norm_eps)
    h = _mm(gelu_tanh(_mm(h, p["mlp"]["w1"]) + p["mlp"]["b1"]),
            p["mlp"]["w2"]) + p["mlp"]["b2"]
    return x + h


def vision_tower_forward(params: Params, pixel_values: torch.Tensor,
                         cfg: VisionConfig, remat: bool = False
                         ) -> torch.Tensor:
    """(B, 3, S, S) normalized pixels -> (B, num_patches, hidden) features of
    the last kept encoder layer (no post-layernorm). ``remat``: each encoder
    layer under non-reentrant ``torch.utils.checkpoint``, recomputed in the
    backward pass (JAX ``jax.checkpoint(encoder_layer)``)."""
    if cfg.tower_pad_seq is not None:
        raise NotImplementedError("tower_pad_seq is not ported")
    w = params["patch_embed"]["w"]
    x = patchify(pixel_values, cfg.patch_size).to(w.dtype)
    x = x @ w + params["patch_embed"]["b"] + params["pos_embed"]
    for lp in params["layers"]:
        if remat:
            x = checkpoint(encoder_layer, lp, x, cfg, use_reentrant=False)
        else:
            x = encoder_layer(lp, x, cfg)
    return x


def init_vision_tower(cfg: VisionConfig, device, generator: torch.Generator,
                      dtype=torch.float32) -> Params:
    """Random init with the JAX package's distributions, made on ``device``:
    linears U(-1/sqrt(in), 1/sqrt(in)), zero biases, unit LN scales,
    N(0, 0.02) position table."""
    D, I = cfg.hidden_size, cfg.intermediate_size
    pdim = 3 * cfg.patch_size * cfg.patch_size

    def linear(din, dout):
        lim = (1.0 / din) ** 0.5
        return torch.empty(din, dout, device=device, dtype=dtype).uniform_(
            -lim, lim, generator=generator)

    def zeros(n):
        return torch.zeros(n, device=device, dtype=dtype)

    def ones(n):
        return torch.ones(n, device=device, dtype=dtype)

    def layer():
        return {
            "ln1": {"scale": ones(D), "bias": zeros(D)},
            "attn": {"wq": linear(D, D), "bq": zeros(D),
                     "wk": linear(D, D), "bk": zeros(D),
                     "wv": linear(D, D), "bv": zeros(D),
                     "wo": linear(D, D), "bo": zeros(D)},
            "ln2": {"scale": ones(D), "bias": zeros(D)},
            "mlp": {"w1": linear(D, I), "b1": zeros(I),
                    "w2": linear(I, D), "b2": zeros(D)},
        }

    return {
        "patch_embed": {"w": linear(pdim, D), "b": zeros(D)},
        "pos_embed": torch.empty(cfg.num_patches, D, device=device,
                                 dtype=dtype).normal_(0.0, 0.02,
                                                      generator=generator),
        "layers": [layer() for _ in range(cfg.num_hidden_layers)],
    }
