"""The vision resamplers (the reference's multimodal_resampler/ family) in
PyTorch: counterpart of ``video3d_tpu/models/resampler.py``.

``mm_resampler_type`` picks one of five (multimodal_resampler/builder.py
:21-32): identity (the default, and the only one the 3D recipe routes
through: the reference's encode_images has the resampler call commented
out, llava_arch.py:277), ``spatial_pool``, ``masked_drop``, ``perceiver``
(flamingo-pytorch's resampler) and ``qformer`` (a BLIP-2 query-only
BERT-base with cross-attention every k layers). Pure functions over
parameter trees laid out as JAX's; the pooling conv is a reshape and a
product (equal to Conv2d with kernel = stride). ``masked_drop``'s noise is
an argument, or drawn from an explicit ``torch.Generator``: JAX draws it
with ``jax.random``, so the tests hand both packages the same noise.
Attention is plain matmul + softmax, as JAX's einsums.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

Params = Dict[str, Any]


def _layer_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                eps: float) -> torch.Tensor:
    """Normalised in f32, cast back, then scale and bias (JAX's order)."""
    xf = x.to(torch.float32)
    mu = xf.mean(dim=-1, keepdim=True)
    var = xf.var(dim=-1, unbiased=False, keepdim=True)
    return ((xf - mu) * torch.rsqrt(var + eps)).to(x.dtype) * scale + bias


# ---------------------------------------------------------------------------
# spatial_pool (spatial_pool.py:6-45)
# ---------------------------------------------------------------------------

def spatial_pool(p: Params, image_features: torch.Tensor,
                 images_hw: Tuple[int, int], mode: str = "average",
                 stride: int = 2) -> torch.Tensor:
    """Pool the (B, N, F) token grid by ``stride``: 'average', 'max' or
    'conv' (p = {conv_w, conv_b}). The grid comes from the images' pixel
    shape as the reference derives it (``ori_W = int(sqrt(N * W // H))``,
    ``ori_H = ori_W * H // W``, then an ori_H x ori_H view, spatial_pool.py
    :24-25). Returns (B, (ori_H // stride) ** 2, F_out)."""
    H, W = images_hw
    B, N, Fd = image_features.shape
    ori_w = int((N * W // H) ** 0.5)
    ori_h = ori_w * H // W
    x = image_features.reshape(B, ori_h, ori_h, Fd)
    out = ori_h // stride
    x = x[:, :out * stride, :out * stride]
    x = x.reshape(B, out, stride, out, stride, Fd)
    if mode == "average":
        x = x.mean(dim=(2, 4))
    elif mode == "max":
        x = x.amax(dim=(2, 4))
    elif mode == "conv":
        x = x.permute(0, 1, 3, 2, 4, 5).reshape(B, out, out,
                                                stride * stride * Fd)
        x = x @ p["conv_w"] + p["conv_b"]
    else:
        raise ValueError(f"Unknown pooling mode: {mode}")
    return x.reshape(B, out * out, -1)


def init_spatial_pool(hidden_size: int, out_channels: int, device,
                      generator: torch.Generator, stride: int = 2,
                      mode: str = "conv", dtype=torch.float32) -> Params:
    if mode != "conv":
        return {}
    return {"conv_w": torch.empty(stride * stride * hidden_size,
                                  out_channels, device=device,
                                  dtype=dtype).normal_(0.0, 0.02,
                                                       generator=generator),
            "conv_b": torch.zeros(out_channels, device=device, dtype=dtype)}


# ---------------------------------------------------------------------------
# masked_drop (masked_drop.py:7-80)
# ---------------------------------------------------------------------------

def random_masking(x: torch.Tensor, len_keep: int, noise: torch.Tensor
                   ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """A random token subset per sample by the argsort of ``noise`` (B, L)
    (masked_drop.py:57-80): (x_masked (B, len_keep, D), mask (B, L) with 0
    where kept, ids_restore (B, L))."""
    ids_shuffle = torch.argsort(noise, dim=1, stable=True)
    ids_restore = torch.argsort(ids_shuffle, dim=1, stable=True)
    ids_keep = ids_shuffle[:, :len_keep]
    x_masked = torch.gather(
        x, 1, ids_keep[:, :, None].expand(-1, -1, x.shape[-1]))
    mask = torch.ones(noise.shape, dtype=x.dtype, device=x.device)
    mask[:, :len_keep] = 0
    return x_masked, torch.gather(mask, 1, ids_restore), ids_restore


def masked_drop(image_features: torch.Tensor,
                noise: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None,
                mode: str = "fixed", ratio: float = 0.5,
                training: bool = True,
                num_keep: Optional[int] = None) -> torch.Tensor:
    """Training-time token dropping (masked_drop.py:17-43). Eval returns the
    input (the reference's skip draw is host-side: callers make it);
    'range' takes its host-drawn ``num_keep``. The (B, N) uniform ``noise``
    is given, or drawn from ``generator`` on the features' device."""
    if not training:
        return image_features
    if mode == "cls_only":
        return image_features[:, :1]
    if mode not in ("fixed", "range"):
        raise ValueError(f"Unexpected masked drop mode: {mode}")
    n_tokens = image_features.shape[1]
    keep = num_keep if num_keep is not None else int(n_tokens * ratio)
    if noise is None:
        noise = torch.rand(image_features.shape[:2], generator=generator,
                           device=image_features.device)
    return random_masking(image_features, keep, noise)[0]


# ---------------------------------------------------------------------------
# perceiver (perceiver.py, flamingo-pytorch's PerceiverResampler)
# ---------------------------------------------------------------------------

def _perceiver_attention(p: Params, x: torch.Tensor, latents: torch.Tensor,
                         heads: int) -> torch.Tensor:
    """PerceiverAttention.forward (perceiver.py:44-71): the latents query
    [media; latents]; bias-free linears; LayerNorm eps 1e-5; softmax of the
    max-shifted scores."""
    x = _layer_norm(x, p["ln_media_s"], p["ln_media_b"], 1e-5)
    lat = _layer_norm(latents, p["ln_latents_s"], p["ln_latents_b"], 1e-5)
    inner = p["to_q"].shape[1]
    dim_head = inner // heads
    q = lat @ p["to_q"]
    k, v = (torch.cat([x, lat], dim=-2) @ p["to_kv"]).chunk(2, dim=-1)

    def split_heads(t):
        B, n = t.shape[:2]
        return t.reshape(B, n, heads, dim_head).transpose(1, 2)

    q, k, v = map(split_heads, (q, k, v))
    sim = (q * dim_head ** -0.5) @ k.transpose(-1, -2)
    sim = sim - sim.amax(dim=-1, keepdim=True).detach()
    out = torch.softmax(sim, dim=-1) @ v
    B, _, n, _ = out.shape
    return out.transpose(1, 2).reshape(B, n, inner) @ p["to_out"]


def perceiver_resampler(p: Params, image_features: torch.Tensor,
                        heads: int = 8) -> torch.Tensor:
    """PerceiverResampler.forward (perceiver.py:120-155) as the builder
    configures it (one frame, one medium, no time embeddings): (B, N, D) ->
    (B, num_latents, D)."""
    B = image_features.shape[0]
    latents = p["latents"].expand(B, *p["latents"].shape)
    for layer in p["layers"]:
        latents = _perceiver_attention(layer["attn"], image_features,
                                       latents, heads) + latents
        ff = layer["ff"]
        h = _layer_norm(latents, ff["ln_s"], ff["ln_b"], 1e-5)
        latents = F.gelu(h @ ff["w1"]) @ ff["w2"] + latents
    return _layer_norm(latents, p["norm_s"], p["norm_b"], 1e-5)


def init_perceiver(dim: int, device, generator: torch.Generator,
                   depth: int = 3, num_latents: int = 32, ff_mult: int = 4,
                   dim_head: int = 64, heads: int = 8,
                   dtype=torch.float32) -> Params:
    """Random perceiver with JAX ``init_perceiver``'s distributions."""
    inner = dim_head * heads

    def normal(*shape, std=0.02):
        return torch.empty(shape, device=device, dtype=dtype).normal_(
            0.0, std, generator=generator)

    def ones(n):
        return torch.ones(n, device=device, dtype=dtype)

    def zeros(n):
        return torch.zeros(n, device=device, dtype=dtype)

    layers = [{"attn": {"ln_media_s": ones(dim), "ln_media_b": zeros(dim),
                        "ln_latents_s": ones(dim),
                        "ln_latents_b": zeros(dim),
                        "to_q": normal(dim, inner),
                        "to_kv": normal(dim, 2 * inner),
                        "to_out": normal(inner, dim)},
               "ff": {"ln_s": ones(dim), "ln_b": zeros(dim),
                      "w1": normal(dim, dim * ff_mult),
                      "w2": normal(dim * ff_mult, dim)}}
              for _ in range(depth)]
    return {"latents": normal(num_latents, dim, std=1.0), "layers": layers,
            "norm_s": ones(dim), "norm_b": zeros(dim)}


# ---------------------------------------------------------------------------
# qformer (qformer.py, BLIP-2's query-only BERT-base)
# ---------------------------------------------------------------------------

_BERT_EPS = 1e-12


def _bert_attention(p: Params, h: torch.Tensor, kv: torch.Tensor,
                    num_heads: int) -> torch.Tensor:
    """BertAttention, self or cross, with BertSelfOutput
    (qformer.py:107-263): the dense context residual-added and
    LayerNormed."""
    B, L, D = h.shape
    dh = D // num_heads

    def split_heads(t):
        return t.reshape(B, -1, num_heads, dh).transpose(1, 2)

    q = split_heads(h @ p["wq"] + p["bq"])
    k = split_heads(kv @ p["wk"] + p["bk"])
    v = split_heads(kv @ p["wv"] + p["bv"])
    probs = torch.softmax((q @ k.transpose(-1, -2)) / (dh ** 0.5), dim=-1)
    ctx = (probs @ v).transpose(1, 2).reshape(B, L, D)
    return _layer_norm(ctx @ p["wo"] + p["bo"] + h, p["ln_s"], p["ln_b"],
                       _BERT_EPS)


def qformer_resampler(p: Params, image_features: torch.Tensor,
                      num_heads: int = 12) -> torch.Tensor:
    """Qformer.forward: ln_vision on the tower tokens, the learned query
    tokens through a query-only BERT (per layer: self-attention over the
    queries, cross-attention to the vision tokens on the layers that have
    it, the query FFN). Returns (B, num_latents, 768)."""
    x = _layer_norm(image_features, p["ln_vision_s"], p["ln_vision_b"], 1e-5)
    B = x.shape[0]
    h = p["query_tokens"].expand(B, *p["query_tokens"].shape)
    h = _layer_norm(h, p["emb_ln_s"], p["emb_ln_b"], _BERT_EPS)
    for layer in p["layers"]:
        h = _bert_attention(layer["self"], h, h, num_heads)
        if "cross" in layer:
            h = _bert_attention(layer["cross"], h, x, num_heads)
        ffn = layer["ffn"]
        inter = F.gelu(h @ ffn["w1"] + ffn["b1"])
        h = _layer_norm(inter @ ffn["w2"] + ffn["b2"] + h, ffn["ln_s"],
                        ffn["ln_b"], _BERT_EPS)
    return h


def init_qformer(encoder_width: int, device, generator: torch.Generator,
                 num_latents: int = 32, cross_attention_freq: int = 2,
                 num_layers: int = 12, hidden: int = 768,
                 intermediate: int = 3072, dtype=torch.float32) -> Params:
    """Random Q-Former with bert-base geometry and cross-attention on the
    layers where ``layer % cross_attention_freq == 0`` (JAX
    ``init_qformer``'s distributions)."""
    def normal(*shape):
        return torch.empty(shape, device=device, dtype=dtype).normal_(
            0.0, 0.02, generator=generator)

    def ones(n):
        return torch.ones(n, device=device, dtype=dtype)

    def zeros(n):
        return torch.zeros(n, device=device, dtype=dtype)

    def attn(kv_dim):
        return {"wq": normal(hidden, hidden), "bq": zeros(hidden),
                "wk": normal(kv_dim, hidden), "bk": zeros(hidden),
                "wv": normal(kv_dim, hidden), "bv": zeros(hidden),
                "wo": normal(hidden, hidden), "bo": zeros(hidden),
                "ln_s": ones(hidden), "ln_b": zeros(hidden)}

    layers = []
    for i in range(num_layers):
        layer = {"self": attn(hidden),
                 "ffn": {"w1": normal(hidden, intermediate),
                         "b1": zeros(intermediate),
                         "w2": normal(intermediate, hidden),
                         "b2": zeros(hidden), "ln_s": ones(hidden),
                         "ln_b": zeros(hidden)}}
        if i % cross_attention_freq == 0:
            layer["cross"] = attn(encoder_width)
        layers.append(layer)
    return {"ln_vision_s": ones(encoder_width),
            "ln_vision_b": zeros(encoder_width),
            "query_tokens": torch.zeros(num_latents, hidden, device=device,
                                        dtype=dtype),
            "emb_ln_s": ones(hidden), "emb_ln_b": zeros(hidden),
            "layers": layers}


# ---------------------------------------------------------------------------
# dispatch (builder.py:21-32)
# ---------------------------------------------------------------------------

def apply_resampler(resampler_type: Optional[str], p: Params,
                    image_features: torch.Tensor, *,
                    images_hw: Tuple[int, int] = (384, 384),
                    mode: Optional[str] = None, stride: int = 2,
                    noise: Optional[torch.Tensor] = None,
                    generator: Optional[torch.Generator] = None,
                    ratio: float = 0.5, training: bool = False
                    ) -> torch.Tensor:
    """build_vision_resampler's dispatch; None -> identity. ``mode``
    defaults per resampler: spatial_pool 'average' (mm_spatial_pool_mode),
    masked_drop 'fixed' (mm_mask_drop_mode). masked_drop's noise comes
    from ``noise`` or ``generator`` (JAX: ``rng``)."""
    if resampler_type in (None, "identity"):
        return image_features
    if resampler_type == "spatial_pool":
        return spatial_pool(p, image_features, images_hw, mode or "average",
                            stride)
    if resampler_type == "masked_drop":
        return masked_drop(image_features, noise, generator,
                           mode=mode or "fixed", ratio=ratio,
                           training=training)
    if resampler_type == "perceiver":
        return perceiver_resampler(p, image_features)
    if resampler_type == "qformer":
        return qformer_resampler(p, image_features)
    raise ValueError(f"Unknown resampler type: {resampler_type}")
