"""Qwen2 decoder with 3-axis mRoPE, GQA and a stacked flat KV cache, in
PyTorch: counterpart of ``video3d_tpu/models/qwen2.py`` (the no-cache
training branch, differentiable through B2 with the logsumexp and B6, with
optional per-layer rematerialisation; the prefill, stacked single-token
decode, contiguous multi-token chunk and shared-prefix branches, and the
single-token paged decode over ``models/paged_kv.py``'s pools; a bf16 KV
cache, or an int8 or a packed int4 one with per-token, per-head scales;
dense weights, the int8 dicts or the ``Int4Weight`` of
``models/quant.py``). JAX's ``scan_layers`` (one ``lax.scan`` over stacked
layers, a compile-time device) is not ported: the port runs the layers in
a Python loop.

Parameter layout as in the JAX tree (matrices (in, out), used as
``x @ w``): ``embed_tokens (vocab, D)``, ``layers[i] {input_layernorm,
attn {wq, wk, wv, wo, bq, bk, bv}, post_attention_layernorm,
mlp {w_gate, w_up, w_down}}``, ``norm``, ``lm_head (D, vocab)``.

bf16 rounding points follow the JAX package: RMSNorm normalises in f32 and
casts to the activation dtype BEFORE the weight multiply; mRoPE cos/sin are
computed in f32 and cast to the query dtype inside ``apply_rotary``.
"""

from __future__ import annotations

import functools
from typing import Any, Dict, NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from video3d_tpu_torch.config import LLMConfig
from video3d_tpu_torch.kernels import quant_matvec as qm
from video3d_tpu_torch.kernels.attention import (mha, mha_cached_stacked,
                                                 mha_shared_prefix, mha_train,
                                                 paged_mha)
from video3d_tpu_torch.models import paged_kv, quant

Params = Dict[str, Any]


#: the int4 KV cache's tag, asked for where a torch dtype asks for the
#: others (``KVCache.zeros``, ``PagedKVCache.zeros``, the engine's
#: ``cache_dtype``): torch has no int4 storage the kernels can use, so the
#: values are stored packed, two per uint8 byte along the channels
#: (:func:`pack_kv_int4`), beside f32 scales shaped as int8's
KV_INT4 = "int4"


def kv_storage_dtype(cache_dtype) -> torch.dtype:
    """The torch dtype a cache of ``cache_dtype`` stores its values in:
    uint8 for :data:`KV_INT4` (or uint8 itself), else the dtype."""
    return torch.uint8 if cache_dtype == KV_INT4 else cache_dtype


def kv_layout(cfg: LLMConfig, cache_dtype) -> Tuple[torch.dtype, int, bool]:
    """(storage dtype, entries per token row, whether f32 scales go with
    the values) of a dense cache or a page pool of ``cache_dtype``: a row
    holds KV * hd values, or KV * hd / 2 bytes of packed int4."""
    storage = kv_storage_dtype(cache_dtype)
    width = cfg.num_key_value_heads * cfg.head_dim
    if storage == torch.uint8:
        width //= 2
    return storage, width, storage in (torch.int8, torch.uint8)


def pack_kv_int4(q: torch.Tensor) -> torch.Tensor:
    """(..., C) int8 values in [-7, 7] -> (..., C / 2) uint8: byte j holds
    channel 2j in its low nibble and 2j + 1 in its high nibble (the nibble
    order of the int4 weights, ``kernels/quant_matvec.py``)."""
    return qm.pack_int4(q, dim=-1).view(torch.uint8)


def unpack_kv_int4(packed: torch.Tensor) -> torch.Tensor:
    """(..., C / 2) uint8 -> (..., C) int8 values: the inverse of
    :func:`pack_kv_int4`."""
    return qm.unpack_int4(packed, dim=-1)


class KVCache(NamedTuple):
    """Stacked flat KV cache: k/v (num_layers, B, max_len, KV * hd).

    The same layout as the JAX package's ``KVCache``; the port writes new
    K/V into it IN PLACE (JAX returns an updated copy), and the attention
    kernels read a layer straight out of the stacked buffer by its strides.
    A quantized cache also holds f32 scales k_scale / v_scale (num_layers,
    B, max_len, KV, 1), per token and kv head: int8 (``dtype=torch.int8``)
    stores one value per byte; int4 (``dtype=KV_INT4``) stores k/v as
    uint8 (num_layers, B, max_len, KV * hd / 2), two channels per byte
    (:func:`pack_kv_int4`). A bf16 or f32 cache has None there.
    """

    k: torch.Tensor
    v: torch.Tensor
    k_scale: Optional[torch.Tensor] = None
    v_scale: Optional[torch.Tensor] = None

    @classmethod
    def zeros(cls, cfg: LLMConfig, batch: int, max_len: int,
              dtype=torch.bfloat16, device=None) -> "KVCache":
        storage, width, quantized = kv_layout(cfg, dtype)
        shape = (cfg.num_hidden_layers, batch, max_len, width)
        k = torch.zeros(shape, dtype=storage, device=device)
        v = torch.zeros(shape, dtype=storage, device=device)
        if not quantized:
            return cls(k, v)
        sshape = shape[:-1] + (cfg.num_key_value_heads, 1)
        return cls(k, v, torch.zeros(sshape, dtype=torch.float32,
                                     device=device),
                   torch.zeros(sshape, dtype=torch.float32, device=device))


def _quantize_kv(x: torch.Tensor, form=torch.int8
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(B, L, KV, hd) -> int8 values and (B, L, KV, 1) f32 scales, symmetric
    per token and head: scale = max(max|x| / qmax, 1e-8) over hd, qmax 127
    for ``form`` int8 and 7 for :data:`KV_INT4` (values then in [-7, 7],
    unpacked). Bit for bit the JAX ``_quantize_kv`` with int8 / int4 as it
    runs eagerly; under jit, XLA may turn the divide by qmax into a
    multiply by its reciprocal, which moves some scales by an ulp."""
    qmax = 7.0 if form == KV_INT4 else 127.0
    xf = x.to(torch.float32)
    scale = torch.clamp(xf.abs().amax(dim=-1, keepdim=True) / qmax,
                        min=1e-8)
    q = torch.clamp(torch.round(xf / scale), -qmax, qmax).to(torch.int8)
    return q, scale


def quantize_rows(x: torch.Tensor, storage: torch.dtype
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(..., KV, hd) -> the flat (..., KV*hd) values as a cache of
    ``storage`` dtype holds them (int8, or uint8 for packed int4:
    (..., KV*hd / 2)) and their (..., KV, 1) f32 scales."""
    int4 = storage == torch.uint8
    q, scale = _quantize_kv(x, KV_INT4 if int4 else torch.int8)
    q = q.flatten(-2)
    return (pack_kv_int4(q) if int4 else q), scale


def _write_kv(cache: KVCache, layer: int, rows, cols, k: torch.Tensor,
              v: torch.Tensor) -> None:
    """cache[layer, rows, cols] = k / v (..., KV, hd), in place: cast to the
    cache's dtype, or quantized with their scales into an int8 or a packed
    int4 cache."""
    for buf, sbuf, x in ((cache.k, cache.k_scale, k),
                         (cache.v, cache.v_scale, v)):
        if sbuf is not None:
            x, scale = quantize_rows(x, buf.dtype)
            sbuf[layer, rows, cols] = scale
            buf[layer, rows, cols] = x
        else:
            buf[layer, rows, cols] = x.flatten(-2).to(buf.dtype)


def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float) -> torch.Tensor:
    x32 = x.to(torch.float32)
    var = (x32 * x32).mean(dim=-1, keepdim=True)
    return weight * (x32 * torch.rsqrt(var + eps)).to(x.dtype)


def rope_inv_freq(cfg: LLMConfig) -> torch.Tensor:
    """(head_dim // 2,) f32 rotary frequencies 1 / theta^(i / half). The
    power is taken in f64 and rounded once to f32 (f32 ``pow`` differs
    between libraries by an ulp)."""
    half = cfg.head_dim // 2
    expo = torch.arange(0, half, dtype=torch.float32) / half
    return 1.0 / (cfg.rope_theta ** expo.to(torch.float64)).to(torch.float32)


@functools.lru_cache(maxsize=None)
def _mrope_tables(cfg: LLMConfig, device: torch.device):
    """(half,) axis of each rotary channel and its f32 frequency, on
    ``device``, made once: a host-to-device copy cannot run while a decode
    step is captured into a CUDA graph. Plain tensors even when first
    asked for under inference mode, so training can use them too."""
    s1, s2, s3 = cfg.mrope_section
    with torch.inference_mode(False):
        axis = torch.cat([torch.zeros(s1, dtype=torch.int64),
                          torch.ones(s2, dtype=torch.int64),
                          torch.full((s3,), 2, dtype=torch.int64)])
        return axis.to(device), rope_inv_freq(cfg).to(device)


def compute_mrope_cos_sin(position_ids: torch.Tensor, cfg: LLMConfig,
                          dtype=torch.float32
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(B, L, 3) position ids -> (cos, sin) each (B, L, head_dim): rotary
    channel i reads axis 0, 1 or 2 by the mrope sections, e.g. [32, 16, 16]."""
    half = cfg.head_dim // 2
    if sum(cfg.mrope_section) != half:
        raise ValueError(f"mrope_section {cfg.mrope_section} != head_dim/2")
    axis_for_freq, inv_freq = _mrope_tables(cfg, position_ids.device)
    pos = position_ids.to(torch.float32)[..., axis_for_freq]   # (B, L, half)
    freqs = pos * inv_freq
    emb = torch.cat([freqs, freqs], dim=-1)
    return torch.cos(emb).to(dtype), torch.sin(emb).to(dtype)


def rotate_half(x: torch.Tensor) -> torch.Tensor:
    half = x.shape[-1] // 2
    return torch.cat([-x[..., half:], x[..., :half]], dim=-1)


def apply_rotary(q: torch.Tensor, k: torch.Tensor, cos: torch.Tensor,
                 sin: torch.Tensor):
    """q, k: (B, L, heads, hd); cos/sin: (B, L, hd)."""
    cos = cos[:, :, None, :].to(q.dtype)
    sin = sin[:, :, None, :].to(q.dtype)
    return q * cos + rotate_half(q) * sin, k * cos + rotate_half(k) * sin


def decoder_layer(p: Params, x: torch.Tensor, cos: torch.Tensor,
                  sin: torch.Tensor, cfg: LLMConfig, layer_idx: int,
                  kv_cache: Optional[KVCache] = None,
                  cache_positions: Optional[torch.Tensor] = None,
                  kv_len: Optional[torch.Tensor] = None,
                  prefill: bool = False,
                  cache_start: Optional[int] = None,
                  shared_prefix: Optional[Tuple[torch.Tensor,
                                                torch.Tensor]] = None,
                  paged: Optional[tuple] = None) -> torch.Tensor:
    """One decoder block on x (B, L, D).

    Without ``kv_cache`` (training, JAX ``qwen2.py:429-431``): causal
    attention over the block's own K/V, keys >= ``kv_len`` masked, through
    the differentiable :func:`mha_train`, or :func:`mha` where grad mode is
    off (the benchmark's prefill without a cache).

    With ``kv_cache``:
      * ``prefill=True`` writes this chunk's K/V at slots 0..L-1 and attends
        the raw K/V (flash kernel);
      * ``cache_start`` (the JAX ``contiguous_update``): the chunk's K/V land
        at slots [cache_start, cache_start + L) of every row, and queries sit
        at ``cache_positions`` (B, L) == cache_start + r;
      * otherwise L == 1 and the new K/V land at ``cache_positions`` (B, 1).
    Attention then reads the stacked cache (decode kernel for one token, the
    GQA-folded flash kernel for a chunk), or, with ``shared_prefix`` = this
    layer's (pk, pv) (P, KV, hd) view of a stored scene prefix (requires
    ``cache_start`` == P), runs over the shared prefix plus this chunk's raw
    K/V (shared-prefix kernel); the cache write happens all the same.
    ``kv_len`` (B,) counts valid keys after the write.

    ``paged`` = (PagedKVCache, pids, off, lens_after), the single-token
    paged decode step (JAX ``qwen2.py:264-281``): this token's K/V are
    appended into ``layer_idx`` of the stacked pools at (pids, off), then
    attention reads each slot's pages up to ``lens_after`` (kernel B7).
    """
    B, L, D = x.shape
    H, KV, hd = cfg.num_attention_heads, cfg.num_key_value_heads, cfg.head_dim
    a = p["attn"]
    h = rms_norm(x, p["input_layernorm"], cfg.rms_norm_eps)
    mm = quant.matmul
    q = (mm(h, a["wq"]) + a["bq"]).reshape(B, L, H, hd)
    k = (mm(h, a["wk"]) + a["bk"]).reshape(B, L, KV, hd)
    v = (mm(h, a["wv"]) + a["bv"]).reshape(B, L, KV, hd)
    q, k = apply_rotary(q, k, cos, sin)

    if paged is not None:
        if L != 1:
            raise NotImplementedError("multi-token paged blocks (the "
                                      "speculative verify) are not ported "
                                      "(ROADMAP A8)")
        cache, pids, off, lens_after = paged
        paged_kv.append_layer_kv(cache, layer_idx, k[:, 0], v[:, 0], pids,
                                 off)
        attn = paged_mha(q, cache.k, cache.v, cache.page_table, lens_after,
                         layer_idx, cache.k_scale, cache.v_scale)
    elif kv_cache is None:
        attn = (mha_train if torch.is_grad_enabled() else mha)(q, k, v,
                                                               kv_len)
    elif prefill:
        _write_kv(kv_cache, layer_idx, slice(None), slice(0, L), k, v)
        # raw K/V, also with a quantized cache (as the JAX prefill)
        attn = mha(q, k, v, kv_len=kv_len)
    else:
        if cache_start is not None:
            _write_kv(kv_cache, layer_idx, slice(None),
                      slice(cache_start, cache_start + L), k, v)
        elif L == 1:
            _write_kv(kv_cache, layer_idx, torch.arange(B, device=x.device),
                      cache_positions[:, 0], k[:, 0], v[:, 0])
        else:
            raise NotImplementedError("per-row multi-token cache writes are "
                                      "not ported (pass cache_start)")
        if shared_prefix is not None:
            pk, pv = shared_prefix[:2]
            if cache_start != pk.shape[0]:
                raise ValueError("a shared-prefix chunk starts at the prefix "
                                 "length")
            # the suffix attends its own raw K/V, the prefix as stored
            attn = mha_shared_prefix(q, pk, pv, k, v, kv_len - cache_start,
                                     *shared_prefix[2:])
        else:
            attn = mha_cached_stacked(q, kv_cache.k, kv_cache.v, layer_idx,
                                      KV, q_positions=cache_positions,
                                      kv_len=kv_len, k_scale=kv_cache.k_scale,
                                      v_scale=kv_cache.v_scale)
    x = x + mm(attn.reshape(B, L, D), a["wo"])

    h = rms_norm(x, p["post_attention_layernorm"], cfg.rms_norm_eps)
    m = p["mlp"]
    return x + mm(F.silu(mm(h, m["w_gate"])) * mm(h, m["w_up"]),
                  m["w_down"])


def qwen2_forward(params: Params, cfg: LLMConfig,
                  inputs_embeds: torch.Tensor, position_ids: torch.Tensor,
                  kv_cache: Optional[KVCache] = None,
                  cache_positions: Optional[torch.Tensor] = None,
                  kv_len: Optional[torch.Tensor] = None,
                  prefill: bool = False,
                  contiguous_update: bool = False,
                  shared_prefix: Optional[KVCache] = None,
                  remat: bool = False,
                  paged_cache: Optional[paged_kv.PagedKVCache] = None,
                  paged_active: Optional[torch.Tensor] = None
                  ) -> torch.Tensor:
    """Run the decoder stack on (B, L, D) embeddings with (B, L, 3) position
    ids; returns the final-norm hidden states. ``kv_cache`` is updated in
    place (see :func:`decoder_layer`).

    ``remat`` (training, no cache): each decoder layer runs under
    ``torch.utils.checkpoint`` (non-reentrant), which keeps only its input
    and recomputes the layer in the backward pass, as JAX's
    ``jax.checkpoint(..., nothing_saveable)`` per layer.

    ``contiguous_update``: every row's ``cache_positions`` are the same
    range [start, start + L) (suffix over a cached prefix); the chunk's K/V
    are written there and attention reads the cache. ``shared_prefix``: a
    KVCache with k/v (layers, P, KV*hd) (int4: KV*hd / 2 bytes; quantized:
    scales (layers, P, KV, 1)), the batch-free scene prefix, whose start
    must be P (see :func:`decoder_layer`).

    ``paged_cache`` (B == its slot count, no ``kv_cache``): one decode step
    over the page pools (JAX ``qwen2.py:552-568, :627-631``). Each slot
    appends at position ``lens``; ``paged_active`` (B,) bool sends dead
    slots to the scratch page and keeps their length; ``lens`` advances
    once, after the last layer. Multi-token blocks (the speculative
    verify) raise.
    """
    L = inputs_embeds.shape[1]
    if kv_cache is not None and prefill and L > kv_cache.k.shape[2]:
        raise ValueError("prefill longer than the KV cache")
    cache_start = None
    if contiguous_update:
        if kv_cache is None or prefill:
            raise ValueError("contiguous_update needs a cache and no prefill")
        cache_start = int(cache_positions[0, 0])
        if cache_start < 0 or cache_start + L > kv_cache.k.shape[2]:
            raise ValueError("chunk outside the KV cache")
    elif shared_prefix is not None:
        raise ValueError("shared_prefix needs contiguous_update")
    if remat and kv_cache is not None:
        raise ValueError("remat is for the no-cache training forward")
    paged = None
    if paged_cache is not None:
        if kv_cache is not None:
            raise ValueError("paged_cache and kv_cache are exclusive")
        pids, off = paged_kv.append_positions(paged_cache, paged_active)
        inc = 1 if paged_active is None \
            else paged_active.to(paged_cache.lens.dtype)
        paged = (paged_cache, pids, off, paged_cache.lens + inc)
    cos, sin = compute_mrope_cos_sin(position_ids, cfg)
    KV = cfg.num_key_value_heads
    x = inputs_embeds
    for i, lp in enumerate(params["layers"]):
        sp = None
        if shared_prefix is not None:
            P = shared_prefix.k.shape[1]
            sp = (shared_prefix.k[i].reshape(P, KV, -1),
                  shared_prefix.v[i].reshape(P, KV, -1))
            if shared_prefix.k_scale is not None:
                sp += (shared_prefix.k_scale[i], shared_prefix.v_scale[i])
        if remat:
            x = checkpoint(decoder_layer, lp, x, cos, sin, cfg, i,
                           kv_len=kv_len, use_reentrant=False)
        else:
            x = decoder_layer(lp, x, cos, sin, cfg, i, kv_cache,
                              cache_positions, kv_len, prefill, cache_start,
                              sp, paged)
    if paged is not None:
        paged_kv.advance_lens(paged_cache, paged_active)
    return rms_norm(x, params["norm"], cfg.rms_norm_eps)


def lm_head(params: Params, hidden: torch.Tensor) -> torch.Tensor:
    """(B, L, D) -> (B, L, vocab) logits; a quantized head at up to 32 rows
    streams through kernel B4 (int8) or B8 (int4) on the GPU
    (``quant.matmul``)."""
    return quant.matmul(hidden, params["lm_head"])


def embed_tokens(params: Params, input_ids: torch.Tensor) -> torch.Tensor:
    return params["embed_tokens"][input_ids]


def init_qwen2(cfg: LLMConfig, device, generator: torch.Generator,
               dtype=torch.float32, bits: int = 16) -> Params:
    """Random init with the JAX package's distributions, made on ``device``:
    N(0, 0.02) matrices and embeddings, zero biases, unit norms. ``bits=8``
    (int8) or ``bits=4`` (int4) quantizes the projections and lm_head
    (``quant.quantize_tree``'s patterns), each layer right after its init,
    so the whole full-precision decoder never exists at once."""
    D, I = cfg.hidden_size, cfg.intermediate_size
    H, KV, hd = cfg.num_attention_heads, cfg.num_key_value_heads, cfg.head_dim

    def normal(*shape):
        return torch.empty(shape, device=device, dtype=dtype).normal_(
            0.0, 0.02, generator=generator)

    def zeros(n):
        return torch.zeros(n, device=device, dtype=dtype)

    def ones(n):
        return torch.ones(n, device=device, dtype=dtype)

    def quantized(llm):
        if bits == 16:
            return llm
        return quant.quantize_tree({"llm": llm}, bits=bits)["llm"]

    def layer():
        return quantized({"layers": [{
            "input_layernorm": ones(D),
            "attn": {"wq": normal(D, H * hd), "wk": normal(D, KV * hd),
                     "wv": normal(D, KV * hd), "wo": normal(H * hd, D),
                     "bq": zeros(H * hd), "bk": zeros(KV * hd),
                     "bv": zeros(KV * hd)},
            "post_attention_layernorm": ones(D),
            "mlp": {"w_gate": normal(D, I), "w_up": normal(D, I),
                    "w_down": normal(I, D)},
        }]})["layers"][0]

    return quantized({
        "embed_tokens": normal(cfg.vocab_size, D),
        "layers": [layer() for _ in range(cfg.num_hidden_layers)],
        "norm": ones(D),
        "lm_head": normal(D, cfg.vocab_size),
    })
