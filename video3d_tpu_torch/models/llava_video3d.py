"""Video-3D-LLM assembly in PyTorch: vision tower -> projector -> bilinear
2D pool -> sin3d world position embedding -> grid-newline layout -> splice
-> Qwen2. Counterpart of ``video3d_tpu/models/llava_video3d.py`` (the parts
the ScanQA answer path and the LM training path run: mlpNx_gelu projector,
bilinear pool, sin3d PE, GRID newlines, the ``<coord>`` box-input PE, the
video branch of ``forward_hidden``, ``forward``, and the LM losses, plain
and chunked).

Parameter dict: ``vision`` (siglip), ``projector {w1, b1, ..., wN, bN}``,
``image_newline (D,)``, ``llm`` (qwen2).
"""

from __future__ import annotations

from typing import Any, Dict, NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from video3d_tpu_torch.config import (ModelConfig, NewlinePosition,
                                      PosEmbedType)
from video3d_tpu_torch.constants import IGNORE_INDEX
from video3d_tpu_torch.models import qwen2, siglip
from video3d_tpu_torch.models.splice import KIND_PAD, KIND_VISION
from video3d_tpu_torch.ops import geometry
from video3d_tpu_torch.ops.pos_embed import sin3d_position_embedding

Params = Dict[str, Any]


def project_features(p: Params, x: torch.Tensor) -> torch.Tensor:
    """linear / mlpNx_gelu projector: Linear, then (erf GELU, Linear)*."""
    h = x
    i = 1
    while f"w{i}" in p:
        if i > 1:
            h = F.gelu(h)
        h = h @ p[f"w{i}"] + p[f"b{i}"]
        i += 1
    return h


def init_projector(in_dim: int, out_dim: int, device,
                   generator: torch.Generator, dtype=torch.float32,
                   projector_type: str = "mlp2x_gelu") -> Params:
    """N(0, 0.02) weights, zero biases, for 'linear' or 'mlpNx_gelu'."""
    import re

    m = re.match(r"^mlp(\d+)x_gelu$", projector_type)
    if projector_type != "linear" and not m:
        raise NotImplementedError(f"projector {projector_type!r} is not ported")
    depth = int(m.group(1)) if m else 1
    p: Params = {}
    for i in range(1, depth + 1):
        d_in = in_dim if i == 1 else out_dim
        p[f"w{i}"] = torch.empty(d_in, out_dim, device=device,
                                 dtype=dtype).normal_(0.0, 0.02,
                                                      generator=generator)
        p[f"b{i}"] = torch.zeros(out_dim, device=device, dtype=dtype)
    return p


class VisionTokens(NamedTuple):
    spliceable: torch.Tensor   # (B, V*tokens_per_frame, D) grid+newline layout
    pooled: torch.Tensor       # (B, V, g*g, D) pooled projected features (+PE)
    raw: torch.Tensor          # (B, V, 729, D) projected pre-pool features


def _pooled_side(cfg: ModelConfig) -> int:
    return -(-cfg.vision.num_patches_per_side // cfg.spatial_pool_stride)


def encode_video_pooled(params: Params, cfg: ModelConfig,
                        images: torch.Tensor, remat: bool = False
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(B, V, 3, S, S) pixels -> (pooled (B, V, g*g, D), raw (B, V, 729, D)):
    tower -> projector -> 2D pool, all frames in one batch."""
    B, V = images.shape[:2]
    side = cfg.vision.num_patches_per_side
    feats = siglip.vision_tower_forward(
        params["vision"], images.reshape(B * V, *images.shape[2:]), cfg.vision,
        remat=remat)
    feats = project_features(params["projector"], feats)
    raw = feats.reshape(B, V, side * side, -1)
    pooled = geometry.pool_2d_tokens(feats, side, cfg.spatial_pool_stride,
                                     cfg.spatial_pool_mode.value)
    g = _pooled_side(cfg)
    return pooled.reshape(B, V, g * g, -1), raw


def finish_video_tokens(params: Params, cfg: ModelConfig,
                        pooled: torch.Tensor, raw: torch.Tensor,
                        patch_coords: Optional[torch.Tensor] = None
                        ) -> VisionTokens:
    """sin3d world PE (from (B, V, g, g, 3) voxel coords) + GRID newlines."""
    B, V = pooled.shape[:2]
    g = _pooled_side(cfg)
    D = pooled.shape[-1]
    if patch_coords is not None and cfg.world_3d.pos_embed != PosEmbedType.NONE:
        if cfg.world_3d.pos_embed != PosEmbedType.SIN3D \
                or cfg.world_3d.pooling.n_points != 1:
            raise NotImplementedError("only single-point sin3d PE is ported")
        pe = sin3d_position_embedding(patch_coords.reshape(B, V * g * g, 3),
                                      cfg.llm.hidden_size,
                                      cfg.world_3d.pe_temperature)
        pooled = pooled + pe.reshape(B, V, g * g, -1).to(pooled.dtype)
    if cfg.newline_position != NewlinePosition.GRID:
        raise NotImplementedError("only the GRID newline layout is ported")
    grid = pooled.reshape(B, V, g, g, D)
    newline = params["image_newline"].to(pooled.dtype).expand(B, V, g, 1, D)
    spliceable = torch.cat([grid, newline], dim=3).reshape(B, -1, D)
    return VisionTokens(spliceable=spliceable, pooled=pooled, raw=raw)


def encode_video(params: Params, cfg: ModelConfig, images: torch.Tensor,
                 patch_coords: Optional[torch.Tensor] = None,
                 remat: bool = False) -> VisionTokens:
    pooled, raw = encode_video_pooled(params, cfg, images, remat)
    return finish_video_tokens(params, cfg, pooled, raw, patch_coords)


def assemble_embeds(params: Params, cfg: ModelConfig,
                    vision_tokens: torch.Tensor, text_ids: torch.Tensor,
                    kind: torch.Tensor, vision_index: torch.Tensor,
                    coord_mask: Optional[torch.Tensor] = None,
                    box_input: Optional[torch.Tensor] = None
                    ) -> torch.Tensor:
    """(B, L, D) input embeddings from the splice plan: text embeddings,
    vision tokens gathered at ``vision_index``, zeros at padding. With
    ``coord_mask`` (B, L) and the discretized Scan2Cap centers
    ``box_input`` (B, 3), their sin3d PE is added at the ``<coord>`` slots
    (JAX ``assemble_embeds``)."""
    text_emb = qwen2.embed_tokens(params["llm"], text_ids)
    D = text_emb.shape[-1]
    vis = torch.gather(vision_tokens, 1,
                       vision_index[..., None].expand(-1, -1, D))
    embeds = torch.where((kind == KIND_VISION)[..., None],
                         vis.to(text_emb.dtype), text_emb)
    embeds = torch.where((kind == KIND_PAD)[..., None],
                         torch.zeros((), dtype=embeds.dtype,
                                     device=embeds.device), embeds)
    if coord_mask is not None and box_input is not None \
            and cfg.world_3d.pos_embed == PosEmbedType.SIN3D:
        pe = sin3d_position_embedding(box_input[:, None, :].float(),
                                      cfg.llm.hidden_size,
                                      cfg.world_3d.pe_temperature)
        embeds = embeds + coord_mask[..., None].to(embeds.dtype) \
            * pe.to(embeds.dtype)
    return embeds


class Batch(NamedTuple):
    """Device-side batch: the fields the answer path reads, and the
    training fields of the JAX ``Batch`` (labels, the ``<coord>`` mask and
    box centers) that the training path reads."""

    images: Optional[torch.Tensor]         # (B, V, 3, S, S)
    patch_coords: Optional[torch.Tensor]   # (B, V, g, g, 3) voxel ids
    text_ids: torch.Tensor                 # (B, L) int64
    kind: torch.Tensor                     # (B, L)
    vision_index: torch.Tensor             # (B, L) int64
    position_ids: torch.Tensor             # (B, L)
    seq_len: torch.Tensor                  # (B,)
    labels: Optional[torch.Tensor] = None       # (B, L) int64
    coord_mask: Optional[torch.Tensor] = None   # (B, L)
    box_input: Optional[torch.Tensor] = None    # (B, 3) discretized centers


def _position_ids_3d(batch: Batch, cfg: ModelConfig) -> torch.Tensor:
    """(B, L, 3) ids: a 1D text position replicated over the three mRoPE
    axes (the sin3d configuration; mrope world positions are not ported)."""
    if cfg.world_3d.pos_embed == PosEmbedType.MROPE:
        raise NotImplementedError("mrope world positions are not ported")
    return batch.position_ids[..., None].expand(*batch.position_ids.shape, 3)


def forward_hidden(params: Params, cfg: ModelConfig, batch: Batch,
                   remat: bool = False
                   ) -> Tuple[torch.Tensor, VisionTokens]:
    """Training / eval forward of a video batch -> (final hidden states
    (B, L, D), the vision tokens). Right padding: causal attention with the
    per-row key length ``seq_len`` is the whole mask. ``remat``: the tower's
    and the decoder's layers run under ``torch.utils.checkpoint``."""
    if batch.images is None:
        raise NotImplementedError("the 2D-image (anyres) modality is not "
                                  "ported (ROADMAP A11)")
    vt = encode_video(params, cfg, batch.images, batch.patch_coords,
                      remat=remat)
    embeds = assemble_embeds(params, cfg, vt.spliceable, batch.text_ids,
                             batch.kind, batch.vision_index,
                             batch.coord_mask, batch.box_input)
    hidden = qwen2.qwen2_forward(params["llm"], cfg.llm, embeds,
                                 _position_ids_3d(batch, cfg),
                                 kv_len=batch.seq_len, remat=remat)
    return hidden, vt


def forward(params: Params, cfg: ModelConfig, batch: Batch,
            remat: bool = False) -> torch.Tensor:
    """Training / eval forward -> (B, L, vocab) logits."""
    hidden, _ = forward_hidden(params, cfg, batch, remat=remat)
    return qwen2.lm_head(params["llm"], hidden)


def _nll_sum(logits: torch.Tensor, labels: torch.Tensor
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(sum of -log p(label) over targets != IGNORE_INDEX, their count)."""
    mask = labels != IGNORE_INDEX
    safe = torch.where(mask, labels, torch.zeros_like(labels))
    logp = torch.log_softmax(logits.float(), dim=-1)
    nll = -torch.gather(logp, -1, safe[..., None].long())[..., 0]
    return (nll * mask).sum(), mask.sum()


def language_model_loss(logits: torch.Tensor,
                        labels: torch.Tensor) -> torch.Tensor:
    """Shifted cross-entropy with IGNORE_INDEX masking, mean over valid
    targets (qwen2/modeling_qwen2.py:1196-1207)."""
    total, count = _nll_sum(logits[:, :-1], labels[:, 1:])
    return total / torch.clamp(count, min=1)


def _chunk_nll(head: torch.Tensor, hidden: torch.Tensor,
               labels: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    return _nll_sum(qwen2.lm_head({"lm_head": head}, hidden), labels)


def chunked_language_model_loss(params: Params, hidden: torch.Tensor,
                                labels: torch.Tensor,
                                chunk: int = 1024) -> torch.Tensor:
    """Same loss as ``language_model_loss(lm_head(hidden), labels)`` without
    ever holding the (B, L, vocab) logits: a loop over length chunks, each
    chunk's lm_head matmul + NLL under non-reentrant
    ``torch.utils.checkpoint``, so forward and backward hold one chunk's
    (B, chunk, vocab) logits at a time (JAX: a ``lax.scan`` over
    ``jax.checkpoint``-ed chunks)."""
    h = hidden[:, :-1]
    lab = labels[:, 1:]
    head = params["llm"]["lm_head"]
    total = torch.zeros((), dtype=torch.float32, device=hidden.device)
    count = torch.zeros((), dtype=torch.int64, device=hidden.device)
    for s in range(0, h.shape[1], chunk):
        ds, dc = checkpoint(_chunk_nll, head, h[:, s:s + chunk],
                            lab[:, s:s + chunk], use_reentrant=False)
        total = total + ds
        count = count + dc
    return total / torch.clamp(count, min=1)
