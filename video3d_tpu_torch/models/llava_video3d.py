"""Video-3D-LLM assembly in PyTorch: vision tower -> projector -> bilinear
2D pool -> sin3d world position embedding -> grid-newline layout -> splice
-> Qwen2. Counterpart of ``video3d_tpu/models/llava_video3d.py`` (the parts
the answer, grounding and LM training paths run: mlpNx_gelu projector,
bilinear pool, sin3d PE, GRID newlines, the ``<coord>`` box-input PE, the
video branch of ``forward_hidden``, ``forward``, the LM losses, plain and
chunked, and the grounding forwards: object patch masks, masked-mean
object features with their box-center PE, and the three ground heads).

Parameter dict: ``vision`` (siglip), ``projector {w1, b1, ..., wN, bN}``,
``image_newline (D,)``, ``llm`` (qwen2), and where the configuration has
one, ``ground_head`` (``{obj, query, zero_target}`` for INFONCE,
``{query}`` for MLP, ``{obj, query, score}`` for SCORE; each MLP
``{w1, b1, ln_scale, ln_bias, w2, b2}``).
"""

from __future__ import annotations

from typing import Any, Dict, NamedTuple, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from video3d_tpu_torch.config import (GroundHeadType, ModelConfig,
                                      NewlinePosition, ObjectFeatureType,
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


def prefill_cached(params: Params, cfg: ModelConfig, batch: Batch,
                   embeds: torch.Tensor, max_cache_len: int,
                   cache_dtype=torch.bfloat16
                   ) -> Tuple[torch.Tensor, qwen2.KVCache]:
    """Prefill ``embeds`` (B, L, D) from position 0 into a fresh cache of
    ``max_cache_len`` slots and ``cache_dtype`` (bf16, int8 or
    ``qwen2.KV_INT4``); returns (final hidden states, cache)."""
    B, L = batch.text_ids.shape
    dev = embeds.device
    cache = qwen2.KVCache.zeros(cfg.llm, B, max_cache_len, dtype=cache_dtype,
                                device=dev)
    hidden = qwen2.qwen2_forward(
        params["llm"], cfg.llm, embeds, _position_ids_3d(batch, cfg),
        kv_cache=cache,
        cache_positions=torch.arange(L, device=dev)[None].expand(B, L),
        kv_len=batch.seq_len, prefill=True)
    return hidden, cache


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


# ---------------------------------------------------------------------------
# Grounding (object proposals)
# ---------------------------------------------------------------------------

#: elements of one chunk's (objects, V, P, px, 3) box comparison in
#: :func:`object_patch_masks`. Each of the chunk's three bool temporaries
#: then holds 256 MB; at 150 objects, V=32 and PATCH14 the unchunked
#: comparison would hold ~2 GB in each.
MASK_CHUNK_ELEMENTS = 1 << 28


def object_patch_masks(world_coords: torch.Tensor, boxes: torch.Tensor,
                       feature_type: ObjectFeatureType, side: int = 27,
                       patch_px: int = 14, grid: int = 14, pool_px: int = 27
                       ) -> torch.Tensor:
    """(N, V, P) bool per-object patch membership from (V, H, W, 3) pixel
    world coordinates and (N, 6) center+size boxes (JAX
    ``object_patch_masks``): PATCH14, the side^2 tower patches of
    patch_px^2 pixels each, a patch belonging to an object when >= 50% of
    its pixels fall inside the box; PATCH27, the grid^2 pooled tokens of
    pool_px^2 pixels each, at >= 25%. The comparison runs over chunks of
    objects of at most MASK_CHUNK_ELEMENTS elements (at least one object);
    the counts are integers, so the result is the unchunked one's bit for
    bit."""
    V = world_coords.shape[0]
    if feature_type == ObjectFeatureType.PATCH14:
        n, px, thresh = side, patch_px, int(patch_px * patch_px * 0.5)
    else:
        n, px, thresh = grid, pool_px, int(pool_px * pool_px * 0.25)
    crop = n * px
    wcp = world_coords[:, :crop, :crop, :].reshape(V, n, px, n, px, 3) \
        .permute(0, 1, 3, 2, 4, 5).reshape(V, n * n, px * px, 3)
    lo = (boxes[:, :3] - boxes[:, 3:] / 2)[:, None, None, None, :]
    hi = (boxes[:, :3] + boxes[:, 3:] / 2)[:, None, None, None, :]
    step = max(1, MASK_CHUNK_ELEMENTS // wcp.numel())
    masks = torch.empty((boxes.shape[0], V, n * n), dtype=torch.bool,
                        device=world_coords.device)
    for s in range(0, boxes.shape[0], step):
        inside = ((wcp >= lo[s:s + step]) & (wcp <= hi[s:s + step])).all(-1)
        masks[s:s + step] = inside.sum(-1) >= thresh
    return masks


def object_features_from_masks(feats: torch.Tensor, masks: torch.Tensor
                               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Masked mean of (V, P, D) patch features per object: ((N, D)
    features, (N,) valid), valid False where no patch matched (the feature
    is then zeros). The mask and the counts are in the features' dtype,
    as in JAX."""
    m = masks.to(feats.dtype)
    counts = m.sum(dim=(1, 2))
    sums = torch.einsum("nvp,vpd->nd", m, feats)
    return sums / torch.clamp(counts, min=1.0)[:, None], counts > 0


def _layernorm(h: torch.Tensor, scale: torch.Tensor,
               bias: torch.Tensor) -> torch.Tensor:
    h32 = h.float()
    mean = h32.mean(-1, keepdim=True)
    var = ((h32 - mean) ** 2).mean(-1, keepdim=True)
    return ((h32 - mean) * torch.rsqrt(var + 1e-5) * scale
            + bias).to(h.dtype)


def _ground_mlp(p: Params, x: torch.Tensor) -> torch.Tensor:
    """Linear -> ReLU -> LayerNorm -> Linear (INFONCE / MLP heads)."""
    h = torch.relu(x @ p["w1"] + p["b1"])
    return _layernorm(h, p["ln_scale"], p["ln_bias"]) @ p["w2"] + p["b2"]


def _ground_mlp_ln_first(p: Params, x: torch.Tensor) -> torch.Tensor:
    """Linear -> LayerNorm -> ReLU -> Linear (SCORE head)."""
    h = torch.relu(_layernorm(x @ p["w1"] + p["b1"], p["ln_scale"],
                              p["ln_bias"]))
    return h @ p["w2"] + p["b2"]


def _unit(x: torch.Tensor) -> torch.Tensor:
    return x / torch.linalg.vector_norm(x.float(), dim=-1,
                                        keepdim=True).to(x.dtype)


def ground_scores(params: Params, query_hidden: torch.Tensor,
                  object_feats: torch.Tensor, object_valid: torch.Tensor,
                  cfg: ModelConfig) -> torch.Tensor:
    """Scores of (N, D) object features against the (D,) hidden state at
    the ``<ground>`` token: INFONCE (N+1,) cosines, slot N the learned
    zero target; MLP and SCORE (N,) raw scores. Objects not
    ``object_valid`` (padding) score -inf."""
    gh = params["ground_head"]
    if cfg.ground_head == GroundHeadType.INFONCE:
        feats = torch.cat([object_feats,
                           gh["zero_target"][None].to(object_feats.dtype)])
        obj = _unit(_ground_mlp(gh["obj"], feats))
        qry = _unit(_ground_mlp(gh["query"], query_hidden[None]))
        scores = (obj * qry).sum(-1)
        valid = torch.cat([object_valid, object_valid.new_ones(1)])
    elif cfg.ground_head == GroundHeadType.MLP:
        q = _ground_mlp(gh["query"], query_hidden[None])[0]
        scores, valid = (object_feats * q).sum(-1), object_valid
    elif cfg.ground_head == GroundHeadType.SCORE:
        obj = _ground_mlp_ln_first(gh["obj"], object_feats)
        qry = _ground_mlp_ln_first(gh["query"], query_hidden[None])
        scores = _ground_mlp_ln_first(gh["score"], obj * qry)[:, 0]
        valid = object_valid
    else:
        raise ValueError(cfg.ground_head)
    return scores.masked_fill(~valid, float("-inf"))


def init_ground_head(hidden: int, device, generator: torch.Generator,
                     dtype=torch.float32,
                     head_type: GroundHeadType = GroundHeadType.INFONCE
                     ) -> Params:
    """JAX ``init_ground_head``'s shapes and distributions: N(0, 0.02)
    linears, zero biases, unit LayerNorm scales, an N(0, 1) zero target."""

    def normal(*shape, std=0.02):
        return torch.empty(shape, device=device, dtype=dtype).normal_(
            0.0, std, generator=generator)

    def mlp(din, dout, out2=None):
        out2 = out2 or dout
        return {"w1": normal(din, dout),
                "b1": torch.zeros(dout, device=device, dtype=dtype),
                "ln_scale": torch.ones(dout, device=device, dtype=dtype),
                "ln_bias": torch.zeros(dout, device=device, dtype=dtype),
                "w2": normal(dout, out2),
                "b2": torch.zeros(out2, device=device, dtype=dtype)}

    if head_type == GroundHeadType.INFONCE:
        return {"obj": mlp(hidden, hidden), "query": mlp(hidden, hidden),
                "zero_target": normal(hidden, std=1.0)}
    if head_type == GroundHeadType.MLP:
        return {"query": mlp(hidden, hidden)}
    if head_type == GroundHeadType.SCORE:
        # the scoring MLP projects to a single logit
        return {"obj": mlp(hidden, 1024), "query": mlp(hidden, 1024),
                "score": mlp(1024, 1024, out2=1)}
    raise ValueError(head_type)


def _grounding_object_features(params: Params, cfg: ModelConfig,
                               vt: VisionTokens, world_coords: torch.Tensor,
                               object_boxes: torch.Tensor,
                               row: int = 0) -> torch.Tensor:
    """(N, D) masked-mean object features of batch row ``row`` (+ the sin3d
    PE of the box centers): question-independent, a function of the
    scene's coordinates, features and proposals only. Objects covering no
    patch keep a zero feature (and its PE) and are still scored. The
    patch and pool pixel sizes derive from the coordinate image's
    height, as in JAX."""
    w3d = cfg.world_3d
    side = cfg.vision.num_patches_per_side
    g = _pooled_side(cfg)
    H = world_coords.shape[-3]
    masks = object_patch_masks(world_coords, object_boxes,
                               w3d.object_feature_type, side=side,
                               patch_px=H // side, grid=g, pool_px=H // g)
    feats = vt.raw[row] if w3d.object_feature_type == \
        ObjectFeatureType.PATCH14 else vt.pooled[row]
    obj_feats, _ = object_features_from_masks(feats, masks)
    if w3d.object_feature_use_pe and w3d.pos_embed == PosEmbedType.SIN3D:
        centers = object_boxes[:, :3]
        if w3d.discrete:
            vox = w3d.voxel
            centers = geometry.discrete_coords(
                centers, vox.min_xyz_range, vox.max_xyz_range,
                vox.voxel_size)
        pe = sin3d_position_embedding(centers[None], cfg.llm.hidden_size,
                                      w3d.pe_temperature)[0]
        obj_feats = obj_feats + pe.to(obj_feats.dtype)
    return obj_feats


def grounding_forward(params: Params, cfg: ModelConfig, batch: Batch,
                      world_coords: torch.Tensor, object_boxes: torch.Tensor,
                      object_valid: torch.Tensor, ground_slot: int,
                      remat: bool = False) -> torch.Tensor:
    """Grounding scores of one sample (B = 1): the full forward without a
    cache, then :func:`ground_scores` of the hidden state at spliced index
    ``ground_slot`` against the (N, 6) padded proposals' features.
    ``world_coords``: (V, H, W, 3) over the batch's V frames."""
    hidden, vt = forward_hidden(params, cfg, batch, remat=remat)
    obj_feats = _grounding_object_features(params, cfg, vt, world_coords,
                                           object_boxes)
    return ground_scores(params, hidden[0, ground_slot], obj_feats,
                         object_valid, cfg)


@torch.inference_mode()
def grounding_forward_cached(params: Params, cfg: ModelConfig, batch: Batch,
                             world_coords: torch.Tensor,
                             object_boxes: torch.Tensor,
                             object_valid: torch.Tensor, ground_slot: int,
                             max_cache_len: int, cache_dtype=torch.bfloat16):
    """:func:`grounding_forward` through a prefill into a fresh KV cache,
    which it returns with the question-independent object features: the
    scene-prefix harvest of the engine's grounding prefix cache. Returns
    (scores, cache, obj_feats (N, D))."""
    vt = encode_video(params, cfg, batch.images, batch.patch_coords)
    embeds = assemble_embeds(params, cfg, vt.spliceable, batch.text_ids,
                             batch.kind, batch.vision_index,
                             batch.coord_mask, batch.box_input)
    hidden, cache = prefill_cached(params, cfg, batch, embeds, max_cache_len,
                                   cache_dtype)
    obj_feats = _grounding_object_features(params, cfg, vt, world_coords,
                                           object_boxes)
    scores = ground_scores(params, hidden[0, ground_slot], obj_feats,
                           object_valid, cfg)
    return scores, cache, obj_feats


def grounding_forward_batch(params: Params, cfg: ModelConfig, batch: Batch,
                            world_coords: torch.Tensor,
                            object_boxes: torch.Tensor,
                            object_valid: torch.Tensor,
                            ground_slot: Sequence[int],
                            remat: bool = False) -> torch.Tensor:
    """Batched :func:`grounding_forward`: B questions in one prefill, each
    scored at its own ``ground_slot`` against its own proposals.
    ``world_coords`` (B, V, H, W, 3), ``object_boxes`` (B, N, 6),
    ``object_valid`` (B, N); returns (B, N+1) scores ((B, N) for the MLP
    and SCORE heads)."""
    hidden, vt = forward_hidden(params, cfg, batch, remat=remat)
    return torch.stack([
        ground_scores(params, hidden[b, int(slot)],
                      _grounding_object_features(
                          params, cfg, vt, world_coords[b], object_boxes[b],
                          row=b),
                      object_valid[b], cfg)
        for b, slot in enumerate(ground_slot)])
