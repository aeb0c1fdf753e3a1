"""Static-shape multimodal token splicing.

The reference splices per-sample with dynamic Python loops at every forward
(``prepare_inputs_labels_for_multimodal``, llava_arch.py:336-836): split
input_ids at IMAGE_TOKEN_INDEX, embed text pieces, insert V*210 visual
tokens, pad to the batch max. That design defeats XLA (dynamic shapes,
host-side control flow).

TPU-native replacement: the *host* computes an integer splice plan once per
batch (cheap numpy), and the device assembles embeddings with a single
gather + select under jit. The plan is a fixed-length layout:

  kind[t]         0=pad, 1=text, 2=vision
  text_ids[t]     token id (0 at vision/pad slots)
  vision_index[t] index into the flattened (V*tokens_per_frame) vision
                  token array (0 at text/pad slots)
  labels[t]       IGNORE_INDEX except supervised text slots
  position_ids[t] running position (matches reference arange over the
                  unpadded sequence, llava_arch.py:794-803)
  mrope_position_ids[t]  (3,) voxel ids for vision tokens / replicated
                  counter for text (llava_arch.py:711-729); newline tokens
                  get (0,0,0) exactly like the reference (:725-727)

Numerics are identical to the reference for right padding: real tokens are
contiguous from slot 0, so attention/PE see the same values.

The port's own copy of ``video3d_tpu/models/splice.py`` (the port imports
nothing of the JAX package).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Sequence

import numpy as np

from video3d_tpu_torch.constants import IGNORE_INDEX, IMAGE_TOKEN_INDEX

KIND_PAD = 0
KIND_TEXT = 1
KIND_VISION = 2


@dataclass
class SplicePlan:
    """Per-batch static-shape splice layout (host numpy arrays)."""

    text_ids: np.ndarray          # (B, L) int32
    kind: np.ndarray              # (B, L) int32
    vision_index: np.ndarray      # (B, L) int32
    labels: np.ndarray            # (B, L) int32
    position_ids: np.ndarray      # (B, L) int32
    mrope_position_ids: np.ndarray  # (B, L, 3) int32
    seq_len: np.ndarray           # (B,) int32 true lengths
    coord_mask: np.ndarray        # (B, L) bool — <coord> token slots


def build_splice_plan(
    input_ids_list: Sequence[Sequence[int]],
    labels_list: Optional[Sequence[Sequence[int]]],
    num_frames: Sequence[int],
    tokens_per_frame: int,
    max_len: int,
    grid_side: int = 14,
    mrope_coords: Optional[Sequence[np.ndarray]] = None,
    coord_token_id: Optional[int] = None,
    truncate_to: Optional[int] = None,
) -> SplicePlan:
    """Build the splice plan for a batch.

    Args:
      input_ids_list: per-sample token ids containing IMAGE_TOKEN_INDEX
        sentinels — one per sample for the video path (V frames in one
        block), or exactly V sentinels for the multi-image chat path
        (each consumes one image's tokens_per_frame features).
      labels_list: per-sample labels aligned with input_ids (IGNORE_INDEX
        masked), or None for inference.
      num_frames: per-sample number of real frames V_b.
      tokens_per_frame: vision tokens inserted per frame (210 for grid mode).
      max_len: static padded length L of the output.
      grid_side: pooled patch grid side (14); used for mrope newline layout.
      mrope_coords: per-sample (V, grid_side, grid_side, 3) discrete voxel
        coords (required only when the model uses mrope position ids).
      coord_token_id: id of the <coord> token (Scan2Cap box-input PE).
      truncate_to: optional truncation of the spliced stream before padding
        (reference tokenizer_model_max_length, llava_arch.py:765-770).
    Returns:
      SplicePlan with (B, L) arrays.
    """
    B = len(input_ids_list)
    text_ids = np.zeros((B, max_len), np.int32)
    kind = np.zeros((B, max_len), np.int32)
    vision_index = np.zeros((B, max_len), np.int32)
    labels = np.full((B, max_len), IGNORE_INDEX, np.int32)
    position_ids = np.zeros((B, max_len), np.int32)
    mrope_ids = np.zeros((B, max_len, 3), np.int32)
    seq_len = np.zeros((B,), np.int32)
    coord_mask = np.zeros((B, max_len), bool)

    for b, ids in enumerate(input_ids_list):
        ids = list(ids)
        labs = list(labels_list[b]) if labels_list is not None else [IGNORE_INDEX] * len(ids)
        V = int(num_frames[b])
        n_vis = V * tokens_per_frame

        img_positions = [i for i, t in enumerate(ids) if t == IMAGE_TOKEN_INDEX]
        # One sentinel = the video path (V frames in one block). N>1
        # sentinels = the multi-image chat contract (reference
        # gradio_multi_image / llava_arch.py image-list branch): each
        # sentinel consumes ONE image's tokens_per_frame features, in
        # order, from the same flat frame-major feature buffer.
        if len(img_positions) > 1:
            assert len(img_positions) == V, (
                f"multi-image splice: {len(img_positions)} <image> "
                f"sentinels but num_frames={V} images")
            assert mrope_coords is None, (
                "multi-image splice carries no 3D voxel coords")

        out_ids: List[int] = []
        out_kind: List[int] = []
        out_vidx: List[int] = []
        out_labs: List[int] = []
        out_mrope: List[tuple] = []
        pos_counter = 0

        def push_text(tok: int, lab: int):
            nonlocal pos_counter
            out_ids.append(tok)
            out_kind.append(KIND_TEXT)
            out_vidx.append(0)
            out_labs.append(lab)
            out_mrope.append((pos_counter, pos_counter, pos_counter))
            pos_counter += 1

        def push_vision(start: int, count: int):
            nonlocal pos_counter
            # frame-major, row-major: grid_side patches then one newline/row
            if mrope_coords is not None:
                coords = np.asarray(mrope_coords[b]).astype(np.int64)
            for t in range(start, start + count):
                out_ids.append(0)
                out_kind.append(KIND_VISION)
                out_vidx.append(t)
                out_labs.append(IGNORE_INDEX)
                if mrope_coords is not None:
                    f = t // tokens_per_frame
                    r = (t % tokens_per_frame) // (grid_side + 1)
                    c = (t % tokens_per_frame) % (grid_side + 1)
                    if c < grid_side:
                        out_mrope.append(tuple(coords[f, r, c]))
                    else:  # newline token -> (0,0,0), llava_arch.py:725-727
                        out_mrope.append((0, 0, 0))
                else:
                    out_mrope.append((pos_counter + t - start,) * 3)
            pos_counter += count

        if len(img_positions) == 1:
            split = img_positions[0]
            for i in range(split):
                push_text(ids[i], labs[i])
            push_vision(0, n_vis)
            for i in range(split + 1, len(ids)):
                push_text(ids[i], labs[i])
        elif img_positions:
            prev = 0
            for j, split in enumerate(img_positions):
                for i in range(prev, split):
                    push_text(ids[i], labs[i])
                push_vision(j * tokens_per_frame, tokens_per_frame)
                prev = split + 1
            for i in range(prev, len(ids)):
                push_text(ids[i], labs[i])
        else:
            for i, t in enumerate(ids):
                push_text(t, labs[i])

        if truncate_to is not None:
            out_ids = out_ids[:truncate_to]
            out_kind = out_kind[:truncate_to]
            out_vidx = out_vidx[:truncate_to]
            out_labs = out_labs[:truncate_to]
            out_mrope = out_mrope[:truncate_to]

        n = min(len(out_ids), max_len)
        seq_len[b] = n
        text_ids[b, :n] = out_ids[:n]
        kind[b, :n] = out_kind[:n]
        vision_index[b, :n] = out_vidx[:n]
        labels[b, :n] = out_labs[:n]
        position_ids[b, :n] = np.arange(n)
        # Pad slots keep increasing positions so KV-cache slot == position.
        position_ids[b, n:] = np.arange(n, max_len)
        mrope_ids[b, :n] = np.asarray(out_mrope[:n], np.int64)
        if coord_token_id is not None:
            coord_mask[b, :n] = np.asarray(out_ids[:n]) == coord_token_id

    # Text ids must be valid embedding rows; clamp sentinels defensively.
    text_ids = np.where(text_ids < 0, 0, text_ids)
    return SplicePlan(text_ids=text_ids, kind=kind, vision_index=vision_index,
                      labels=labels, position_ids=position_ids,
                      mrope_position_ids=mrope_ids, seq_len=seq_len,
                      coord_mask=coord_mask)


def vision_end_from_kind(kind_row: np.ndarray) -> int:
    """Spliced index one past the last vision token of one (L,) kind row
    (the scene-prefix length for prefix-KV caching), or 0 when the row has
    no vision block. The single source of truth for the prefix-length
    rule — the slicing side (slice_suffix_plan callers) and the storing
    side (drivers._store_prefix) must agree."""
    vis = np.nonzero(np.asarray(kind_row) == KIND_VISION)[0]
    return int(vis[-1]) + 1 if len(vis) else 0


def vision_end(plan: SplicePlan, b: int = 0) -> int:
    """:func:`vision_end_from_kind` of plan sample ``b``."""
    return vision_end_from_kind(plan.kind[b])


def slice_suffix_plan(plan: SplicePlan, prefix_len: int,
                      suffix_max_len: int) -> Optional[SplicePlan]:
    """Slice spliced positions [prefix_len, prefix_len + suffix_max_len) out
    of a full plan — the question suffix fed to
    ``generate.start_decode_prefix`` against a cached scene-prefix KV.

    ``seq_len`` stays the TOTAL true length (the suffix forward needs the
    absolute kv_len / last-token position). Returns None when any sample's
    true sequence ends inside the prefix (truncation cut into the vision
    block — caller must fall back to a full prefill) or when a vision token
    would land in the suffix.
    """
    B, L = plan.text_ids.shape
    Ls = suffix_max_len
    if np.any(plan.seq_len <= prefix_len):
        return None
    if np.any(plan.seq_len - prefix_len > Ls):
        return None
    if np.any(plan.kind[:, prefix_len:] == KIND_VISION):
        return None

    def sl(a: np.ndarray, fill=0) -> np.ndarray:
        out = np.full((B, Ls) + a.shape[2:], fill, a.dtype)
        m = min(Ls, L - prefix_len)
        if m > 0:
            out[:, :m] = a[:, prefix_len:prefix_len + m]
        return out

    # pad slots keep increasing positions (same convention as the full plan)
    pos = sl(plan.position_ids)
    m = min(Ls, L - prefix_len)
    if m < Ls:
        pos[:, m:] = prefix_len + np.arange(m, Ls)[None]
    return SplicePlan(
        text_ids=sl(plan.text_ids), kind=sl(plan.kind, KIND_PAD),
        vision_index=sl(plan.vision_index),
        labels=sl(plan.labels, IGNORE_INDEX),
        position_ids=pos,
        mrope_position_ids=sl(plan.mrope_position_ids),
        seq_len=plan.seq_len.copy(),
        coord_mask=sl(plan.coord_mask, False))
