"""Greedy KV-cache decoding over the spliced multimodal prefill, in PyTorch:
counterpart of ``video3d_tpu/models/generate.py`` (``prefill_multimodal``
and the greedy form of ``generate_greedy``).

The JAX ``lax.while_loop`` becomes a Python loop: one decoder forward per
step, stopping once every row has emitted EOS or ``max_new_tokens`` steps
ran. Like the JAX loop, the step that emits the last token still runs its
forward, so a request makes exactly (steps) decode forwards.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from video3d_tpu.config import ModelConfig
from video3d_tpu_torch.models import llava_video3d as lv3d
from video3d_tpu_torch.models import qwen2


class GenerateResult(NamedTuple):
    tokens: torch.Tensor    # (B, max_new_tokens) emitted ids (eos-padded)
    lengths: torch.Tensor   # (B,) tokens before EOS (exclusive)


def _decode_position_ids(pos: torch.Tensor) -> torch.Tensor:
    """(B, 1) text positions -> (B, 1, 3) replicated mRoPE ids."""
    return pos[..., None].expand(*pos.shape, 3)


def prefill_multimodal(params, cfg: ModelConfig, batch: lv3d.Batch,
                       max_cache_len: int,
                       vision_features: Optional[torch.Tensor] = None):
    """Vision encode + splice + prefill into a fresh bf16 cache. Returns
    (next_logits (B, vocab), cache, start_pos (B,)). ``vision_features``
    (B, T, D) skips the vision encode."""
    B, L = batch.text_ids.shape
    if vision_features is None:
        vision_features = lv3d.encode_video(params, cfg, batch.images,
                                            batch.patch_coords).spliceable
    embeds = lv3d.assemble_embeds(params, cfg, vision_features,
                                  batch.text_ids, batch.kind,
                                  batch.vision_index)
    dev = embeds.device
    cache = qwen2.KVCache.zeros(cfg.llm, B, max_cache_len, device=dev)
    cache_positions = torch.arange(L, device=dev)[None].expand(B, L)
    hidden = qwen2.qwen2_forward(
        params["llm"], cfg.llm, embeds, lv3d._position_ids_3d(batch, cfg),
        kv_cache=cache, cache_positions=cache_positions, kv_len=batch.seq_len,
        prefill=True)
    last = hidden[torch.arange(B, device=dev), batch.seq_len.long() - 1]
    next_logits = qwen2.lm_head(params["llm"], last[:, None])[:, 0]
    return next_logits, cache, batch.seq_len


@torch.inference_mode()
def generate_greedy(params, cfg: ModelConfig, batch: lv3d.Batch,
                    max_new_tokens: int = 512, eos_token_id: int = 151645,
                    vision_features: Optional[torch.Tensor] = None
                    ) -> GenerateResult:
    """Greedy decode into a cache of L + max_new_tokens slots: argmax over
    float32 logits (first maximum on ties, as ``jnp.argmax``)."""
    B, L = batch.text_ids.shape
    max_cache_len = L + max_new_tokens
    next_logits, cache, start_pos = prefill_multimodal(
        params, cfg, batch, max_cache_len, vision_features)
    dev = next_logits.device
    start_pos = start_pos.long()
    if int(start_pos.max()) + max_new_tokens > max_cache_len:
        raise ValueError("decode would write past the KV cache")
    tokens = torch.full((B, max_new_tokens), eos_token_id, dtype=torch.long,
                        device=dev)
    done = torch.zeros(B, dtype=torch.bool, device=dev)
    lengths = torch.zeros(B, dtype=torch.long, device=dev)
    for step in range(max_new_tokens):
        tok = torch.argmax(next_logits.to(torch.float32), dim=-1)
        tok = torch.where(done, eos_token_id, tok)
        tokens[:, step] = tok
        is_eos = tok == eos_token_id
        lengths = torch.where(done | is_eos, lengths, lengths + 1)
        done = done | is_eos
        pos = (start_pos + step)[:, None]
        hidden = qwen2.qwen2_forward(
            params["llm"], cfg.llm,
            qwen2.embed_tokens(params["llm"], tok[:, None]),
            _decode_position_ids(pos), kv_cache=cache, cache_positions=pos,
            kv_len=pos[:, 0] + 1)
        next_logits = qwen2.lm_head(params["llm"], hidden)[:, 0]
        if bool(done.all()):
            break
    return GenerateResult(tokens=tokens, lengths=lengths)
