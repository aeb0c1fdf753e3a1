"""Greedy KV-cache decoding over the spliced multimodal prefill, in PyTorch:
counterpart of ``video3d_tpu/models/generate.py`` (``prefill_multimodal``,
``DecodeState`` / ``start_decode`` / ``generate_from_state``, the greedy
form of ``generate_greedy``, the scene-prefix entry points
``shared_prefix_view``, ``_write_prefix`` and ``start_decode_prefix``, and
the slot API of the continuous batcher over dense rows and page pools).

The JAX ``lax.while_loop`` becomes a Python loop: one decoder forward per
step, stopping once every row has emitted EOS or ``max_new_tokens`` steps
ran. Like the JAX loop, the step that emits the last token still runs its
forward, so a request makes exactly (steps) decode forwards. The cache is
written in place: ``generate_from_state`` consumes its state (the JAX
function donates it).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from video3d_tpu_torch.config import ModelConfig
from video3d_tpu_torch.models import llava_video3d as lv3d
from video3d_tpu_torch.models import paged_kv, qwen2


class GenerateResult(NamedTuple):
    tokens: torch.Tensor    # (B, max_new_tokens) emitted ids (eos-padded)
    lengths: torch.Tensor   # (B,) tokens before EOS (exclusive)


class DecodeState(NamedTuple):
    """Carried decode state between a prefill and the decode loop."""

    next_logits: torch.Tensor   # (B, vocab) logits for the next position
    cache: qwen2.KVCache
    pos: torch.Tensor           # (B,) next absolute position
    done: torch.Tensor          # (B,) bool


def _decode_position_ids(pos: torch.Tensor) -> torch.Tensor:
    """(B, 1) text positions -> (B, 1, 3) replicated mRoPE ids."""
    return pos[..., None].expand(*pos.shape, 3)


def prefill_multimodal(params, cfg: ModelConfig, batch: lv3d.Batch,
                       max_cache_len: int,
                       vision_features: Optional[torch.Tensor] = None,
                       cache_dtype=torch.bfloat16):
    """Vision encode + splice + prefill into a fresh cache of
    ``cache_dtype`` (bf16, or int8 or ``qwen2.KV_INT4`` with scales).
    Returns (next_logits (B, vocab), cache, start_pos (B,)).
    ``vision_features`` (B, T, D) skips the vision encode."""
    B, L = batch.text_ids.shape
    if vision_features is None:
        vision_features = lv3d.encode_video(params, cfg, batch.images,
                                            batch.patch_coords).spliceable
    embeds = lv3d.assemble_embeds(params, cfg, vision_features,
                                  batch.text_ids, batch.kind,
                                  batch.vision_index)
    dev = embeds.device
    cache = qwen2.KVCache.zeros(cfg.llm, B, max_cache_len, dtype=cache_dtype,
                                device=dev)
    cache_positions = torch.arange(L, device=dev)[None].expand(B, L)
    hidden = qwen2.qwen2_forward(
        params["llm"], cfg.llm, embeds, lv3d._position_ids_3d(batch, cfg),
        kv_cache=cache, cache_positions=cache_positions, kv_len=batch.seq_len,
        prefill=True)
    last = hidden[torch.arange(B, device=dev), batch.seq_len.long() - 1]
    next_logits = qwen2.lm_head(params["llm"], last[:, None])[:, 0]
    return next_logits, cache, batch.seq_len


def _initial_state(next_logits, cache, pos) -> DecodeState:
    return DecodeState(next_logits=next_logits, cache=cache, pos=pos.long(),
                       done=torch.zeros(next_logits.shape[0], dtype=torch.bool,
                                        device=next_logits.device))


@torch.inference_mode()
def start_decode(params, cfg: ModelConfig, batch: lv3d.Batch,
                 max_cache_len: int,
                 vision_features: Optional[torch.Tensor] = None,
                 cache_dtype=torch.bfloat16) -> DecodeState:
    """Prefill and return the initial decode state."""
    next_logits, cache, start_pos = prefill_multimodal(
        params, cfg, batch, max_cache_len, vision_features, cache_dtype)
    return _initial_state(next_logits, cache, start_pos)


def shared_prefix_view(prefix: qwen2.KVCache, prefix_len: int,
                       B: int) -> Optional[qwen2.KVCache]:
    """Batch-free (layers, P, KV*hd) view of a stored B=1 prefix (with its
    (layers, P, KV, 1) scales when quantized; int4 values stay packed) for
    the shared-prefix attention path, or None when the path does not apply
    (B == 1: the folded kernel over the seeded cache reads the same bytes
    once anyway). Sliced to ``prefix_len``: the shared path attends every
    prefix slot unmasked."""
    if not (prefix.k.shape[1] == 1 and B > 1):
        return None
    return qwen2.KVCache(*(None if t is None else t[:, 0, :prefix_len]
                           for t in prefix))


def _write_prefix(cache: qwen2.KVCache, prefix: qwen2.KVCache) -> None:
    """Copy a (layers, 1 or B, P, KV*hd) prefix (and its scales; int4
    values as packed bytes) into the head of a fresh cache of the same
    dtype, in place; a B=1 prefix broadcasts into every row. The cache
    never shares memory with the stored prefix, so decode cannot reach
    it."""
    P = prefix.k.shape[2]
    for dst, src in zip(cache, prefix):
        if dst is not None:
            dst[:, :, :P] = src


@torch.inference_mode()
def start_decode_prefix(params, cfg: ModelConfig, batch: lv3d.Batch,
                        prefix: qwen2.KVCache, prefix_len: int,
                        max_cache_len: int,
                        cache_dtype: Optional[torch.dtype] = None
                        ) -> DecodeState:
    """Prefill only a question SUFFIX against a cached scene-prefix KV.

    ``batch`` is the suffix slice of the full splice plan
    (``slice_suffix_plan``): (B, Ls) ids at spliced positions
    [prefix_len, prefix_len + Ls), no vision tokens, and ``batch.seq_len``
    the TOTAL true length. ``prefix`` is the stored (layers, 1, P, KV*hd)
    entry (int8 or packed int4 with its scales); the new cache takes its
    form (``cache_dtype``, when given, must be that form, as the JAX
    function requires). The cache is seeded with the prefix (broadcast to
    every row), the suffix K/V are written after it, and the suffix attends
    the prefix plus itself: through the cache and the folded kernel at
    B == 1, through the shared-prefix kernel at B > 1. Decoding then
    proceeds unchanged.
    """
    B, Ls = batch.text_ids.shape
    dev = batch.text_ids.device
    if prefix_len + Ls > max_cache_len:
        raise ValueError("prefix + suffix longer than the KV cache")
    if cache_dtype is not None and \
            qwen2.kv_storage_dtype(cache_dtype) != prefix.k.dtype:
        raise ValueError(f"a {prefix.k.dtype} prefix cannot seed a "
                         f"{cache_dtype} cache")
    cache = qwen2.KVCache.zeros(cfg.llm, B, max_cache_len,
                                dtype=prefix.k.dtype, device=dev)
    _write_prefix(cache, prefix)
    emb = params["llm"]["embed_tokens"]
    dummy_vis = torch.zeros((B, 1, emb.shape[-1]), dtype=emb.dtype,
                            device=dev)
    embeds = lv3d.assemble_embeds(params, cfg, dummy_vis, batch.text_ids,
                                  batch.kind, batch.vision_index)
    cache_positions = (prefix_len + torch.arange(Ls, device=dev))[None] \
        .expand(B, Ls)
    hidden = qwen2.qwen2_forward(
        params["llm"], cfg.llm, embeds, lv3d._position_ids_3d(batch, cfg),
        kv_cache=cache, cache_positions=cache_positions, kv_len=batch.seq_len,
        contiguous_update=True,
        shared_prefix=shared_prefix_view(prefix, prefix_len, B))
    last = hidden[torch.arange(B, device=dev),
                  batch.seq_len.long() - 1 - prefix_len]
    next_logits = qwen2.lm_head(params["llm"], last[:, None])[:, 0]
    return _initial_state(next_logits, cache, batch.seq_len)


def _greedy(next_logits: torch.Tensor, done: torch.Tensor,
            eos_token_id: int) -> torch.Tensor:
    """argmax over float32 logits (first maximum), EOS for done rows."""
    tok = torch.argmax(next_logits.to(torch.float32), dim=-1)
    return torch.where(done, eos_token_id, tok)


@torch.inference_mode()
def generate_from_state(params, cfg: ModelConfig, state: DecodeState,
                        max_new_tokens: int = 512,
                        eos_token_id: int = 151645) -> GenerateResult:
    """Greedy decode from a prefilled state (full or prefix-cached):
    argmax over float32 logits (first maximum on ties, as ``jnp.argmax``).
    The state's cache is written in place."""
    next_logits, cache, start_pos, done = state
    B = next_logits.shape[0]
    dev = next_logits.device
    if int(start_pos.max()) + max_new_tokens > cache.k.shape[2]:
        raise ValueError("decode would write past the KV cache")
    tokens = torch.full((B, max_new_tokens), eos_token_id, dtype=torch.long,
                        device=dev)
    lengths = torch.zeros(B, dtype=torch.long, device=dev)
    for step in range(max_new_tokens):
        tok = _greedy(next_logits, done, eos_token_id)
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


def generate_greedy(params, cfg: ModelConfig, batch: lv3d.Batch,
                    max_new_tokens: int = 512, eos_token_id: int = 151645,
                    vision_features: Optional[torch.Tensor] = None,
                    cache_dtype=torch.bfloat16) -> GenerateResult:
    """Greedy decode into a cache of L + max_new_tokens slots."""
    state = start_decode(params, cfg, batch,
                         batch.text_ids.shape[1] + max_new_tokens,
                         vision_features, cache_dtype)
    return generate_from_state(params, cfg, state, max_new_tokens,
                               eos_token_id)


# ---------------------------------------------------------------------------
# The continuous batcher's slot API (JAX ``generate.py:482-682``): an S-slot
# state whose rows are admitted, decoded together and released. Greedy only
# (JAX's ``sample_token`` at temperature 0 is the argmax; sampling is
# ROADMAP A4 / A8). The states are updated in place; a decode chunk makes no
# host sync and returns its tokens on the device.
# ---------------------------------------------------------------------------


def empty_decode_state(cfg: ModelConfig, num_slots: int, max_cache_len: int,
                       cache_dtype=torch.bfloat16,
                       logits_dtype=torch.float32,
                       device=None) -> DecodeState:
    """All-done S-slot DecodeState of dense cache rows: the persistent state
    of a continuous batcher. Slots are rows; admission is
    :func:`insert_decode_slot` of a B=1 prefill."""
    return DecodeState(
        next_logits=torch.zeros((num_slots, cfg.llm.vocab_size),
                                dtype=logits_dtype, device=device),
        cache=qwen2.KVCache.zeros(cfg.llm, num_slots, max_cache_len,
                                  dtype=cache_dtype, device=device),
        pos=torch.zeros(num_slots, dtype=torch.long, device=device),
        done=torch.ones(num_slots, dtype=torch.bool, device=device))


@torch.inference_mode()
def insert_decode_slot(state: DecodeState, slot: int,
                       sub: DecodeState) -> DecodeState:
    """Copy a freshly prefilled B=1 DecodeState into row ``slot``, in place;
    the caches must have the same length."""
    if sub.cache.k.shape[2] != state.cache.k.shape[2]:
        raise ValueError("the prefilled cache and the slot rows differ in "
                         "length")
    for big, small in zip(state.cache, sub.cache):
        if big is not None:
            big[:, slot] = small[:, 0]
    state.next_logits[slot] = sub.next_logits[0]
    state.pos[slot] = sub.pos[0]
    state.done[slot] = sub.done[0]
    return state


@torch.inference_mode()
def release_decode_slot(state: DecodeState, slot: int) -> DecodeState:
    """Force a slot done (finished, budget spent or cancelled); decode
    chunks then emit EOS for it until it is reused."""
    state.done[slot] = True
    return state


@torch.inference_mode()
def decode_chunk(params, cfg: ModelConfig, state: DecodeState,
                 chunk: int = 16, eos_token_id: int = 151645):
    """Emit ``chunk`` greedy tokens from every row of a dense S-slot state
    (done rows emit EOS); returns (state, tokens (S, chunk)), the state
    updated in place.

    As in JAX, done rows still run the step and their position advances.
    A done row can so run past the end of its cache row: JAX drops such
    writes; here they land in the row's last slot, which the next
    :func:`insert_decode_slot` rewrites with the whole row."""
    next_logits, cache, pos, done = state
    last = cache.k.shape[2] - 1
    toks = []
    for _ in range(chunk):
        tok = _greedy(next_logits, done, eos_token_id)
        toks.append(tok)
        done = done | (tok == eos_token_id)
        hidden = qwen2.qwen2_forward(
            params["llm"], cfg.llm,
            qwen2.embed_tokens(params["llm"], tok[:, None]),
            _decode_position_ids(pos[:, None]), kv_cache=cache,
            cache_positions=pos.clamp(max=last)[:, None], kv_len=pos + 1)
        # keep the state's logits dtype (f32 from empty_decode_state)
        next_logits = qwen2.lm_head(params["llm"], hidden)[:, 0] \
            .to(next_logits.dtype)
        pos = pos + 1
    return DecodeState(next_logits, cache, pos, done), torch.stack(toks, 1)


class PagedDecodeState(NamedTuple):
    """S-slot state over a shared page pool; the slots' lengths live in
    ``cache.lens`` (the dense state's ``pos``)."""

    next_logits: torch.Tensor   # (S, vocab)
    cache: paged_kv.PagedKVCache
    done: torch.Tensor          # (S,) bool


def empty_paged_state(cfg: ModelConfig, num_slots: int, num_pages: int,
                      page_size: int, max_pages: int,
                      cache_dtype=torch.bfloat16,
                      logits_dtype=torch.float32,
                      device=None) -> PagedDecodeState:
    """All-done paged batcher state."""
    return PagedDecodeState(
        next_logits=torch.zeros((num_slots, cfg.llm.vocab_size),
                                dtype=logits_dtype, device=device),
        cache=paged_kv.PagedKVCache.zeros(cfg.llm, num_pages, page_size,
                                          num_slots, max_pages,
                                          dtype=cache_dtype, device=device),
        done=torch.ones(num_slots, dtype=torch.bool, device=device))


@torch.inference_mode()
def insert_paged_slot(state: PagedDecodeState, slot: int, sub: DecodeState,
                      page_row: torch.Tensor, n_pages: int,
                      skip_pages: int = 0) -> PagedDecodeState:
    """Copy a freshly prefilled B=1 dense DecodeState into paged slot
    ``slot``, in place: its first ``n_pages`` pages (listed in the
    (max_pages,) ``page_row``) take the dense cache's n_pages * page
    positions (quantized: values and scales verbatim), ``lens[slot]``
    becomes the prefill length. ``skip_pages``: the row's first entries are
    shared scene-prefix pages written by :func:`write_shared_prefix`; only
    pages ``skip_pages..n_pages`` are copied."""
    paged_kv.transplant_dense(state.cache, sub.cache, slot, page_row,
                              n_pages, sub.pos[0], skip_pages=skip_pages)
    state.next_logits[slot] = sub.next_logits[0]
    state.done[slot] = sub.done[0]
    return state


@torch.inference_mode()
def write_shared_prefix(cache: paged_kv.PagedKVCache, prefix: qwen2.KVCache,
                        pages, n_pages: int) -> paged_kv.PagedKVCache:
    """Write a scene's prefix KV (the dense (layers, 1, P, ...) entry of the
    engine's prefix cache, same dtype) into ``n_pages`` shared pool pages,
    in place."""
    return paged_kv.scatter_shared_prefix(cache, prefix, pages, n_pages)


@torch.inference_mode()
def release_paged_slot(state: PagedDecodeState,
                       slot: int) -> PagedDecodeState:
    """Force a slot done; the host frees its pages (done rows append to the
    scratch page and their length is frozen, so the pages are not read
    again)."""
    state.done[slot] = True
    return state


@torch.inference_mode()
def paged_decode_chunk(params, cfg: ModelConfig, state: PagedDecodeState,
                       chunk: int = 16, eos_token_id: int = 151645):
    """:func:`decode_chunk` over the page pools: the same emissions (EOS
    for done rows), but dead slots neither advance their length nor touch
    their pages (a slot's step still runs while it emits its EOS). The
    caller guarantees pages for ``lens + chunk`` on every live slot (the
    paged batcher reserves the whole budget at admission)."""
    next_logits, cache, done = state
    toks = []
    for _ in range(chunk):
        tok = _greedy(next_logits, done, eos_token_id)
        toks.append(tok)
        hidden = qwen2.qwen2_forward(
            params["llm"], cfg.llm,
            qwen2.embed_tokens(params["llm"], tok[:, None]),
            _decode_position_ids(cache.lens.long()[:, None]),
            paged_cache=cache, paged_active=~done)
        done = done | (tok == eos_token_id)
        next_logits = qwen2.lm_head(params["llm"], hidden)[:, 0] \
            .to(next_logits.dtype)
    return PagedDecodeState(next_logits, cache, done), torch.stack(toks, 1)
