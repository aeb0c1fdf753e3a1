"""Speculative decoding in PyTorch: counterpart of
``video3d_tpu/models/speculative.py``.

A cheap draft model proposes ``K`` tokens one step at a time, then the
target scores the block [cur, d_1..d_K] in ONE (K+1)-token forward and
keeps the longest prefix it agrees with, plus its own next token. Greedy
verification emits exactly the target's argmaxes, so the output is vanilla
greedy decoding's; sampled verification is chain rejection sampling
(Leviathan et al. 2023, Chen et al. 2023), whose emissions follow the
warped target distribution exactly. The draft only changes the speed.

The draft is any decoder with the target's width and vocabulary, or
:func:`self_draft_params`, the target's first ``k`` layers (the same
tensors, no copy), optionally with its head cut to the first
``draft_vocab`` tokens.

As in JAX, a rejected block needs no rollback: ``pos`` advances by the
kept count and the stale K/V past it is masked by the key length and
overwritten by the next round's block. The dense verify writes its block
at each row's own offset (``qwen2.decoder_layer``'s per-row writes) and
attends the cache through B2 folded (L = K+1 rows per batch row); the
paged verify appends the block into the slot's pages and attends them
through ``paged_attention_multi`` (plain gather, as JAX's); the draft
steps are one-token decode steps (B3) over a dense draft cache.

JAX's ``lax.while_loop`` / ``lax.scan`` over rounds become host loops with
one sync per round (``generate_speculative``) or per chunk of rounds (the
batcher's ``spec_decode_chunk``). Rounds run eagerly. Random draws use the
decode loops' counter hash (``generate.hash_bits``: seed, round, row,
token) with a stream tag for each use: the draft's draw at step i, the
acceptance uniforms and the residual draw. A round's draws are so a pure
function of (seed, round, row), and one-shot and chunked loops draw alike.
The first token is drawn as the plain decode loops draw theirs (step 0,
no tag).

A row whose position runs past its cache row (a batcher slot decoding past
its budget inside a chunk: its tokens are discarded on the host) writes
its block at the last K+1 slots instead; JAX drops such writes.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional, Tuple

import torch

from video3d_tpu_torch.config import LLMConfig, ModelConfig
from video3d_tpu_torch.models import llava_video3d as lv3d
from video3d_tpu_torch.models import paged_kv, qwen2
from video3d_tpu_torch.models.generate import (Sampling,
                                               _decode_position_ids,
                                               _embeds_and_pos, gumbel_noise,
                                               hash_bits, sample_token,
                                               uniform_from_bits, warp_logits)

#: stream tags of a round's draws (``generate.hash_bits``): the draft's
#: draw at step i is DRAFT_TAG + i
DRAFT_TAG = 0x100
ACCEPT_TAG = 0x200
RESIDUAL_TAG = 0x201


def rejection_sample_block(d: torch.Tensor, q_probs: torch.Tensor,
                           t_probs: torch.Tensor, seed: int = 0,
                           step: Optional[torch.Tensor] = None):
    """Chain speculative rejection sampling for one drafted block (JAX
    :43).

    d (B, K) draft tokens, each d_i ~ q_i; q_probs (B, K, V) the draft's
    proposal distributions; t_probs (B, K+1, V) the target's (position i
    conditions on the accepted prefix and d_1..d_i). Returns (emit (B,
    K+1), a (B,)): emit[:, j] = d_j for j < a, emit[:, a] the residual
    draw from relu(p - q) on a rejection, or the bonus draw from t_K when
    all K are accepted. d_i is accepted when u_i * q(d_i) < p(d_i) (no
    division). The draws are the counter hash of (seed, step, row) in the
    ACCEPT_TAG and RESIDUAL_TAG streams."""
    B, K, V = q_probs.shape
    dev = q_probs.device
    if step is None:
        step = torch.zeros((), dtype=torch.long, device=dev)
    qd = torch.gather(q_probs, -1, d[..., None])[..., 0]
    pd = torch.gather(t_probs[:, :K], -1, d[..., None])[..., 0]
    u = uniform_from_bits(hash_bits(seed, step, (B, K), dev, ACCEPT_TAG))
    accept = u * qd < pd
    a = torch.cumprod(accept.long(), dim=1).sum(dim=1)
    # the stop position's distribution: relu(p - q) normalised on a
    # rejection; q's row K is zero, so a == K gives p itself
    q_pad = torch.cat([q_probs, q_probs.new_zeros((B, 1, V))], dim=1)
    rows = torch.arange(B, device=dev)
    p_sel, q_sel = t_probs[rows, a], q_pad[rows, a]
    resid = (p_sel - q_sel).clamp(min=0.0)
    z = resid.sum(-1, keepdim=True)
    resid = torch.where(z > 0, resid / z, p_sel)   # p == q: accepted surely
    y = torch.argmax(torch.log(resid) + gumbel_noise(
        seed, step, (B, V), dev, RESIDUAL_TAG), dim=-1)
    d_pad = torch.cat([d, d[:, :1]], dim=1)
    idx = torch.arange(K + 1, device=dev)[None]
    return torch.where(idx < a[:, None], d_pad, y[:, None]), a


def self_draft_params(params, k: int, draft_vocab: int = 0):
    """Early-exit draft from the target's own weights (JAX :84): its first
    ``k`` decoder layers (a list slice: the same tensors) and its final
    norm, embeddings and lm_head. ``draft_vocab > 0`` cuts a plain 2-D head
    to its first that many token columns (a view): a greedy answer is
    unchanged (rejections rise), a sampled one keeps its law (the residual
    covers tokens the draft cannot propose)."""
    llm = params["llm"]
    head = llm["lm_head"]
    if draft_vocab and isinstance(head, torch.Tensor) and head.dim() == 2:
        head = head[:, :draft_vocab]
    return {"embed_tokens": llm["embed_tokens"], "layers": llm["layers"][:k],
            "norm": llm["norm"], "lm_head": head}


def self_draft_config(cfg: LLMConfig, k: int) -> LLMConfig:
    return dataclasses.replace(cfg, num_hidden_layers=k)


def _shares_layers(params, draft_params) -> bool:
    """The draft is the target's first layers (:func:`self_draft_params`):
    its K/V over a sequence are the target's first layers' bit for bit."""
    layers = params["llm"]["layers"]
    dl = draft_params["layers"]
    return (len(dl) <= len(layers)
            and draft_params["embed_tokens"] is params["llm"]["embed_tokens"]
            and all(a is b for a, b in zip(dl, layers)))


def _copy_layers(dst: qwen2.KVCache, src: qwen2.KVCache, n: int) -> None:
    """dst[:, :, :n] = src[:k, :, :n] for each of k / v (and scales): a
    self-draft's cache from the target's."""
    k = dst.k.shape[0]
    for a, b in zip(dst, src):
        if a is not None:
            a[:, :, :n] = b[:k, :, :n]


class SpecResult(NamedTuple):
    tokens: torch.Tensor          # (B, max_new_tokens) eos-padded ids
    lengths: torch.Tensor         # (B,) tokens before EOS
    target_forwards: int          # verify passes run, the prefill counted
    accepted_drafts: int          # draft tokens accepted
    offered_drafts: int           # K per live row per round


def _last_logits(params, hidden: torch.Tensor, idx: torch.Tensor):
    B = hidden.shape[0]
    last = hidden[torch.arange(B, device=hidden.device), idx.long()]
    return qwen2.lm_head(params["llm"], last[:, None])[:, 0]


@torch.inference_mode()
def spec_prefill(params, draft_params, cfg: ModelConfig,
                 draft_cfg: LLMConfig, batch: lv3d.Batch,
                 max_cache_len: int, cache_dtype=torch.bfloat16,
                 vision_features: Optional[torch.Tensor] = None,
                 draft_max_cache_len: Optional[int] = None):
    """Vision encode and splice once, then both models' prefills (JAX
    :121). Returns (next_logits (B, vocab), target cache, draft cache).
    ``draft_max_cache_len`` sizes the draft cache on its own (the paged
    batcher's target cache is only the prompt's pages). A self-draft's
    cache is the target's first layers, copied, instead of a second
    forward: the same values."""
    B, L = batch.text_ids.shape
    dev = batch.text_ids.device
    embeds, pos3 = _embeds_and_pos(params, cfg, batch, vision_features)
    positions = torch.arange(L, device=dev)[None].expand(B, L)
    dmcl = draft_max_cache_len or max_cache_len

    def prefill(llm, c: LLMConfig, mcl: int):
        cache = qwen2.KVCache.zeros(c, B, mcl, dtype=cache_dtype, device=dev)
        hidden = qwen2.qwen2_forward(llm, c, embeds, pos3, kv_cache=cache,
                                     cache_positions=positions,
                                     kv_len=batch.seq_len, prefill=True)
        return hidden, cache

    hidden, t_cache = prefill(params["llm"], cfg.llm, max_cache_len)
    next_logits = _last_logits(params, hidden, batch.seq_len - 1)
    if _shares_layers(params, draft_params):
        d_cache = qwen2.KVCache.zeros(draft_cfg, B, dmcl, dtype=cache_dtype,
                                      device=dev)
        _copy_layers(d_cache, t_cache, min(L, dmcl))
    else:
        _, d_cache = prefill(draft_params, draft_cfg, dmcl)
    return next_logits, t_cache, d_cache


@torch.inference_mode()
def spec_prefill_prefix(params, draft_params, cfg: ModelConfig,
                        draft_cfg: LLMConfig, batch: lv3d.Batch,
                        prefix: qwen2.KVCache, prefix_len: int,
                        max_cache_len: int, cache_dtype=None,
                        draft_max_cache_len: Optional[int] = None):
    """:func:`spec_prefill` against a stored scene prefix (JAX :161), for
    self-drafts only: the draft is the target's first k layers, so the
    target's suffix forward over the prefix gives the draft's cache too
    (its first k layers, copied). ``batch`` is the suffix slice; no vision
    work."""
    from video3d_tpu_torch.models.generate import _suffix_forward

    if not _shares_layers(params, draft_params):
        raise ValueError("prefix reuse needs a self-draft")
    B, Ls = batch.text_ids.shape
    dmcl = draft_max_cache_len or max_cache_len
    hidden, t_cache = _suffix_forward(params, cfg, batch, prefix, prefix_len,
                                      max_cache_len, cache_dtype)
    next_logits = _last_logits(params, hidden,
                               batch.seq_len - 1 - prefix_len)
    d_cache = qwen2.KVCache.zeros(draft_cfg, B, dmcl, dtype=prefix.k.dtype,
                                  device=batch.text_ids.device)
    _copy_layers(d_cache, t_cache, min(prefix_len + Ls, dmcl))
    return next_logits, t_cache, d_cache


def _block_start(pos: torch.Tensor, cache_len: int, K: int) -> torch.Tensor:
    """Where a round writes its K+1 positions: ``pos``, or the last K+1
    slots of the row for a row past its budget."""
    return pos.clamp(max=cache_len - (K + 1))


def _draft_block(draft_params, draft_cfg: LLMConfig, cur: torch.Tensor,
                 pos: torch.Tensor, d_cache: qwen2.KVCache, K: int,
                 sampling: Sampling, step: torch.Tensor):
    """K+1 one-token draft forwards from ``cur`` at ``pos`` (JAX :268; the
    last only writes d_K's K/V, so its lm_head is skipped). Returns (d (B,
    K), the draft's warped distributions (B, K, V') when sampled, else
    None)."""
    start = _block_start(pos, d_cache.k.shape[2], K)
    tok, drafts, probs = cur, [], []
    for i in range(K + 1):
        p = (start + i)[:, None]
        h = qwen2.qwen2_forward(
            draft_params, draft_cfg, qwen2.embed_tokens(draft_params,
                                                        tok[:, None]),
            _decode_position_ids(p), kv_cache=d_cache, cache_positions=p,
            kv_len=p[:, 0] + 1)
        if i == K:
            break
        logits = qwen2.lm_head(draft_params, h)[:, 0]
        if sampling.greedy:
            tok = torch.argmax(logits.float(), dim=-1)
        else:
            warped = warp_logits(logits, sampling.temperature,
                                 sampling.top_p, sampling.top_k)
            tok = torch.argmax(warped + gumbel_noise(
                sampling.seed, step, warped.shape, warped.device,
                DRAFT_TAG + i), dim=-1)
            probs.append(torch.softmax(warped, dim=-1))
        drafts.append(tok)
    return torch.stack(drafts, 1), (torch.stack(probs, 1) if probs else None)


def _accept_block(d: torch.Tensor, q_probs: Optional[torch.Tensor],
                  t_logits: torch.Tensor, K: int, sampling: Sampling,
                  step: torch.Tensor):
    """Greedy or chain-rejection acceptance of one verify block (JAX
    :300), shared by the dense and paged paths. Returns (emit (B, K+1), a
    (B,))."""
    if sampling.greedy:
        t = torch.argmax(t_logits.float(), dim=-1)
        a = torch.cumprod((d == t[:, :K]).long(), dim=1).sum(dim=1)
        return t, a
    B, Kp1, V = t_logits.shape
    t_probs = torch.softmax(warp_logits(
        t_logits.reshape(B * Kp1, V), sampling.temperature, sampling.top_p,
        sampling.top_k), dim=-1).reshape(B, Kp1, V)
    if q_probs.shape[-1] != V:
        # a truncated draft vocabulary: a subset-support proposal is still
        # a valid q; the residual covers the tokens it cannot propose
        q_probs = torch.nn.functional.pad(q_probs,
                                          (0, V - q_probs.shape[-1]))
    return rejection_sample_block(d, q_probs, t_probs, sampling.seed, step)


def accept_truncate(emit: torch.Tensor, a: torch.Tensor, done: torch.Tensor,
                    eos_token_id: int, K: int):
    """One round's kept emissions (JAX :325): the valid prefix up to
    ``a``, cut after the first EOS, none for rows already done. Returns
    (keep, is_eos, idx)."""
    idx = torch.arange(K + 1, device=emit.device)[None]
    valid = idx <= a[:, None]
    is_eos = emit == eos_token_id
    hit = valid & is_eos
    eos_before = torch.cumsum(hit.long(), dim=1) - hit.long()
    keep = valid & (eos_before == 0) & ~done[:, None]
    return keep, is_eos, idx


def _verify_dense(params, cfg: ModelConfig, cur: torch.Tensor,
                  pos: torch.Tensor, d: torch.Tensor,
                  t_cache: qwen2.KVCache, K: int) -> torch.Tensor:
    """The (K+1)-token target forward over [cur, d_1..d_K] at each row's
    own offset; returns the block's logits (B, K+1, V)."""
    start = _block_start(pos, t_cache.k.shape[2], K)
    bpos = start[:, None] + torch.arange(K + 1, device=pos.device)
    block = torch.cat([cur[:, None], d], dim=1)
    h = qwen2.qwen2_forward(
        params["llm"], cfg.llm, qwen2.embed_tokens(params["llm"], block),
        _decode_position_ids(bpos), kv_cache=t_cache, cache_positions=bpos,
        kv_len=start + K + 1)
    return qwen2.lm_head(params["llm"], h)


def spec_iteration(params, draft_params, cfg: ModelConfig,
                   draft_cfg: LLMConfig, cur, pos, t_cache, d_cache, K: int,
                   sampling: Sampling, step: torch.Tensor):
    """One speculative round for a batch of independent rows (JAX :238):
    K+1 draft steps, one (K+1)-token verify, acceptance. Returns (emit (B,
    K+1), a (B,)); both caches are written in place."""
    d, q_probs = _draft_block(draft_params, draft_cfg, cur, pos, d_cache, K,
                              sampling, step)
    t_logits = _verify_dense(params, cfg, cur, pos, d, t_cache, K)
    return _accept_block(d, q_probs, t_logits, K, sampling, step)


def _advance(emit, a, cur, done, eos_token_id: int, K: int):
    """A round's bookkeeping shared by the slot loops: ``cur`` and ``done``
    updated in place. Returns (keep, n_keep)."""
    keep, is_eos, _ = accept_truncate(emit, a, done, eos_token_id, K)
    n_keep = keep.sum(dim=1)
    new_done = done | (keep & is_eos).any(dim=1)
    last = torch.gather(emit, 1, (n_keep - 1).clamp(min=0)[:, None])[:, 0]
    cur.copy_(torch.where(new_done | (n_keep == 0), eos_token_id, last))
    done.copy_(new_done)
    return keep, n_keep


@torch.inference_mode()
def generate_speculative(params, draft_params, cfg: ModelConfig,
                         draft_cfg: LLMConfig, batch: lv3d.Batch,
                         num_draft_tokens: int = 4,
                         max_new_tokens: int = 512,
                         eos_token_id: int = 151645,
                         max_cache_len: Optional[int] = None,
                         cache_dtype=torch.bfloat16,
                         temperature: float = 0.0, top_p: float = 1.0,
                         top_k: int = 0, seed: int = 0,
                         vision_features: Optional[torch.Tensor] = None
                         ) -> SpecResult:
    """Speculative decode (JAX :344): greedy at temperature 0 (the emitted
    ids are ``generate_greedy``'s), else chain rejection sampling of the
    same warped target distribution as vanilla sampling. One host sync per
    round (is every row done?). The caches hold L + max_new_tokens + K + 2
    slots by default: the verify block writes past the accepted
    position."""
    K = num_draft_tokens
    sampling = Sampling(temperature, top_p, top_k, seed)
    B, L = batch.text_ids.shape
    dev = batch.text_ids.device
    if max_cache_len is None:
        max_cache_len = L + max_new_tokens + K + 2
    next_logits, t_cache, d_cache = spec_prefill(
        params, draft_params, cfg, draft_cfg, batch, max_cache_len,
        cache_dtype, vision_features)
    step = torch.zeros((), dtype=torch.long, device=dev)
    cur = sample_token(next_logits, sampling, step)
    tokens = torch.full((B, max_new_tokens + 1), eos_token_id,
                        dtype=torch.long, device=dev)
    if max_new_tokens <= 0:
        return SpecResult(tokens[:, :0], torch.zeros(B, dtype=torch.long,
                                                     device=dev), 1, 0, 0)
    tokens[:, 0] = cur
    done = cur == eos_token_id
    lengths = (~done).long()
    out_len = torch.ones(B, dtype=torch.long, device=dev)
    pos = batch.seq_len.long().clone()
    n_fwd, n_acc, n_off = 1, torch.zeros((), dtype=torch.long, device=dev), \
        torch.zeros((), dtype=torch.long, device=dev)
    while not bool((done | (out_len >= max_new_tokens)).all()):
        emit, a = spec_iteration(params, draft_params, cfg, draft_cfg, cur,
                                 pos, t_cache, d_cache, K, sampling, step)
        keep, is_eos, idx = accept_truncate(emit, a, done, eos_token_id, K)
        keep &= out_len[:, None] + idx < max_new_tokens
        n_keep = keep.sum(dim=1)
        cols = torch.where(keep, out_len[:, None] + idx, max_new_tokens)
        tokens.scatter_(1, cols, emit)
        new_done = done | (keep & is_eos).any(dim=1)
        lengths += (keep & ~is_eos).sum(dim=1)
        out_len += n_keep
        last = torch.gather(emit, 1, (n_keep - 1).clamp(min=0)[:, None])[:, 0]
        cur = torch.where(new_done | (n_keep == 0), eos_token_id, last)
        pos = torch.where(done, pos, pos + n_keep)
        n_acc += torch.where(done, 0, a).sum()
        n_off += K * (~done).sum()
        done = new_done | (out_len >= max_new_tokens)
        n_fwd += 1
        step += 1
    return SpecResult(tokens=tokens[:, :max_new_tokens],
                      lengths=lengths.clamp(max=max_new_tokens),
                      target_forwards=n_fwd, accepted_drafts=int(n_acc),
                      offered_drafts=int(n_off))


# ---------------------------------------------------------------------------
# Persistent slots: speculative decoding inside the continuous batcher
# (JAX :458-580), both models' caches per slot, updated in place.
# ---------------------------------------------------------------------------


class SpecSlots(NamedTuple):
    cur: torch.Tensor        # (S,) last emitted token per slot (not cached)
    pos: torch.Tensor        # (S,) absolute position of ``cur``
    done: torch.Tensor       # (S,) bool
    t_cache: qwen2.KVCache
    d_cache: qwen2.KVCache
    n_iter: torch.Tensor     # () int64 rounds run (the draws' counter)


def _zeros_long(n: Tuple[int, ...], device) -> torch.Tensor:
    return torch.zeros(n, dtype=torch.long, device=device)


def empty_spec_slots(cfg: ModelConfig, draft_cfg: LLMConfig, num_slots: int,
                     max_cache_len: int, cache_dtype=torch.bfloat16,
                     device=None) -> SpecSlots:
    return SpecSlots(
        cur=_zeros_long((num_slots,), device),
        pos=_zeros_long((num_slots,), device),
        done=torch.ones(num_slots, dtype=torch.bool, device=device),
        t_cache=qwen2.KVCache.zeros(cfg.llm, num_slots, max_cache_len,
                                    dtype=cache_dtype, device=device),
        d_cache=qwen2.KVCache.zeros(draft_cfg, num_slots, max_cache_len,
                                    dtype=cache_dtype, device=device),
        n_iter=_zeros_long((), device))


def _one_slot(next_logits, t_cache, d_cache, seq_len,
              sampling: Sampling) -> Tuple[SpecSlots, torch.Tensor]:
    dev = next_logits.device
    cur = sample_token(next_logits, sampling, _zeros_long((), dev))
    return SpecSlots(cur=cur, pos=seq_len.long().clone(),
                     done=torch.zeros_like(cur, dtype=torch.bool),
                     t_cache=t_cache, d_cache=d_cache,
                     n_iter=_zeros_long((), dev)), cur


@torch.inference_mode()
def spec_start(params, draft_params, cfg: ModelConfig, draft_cfg: LLMConfig,
               batch: lv3d.Batch, max_cache_len: int,
               cache_dtype=torch.bfloat16, temperature: float = 0.0,
               top_p: float = 1.0, top_k: int = 0, seed: int = 0,
               vision_features: Optional[torch.Tensor] = None,
               draft_max_cache_len: Optional[int] = None):
    """Prefill both models for a request and draw its first token (JAX
    :484). Returns (SpecSlots of its rows, first token (B,))."""
    next_logits, t_cache, d_cache = spec_prefill(
        params, draft_params, cfg, draft_cfg, batch, max_cache_len,
        cache_dtype, vision_features, draft_max_cache_len)
    return _one_slot(next_logits, t_cache, d_cache, batch.seq_len,
                     Sampling(temperature, top_p, top_k, seed))


@torch.inference_mode()
def spec_start_prefix(params, draft_params, cfg: ModelConfig,
                      draft_cfg: LLMConfig, batch: lv3d.Batch,
                      prefix: qwen2.KVCache, prefix_len: int,
                      max_cache_len: int, cache_dtype=None,
                      temperature: float = 0.0, top_p: float = 1.0,
                      top_k: int = 0, seed: int = 0,
                      draft_max_cache_len: Optional[int] = None):
    """:func:`spec_start` through a stored scene prefix (JAX :216; the
    suffix-only prefill of both models)."""
    next_logits, t_cache, d_cache = spec_prefill_prefix(
        params, draft_params, cfg, draft_cfg, batch, prefix, prefix_len,
        max_cache_len, cache_dtype, draft_max_cache_len)
    return _one_slot(next_logits, t_cache, d_cache, batch.seq_len,
                     Sampling(temperature, top_p, top_k, seed))


def _graft(big: qwen2.KVCache, small: qwen2.KVCache, slot: int) -> None:
    if small.k.shape[2] != big.k.shape[2]:
        raise ValueError("the prefilled cache and the slot rows differ in "
                         "length")
    for b, s in zip(big, small):
        if b is not None:
            b[:, slot] = s[:, 0]


@torch.inference_mode()
def insert_spec_slot(slots: SpecSlots, slot: int,
                     sub: SpecSlots) -> SpecSlots:
    """Copy a B=1 :func:`spec_start` result into row ``slot`` of both
    caches, in place (JAX :507)."""
    _graft(slots.t_cache, sub.t_cache, slot)
    _graft(slots.d_cache, sub.d_cache, slot)
    slots.cur[slot] = sub.cur[0]
    slots.pos[slot] = sub.pos[0]
    slots.done[slot] = False
    return slots


@torch.inference_mode()
def release_spec_slot(slots, slot: int):
    """Force a slot done, in :class:`SpecSlots` or :class:`PagedSpecSlots`
    (JAX ``release_spec_slot`` :521 and ``release_paged_spec_slot`` :635):
    its rounds keep nothing until it is reused."""
    slots.done[slot] = True
    return slots


@torch.inference_mode()
def spec_decode_chunk(params, draft_params, cfg: ModelConfig,
                      draft_cfg: LLMConfig, slots: SpecSlots,
                      iters: int = 4, num_draft_tokens: int = 4,
                      eos_token_id: int = 151645, temperature: float = 0.0,
                      top_p: float = 1.0, top_k: int = 0, seed: int = 0):
    """``iters`` speculative rounds for every slot (JAX :528), the state
    updated in place. Returns (slots, emit (S, iters, K+1), keep (S, iters,
    K+1) bool): round j's candidate emissions and the kept prefix (empty
    for done slots); the host walks ``keep`` and applies budgets by
    releasing slots. No host sync."""
    K = num_draft_tokens
    sampling = Sampling(temperature, top_p, top_k, seed)
    emits, keeps = [], []
    for _ in range(iters):
        emit, a = spec_iteration(params, draft_params, cfg, draft_cfg,
                                 slots.cur, slots.pos, slots.t_cache,
                                 slots.d_cache, K, sampling, slots.n_iter)
        done0 = slots.done.clone()
        keep, n_keep = _advance(emit, a, slots.cur, slots.done, eos_token_id,
                                K)
        slots.pos.copy_(torch.where(done0, slots.pos, slots.pos + n_keep))
        slots.n_iter.add_(1)
        emits.append(emit)
        keeps.append(keep)
    return slots, torch.stack(emits, 1), torch.stack(keeps, 1)


# ---------------------------------------------------------------------------
# A paged target cache with speculation (JAX :583-693): the target's K/V in
# the shared page pool, the draft's in dense rows. The verify appends its
# block with one multi-token paged forward and sets ``lens`` back to the
# kept prefix; the next round's block overwrites the rejected positions.
# ---------------------------------------------------------------------------


class PagedSpecSlots(NamedTuple):
    """S-slot speculative state over a paged target cache; a slot's
    position is ``cache.lens``."""

    cur: torch.Tensor            # (S,) last emitted token per slot
    done: torch.Tensor           # (S,) bool
    cache: paged_kv.PagedKVCache
    d_cache: qwen2.KVCache       # dense draft rows
    n_iter: torch.Tensor         # () int64


def empty_paged_spec_slots(cfg: ModelConfig, draft_cfg: LLMConfig,
                           num_slots: int, num_pages: int, page_size: int,
                           max_pages: int, draft_max_cache_len: int,
                           cache_dtype=torch.bfloat16,
                           device=None) -> PagedSpecSlots:
    return PagedSpecSlots(
        cur=_zeros_long((num_slots,), device),
        done=torch.ones(num_slots, dtype=torch.bool, device=device),
        cache=paged_kv.PagedKVCache.zeros(cfg.llm, num_pages, page_size,
                                          num_slots, max_pages,
                                          dtype=cache_dtype, device=device),
        d_cache=qwen2.KVCache.zeros(draft_cfg, num_slots, draft_max_cache_len,
                                    dtype=cache_dtype, device=device),
        n_iter=_zeros_long((), device))


@torch.inference_mode()
def insert_paged_spec_slot(slots: PagedSpecSlots, slot: int, sub: SpecSlots,
                           page_row: torch.Tensor, n_pages: int,
                           skip_pages: int = 0) -> PagedSpecSlots:
    """Copy a B=1 :func:`spec_start` result into paged slot ``slot`` (JAX
    :613): the target cache into the slot's pages (``skip_pages`` shared
    scene-prefix pages not copied), the draft cache into its dense row."""
    paged_kv.transplant_dense(slots.cache, sub.t_cache, slot, page_row,
                              n_pages, sub.pos[0], skip_pages=skip_pages)
    _graft(slots.d_cache, sub.d_cache, slot)
    slots.cur[slot] = sub.cur[0]
    slots.done[slot] = False
    return slots



@torch.inference_mode()
def paged_spec_decode_chunk(params, draft_params, cfg: ModelConfig,
                            draft_cfg: LLMConfig, slots: PagedSpecSlots,
                            iters: int = 4, num_draft_tokens: int = 4,
                            eos_token_id: int = 151645,
                            temperature: float = 0.0, top_p: float = 1.0,
                            top_k: int = 0, seed: int = 0):
    """:func:`spec_decode_chunk` over the paged target cache (JAX :645):
    the same draft, acceptance and truncation, so the same emissions. The
    caller reserves pages for the K+2 write-ahead."""
    K = num_draft_tokens
    sampling = Sampling(temperature, top_p, top_k, seed)
    cache = slots.cache
    emits, keeps = [], []
    for _ in range(iters):
        pos = cache.lens.long()
        d, q_probs = _draft_block(draft_params, draft_cfg, slots.cur, pos,
                                  slots.d_cache, K, sampling, slots.n_iter)
        bpos = pos[:, None] + torch.arange(K + 1, device=pos.device)
        block = torch.cat([slots.cur[:, None], d], dim=1)
        h = qwen2.qwen2_forward(
            params["llm"], cfg.llm, qwen2.embed_tokens(params["llm"], block),
            _decode_position_ids(bpos), paged_cache=cache,
            paged_active=~slots.done)
        t_logits = qwen2.lm_head(params["llm"], h)
        emit, a = _accept_block(d, q_probs, t_logits, K, sampling,
                                slots.n_iter)
        done0 = slots.done.clone()
        keep, n_keep = _advance(emit, a, slots.cur, slots.done, eos_token_id,
                                K)
        # lens back from pos + K + 1 to the kept prefix
        cache.lens.copy_(torch.where(done0, pos, pos + n_keep))
        slots.n_iter.add_(1)
        emits.append(emit)
        keeps.append(keep)
    return slots, torch.stack(emits, 1), torch.stack(keeps, 1)

