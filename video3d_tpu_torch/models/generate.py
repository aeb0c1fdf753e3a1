"""KV-cache decoding over the spliced multimodal prefill, greedy or
sampled, in PyTorch: counterpart of ``video3d_tpu/models/generate.py``
(``warp_logits`` / ``sample_token``, ``prefill_multimodal``,
``DecodeState`` / ``start_decode`` / ``generate_from_state``,
``generate_greedy``, Sarathi-style ``ChunkedPrefill``, the scene-prefix
entry points ``shared_prefix_view``,
``_write_prefix``, ``start_decode_prefix`` and ``ground_suffix``, and the
slot API of the continuous batcher over dense rows and page pools).

Sampling (temperature > 0) applies HF's warpers (temperature, top-k,
top-p) and draws by Gumbel-max with a counter-based noise: each (row,
token) uniform is a hash of the seed, the state's absolute step and the
row and token indices, computed in tensor ops on the device. A draw is so
a pure function of the state, and a replayed graph, an eager chunk and any
split of the steps into chunks draw the same tokens. JAX draws with
``jax.random.categorical`` from ``fold_in(rng_key, step)``: the two
frameworks sample the same warped distribution, not the same tokens.

The JAX ``lax.while_loop`` and ``lax.scan`` compile each loop to one device
program; here the loops run chunks of decode steps, and on the card each
chunk is one captured CUDA graph (``models/decode_graph.py``) replayed on a
static state updated in place. ``generate_from_state`` checks on the host
once per chunk whether every row has emitted EOS and stops after that
chunk; its last chunk is cut short so no step runs past
``max_new_tokens``. As in the JAX loop, done rows emit EOS and keep their
lengths, so tokens and lengths equal the per-step loop's (``chunk=1``)
whatever the chunk. A loop runs captured when its caller passes a holder
of graphs (``graphs``, a ``DecodeGraphs`` that keeps them across calls:
the engine's, the batcher's); without one, or with ``capture=False``, it
runs the same chunks eagerly (the reference form; the CPU's). The cache
is written in place: ``generate_from_state`` consumes its state (the JAX
function donates it).
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional

import numpy as np
import torch

from video3d_tpu_torch.config import ModelConfig
from video3d_tpu_torch.kernels._launch import sm_count
from video3d_tpu_torch.models import decode_graph as dg
from video3d_tpu_torch.models import llava_video3d as lv3d
from video3d_tpu_torch.models import paged_kv, qwen2
from video3d_tpu_torch.models.decode_graph import DECODE_CHUNK


class GenerateResult(NamedTuple):
    tokens: torch.Tensor    # (B, max_new_tokens) emitted ids (eos-padded)
    lengths: torch.Tensor   # (B,) tokens before EOS (exclusive)


class DecodeState(NamedTuple):
    """Carried decode state between a prefill and the decode loop."""

    next_logits: torch.Tensor   # (B, vocab) logits for the next position
    cache: qwen2.KVCache
    pos: torch.Tensor           # (B,) next absolute position
    done: torch.Tensor          # (B,) bool
    step: torch.Tensor          # () int64 steps decoded (the draws' counter)


class Sampling(NamedTuple):
    """How a decode picks its tokens (JAX's static ``temperature``,
    ``top_p``, ``top_k`` and its ``rng_key``, here a seed): greedy when
    ``temperature <= 0``."""

    temperature: float = 0.0
    top_p: float = 1.0
    top_k: int = 0
    seed: int = 0

    @property
    def greedy(self) -> bool:
        return self.temperature <= 0.0

    def key(self) -> Optional[tuple]:
        """What a captured graph of this decode depends on: None for every
        greedy setting."""
        return None if self.greedy else tuple(self)


GREEDY = Sampling()


def warp_logits(logits: torch.Tensor, temperature: float, top_p: float,
                top_k: int = 0) -> torch.Tensor:
    """HF's warper chain (temperature -> top_k -> top_p) on (B, V) logits in
    float32; masked-out entries become -inf (JAX ``warp_logits``). top-k
    keeps the logits >= the k-th largest (ties stay); top-p keeps the
    logits >= the one at which the descending cumulative softmax first
    reaches ``top_p`` (the smallest such set, the first logit always)."""
    logits = logits.float() / temperature
    if top_k > 0:
        kth = torch.topk(logits, top_k, dim=-1).values[:, -1:]
        logits = logits.masked_fill(logits < kth, float("-inf"))
    if top_p < 1.0:
        ordered = torch.sort(logits, dim=-1, descending=True).values
        cum = torch.cumsum(torch.softmax(ordered, dim=-1), dim=-1)
        # a cumulative sum that rounds below top_p to the end keeps all
        cutoff_idx = (cum < top_p).sum(-1, keepdim=True).clamp(
            max=logits.shape[-1] - 1)
        cutoff = torch.gather(ordered, -1, cutoff_idx)
        logits = logits.masked_fill(logits < cutoff, float("-inf"))
    return logits


_M32 = 0xFFFFFFFF


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """x * c mod 2^32 for int64 x in [0, 2^32), without leaving int64."""
    return (x * (c & 0xFFFF) + (((x * (c >> 16)) & 0xFFFF) << 16)) & _M32


def _mix32(x: torch.Tensor) -> torch.Tensor:
    """A bijection of [0, 2^32) with full avalanche (Wellons' lowbias32)."""
    x = x ^ (x >> 16)
    x = _mul32(x, 0x7FEB352D)
    x = x ^ (x >> 15)
    x = _mul32(x, 0x846CA68B)
    return x ^ (x >> 16)


def uniform_from_bits(bits: torch.Tensor) -> torch.Tensor:
    """Uniforms in [2^-24, 1 - 2^-24] from 32-bit hashes (int64 in [0,
    2^32)): the top 23 bits, every value of which, and its +0.5 offset,
    float32 holds exactly, so no hash gives u = 0 or u = 1."""
    return ((bits >> 9).float() + 0.5) * (1.0 / (1 << 23))


def gumbel_from_bits(bits: torch.Tensor) -> torch.Tensor:
    """Gumbel(0, 1) noise from 32-bit hashes: -log(-log u) of
    :func:`uniform_from_bits`, finite for every hash (an infinite noise
    would pick a masked token)."""
    return -torch.log(-torch.log(uniform_from_bits(bits)))


def hash_bits(seed: int, step: torch.Tensor, shape, device,
              tag: Optional[int] = None) -> torch.Tensor:
    """(B, V) int64 32-bit hashes of (seed, step, ``tag``, row, column): a
    counter-based stream. ``tag`` names a stream of its own at the same
    step (the speculative draft's draws, its acceptance uniforms and its
    residual draw); None is the decode loops' stream."""
    B, V = shape
    key = _mix32(_mix32(step.long() & _M32) ^ (seed & _M32))
    if tag is not None:
        key = _mix32(key ^ (tag & _M32))
    rows = _mix32(key ^ torch.arange(B, device=device))[:, None]
    return _mix32(rows ^ torch.arange(V, device=device)[None])


def gumbel_noise(seed: int, step: torch.Tensor, shape, device,
                 tag: Optional[int] = None) -> torch.Tensor:
    """(B, V) float32 Gumbel(0, 1) noise, a pure function of (seed, step,
    ``tag``, row, token) through :func:`hash_bits`."""
    return gumbel_from_bits(hash_bits(seed, step, shape, device, tag))


def sample_token(logits: torch.Tensor, sampling: Sampling = GREEDY,
                 step: Optional[torch.Tensor] = None,
                 tag: Optional[int] = None) -> torch.Tensor:
    """(B,) ids from (B, V) logits: the argmax over float32 logits (first
    maximum, as ``jnp.argmax``) when greedy, else a draw from the softmax
    of :func:`warp_logits` by Gumbel-max at the state's ``step`` (the
    reference's do_sample = temperature > 0, model_scanqa.py:176-180) in
    stream ``tag``."""
    if sampling.greedy:
        return torch.argmax(logits.to(torch.float32), dim=-1)
    warped = warp_logits(logits, sampling.temperature, sampling.top_p,
                         sampling.top_k)
    return torch.argmax(warped + gumbel_noise(
        sampling.seed, step, warped.shape, warped.device, tag), dim=-1)


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
    B = batch.text_ids.shape[0]
    if vision_features is None:
        vision_features = lv3d.encode_video(params, cfg, batch.images,
                                            batch.patch_coords).spliceable
    embeds = lv3d.assemble_embeds(params, cfg, vision_features,
                                  batch.text_ids, batch.kind,
                                  batch.vision_index, batch.coord_mask,
                                  batch.box_input)
    hidden, cache = lv3d.prefill_cached(params, cfg, batch, embeds,
                                        max_cache_len, cache_dtype)
    last = hidden[torch.arange(B, device=embeds.device),
                  batch.seq_len.long() - 1]
    next_logits = qwen2.lm_head(params["llm"], last[:, None])[:, 0]
    return next_logits, cache, batch.seq_len


def _initial_state(next_logits, cache, pos) -> DecodeState:
    dev = next_logits.device
    # a copy: the loops advance pos in place, and a long seq_len would
    # otherwise be the batch's own tensor
    return DecodeState(next_logits=next_logits, cache=cache,
                       pos=pos.long().clone(),
                       done=torch.zeros(next_logits.shape[0], dtype=torch.bool,
                                        device=dev),
                       step=torch.zeros((), dtype=torch.long, device=dev))


@torch.inference_mode()
def start_decode(params, cfg: ModelConfig, batch: lv3d.Batch,
                 max_cache_len: int,
                 vision_features: Optional[torch.Tensor] = None,
                 cache_dtype=torch.bfloat16) -> DecodeState:
    """Prefill and return the initial decode state."""
    next_logits, cache, start_pos = prefill_multimodal(
        params, cfg, batch, max_cache_len, vision_features, cache_dtype)
    return _initial_state(next_logits, cache, start_pos)


def _embeds_and_pos(params, cfg: ModelConfig, batch: lv3d.Batch,
                    vision_features: Optional[torch.Tensor] = None):
    """Vision encode + splice assembly + 3D position ids: the
    chunk-independent first step of a chunked prefill (JAX :111)."""
    if vision_features is None:
        vision_features = lv3d.encode_video(params, cfg, batch.images,
                                            batch.patch_coords).spliceable
    embeds = lv3d.assemble_embeds(params, cfg, vision_features,
                                  batch.text_ids, batch.kind,
                                  batch.vision_index, batch.coord_mask,
                                  batch.box_input)
    return embeds, lv3d._position_ids_3d(batch, cfg)


def _prefill_chunk(params, cfg: ModelConfig, cache: qwen2.KVCache,
                   h_last: torch.Tensor, embeds_c: torch.Tensor,
                   pos3_c: torch.Tensor, start: int,
                   kv_len: torch.Tensor) -> None:
    """One text chunk of a chunked prefill (JAX :128) through the
    cached-chunk path (the suffix prefill's: K/V written at [start, start
    + C), the chunk attending the cache through B2 folded), in place.
    ``h_last`` (B, D) carries each row's last real hidden state across
    chunks (a row's kv_len - 1 may fall in any chunk); the lm_head runs
    once, in :func:`_finish_chunked_logits`."""
    B, C, _ = embeds_c.shape
    dev = embeds_c.device
    positions = (start + torch.arange(C, device=dev))[None].expand(B, C)
    hidden = qwen2.qwen2_forward(
        params["llm"], cfg.llm, embeds_c, pos3_c, kv_cache=cache,
        cache_positions=positions, kv_len=kv_len, contiguous_update=True)
    last = kv_len.long() - 1
    cand = hidden[torch.arange(B, device=dev),
                  (last - start).clamp(0, C - 1)]
    in_chunk = (last >= start) & (last < start + C)
    h_last.copy_(torch.where(in_chunk[:, None], cand.to(h_last.dtype),
                             h_last))


def _finish_chunked_logits(params, h_last: torch.Tensor) -> torch.Tensor:
    """(B, D) last-token hidden states -> (B, vocab) logits: one lm_head
    read for the whole chunked prefill (JAX :155)."""
    return qwen2.lm_head(params["llm"], h_last[:, None])[:, 0]


class ChunkedPrefill:
    """Host-driven chunked multimodal prefill, Sarathi-style (JAX
    ``ChunkedPrefill``, :163): the batcher's scheduler runs one bounded
    unit per iteration between decode chunks, so a cold admission stalls
    decode for about max(tower, one chunk forward) instead of the whole
    prefill. Step 0 is the vision encode and the splice assembly; each
    later step one ``chunk_len``-token forward over the chunk's positions
    through the cached-chunk path (B2 folded on the card); the last step
    pays the lm_head. Only the true tokens are covered: K/V past a row's
    ``seq_len`` is masked and decode overwrites from there. The finished
    :class:`DecodeState` is :func:`start_decode`'s up to the rounding of
    the two attention paths (the full prefill attends raw K/V, a chunk the
    cache, quantized when the cache is)."""

    def __init__(self, params, cfg: ModelConfig, batch: lv3d.Batch,
                 max_cache_len: int, chunk_len: int = 256,
                 cache_dtype=torch.bfloat16,
                 vision_features: Optional[torch.Tensor] = None):
        self.params, self.cfg, self.batch = params, cfg, batch
        self.chunk_len = int(chunk_len)
        if self.chunk_len <= 0:
            raise ValueError("chunk_len must be positive")
        self.max_cache_len = max_cache_len
        self.cache_dtype = cache_dtype
        self.vision_features = vision_features
        self._embeds = self._pos3 = self._cache = self._h_last = None
        self._off = 0
        self._state: Optional[DecodeState] = None
        self._n_true = int(batch.seq_len.max())
        if self._n_true > max_cache_len:
            raise ValueError("prefill longer than the KV cache")
        # 1 (vision / assembly) + the text chunks
        self.total_steps = 1 + -(-self._n_true // self.chunk_len)

    @property
    def done(self) -> bool:
        return self._state is not None

    @torch.inference_mode()
    def step(self) -> bool:
        """Run the next bounded unit of work; returns :attr:`done`."""
        if self._state is not None:
            return True
        B = self.batch.text_ids.shape[0]
        if self._embeds is None:
            self._embeds, self._pos3 = _embeds_and_pos(
                self.params, self.cfg, self.batch, self.vision_features)
            self._cache = qwen2.KVCache.zeros(
                self.cfg.llm, B, self.max_cache_len, dtype=self.cache_dtype,
                device=self._embeds.device)
            self._h_last = self._embeds.new_zeros(
                (B, self._embeds.shape[-1]))
            return False
        c0 = self._off
        c1 = min(c0 + self.chunk_len, self._n_true)
        _prefill_chunk(self.params, self.cfg, self._cache, self._h_last,
                       self._embeds[:, c0:c1], self._pos3[:, c0:c1], c0,
                       self.batch.seq_len)
        self._off = c1
        if c1 < self._n_true:
            return False
        next_logits = _finish_chunked_logits(self.params, self._h_last)
        cache, self._cache = self._cache, None
        self._embeds = self._pos3 = self._h_last = None
        self._state = _initial_state(next_logits, cache, self.batch.seq_len)
        return True

    def result(self) -> DecodeState:
        if self._state is None:
            raise RuntimeError("the chunked prefill has not finished")
        return self._state


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


def _suffix_forward(params, cfg: ModelConfig, batch: lv3d.Batch,
                    prefix: qwen2.KVCache, prefix_len: int,
                    max_cache_len: int,
                    cache_dtype: Optional[torch.dtype] = None):
    """The suffix forward shared by :func:`start_decode_prefix` and
    :func:`ground_suffix`: a fresh cache of ``max_cache_len`` slots seeded
    with ``prefix`` (broadcast to every row), the suffix's K/V written
    after it, and the suffix attending the prefix plus itself: through the
    cache and the folded kernel at B == 1, through the shared-prefix
    kernel at B > 1. ``batch.coord_mask`` / ``batch.box_input`` add the
    ``<coord>`` box PE. Returns (hidden (B, Ls, D), cache)."""
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
                                  batch.kind, batch.vision_index,
                                  batch.coord_mask, batch.box_input)
    cache_positions = (prefix_len + torch.arange(Ls, device=dev))[None] \
        .expand(B, Ls)
    hidden = qwen2.qwen2_forward(
        params["llm"], cfg.llm, embeds, lv3d._position_ids_3d(batch, cfg),
        kv_cache=cache, cache_positions=cache_positions, kv_len=batch.seq_len,
        contiguous_update=True,
        shared_prefix=shared_prefix_view(prefix, prefix_len, B))
    return hidden, cache


@torch.inference_mode()
def start_decode_prefix(params, cfg: ModelConfig, batch: lv3d.Batch,
                        prefix: qwen2.KVCache, prefix_len: int,
                        max_cache_len: int,
                        cache_dtype: Optional[torch.dtype] = None
                        ) -> DecodeState:
    """Prefill only a question SUFFIX against a cached scene prefix
    (:func:`_suffix_forward`) and return the decode state.

    ``batch`` is the suffix slice of the full splice plan
    (``slice_suffix_plan``): (B, Ls) ids at spliced positions
    [prefix_len, prefix_len + Ls), no vision tokens, and ``batch.seq_len``
    the TOTAL true length. ``prefix`` is the stored (layers, 1, P, KV*hd)
    entry (int8 or packed int4 with its scales); the new cache takes its
    form (``cache_dtype``, when given, must be that form, as the JAX
    function requires). Decoding then proceeds unchanged.
    """
    hidden, cache = _suffix_forward(params, cfg, batch, prefix, prefix_len,
                                    max_cache_len, cache_dtype)
    B = hidden.shape[0]
    last = hidden[torch.arange(B, device=hidden.device),
                  batch.seq_len.long() - 1 - prefix_len]
    next_logits = qwen2.lm_head(params["llm"], last[:, None])[:, 0]
    return _initial_state(next_logits, cache, batch.seq_len)


@torch.inference_mode()
def ground_suffix(params, cfg: ModelConfig, batch: lv3d.Batch,
                  prefix: qwen2.KVCache, prefix_len: int, max_cache_len: int,
                  cache_dtype, obj_feats: torch.Tensor,
                  object_valid: torch.Tensor, ground_slot) -> torch.Tensor:
    """Grounding scores through the scene-prefix cache: the suffix forward
    of :func:`start_decode_prefix` (the suffix holds the ``<ground>``
    token), each row scored at its own ABSOLUTE spliced ``ground_slot``
    (an int, or one per row) against the cached question-independent
    (N, D) object features. Returns (N+1,) scores at B = 1, (B, N+1)
    otherwise (N for the MLP and SCORE heads): the full grounding forward's
    up to the cache's precision."""
    hidden, _ = _suffix_forward(params, cfg, batch, prefix, prefix_len,
                                max_cache_len, cache_dtype)
    B = hidden.shape[0]
    slots = np.broadcast_to(np.asarray(ground_slot).reshape(-1), (B,))
    scores = torch.stack([
        lv3d.ground_scores(params, hidden[b, int(slot) - prefix_len],
                           obj_feats, object_valid, cfg)
        for b, slot in enumerate(slots)])
    return scores[0] if B == 1 else scores


def _next_token(next_logits: torch.Tensor, done: torch.Tensor,
                eos_token_id: int, sampling: Sampling,
                step: torch.Tensor) -> torch.Tensor:
    """:func:`sample_token`, EOS for done rows."""
    return torch.where(done, eos_token_id,
                       sample_token(next_logits, sampling, step))


def _dense_steps(params, cfg: ModelConfig, state: DecodeState,
                 toks: torch.Tensor, eos_token_id: int,
                 sampling: Sampling = GREEDY,
                 lengths: Optional[torch.Tensor] = None) -> None:
    """``toks.shape[1]`` decode steps over a dense state, every tensor of
    it updated in place (what a captured chunk records): step i writes its
    ids into ``toks[:, i]`` and counts each row's ids before EOS into
    ``lengths``. Writes of rows past the end of their cache row land in the
    row's last slot."""
    next_logits, cache, pos, done = (state.next_logits, state.cache,
                                     state.pos, state.done)
    last = cache.k.shape[2] - 1
    for i in range(toks.shape[1]):
        tok = _next_token(next_logits, done, eos_token_id, sampling,
                          state.step)
        toks[:, i] = tok
        is_eos = tok == eos_token_id
        if lengths is not None:
            lengths.add_((~(done | is_eos)).long())
        done.logical_or_(is_eos)
        hidden = qwen2.qwen2_forward(
            params["llm"], cfg.llm,
            qwen2.embed_tokens(params["llm"], tok[:, None]),
            _decode_position_ids(pos[:, None]), kv_cache=cache,
            cache_positions=pos.clamp(max=last)[:, None], kv_len=pos + 1)
        # keep the state's logits dtype (f32 from empty_decode_state)
        next_logits.copy_(qwen2.lm_head(params["llm"], hidden)[:, 0])
        pos.add_(1)
        state.step.add_(1)


@torch.inference_mode()
def generate_from_state(params, cfg: ModelConfig, state: DecodeState,
                        max_new_tokens: int = 512,
                        eos_token_id: int = 151645,
                        temperature: float = 0.0, top_p: float = 1.0,
                        top_k: int = 0, seed: int = 0,
                        chunk: int = DECODE_CHUNK,
                        capture: Optional[bool] = None,
                        graphs: Optional[dg.DecodeGraphs] = None
                        ) -> GenerateResult:
    """Decode from a prefilled state (full or prefix-cached): greedy at
    ``temperature`` 0 (the argmax over float32 logits, first maximum on
    ties, as ``jnp.argmax``), else sampled (:func:`sample_token`), in
    chunks of ``chunk`` steps with one host sync each. On a CUDA device
    with a holder ``graphs`` (e.g. the engine's), each chunk is a replayed
    CUDA graph of it; without one, or with ``capture=False``, the chunks
    run eagerly; ``capture=True`` without a holder or off the card raises.
    The state's cache is written in place."""
    sampling = Sampling(temperature, top_p, top_k, seed)
    B = state.next_logits.shape[0]
    dev = state.next_logits.device
    capture = dg.resolve_capture(capture, dev, graphs)
    if int(state.pos.max()) + max_new_tokens > state.cache.k.shape[2]:
        raise ValueError("decode would write past the KV cache")
    tokens = torch.full((B, max_new_tokens), eos_token_id, dtype=torch.long,
                        device=dev)
    if not capture:
        st = DecodeState(state.next_logits.clone(), state.cache,
                         state.pos.long().clone(), state.done.clone(),
                         state.step.clone())
        lengths = torch.zeros(B, dtype=torch.long, device=dev)
        for s0 in range(0, max_new_tokens, chunk):
            _dense_steps(params, cfg, st, tokens[:, s0:s0 + chunk],
                         eos_token_id, sampling, lengths)
            if bool(st.done.all()):
                break
        return GenerateResult(tokens=tokens, lengths=lengths)
    with graphs.lock:
        entry = graphs.bind(params, state, eos_token_id, sampling.key())
        st = entry.state
        for s0 in range(0, max_new_tokens, chunk):
            n = min(chunk, max_new_tokens - s0)
            toks = entry.tokens(n)
            graphs.run(entry, n, functools.partial(
                _dense_steps, params, cfg, st, toks, eos_token_id,
                sampling, entry.lengths), lambda: dg.step_buffers(
                    params, cfg, B, state.cache.k.shape[2],
                    sm_count(dev.index or 0)))
            tokens[:, s0:s0 + n] = toks
            if bool(st.done.all()):
                break
        return GenerateResult(tokens=tokens, lengths=entry.lengths.clone())


def generate_greedy(params, cfg: ModelConfig, batch: lv3d.Batch,
                    max_new_tokens: int = 512, eos_token_id: int = 151645,
                    vision_features: Optional[torch.Tensor] = None,
                    cache_dtype=torch.bfloat16, **decode) -> GenerateResult:
    """Greedy (temperature 0, the eval default) or sampled decode into a
    cache of L + max_new_tokens slots; ``decode``:
    :func:`generate_from_state`'s ``temperature``, ``top_p``, ``top_k``,
    ``seed``, ``chunk``, ``capture`` and ``graphs``."""
    state = start_decode(params, cfg, batch,
                         batch.text_ids.shape[1] + max_new_tokens,
                         vision_features, cache_dtype)
    return generate_from_state(params, cfg, state, max_new_tokens,
                               eos_token_id, **decode)


# ---------------------------------------------------------------------------
# The continuous batcher's slot API (JAX ``generate.py:482-682``): an S-slot
# state whose rows are admitted, decoded together and released, greedy or
# sampled. The states are updated in place; a decode chunk makes no host
# sync and returns its tokens on the device. On the card a chunk is a
# replayed CUDA graph over the state's own tensors, so admission and release
# write the tensors the graphs read.
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
        done=torch.ones(num_slots, dtype=torch.bool, device=device),
        step=torch.zeros((), dtype=torch.long, device=device))


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


def _run_chunk(kind: str, steps, params, cfg: ModelConfig, state,
               chunk: int, eos_token_id: int, sampling: Sampling,
               capture: Optional[bool],
               graphs: Optional[dg.DecodeGraphs], cap: int):
    """One chunk of ``steps`` over ``state`` in place, eagerly or as the
    replay of ``graphs``' graph on the state's own tensors; returns (state,
    tokens (S, chunk)), the tokens a copy of the graph's buffer."""
    dev = state.next_logits.device
    S = state.next_logits.shape[0]
    if not dg.resolve_capture(capture, dev, graphs):
        toks = torch.empty((S, chunk), dtype=torch.long, device=dev)
        steps(params, cfg, state, toks, eos_token_id, sampling)
        return state, toks
    with graphs.lock:
        entry = graphs.adopt(kind, params, state, eos_token_id,
                             sampling.key())
        toks = entry.tokens(chunk)
        graphs.run(entry, chunk,
                   functools.partial(steps, params, cfg, state, toks,
                                     eos_token_id, sampling),
                   lambda: dg.step_buffers(params, cfg, S, cap,
                                           sm_count(dev.index or 0)))
        return state, toks.clone()


@torch.inference_mode()
def decode_chunk(params, cfg: ModelConfig, state: DecodeState,
                 chunk: int = 16, eos_token_id: int = 151645,
                 temperature: float = 0.0, top_p: float = 1.0,
                 top_k: int = 0, seed: int = 0,
                 capture: Optional[bool] = None,
                 graphs: Optional[dg.DecodeGraphs] = None):
    """Emit ``chunk`` tokens, greedy or sampled (:func:`sample_token` at
    the state's step), from every row of a dense S-slot state (done rows
    emit EOS); returns (state, tokens (S, chunk)): the same
    state, its tensors updated in place. On a CUDA device with a holder
    ``graphs`` (the batcher's), the chunk is a replay of its captured graph
    for this state; without one, or with ``capture=False``, it runs
    eagerly.

    As in JAX, done rows still run the step and their position advances.
    A done row can so run past the end of its cache row: JAX drops such
    writes; here they land in the row's last slot, which the next
    :func:`insert_decode_slot` rewrites with the whole row."""
    return _run_chunk("dense", _dense_steps, params, cfg, state, chunk,
                      eos_token_id, Sampling(temperature, top_p, top_k, seed),
                      capture, graphs, state.cache.k.shape[2])


class PagedDecodeState(NamedTuple):
    """S-slot state over a shared page pool; the slots' lengths live in
    ``cache.lens`` (the dense state's ``pos``)."""

    next_logits: torch.Tensor   # (S, vocab)
    cache: paged_kv.PagedKVCache
    done: torch.Tensor          # (S,) bool
    step: torch.Tensor          # () int64 steps decoded


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
        done=torch.ones(num_slots, dtype=torch.bool, device=device),
        step=torch.zeros((), dtype=torch.long, device=device))


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


def _paged_steps(params, cfg: ModelConfig, state: PagedDecodeState,
                 toks: torch.Tensor, eos_token_id: int,
                 sampling: Sampling = GREEDY) -> None:
    """``toks.shape[1]`` decode steps over the page pools, every tensor of
    the state updated in place; dead slots neither advance their length
    nor touch their pages."""
    next_logits, cache, done = state.next_logits, state.cache, state.done
    for i in range(toks.shape[1]):
        tok = _next_token(next_logits, done, eos_token_id, sampling,
                          state.step)
        toks[:, i] = tok
        hidden = qwen2.qwen2_forward(
            params["llm"], cfg.llm,
            qwen2.embed_tokens(params["llm"], tok[:, None]),
            _decode_position_ids(cache.lens.long()[:, None]),
            paged_cache=cache, paged_active=~done)
        done.logical_or_(tok == eos_token_id)
        next_logits.copy_(qwen2.lm_head(params["llm"], hidden)[:, 0])
        state.step.add_(1)


@torch.inference_mode()
def paged_decode_chunk(params, cfg: ModelConfig, state: PagedDecodeState,
                       chunk: int = 16, eos_token_id: int = 151645,
                       temperature: float = 0.0, top_p: float = 1.0,
                       top_k: int = 0, seed: int = 0,
                       capture: Optional[bool] = None,
                       graphs: Optional[dg.DecodeGraphs] = None):
    """:func:`decode_chunk` over the page pools: the same emissions (EOS
    for done rows), but dead slots neither advance their length nor touch
    their pages (a slot's step still runs while it emits its EOS). The
    caller guarantees pages for ``lens + chunk`` on every live slot (the
    paged batcher reserves the whole budget at admission)."""
    cache = state.cache
    return _run_chunk("paged", _paged_steps, params, cfg, state, chunk,
                      eos_token_id, Sampling(temperature, top_p, top_k, seed),
                      capture, graphs, cache.max_pages * cache.page_size)
